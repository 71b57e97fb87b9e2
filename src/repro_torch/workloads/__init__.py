"""Workload zoo: named deconv towers on the plan and serve surface.

`registry` is the mechanism (typed register/resolve lookups plus
calibration-input synthesis); `zoo` registers the built-ins: the paper's
two WGAN generators and the super-resolution and denoising heads.
Importing this package registers the zoo."""
from .registry import (UnknownWorkloadError, Workload, WorkloadError,
                       calibration_input, get, names, register,
                       resolve_model, workload_for, workload_name_for)
from .zoo import DAE_DENOISE, SR_X2

__all__ = [
    "Workload",
    "WorkloadError",
    "UnknownWorkloadError",
    "register",
    "get",
    "names",
    "resolve_model",
    "workload_for",
    "workload_name_for",
    "calibration_input",
    "SR_X2",
    "DAE_DENOISE",
]
