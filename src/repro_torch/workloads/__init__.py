"""Named towers on the plan and serve surface."""
from .registry import (UnknownWorkloadError, WorkloadError,
                       calibration_input, get, names, resolve_model,
                       workload_name_for)

__all__ = ["UnknownWorkloadError", "WorkloadError", "calibration_input", "get",
           "names", "resolve_model", "workload_name_for"]
