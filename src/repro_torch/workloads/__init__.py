"""Named towers on the plan and serve surface."""
from .registry import (UnknownWorkloadError, WorkloadError, get, names,
                       resolve_model, workload_name_for)

__all__ = ["UnknownWorkloadError", "WorkloadError", "get", "names",
           "resolve_model", "workload_name_for"]
