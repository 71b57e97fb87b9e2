"""Bucketed DCNN serving (fp32, int8, zero-skip) on one device."""
from .config import EngineConfig
from .engine import DcnnServeEngine, pow2_buckets
from .errors import (AdmissionRejected, DeadlineExceeded, EngineDegraded,
                     EngineError)

__all__ = ["AdmissionRejected", "DcnnServeEngine", "DeadlineExceeded",
           "EngineConfig", "EngineDegraded", "EngineError", "pow2_buckets"]
