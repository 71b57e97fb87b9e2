"""Bucketed fp32 DCNN serving on one device."""
from .config import EngineConfig
from .engine import DcnnServeEngine, pow2_buckets
from .errors import (AdmissionRejected, DeadlineExceeded, EngineDegraded,
                     EngineError)

__all__ = ["AdmissionRejected", "DcnnServeEngine", "DeadlineExceeded",
           "EngineConfig", "EngineDegraded", "EngineError", "pow2_buckets"]
