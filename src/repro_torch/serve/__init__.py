"""Bucketed DCNN serving (fp32, bf16, int8, zero-skip) on one device, with
typed fault/deadline semantics, the SLO-aware async frontend (admission
control, EDF scheduling, graceful precision degradation), and the LM's
continuous-batching `ServeEngine`."""
from .admission import AdmissionController, TenantClass
from .config import EngineConfig
from .engine import DcnnServeEngine, Request, ServeEngine, pow2_buckets
from .errors import (AdmissionRejected, DeadlineExceeded, EngineDegraded,
                     EngineError)
from .frontend import AsyncServeFrontend
from .scheduler import EdfScheduler, ServiceModel

__all__ = [
    "EngineConfig", "DcnnServeEngine", "Request", "ServeEngine",
    "pow2_buckets",
    "AsyncServeFrontend", "TenantClass", "AdmissionController",
    "EdfScheduler", "ServiceModel",
    "AdmissionRejected", "DeadlineExceeded", "EngineDegraded", "EngineError",
]
