"""Fault tolerance on one device: deterministic fault injection, straggler
detection and liveness heartbeats (the single-device part of the JAX
package's ``dist``; sharding, meshes and elastic remesh wait for the
multi-device port)."""
from .fault import Heartbeat, StragglerMonitor
from .inject import (DeviceLoss, DeviceLossError, FaultError, FaultInjector,
                     SlowCall, TransientCallError, TransientFailure)

__all__ = [
    "Heartbeat", "StragglerMonitor",
    "DeviceLoss", "DeviceLossError", "FaultError", "FaultInjector",
    "SlowCall", "TransientCallError", "TransientFailure",
]
