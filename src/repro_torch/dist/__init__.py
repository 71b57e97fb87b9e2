"""Fault tolerance and data parallelism: deterministic fault injection,
straggler detection, liveness heartbeats, elastic meshes and the DCNN
paths' batch sharding (the JAX package's ``dist`` without its LM-side
context, pipeline and rule policies)."""
from .fault import Heartbeat, StragglerMonitor, elastic_mesh, reshard_tree
from .inject import (DeviceLoss, DeviceLossError, FaultError, FaultInjector,
                     SlowCall, TransientCallError, TransientFailure)

__all__ = [
    "Heartbeat", "StragglerMonitor", "elastic_mesh", "reshard_tree",
    "DeviceLoss", "DeviceLossError", "FaultError", "FaultInjector",
    "SlowCall", "TransientCallError", "TransientFailure",
]
