"""Fault tolerance and data parallelism: deterministic fault injection,
straggler detection, liveness heartbeats, elastic meshes, the DCNN
paths' batch sharding and the LM's sharding context (the JAX package's
``dist`` without its pipeline and rule policies)."""
from .fault import Heartbeat, StragglerMonitor, elastic_mesh, reshard_tree
from .inject import (DeviceLoss, DeviceLossError, FaultError, FaultInjector,
                     SlowCall, TransientCallError, TransientFailure)

__all__ = [
    "Heartbeat", "StragglerMonitor", "elastic_mesh", "reshard_tree",
    "DeviceLoss", "DeviceLossError", "FaultError", "FaultInjector",
    "SlowCall", "TransientCallError", "TransientFailure",
]
