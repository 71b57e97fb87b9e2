"""Distribution substrate: the sharding context, logical-axis rules,
fault tolerance and pipeline parallelism (the JAX package's ``dist``).

The model code never names mesh axes directly: it annotates tensors with
*logical* axes (``constrain(x, "batch", None, "mlp")``) and the active
`sharding_context` maps them onto mesh axes through the policy rules
(`make_rules`).  Outside a context every annotation is a no-op, so the
same model runs unchanged on one device.
"""
from .context import constrain, current, local_region, sharding_context
from .fault import Heartbeat, StragglerMonitor, elastic_mesh, reshard_tree
from .inject import (DeviceLoss, DeviceLossError, FaultError, FaultInjector,
                     SlowCall, TransientCallError, TransientFailure)
from .pipeline import microbatch, pipeline_apply
from .sharding import (PartitionSpec, batch_pspec, cache_specs,
                       data_axis_size, distribute_tree, make_rules,
                       placements, replicated_specs, spec_to_pspec,
                       tree_shardings)

__all__ = [
    "constrain", "current", "local_region", "sharding_context",
    "Heartbeat", "StragglerMonitor", "elastic_mesh", "reshard_tree",
    "DeviceLoss", "DeviceLossError", "FaultError", "FaultInjector",
    "SlowCall", "TransientCallError", "TransientFailure",
    "microbatch", "pipeline_apply",
    "PartitionSpec", "batch_pspec", "cache_specs", "data_axis_size",
    "distribute_tree", "make_rules", "placements", "replicated_specs",
    "spec_to_pspec", "tree_shardings",
]
