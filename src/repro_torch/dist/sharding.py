"""What the DCNN paths use of the JAX package's ``dist/sharding.py``.

The DCNN paths shard one dim: the batch splits over a mesh's data axis
in contiguous, equal shards in shard order, and every parameter
replicates (one copy per shard).  The logical-axis rules and the LM
side's rule policies (``make_rules``), ``tree_shardings`` and
``cache_specs`` have not been ported: the DCNN paths have one rule, and
the shard count is the mesh's ``data`` extent.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch

from ..core.tree import tree_map


def batch_slices(n_shards: int, batch_size: int) -> List[slice]:
    """Per batch shard, its rows of a batch-leading array: contiguous,
    equal and in shard order (the split of ``batch_pspec``)."""
    if n_shards < 1 or batch_size % n_shards:
        raise ValueError(f"{batch_size} rows do not split into {n_shards} "
                         "equal shards")
    per = batch_size // n_shards
    return [slice(i * per, (i + 1) * per) for i in range(n_shards)]


def _to_device(x, device: torch.device):
    """A copy of ``x`` on ``device``: a tensor, or a dataclass holding
    tensors (a layer's prepared static operands, a packed weight)."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to_device(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    return x


def replicate(tree, devices: Sequence) -> List[Any]:
    """One copy of a parameter tree per device (the replicated specs of
    the DCNN generator and critic weights, small enough to live whole on
    every device)."""
    return [tree_map(lambda t, d=torch.device(d): _to_device(t, d), tree)
            for d in devices]
