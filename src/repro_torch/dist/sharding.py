"""Logical-axis -> mesh-axis rules and DTensor placements (the JAX
package's ``repro.dist.sharding``).

Policies (mesh axes are ("pod",)? + ("data", "model")):

* ``tp``       — tensor parallelism only: weight feature axes (mlp, heads,
                 kv_heads, vocab, experts) shard the model axis; params are
                 replicated across data.
* ``fsdp_tp``  — tp plus FSDP: the embed (d_model) axis of every weight
                 shards the data axis, so optimizer state scales with the
                 full mesh.

The batch axis always shards data (and pod when present).  A logical axis
whose dim does not divide the mapped mesh extent degrades to replicated
(checked per tensor in `spec_to_pspec`).

Every rule function reads only ``mesh.shape``, a dict of axis extents, as
the reference's do: so they serve the DCNN paths' single-controller
`launch.mesh.DeviceMesh` and the LM's `launch.mesh.LmMesh` alike.  A
`PartitionSpec` is a tuple of mesh-axis names (or tuples of them, or
None), one per tensor dim, and compares equal to
``tuple(jax.sharding.PartitionSpec(...))``.  The torch pieces with no JAX
name turn a spec into DTensor placements (`placements`) and place trees
(`tree_shardings`, `distribute_tree`).

The DCNN paths shard one dim: the batch splits over the mesh's data axis
in contiguous, equal shards in shard order (`batch_slices`), and every
parameter replicates (`replicate`, `replicated_specs`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.tree import tree_leaves, tree_map, tree_unflatten

Rules = Dict[str, Union[str, Tuple[str, ...]]]

# axes that are never sharded (the unit-stacked layer dim)
_UNSHARDED = ("layers",)


class PartitionSpec(tuple):
    """One mesh axis (a name, a tuple of names, or None) per tensor dim."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def make_rules(policy: str, multi_pod: bool = False) -> Rules:
    batch_axes: Union[str, Tuple[str, ...]] = (
        ("pod", "data") if multi_pod else "data"
    )
    rules: Rules = {
        "batch": batch_axes,
        "moe_group": batch_axes,
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "vocab": "model",
        "experts": "model",
    }
    if policy == "fsdp_tp":
        rules["embed"] = "data"
    elif policy != "tp":
        raise ValueError(f"unknown sharding policy {policy!r}")
    return rules


def _flat(axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def _axis_size(mesh, axis: Union[str, Tuple[str, ...]]) -> int:
    n = 1
    for a in _flat(axis):
        n *= mesh.shape.get(a, 1)
    return n


def spec_to_pspec(
    rules: Rules,
    spec: Sequence[Optional[str]],
    mesh=None,
    shape: Optional[Tuple[int, ...]] = None,
) -> PartitionSpec:
    """Map a logical-axis tuple onto a PartitionSpec.

    Unknown logical names and never-sharded axes map to None; with a
    ``mesh``, an axis the mesh lacks or of extent 1 maps to None, and when
    ``shape`` is given any dim that does not divide the mesh extent also
    degrades to None (replicated), so the placement always exists.  A mesh
    axis appears once per spec."""
    out = []
    used: set = set()
    for i, name in enumerate(spec):
        axis = None
        if name is not None and name not in _UNSHARDED:
            axis = rules.get(name)
        if axis is not None and any(a in used for a in _flat(axis)):
            axis = None
        if axis is not None and mesh is not None:
            n = _axis_size(mesh, axis)
            present = all(a in mesh.shape for a in _flat(axis))
            if not present or n <= 1:
                axis = None
            elif shape is not None and shape[i] % n != 0:
                axis = None
        if axis is not None:
            used.update(_flat(axis))
        out.append(axis)
    return P(*out)


def placements(mesh, pspec: Sequence) -> Tuple[Any, ...]:
    """One DTensor placement per mesh dim of ``mesh`` (an `LmMesh`): dim
    ``d`` of the tensor is ``Shard(d)`` on every mesh axis that
    ``pspec[d]`` names (a tuple names several, outer first, the reference's
    row-major layout), and the tensor is ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out: List[Any] = [Replicate()] * len(mesh.axis_names)
    for d, axis in enumerate(pspec):
        if axis is None:
            continue
        for a in _flat(axis):
            i = mesh.axis_names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} used twice in {pspec}")
            out[i] = Shard(d)
    return tuple(out)


def _is_spec_leaf(s: Any) -> bool:
    return isinstance(s, tuple)


def _spec_leaves(specs_tree) -> list:
    if _is_spec_leaf(specs_tree):
        return [specs_tree]
    if isinstance(specs_tree, dict):
        return [l for k in sorted(specs_tree)
                for l in _spec_leaves(specs_tree[k])]
    raise TypeError(f"not a spec tree: {type(specs_tree).__name__}")


def leaf_pspecs(mesh, rules: Rules, shapes_tree, specs_tree) -> list:
    """The PartitionSpec of each leaf of ``shapes_tree`` (tensors, meta
    tensors), in leaf order, from its logical spec in ``specs_tree``,
    which mirrors it."""
    shape_leaves = tree_leaves(shapes_tree)
    spec_leaves = _spec_leaves(specs_tree)
    if len(shape_leaves) != len(spec_leaves):
        raise ValueError(f"{len(shape_leaves)} leaves against "
                         f"{len(spec_leaves)} specs")
    return [spec_to_pspec(rules, s, mesh=mesh, shape=tuple(t.shape))
            for t, s in zip(shape_leaves, spec_leaves)]


def tree_shardings(mesh, rules: Rules, shapes_tree, specs_tree):
    """The tree of DTensor placements (a tuple per leaf, one placement per
    mesh dim) from a (params/shapes, logical specs) pair: the reference's
    NamedSharding tree."""
    return tree_unflatten(shapes_tree, [
        placements(mesh, ps)
        for ps in leaf_pspecs(mesh, rules, shapes_tree, specs_tree)])


def distribute_tree(mesh, tree, placements_tree):
    """Each tensor of ``tree`` placed by its placements: a DTensor whose
    local shard is this rank's piece of the (replicated, equal on every
    rank) tensor given.  A DTensor leaf is redistributed instead."""
    from .context import as_dtensor

    return tree_map(
        lambda t, pl: as_dtensor(t, mesh).redistribute(mesh.device_mesh, pl),
        tree, placements_tree)


def replicated_specs(tree):
    """All-replicated logical spec tree mirroring ``tree``: every dim maps
    to None (the DCNN generator and critic weights, small enough to live
    whole on every device)."""
    return tree_map(lambda a: (None,) * len(getattr(a, "shape", ())), tree)


def data_axis_size(mesh, rules: Rules) -> int:
    """Total data-parallel extent the batch dim shards over (1 when the
    mesh or the batch rule is absent)."""
    if mesh is None:
        return 1
    axis = rules.get("batch")
    if axis is None:
        return 1
    return _axis_size(mesh, axis)


def shard_index(mesh, rules: Rules) -> int:
    """Linearized index of this rank's batch shard, for use inside a
    `local_map` body: 0 .. data_axis_size-1, row-major over the batch
    axes (how a batch-leading tensor is laid out across them).  ``mesh``
    is an `LmMesh`: the coordinates are this process's."""
    axis = rules.get("batch")
    if axis is None:
        return 0
    idx = 0
    for a in _flat(axis):
        idx = idx * mesh.shape.get(a, 1) + (
            mesh.coordinate(a) if a in mesh.shape else 0)
    return idx


def batch_pspec(mesh, rules: Rules, batch_size: int,
                ndim: int) -> PartitionSpec:
    """PartitionSpec for a batch-leading tensor: dim 0 on the batch axes
    when divisible, everything else replicated."""
    axis = rules.get("batch")
    if axis is not None:
        n = _axis_size(mesh, axis)
        if n <= 1 or batch_size % n != 0:
            axis = None
    return P(axis, *([None] * (ndim - 1)))


# ---------------------------------------------------------------------------
# serving-cache logical specs (mirrors models.transformer.init_cache)
# ---------------------------------------------------------------------------
def _attn_cache_spec(cfg) -> Dict[str, tuple]:
    kv = ("batch", None, "kv_heads", None)
    spec = {"k": kv, "v": kv, "slot_pos": (None,)}
    if cfg.kv_quant:
        spec["k_scale"] = kv
        spec["v_scale"] = kv
    return spec


def _block_cache_spec(cfg, kind: str) -> Dict[str, tuple]:
    if kind in ("global", "local"):
        return _attn_cache_spec(cfg)
    if kind == "griffin":
        return {"conv": ("batch", None, None), "h": ("batch", None)}
    if kind == "mlstm":
        return {
            "C": ("batch", "heads", None, None),
            "n": ("batch", "heads", None),
            "m": ("batch", "heads"),
            "conv": ("batch", None, None),
        }
    if kind == "slstm":
        st = ("batch", "heads", None)
        return {"c": st, "n": st, "h": st, "m": st}
    raise ValueError(kind)


def cache_specs(cfg) -> Dict[str, Any]:
    """Logical spec tree matching init_cache(cfg, ...)'s tree."""
    from ..models import nn

    pattern = cfg.block_pattern
    unit = {f"b{i}": _block_cache_spec(cfg, kind)
            for i, kind in enumerate(pattern)}
    specs: Dict[str, Any] = {
        "units": nn.stack_specs(unit),
        "pos": (),
    }
    if cfg.n_rem:
        specs["rem"] = {f"b{i}": _block_cache_spec(cfg, pattern[i])
                        for i in range(cfg.n_rem)}
    return specs


# ---------------------------------------------------------------------------
# the DCNN paths: batch shards and replicas on a single-controller mesh
# ---------------------------------------------------------------------------
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
