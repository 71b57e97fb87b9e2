"""Thread-local sharding context: (mesh, logical-axis rules), the JAX
package's ``repro.dist.context`` for the port.

`constrain` is the single annotation primitive the LM models use.  Outside
a context, and on the DCNN paths' single-controller mesh (a
`launch.mesh.DeviceMesh` whose ``model`` extent is 1), it returns its
input: one process holds every shard of every tensor.  On the LM's mesh (a
`launch.mesh.LmMesh`, one process per device) it places the tensor: a
DTensor is redistributed to the placements that the rules give its
logical axes (the reference's ``with_sharding_constraint``), and a plain
tensor, equal on every rank, becomes a DTensor with those placements.

Under an `LmMesh` the context also turns on DTensor's implicit
replication: the tensors that the model makes as it runs (positions,
masks, zero states, gather indices) are the same on every rank, and they
meet the placed params as replicated DTensors.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

_state = threading.local()


def current() -> Tuple[Optional[object], Optional[dict]]:
    """The active (mesh, rules), or (None, None) outside any context."""
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


def is_lm_mesh(mesh) -> bool:
    """Whether ``mesh`` places DTensors (an `LmMesh`), as against the
    DCNN paths' single-controller mesh."""
    return getattr(mesh, "device_mesh", None) is not None


@contextlib.contextmanager
def sharding_context(mesh, rules):
    """Activate (mesh, rules) for the dynamic extent of a step function.

    A single-controller mesh with a ``model`` axis above 1 has nothing to
    place a shard of a model on, and is refused."""
    if (mesh is not None and not is_lm_mesh(mesh)
            and getattr(mesh, "shape", {}).get("model", 1) > 1):
        raise TypeError(
            f"a single-controller mesh of shape {mesh.shape} cannot shard "
            "within a model: use an LmMesh (launch.mesh.make_lm_mesh)")
    prev = current()
    _state.mesh, _state.rules = mesh, rules
    try:
        with contextlib.ExitStack() as stack:
            if is_lm_mesh(mesh):
                from torch.distributed.tensor.experimental import (
                    implicit_replication)
                stack.enter_context(implicit_replication())
            yield
    finally:
        _state.mesh, _state.rules = prev


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """``x`` placed by the logical-axis rules (one logical axis name, or
    None, per dim of ``x``).  Axes without a rule, an axis already used,
    one of extent 1, or one whose dim does not divide the mesh extent
    mean replicated along it (`dist.sharding.spec_to_pspec`).  Outside a
    context, and on a single-controller mesh, that placement is ``x`` as
    it is."""
    mesh, rules = current()
    if mesh is None or rules is None or not is_lm_mesh(mesh):
        return x
    from .sharding import placements, spec_to_pspec

    pl = placements(mesh, spec_to_pspec(rules, tuple(logical_axes),
                                        mesh=mesh, shape=tuple(x.shape)))
    x = as_dtensor(x, mesh)
    if any(p.is_partial() for p in x.placements):
        return _Reduce.apply(x, mesh.device_mesh, pl)
    return x.redistribute(mesh.device_mesh, pl)


class _Reduce(torch.autograd.Function):
    """A redistribution out of partial sums whose gradient goes back
    replicated along the axes where the input was partial.  Each partial
    sum's gradient is the whole sum's, so that is exact.  DTensor's own
    backward returns a partial gradient (torch 2.13 always, 2.11 in some
    plans), with which the backward of a row-parallel projection gathers
    its weight and runs whole on every rank of the model axis."""

    @staticmethod
    def forward(ctx, x, device_mesh, pl):
        from torch.distributed.tensor import Replicate

        ctx.device_mesh = device_mesh
        ctx.back = [Replicate() if p.is_partial() else p
                    for p in x.placements]
        return x.redistribute(device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.device_mesh, ctx.back), None, None


def shard_of(x, dim: int):
    """Where the DTensor ``x`` splits its dim ``dim`` over one mesh axis:
    ``(mesh dim, its process group, this rank's coordinate on it)``; None
    for a plain tensor, or where no single mesh axis splits that dim."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return None
    dim %= x.ndim
    hits = [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]
    if len(hits) != 1:
        return None
    i, = hits
    mesh = x.device_mesh
    return i, mesh.get_group(i), mesh.get_local_rank(i)


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """A copy of the plain tensor ``t`` all-reduced ("sum" or "max") over
    ``group``."""
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return out


class SumOver(torch.autograd.Function):
    """``all_reduce(x, "sum", group)`` whose gradient passes through: the
    sum is the same on every member of the group, and the gradient that
    reaches each member is the whole sum's (Megatron's reduction out of
    the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def batch_placements(x):
    """Placements of a tensor split like the DTensor ``x`` on its dim 0
    (the batch) and whole along every other mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]


def fsdp_gathered(w):
    """``w`` whole along the mesh axes that shard the batch, its other
    placements kept: an FSDP weight gathered once, so that a projection
    runs on each rank's batch shard (the batch axes cannot split both).
    Outside an `LmMesh` context, or on a plain tensor, ``w`` itself."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, rules = current()
    if not is_lm_mesh(mesh) or not isinstance(w, DTensor):
        return w
    batch = (rules or {}).get("batch") or ()
    batch = batch if isinstance(batch, tuple) else (batch,)
    pl = [Replicate() if name in batch else p
          for name, p in zip(w.device_mesh.mesh_dim_names, w.placements)]
    return w.redistribute(w.device_mesh, pl)


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh`` (an `LmMesh`): a plain tensor, equal
    on every rank, is replicated; a DTensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh.device_mesh,
                              [Replicate()] * len(mesh.axis_names),
                              run_check=False)


def local_region(fn, in_specs, out_specs, *tensors):
    """``fn`` on this rank's shards: the reference's ``shard_map`` through
    ``torch.distributed.tensor.experimental.local_map``.

    Each tensor is placed by its logical spec in ``in_specs`` (a plain
    tensor, equal on every rank, counts as replicated), ``fn`` runs on the
    local shards as plain tensors, and its result comes back as DTensors
    placed by ``out_specs``: one logical spec for a single tensor, a list
    of them for a tuple.  Outside an `LmMesh` context ``fn`` runs on the
    tensors as they are."""
    mesh, rules = current()
    if not is_lm_mesh(mesh):
        return fn(*tensors)
    from torch.distributed.tensor.experimental import local_map

    from .sharding import placements, spec_to_pspec

    def pl(spec):   # a list: local_map reads a tuple as several outputs
        return list(placements(mesh, spec_to_pspec(rules, tuple(spec),
                                                   mesh=mesh)))

    multi = isinstance(out_specs, list)
    out_pl = tuple(pl(s) for s in out_specs) if multi else pl(out_specs)
    run = local_map(fn, out_placements=out_pl,
                    in_placements=tuple(pl(s) for s in in_specs),
                    device_mesh=mesh.device_mesh, redistribute_inputs=True)
    return run(*(as_dtensor(t, mesh) for t in tensors))


def replicated_local(x: torch.Tensor) -> torch.Tensor:
    """The whole of ``x`` as a plain tensor on this rank (a DTensor is
    replicated first; autograd flows back through it), for a
    `local_region` body to close over."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(
        x.device_mesh, [Replicate()] * x.device_mesh.ndim).to_local()
