"""Pipeline parallelism over a mesh axis (GPipe-style skewed schedule), the
JAX package's ``repro.dist.pipeline``.

Every stage runs the same tick in lockstep: stage ``s`` processes
microbatch ``t - s`` at tick ``t``.  Without a mesh one process runs the
schedule over a stage-stacked buffer, as the reference does.  On an
`launch.mesh.LmMesh`, stage ``s`` lives on coordinate ``s`` of the
pipeline axis and holds one slot of that buffer: each tick shifts the
activations one stage on by point-to-point sends
(``torch.distributed.batch_isend_irecv`` on the axis's process group), the
reference's collective-permute.  Both give the same numbers: each stage
applies the same ``stage_fn`` to the same inputs.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B // n_micro, ...)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} microbatches")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def _stage_weight(stage_weights, s: int) -> torch.Tensor:
    """Stage ``s``'s weights: its slice of the stacked tensor, or the local
    shard of a DTensor sharded over the stages."""
    from torch.distributed.tensor import DTensor

    if isinstance(stage_weights, DTensor):
        local = stage_weights.to_local()
        if local.shape[0] != 1:
            raise ValueError("stage weights must shard one stage per rank")
        return local[0]
    return stage_weights[s]


def pipeline_apply(
    mesh,
    axis: Optional[str],
    stage_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    stage_weights: torch.Tensor,     # (n_stages, ...) stacked per-stage params
    xm: torch.Tensor,                # (n_micro, mb, ...) microbatched input
) -> torch.Tensor:
    """Run every microbatch through all stages; returns (n_micro, mb, ...)
    (on every rank of the pipeline axis, when there is one).

    ``stage_fn(w, x) -> y`` must be shape-preserving (uniform stage width),
    which is what lets one stacked buffer carry all in-flight activations.
    Total ticks = n_micro + n_stages - 1; the first n_stages - 1 outputs are
    bubble and are dropped."""
    n_stages = stage_weights.shape[0]
    if mesh is None or axis is None or axis not in mesh.shape:
        return _skewed(stage_fn, stage_weights, xm, n_stages)
    if mesh.shape[axis] != n_stages:
        raise ValueError(f"{n_stages} stages over a {axis!r} axis of "
                         f"{mesh.shape[axis]}")
    return _p2p(mesh, axis, stage_fn, stage_weights, xm, n_stages)


def _skewed(stage_fn, stage_weights, xm, n_stages: int) -> torch.Tensor:
    """The single-process schedule over a stage-stacked buffer."""
    n_micro, mb_shape = xm.shape[0], tuple(xm.shape[1:])
    buf = xm.new_zeros((n_stages,) + mb_shape)
    outs = []
    for t in range(n_micro + n_stages - 1):
        feed = xm[t] if t < n_micro else xm.new_zeros(mb_shape)
        # shift-in: stage 0 takes the next microbatch, stage s takes stage
        # s-1's previous output
        buf = torch.cat([feed[None], buf[:-1]], dim=0)
        buf = torch.stack([stage_fn(stage_weights[s], buf[s])
                           for s in range(n_stages)])
        if t >= n_stages - 1:
            outs.append(buf[-1])
    return torch.stack(outs, dim=0)


def _p2p(mesh, axis: str, stage_fn, stage_weights, xm,
         n_stages: int) -> torch.Tensor:
    """One stage per rank of ``axis``: a tick is the stage's apply, then
    its output goes to the next stage as the previous one's arrives."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    s = mesh.coordinate(axis)
    w = _stage_weight(stage_weights, s)
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < n_stages - 1 else None
    n_micro, mb_shape = xm.shape[0], tuple(xm.shape[1:])
    inp = xm.new_zeros(mb_shape)
    outs = []
    for t in range(n_micro + n_stages - 1):
        if s == 0:
            inp = xm[t] if t < n_micro else xm.new_zeros(mb_shape)
        y = stage_fn(w, inp)
        if s == n_stages - 1 and t >= n_stages - 1:
            outs.append(y)
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prev is not None:
            inp = xm.new_empty(mb_shape)
            ops.append(dist.P2POp(dist.irecv, inp, prev, group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    out = (torch.stack(outs, dim=0) if outs
           else xm.new_empty((n_micro,) + mb_shape))
    dist.broadcast(out, dist.get_global_rank(group, n_stages - 1),
                   group=group)
    return out
