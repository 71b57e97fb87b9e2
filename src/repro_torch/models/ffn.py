"""FFN substrate (the JAX package's ``repro.models.ffn``): dense gated
FFNs (SwiGLU, GeGLU, the plain GeLU MLP) and the top-k routed
Mixture-of-Experts.

The MoE dispatch is the reference's sort-based capacity dispatch, per
token group (`_dispatch_groups`): a stable sort of the token-expert
assignments by expert, a scatter of the kept ones into a ``(groups,
experts, capacity, d)`` buffer, the grouped SwiGLU as three einsums over
every expert, and a float32 combine.  The order of the sort decides which
assignments fall past the capacity and are dropped, so it is stable, as
``jnp.argsort`` is, and the top-k breaks ties toward the lower expert, as
``lax.top_k`` does.

On an `LmMesh` whose ``moe_group`` axis divides the groups, the scatter
into the expert buffer and the combine run shard-local, as the
reference's ``shard_map`` regions do: `dist.context.local_region` hands
each rank its groups, and the grouped einsums run on the
``experts``/``mlp``-sharded weights between them.  Elsewhere (no mesh, a
single-controller mesh, groups that do not divide) the same two
functions run on the whole tensors: each group's dispatch is local to it
anyway.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..dist.context import (constrain, current, fsdp_gathered,
                            is_lm_mesh, local_region)
from ..dist.sharding import data_axis_size
from . import nn


# ---------------------------------------------------------------------------
# Dense gated FFN
# ---------------------------------------------------------------------------
def ffn_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             dtype: torch.dtype, activation: str = "swiglu",
             device=None) -> nn.Params:
    p = {"wu": nn.dense_init(generator, d_model, d_ff, dtype, device=device),
         "wd": nn.dense_init(generator, d_ff, d_model, dtype, device=device)}
    if activation in ("swiglu", "geglu"):
        p["wg"] = nn.dense_init(generator, d_model, d_ff, dtype,
                                device=device)
    return p


def ffn_specs(activation: str = "swiglu") -> nn.Specs:
    s = {"wu": nn.dense_specs(("embed", "mlp")),
         "wd": nn.dense_specs(("mlp", "embed"))}
    if activation in ("swiglu", "geglu"):
        s["wg"] = nn.dense_specs(("embed", "mlp"))
    return s


def ffn_apply(p: nn.Params, x: torch.Tensor,
              activation: str = "swiglu") -> torch.Tensor:
    if activation == "swiglu":
        h = nn.silu(nn.dense(p["wg"], x)) * nn.dense(p["wu"], x)
    elif activation == "geglu":
        h = nn.gelu(nn.dense(p["wg"], x)) * nn.dense(p["wu"], x)
    else:  # gelu
        h = nn.gelu(nn.dense(p["wu"], x))
    wd = p["wd"]
    mesh, _ = current()
    if is_lm_mesh(mesh) and mesh.shape.get("model", 1) == 1:
        # On a data-only mesh DTensor replicates the up projections' output
        # and ran the down projection whole on every rank: h is pinned to
        # the batch axes, and the weight's FSDP shards (its output features
        # over the batch axes) are gathered once, so that it runs on each
        # rank's batch shard.
        h = constrain(h, "batch", *([None] * (h.ndim - 2)), "mlp")
        wd = dict(wd, w=fsdp_gathered(wd["w"]))
    return nn.dense(wd, h)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------
def moe_init(generator: Optional[torch.Generator], cfg, dtype: torch.dtype,
             device=None) -> nn.Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    p = {"router": nn.dense_init(generator, d, e, dtype, device=device),
         "wg": nn.lecun_init(generator, (e, d, f), dtype, fan_in=d,
                             device=device),
         "wu": nn.lecun_init(generator, (e, d, f), dtype, fan_in=d,
                             device=device),
         "wd": nn.lecun_init(generator, (e, f, d), dtype, fan_in=f,
                             device=device)}
    if cfg.n_shared_experts > 0:
        sf = cfg.n_shared_experts * cfg.expert_d_ff
        p["shared"] = ffn_init(generator, d, sf, dtype, "swiglu",
                               device=device)
        p["shared_gate"] = nn.dense_init(generator, d, 1, dtype,
                                         device=device)
    return p


def moe_specs(cfg) -> nn.Specs:
    s = {"router": nn.dense_specs(("embed", None)),
         "wg": ("experts", "embed", "mlp"),
         "wu": ("experts", "embed", "mlp"),
         "wd": ("experts", "mlp", "embed")}
    if cfg.n_shared_experts > 0:
        s["shared"] = ffn_specs("swiglu")
        s["shared_gate"] = nn.dense_specs(("embed", None))
    return s


def _dispatch_groups(t: int) -> int:
    """Dispatch groups: the largest of 32, 16, 8, 4, 2 that divides the
    ``t`` tokens into groups of at least 64; else one group."""
    for g in (32, 16, 8, 4, 2):
        if t % g == 0 and t // g >= 64:
            return g
    return 1


class Dispatch(NamedTuple):
    """The routing of one `moe_apply` call: every field but ``probs``,
    ``top_p`` and ``top_e`` (per token) is per group, over the group's
    ``tg * k`` assignments in the stable order of their expert."""
    probs: torch.Tensor      # (T, E) float32 router softmax
    top_p: torch.Tensor      # (T, k) float32, renormalised under norm_topk
    top_e: torch.Tensor      # (T, k) int64 routed experts
    sort_idx: torch.Tensor   # (G, Tg*k) the stable sort by expert
    sorted_e: torch.Tensor   # (G, Tg*k) each assignment's expert
    pos: torch.Tensor        # (G, Tg*k) its slot; ``cap`` where dropped
    counts: torch.Tensor     # (G, E) assignments per expert, before the drop
    cap: int


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p: nn.Params, cfg, xf: torch.Tensor,
              capacity_factor: float) -> Dispatch:
    """The reference's router and sort-based dispatch over ``xf`` (T, D)."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = (xf @ p["router"]["w"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)
    if cfg.moe_norm_topk:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    g = _dispatch_groups(t)
    tg = t // g
    # Python's round (half to even) on a Python float, as the reference
    cap = int(max(1, round(tg * k / e * capacity_factor)))
    flat_e = top_e.reshape(g, tg * k)
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    counts = flat_e.new_zeros((g, e)).scatter_add(1, flat_e,
                                                  torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=1) - counts
    pos_in_e = (torch.arange(tg * k, device=xf.device)[None, :]
                - torch.gather(offsets, 1, sorted_e))
    pos = torch.where(pos_in_e < cap, pos_in_e,
                      torch.full_like(pos_in_e, cap))
    return Dispatch(probs, top_p, top_e, sort_idx, sorted_e, pos, counts, cap)


def _scatter_local(xg: torch.Tensor, sorted_e: torch.Tensor,
                   pos: torch.Tensor, src_tok: torch.Tensor, e: int,
                   cap: int) -> torch.Tensor:
    """The kept assignments of each group into its (E, cap, D) expert
    buffer.  A dropped one lands in the extra row ``cap``, which is sliced
    off (the reference's out-of-bounds drop)."""
    gl, _, d = xg.shape
    gi = torch.arange(gl, device=xg.device)[:, None]
    hb = xg.new_zeros((gl, e, cap + 1, d))
    hb = hb.index_put((gi, sorted_e, pos), xg[gi, src_tok])
    return hb[:, :, :cap]


def _combine_local(out_e: torch.Tensor, sorted_e: torch.Tensor,
                   pos: torch.Tensor, src_tok: torch.Tensor,
                   w_sorted: torch.Tensor, tg: int) -> torch.Tensor:
    """Each group's tokens from the expert outputs: a gather with zero
    fill, weighted, summed per token in float32; (G, Tg, D)."""
    gl, e, _, d = out_e.shape
    gi = torch.arange(gl, device=out_e.device)[:, None]
    out_pad = torch.cat([out_e, out_e.new_zeros((gl, e, 1, d))], dim=2)
    gat = out_pad[gi, sorted_e, pos]                         # (G, Tg*k, D)
    contrib = (gat * w_sorted[..., None]).float()
    rows = (gi * tg + src_tok).reshape(-1)
    y = torch.zeros((gl * tg, d), dtype=torch.float32, device=out_e.device)
    return y.index_add(0, rows, contrib.reshape(-1, d)).reshape(gl, tg, d)


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("geca,eab->gecb", x, w)``: x (groups, experts, capacity,
    a), w (experts, a, b).

    On DTensors it runs shard-local with placements of its own, per mesh
    axis: x's groups or partial sums kept (w gathered whole), the experts
    where both shard them, the output features where w shards them, or
    partial sums where w shards the contracted dim (x sliced to match);
    any other pairing is gathered first.  Each pairing names its inputs'
    gradient placements: a whole w against x's shards gets partial sums
    of its gradient.  DTensor's einsum viewed the permuted shards by the
    global strides, which the local layout does not allow on some
    placements (qwen2-moe's 60 experts on a model axis of 16 come back
    from an uneven shard as a slice of a padded buffer)."""
    if not (nn.is_dtensor(x) or nn.is_dtensor(w)):
        return torch.einsum("geca,eab->gecb", x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = (x if nn.is_dtensor(x) else w).device_mesh
    rep = [Replicate()] * mesh.ndim
    xp = list(x.placements) if nn.is_dtensor(x) else rep
    wp = list(w.placements) if nn.is_dtensor(w) else rep
    R, P = Replicate(), Partial()
    # per mesh axis: (x, w, out, x's gradient, w's gradient)
    axes = []
    for px, pw in zip(xp, wp):
        dx = px.dim % 4 if isinstance(px, Shard) else None
        dw = pw.dim % 3 if isinstance(pw, Shard) else None
        if dx == 0:
            axes.append((px, R, px, px, P))
        elif isinstance(px, Partial):
            axes.append((px, R, px, R, P))
        elif (dx, dw) == (1, 0):
            axes.append((px, pw, Shard(1), px, pw))
        elif dx is None and dw == 2:
            axes.append((px, pw, Shard(3), P, pw))
        elif dw == 1 and dx in (None, 3):
            axes.append((Shard(3), pw, P, Shard(3), pw))
        else:
            axes.append((R, R, R, R, R))
    in_x, in_w, out, g_x, g_w = (list(a) for a in zip(*axes))
    run = local_map(lambda a, b: torch.einsum("geca,eab->gecb", a, b),
                    out_placements=out, in_placements=(in_x, in_w),
                    in_grad_placements=(g_x, g_w), device_mesh=mesh,
                    redistribute_inputs=True)
    return run(x, w)


def moe_apply(p: nn.Params, cfg, x: torch.Tensor,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), the switch load-balance aux loss, a
    float32 scalar)."""
    b, sl, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * sl
    # pinned to the batch axes: the backward brings the grad back onto
    # them before it unflattens (a grad sharded on d came back through
    # DTensor's view with the global d)
    xf = constrain(x.reshape(t, d), "batch", None)
    mesh, rules = current()
    if (is_lm_mesh(mesh) and _dispatch_groups(t)
            % data_axis_size(mesh, rules) != 0):
        # fewer groups than batch shards (a decode step's few tokens):
        # every rank routes every token, as the groups cannot split
        xf = constrain(xf, None, None)
    r = moe_route(p, cfg, xf, capacity_factor)
    g = r.sort_idx.shape[0]
    tg, cap = t // g, r.cap
    xg = constrain(xf.reshape(g, tg, d), "moe_group", None, None)
    src_tok = r.sort_idx // k                                # (G, Tg*k)
    w_sorted = torch.gather(r.top_p.reshape(g, tg * k), 1,
                            r.sort_idx).to(x.dtype)

    # the reference's condition for its shard_map over the group axis,
    # which on a multi-pod mesh spans ("pod", "data") (there the reference
    # leaves the dispatch to XLA's partitioner, and DTensor has no
    # sharding for its index on the nested batch shards)
    groups = {"batch": (rules or {}).get("moe_group")}
    local = (is_lm_mesh(mesh) and groups["batch"] is not None
             and g % data_axis_size(mesh, groups) == 0)

    scatter = functools.partial(_scatter_local, e=e, cap=cap)
    combine = functools.partial(_combine_local, tg=tg)
    route = (r.sorted_e, r.pos, src_tok)
    if local:
        hbuf = local_region(scatter, [("moe_group",)] * 4, ("moe_group",),
                            xg, *route)
    else:
        hbuf = scatter(xg, *route)
    hbuf = constrain(hbuf, "moe_group", "experts", None, None)

    # grouped expert FFN (SwiGLU) over every expert
    hg = _expert_mm(hbuf, p["wg"])
    hu = _expert_mm(hbuf, p["wu"])
    hh = nn.silu(hg) * hu
    hh = constrain(hh, "moe_group", "experts", None, "mlp")
    out_e = _expert_mm(hh, p["wd"])
    out_e = constrain(out_e, "moe_group", "experts", None, None)

    if local:
        y = local_region(combine, [("moe_group",)] * 5, ("moe_group",),
                         out_e, *route, w_sorted)
    else:
        y = combine(out_e, *route, w_sorted)
    # the tokens pinned to the batch axes: the backward then brings the
    # grad back onto them before it unflattens into groups (DTensor's
    # view of a grad also sharded on d into the groups fails)
    y = constrain(y.reshape(t, d), "batch", None).to(x.dtype)

    # shared experts (always on) behind a sigmoid gate
    if cfg.n_shared_experts > 0:
        gate = torch.sigmoid(xf @ p["shared_gate"]["w"]).to(x.dtype)
        y = y + gate * ffn_apply(p["shared"], xf, "swiglu")

    # switch-style load-balance loss, over the counts before the drop (they
    # sum to t * k: every token has k assignments)
    frac = r.counts.sum(0).float() / float(max(t * k, 1))
    aux = e * torch.sum(frac * r.probs.mean(dim=0))
    return y.reshape(b, sl, d), aux
