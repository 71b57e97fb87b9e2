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
``lax.top_k`` does.  The reference's ``shard_map`` dispatch (a mesh with a
``moe_group`` axis) waits for sharding within a model (ROADMAP.md A16,
item 4) and raises here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..dist.context import constrain, current
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


def ffn_apply(p: nn.Params, x: torch.Tensor,
              activation: str = "swiglu") -> torch.Tensor:
    if activation == "swiglu":
        h = nn.silu(nn.dense(p["wg"], x)) * nn.dense(p["wu"], x)
    elif activation == "geglu":
        h = nn.gelu(nn.dense(p["wg"], x)) * nn.dense(p["wu"], x)
    else:  # gelu
        h = nn.gelu(nn.dense(p["wu"], x))
    return nn.dense(p["wd"], h)


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
    counts = torch.zeros((g, e), dtype=torch.int64, device=xf.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=1) - counts
    pos_in_e = (torch.arange(tg * k, device=xf.device)[None, :]
                - torch.gather(offsets, 1, sorted_e))
    pos = torch.where(pos_in_e < cap, pos_in_e,
                      torch.full_like(pos_in_e, cap))
    return Dispatch(probs, top_p, top_e, sort_idx, sorted_e, pos, counts, cap)


def moe_apply(p: nn.Params, cfg, x: torch.Tensor,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), the switch load-balance aux loss, a
    float32 scalar)."""
    b, sl, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * sl
    xf = x.reshape(t, d)
    r = moe_route(p, cfg, xf, capacity_factor)
    g = r.sort_idx.shape[0]
    tg, cap = t // g, r.cap
    mesh, rules = current()
    dp_axis = (rules or {}).get("moe_group")
    if (mesh is not None and dp_axis in getattr(mesh, "shape", {})
            and g % mesh.shape[dp_axis] == 0):
        raise NotImplementedError(
            f"moe_apply over the mesh axis {dp_axis!r}: the shard-local "
            "dispatch waits for sharding within a model (ROADMAP.md A16, "
            "item 4)")
    xg = constrain(xf.reshape(g, tg, d), "moe_group", None, None)
    gi = torch.arange(g, device=x.device)[:, None]
    src_tok = r.sort_idx // k                                # (G, Tg*k)

    # scatter: a dropped assignment lands in the extra row ``cap``, which
    # is sliced off (the reference's out-of-bounds drop)
    hb = x.new_zeros((g, e, cap + 1, d))
    hb = hb.index_put((gi, r.sorted_e, r.pos), xg[gi, src_tok])
    hbuf = constrain(hb[:, :, :cap], "moe_group", "experts", None, None)

    # grouped expert FFN (SwiGLU) over every expert
    hg = torch.einsum("gecd,edf->gecf", hbuf, p["wg"])
    hu = torch.einsum("gecd,edf->gecf", hbuf, p["wu"])
    hh = nn.silu(hg) * hu
    out_e = torch.einsum("gecf,efd->gecd", hh, p["wd"])

    # combine: gather with zero fill, weight, sum per token in float32
    w_sorted = torch.gather(r.top_p.reshape(g, tg * k), 1,
                            r.sort_idx).to(x.dtype)
    out_pad = torch.cat([out_e, out_e.new_zeros((g, e, 1, d))], dim=2)
    gat = out_pad[gi, r.sorted_e, r.pos]                      # (G, Tg*k, D)
    contrib = (gat * w_sorted[..., None]).float()
    rows = (gi * tg + src_tok).reshape(-1)
    y = torch.zeros((g * tg, d), dtype=torch.float32, device=x.device)
    y = y.index_add(0, rows, contrib.reshape(-1, d))
    y = y.to(x.dtype)

    # shared experts (always on) behind a sigmoid gate
    if cfg.n_shared_experts > 0:
        gate = torch.sigmoid(xf @ p["shared_gate"]["w"]).to(x.dtype)
        y = y + gate * ffn_apply(p["shared"], xf, "swiglu")

    # switch-style load-balance loss, over the counts before the drop (they
    # sum to t * k: every token has k assignments)
    frac = r.counts.sum(0).float() / float(max(t * k, 1))
    aux = e * torch.sum(frac * r.probs.mean(dim=0))
    return y.reshape(b, sl, d), aux
