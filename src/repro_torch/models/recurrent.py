"""Recurrent blocks (the JAX package's ``repro.models.recurrent``): the
RG-LRU of RecurrentGemma/Griffin and the xLSTM cells, mLSTM and sLSTM.

Every recurrence is a loop over time with an explicit carried state
(`time_scan`, the counterpart of ``lax.scan``), so one apply function
serves training (the full sequence), prefill (building the state) and
decode (one step, state in and out).  The state is O(d) (RG-LRU, sLSTM)
or O(d_head^2) (mLSTM), whatever the context length.

State dtypes are the reference's: Griffin's ``h`` float32 and its conv
history in the model's dtype; mLSTM's ``C``, ``n`` and ``m`` float32 (``m``
starts at -1e30) with its conv history in the model's dtype; sLSTM's all
float32.  RG-LRU's ``lam`` is drawn and kept in float32 in any model.

On an `LmMesh` the time loops and the mLSTM cell run shard-local
(`dist.context.local_region`): the step-order loop has no sharding of its
own to propagate, so each rank walks its batch shard with plain tensors,
replicated over the model axis as the reference's constraints before each
cell replicate it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from ..core.counting import repeat, trips
from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..dist.context import (constrain, current, is_lm_mesh, local_region,
                            replicated_local)
from ..dist.sharding import data_axis_size
from . import nn

CONV_W = 4        # temporal conv width of the Griffin and xLSTM blocks
TIME_CHUNK = 256  # recompute granularity of the time loops under autograd
MLSTM_CHUNK = 64  # chunk of the chunkwise-parallel mLSTM


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _loop(step: Callable, carry, xs, lo: int, hi: int):
    ys = []
    for i in trips(hi - lo):
        carry, y = step(carry, tree_map(lambda x: x[lo + i], xs))
        ys.append(y)
    return carry, torch.stack(repeat(ys, hi - lo))


def _scan(step: Callable, carry, xs, chunk: int):
    t = tree_leaves(xs)[0].shape[0]
    records = torch.is_grad_enabled() and any(
        isinstance(l, torch.Tensor) and l.requires_grad
        for l in tree_leaves((carry, xs)))
    if t <= chunk or not records:
        return _loop(step, carry, xs, 0, t)
    ys = []
    n_full = t // chunk
    for c in trips(n_full):
        carry, y = torch.utils.checkpoint.checkpoint(
            _loop, step, carry, xs, c * chunk, (c + 1) * chunk,
            use_reentrant=False)
        ys.append(y)
    ys = repeat(ys, n_full)
    if t % chunk:
        carry, y = _loop(step, carry, xs, n_full * chunk, t)
        ys.append(y)
    return carry, torch.cat(ys, dim=0)


def _batch_axis(batch: int):
    """The logical axis of a batch dim inside a shard-local region on the
    current `LmMesh`: ``"batch"`` when the batch splits evenly over the
    data shards, else ``None`` (every rank walks the whole batch)."""
    mesh, rules = current()
    return "batch" if batch % data_axis_size(mesh, rules) == 0 else None


def time_scan(step: Callable, carry, xs, chunk: int = TIME_CHUNK):
    """``step(carry, x_t) -> (carry, y_t)`` over the leading (time) axis
    of ``xs`` (a tensor or a tuple of tensors); returns (carry, the y_t
    stacked).

    When autograd records and the sequence is longer than ``chunk``, each
    full chunk runs under ``torch.utils.checkpoint``: the backward pass
    keeps the carry at chunk boundaries only and recomputes inside a chunk
    (the reference's ``jax.checkpoint`` of its chunk body), which for the
    mLSTM's (B, H, dh, dh) state is the difference between O(T) and
    O(T / chunk) saved states.

    Under an `LmMesh` context the loop runs on each rank's batch shard
    (carries batch-leading, ``xs`` and the ``y_t`` time-major); ``step``
    must then close over plain tensors only (`replicated_local`)."""
    if not is_lm_mesh(current()[0]):
        return _scan(step, carry, xs, chunk)
    c_leaves, x_leaves = tree_leaves(carry), tree_leaves(xs)
    n_c = len(c_leaves)
    bat = (_batch_axis(c_leaves[0].shape[0]),)
    tm = (None,) + bat

    def body(*leaves):
        c, ys = _scan(step, tree_unflatten(carry, leaves[:n_c]),
                      tree_unflatten(xs, leaves[n_c:]), chunk)
        return (*tree_leaves(c), ys)

    out = local_region(body, [bat] * n_c + [tm] * len(x_leaves),
                       [bat] * n_c + [tm], *c_leaves, *x_leaves)
    return tree_unflatten(carry, out[:n_c]), out[n_c]


# ---------------------------------------------------------------------------
# temporal conv1d with decode state
# ---------------------------------------------------------------------------
def conv1d_init(generator: Optional[torch.Generator], d: int,
                dtype: torch.dtype, device=None) -> nn.Params:
    dev = generator.device if generator is not None else device
    return {"w": nn.lecun_init(generator, (CONV_W, d), dtype, fan_in=CONV_W,
                               device=device),
            "b": torch.zeros((d,), dtype=dtype, device=dev)}


def conv1d_apply(p: nn.Params, x: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Causal depthwise conv.  x: (B, S, D); state: the (B, CONV_W-1, D)
    history.  Returns (y, the new history)."""
    b, sl, d = x.shape
    hist = (state if state is not None
            else torch.zeros((b, CONV_W - 1, d), dtype=x.dtype,
                             device=x.device))
    xx = torch.cat([hist, x], dim=1)
    y = sum(xx[:, i:i + sl, :] * p["w"][i] for i in range(CONV_W)) + p["b"]
    return y.to(x.dtype), xx[:, -(CONV_W - 1):, :]


# ---------------------------------------------------------------------------
# RG-LRU (Real-Gated Linear Recurrent Unit), Griffin eq. (1)-(4)
# ---------------------------------------------------------------------------
def _uniform(generator: Optional[torch.Generator], shape,
             device) -> torch.Tensor:
    """U[0, 1) float32 from ``generator`` on its device (uninitialised on
    ``device`` without one)."""
    if generator is None:
        return torch.empty(shape, device=device)
    return torch.rand(shape, generator=generator, device=generator.device)


def rglru_init(generator: Optional[torch.Generator], d: int,
               dtype: torch.dtype, device=None) -> nn.Params:
    return {"wa": nn.lecun_init(generator, (d, d), dtype, device=device),
            "wx": nn.lecun_init(generator, (d, d), dtype, device=device),
            "lam": (8.0 * _uniform(generator, (d,), device) + 2.0
                    ).to(torch.float32)}


def rglru_apply(p: nn.Params, x: torch.Tensor,
                h0: Optional[torch.Tensor] = None):
    """x: (B, S, D) -> (y (B, S, D), h_final (B, D) float32); c = 8, as in
    Griffin."""
    b, sl, d = x.shape
    r = torch.sigmoid(x @ p["wa"]).float()
    i = torch.sigmoid(x @ p["wx"]).float()
    log_a = -8.0 * r * softplus(p["lam"])                 # (B, S, D) f32
    a = torch.exp(log_a)
    gated_x = i * x.float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bt = beta * gated_x
    h_init = (h0.float() if h0 is not None
              else torch.zeros((b, d), dtype=torch.float32, device=x.device))

    def step(h, inp):
        a_t, b_t = inp
        h = a_t * h + b_t
        return h, h

    h_fin, ys = time_scan(step, h_init,
                          (a.transpose(0, 1), bt.transpose(0, 1)))
    return ys.transpose(0, 1).to(x.dtype), h_fin


def griffin_block_init(generator: Optional[torch.Generator], cfg,
                       dtype: torch.dtype, device=None) -> nn.Params:
    """Griffin's recurrent block: a GeLU gate branch beside conv1d ->
    RG-LRU."""
    d = cfg.d_model
    dr = cfg.rnn_width or d
    return {"in_x": nn.dense_init(generator, d, dr, dtype, device=device),
            "in_g": nn.dense_init(generator, d, dr, dtype, device=device),
            "conv": conv1d_init(generator, dr, dtype, device),
            "rglru": rglru_init(generator, dr, dtype, device),
            "out": nn.dense_init(generator, dr, d, dtype, device=device)}


def griffin_block_specs(cfg) -> nn.Specs:
    return {"in_x": nn.dense_specs(("embed", "rnn")),
            "in_g": nn.dense_specs(("embed", "rnn")),
            "conv": {"w": (None, "rnn"), "b": ("rnn",)},
            "rglru": {"wa": ("rnn", "rnn2"), "wx": ("rnn", "rnn2"),
                      "lam": ("rnn2",)},
            "out": nn.dense_specs(("rnn", "embed"))}


def griffin_block_apply(p: nn.Params, cfg, x: torch.Tensor,
                        state: Optional[Dict] = None):
    gate = nn.gelu(nn.dense(p["in_g"], x))
    xr = nn.dense(p["in_x"], x)
    conv_state = state["conv"] if state is not None else None
    h0 = state["h"] if state is not None else None
    xc, new_conv = conv1d_apply(p["conv"], xr, conv_state)
    y, h_fin = rglru_apply(p["rglru"], xc, h0)
    out = nn.dense(p["out"], gate * y)
    return out, {"conv": new_conv, "h": h_fin}


def griffin_state_init(cfg, batch: int, dtype: torch.dtype, device,
                       full=None):
    full = full or nn.full_on(device)
    dr = cfg.rnn_width or cfg.d_model
    return {"conv": full((batch, CONV_W - 1, dr), 0, dtype),
            "h": full((batch, dr), 0, torch.float32)}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory cell)
#
# Two equal evaluation orders: the step recurrence (decode, short
# sequences), which touches the (dh x dh) state every step, and the
# chunkwise-parallel order (train and prefill), an L x L masked attention
# within each chunk of L tokens with the state read and written once per
# chunk.  Both use the stabiliser m_t = g_t + max(m0, cummax(li - g)).
# ---------------------------------------------------------------------------
def mlstm_chunkwise(q, k, v, log_i, log_f, c0, n0, m0,
                    chunk: int = MLSTM_CHUNK):
    """q, k, v: (B, S, H, dh); log_i, log_f: (B, S, H) float32; states c0
    (B, H, dh, dh), n0 (B, H, dh), m0 (B, H).  Returns (h (B, S, H, dh)
    float32, (c1, n1, m1))."""
    b, s, hh, dh = q.shape
    nc = s // chunk
    assert s % chunk == 0

    def resh(x):
        return (x.reshape(b, nc, chunk, hh, -1)
                .permute(1, 0, 3, 2, 4).float())          # (nc, B, H, L, dh)

    qc, kc, vc = resh(q), resh(k), resh(v)
    gi = log_i.reshape(b, nc, chunk, hh).permute(1, 0, 3, 2)  # (nc, B, H, L)
    gf = log_f.reshape(b, nc, chunk, hh).permute(1, 0, 3, 2)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    c0h, n0h, m0_ = c0, n0, m0
    hs = []
    for j in trips(nc):
        qb, kb, vb, li, lf = qc[j], kc[j], vc[j], gi[j], gf[j]
        g = torch.cumsum(lf, dim=-1)                       # (B, H, L)
        a = li - g
        mc_run = torch.cummax(a, dim=-1).values
        m_t = torch.maximum(m0_[..., None], mc_run)        # (B, H, L)
        # intra-chunk: D[t, s] = exp(a_s - M_t) for s <= t (all <= 1); the
        # masked entries are exp(-inf), so no overflow reaches a gradient
        expo = a[:, :, None, :] - m_t[..., None]
        d = torch.exp(torch.where(mask, expo,
                                  torch.full_like(expo, float("-inf"))))
        scores = torch.einsum("bhtd,bhsd->bhts", qb, kb) * d
        num = torch.einsum("bhts,bhsd->bhtd", scores, vb)
        den = scores.sum(dim=-1)
        # inter-chunk: the carried state
        w0 = torch.exp(m0_[..., None] - m_t)
        num = num + w0[..., None] * torch.einsum("bhtk,bhvk->bhtv", qb, c0h)
        den = den + w0 * torch.einsum("bhtk,bhk->bht", qb, n0h)
        hs.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        # the state: read and written once per chunk
        mcf = mc_run[..., -1]
        m_max = torch.maximum(m0_, mcf)
        m1 = g[..., -1] + m_max
        sc_old = torch.exp(m0_ - m_max)
        w_s = torch.exp(a - m_max[..., None])               # (B, H, L)
        c0h = (sc_old[..., None, None] * c0h
               + torch.einsum("bhsv,bhsk->bhvk", vb * w_s[..., None], kb))
        n0h = sc_old[..., None] * n0h + torch.einsum("bhs,bhsk->bhk", w_s, kb)
        m0_ = m1
    h = torch.stack(repeat(hs, nc)).permute(1, 0, 3, 2, 4)
    h = h.reshape(b, s, hh, dh)
    return h, (c0h, n0h, m0_)


def mlstm_block_init(generator: Optional[torch.Generator], cfg,
                     dtype: torch.dtype, device=None) -> nn.Params:
    d = cfg.d_model
    di = 2 * d                       # xLSTM projection factor 2
    h = cfg.n_heads
    dh = di // h
    p = {"up": nn.dense_init(generator, d, 2 * di, dtype, device=device),
         "conv": conv1d_init(generator, di, dtype, device)}
    # block-diagonal (per-head) q/k/v projections, as in the xLSTM paper
    for nm in ("wq", "wk", "wv"):
        p[nm] = {"w": nn.lecun_init(generator, (h, dh, dh), dtype,
                                    fan_in=dh, device=device)}
    p["wi"] = nn.dense_init(generator, di, h, dtype, device=device)
    p["wf"] = nn.dense_init(generator, di, h, dtype, device=device)
    p["down"] = nn.dense_init(generator, di, d, dtype, device=device)
    return p


def mlstm_block_specs(cfg) -> nn.Specs:
    s = {"up": nn.dense_specs(("embed", "rnn")),
         "conv": {"w": (None, "rnn"), "b": ("rnn",)},
         "wi": nn.dense_specs(("rnn", None)),
         "wf": nn.dense_specs(("rnn", None)),
         "down": nn.dense_specs(("rnn", "embed"))}
    for nm in ("wq", "wk", "wv"):
        s[nm] = {"w": ("heads", None, None)}
    return s


def mlstm_state_init(cfg, batch: int, dtype: torch.dtype, device,
                     full=None):
    full = full or nn.full_on(device)
    di = 2 * cfg.d_model
    h = cfg.n_heads
    dh = di // h
    f32 = torch.float32
    return {"C": full((batch, h, dh, dh), 0, f32),
            "n": full((batch, h, dh), 0, f32),
            "m": full((batch, h), -1e30, f32),
            "conv": full((batch, CONV_W - 1, di), 0, dtype)}


def _mlstm_step(carry, inp):
    c, n, m = carry
    qt, kt, vt, li, lf = inp                     # (B, H, dh) x3, (B, H) x2
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)[..., None]
    ip = torch.exp(li - m_new)[..., None]
    kt32, vt32, qt32 = kt.float(), vt.float(), qt.float()
    c = (fp[..., None] * c
         + ip[..., None] * (vt32[..., :, None] * kt32[..., None, :]))
    n = fp * n + ip * kt32
    num = torch.einsum("bhvk,bhk->bhv", c, qt32)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", n, qt32).abs(), min=1.0)
    return (c, n, m_new), num / den[..., None]


def mlstm_block_apply(p: nn.Params, cfg, x: torch.Tensor,
                      state: Optional[Dict] = None):
    b, sl, d = x.shape
    di = 2 * d
    hh = cfg.n_heads
    dh = di // hh
    up = nn.dense(p["up"], x)
    xm, z = torch.chunk(up, 2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = conv1d_apply(p["conv"], xm, conv_state)
    xc = nn.silu(xc)
    xc = constrain(xc, "batch", None, None)
    xh = xc.reshape(b, sl, hh, dh)
    log_i = nn.dense(p["wi"], xc).float()                  # (B, S, H)
    log_f = -softplus(-nn.dense(p["wf"], xc).float())

    if state is not None:
        c0, n0, m0 = state["C"], state["n"], state["m"]
    else:
        st = mlstm_state_init(cfg, b, x.dtype, x.device)
        c0, n0, m0 = st["C"], st["n"], st["m"]

    def cell(xh, wq, wk, wv, log_i, log_f, c0, n0, m0):
        q = torch.einsum("bshd,hde->bshe", xh, wq)
        k = torch.einsum("bshd,hde->bshe", xh, wk) * (dh ** -0.5)
        v = torch.einsum("bshd,hde->bshe", xh, wv)
        if sl % MLSTM_CHUNK == 0 and sl >= 2 * MLSTM_CHUNK:
            # the chunkwise-parallel order (train, prefill)
            h, (c, n, m) = mlstm_chunkwise(q, k, v, log_i, log_f, c0, n0, m0)
            return h, c, n, m
        seq = (q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
               log_i.transpose(0, 1), log_f.transpose(0, 1))
        (c, n, m), ys = _scan(_mlstm_step, (c0, n0, m0), seq, TIME_CHUNK)
        return ys.transpose(0, 1), c, n, m

    # the cell runs on each rank's batch shard with every head, as the
    # reference's constraint on xc replicates it: its per-head weights are
    # tiny, and DTensor has no strategy for cummax nor, on some torch
    # releases, for the head-batched einsums on sharded heads
    bat = _batch_axis(b) if is_lm_mesh(current()[0]) else None
    w = (None, None, None)
    h4, c_f, n_f, m_f = local_region(
        cell, [(bat, None, None, None), w, w, w, (bat, None, None),
               (bat, None, None), (bat, None, None, None), (bat, None, None),
               (bat, None)],
        [(bat, None, None, None), (bat, None, None, None), (bat, None, None),
         (bat, None)],
        xh, p["wq"]["w"], p["wk"]["w"], p["wv"]["w"], log_i, log_f,
        c0, n0, m0)
    h_seq = h4.reshape(b, sl, di).to(x.dtype)
    out = nn.dense(p["down"], h_seq * nn.silu(z))
    return out, {"C": c_f, "n": n_f, "m": m_f, "conv": new_conv}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM's scalar cell with a hidden-state recurrence)
# ---------------------------------------------------------------------------
def slstm_block_init(generator: Optional[torch.Generator], cfg,
                     dtype: torch.dtype, device=None) -> nn.Params:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {"wx": nn.dense_init(generator, d, 4 * d, dtype, device=device),
            # block-diagonal (per-head) recurrent matrices, 4 gates
            "r": nn.lecun_init(generator, (4, h, dh, dh), dtype, fan_in=dh,
                               device=device),
            "out": nn.dense_init(generator, d, d, dtype, device=device),
            "ffn": nn.dense_init(generator, d, d, dtype, device=device)}


def slstm_state_init(cfg, batch: int, dtype: torch.dtype, device,
                     full=None):
    full = full or nn.full_on(device)
    shape = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    f32 = torch.float32
    return {"c": full(shape, 0, f32), "n": full(shape, 0, f32),
            "h": full(shape, 0, f32), "m": full(shape, -1e30, f32)}


def slstm_block_specs(cfg) -> nn.Specs:
    return {"wx": nn.dense_specs(("embed", "rnn")),
            "r": (None, "heads", None, None),
            "out": nn.dense_specs(("rnn", "embed")),
            "ffn": nn.dense_specs(("embed", "mlp"))}


def slstm_block_apply(p: nn.Params, cfg, x: torch.Tensor,
                      state: Optional[Dict] = None):
    b, sl, d = x.shape
    hh, dh = cfg.n_heads, d // cfg.n_heads
    gx = nn.dense(p["wx"], x)
    gx = constrain(gx, "batch", None, None)
    gx = gx.reshape(b, sl, 4, hh, dh).float()
    if state is None:
        state = slstm_state_init(cfg, b, x.dtype, x.device)
    c0, n0, h0, m0 = state["c"], state["n"], state["h"], state["m"]
    r = replicated_local(p["r"].float())

    def step(carry, g_t):
        c, n, h, m = carry
        rec = torch.einsum("bhd,ghde->gbhe", h, r)         # (4, B, H, dh)
        zi = g_t[:, 0] + rec[0]
        zf = g_t[:, 1] + rec[1]
        zz = g_t[:, 2] + rec[2]
        zo = g_t[:, 3] + rec[3]
        log_f = -softplus(-zf)                             # log sigmoid
        m_new = torch.maximum(log_f + m, zi)
        ip = torch.exp(zi - m_new)
        fp = torch.exp(log_f + m - m_new)
        c = fp * c + ip * torch.tanh(zz)
        n = fp * n + ip
        h_new = torch.sigmoid(zo) * c / torch.clamp(n, min=1.0)
        return (c, n, h_new, m_new), h_new

    (c_f, n_f, h_f, m_f), ys = time_scan(step, (c0, n0, h0, m0),
                                         gx.transpose(0, 1))
    h_seq = ys.transpose(0, 1).reshape(b, sl, d).to(x.dtype)
    y = nn.dense(p["out"], h_seq)
    y = y + nn.gelu(nn.dense(p["ffn"], y))
    return y, {"c": c_f, "n": n_f, "h": h_f, "m": m_f}
