"""Attention substrate (the JAX package's ``repro.models.attention``):
GQA/MQA/MHA, the RoPE variants, blocked attention with an online softmax,
local/global windows, logit softcapping, and KV caches (a full cache for
global layers, a ring buffer of ``local_window`` for local ones, int8 with
per-(token, head) scales under ``kv_quant``).

Plain PyTorch, as the reference computes all of it outside any Pallas
kernel: `blocked_attention` walks the same query and key blocks with the
same running max, sum and masks as the reference's scans (one Python loop
per scan), so its results follow the reference's and not those of
``scaled_dot_product_attention``.  Scores and the weighted sums of values
are float32 whatever the model's dtype, as the reference's
``preferred_element_type=float32`` einsums are.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..core.counting import repeat, trips
from ..dist.context import constrain, current, is_lm_mesh, local_region
from ..dist.sharding import data_axis_size
from . import nn

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


def _attn_tp_divisible(n_heads: int) -> bool:
    """True when the attention heads split the model axis.  When they do
    not (minitron's 24 heads, qwen2-vl's 28 and musicgen's 24 on a model
    axis of 16), train and prefill replicate the attention compute and
    keep the tensor parallelism on the projections and the FFN: sharding
    the head dim instead would make every score tile a cross-shard
    contraction."""
    mesh, _ = current()
    if mesh is None:
        return True
    return n_heads % mesh.shape.get("model", 1) == 0


def split_heads(y: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(..., n * dh) -> (..., n, dh).  A feature dim sharded on the model
    axis across head boundaries (n heads that do not divide it) is
    gathered first: DTensor cannot split a shard between heads, where the
    reference's compiler re-lays it out."""
    if nn.is_dtensor(y) and not _attn_tp_divisible(n):
        lead = ("batch",) if y.ndim == 3 else (None,)
        y = constrain(y, *lead, *((None,) * (y.ndim - 1)))
    return y.reshape(*y.shape[:-1], n, dh)


def merge_heads(y: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(..., n, dh) -> (..., n * dh), `split_heads` undone.  With n heads
    that do not divide the model axis the merged dim's gradient comes back
    from the row-parallel ``wo`` sharded across head boundaries, which the
    reshape's backward cannot split either (torch 2.11 refuses it): the
    constraint, the identity forward, gathers it first."""
    y = y.reshape(*y.shape[:-2], n * dh)
    if nn.is_dtensor(y) and not _attn_tp_divisible(n):
        lead = ("batch",) if y.ndim == 3 else (None,)
        y = constrain(y, *lead, *((None,) * (y.ndim - 1)))
    return y


# ---------------------------------------------------------------------------
# RoPE family
# ---------------------------------------------------------------------------
def rope_freqs(rotary_dim: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, rotary_dim // 2, dtype=torch.float32, device=device)
    return theta ** (-2.0 * i / rotary_dim)


def apply_rope(
    x: torch.Tensor,                # (B, S, H, Dh)
    positions: torch.Tensor,        # (B, S) int, or (3, B, S) for M-RoPE
    theta: float = 10000.0,
    rotary_frac: float = 1.0,       # chatglm3's "2d" RoPE: 0.5 (partial)
    mrope_sections: Optional[Tuple[int, ...]] = None,  # qwen2-vl (16, 24, 24)
) -> torch.Tensor:
    dh = x.shape[-1]
    rd = int(dh * rotary_frac)
    rd -= rd % 2
    freqs = rope_freqs(rd, theta, x.device)                # (rd/2,)
    if positions.ndim == 3:
        # M-RoPE: each frequency band takes its position channel.
        assert mrope_sections is not None
        sec_ids = torch.cat([
            torch.full((s,), i, dtype=torch.long, device=x.device)
            for i, s in enumerate(mrope_sections)])       # (rd/2,)
        pos = positions.float()                            # (3, B, S)
        angles = pos[sec_ids].permute(1, 2, 0) * freqs     # (B, S, rd/2)
    else:
        angles = positions.float()[..., None] * freqs      # (B, S, rd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Blocked attention with online softmax
# ---------------------------------------------------------------------------
def _pad_seq(t: torch.Tensor, to: int, value=0) -> torch.Tensor:
    """``t`` padded with ``value`` along dim 1 to length ``to``."""
    if t.shape[1] == to:
        return t
    pad = t.new_full((t.shape[0], to - t.shape[1], *t.shape[2:]), value)
    return torch.cat([t, pad], dim=1)


def blocked_attention(
    q: torch.Tensor,                # (B, Sq, H, Dh)
    k: torch.Tensor,                # (B, Skv, Hkv, Dh)
    v: torch.Tensor,                # (B, Skv, Hkv, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap_val: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,   # valid kv prefix length (decode caches)
    kv_positions: Optional[torch.Tensor] = None,  # (Skv,) ring positions
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # (B, Skv, Hkv, 1) int8-KV scales
    v_scale: Optional[torch.Tensor] = None,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else dh ** -0.5
    kv_len = kv_len if kv_len is not None else skv
    dev = q.device

    block_q = min(block_q, sq)
    block_k = min(block_k, skv)
    nq = -(-sq // block_q)
    nk = -(-skv // block_k)
    sq_p, skv_p = nq * block_q, nk * block_k

    qp = _pad_seq(q, sq_p)
    kp = _pad_seq(k, skv_p)
    vp = _pad_seq(v, skv_p)
    quant = k_scale is not None
    if quant:
        ksp = _pad_seq(k_scale, skv_p)
        vsp = _pad_seq(v_scale, skv_p)

    q_positions = q_offset + torch.arange(sq_p, dtype=torch.int32,
                                          device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(skv_p, dtype=torch.int32, device=dev)
    elif skv_p > skv:
        kv_positions = torch.cat([kv_positions, kv_positions.new_full(
            (skv_p - skv,), INT32_MAX)])

    blocks = []
    for qi in trips(nq):
        qb = qp[:, qi * block_q:(qi + 1) * block_q]
        qb = qb.reshape(b, block_q, hkv, g, dh).permute(0, 2, 3, 1, 4).float()
        qpos = q_positions[qi * block_q:(qi + 1) * block_q]
        m = torch.full((b, hkv, g, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, block_q, dh), dtype=torch.float32,
                          device=dev)
        for ki in trips(nk):
            kb = kp[:, ki * block_k:(ki + 1) * block_k]
            vb = vp[:, ki * block_k:(ki + 1) * block_k]
            if quant:  # dequantize on read: only the block leaves int8
                ksb = ksp[:, ki * block_k:(ki + 1) * block_k]
                vsb = vsp[:, ki * block_k:(ki + 1) * block_k]
                kb = kb.to(ksb.dtype) * ksb
                vb = vb.to(vsb.dtype) * vsb
            kpos = kv_positions[ki * block_k:(ki + 1) * block_k]
            s = torch.einsum("bhgqd,bkhd->bhgqk", qb, kb.float()) * scale
            s = nn.softcap(s, softcap_val)
            mask = kpos[None, :] < kv_len
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        blocks.append(acc / torch.clamp(l, min=1e-30)[..., None])
    # per block (B, Hkv, G, bq, Dh) -> (B, Sq, H, Dh)
    out = torch.stack(repeat(blocks, nq), dim=0).permute(1, 0, 4, 2, 3, 5)
    return out.reshape(b, sq_p, h, dh)[:, :sq].to(q.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: bool,
            k_scale: Optional[torch.Tensor] = None,
            v_scale: Optional[torch.Tensor] = None,
            kv_positions: Optional[torch.Tensor] = None,
            **kw) -> torch.Tensor:
    """`blocked_attention`; on an `LmMesh`, shard-local
    (`dist.context.local_region`): each rank attends its batch shard and,
    with ``heads`` (q and kv heads both divide the model axis), its heads,
    else every head.  Attention mixes nothing across heads or batch rows,
    and DTensor cannot run its einsums on sharded heads (on some torch
    releases it refuses to flatten the batch and a sharded head dim)."""
    mesh, rules = current()
    if not is_lm_mesh(mesh):
        return blocked_attention(q, k, v, k_scale=k_scale, v_scale=v_scale,
                                 kv_positions=kv_positions, **kw)
    bat = "batch" if q.shape[0] % data_axis_size(mesh, rules) == 0 else None
    sq = (bat, None, "heads" if heads else None, None)
    sk = (bat, None, "kv_heads" if heads else None, None)
    quant = k_scale is not None
    tensors = [q, k, v] + ([k_scale, v_scale] if quant else []) + (
        [kv_positions] if kv_positions is not None else [])
    specs = [sq, sk, sk] + ([sk, sk] if quant else []) + (
        [(None,)] if kv_positions is not None else [])

    def body(q, k, v, *rest):
        scales = rest[:2] if quant else (None, None)
        pos = rest[-1] if kv_positions is not None else None
        return blocked_attention(q, k, v, k_scale=scales[0],
                                 v_scale=scales[1], kv_positions=pos, **kw)

    return local_region(body, specs, sq, *tensors)


# ---------------------------------------------------------------------------
# Attention layer (init/apply) with KV cache
# ---------------------------------------------------------------------------
def attention_init(generator: Optional[torch.Generator], cfg,
                   dtype: torch.dtype, layer_kind: str = "global",
                   device=None) -> nn.Params:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": nn.dense_init(generator, d, h * dh, dtype, bias=cfg.qkv_bias,
                            device=device),
        "wk": nn.dense_init(generator, d, hkv * dh, dtype,
                            bias=cfg.qkv_bias, device=device),
        "wv": nn.dense_init(generator, d, hkv * dh, dtype,
                            bias=cfg.qkv_bias, device=device),
        "wo": nn.dense_init(generator, h * dh, d, dtype, device=device),
    }


def attention_specs(cfg) -> nn.Specs:
    return {
        "wq": nn.dense_specs(("embed", "heads"), bias=cfg.qkv_bias),
        "wk": nn.dense_specs(("embed", "kv_heads"), bias=cfg.qkv_bias),
        "wv": nn.dense_specs(("embed", "kv_heads"), bias=cfg.qkv_bias),
        "wo": nn.dense_specs(("heads", "embed")),
    }


def init_kv_cache(cfg, batch: int, max_len: int, layer_kind: str,
                  dtype: torch.dtype, device, full=None
                  ) -> Dict[str, torch.Tensor]:
    """Cache for ONE attention layer.  Local layers use a ring buffer
    bounded by the attention window.  With ``cfg.kv_quant``, k/v are int8
    with per-(token, head) scales.  ``full``: the allocator
    (`nn.full_on(device)` by default)."""
    full = full or nn.full_on(device)
    size = max_len if layer_kind == "global" else min(cfg.local_window,
                                                      max_len)
    kv_dtype = torch.int8 if cfg.kv_quant else dtype
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": full(shape, 0, kv_dtype), "v": full(shape, 0, kv_dtype),
             "slot_pos": full((size,), -1, torch.int32)}
    if cfg.kv_quant:
        sshape = (batch, size, cfg.n_kv_heads, 1)
        cache["k_scale"] = full(sshape, 0, dtype)
        cache["v_scale"] = full(sshape, 0, dtype)
    return cache


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, Hkv, Dh) -> (int8 values, per-(token, head) scales).  Rounds
    half to even, as the reference's ``jnp.round`` does."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(x.dtype)


def update_slice(buf: torch.Tensor, upd: torch.Tensor, start: int,
                 dim: int) -> torch.Tensor:
    """A copy of ``buf`` with ``upd`` written at ``start`` along ``dim``;
    ``start`` is clamped so that ``upd`` fits, as
    ``lax.dynamic_update_slice`` clamps it."""
    n = upd.shape[dim]
    start = max(0, min(int(start), buf.shape[dim] - n))
    out = buf.clone()
    out.narrow(dim, start, n).copy_(upd)
    return out


def attention_apply(
    p: nn.Params,
    cfg,
    x: torch.Tensor,                    # (B, S, D)
    positions: torch.Tensor,            # (B, S) or (3, B, S)
    layer_kind: str = "global",
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,    # tokens already cached
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    b, sq, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(nn.dense(p["wq"], x), h, dh)
    k = split_heads(nn.dense(p["wk"], x), hkv, dh)
    v = split_heads(nn.dense(p["wv"], x), hkv, dh)
    if cache is None and not _attn_tp_divisible(h):
        # train/prefill with q-heads % model != 0: replicate the attention
        # compute (the projections and the FFN stay sharded)
        q = constrain(q, "batch", None, None, None)
        k = constrain(k, "batch", None, None, None)
        v = constrain(v, "batch", None, None, None)
    else:
        # q sharded on heads; k/v on kv_heads where they divide, else
        # replicated (never on the head dim)
        q = constrain(q, "batch", None, "heads", None)
        k = constrain(k, "batch", None, "kv_heads", None)
        v = constrain(v, "batch", None, "kv_heads", None)

    if cfg.rope != "none":
        rope_kwargs = dict(theta=cfg.rope_theta, rotary_frac=cfg.rotary_frac,
                           mrope_sections=cfg.mrope_sections)
        q = apply_rope(q, positions, **rope_kwargs)
        k = apply_rope(k, positions, **rope_kwargs)

    window = cfg.local_window if layer_kind == "local" else None
    scale = cfg.attn_scale if cfg.attn_scale is not None else dh ** -0.5
    heads = _attn_tp_divisible(h) and _attn_tp_divisible(hkv)

    if cache is None:
        out = _attend(
            q, k, v, heads, causal=True, window=window,
            softcap_val=cfg.attn_softcap, scale=scale,
            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        new_cache = None
    else:
        # decode: write the S new tokens into the cache and attend.
        size = cache["k"].shape[1]
        slot = cache_pos % size
        if cfg.kv_quant:
            k_store, ks = quantize_kv(k)
            v_store, vs = quantize_kv(v)
        else:
            k_store, v_store = k, v
        ck = update_slice(cache["k"], k_store, slot, 1)
        cv = update_slice(cache["v"], v_store, slot, 1)
        spos = update_slice(
            cache["slot_pos"],
            cache_pos + torch.arange(sq, dtype=torch.int32, device=x.device),
            slot, 0)
        kv_positions = torch.where(spos < 0, torch.full_like(spos, INT32_MAX),
                                   spos)
        new_cache = {"k": ck, "v": cv, "slot_pos": spos}
        scales = {}
        if cfg.kv_quant:
            new_cache["k_scale"] = update_slice(cache["k_scale"], ks, slot, 1)
            new_cache["v_scale"] = update_slice(cache["v_scale"], vs, slot, 1)
            scales = {"k_scale": new_cache["k_scale"],
                      "v_scale": new_cache["v_scale"]}
        out = _attend(
            q, ck, cv, heads, causal=True, window=window,
            softcap_val=cfg.attn_softcap, scale=scale,
            q_offset=cache_pos, kv_len=cache_pos + sq,
            kv_positions=kv_positions, block_q=sq,
            block_k=cfg.attn_block_k, **scales)

    return nn.dense(p["wo"], merge_heads(out, h, dh)), new_cache
