"""The unified decoder LM of the JAX package (``repro.models.transformer``)
in torch, for every family of its ten configs: GQA/MQA/MHA attention
blocks, local/global alternation, softcaps, partial and multi-section
RoPE, the dense FFNs and the top-k routed MoE (`models.ffn`), the
recurrent blocks "griffin", "mlstm" and "slstm" (`models.recurrent`) and
the modality-frontend stub.

The tree is the reference's: layers grouped into repeat *units* (the
block pattern) whose params are stacked along a leading unit axis
(``units``), the remainder blocks (``rem``), the tied ``embed`` table,
``final_norm`` and, with a frontend, ``frontend_proj``; a serving cache is
``{"units", "pos"}`` (and ``rem``): a KV cache per attention block and a
recurrent state per recurrent block.  A Python loop over the unit axis
takes the place of the reference's ``lax.scan``; each unit's new cache is
written into the stacked cache as soon as it is made, so a step holds the
old cache and the new one, never a third copy.  In "train" mode under
autograd with ``cfg.remat``, each unit runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable``).  A recurrent block starts from no state in "train"
and "prefill" (its state after the prompt becomes the cache) and from the
cache in "decode", as the reference's does.  The aux loss is summed over
every block.

`lm_specs` gives the reference's logical-axis spec of every param leaf
(``init_lm``'s second result there), which `dist.sharding` maps onto a
mesh.  Under a sharding context with an `launch.mesh.LmMesh` the params
are DTensors and every step runs on them: the embedding looks tokens up
on a vocab-sharded table, the residual stream is constrained on the
batch at each unit and the logits on the vocab, as in the reference.

``init_lm`` draws every tensor from a ``torch.Generator`` on that
generator's device (at full width, a ~6.5 G-parameter model is drawn on
the card, not on the host); the draws do not match the reference's, so
parity tests load its params through `lm_params_from_numpy`.  Every leaf
keeps its own dtype across the packages: in a bf16 model RG-LRU's ``lam``
and the recurrent states stay float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..core.counting import trips
from ..core.tree import tree_leaves, tree_map, tree_paths, tree_unflatten
from ..dist.context import constrain
from . import nn
from .attention import (apply_rope, attention_apply, attention_init,
                        attention_specs, init_kv_cache, quantize_kv,
                        split_heads, update_slice)
from .ffn import (ffn_apply, ffn_init, ffn_specs, moe_apply, moe_init,
                  moe_specs)
from .recurrent import (griffin_block_apply, griffin_block_init,
                        griffin_block_specs, griffin_state_init,
                        mlstm_block_apply, mlstm_block_init,
                        mlstm_block_specs, mlstm_state_init,
                        slstm_block_apply, slstm_block_init,
                        slstm_block_specs, slstm_state_init)

ATTN_KINDS = ("global", "local")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    block_pattern: tuple = ("global",)
    activation: str = "swiglu"
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    rope: str = "standard"           # standard | 2d | mrope | none
    rope_theta: float = 10000.0
    rotary_frac: float = 1.0
    mrope_sections: Optional[tuple] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_scale: Optional[float] = None
    local_window: int = 4096
    qkv_bias: bool = False
    embed_scale: bool = False
    # MoE
    n_experts: int = 0
    moe_top_k: int = 2
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    moe_norm_topk: bool = True
    moe_capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # recurrent
    rnn_width: int = 0
    # modality frontend stub
    frontend: Optional[str] = None   # vision | audio
    frontend_len: int = 0
    frontend_dim: int = 0
    # execution
    dtype: str = "bfloat16"
    attn_block_q: int = 512
    attn_block_k: int = 512
    remat: bool = True
    # int8 KV cache (per-token-per-head symmetric scales)
    kv_quant: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def n_rem(self) -> int:
        return self.n_layers % len(self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs: every block is recurrent or windowed."""
        return all(k in ("griffin", "mlstm", "slstm", "local")
                   for k in self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (tied embeddings)."""
        d, dh = self.d_model, self.head_dim
        n_attn = sum(1 for k in self.block_pattern if k in ATTN_KINDS)
        n_grif = sum(1 for k in self.block_pattern if k == "griffin")
        n_ml = sum(1 for k in self.block_pattern if k == "mlstm")
        n_sl = sum(1 for k in self.block_pattern if k == "slstm")
        per_unit = 0
        per_unit += n_attn * (d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
                              + self.n_heads * dh * d)
        if self.n_experts:
            per_unit += n_attn * (d * self.n_experts
                                  + 3 * self.n_experts * d * self.expert_d_ff)
            if self.n_shared_experts:
                per_unit += n_attn * 3 * d * self.n_shared_experts * self.expert_d_ff
        else:
            mult = 3 if self.activation in ("swiglu", "geglu") else 2
            per_unit += n_attn * mult * d * self.d_ff
        dr = self.rnn_width or d
        per_unit += n_grif * (2 * d * dr + 2 * dr * dr + dr * d
                              + 3 * d * self.d_ff)
        di = 2 * d
        per_unit += n_ml * (d * 2 * di + 3 * di * (di // self.n_heads)
                            + di * d)
        per_unit += n_sl * (4 * d * d + 4 * d * (d // self.n_heads) + 2 * d * d)
        total = self.n_units * per_unit
        if self.n_rem:
            total += per_unit * self.n_rem // max(len(self.block_pattern), 1)
        total += self.vocab_size * d  # tied embeddings
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        routed_all = 3 * self.n_experts * d * self.expert_d_ff
        routed_act = 3 * self.moe_top_k * d * self.expert_d_ff
        n_attn_layers = sum(1 for k in self.block_pattern if k in ATTN_KINDS)
        n_moe = self.n_units * n_attn_layers + self.n_rem
        return self.param_count() - n_moe * (routed_all - routed_act)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _norm_init(cfg: ModelConfig, device) -> nn.Params:
    if cfg.norm == "layernorm":
        return nn.layernorm_init(cfg.d_model, cfg.tdtype, device)
    return nn.rmsnorm_init(cfg.d_model, cfg.tdtype, device)


def _norm_specs(cfg: ModelConfig) -> nn.Specs:
    if cfg.norm == "layernorm":
        return nn.layernorm_specs()
    return nn.rmsnorm_specs()


def _norm(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return nn.layernorm(p, x, cfg.norm_eps)
    return nn.rmsnorm(p, x, cfg.norm_eps)


def init_block(generator: Optional[torch.Generator], cfg: ModelConfig,
               kind: str, device=None) -> nn.Params:
    dt = cfg.tdtype
    p: Dict[str, Any] = {"norm1": _norm_init(cfg, device)}
    if kind in ATTN_KINDS:
        p["attn"] = attention_init(generator, cfg, dt, kind, device=device)
        p["norm2"] = _norm_init(cfg, device)
        if cfg.n_experts:
            p["moe"] = moe_init(generator, cfg, dt, device=device)
        else:
            p["ffn"] = ffn_init(generator, cfg.d_model, cfg.d_ff, dt,
                                cfg.activation, device=device)
    elif kind == "griffin":
        p["mixer"] = griffin_block_init(generator, cfg, dt, device)
        p["norm2"] = _norm_init(cfg, device)
        p["ffn"] = ffn_init(generator, cfg.d_model, cfg.d_ff, dt,
                            cfg.activation, device=device)
    elif kind == "mlstm":
        p["mixer"] = mlstm_block_init(generator, cfg, dt, device)
    elif kind == "slstm":
        p["mixer"] = slstm_block_init(generator, cfg, dt, device)
    else:
        raise ValueError(f"unknown block kind {kind}")
    return p


def block_specs(cfg: ModelConfig, kind: str) -> nn.Specs:
    """The logical specs of `init_block`'s tree."""
    s: Dict[str, Any] = {"norm1": _norm_specs(cfg)}
    if kind in ATTN_KINDS:
        s["attn"] = attention_specs(cfg)
        s["norm2"] = _norm_specs(cfg)
        if cfg.n_experts:
            s["moe"] = moe_specs(cfg)
        else:
            s["ffn"] = ffn_specs(cfg.activation)
    elif kind == "griffin":
        s["mixer"] = griffin_block_specs(cfg)
        s["norm2"] = _norm_specs(cfg)
        s["ffn"] = ffn_specs(cfg.activation)
    elif kind == "mlstm":
        s["mixer"] = mlstm_block_specs(cfg)
    elif kind == "slstm":
        s["mixer"] = slstm_block_specs(cfg)
    else:
        raise ValueError(f"unknown block kind {kind}")
    return s


def _reduced(y: torch.Tensor) -> torch.Tensor:
    """A residual branch's output placed on the batch axes and whole
    along the model axis before it joins the residual stream: a
    row-parallel projection leaves partial sums, and a stream of partial
    sums fed on into the next norm and projections made DTensor gather
    weights and, on a (16, 16) mesh, fail to shard the FFN's down
    projection."""
    return constrain(y, "batch", *([None] * (y.ndim - 1)))


def apply_block(p, cfg: ModelConfig, kind: str, x, positions, mode: str,
                cache, cache_pos: int):
    """Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm(cfg, p["norm1"], x)
    if kind in ATTN_KINDS:
        if mode == "train":
            out, new_cache = attention_apply(p["attn"], cfg, h, positions,
                                             kind)
        elif mode == "prefill":
            out, _ = attention_apply(p["attn"], cfg, h, positions, kind)
            new_cache = _fill_cache(cfg, cache, h, p, positions)
        else:  # decode
            out, new_cache = attention_apply(p["attn"], cfg, h, positions,
                                             kind, cache, cache_pos)
        x = x + _reduced(out)
        h2 = _norm(cfg, p["norm2"], x)
        if cfg.n_experts:
            y, aux = moe_apply(p["moe"], cfg, h2,
                               capacity_factor=cfg.moe_capacity_factor)
        else:
            y = ffn_apply(p["ffn"], h2, cfg.activation)
        return x + _reduced(y), new_cache, aux
    # a recurrent block: from no state in train and prefill (its state
    # after the prompt is the new cache), from the cache in decode
    state = cache if mode == "decode" else None
    if kind == "griffin":
        out, new_cache = griffin_block_apply(p["mixer"], cfg, h, state)
        x = x + _reduced(out)
        h2 = _norm(cfg, p["norm2"], x)
        x = x + _reduced(ffn_apply(p["ffn"], h2, cfg.activation))
    elif kind in ("mlstm", "slstm"):
        fn = mlstm_block_apply if kind == "mlstm" else slstm_block_apply
        out, new_cache = fn(p["mixer"], cfg, h, state)
        x = x + _reduced(out)
    else:
        raise ValueError(f"unknown block kind {kind}")
    return x, (None if mode == "train" else new_cache), aux


def _fill_cache(cfg: ModelConfig, cache, h, p, positions):
    """Prefill: recompute k/v once more into the cache buffers (cheap linear
    projections; avoids threading k/v out of attention_apply)."""
    b, sl, _ = h.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    k = split_heads(h @ p["attn"]["wk"]["w"], hkv, dh)
    v = split_heads(h @ p["attn"]["wv"]["w"], hkv, dh)
    if "b" in p["attn"]["wk"]:
        k = k + split_heads(p["attn"]["wk"]["b"], hkv, dh)
        v = v + split_heads(p["attn"]["wv"]["b"], hkv, dh)
    if cfg.rope != "none":
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       rotary_frac=cfg.rotary_frac,
                       mrope_sections=cfg.mrope_sections)
    scales = {}
    if cfg.kv_quant:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    size = cache["k"].shape[1]
    if sl >= size:
        ck, cv = k[:, -size:], v[:, -size:]
        spos = torch.arange(sl - size, sl, dtype=torch.int32, device=h.device)
        if cfg.kv_quant:
            scales = {"k_scale": ks[:, -size:], "v_scale": vs[:, -size:]}
    else:
        ck = update_slice(cache["k"], k, 0, 1)
        cv = update_slice(cache["v"], v, 0, 1)
        idx = torch.arange(size, dtype=torch.int32, device=h.device)
        spos = torch.where(idx < sl, idx, torch.full_like(idx, -1))
        if cfg.kv_quant:
            scales = {"k_scale": update_slice(cache["k_scale"], ks, 0, 1),
                      "v_scale": update_slice(cache["v_scale"], vs, 0, 1)}
    return {"k": ck, "v": cv, "slot_pos": spos, **scales}


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device="cuda", full=None):
    """One block's cache, each leaf from ``full(shape, value, dtype)``
    (`nn.full_on(device)` by default)."""
    if kind in ATTN_KINDS:
        return init_kv_cache(cfg, batch, max_len, kind, cfg.tdtype, device,
                             full)
    if kind == "griffin":
        return griffin_state_init(cfg, batch, cfg.tdtype, device, full)
    if kind == "mlstm":
        return mlstm_state_init(cfg, batch, cfg.tdtype, device, full)
    if kind == "slstm":
        return slstm_state_init(cfg, batch, cfg.tdtype, device, full)
    raise ValueError(f"unknown block kind {kind}")


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def _stacked(make: Callable[[], Any], n: int):
    """``n`` trees from ``make()`` stacked along a new leading axis, each
    written into the stack as soon as it is drawn (so a full-width model
    never holds its units twice)."""
    first = make()
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    for u in range(n):
        tree = first if u == 0 else make()
        tree_map(lambda dst, src: dst[u].copy_(src), out, tree)
    return out


def _unstack(stacked, n: int) -> List[Any]:
    """The ``n`` unit trees of a unit-stacked tree: one ``unbind`` per
    leaf, so under autograd each leaf's gradient is stacked once by one
    node rather than summed over ``n`` full-size slices."""
    leaves = [t.unbind(0) for t in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [l[u] for l in leaves])
            for u in range(n)]


def init_lm(generator: Optional[torch.Generator], cfg: ModelConfig,
            device=None):
    """Params with unit-stacked block params, drawn from ``generator`` on
    its device (with ``generator=None``, uninitialised tensors on
    ``device``: ``device="meta"`` gives the tree's shapes alone)."""
    dev = generator.device if generator is not None else torch.device(device)
    pattern = cfg.block_pattern

    def init_unit():
        return {f"b{i}": init_block(generator, cfg, kind, dev)
                for i, kind in enumerate(pattern)}

    params: Dict[str, Any] = {"units": _stacked(init_unit, cfg.n_units)}
    if cfg.n_rem:
        params["rem"] = {f"b{i}": init_block(generator, cfg, pattern[i], dev)
                         for i in range(cfg.n_rem)}
    params["embed"] = nn.embedding_init(generator, cfg.vocab_size,
                                        cfg.d_model, cfg.tdtype, device=dev)
    params["final_norm"] = _norm_init(cfg, dev)
    if cfg.frontend is not None:
        params["frontend_proj"] = nn.dense_init(
            generator, cfg.frontend_dim, cfg.d_model, cfg.tdtype, device=dev)
    return params


def lm_specs(cfg: ModelConfig) -> nn.Specs:
    """The logical-axis spec of every leaf of `init_lm`'s tree (the
    reference's ``init_lm(key, cfg)[1]``): the unit-stacked blocks lead
    with ``"layers"``."""
    pattern = cfg.block_pattern
    specs: Dict[str, Any] = {"units": nn.stack_specs(
        {f"b{i}": block_specs(cfg, kind) for i, kind in enumerate(pattern)})}
    if cfg.n_rem:
        specs["rem"] = {f"b{i}": block_specs(cfg, pattern[i])
                        for i in range(cfg.n_rem)}
    specs["embed"] = nn.embedding_specs()
    specs["final_norm"] = _norm_specs(cfg)
    if cfg.frontend is not None:
        specs["frontend_proj"] = nn.dense_specs((None, "embed"))
    return specs


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               full=None):
    """Serving cache: unit-stacked block caches, remainder, and ``pos``.
    Each block leaf comes from ``full(shape, value, dtype)``
    (`nn.full_on(device)` by default; a unit-stacked leaf's ``shape``
    leads with the units)."""
    pattern = cfg.block_pattern
    full = full or nn.full_on(device)

    def stacked(shape, value, dtype):
        return full((cfg.n_units, *shape), value, dtype)

    cache = {"units": {f"b{i}": init_block_cache(cfg, kind, batch, max_len,
                                                 device, stacked)
                       for i, kind in enumerate(pattern)},
             # a literal: a fake tensor of it keeps its value (the dry run)
             "pos": torch.tensor(0, dtype=torch.int32, device=device)}
    if cfg.n_rem:
        cache["rem"] = {f"b{i}": init_block_cache(cfg, pattern[i], batch,
                                                  max_len, device, full)
                        for i in range(cfg.n_rem)}
    return cache


def default_positions(cfg: ModelConfig, batch: int, start: int, length: int,
                      device="cuda") -> torch.Tensor:
    """Position ids; (3, B, S) for M-RoPE (text: t=h=w)."""
    pos = start + torch.arange(length, dtype=torch.int32, device=device)
    pos = pos.expand(batch, length)
    if cfg.rope == "mrope":
        return pos.expand(3, batch, length)
    return pos


def apply_lm(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                          # (B, S_tok) int
    frontend_embeds: Optional[torch.Tensor] = None,  # (B, L_f, frontend_dim)
    mode: str = "train",
    cache: Optional[Dict] = None,
    positions: Optional[torch.Tensor] = None,
):
    """Returns (logits (B, S_total, V) float32, new_cache, aux_loss), on
    the device of the params."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = params["embed"]["table"].device
    dt = cfg.tdtype
    tokens = torch.as_tensor(tokens, device=dev)
    b = tokens.shape[0]
    x = nn.embed(params["embed"], tokens).to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt, device=dev)
    if frontend_embeds is not None:
        fe = nn.dense(params["frontend_proj"],
                      torch.as_tensor(frontend_embeds, device=dev).to(dt))
        x = torch.cat([fe, x], dim=1)
    s_total = x.shape[1]

    cache_pos = int(cache["pos"]) if cache is not None else 0
    if positions is None:
        start = cache_pos if mode == "decode" else 0
        positions = default_positions(cfg, b, start, s_total, dev)

    pattern = cfg.block_pattern

    def run(x, blocks_p, blocks_c):
        """One unit (or the remainder): (x, its new caches, its aux)."""
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        new_c = {}
        for i, kind in enumerate(pattern[:len(blocks_p)]):
            c_i = blocks_c[f"b{i}"] if blocks_c is not None else None
            x, nc, a = apply_block(blocks_p[f"b{i}"], cfg, kind, x, positions,
                                   mode, c_i, cache_pos)
            aux = aux + a
            if nc is not None:
                new_c[f"b{i}"] = nc
        return x, new_c, aux

    def run_train(x, unit_p):
        x, _, a = run(x, unit_p, None)
        return x, a

    remat = (mode == "train" and cfg.remat and torch.is_grad_enabled())
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    new_units = None
    units = _unstack(params["units"], cfg.n_units)
    for u in trips(cfg.n_units):
        unit_p = units[u]
        x = constrain(x, "batch", None, None)
        if mode == "train":
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    run_train, x, unit_p, use_reentrant=False)
            else:
                x, a = run_train(x, unit_p)
        else:
            unit_c = tree_map(lambda t: t[u], cache["units"])
            x, new_c, a = run(x, unit_p, unit_c)
            # written into the stack now: no list of per-unit caches (the
            # stack takes the old one's dtypes and, on a mesh, placements)
            if new_units is None:
                new_units = tree_map(torch.empty_like, cache["units"])
            tree_map(lambda dst, src: dst[u].copy_(src), new_units, new_c)
            del new_c, unit_c
        aux = aux + a
    new_cache = None
    if mode != "train":
        new_cache = {"units": new_units,
                     "pos": cache["pos"].new_full((), cache_pos + s_total)}

    if cfg.n_rem:
        rem_c = cache["rem"] if cache is not None and mode != "train" else None
        x, new_rem, a = run(x, params["rem"], rem_c)
        aux = aux + a
        if new_cache is not None:
            new_cache["rem"] = new_rem

    x = _norm(cfg, params["final_norm"], x)
    logits = nn.unembed(params["embed"], x)
    # the logits stay sharded on the vocab
    logits = constrain(logits, "batch", None, "vocab")
    logits = nn.softcap(logits.float(), cfg.final_softcap)
    return logits, new_cache, aux


# ---------------------------------------------------------------------------
# trees across the packages (numpy, in the reference's leaf order)
# ---------------------------------------------------------------------------
def _tensor_from_numpy(a, like: torch.Tensor, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16, by its bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    return t.to(device=device, dtype=like.dtype)


def _tree_from_numpy(tree, like, device, what: str):
    got, want = tree_paths(tree), tree_paths(like)
    if got != want:
        raise ValueError(f"{what}: expected the leaves "
                         f"{['/'.join(p) for p in want]}, got "
                         f"{['/'.join(p) for p in got]}")
    leaves, out = tree_leaves(tree), []
    for path, a, l in zip(want, leaves, tree_leaves(like)):
        if tuple(np.shape(a)) != tuple(l.shape):
            raise ValueError(f"{what}: {'/'.join(path)} has shape "
                             f"{tuple(np.shape(a))}, expected {tuple(l.shape)}")
        out.append(_tensor_from_numpy(a, l, device))
    return tree_unflatten(like, out)


def _tree_to_numpy(tree):
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)


def lm_params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """The port's LM params from the reference's params as numpy (a
    ``jax.tree_util.tree_map(np.asarray, params)``), every key and shape
    checked against `init_lm`'s tree and each leaf cast to its dtype there
    (``cfg``'s dtype, but float32 for RG-LRU's ``lam``)."""
    like = init_lm(None, cfg, device="meta")
    return _tree_from_numpy(tree, like, device, f"{cfg.name} params")


def lm_params_to_numpy(params):
    """The params as a tree of numpy arrays (bfloat16 leaves as float32,
    exactly), the reference's tree and leaf order."""
    return _tree_to_numpy(params)


def lm_cache_from_numpy(tree, cfg: ModelConfig, batch: int, max_len: int,
                        device="cuda"):
    """A serving cache from the reference's cache as numpy, each leaf in
    `init_cache`'s dtype (the recurrent states' float32 in any model)."""
    like = init_cache(cfg, batch, max_len, device="meta")
    return _tree_from_numpy(tree, like, device, f"{cfg.name} cache")


def lm_cache_to_numpy(cache):
    return _tree_to_numpy(cache)
