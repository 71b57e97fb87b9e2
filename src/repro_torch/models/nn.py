"""The JAX package's functional NN substrate (``repro.models.nn``) in
torch: inits, a dense layer, the norms, the (tied) embedding, the
activations and the tree helpers.  Params are dicts of tensors.  Each
init has a ``*_specs`` twin that gives the reference's logical-axis spec
tree for it (a tuple of logical axis names, or None, per dim of each
leaf), which `dist.sharding` maps onto a mesh.

Every init draws from a ``torch.Generator`` on that generator's own
device: the DCNN towers draw on the CPU (a seed gives the same weights
whatever device they go to), the LM draws on the card it serves from.
With ``generator=None`` an init returns an uninitialised tensor on
``device``: on the "meta" device that is a shape template.  The draws do
not match the reference's ``jax.random``; parity tests load its params.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.tree import tree_leaves

Params = Dict[str, Any]
Specs = Dict[str, Any]  # mirrors Params; leaves are tuples of logical axes


def is_dtensor(x) -> bool:
    """Whether ``x`` is placed on an LM mesh.  By the type's name: the
    DTensor package takes seconds to import, and a process that places
    nothing never imports it."""
    return type(x).__name__ == "DTensor"


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def _draw(generator: Optional[torch.Generator], shape,
          device) -> torch.Tensor:
    """N(0, 1) of ``shape`` from ``generator`` on its device, or (no
    generator) an uninitialised float32 tensor on ``device``."""
    if generator is None:
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=generator, device=generator.device)


def normal_init(generator: Optional[torch.Generator], shape,
                dtype: torch.dtype, scale: float = 0.02,
                device=None) -> torch.Tensor:
    return (scale * _draw(generator, shape, device)).to(dtype)


def lecun_init(generator: Optional[torch.Generator], shape,
               dtype: torch.dtype, fan_in: Optional[int] = None,
               device=None) -> torch.Tensor:
    """N(0, 1/fan_in) weights (fan_in defaults to ``shape[0]``)."""
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan, 1))
    return (scale * _draw(generator, shape, device)).to(dtype)


def full_on(device):
    """``full(shape, value, dtype)``: `torch.full` on ``device``, the
    cache initialisers' allocator unless their caller gives its own (a
    placed cache allocates each rank's shards)."""
    return lambda shape, value, dtype: torch.full(shape, value, dtype=dtype,
                                                  device=device)


def zeros_init(shape, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(shape, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------
def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               dtype: torch.dtype, bias: bool = False, *,
               device) -> Dict[str, torch.Tensor]:
    """``device`` is required: the weight is drawn on the generator's
    device and then moved to ``device``, so a default would quietly move
    a draw made on the card to the host."""
    p = {"w": lecun_init(generator, (d_in, d_out), dtype,
                         device=device).to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_specs(axes: Tuple[Optional[str], Optional[str]] = ("embed", "mlp"),
                bias: bool = False) -> Specs:
    s: Specs = {"w": tuple(axes)}
    if bias:
        s["b"] = (axes[1],)
    return s


def dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, dtype: torch.dtype, device) -> Params:
    return {"scale": ones_init((d,), dtype, device)}


def rmsnorm_specs() -> Specs:
    return {"scale": ("embed",)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm_init(d: int, dtype: torch.dtype, device) -> Params:
    return {"scale": ones_init((d,), dtype, device),
            "bias": zeros_init((d,), dtype, device)}


def layernorm_specs() -> Specs:
    return {"scale": ("embed",), "bias": ("embed",)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


# ---------------------------------------------------------------------------
# Embedding (tied: the unembedding is the table's transpose)
# ---------------------------------------------------------------------------
def embedding_init(generator: Optional[torch.Generator], vocab: int, d: int,
                   dtype: torch.dtype, device=None) -> Params:
    return {"table": normal_init(generator, (vocab, d), dtype,
                                 device=device)}


def embedding_specs() -> Specs:
    return {"table": ("vocab", "embed")}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table.  On a DTensor table, the vocab-parallel lookup:
    each rank looks up its own batch shard's tokens in its vocabulary
    shard (the table gathered along any other axis, the embed dim under
    FSDP), the rows of tokens outside its shard zero, and the partial sums
    are all-reduced over the vocabulary's mesh axis alone.  The rows come
    out split like the tokens' batch and whole along the vocabulary's
    axis.  The reduction is explicit, over that axis's process group:
    DTensor's masked partial does not survive a batch split in a later
    redistribution, and indexing would gather the whole table."""
    table, tokens = p["table"], tokens.long()
    if not is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..dist.context import SumOver, batch_placements, shard_of

    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    vocab = shard_of(table, 0)
    axis = vocab[0] if vocab is not None else None
    tok_pl = [Replicate() if i == axis else pl
              for i, pl in enumerate(batch_placements(tokens))]
    tab_pl = [Shard(0) if i == axis else Replicate()
              for i in range(mesh.ndim)]
    # a rank's table gradient: its vocabulary shard's, summed over the
    # ranks that hold the other batch shards
    tab_grad = [Shard(0) if i == axis else
                Partial() if isinstance(tok_pl[i], Shard) else Replicate()
                for i in range(mesh.ndim)]

    def lookup(tok, tab):
        if vocab is None:
            return F.embedding(tok, tab)
        _, group, rank = vocab
        rows = tab.shape[0]
        local = tok - rank * rows
        hit = (local >= 0) & (local < rows)
        part = F.embedding(local.clamp(0, rows - 1), tab) * \
            hit[..., None].to(tab.dtype)
        return SumOver.apply(part, group)

    run = local_map(lookup, out_placements=tok_pl,
                    in_placements=(tok_pl, tab_pl),
                    in_grad_placements=(tok_pl, tab_grad), device_mesh=mesh,
                    redistribute_inputs=True)
    return run(tokens, table)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# tree utilities
# ---------------------------------------------------------------------------
def tree_size(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def tree_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in tree_leaves(params))


def stack_specs(spec: Specs) -> Specs:
    """Prefix every leaf spec with the (never-sharded) ``"layers"`` axis
    of a unit-stacked tree."""
    if isinstance(spec, tuple):
        return ("layers",) + spec
    return {k: stack_specs(v) for k, v in spec.items()}
