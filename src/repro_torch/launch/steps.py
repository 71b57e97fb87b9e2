"""Shardings and step functions of the sharded LM (the JAX package's
``repro.launch.steps``): the placements of params, optimizer states,
batches and caches on an `launch.mesh.LmMesh`, the policy defaults, and
the train, prefill and decode steps, each running its inner step under
``sharding_context(mesh, rules)`` on placed params.

Shapes come from the "meta" device (no allocation).  Where the reference
hands shardings to ``jax.jit``, the port places DTensors: params by
`place_params` (from whole tensors) or `init_placed_params` (each rank
draws only its own shards, for models that no single card holds), batch
inputs inside the steps, and a train step's outputs back onto the params'
placements (the reference's ``out_shardings``).

`lower_cell` is the dry run's cell: the step of one (arch, shape, mesh)
with fake inputs placed as the reference's shardings place them, for
`analysis.cost.analyze` to count; it allocates nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..core.tree import tree_leaves, tree_map, tree_paths, tree_unflatten
from ..dist.context import constrain, sharding_context
from ..dist.sharding import (P, batch_pspec, cache_specs, distribute_tree,
                             leaf_pspecs, placements, tree_shardings)
from ..models.transformer import (ModelConfig, apply_lm, init_cache, init_lm,
                                  lm_specs)
from ..optim.optimizer import AdamState, AdamW


def abstract_params(cfg: ModelConfig):
    """(params tree on the "meta" device, logical spec tree): no
    allocation."""
    return init_lm(None, cfg, device="meta"), lm_specs(cfg)


def opt_state_shapes(params_shapes) -> AdamState:
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return AdamState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=tree_map(f32, params_shapes),
        nu=tree_map(f32, params_shapes),
    )


def opt_shardings(mesh, rules, params_shapes, specs) -> AdamState:
    p_sh = tree_shardings(mesh, rules, params_shapes, specs)
    return AdamState(step=placements(mesh, P()), mu=p_sh, nu=p_sh)


def batch_shardings(mesh, rules, batch_specs: Dict[str, Any]):
    """Placements of the batch inputs (the cache goes by
    `cache_shardings`)."""
    return {k: placements(mesh, batch_pspec(mesh, rules, v.shape[0],
                                            len(v.shape)))
            for k, v in batch_specs.items() if k != "cache"}


def cache_shardings(mesh, rules, cfg: ModelConfig, cache_shapes):
    return tree_shardings(mesh, rules, cache_shapes, cache_specs(cfg))


def place_params(mesh, rules, cfg: ModelConfig, params):
    """Whole params (equal on every rank) placed by their specs."""
    return distribute_tree(mesh, params, tree_shardings(
        mesh, rules, params, lm_specs(cfg)))


def _fill(local: torch.Tensor, shape, name: str,
          gen: torch.Generator) -> None:
    """One shard of a leaf of global ``shape``, drawn in place from the
    distribution `init_lm` draws the leaf from: norm scales one, biases
    zero, RG-LRU's ``lam`` U[2, 10), the table N(0, 0.02^2), every other
    weight N(0, 1 / fan_in) with the fan-in the leaf's second-to-last dim
    (a dense (d_in, d_out), an expert's (E, d_in, f), a per-head
    (H, dh, dh), the conv's (W, d)), whatever the shard's."""
    if name == "scale":
        local.fill_(1.0)
    elif name in ("b", "bias"):
        local.zero_()
    elif name == "lam":
        local.uniform_(generator=gen).mul_(8.0).add_(2.0)
    elif name == "table":
        local.normal_(0.0, 0.02, generator=gen)
    else:
        local.normal_(0.0, 1.0 / math.sqrt(max(shape[-2], 1)),
                      generator=gen)


def init_placed_params(cfg: ModelConfig, mesh, rules, seed: int = 0):
    """Random params, placed, with every rank allocating and drawing only
    its own shards (on its device: the card under NCCL).  A shard is drawn
    from a generator seeded by the seed, the leaf and the shard's
    coordinates, so the ranks that hold the same shard hold the same
    numbers.  The draw equals no other draw (not `init_lm`'s)."""
    import torch.distributed.tensor as dtensor
    from torch.distributed.tensor import Shard

    shapes, specs = abstract_params(cfg)
    pls = [placements(mesh, ps)
           for ps in leaf_pspecs(mesh, rules, shapes, specs)]
    out = []
    for i, (path, t, pl) in enumerate(zip(tree_paths(shapes),
                                          tree_leaves(shapes), pls)):
        d = dtensor.empty(tuple(t.shape), dtype=t.dtype,
                          device_mesh=mesh.device_mesh, placements=pl)
        local = d.to_local()
        coords = tuple(mesh.coordinate(a) if isinstance(p, Shard) else 0
                       for a, p in zip(mesh.axis_names, pl))
        gen = torch.Generator(device=local.device)
        gen.manual_seed(hash((seed, i, coords)) % (2 ** 63))
        _fill(local, tuple(t.shape), path[-1], gen)
        out.append(d)
    return tree_unflatten(shapes, out)


def full_params(params):
    """Every leaf whole, as plain tensors (a collective: every rank of the
    mesh calls it)."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, params)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------
def make_optimizer(cfg: ModelConfig) -> AdamW:
    return AdamW(lr=3e-4, weight_decay=0.1, clip_norm=1.0)


def default_policy(cfg: ModelConfig) -> str:
    """FSDP where TP-only optimizer state would not fit: above 20 G dense
    params, or any MoE (the expert weights' Adam moments need the data
    axis too).  TP alone elsewhere avoids the per-microbatch FSDP weight
    all-gather."""
    if cfg.n_experts > 0 or cfg.param_count() > 20e9:
        return "fsdp_tp"
    return "tp"


def default_grad_accum(cfg: ModelConfig, suite, mesh,
                       target_tokens_per_device: int = 6144) -> int:
    """Microbatching so per-device microbatch activations stay small: the
    smallest divisor of the per-device batch (and of the global batch)
    that brings its tokens to the target, so the batch-dim sharding
    survives the microbatch split."""
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    per_dev_batch = max(1, suite.global_batch // dp)
    per_dev_tokens = per_dev_batch * suite.seq_len
    divisors = [d for d in range(1, per_dev_batch + 1)
                if per_dev_batch % d == 0 and suite.global_batch % d == 0]
    for ga in divisors:  # smallest ga meeting the activation target
        if per_dev_tokens // ga <= target_tokens_per_device:
            return ga
    return divisors[-1]


def _placed_like(new, old):
    """``new`` on ``old``'s placements (a plain ``old``: ``new`` as is)."""
    from torch.distributed.tensor import DTensor

    if isinstance(old, DTensor):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def build_train_step(cfg: ModelConfig, mesh, rules, grad_accum: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the new params and Adam moments keep the params'
    placements."""
    from ..train.lm import make_train_step

    optimizer = make_optimizer(cfg)
    inner = make_train_step(cfg, optimizer, grad_accum=grad_accum,
                            compress=False)

    def train_step(params, opt_state, batch):
        with sharding_context(mesh, rules):
            batch = {k: constrain(v, "batch", *([None] * (v.ndim - 1)))
                     for k, v in batch.items()}
            new, opt, _, met = inner(params, opt_state, None, batch)
            new = tree_map(_placed_like, new, params)
            opt = AdamState(step=opt.step,
                            mu=tree_map(_placed_like, opt.mu, params),
                            nu=tree_map(_placed_like, opt.nu, params))
        return new, opt, met

    return train_step


class _Fill:
    """A cache leaf not yet allocated: its shape, fill and dtype."""

    def __init__(self, shape, value, dtype):
        self.shape, self.value, self.dtype = tuple(shape), value, dtype


def placed_cache(cfg: ModelConfig, mesh, rules, batch: int, max_len: int,
                 device):
    """`init_cache`'s tree placed by `cache_specs`, each leaf filled as
    `init_cache` fills it and each rank allocating only its own shards
    (the whole cache of a long prompt is no card's to hold: deepseek-7b's
    at 32 x 32768 is 240 GiB)."""
    import torch.distributed.tensor as dtensor

    fills = init_cache(cfg, batch, max_len, device, full=_Fill)
    shapes = tree_map(lambda f: f if isinstance(f, torch.Tensor) else
                      torch.empty(f.shape, dtype=f.dtype, device="meta"),
                      fills)

    def leaf(f, pl):
        if isinstance(f, torch.Tensor):     # ``pos``, a literal
            return distribute_tree(mesh, f, pl)
        return dtensor.full(f.shape, f.value, dtype=f.dtype,
                            device_mesh=mesh.device_mesh, placements=pl)

    return tree_map(leaf, fills, cache_shardings(mesh, rules, cfg, shapes))


def build_prefill_step(cfg: ModelConfig, mesh, rules, batch: int,
                       max_len: int):
    """``prefill_step(params, {"tokens", "frontend_embeds"?}) -> (last
    logits (B, V), cache)``, the cache placed by `cache_specs`."""

    def prefill_step(params, batch_inputs):
        dev = tree_leaves(params)[0].device
        with sharding_context(mesh, rules):
            cache = (init_cache(cfg, batch, max_len, device=dev)
                     if mesh is None else
                     placed_cache(cfg, mesh, rules, batch, max_len, dev))
            tokens = constrain(batch_inputs["tokens"], "batch", None)
            fe = batch_inputs.get("frontend_embeds")
            if fe is not None:
                fe = constrain(fe, "batch", None, None)
            logits, cache, _ = apply_lm(params, cfg, tokens, fe,
                                        mode="prefill", cache=cache)
        return logits[:, -1, :], cache

    return prefill_step


def build_decode_step(cfg: ModelConfig, mesh, rules):
    """``decode_step(params, cache, tokens (B, 1)) -> (logits (B, V),
    cache)``."""

    def decode_step(params, cache, tokens):
        with sharding_context(mesh, rules):
            tokens = constrain(tokens, "batch", None)
            logits, cache, _ = apply_lm(params, cfg, tokens, mode="decode",
                                        cache=cache)
        return logits[:, -1, :], cache

    return decode_step


# ---------------------------------------------------------------------------
# cell lowering (arch x shape x mesh) -> the step and its fake inputs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LoweredCell:
    """A cell's step ``fn``, its placed fake inputs ``args`` and the
    FakeTensorMode that made them (`analysis.cost.analyze(fn, *args,
    fake_mode=fake_mode)` counts it); ``grad_accum`` and ``policy`` as
    resolved."""

    fn: Any
    args: tuple
    fake_mode: Any
    policy: str
    grad_accum: int = 1


def _fake_placed(mesh, t: torch.Tensor, pl, fake_mode, value=None):
    """A fake DTensor of ``t``'s global shape and dtype with placements
    ``pl`` on ``mesh``: its local shard is rank 0's (every split is even).
    ``value`` makes a scalar a constant (a cache's position)."""
    from torch.distributed.tensor import DTensor, Shard

    shape = list(t.shape)
    for size, p in zip(mesh.device_mesh.shape, pl):
        if isinstance(p, Shard):
            shape[p.dim] //= size
    with fake_mode:
        local = (torch.tensor(value, dtype=t.dtype) if value is not None
                 else torch.empty(shape, dtype=t.dtype))
        return DTensor.from_local(local, mesh.device_mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape,
                                                     device="meta").stride())


def lower_cell(cfg: ModelConfig, suite, mesh, policy: str = "auto",
               grad_accum: Optional[int] = None) -> LoweredCell:
    """The step of one cell and its fake inputs, placed by the same
    `make_rules`, `tree_shardings`, `opt_shardings`, `batch_shardings`,
    `cache_shardings` and `default_grad_accum` as the reference's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs.shapes import input_specs
    from ..dist.sharding import make_rules

    multi_pod = "pod" in mesh.shape
    if policy == "auto":
        policy = default_policy(cfg)
    rules = make_rules(policy, multi_pod=multi_pod)
    p_shapes, specs = abstract_params(cfg)
    p_sh = tree_shardings(mesh, rules, p_shapes, specs)
    in_specs = input_specs(cfg, suite)
    fake_mode = FakeTensorMode()
    place = lambda t, pl: _fake_placed(mesh, t, pl, fake_mode)
    params = tree_map(place, p_shapes, p_sh)

    if suite.kind == "train":
        if grad_accum is None:
            grad_accum = default_grad_accum(cfg, suite, mesh)
        o_shapes = opt_state_shapes(p_shapes)
        o_sh = opt_shardings(mesh, rules, p_shapes, specs)
        opt = AdamState(step=place(o_shapes.step, o_sh.step),
                        mu=tree_map(place, o_shapes.mu, o_sh.mu),
                        nu=tree_map(place, o_shapes.nu, o_sh.nu))
        b_sh = batch_shardings(mesh, rules, in_specs)
        batch = {k: place(v, b_sh[k]) for k, v in in_specs.items()}
        step = build_train_step(cfg, mesh, rules, grad_accum=grad_accum)
        return LoweredCell(step, (params, opt, batch), fake_mode, policy,
                           grad_accum)
    if suite.kind == "prefill":
        b_sh = batch_shardings(mesh, rules, in_specs)
        batch = {k: place(v, b_sh[k]) for k, v in in_specs.items()}
        step = build_prefill_step(cfg, mesh, rules, suite.global_batch,
                                  suite.seq_len)
        return LoweredCell(step, (params, batch), fake_mode, policy)
    # decode: one token against a full cache (the new token's slot last)
    cache_shapes = in_specs["cache"]
    c_sh = cache_shardings(mesh, rules, cfg, cache_shapes)
    cache = {k: tree_map(place, v, c_sh[k]) for k, v in cache_shapes.items()
             if k != "pos"}
    cache["pos"] = _fake_placed(mesh, cache_shapes["pos"], c_sh["pos"],
                                fake_mode, value=suite.seq_len - 1)
    tok_pl = placements(mesh, batch_pspec(mesh, rules, suite.global_batch, 2))
    tokens = place(in_specs["tokens"], tok_pl)
    step = build_decode_step(cfg, mesh, rules)
    return LoweredCell(step, (params, cache, tokens), fake_mode, policy)
