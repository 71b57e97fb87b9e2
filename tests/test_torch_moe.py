"""The port's MoE FFN (``repro_torch.models.ffn.moe_init``/``moe_apply``)
against the JAX package's, on the CPU, on the reduced ``qwen2-moe`` (8
experts top-4, 2 shared experts, renormalised top-k) and ``phi3.5-moe`` (8
experts top-2, no shared) configs, with the reference's params and the
same numpy inputs; then the reference's own four routing properties
(tests/test_moe.py) re-run on the port.

Tolerances, each with its reason (all in float32):
* the routing: the routed experts, the stable sort by expert, each
  assignment's slot and which assignments are dropped past the capacity
  are equal (integers; the router's probabilities agree to ~1e-7 and no
  two of them tie);
* the output ``y``: 1e-5 of its largest magnitude (the same float32
  products and float32 combine, summed in another order);
* the aux loss: rtol 1e-6 (a float32 mean of the same probabilities).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import ffn as jffn
from repro_torch import configs
from repro_torch.dist.context import sharding_context
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import ffn

TOL = 1e-5
ARCHS = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")
# (batch, seq): one dispatch group (16 tokens) and two (128 tokens); the
# reference's default capacity factor, and one that drops most overflow
SHAPES = {"one_group": (2, 8), "two_groups": (2, 64)}
FACTORS = (1.25, 0.5)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol * scale, f"max|diff| {err:.3e} vs {tol} x {scale:.3e}"


@functools.lru_cache(maxsize=None)
def params(arch):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = jconfigs.reduced_config(arch)
    jp, _ = jffn.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    pn = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, configs.reduced_config(arch), \
        jax.tree_util.tree_map(t, pn)


def ref_dispatch(p, cfg, x, cf):
    """The reference's routing, its own lines of ``moe_apply``
    (src/repro/models/ffn.py), up to the slots: (top_e, sort_idx,
    sorted_e, pos_safe, keep, cap)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    xf = x.reshape(-1, cfg.d_model)
    t_ = xf.shape[0]
    probs = jax.nn.softmax((xf @ p["router"]["w"]).astype(jnp.float32), -1)
    _, top_e = jax.lax.top_k(probs, k)
    g = jffn._dispatch_groups(t_)
    tg = t_ // g
    cap = int(max(1, round(tg * k / e * cf)))
    flat_e = top_e.reshape(g, tg * k)
    sort_idx = jnp.argsort(flat_e, axis=1)
    sorted_e = jnp.take_along_axis(flat_e, sort_idx, axis=1)
    counts = jax.vmap(lambda f: jnp.bincount(f, length=e))(flat_e)
    offsets = jnp.cumsum(counts, axis=1) - counts
    pos_in_e = (jnp.arange(tg * k)[None, :]
                - jnp.take_along_axis(offsets, sorted_e, axis=1))
    keep = pos_in_e < cap
    return [np.asarray(a) for a in (top_e, sort_idx, sorted_e,
                                    jnp.where(keep, pos_in_e, cap), keep)] \
        + [cap]


@functools.lru_cache(maxsize=None)
def case(arch, shape, cf):
    jcfg, jp, cfg, p = params(arch)
    b, s = SHAPES[shape]
    seed = 10 * sorted(SHAPES).index(shape) + FACTORS.index(cf)
    x = np.random.RandomState(seed).randn(
        b, s, cfg.d_model).astype(np.float32)
    jy, jaux = jffn.moe_apply(jp, jcfg, jnp.asarray(x), capacity_factor=cf)
    y, aux = ffn.moe_apply(p, cfg, t(x), capacity_factor=cf)
    route = ffn.moe_route(p, cfg, t(x).reshape(-1, cfg.d_model), cf)
    return (np.asarray(jy), float(jaux), ref_dispatch(jp, jcfg, jnp.asarray(x),
                                                     cf),
            y, aux, route)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, shape, cf):
    jy, jaux, (top_e, sort_idx, sorted_e, pos, keep, cap), y, aux, r = \
        case(arch, shape, cf)
    assert r.cap == cap
    assert r.sort_idx.shape[0] == (2 if shape == "two_groups" else 1)
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    np.testing.assert_array_equal(r.sort_idx.numpy(), sort_idx)
    np.testing.assert_array_equal(r.sorted_e.numpy(), sorted_e)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal((r.pos < r.cap).numpy(), keep)
    if cf == 0.5:   # the case of capacity drops
        assert not keep.all()
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    close(y, jy)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-6)


def test_a_moe_group_mesh_axis_raises(rng):
    """A ``moe_group`` axis on the single-controller mesh: nothing raises,
    and moe_apply computes what it computes without a mesh (each group's
    dispatch is local anyway; 2 groups over a data axis of 2).  The
    shard-local dispatch on DTensors is held in test_torch_sharded_lm.py."""
    _, _, cfg, p = params("qwen2-moe-a2.7b")
    x = torch.from_numpy(rng.randn(2, 64, cfg.d_model).astype(np.float32))
    want_y, want_aux = ffn.moe_apply(p, cfg, x)
    assert ffn._dispatch_groups(2 * 64) == 2
    with sharding_context(make_test_mesh(2, device="cpu"),
                          {"moe_group": "data"}):
        y, aux = ffn.moe_apply(p, cfg, x)
    assert torch.equal(y, want_y) and torch.equal(aux, want_aux)


# ---------------------------------------------------------------------------
# the reference's routing properties (tests/test_moe.py) on the port
# ---------------------------------------------------------------------------
def _cfg(**kw):
    return dataclasses.replace(configs.reduced_config("phi3.5-moe-42b-a6.6b"),
                               **kw)


def _init(cfg):
    return ffn.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                        device="cpu")


def test_nodrop_matches_dense_mixture(rng):
    cfg = _cfg(moe_capacity_factor=100.0)
    p = _init(cfg)
    x = torch.from_numpy(rng.randn(2, 8, cfg.d_model).astype(np.float32))
    y, _ = ffn.moe_apply(p, cfg, x, capacity_factor=100.0)
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p["router"]["w"], -1)
    top_p, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    outs = torch.stack([(torch.nn.functional.silu(xf @ p["wg"][e])
                         * (xf @ p["wu"][e])) @ p["wd"][e]
                        for e in range(cfg.n_experts)], 1)   # (T, E, D)
    ref = sum(top_p[:, j:j + 1] * outs[torch.arange(len(xf)), top_e[:, j]]
              for j in range(cfg.moe_top_k))
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               ref.numpy(), rtol=2e-3, atol=2e-3)


def test_capacity_drops_tokens(rng):
    cfg = _cfg()
    p = _init(cfg)
    x = torch.from_numpy(rng.randn(2, 32, cfg.d_model).astype(np.float32))
    y_full, _ = ffn.moe_apply(p, cfg, x, capacity_factor=100.0)
    y_tight, _ = ffn.moe_apply(p, cfg, x, capacity_factor=0.25)
    assert torch.isfinite(y_tight).all()
    assert float(y_tight.abs().sum()) < float(y_full.abs().sum())


def test_aux_loss_balanced_is_one(rng):
    cfg = _cfg()
    p = _init(cfg)
    p["router"]["w"] = torch.zeros_like(p["router"]["w"])
    x = torch.from_numpy(rng.randn(2, 64, cfg.d_model).astype(np.float32))
    _, aux = ffn.moe_apply(p, cfg, x)
    assert float(aux) == pytest.approx(1.0, rel=0.1)


def test_shared_experts_add(rng):
    cfg = dataclasses.replace(configs.reduced_config("qwen2-moe-a2.7b"),
                              moe_capacity_factor=100.0)
    p = _init(cfg)
    x = torch.from_numpy(rng.randn(1, 8, cfg.d_model).astype(np.float32))
    y, _ = ffn.moe_apply(p, cfg, x, capacity_factor=100.0)
    p["shared"]["wd"]["w"] = torch.zeros_like(p["shared"]["wd"]["w"])
    y2, _ = ffn.moe_apply(p, cfg, x, capacity_factor=100.0)
    assert float((y - y2).abs().max()) > 1e-6
