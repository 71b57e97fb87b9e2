"""The port's recurrent blocks (``repro_torch.models.recurrent``) against
the JAX package's, on the CPU, with the reference's params and the same
numpy inputs: the temporal conv with and without its history, the
RG-LRU, the Griffin, mLSTM (both evaluation orders) and sLSTM blocks with
and without a carried state, the chunkwise mLSTM against the step order,
``time_scan``'s chunked recompute (values and grads) and the float32
leaves of a bf16 model.

Tolerances, each with its reason (all in float32):
* outputs and states of the conv, the RG-LRU and every block: 1e-5 of the
  largest magnitude of the reference's (the same float32 products, summed
  in another order; the conv history is a copy, so equal);
* the chunkwise mLSTM against the step order: 2e-4 (rtol and atol), the
  reference's own bound for the two orders (tests/test_mlstm_chunkwise.py:
  one sums the chunk's L x L products, the other T rank-one updates);
* ``time_scan`` over 300 steps, chunked under autograd, against the
  reference's ``time_scan`` and ``jax.grad``: 1e-5 of the largest
  magnitude, for the values and for the grads.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import recurrent as jrec
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.core.tree import tree_leaves
from repro_torch.models import recurrent, transformer

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol * scale, f"max|diff| {err:.3e} vs {tol} x {scale:.3e}"


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_tree(tree):
    return jax.tree_util.tree_map(t, np_tree(tree))


def randn(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# conv1d and RG-LRU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("history", [False, True])
def test_conv1d_matches_reference(history):
    rng = np.random.RandomState(0)
    p, _ = jrec.conv1d_init(jax.random.PRNGKey(0), 24, jnp.float32)
    p["b"] = jnp.asarray(randn(rng, 24))
    x = randn(rng, 2, 9, 24)
    st = randn(rng, 2, recurrent.CONV_W - 1, 24) if history else None
    jy, jst = jrec.conv1d_apply(p, jnp.asarray(x),
                                None if st is None else jnp.asarray(st))
    y, nst = recurrent.conv1d_apply(t_tree(p), t(x),
                                    None if st is None else t(st))
    close(y, jy)
    np.testing.assert_array_equal(nst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("h0", [False, True])
def test_rglru_matches_reference(h0):
    rng = np.random.RandomState(1)
    p, _ = jrec.rglru_init(jax.random.PRNGKey(1), 32, jnp.float32)
    x = randn(rng, 2, 11, 32)
    h = randn(rng, 2, 32) if h0 else None
    jy, jh = jrec.rglru_apply(p, jnp.asarray(x),
                              None if h is None else jnp.asarray(h))
    y, nh = recurrent.rglru_apply(t_tree(p), t(x),
                                  None if h is None else t(h))
    close(y, jy)
    close(nh, jh)


# ---------------------------------------------------------------------------
# the blocks, with and without a carried state
# ---------------------------------------------------------------------------
BLOCKS = {"griffin": "recurrentgemma-2b", "mlstm": "xlstm-1.3b",
          "slstm": "xlstm-1.3b"}
# mLSTM at 20 tokens takes the step order, at 128 the chunkwise one
LENGTHS = {"griffin": (13,), "mlstm": (20, 128), "slstm": (13,)}


@functools.lru_cache(maxsize=None)
def block_case(kind, seq, with_state):
    arch = BLOCKS[kind]
    jcfg, cfg = jconfigs.reduced_config(arch), configs.reduced_config(arch)
    p, _ = getattr(jrec, f"{kind}_block_init")(jax.random.PRNGKey(2), jcfg,
                                                jnp.float32)
    rng = np.random.RandomState(3)
    x = randn(rng, 2, seq, cfg.d_model)
    jstate = None
    if with_state:   # the state after a first run over 7 tokens
        _, jstate = getattr(jrec, f"{kind}_block_apply")(
            p, jcfg, jnp.asarray(randn(rng, 2, 7, cfg.d_model)))
    jy, jst = getattr(jrec, f"{kind}_block_apply")(p, jcfg, jnp.asarray(x),
                                                   jstate)
    y, st = getattr(recurrent, f"{kind}_block_apply")(
        t_tree(p), cfg, t(x), None if jstate is None else t_tree(jstate))
    return (np.asarray(jy), np_tree(jst)), (y, st)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kind,seq", [(k, s) for k in sorted(BLOCKS)
                                      for s in LENGTHS[k]])
def test_block_matches_reference(kind, seq, with_state):
    (jy, jst), (y, st) = block_case(kind, seq, with_state)
    close(y, jy)
    assert sorted(st) == sorted(jst)
    for name in jst:
        close(st[name], jst[name])


def test_state_init_matches_reference():
    for kind, arch in BLOCKS.items():
        jcfg, cfg = jconfigs.reduced_config(arch), configs.reduced_config(arch)
        want = getattr(jrec, f"{kind}_state_init")(jcfg, 3, jnp.bfloat16)
        got = getattr(recurrent, f"{kind}_state_init")(cfg, 3, torch.bfloat16,
                                                       "cpu")
        assert sorted(got) == sorted(want)
        for name, a in want.items():
            assert tuple(got[name].shape) == a.shape
            assert str(got[name].dtype).replace("torch.", "") == str(a.dtype)
            np.testing.assert_array_equal(got[name].float().numpy(),
                                          np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# chunkwise mLSTM against the step order
# ---------------------------------------------------------------------------
def _mlstm_inputs(rng, b, s, hh, dh):
    q, v = randn(rng, b, s, hh, dh), randn(rng, b, s, hh, dh)
    k = randn(rng, b, s, hh, dh) * dh ** -0.5
    li, lf = randn(rng, b, s, hh), -np.abs(randn(rng, b, s, hh))
    return [t(a) for a in (q, k, v, li, lf)]


def _step_order(q, k, v, li, lf, c0, n0, m0):
    seq = tuple(a.transpose(0, 1) for a in (q, k, v, li, lf))
    (c, n, m), ys = recurrent.time_scan(recurrent._mlstm_step,
                                        (c0, n0, m0), seq)
    return ys.transpose(0, 1), (c, n, m)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [128, 192])
def test_mlstm_chunkwise_equals_step_order(s, carried):
    rng = np.random.RandomState(s)
    b, hh, dh = 2, 2, 16
    q, k, v, li, lf = _mlstm_inputs(rng, b, s, hh, dh)
    c0 = torch.zeros((b, hh, dh, dh))
    n0 = torch.zeros((b, hh, dh))
    m0 = torch.full((b, hh), -1e30)
    if carried:   # the state after 64 earlier tokens
        pre = _mlstm_inputs(rng, b, 64, hh, dh)
        _, (c0, n0, m0) = _step_order(*pre, c0, n0, m0)
    h_cw, st_cw = recurrent.mlstm_chunkwise(q, k, v, li, lf, c0, n0, m0)
    h_st, st_st = _step_order(q, k, v, li, lf, c0, n0, m0)
    np.testing.assert_allclose(h_cw.numpy(), h_st.numpy(), rtol=2e-4,
                               atol=2e-4)
    for a, bb in zip(st_cw, st_st):
        np.testing.assert_allclose(a.numpy(), bb.numpy(), rtol=2e-4,
                                   atol=2e-4)
    # and the chunkwise order against the reference's
    jh, jst = jrec.mlstm_chunkwise(*(jnp.asarray(a.numpy())
                                     for a in (q, k, v, li, lf, c0, n0, m0)))
    close(h_cw, jh)
    for a, bb in zip(st_cw, jst):
        close(a, bb)


# ---------------------------------------------------------------------------
# time_scan: a chunk plus a tail, under autograd
# ---------------------------------------------------------------------------
def test_time_scan_chunked_values_and_grads():
    rng = np.random.RandomState(7)
    T, d = 300, 8
    w = randn(rng, d, d, scale=0.3)
    xs = randn(rng, T, 2, d)
    h0 = randn(rng, 2, d)

    def jloss(w, xs, h0):
        def step(h, x):
            h = jnp.tanh(h @ w + x)
            return h, h
        hf, ys = jrec.time_scan(step, h0, xs)
        return jnp.sum(ys * ys) + jnp.sum(hf), ys

    (jl, jys), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(w), jnp.asarray(xs), jnp.asarray(h0))

    tw, txs, th0 = (t(a).requires_grad_(True) for a in (w, xs, h0))
    calls = [0]

    def step(h, x):
        calls[0] += 1
        h = torch.tanh(h @ tw + x)
        return h, h

    hf, ys = recurrent.time_scan(step, th0, txs)
    loss = torch.sum(ys * ys) + torch.sum(hf)
    assert calls[0] == T
    grads = torch.autograd.grad(loss, (tw, txs, th0))
    # the full chunk of 256 steps ran again in the backward pass, the
    # 44-step tail did not
    assert calls[0] == T + recurrent.TIME_CHUNK
    close(ys, jys)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for g, jgi in zip(grads, jg):
        close(g, jgi)


# ---------------------------------------------------------------------------
# float32 leaves of a bf16 model
# ---------------------------------------------------------------------------
def test_lam_and_states_stay_float32_in_a_bf16_model():
    arch = "recurrentgemma-2b"
    cfg = dataclasses.replace(configs.reduced_config(arch), dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch),
                               dtype="bfloat16")
    p = transformer.init_lm(torch.Generator().manual_seed(0), cfg)
    assert p["units"]["b0"]["mixer"]["rglru"]["lam"].dtype == torch.float32
    assert p["units"]["b0"]["mixer"]["in_x"]["w"].dtype == torch.bfloat16
    jp, _ = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = transformer.lm_params_from_numpy(np_tree(jp), cfg, "cpu")
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    lam = tp["rem"]["b0"]["mixer"]["rglru"]["lam"]
    np.testing.assert_array_equal(
        lam.numpy(), np.asarray(jp["rem"]["b0"]["mixer"]["rglru"]["lam"]))
    cache = transformer.init_cache(cfg, 2, 16, "cpu")
    back = transformer.lm_cache_from_numpy(
        transformer.lm_cache_to_numpy(cache), cfg, 2, 16, "cpu")
    assert back["units"]["b0"]["h"].dtype == torch.float32
    assert back["units"]["b0"]["conv"].dtype == torch.bfloat16
    xcfg = dataclasses.replace(configs.reduced_config("xlstm-1.3b"),
                               dtype="bfloat16")
    xc = transformer.init_cache(xcfg, 2, 16, "cpu")["units"]
    assert {k: str(v.dtype) for k, v in xc["b0"].items()} == {
        "C": "torch.float32", "n": "torch.float32", "m": "torch.float32",
        "conv": "torch.bfloat16"}
    assert all(v.dtype == torch.float32 for v in xc["b7"].values())
