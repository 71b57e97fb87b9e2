"""The port's LM modules (``repro_torch.models.{nn, attention, ffn,
transformer}``, ``repro_torch.configs``, ``repro_torch.dist.context``)
against the JAX package's, on the CPU, with the same numpy inputs made
from a seed and the reference's params loaded through
`lm_params_from_numpy`.

Tolerances, each with its reason (all in float32):
* RoPE, attention, FFN, norms, softcap, embeddings: 1e-5 of the largest
  magnitude of the reference's result (the same float32 products, summed
  in another order);
* ``quantize_kv``: int8 values and scales equal (both round half to even);
* ``apply_lm`` logits in "train", "prefill" and "decode", and the caches
  after them, on all ten reduced configs: 1e-5 of their largest
  magnitude; for xlstm-1.3b 3e-5.  Its eight blocks each agree to ~2e-7
  (tests/test_torch_recurrent.py), but the stack amplifies a perturbation
  about twofold per block: scaling the reference's own params by
  (1 + 1e-7), less than one float32 ulp, moves its train logits by
  1.4e-5 of their max, and the port's differ by 1.2e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models import nn as jnn
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.core.tree import tree_leaves
from repro_torch.dist.context import constrain, current, sharding_context
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention, ffn, nn, transformer

TOL = 1e-5
DENSE = ("deepseek-7b", "chatglm3-6b", "minitron-4b", "gemma2-27b",
         "qwen2-vl-7b", "musicgen-medium")
ALL = DENSE + ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
               "xlstm-1.3b")
LM_TOL = {"xlstm-1.3b": 3e-5}
MODES = ("train", "prefill", "decode")
BATCH, SEQ, MAX_LEN, DECODE_STEPS = 2, 20, 32, 2


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol * scale, f"max|diff| {err:.3e} vs {tol} x {scale:.3e}"


def t(a):
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# RoPE, attention, FFN, norms, embeddings
# ---------------------------------------------------------------------------
ROPES = {
    "standard": dict(rotary_frac=1.0, mrope_sections=None),
    "2d": dict(rotary_frac=0.5, mrope_sections=None),
    "mrope": dict(rotary_frac=1.0, mrope_sections=(4, 2, 2)),
}


@pytest.mark.parametrize("form", sorted(ROPES))
def test_apply_rope_matches_reference(form):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 4, 16).astype(np.float32)
    if form == "mrope":   # t, h and w positions differ
        pos = rng.randint(0, 50, (3, 2, 6)).astype(np.int32)
    else:
        pos = rng.randint(0, 50, (2, 6)).astype(np.int32)
    kw = dict(theta=1e4, **ROPES[form])
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), **kw)
    close(attention.apply_rope(t(x), t(pos), **kw), want)


def _ring(size, pos):
    """Slot positions of a ring buffer of ``size`` slots after ``pos``
    tokens (slot j holds the newest position congruent to j)."""
    out = np.full((size,), -1, np.int32)
    for p in range(pos):
        out[p % size] = p
    return out


ATTENTION = {
    "causal": dict(),
    "window": dict(window=8),
    "softcap": dict(softcap_val=5.0, scale=0.5),
    "decode_int8": dict(window=16),
}


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_blocked_attention_matches_reference(case):
    rng = np.random.RandomState(1)
    kw = dict(ATTENTION[case], block_q=16, block_k=16)
    if case != "decode_int8":
        q = rng.randn(2, 40, 4, 16).astype(np.float32)
        k = rng.randn(2, 40, 2, 16).astype(np.float32)
        v = rng.randn(2, 40, 2, 16).astype(np.float32)
        want = jattn.blocked_attention(*map(jnp.asarray, (q, k, v)), **kw)
        close(attention.blocked_attention(t(q), t(k), t(v), **kw), want)
        return
    # one new token against a 24-slot int8 ring buffer after 30 tokens
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    k = rng.randint(-127, 128, (2, 24, 2, 16)).astype(np.int8)
    v = rng.randint(-127, 128, (2, 24, 2, 16)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (2, 24, 2, 1)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (2, 24, 2, 1)).astype(np.float32)
    spos = _ring(24, 31)
    kvpos = np.where(spos < 0, np.iinfo(np.int32).max, spos).astype(np.int32)
    kw.update(q_offset=30, kv_len=31, block_q=1)
    want = jattn.blocked_attention(
        *map(jnp.asarray, (q, k, v)), kv_positions=jnp.asarray(kvpos),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **kw)
    got = attention.blocked_attention(t(q), t(k), t(v), kv_positions=t(kvpos),
                                      k_scale=t(ks), v_scale=t(vs), **kw)
    close(got, want)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_ffn_matches_reference(activation):
    p, _ = jffn.ffn_init(jax.random.PRNGKey(3), 64, 128, jnp.float32,
                         activation)
    x = np.random.RandomState(3).randn(2, 5, 64).astype(np.float32)
    want = jffn.ffn_apply(p, jnp.asarray(x), activation)
    got = ffn.ffn_apply(jax.tree_util.tree_map(t, np_tree(p)), t(x),
                        activation)
    close(got, want)


def _norm_case(which):
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 5, 64) * 3 + 1).astype(np.float32)
    if which == "rmsnorm":
        p = {"scale": rng.randn(64).astype(np.float32)}
        return (jnn.rmsnorm({"scale": jnp.asarray(p["scale"])},
                            jnp.asarray(x), 1e-6),
                nn.rmsnorm({"scale": t(p["scale"])}, t(x), 1e-6))
    if which == "layernorm":
        p = {"scale": rng.randn(64).astype(np.float32),
             "bias": rng.randn(64).astype(np.float32)}
        return (jnn.layernorm(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), 1e-5),
                nn.layernorm({k: t(a) for k, a in p.items()}, t(x), 1e-5))
    if which == "softcap":
        y = x * 40
        return (jnn.softcap(jnp.asarray(y), 30.0), nn.softcap(t(y), 30.0))
    table = rng.randn(512, 64).astype(np.float32)
    if which == "embed":
        toks = rng.randint(0, 512, (2, 7)).astype(np.int32)
        return (jnn.embed({"table": jnp.asarray(table)}, jnp.asarray(toks)),
                nn.embed({"table": t(table)}, t(toks)))
    return (jnn.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)),
            nn.unembed({"table": t(table)}, t(x)))


@pytest.mark.parametrize("which", ["rmsnorm", "layernorm", "softcap",
                                   "embed", "unembed"])
def test_norms_softcap_and_embeddings_match_reference(which):
    want, got = _norm_case(which)
    close(got, want)


def test_quantize_kv_is_bit_equal():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 2, 16).astype(np.float32) * 3
    # a row whose scale is exactly 1 (127 / 127 + 1e-8 rounds to 1.0): its
    # halves are ties, which both packages must round to even
    x[0, 0, 0] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                  126.5, -126.5, 4.5, 5.5, 0.0, -0.0, 6.5, -7.5]
    jq, js = jattn.quantize_kv(jnp.asarray(x))
    q, s = attention.quantize_kv(t(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        q.numpy()[0, 0, 0],
        [127, 0, 2, 2, 0, -2, -2, 4, 126, -126, 4, 6, 0, 0, 6, -8])


# ---------------------------------------------------------------------------
# the whole model: reduced configs of the six dense-family archs
# ---------------------------------------------------------------------------
def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    s_tok = SEQ - cfg.frontend_len if cfg.frontend else SEQ
    toks = rng.randint(0, cfg.vocab_size, (BATCH, s_tok)).astype(np.int32)
    fe = (rng.randn(BATCH, cfg.frontend_len, cfg.frontend_dim)
          .astype(np.float32) if cfg.frontend else None)
    return toks, fe


@functools.lru_cache(maxsize=None)
def lm_case(arch):
    """The reference's and the port's logits of one reduced config in the
    three modes, on the same params and tokens: the train pass over the
    prompt, its prefill into a cache of MAX_LEN, then DECODE_STEPS greedy
    tokens (the reference's picks, fed to both)."""
    jcfg = jconfigs.reduced_config(arch)
    cfg = configs.reduced_config(arch)
    jp, _ = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    pn = np_tree(jp)
    p = transformer.lm_params_from_numpy(pn, cfg, "cpu")
    toks, fe = _inputs(cfg)
    jfe = None if fe is None else jnp.asarray(fe)
    tfe = None if fe is None else t(fe)
    out = {"ref": {}, "port": {}}

    lg, _, _ = jtr.apply_lm(jp, jcfg, jnp.asarray(toks), jfe, mode="train")
    out["ref"]["train"] = [np.asarray(lg)]
    out["port"]["train"] = [transformer.apply_lm(p, cfg, t(toks), tfe,
                                                 mode="train")[0]]

    jc = jtr.init_cache(jcfg, BATCH, MAX_LEN)
    lg, jc, _ = jtr.apply_lm(jp, jcfg, jnp.asarray(toks), jfe,
                             mode="prefill", cache=jc)
    c = transformer.init_cache(cfg, BATCH, MAX_LEN, "cpu")
    tl, c, _ = transformer.apply_lm(p, cfg, t(toks), tfe, mode="prefill",
                                    cache=c)
    out["ref"]["prefill"], out["port"]["prefill"] = [np.asarray(lg)], [tl]
    out["ref"]["decode"], out["port"]["decode"] = [], []
    for _ in range(DECODE_STEPS):
        nxt = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None].astype(np.int32)
        lg, jc, _ = jtr.apply_lm(jp, jcfg, jnp.asarray(nxt), None,
                                 mode="decode", cache=jc)
        tl, c, _ = transformer.apply_lm(p, cfg, t(nxt), None, mode="decode",
                                        cache=c)
        out["ref"]["decode"].append(np.asarray(lg))
        out["port"]["decode"].append(tl)
    out["caches"] = (np_tree(jc), transformer.lm_cache_to_numpy(c))
    out["params"] = (pn, p)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ALL)
def test_apply_lm_matches_reference(arch, mode):
    case = lm_case(arch)
    tol = LM_TOL.get(arch, TOL)
    for want, got in zip(case["ref"][mode], case["port"][mode]):
        assert got.dtype == torch.float32
        close(got, want, tol)
    if mode == "decode":
        want, got = case["caches"]
        assert int(got["pos"]) == int(want["pos"]) == SEQ + DECODE_STEPS
        flat_w, flat_g = (jax.tree_util.tree_leaves(want),
                          tree_leaves(got))
        assert [a.shape for a in flat_g] == [a.shape for a in flat_w]
        for a, b in zip(flat_g, flat_w):
            assert a.dtype == b.dtype
            if a.dtype in (np.int8, np.int32):   # quantized k/v, positions
                np.testing.assert_array_equal(a, b)
            else:
                close(a, b, tol)


@pytest.mark.parametrize("arch", ALL)
def test_weights_and_cache_round_trip(arch):
    case = lm_case(arch)
    pn, p = case["params"]
    cfg = configs.reduced_config(arch)
    # the port's tree walks its leaves in the reference's order
    assert [tuple(a.shape) for a in tree_leaves(p)] == \
        [a.shape for a in jax.tree_util.tree_leaves(pn)]
    back = transformer.lm_params_to_numpy(p)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(pn)):
        np.testing.assert_array_equal(a, b)
    jc = case["caches"][0]
    c = transformer.lm_cache_from_numpy(jc, cfg, BATCH, MAX_LEN, "cpu")
    for a, b in zip(tree_leaves(transformer.lm_cache_to_numpy(c)),
                    jax.tree_util.tree_leaves(jc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # a tree of another shape is refused by name
    bad = dict(pn, embed={"table": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="embed/table"):
        transformer.lm_params_from_numpy(bad, cfg, "cpu")


def test_bf16_leaves_cross_by_their_bits():
    cfg = dataclasses.replace(configs.reduced_config("deepseek-7b"),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.reduced_config("deepseek-7b"),
                               dtype="bfloat16")
    jp, _ = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    p = transformer.lm_params_from_numpy(np_tree(jp), cfg, "cpu")
    assert p["embed"]["table"].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(transformer.lm_params_to_numpy(p)),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_dense_init_needs_its_device():
    """A draw on the card must not move to the host by a default: a call
    without ``device`` fails on the signature, before any draw (so this
    runs without a card; the stand-in is never used)."""
    class CardGenerator:
        device = torch.device("cuda")

    with pytest.raises(TypeError, match="device"):
        nn.dense_init(CardGenerator(), 4, 8, torch.float32)
    p = nn.dense_init(torch.Generator().manual_seed(0), 4, 8, torch.float32,
                      bias=True, device="cpu")
    assert p["w"].shape == (4, 8) and p["b"].device.type == "cpu"


# ---------------------------------------------------------------------------
# configs, shapes, the sharding context
# ---------------------------------------------------------------------------
def test_configs_equal_reference():
    assert configs.list_configs() == jconfigs.list_configs()
    assert list(configs.LM_CONFIGS) == list(jconfigs.LM_CONFIGS)
    for name, jc in jconfigs.LM_CONFIGS.items():
        c = configs.get_config(name)
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert c.param_count() == jc.param_count()
        assert c.active_param_count() == jc.active_param_count()
        assert (dataclasses.asdict(configs.reduced_config(name))
                == dataclasses.asdict(jconfigs.reduced_config(name)))
    for name, jc in jconfigs.DCNN_CONFIGS.items():
        assert configs.get_config(name).name == jc.name
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")
    full = configs.get_config("deepseek-7b")
    assert full.tdtype == torch.bfloat16
    meta = transformer.init_lm(None, full, device="meta")
    # the analytic count leaves out the norms' scales
    assert nn.tree_size(meta) == full.param_count() + 4096 * (2 * 30 + 1)


@pytest.mark.parametrize("arch", ALL)
def test_input_specs_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        assert (configs.shape_applicable(cfg, shape) is None) == \
            (jconfigs.shape_applicable(jcfg, jshape) is None)
        got = configs.input_specs(cfg, shape)
        want = jconfigs.input_specs(jcfg, jshape)
        assert sorted(got) == sorted(want)
        g_leaves = tree_leaves(got)
        w_leaves = jax.tree_util.tree_leaves(want)
        assert [tuple(a.shape) for a in g_leaves] == \
            [a.shape for a in w_leaves]
        assert all(a.device.type == "meta" for a in g_leaves)
        assert [str(a.dtype).replace("torch.", "") for a in g_leaves] == \
            [str(a.dtype) for a in w_leaves]


def test_constrain_is_the_identity_without_a_model_axis():
    x = torch.ones(2, 3)
    assert constrain(x, "batch", None) is x
    mesh = make_test_mesh(2, device="cpu")
    with sharding_context(mesh, {"batch": "data"}):
        assert current() == (mesh, {"batch": "data"})
        assert constrain(x, "batch", None) is x
    assert current() == (None, None)
    # a model axis needs the LM's process-group mesh
    with pytest.raises(TypeError, match="LmMesh"):
        with sharding_context(make_test_mesh(2, model=2, device="cpu"), {}):
            constrain(x, "batch", "embed")
    assert current() == (None, None)
