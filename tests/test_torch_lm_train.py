"""LM training on the port (``repro_torch.quant.qmath.quantize_absmax``,
``repro_torch.optim.compression``, ``repro_torch.train.lm``,
``repro_torch.launch.train`` and ``examples/train_lm_torch.py``) against
the JAX package's, on the CPU: the int8 gradient compression bit for bit,
one training step against the reference's jitted step on the same params
and batch, and the launcher's checkpointed resume.

Tolerances, each with its reason:
* ``quantize_absmax``, ``compress_grads``, ``decompress_grads`` and the
  error feedback: equal (the same float32 division, round half to even
  and clip);
* one ``make_train_step`` step (float32), both packages' AdamW with lr
  1e-3 and eps 1e-3 and fresh states: the loss rtol 1e-5; Adam's first
  and second moments (the step's clipped grads) within 1e-4 of the
  reference's as ||difference|| / ||reference||; the params after the
  step within 1e-5 of their largest magnitude.  The grads agree to ~1e-5
  of each leaf's largest, but AdamW's update g / (|g| + eps) amplifies the
  error of a grad near zero by 1 / eps: at the default eps of 1e-8 a
  float32 rounding of a 1e-9 grad moves its param by ~2e-5 x lr.  With
  eps = lr every param carries its grad's error one to one (AdamW's own
  arithmetic at the default eps is held in tests/test_torch_optim.py).
  With compression, a grad within float32 noise of an int8 rounding
  boundary takes the neighbouring code in one package, so up to 1e-4 of
  the params may differ by up to 1e-3 of the largest (one quantization
  step through the update); all others within 1e-5.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro.optim import AdamW as JAdamW
from repro.optim import compression as jcomp
from repro.quant import qmath as jqmath
from repro.train import lm as jlm
from repro_torch import configs
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import lm_source
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.optim import AdamW, compression
from repro_torch.quant.qmath import quantize_absmax
from repro_torch.train.lm import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]


def t(a):
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# int8 compression, bit for bit
# ---------------------------------------------------------------------------
def _grads(rng):
    g = {"a": (rng.randn(33, 17) * 3e-3).astype(np.float32),
         "b": {"w": rng.randn(5, 7, 3).astype(np.float32),
               "z": np.zeros((4,), np.float32)},
         "c": (rng.randn(1000) * 1e-6).astype(np.float32)}
    g["a"][0, :4] = [0.0, -0.0, 1e-30, -2.5e-3]
    return g


def test_quantize_absmax_is_bit_equal(rng):
    for x in tree_leaves(_grads(rng)) + [
            # a tensor whose halves are exact ties (scale 1 + 1e-12 rounds
            # to 1 in float32)
            np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, -126.5],
                     np.float32)]:
        jq, js = jqmath.quantize_absmax(jnp.asarray(x))
        q, s = quantize_absmax(t(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_compress_grads_and_error_feedback_are_bit_equal(rng):
    jef = jcomp.init_error_feedback(jax.tree_util.tree_map(jnp.asarray,
                                                           _grads(rng)))
    ef = compression.init_error_feedback(
        jax.tree_util.tree_map(t, _grads(rng)))
    for _ in range(3):   # the residual carries into the next call
        g = _grads(rng)
        jq, js, jef = jcomp.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, g), jef)
        q, s, ef = compression.compress_grads(
            jax.tree_util.tree_map(t, g), ef)
        assert isinstance(ef, compression.EFState)
        for a, b in zip(tree_leaves((q, s, ef, compression.decompress_grads(
                q, s))), jax.tree_util.tree_leaves(
                    (jq, js, jef, jcomp.decompress_grads(jq, js)))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert compression.compression_ratio(ef.residual) == \
        jcomp.compression_ratio(jef.residual)


# ---------------------------------------------------------------------------
# one training step against the reference's jitted step
# ---------------------------------------------------------------------------
# (arch, grad_accum, compress, seq): deepseek's plain step; the MoE's aux
# loss through two microbatches and the int8 compression; xlstm's
# chunkwise mLSTM (128 tokens) through two microbatches
STEPS = {"deepseek": ("deepseek-7b", 1, False, 16),
         "moe_accum_compress": ("qwen2-moe-a2.7b", 2, True, 16),
         "xlstm_accum_chunkwise": ("xlstm-1.3b", 2, False, 128)}
BATCH = 4


@functools.lru_cache(maxsize=None)
def step_case(name):
    arch, ga, comp, seq = STEPS[name]
    jcfg, cfg = jconfigs.reduced_config(arch), configs.reduced_config(arch)
    jp, _ = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    p = transformer.lm_params_from_numpy(np_tree(jp), cfg, "cpu")
    batch = lm_source(0, BATCH, seq, cfg.vocab_size).batch(0)
    jopt, opt = JAdamW(lr=1e-3, eps=1e-3), AdamW(lr=1e-3, eps=1e-3)
    jout = jax.jit(jlm.make_train_step(jcfg, jopt, ga, comp))(
        jp, jopt.init(jp), jcomp.init_error_feedback(jp) if comp else None,
        {k: jnp.asarray(v) for k, v in batch.items()})
    out = make_train_step(cfg, opt, ga, comp)(
        p, opt.init(p), compression.init_error_feedback(p) if comp else None,
        batch)
    return np_tree(jout), out


def _ratio(got, want):
    num = sum(float(np.sum((a.numpy().astype(np.float64) - b) ** 2))
              for a, b in zip(tree_leaves(got),
                              jax.tree_util.tree_leaves(want)))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2))
              for b in jax.tree_util.tree_leaves(want))
    return np.sqrt(num / den)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_matches_reference(name):
    (jp, jst, jef, jmet), (p, st, ef, met) = step_case(name)
    comp = STEPS[name][2]
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert np.isfinite(float(met["ce"]))
    assert int(st.step) == int(jst.step) == 1
    assert _ratio(st.mu, jst.mu) <= 1e-4
    assert _ratio(st.nu, jst.nu) <= 1e-4
    got = [a.numpy() for a in tree_leaves(p)]
    want = jax.tree_util.tree_leaves(jp)
    assert [a.dtype for a in got] == [a.dtype for a in want]
    scale = max(float(np.max(np.abs(a))) for a in want)
    errs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, want)])
    if comp:
        assert ef is not None and jef is not None
        assert [tuple(a.shape) for a in tree_leaves(ef)] == \
            [a.shape for a in jax.tree_util.tree_leaves(jef)]
        assert np.mean(errs > 1e-5 * scale) <= 1e-4
        assert errs.max() <= 1e-3 * scale
    else:
        assert ef is None
        assert errs.max() <= 1e-5 * scale


def test_train_step_moves_bf16_params_and_keeps_dtypes():
    """A bf16 recurrentgemma step: every param keeps its dtype (RG-LRU's
    ``lam`` float32, the rest bf16), the moments are float32, the params
    move and the loss is finite."""
    cfg = dataclasses.replace(configs.reduced_config("recurrentgemma-2b"),
                              dtype="bfloat16")
    p = transformer.init_lm(torch.Generator().manual_seed(0), cfg)
    opt = AdamW(lr=1e-3)
    batch = lm_source(0, 2, 16, cfg.vocab_size).batch(0)
    p2, st, _, met = make_train_step(cfg, opt)(p, opt.init(p), None, batch)
    assert np.isfinite(float(met["loss"]))
    assert all(a.dtype == b.dtype for a, b in zip(tree_leaves(p2),
                                                  tree_leaves(p)))
    assert p2["rem"]["b0"]["mixer"]["rglru"]["lam"].dtype == torch.float32
    assert all(m.dtype == torch.float32 for m in tree_leaves(st.mu))
    assert any(bool((a != b).any()) for a, b in zip(tree_leaves(p2),
                                                    tree_leaves(p)))


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------
def _launch(tmp, steps, ckpt=True, extra=()):
    argv = ["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
            "--steps", str(steps), "--batch", "2", "--seq", "16",
            "--ckpt-every", "1", "--compress-grads", *extra]
    if ckpt:
        argv += ["--ckpt-dir", str(tmp)]
    return launch_train.run(launch_train.parse_args(argv))


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    (p3, opt3, ef3), d3 = _launch(tmp_path / "ck", 3)
    out = capsys.readouterr().out
    assert "params moved: " in out and "losses: " in out
    assert [m["step"] for m in d3.metrics_log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in d3.metrics_log)
    # resume: steps 3 and 4 only, from step 2's checkpoint (params, AdamW
    # state and the error feedback)
    (p5, opt5, ef5), d5 = _launch(tmp_path / "ck", 5)
    assert [m["step"] for m in d5.metrics_log] == [3, 4]
    assert isinstance(ef5, compression.EFState)
    # ... equal to an uninterrupted run of 5 steps
    (q5, optq, efq), dq = _launch(None, 5, ckpt=False)
    assert [m["loss"] for m in dq.metrics_log[3:]] == \
        [m["loss"] for m in d5.metrics_log]
    for a, b in zip(tree_leaves((p5, opt5, ef5)), tree_leaves((q5, optq,
                                                               efq))):
        assert torch.equal(a, b)


def test_launcher_and_example_refuse_no_card_and_run_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if not torch.cuda.is_available():
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "deepseek-7b", "--reduced", "--steps", "1"],
            capture_output=True, text=True, env=env, timeout=120)
        assert res.returncode == 2 and "--device cpu" in res.stdout
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--arch", "recurrentgemma-2b", "--steps", "2", "--batch", "2",
         "--seq", "12", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "arch=recurrentgemma-2b" in res.stdout
    assert "reduced=True" in res.stdout
    losses = [float(x) for x in res.stdout.split("losses: ")[1]
              .splitlines()[0].split()]
    assert len(losses) == 2 and all(np.isfinite(losses))
