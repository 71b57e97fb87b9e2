"""The port's training path against the JAX package's, on the CPU.

Params come from the JAX package's inits and cross as numpy; the JAX side
runs its plain formulations (``backend="reverse_loop"``,
``make_fused_generator(fwd_backend="reverse_loop")``: its Pallas kernels
fail on this jax).  The port's "cuda" backend runs the plain version of
B1 on CPU tensors.  Noise: the port's ``critic_update``/``gen_update``
take the z and eps the reference draws from its key.

Tolerances: critic scores 1e-5; losses and grads 1e-5 relative; fused
generator values and grads 1e-5; one whole step's params and Adam
moments 1e-5; three supervised AdamW steps: the first step's moments
1e-5 relative, each loss rtol 1e-4, the params after them 1e-4 (a first
Adam step moves a param by about lr whatever its grad's size, so a grad
within rounding of zero can move it either way, and later steps carry
that)."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.data import pipeline as jpipe
from repro.models import dcnn as jdcnn
from repro.optim.optimizer import AdamW as JAdamW
from repro.train import supervised as jsup
from repro.train import wgan as jwgan
from repro.train.loop import TrainDriver as JTrainDriver
from repro.workloads import get as jget
from repro_torch.ckpt import (AsyncCheckpointer, restore, save,
                              train_state_from_numpy, valid_steps)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import pipeline as pipe
from repro_torch.kernels.deconv2d import deconv2d
from repro_torch.kernels.deconv2d.int8 import deconv2d_int8
from repro_torch.kernels.deconv2d_sparse import deconv2d_sparse
from repro_torch.models import dcnn
from repro_torch.optim import AdamW
from repro_torch.plan import build_network_plan, executable_fingerprints
from repro_torch.train import (NodeFailure, SupervisedTrainer, TrainDriver,
                               WganTrainer, critic_loss, generator_loss,
                               train_wgan)
from repro_torch.train.supervised import pair_source
from repro_torch.workloads import get

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
LR = 1e-4


def _tiny(mod):
    """The reference test's tiny WGAN tower (tests/test_wgan_system.py)."""
    return mod.DcnnConfig(
        name="tiny", z_dim=16, img_hw=16, img_c=1,
        layers=(mod.DeconvLayerCfg(16, 32, 4, 1, 0, "relu"),
                mod.DeconvLayerCfg(32, 16, 4, 2, 1, "relu"),
                mod.DeconvLayerCfg(16, 1, 4, 2, 1, "tanh")))


JTINY, TINY = _tiny(jdcnn), _tiny(dcnn)
NETS = {"mnist": (jdcnn.MNIST_DCNN, dcnn.MNIST_DCNN),
        "celeba": (jdcnn.CELEBA_DCNN, dcnn.CELEBA_DCNN), "tiny": (JTINY, TINY)}


class _TinySource:
    def batch(self, step):
        rng = np.random.RandomState(step)
        x = rng.randn(8, 16, 16, 1).astype(np.float32) * 0.2
        x[:, 4:12, 4:12, :] += 0.5
        return {"images": np.clip(x, -1, 1)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jopt():
    return JAdamW(lr=LR, b1=0.5, b2=0.9)


def _opt():
    return AdamW(lr=LR, b1=0.5, b2=0.9)


def _ref_params(jcfg, cfg, seed=0):
    """(reference gp, dp as jax; port gp, dp on the CPU) from one init."""
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    jgp, _ = jdcnn.generator_init(kg, jcfg)
    jdp, _ = jdcnn.critic_init(kd, jcfg)
    return (jgp, jdp, dcnn.generator_params_from_numpy(_np(jgp), cfg, "cpu"),
            dcnn.critic_params_from_numpy(_np(jdp), cfg, "cpu"))


def _assert_tree_close(ours, ref, rtol=TOL, atol=TOL):
    ol, rl = tree_leaves(ours), jax.tree_util.tree_leaves(ref)
    assert len(ol) == len(rl)
    for a, b in zip(ol, rl):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# critic, losses, fused generator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", ["mnist", "celeba"])
def test_critic_matches_reference(net, rng):
    jcfg, cfg = NETS[net]
    _, jdp, _, dp = _ref_params(jcfg, cfg)
    x = rng.uniform(-1, 1, (2, cfg.img_hw, cfg.img_hw, cfg.img_c)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p_, x_: jdcnn.critic_apply(
        p_, jcfg, x_))(jdp, x))
    got = dcnn.critic_apply(dp, cfg, torch.from_numpy(x))
    assert tuple(got.shape) == (2,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in dp.items()} == dcnn.critic_shapes(cfg)


def test_critic_head_reads_nhwc_features(rng):
    """A head fed NCHW-flattened features (every head weight permuted)
    disagrees with the reference: the parity above would catch it."""
    _, jdp, _, dp = _ref_params(JTINY, TINY)
    x = rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jdcnn.critic_apply(jdp, JTINY, x))
    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    for i in range(2):
        h = torch.nn.functional.leaky_relu(torch.nn.functional.conv2d(
            h, dp[f"c{i}"]["w"].permute(3, 2, 0, 1), dp[f"c{i}"]["b"],
            stride=2, padding=1), 0.2)
    wrong = (h.reshape(2, -1) @ dp["head"]["w"] + dp["head"]["b"])[:, 0]
    assert np.abs(wrong.numpy() - want).max() > 1e-3


def test_critic_params_from_numpy_checks_shapes():
    _, jdp, _, _ = _ref_params(JTINY, TINY)
    tree = _np(jdp)
    tree["head"] = {"w": tree["head"]["w"][:-1], "b": tree["head"]["b"]}
    with pytest.raises(ValueError, match="head.w"):
        dcnn.critic_params_from_numpy(tree, TINY, "cpu")
    with pytest.raises(ValueError, match="expects params"):
        dcnn.critic_params_from_numpy({"c0": tree["c0"]}, TINY, "cpu")


def _ref_critic_noise(key, bucket, shards, z_dim):
    """z and eps as the reference's critic step draws them per shard."""
    local = bucket // shards
    zs, es = [], []
    for i in range(shards):
        kz, kgp = jax.random.split(jax.random.fold_in(key, i))
        zs.append(np.asarray(jax.random.normal(kz, (local, z_dim))))
        es.append(np.asarray(jax.random.uniform(kgp, (local, 1, 1, 1))))
    return np.concatenate(zs), np.concatenate(es)


def _ref_gen_noise(key, bucket, shards, z_dim):
    local = bucket // shards
    return np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (local, z_dim))) for i in range(shards)])


@pytest.mark.parametrize("masked", [False, True])
def test_losses_and_grads_match_reference(masked, rng):
    jgp, jdp, gp, dp = _ref_params(JTINY, TINY)
    real = rng.uniform(-1, 1, (4, 16, 16, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    z = rng.randn(4, 16).astype(np.float32)
    # the reference's critic_loss draws its eps from the key it is given
    eps = np.asarray(jax.random.uniform(key, (4, 1, 1, 1)))
    mask = np.array([1, 1, 1, 0], np.float32) if masked else None
    nv = 3 if masked else None
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda dp_: jwgan.critic_loss(dp_, jgp, JTINY, real, z, key, mask=mask,
                                      n_valid=nv), has_aux=True))(jdp)
    dpg = tree_map(lambda t: t.requires_grad_(), dp)
    l, met = critic_loss(dpg, gp, TINY, torch.from_numpy(real),
                         torch.from_numpy(z), torch.from_numpy(np.array(eps)),
                         mask=None if mask is None else torch.from_numpy(mask),
                         n_valid=nv)
    g = torch.autograd.grad(l, tree_leaves(dpg))
    np.testing.assert_allclose(l.item(), float(jl), rtol=TOL)
    for k in ("wdist", "gp"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=TOL)
    for a, b in zip(g, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL * np.abs(np.asarray(b)).max())

    denom = 8.0 if masked else None
    jl, jg = jax.jit(jax.value_and_grad(
        lambda gp_: jwgan.generator_loss(gp_, jdp, JTINY, z, denom=denom)))(jgp)
    gpg = tree_map(lambda t: t.requires_grad_(), gp)
    l = generator_loss(gpg, dp, TINY, torch.from_numpy(z), denom=denom)
    g = torch.autograd.grad(l, tree_leaves(gpg))
    np.testing.assert_allclose(l.item(), float(jl), rtol=TOL)
    for a, b in zip(g, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("use_plan", [False, True])
def test_fused_generator_matches_reference_vjp(use_plan, rng):
    """The port's fused generator ("cuda": plain B1 on the CPU; or a
    pinned plan) against the reference's fused generator on its reverse
    loop: values, and the grads of every param and of z."""
    jgp, _, gp, _ = _ref_params(JTINY, TINY)
    z = rng.randn(3, 16).astype(np.float32)
    ct = rng.randn(3, 16, 16, 1).astype(np.float32)
    japply = jdcnn.make_fused_generator(JTINY, fwd_backend="reverse_loop")
    jy, (jgp_grad, jz_grad) = jax.jit(lambda p_, z_, ct_: (
        lambda out: (out[0], out[1](ct_)))(jax.vjp(japply, p_, z_)))(
            jgp, jnp.asarray(z), jnp.asarray(ct))
    plan = (build_network_plan(TINY, batch=3, autotune=False)
            if use_plan else None)
    apply = dcnn.make_fused_generator(TINY, plan=plan)
    gpg = tree_map(lambda t: t.requires_grad_(), gp)
    zt = torch.from_numpy(z).requires_grad_()
    y = apply(gpg, zt)
    assert y.grad_fn is not None
    grads = torch.autograd.grad(y, tree_leaves(gpg) + [zt],
                                torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jgp_grad) + [jz_grad]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_kernel_ops_refuse_to_build_a_graph(rng):
    """A kernel launch has no grad_fn: each public op raises instead of
    returning a tensor a loss would silently not train through."""
    x = torch.from_numpy(rng.randn(2, 4, 4, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 4, 8, 8).astype(np.float32))
    b = torch.zeros(8)
    xq = torch.from_numpy(rng.randint(-5, 5, (2, 4, 4, 8)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-5, 5, (4, 4, 8, 8)).astype(np.int8))
    calls = {
        "deconv2d": lambda w_: deconv2d(x, w_, b, 2, 1),
        "deconv2d_sparse": lambda w_: deconv2d_sparse(x, w_, b, 2, 1),
        "deconv2d_int8": lambda s_: deconv2d_int8(xq, wq, s_, b, 2, 1),
    }
    for name, call in calls.items():
        arg = (torch.full((8,), 0.01) if name == "deconv2d_int8" else w)
        with pytest.raises(RuntimeError, match="make_fused_generator"):
            call(arg.clone().requires_grad_())
        with torch.no_grad():
            call(arg.clone().requires_grad_())
        assert call(arg).grad_fn is None
    gp = dcnn.generator_init(torch.Generator().manual_seed(0), TINY, "cpu")
    gp["l1"]["w"].requires_grad_()
    for backend in ("cuda", "cuda_sparse"):
        with pytest.raises(RuntimeError, match="make_fused_generator"):
            dcnn.generator_apply(gp, TINY, torch.zeros(2, 16), backend=backend)
    with pytest.raises(ValueError, match="inference-only"):
        dcnn.make_fused_generator(TINY, fwd_backend="cuda_sparse")


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_steps():
    """Per z_shards: the reference's critic step and generator step from
    one init, on a ragged batch of 5 (bucket 8, or 9 with three shards),
    with their noise and the mean size of the generator step's scores."""
    out = {}
    real = np.random.RandomState(9).uniform(-1, 1, (5, 16, 16, 1)).astype(
        np.float32)
    for shards in (1, 2, 3):
        jgp, jdp, _, _ = _ref_params(JTINY, TINY, seed=1)
        t = jwgan.WganTrainer(JTINY, _jopt(), _jopt(), n_critic=1,
                              z_shards=shards)
        ds, gs = t.d_opt.init(jdp), t.g_opt.init(jgp)
        kc, kg = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
        dp1, ds1, dmet = t.critic_step(jdp, ds, jgp, real, kc)
        gp1, gs1, gmet = t.gen_step(jgp, gs, dp1, kg, 5)
        out[shards] = dict(
            real=real, dp0=_np(jdp), gp0=_np(jgp), dp1=_np(dp1), ds1=_np(ds1),
            gp1=_np(gp1), gs1=_np(gs1), dmet=_np(dmet), gmet=_np(gmet),
            bucket=t.bucket_for(5),
            gscale=float(jnp.mean(jnp.abs(jdcnn.critic_apply(
                dp1, JTINY, jdcnn.generator_apply(
                    jgp, JTINY, _ref_gen_noise(kg, t.bucket_for(5), shards,
                                               16)))))),
            noise=_ref_critic_noise(kc, t.bucket_for(5), shards, 16),
            gz=_ref_gen_noise(kg, t.bucket_for(5), shards, 16))
    return out


@pytest.mark.parametrize("backend", ["reverse_loop", "cudnn", "cuda"])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_wgan_steps_match_reference(shards, backend, ref_steps):
    """Ragged batch of 5: bucket 8, or 9 with three shards (the power of
    two rounded up to a multiple of the shard count)."""
    r = ref_steps[shards]
    t = WganTrainer(TINY, _opt(), _opt(), n_critic=1, z_shards=shards,
                    backend=backend, autotune=False, device="cpu")
    bucket = r["bucket"]
    assert t.bucket_for(5) == bucket == (9 if shards == 3 else 8)
    gp = dcnn.generator_params_from_numpy(r["gp0"], TINY, "cpu")
    dp = dcnn.critic_params_from_numpy(r["dp0"], TINY, "cpu")
    real = torch.cat([torch.from_numpy(r["real"]),
                      torch.zeros(bucket - 5, 16, 16, 1)])
    z, eps = (torch.from_numpy(a) for a in r["noise"])
    dp1, ds1, dmet = t.critic_update(dp, t.d_opt.init(dp), gp, real, 5, z,
                                     eps)
    _assert_tree_close(dp1, r["dp1"])
    _assert_tree_close(ds1, r["ds1"])
    for k, v in r["dmet"].items():
        np.testing.assert_allclose(float(dmet[k]), float(v), rtol=TOL)
    gp1, gs1, gmet = t.gen_update(gp, t.g_opt.init(gp), dp1,
                                  torch.from_numpy(r["gz"]))
    _assert_tree_close(gp1, r["gp1"])
    _assert_tree_close(gs1, r["gs1"])
    # with three shards the reference sums the shards' partial means in
    # another order, and its loss (-3.6e-4) is a difference of scores
    # about 20x larger: it is held there to 1e-5 of their mean size too
    np.testing.assert_allclose(float(gmet["g_loss"]), float(r["gmet"]["g_loss"]),
                               rtol=TOL,
                               atol=TOL * r["gscale"] if shards == 3 else 0)
    assert t.build_counts == {"critic": {bucket: 1}, "gen": {bucket: 1},
                              "plan": {bucket: 1} if backend == "cuda" else {}}
    if backend == "cuda":
        assert set(t.plan_fingerprints()) == {bucket // shards}
    # the public steps pad and draw at the same bucket
    t.critic_step(dp, t.d_opt.init(dp), gp, r["real"], (0, 1, 0))
    t.gen_step(gp, t.g_opt.init(gp), dp, (0, 1, 1), 5)
    assert t.total_builds == (3 if backend == "cuda" else 2)


def test_steps_draw_per_shard_and_build_once():
    """The public steps pad a ragged batch to its bucket and draw noise per
    (key, shard): the same key gives the same update, another key another;
    four ragged sizes build one step per kind."""
    t = WganTrainer(TINY, _opt(), _opt(), n_critic=1, z_shards=2,
                    device="cpu")
    gp, dp, gs, ds = t.init_state(0)
    src = np.random.RandomState(0)
    outs = []
    for n, key in ((5, (0, 1, 0)), (6, (0, 1, 0)), (7, (0, 2, 0)),
                   (8, (0, 2, 0))):
        real = src.uniform(-1, 1, (n, 16, 16, 1)).astype(np.float32)
        outs.append(t.critic_step(dp, ds, gp, real, key)[0])
        t.gen_step(gp, gs, dp, key, n)
    assert t.build_counts == {"critic": {8: 1}, "gen": {8: 1}, "plan": {}}
    assert t.total_builds == 2
    t2 = WganTrainer(TINY, _opt(), _opt(), n_critic=1, z_shards=2,
                     device="cpu")
    real = src.uniform(-1, 1, (5, 16, 16, 1)).astype(np.float32)
    a = t2.critic_step(dp, ds, gp, real, (0, 1, 0))[0]
    b = t2.critic_step(dp, ds, gp, real, (0, 1, 0))[0]
    c = t2.critic_step(dp, ds, gp, real, (0, 1, 1))[0]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(c)))


def test_pinned_plan_is_hash_asserted():
    plan = build_network_plan(TINY, batch=8, autotune=False)
    t = WganTrainer(TINY, _opt(), _opt(), n_critic=1, backend="cuda",
                    plan=plan, autotune=False, device="cpu")
    t._gen_for(8)
    assert t.plans[8] is plan
    assert t.plan_fingerprints() == executable_fingerprints([plan])
    other = dataclasses.replace(plan, layers=tuple(
        dataclasses.replace(l, tiles=dataclasses.replace(l.tiles, t_n=1))
        for l in plan.layers))
    assert other.stable_hash() != plan.stable_hash()
    t = WganTrainer(TINY, _opt(), _opt(), n_critic=1, backend="cuda",
                    plan=other, autotune=False, device="cpu")
    with pytest.raises(ValueError, match="pinned serving plan"):
        t._gen_for(8)
    with pytest.raises(ValueError, match="two plans"):
        executable_fingerprints([plan, other])
    with pytest.raises(ValueError, match="backend='cuda'"):
        WganTrainer(TINY, _opt(), _opt(), plan=plan, device="cpu")
    assert plan.tile_overrides() == {i: l.tiles
                                     for i, l in enumerate(plan.layers)}


def test_rejections():
    """The reference's up-front rejections (tests/test_wgan_system.py)."""
    with pytest.raises(ValueError, match="n_critic"):
        WganTrainer(TINY, _opt(), _opt(), n_critic=0)
    with pytest.raises(ValueError, match="n_critic"):
        train_wgan(TINY, _TinySource(), 1, 0, _opt(), _opt(), n_critic=0,
                   device="cpu")
    for cls, args in ((WganTrainer, (_opt(), _opt())),
                      (SupervisedTrainer, (_opt(),))):
        with pytest.raises(ValueError, match="inference-only"):
            cls(TINY, *args, backend="cuda_sparse")
        with pytest.raises(ValueError, match="unknown training backend"):
            cls(TINY, *args, backend="pallas")


def _assert_moments_close(ours, ref, rtol=TOL):
    """Adam's mu and nu, each leaf within ``rtol`` of its largest value:
    what the grads set, where a first step's params are not (they move by
    about lr whatever the grad's size)."""
    assert int(ours.step) == int(ref.step)
    for a, b in zip(tree_leaves((ours.mu, ours.nu)),
                    jax.tree_util.tree_leaves((ref.mu, ref.nu))):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= rtol * np.abs(b).max()


def test_supervised_steps_match_reference():
    """Three masked-MSE AdamW steps on the zoo's sr head at its published
    width, ragged batches of 5 (bucket 8): the port on "cuda" (plain B1)
    and "reverse_loop" against the reference's reverse loop.  The first
    step, from the same init: Adam's moments 1e-5 relative (what the
    grads set).  Each step's loss rtol 1e-4, and the params after three
    steps within 1e-4 (readings 2.2e-6 to 2.3e-5: at the third step one
    ReLU input of about 1e-8 rounds to opposite signs in the two
    packages, so from there the grads differ by about 1e-3 relative)."""
    lr, k = 1e-3, 3
    jw, w = jget("sr"), get("sr")
    jp, _ = jdcnn.generator_init(jax.random.PRNGKey(0), jw.cfg)
    p0 = _np(jp)
    jt = jsup.SupervisedTrainer(jw.cfg, JAdamW(lr=lr))
    js = jt.opt.init(jp)
    jsrc, src = jsup.pair_source(jw, 0, 5), pair_source(w, 0, 5)
    jstates, jlosses = [], []
    for step in range(k):
        b = jsrc.batch(step)
        jp, js, jmet = jt.step(jp, js, b["x"], b["y"])
        jstates.append(_np(js))
        jlosses.append(float(jmet["loss"]))
    for backend in ("cuda", "reverse_loop"):
        t = SupervisedTrainer(w.cfg, AdamW(lr=lr), backend=backend,
                              autotune=False, device="cpu")
        p = dcnn.generator_params_from_numpy(p0, w.cfg, "cpu")
        s = t.opt.init(p)
        for step in range(k):
            b = src.batch(step)
            np.testing.assert_array_equal(b["x"], jsrc.batch(step)["x"])
            p, s, met = t.step(p, s, b["x"], b["y"])
            if step == 0:
                _assert_moments_close(s, jstates[0])
            np.testing.assert_allclose(float(met["loss"]), jlosses[step],
                                       rtol=1e-4)
        _assert_tree_close(p, _np(jp), rtol=0, atol=1e-4)
        assert t.build_counts["step"] == {8: 1}
        assert t.build_counts["plan"] == ({8: 1} if backend == "cuda" else {})


# ---------------------------------------------------------------------------
# checkpoints, resume, streaming, the driver, the pipeline
# ---------------------------------------------------------------------------
def test_checkpoints_cross_packages(tmp_path):
    """A {g, d, gs, ds} state written by either package restores into the
    other, leaf for leaf; `train_state_from_numpy` gives the same state."""
    jt = jwgan.WganTrainer(JTINY, _jopt(), _jopt(), n_critic=1)
    jgp, jdp, jgs, jds = jt.init_state(jax.random.PRNGKey(4))
    jtree = {"g": jgp, "d": jdp, "gs": jgs, "ds": jds}
    jckpt.save(str(tmp_path / "ref"), 3, jtree, extra={"step": 3})
    t = WganTrainer(TINY, _opt(), _opt(), n_critic=1, device="cpu")
    gp, dp, gs, ds = t.init_state(0)
    like = {"g": gp, "d": dp, "gs": gs, "ds": ds}
    got, step, extra = restore(str(tmp_path / "ref"), like)
    assert (step, extra) == (3, {"step": 3})
    _assert_tree_close(got, jtree, rtol=0, atol=0)
    assert got["gs"].step.dtype == torch.int32
    _assert_tree_close(train_state_from_numpy(_np(jtree), "cpu"), jtree,
                       rtol=0, atol=0)

    # the port's state after one step, read back by the reference
    gp, gs, _ = t.gen_step(gp, gs, dp, (0, 0, 1), 8)
    ours = {"g": gp, "d": dp, "gs": gs, "ds": ds}
    save(str(tmp_path / "port"), 5, ours, extra={"step": 5})
    back, step, _ = jckpt.restore(str(tmp_path / "port"), jtree)
    assert step == 5 and int(back["gs"].step) == 1
    _assert_tree_close(ours, back, rtol=0, atol=0)

    # a leaf order mismatch (two leaves of one shape swapped) cannot load
    # silently through a reshape: shapes are checked per leaf
    bad = dict(like, d={"c1": like["d"]["c0"], "c0": like["d"]["c1"],
                        "head": like["d"]["head"]})
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path / "ref"), bad)


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path):
    d = str(tmp_path / "run")
    ck = AsyncCheckpointer(d, keep=5)
    train_wgan(TINY, _TinySource(), 4, 0, _opt(), _opt(), n_critic=2,
               ckpt=ck, ckpt_every=2, device="cpu")
    ck.wait()
    assert valid_steps(d) == [0, 2]
    g2, d2, _ = train_wgan(TINY, _TinySource(), 6, 0, _opt(), _opt(),
                           n_critic=2, resume_from=d, device="cpu")
    g3, d3, _ = train_wgan(TINY, _TinySource(), 6, 0, _opt(), _opt(),
                           n_critic=2, device="cpu")
    for a, b in zip(tree_leaves((g2, d2)), tree_leaves((g3, d3))):
        assert torch.equal(a, b)


def test_streaming_iterator_drains_exactly():
    """tests/test_wgan_system.py's streaming cases on the port."""
    src = _TinySource()
    stream = pipe.finite_batches(src, 3)
    t = WganTrainer(TINY, _opt(), _opt(), n_critic=1, device="cpu")
    _, _, hist = t.fit(stream, 10, 0, log_every=1)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert next(stream, None) is None
    assert all(np.isfinite(v) for h in hist for v in h.values())
    # n_critic=2 over 5 batches: 2 whole steps, no unpaired generator update
    t2 = WganTrainer(TINY, _opt(), _opt(), n_critic=2, device="cpu")
    _, _, hist2 = t2.fit(pipe.finite_batches(src, 5), 10, 0, log_every=1)
    assert [h["step"] for h in hist2] == [0, 1]
    # bare-array streams work too
    t3 = WganTrainer(TINY, _opt(), _opt(), n_critic=1, device="cpu")
    _, _, hist3 = t3.fit(iter([src.batch(0)["images"]] * 2), 10, 0,
                         log_every=1)
    assert [h["step"] for h in hist3] == [0, 1]


def test_train_driver_recovers_from_an_injected_failure(tmp_path):
    """The reference's driver semantics on a masked-MSE sr step: a failure
    injected once at step 3 restores the last committed checkpoint and
    the run ends where the uninterrupted one does (bitwise)."""
    w = get("sr")
    src = pair_source(w, 0, 4)
    t = SupervisedTrainer(w.cfg, AdamW(lr=1e-3), device="cpu")

    def step_fn(state, batch):
        p, s, met = t.step(*state, batch["x"], batch["y"])
        return (p, s), met

    fired = []

    def inject(step):
        if step == 3 and not fired:
            fired.append(step)
            return True
        return False

    drv = TrainDriver(step_fn, src, ckpt_dir=str(tmp_path / "run"),
                      ckpt_every=2, failure_injector=inject)
    s1 = drv.run(t.init_state(0), 5)
    assert drv.recoveries == 1 and fired == [3]
    assert [m["step"] for m in drv.metrics_log] == [0, 1, 2, 3, 4]
    s2 = TrainDriver(step_fn, src).run(t.init_state(0), 5)
    for a, b in zip(tree_leaves(s1), tree_leaves(s2)):
        assert torch.equal(a, b)
    # the same protocol in the reference's driver (its tests run it on LM
    # steps): recovery count and the logged steps agree
    jfired = []

    def jinject(step):
        if step == 3 and not jfired:
            jfired.append(step)
            return True
        return False

    jdrv = JTrainDriver(lambda st, b: (st, {"loss": 0.0}), jpipe.image_source(
        "mnist", 0, 2), ckpt_dir=str(tmp_path / "jrun"), ckpt_every=2,
        failure_injector=jinject)
    jdrv.run({"x": jnp.zeros(2)}, 5)
    assert jdrv.recoveries == drv.recoveries
    assert [m["step"] for m in jdrv.metrics_log] == [
        m["step"] for m in drv.metrics_log]


def test_train_driver_raises_what_is_not_a_node_failure(tmp_path):
    """A step that fails the same way every time (a kernel that does not
    launch, say) surfaces its error; only a NodeFailure is recovered."""
    calls = []

    def step_fn(state, batch):
        calls.append(1)
        raise RuntimeError("kernel launch failed")

    drv = TrainDriver(step_fn, pipe.image_source("mnist", 0, 2),
                      ckpt_dir=str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        drv.run({"x": torch.zeros(2)}, 3)
    assert drv.recoveries == 0 and len(calls) == 1
    assert issubclass(NodeFailure, RuntimeError)


def test_pipeline_batches_equal_the_references():
    for kind in ("mnist", "celeba"):
        a, b = pipe.image_source(kind, 3, 2), jpipe.image_source(kind, 3, 2)
        np.testing.assert_array_equal(a.batch(4)["images"],
                                      b.batch(4)["images"])
        np.testing.assert_array_equal(a.shard(1, 2).batch(1)["images"],
                                      b.shard(1, 2).batch(1)["images"])
    a, b = pipe.lm_source(1, 3, 8, 50), jpipe.lm_source(1, 3, 8, 50)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a.batch(2)[k], b.batch(2)[k])
    src = pipe.image_source("mnist", 0, 2)
    got = [r["images"] for r in pipe.finite_batches(src, 3, start=2)]
    want = [r["images"] for r in jpipe.finite_batches(
        jpipe.image_source("mnist", 0, 2), 3, start=2)]
    assert len(got) == 3
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    pf = pipe.Prefetcher(src, start_step=5)
    try:
        for want_step in (5, 6):
            step, rec = pf.get()
            assert step == want_step
            np.testing.assert_array_equal(rec["images"],
                                          src.batch(step)["images"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_example_trains_and_resumes_on_the_cpu(tmp_path):
    cmd = [sys.executable, str(ROOT / "examples" / "train_wgan_mnist_torch.py"),
           "--device", "cpu", "--batch", "4", "--ckpt-dir",
           str(tmp_path / "ck")]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for extra in (["--steps", "1"], ["--steps", "2", "--resume"]):
        res = subprocess.run(cmd + extra, capture_output=True, text=True,
                             timeout=300, env=env, cwd=str(tmp_path))
        assert res.returncode == 0, res.stderr
        assert "final MMD" in res.stdout
    assert "step    1" in res.stdout and "step    0" not in res.stdout
