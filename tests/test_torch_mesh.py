"""The port's data-parallel mesh (serving, elastic remesh, WGAN-GP
training) against the JAX package's mesh engine and trainer, on the CPU.

The reference runs in a subprocess on 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, the way its own
mesh tests run), with ``backend="reverse_loop"`` (its Pallas kernels fail
on this jax); it writes its params, images, engine fields, remesh event
and one mesh-sharded critic and generator step to a scratch directory.
The port runs the same on `make_test_mesh(4, device="cpu")`: 4 shards
that repeat the CPU.  Tolerances: images 1e-5 (fp32).  The trainer: a
port mesh against the port's ``z_shards`` bit for bit (the same ops on
the same device); against the reference's mesh trainer, fed its z and
eps, losses 1e-4 relative, the critic's params rtol 2e-4 (its mesh
test's) and the critic step's Adam moments (its grads) 1e-5 as
||difference|| / ||ref|| per leaf.

The whole generator step from these initial params is ill-conditioned:
one of the critic's LeakyReLU inputs on the fakes lies 7.5e-9 from the
kink, where the two packages' convolutions round to opposite sides, and
its slope (0.2 or 1) moves the generator's grads by 0.3 %.  A first Adam
step moves each param by lr times the sign of its grad, so that shift
flips the step of the params whose grads are near zero: the whole step's
generator params are not compared, and its moments are held to 2e-2 per
leaf (a shard missing or counted twice moves them by 25 % or more).  The
generator step is then held alone: both packages' mesh trainers take it
with the critic replaced by its linearisation at the reference's fakes
(the reference critic's scores and input grads there), so no kink is
crossed and what is compared is the generator's own grads, their sum
over the shards and the update: params rtol 2e-4 (atol 1e-6), moments
1e-5 per leaf, the loss 1e-4 relative."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.train.wgan as wgan_mod
from repro_torch.analysis.check import PlanCheckError
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.dist import (DeviceLoss, FaultInjector, elastic_mesh,
                              reshard_tree)
from repro_torch.dist.sharding import batch_slices, replicate
from repro_torch.launch import DeviceMesh, make_serving_mesh, make_test_mesh
from repro_torch.models.dcnn import (DcnnConfig, DeconvLayerCfg, critic_init,
                                     generator_init)
from repro_torch.obs import trace as obstrace
from repro_torch.optim import AdamW
from repro_torch.plan import build_network_plan
from repro_torch.serve import DcnnServeEngine, EngineConfig, EngineDegraded
from repro_torch.serve.engine import shard_aligned_buckets
from repro_torch.train import WganTrainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = DcnnConfig(name="tiny", z_dim=16, img_hw=16, img_c=1, layers=(
    DeconvLayerCfg(16, 32, 4, 1, 0, "relu"),
    DeconvLayerCfg(32, 16, 4, 2, 1, "relu"),
    DeconvLayerCfg(16, 1, 4, 2, 1, "tanh")))
BUCKETS = (1, 2, 4, 8, 16)
TOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_RTOL = 2e-4
LR = 1e-4
PARAM_ATOL = 1e-6
MOMENT_TOL = {"ds1": 1e-5, "gs1": 2e-2, "lgs1": 1e-5}
ROW_TOL = 1e-4

REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
out = sys.argv[1]
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(out, "at.json")
import jax
import numpy as np
from repro.dist.inject import DeviceLoss, FaultInjector
from repro.launch.mesh import make_serving_mesh, make_test_mesh
from repro.models.dcnn import (DcnnConfig, DeconvLayerCfg, critic_init,
                               generator_init)
from repro.optim.optimizer import AdamW
from repro.serve import DcnnServeEngine, EngineConfig
from repro.train.wgan import WganTrainer

TINY = DcnnConfig(name="tiny", z_dim=16, img_hw=16, img_c=1, layers=(
    DeconvLayerCfg(16, 32, 4, 1, 0, "relu"),
    DeconvLayerCfg(32, 16, 4, 2, 1, "relu"),
    DeconvLayerCfg(16, 1, 4, 2, 1, "tanh")))
leaves = lambda t: [np.asarray(a) for a in jax.tree_util.tree_leaves(t)]
arrays, meta = {}, {}
params, _ = generator_init(jax.random.PRNGKey(0), TINY)
for j, a in enumerate(leaves(params)):
    arrays[f"p_{j}"] = a
rng = np.random.RandomState(0)
z, z2 = (rng.randn(n, 16).astype(np.float32) for n in (19, 7))
arrays.update(z=z, z2=z2)
cfg = EngineConfig(model=TINY, backend="reverse_loop",
                   mesh=make_serving_mesh(), buckets=(1, 2, 4, 8, 16))
eng = DcnnServeEngine.from_config(cfg, params)
arrays["y"] = eng.generate(z)
eng.generate(z)
meta["serve"] = dict(
    buckets=list(eng.buckets), n_devices=eng.n_devices,
    shard_batch=eng.shard_batch(16), stats=eng.stats,
    plans={b: p.stable_hash() for b, p in eng.plans.items()})
inj = FaultInjector([DeviceLoss(at_call=1, keep=2)])
eng = DcnnServeEngine.from_config(cfg, params, fault_injector=inj)
arrays["y_loss"] = eng.generate(z)
arrays["y_after"] = eng.generate(z2)
ev = dict(eng.fault_stats["remesh_events"][0])
meta["remesh"] = dict(
    {k: v for k, v in ev.items() if k != "bucket_stats_before"},
    calls_before={b: s["calls"] for b, s in ev["bucket_stats_before"].items()},
    n_devices=eng.n_devices, buckets_now=list(eng.buckets), stats=eng.stats)
kg, kd = jax.random.split(jax.random.PRNGKey(1))
jgp, _ = generator_init(kg, TINY)
jdp, _ = critic_init(kd, TINY)
opt = lambda: AdamW(lr=1e-4, b1=0.5, b2=0.9)
real = np.random.RandomState(9).uniform(-1, 1, (5, 16, 16, 1)).astype(
    np.float32)
kc, kgen = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
steps = {}
for kw in (dict(mesh=make_test_mesh(4, 1)), dict(z_shards=4)):
    t = WganTrainer(TINY, opt(), opt(), n_critic=1, **kw)
    dp1, ds1, dmet = t.critic_step(jdp, t.d_opt.init(jdp), jgp, real, kc)
    gp1, gs1, gmet = t.gen_step(jgp, t.g_opt.init(jgp), dp1, kgen, 5)
    steps[len(kw["mesh"].devices) if "mesh" in kw else "z"] = leaves(
        (dp1, ds1, gp1, gs1))
# the reference's mesh trainer is its z_shards trainer
assert all(np.array_equal(a, b) for a, b in zip(steps[4], steps["z"]))
bucket = t.bucket_for(5)
local = bucket // 4
zs, es, gz = [], [], []
for i in range(4):
    k1, k2 = jax.random.split(jax.random.fold_in(kc, i))
    zs.append(np.asarray(jax.random.normal(k1, (local, 16))))
    es.append(np.asarray(jax.random.uniform(k2, (local, 1, 1, 1))))
    gz.append(np.asarray(jax.random.normal(jax.random.fold_in(kgen, i),
                                           (local, 16))))
arrays.update(real=real, tz=np.concatenate(zs), eps=np.concatenate(es),
              gz=np.concatenate(gz))
# the generator step alone, on the critic's linearisation at the fakes
import jax.numpy as jnp
import repro.train.wgan as W
from repro.models.dcnn import critic_apply, generator_apply
fake = generator_apply(jgp, TINY, arrays["gz"])
score = critic_apply(dp1, TINY, fake)
cgrad = jax.grad(lambda x: critic_apply(dp1, TINY, x).sum())(fake)
arrays.update(lin_fake=np.asarray(fake), lin_score=np.asarray(score),
              lin_cgrad=np.asarray(cgrad))

def linear_critic(dp, cfg, x):
    d = jnp.sum((x[:, None] - fake[None]) ** 2, axis=(2, 3, 4))
    i = jnp.argmin(d, axis=1)
    return score[i] + jnp.sum(cgrad[i] * (x - fake[i]), axis=(1, 2, 3))

W.critic_apply = linear_critic
t = WganTrainer(TINY, opt(), opt(), n_critic=1, mesh=make_test_mesh(4, 1))
lgp1, lgs1, lgmet = t.gen_step(jgp, t.g_opt.init(jgp), dp1, kgen, 5)
for name, tree in dict(gp0=jgp, dp0=jdp, dp1=dp1, ds1=ds1, gp1=gp1,
                       gs1=gs1, lgp1=lgp1, lgs1=lgs1).items():
    for j, a in enumerate(leaves(tree)):
        arrays[f"{name}_{j}"] = a
meta["train"] = dict(bucket=bucket,
                     dmet={k: float(v) for k, v in dmet.items()},
                     gmet={k: float(v) for k, v in gmet.items()},
                     lgmet={k: float(v) for k, v in lgmet.items()})
np.savez(os.path.join(out, "ref.npz"), **arrays)
with open(os.path.join(out, "ref.json"), "w") as f:
    json.dump(meta, f)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's mesh run (see the module doc)."""
    out = tmp_path_factory.mktemp("ref_mesh")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(out)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-4000:]
    arrays = dict(np.load(out / "ref.npz"))
    meta = json.loads((out / "ref.json").read_text())
    return arrays, meta


def _tree(like, arrays, prefix):
    n = len(tree_leaves(like))
    return tree_unflatten(like, [torch.from_numpy(arrays[f"{prefix}_{j}"])
                                 for j in range(n)])


def _params(arrays):
    like = generator_init(torch.Generator().manual_seed(0), TINY, "cpu")
    return _tree(like, arrays, "p")


def _engine(params, backend, mesh=True, **kw):
    return DcnnServeEngine.from_config(EngineConfig(
        model=TINY, backend=backend, buckets=BUCKETS, device="cpu",
        mesh=make_test_mesh(4, device="cpu") if mesh else None, **kw),
        params)


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------
def test_mesh_shapes_and_shard_helpers():
    mesh = make_test_mesh(4, device="cpu")
    assert mesh.shape == {"data": 4, "model": 1}
    assert mesh.data == 4
    assert mesh.data_devices == (torch.device("cpu"),) * 4
    m2 = make_test_mesh(2, 2, device="cpu")
    assert m2.shape == {"data": 2, "model": 2} and len(m2.data_devices) == 2
    assert batch_slices(mesh.data, 16) == [
        slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
    assert batch_slices(1, 16) == [slice(0, 16)]
    with pytest.raises(ValueError, match="equal shards"):
        batch_slices(4, 6)
    with pytest.raises(ValueError):
        DeviceMesh((torch.device("cpu"),) * 3, model=2)


def test_shard_aligned_buckets_match_the_reference():
    from repro.serve.engine import shard_aligned_buckets as jaligned

    for n in (1, 2, 3, 4, 8):
        for buckets in ((1, 2, 4, 8, 16), (3, 5, 64), (64,)):
            assert shard_aligned_buckets(buckets, n) == jaligned(buckets, n)


def test_elastic_mesh_keeps_the_prefix_and_reshard_copies():
    devs = [torch.device("cpu")] * 5
    m = elastic_mesh(devs, model_parallel=2)
    assert m.shape == {"data": 2, "model": 2}
    assert elastic_mesh(devs[:3]).data == 3
    with pytest.raises(ValueError):
        elastic_mesh(devs[:1], model_parallel=2)
    tree = {"l0": {"w": torch.arange(6.).reshape(2, 3), "b": torch.ones(3)}}
    reps = replicate(tree, [torch.device("cpu")] * 2)
    moved = reshard_tree(tree, torch.device("cpu"))
    for t in (reps[0], reps[1], moved):
        for a, b in zip(tree_leaves(t), tree_leaves(tree)):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert len(reshard_tree(tree, m.data_devices)) == 2


def test_serving_mesh_needs_a_card():
    if torch.cuda.is_available():
        assert make_serving_mesh().data == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_serving_mesh()


# ---------------------------------------------------------------------------
# serving against the reference's mesh engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["reverse_loop", "cuda", "cudnn"])
def test_mesh_engine_matches_reference(ref, backend):
    arrays, meta = ref
    eng = _engine(_params(arrays), backend)
    want = meta["serve"]
    assert list(eng.buckets) == want["buckets"] == [4, 8, 16]
    assert eng.n_devices == want["n_devices"] == 4
    assert eng.shard_batch(16) == want["shard_batch"] == 4
    y = eng.generate(arrays["z"])
    np.testing.assert_allclose(y, arrays["y"], rtol=0, atol=TOL)
    eng.generate(arrays["z"])
    assert eng.stats == want["stats"]
    for b, p in eng.plans.items():
        assert p.batch == eng.shard_batch(b)
        if backend == "reverse_loop":   # the same plan, the same hash
            assert p.stable_hash() == want["plans"][str(b)]
    tput = eng.throughput()
    assert sorted(tput) == sorted(int(b) for b in want["plans"])
    for row in tput.values():
        assert row["img_per_s"] > 0
        assert row["img_per_s_per_device"] * 4 == pytest.approx(
            row["img_per_s"], rel=1e-12)


@pytest.mark.parametrize("backend", ["reverse_loop", "cuda"])
def test_mesh_engine_elastic_remesh_matches_reference(ref, backend):
    arrays, meta = ref
    want = meta["remesh"]
    inj = FaultInjector([DeviceLoss(at_call=1, keep=2)])
    eng = DcnnServeEngine.from_config(EngineConfig(
        model=TINY, backend=backend, buckets=BUCKETS,
        mesh=make_test_mesh(4, device="cpu")), _params(arrays),
        fault_injector=inj)
    tracer = obstrace.enable(clear=True)
    try:
        y = eng.generate(arrays["z"])
    finally:
        obstrace.disable()
    np.testing.assert_allclose(y, arrays["y_loss"], rtol=0, atol=TOL)
    np.testing.assert_allclose(eng.generate(arrays["z2"]), arrays["y_after"],
                               rtol=0, atol=TOL)
    ev, = eng.fault_stats["remesh_events"]
    for k in ("devices_before", "devices_after", "buckets"):
        assert ev[k] == want[k], k
    assert {str(b): v for b, v in ev["plan_hash_matches"].items()} \
        == want["plan_hash_matches"]
    assert all(ev["plan_hash_matches"].values())
    if backend == "reverse_loop":
        for k in ("plan_hashes_before", "plan_hashes_after"):
            assert {str(b): h for b, h in ev[k].items()} == want[k], k
    assert {str(b): s["calls"] for b, s in ev["bucket_stats_before"].items()} \
        == want["calls_before"]
    assert ev["seconds"] > 0
    assert eng.n_devices == want["n_devices"] == 2
    assert list(eng.buckets) == want["buckets_now"]
    assert eng.stats == want["stats"]
    assert len(eng.mesh.devices) == 2 and len(eng._replicas) == 2
    labels = {"net": "tiny", "workload": eng.workload, "precision": "fp32"}
    assert eng.metrics.get("engine.device_count").value(**labels) == 2
    assert eng.metrics.get("engine.fault_events").value(
        event="remesh_events", **labels) == 1
    assert "remesh" in [e.get("name") for e in tracer.events()]


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_mesh_engine_matches_single_device_engine(precision):
    params = generator_init(torch.Generator().manual_seed(3), TINY, "cpu")
    z = np.random.RandomState(1).randn(11, 16).astype(np.float32)
    kw = dict(precision=precision, calib_batch=8)
    y_m = _engine(params, "cuda", **kw).generate(z)
    y_1 = _engine(params, "cuda", mesh=False, **kw).generate(z)
    if precision == "int8":
        np.testing.assert_array_equal(y_m, y_1)
    else:
        np.testing.assert_allclose(y_m, y_1, rtol=0, atol=TOL)


def test_mesh_replicas_and_static_operands_per_shard():
    params = generator_init(torch.Generator().manual_seed(3), TINY, "cpu")
    eng = _engine(params, "cuda", warmup=True)
    assert eng.capture_counts == {b: 1 for b in eng.buckets}
    assert len(eng._replicas) == len(eng._statics) == 4
    assert eng._replicas[0] is eng.params
    ptrs = {eng._replicas[i]["l0"]["w"].data_ptr() for i in range(4)}
    assert len(ptrs) == 4          # a copy per shard, even on one device
    assert all(set(st) == set(eng._static) for st in eng._statics)
    ex = eng._fns[16]
    assert [s.bucket for s in ex.shards] == [4] * 4


def test_device_loss_without_elastic_is_degraded():
    params = generator_init(torch.Generator().manual_seed(3), TINY, "cpu")
    eng = DcnnServeEngine.from_config(EngineConfig(
        model=TINY, backend="reverse_loop", buckets=BUCKETS, elastic=False,
        mesh=make_test_mesh(4, device="cpu")), params,
        fault_injector=FaultInjector([DeviceLoss(at_call=0, keep=2)]))
    with pytest.raises(EngineDegraded, match="elastic mesh"):
        eng.generate(np.zeros((4, 16), np.float32))
    assert eng.fault_stats["remesh_events"] == [] and eng.n_devices == 4


def test_pinned_plan_gate_on_a_mesh():
    params = generator_init(torch.Generator().manual_seed(3), TINY, "cpu")
    plan = build_network_plan(TINY, batch=4, backend="cuda", autotune=False)
    mesh = make_test_mesh(2, device="cpu")
    # per-device batch 4 on 2 devices needs bucket 8, which (4, 16) lacks
    with pytest.raises(PlanCheckError) as ei:
        DcnnServeEngine.from_config(EngineConfig(
            model=TINY, buckets=(4, 16), mesh=mesh), params, plan=plan)
    assert {v.rule_id for v in ei.value.violations} == {"drc.bucket_mesh"}
    eng = DcnnServeEngine.from_config(EngineConfig(
        model=TINY, buckets=(4, 8, 16), mesh=mesh), params, plan=plan)
    assert eng.plans == {8: plan}


# ---------------------------------------------------------------------------
# WGAN-GP training
# ---------------------------------------------------------------------------
def _opt():
    return AdamW(lr=LR, b1=0.5, b2=0.9)


def _check_params(trees, arrays):
    for name, tree in trees.items():
        for j, a in enumerate(tree_leaves(tree)):
            np.testing.assert_allclose(
                a.detach().numpy(), arrays[f"{name}_{j}"], rtol=PARAM_RTOL,
                atol=PARAM_ATOL, err_msg=f"{name} leaf {j}")


def _check_moments(trees, arrays):
    """Adam's moments, ||difference|| / ||ref|| per leaf."""
    for name, tree in trees.items():
        for j, a in enumerate(tree_leaves(tree)):
            r = arrays[f"{name}_{j}"]
            err = np.linalg.norm(a.detach().numpy() - r)
            assert err <= MOMENT_TOL[name] * max(np.linalg.norm(r), 1e-30), \
                (name, j, err)


@pytest.mark.parametrize("backend", ["reverse_loop", "cudnn", "cuda"])
def test_mesh_trainer_matches_reference_mesh_trainer(ref, backend):
    arrays, meta = ref
    want = meta["train"]
    t = WganTrainer(TINY, _opt(), _opt(), n_critic=1, backend=backend,
                    autotune=False, mesh=make_test_mesh(4, device="cpu"))
    bucket = t.bucket_for(5)
    assert bucket == want["bucket"] == 8
    g = torch.Generator().manual_seed(0)
    gp = _tree(generator_init(g, TINY, "cpu"), arrays, "gp0")
    dp = _tree(critic_init(g, TINY, "cpu"), arrays, "dp0")
    real = torch.cat([torch.from_numpy(arrays["real"]),
                      torch.zeros(bucket - 5, 16, 16, 1)])
    z, eps, gz = (torch.from_numpy(arrays[k]) for k in ("tz", "eps", "gz"))
    dp1, ds1, dmet = t.critic_update(dp, t.d_opt.init(dp), gp, real, 5, z,
                                     eps)
    gp1, gs1, gmet = t.gen_update(gp, t.g_opt.init(gp), dp1, gz)
    # the generator's params: see the module doc, and the next test
    _check_params(dict(dp1=dp1), arrays)
    _check_moments(dict(ds1=ds1, gs1=gs1), arrays)
    for met, ref_met in ((dmet, want["dmet"]), (gmet, want["gmet"])):
        for k, v in ref_met.items():
            np.testing.assert_allclose(float(met[k]), v, rtol=LOSS_RTOL)


@pytest.mark.parametrize("backend", ["reverse_loop", "cudnn", "cuda"])
def test_mesh_generator_step_matches_reference_on_its_critic(
        ref, backend, monkeypatch):
    """The generator step alone, both packages' critics replaced by the
    reference critic's linearisation at its fakes (see the module doc)."""
    arrays, meta = ref
    fake, score, cgrad = (torch.from_numpy(arrays[f"lin_{k}"])
                          for k in ("fake", "score", "cgrad"))

    def linear_critic(dp, cfg, x):
        d = ((x[:, None] - fake[None]) ** 2).sum(dim=(2, 3, 4))
        dist, i = d.detach().min(dim=1)
        # every row of the port's fakes is one of the reference's
        assert float(dist.max().sqrt()) <= ROW_TOL, float(dist.max().sqrt())
        return score[i] + (cgrad[i] * (x - fake[i])).sum(dim=(1, 2, 3))

    monkeypatch.setattr(wgan_mod, "critic_apply", linear_critic)
    t = WganTrainer(TINY, _opt(), _opt(), n_critic=1, backend=backend,
                    autotune=False, mesh=make_test_mesh(4, device="cpu"))
    g = torch.Generator().manual_seed(0)
    gp = _tree(generator_init(g, TINY, "cpu"), arrays, "gp0")
    dp = _tree(critic_init(g, TINY, "cpu"), arrays, "dp1")
    gp1, gs1, gmet = t.gen_update(gp, t.g_opt.init(gp), dp,
                                  torch.from_numpy(arrays["gz"]))
    _check_params(dict(lgp1=gp1), arrays)
    _check_moments(dict(lgs1=gs1), arrays)
    for k, v in meta["train"]["lgmet"].items():
        np.testing.assert_allclose(float(gmet[k]), v, rtol=LOSS_RTOL)


@pytest.mark.parametrize("backend", ["reverse_loop", "cuda"])
def test_mesh_trainer_equals_z_shards(backend):
    class Src:
        sizes = (13, 14, 15, 16)   # ragged: all bucket to 16

        def batch(self, step):
            r = np.random.RandomState(step)
            n = self.sizes[step % len(self.sizes)]
            return {"images": r.randn(n, 16, 16, 1).astype(np.float32) * 0.2}

    tm = WganTrainer(TINY, _opt(), _opt(), n_critic=2, backend=backend,
                     autotune=False, mesh=make_test_mesh(4, device="cpu"))
    t1 = WganTrainer(TINY, _opt(), _opt(), n_critic=2, backend=backend,
                     autotune=False, z_shards=4, device="cpu")
    gm, dm, hm = tm.fit(Src(), 2, seed=1, log_every=1)
    g1, d1, h1 = t1.fit(Src(), 2, seed=1, log_every=1)
    assert hm == h1
    for a, b in zip(tree_leaves((gm, dm)), tree_leaves((g1, d1))):
        assert torch.equal(a, b)
    assert tm.build_counts == t1.build_counts
    assert tm.build_counts["critic"] == {16: 1}
    with pytest.raises(ValueError, match="z_shards"):
        WganTrainer(TINY, _opt(), _opt(), z_shards=2,
                    mesh=make_test_mesh(4, device="cpu"))


def test_train_example_runs_on_a_cpu_mesh(tmp_path):
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_wgan_mnist_torch.py"),
         "--device", "cpu", "--mesh", "2", "--steps", "1", "--batch", "4",
         "--ckpt-dir", str(tmp_path / "ck")],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh: {'data': 2, 'model': 1}" in res.stdout
    assert "final MMD" in res.stdout


# ---------------------------------------------------------------------------
# the LM rules on the DCNN mesh: every rule set gives its data axis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy,multi_pod", [("tp", False),
                                              ("fsdp_tp", False),
                                              ("tp", True)])
def test_every_rule_set_gives_the_dcnn_mesh_its_data_axis(policy, multi_pod):
    """The engine and the trainer split over ``mesh.data`` shards, which
    is ``data_axis_size`` under every rule set ``make_rules`` builds, here
    and in the reference, so the DCNN paths take no rules; the DCNN
    params' replicated specs place as ``Replicate`` under each."""
    from repro.dist.sharding import data_axis_size as jdata_axis_size
    from repro.dist.sharding import make_rules as jmake_rules
    from torch.distributed.tensor import Replicate

    from repro_torch.dist.sharding import (data_axis_size, make_rules,
                                           replicated_specs, tree_shardings)

    params = generator_init(torch.Generator().manual_seed(3), TINY, "cpu")
    mesh = make_test_mesh(4, device="cpu")
    eng = _engine(params, "reverse_loop")
    trainer = WganTrainer(TINY, _opt(), _opt(), autotune=False, mesh=mesh)
    rules = make_rules(policy, multi_pod)
    assert eng.n_devices == trainer.shards == mesh.data == data_axis_size(
        mesh, rules) == jdata_axis_size(mesh, jmake_rules(policy,
                                                          multi_pod)) == 4

    class Standin:   # the placements of the replicated specs on (4, 1)
        shape = mesh.shape
        axis_names = ("data", "model")

    pl = tree_leaves(tree_shardings(Standin(), rules, params,
                                    replicated_specs(params)))
    assert pl and all(isinstance(p, Replicate) for p in pl)
