"""Card-only checks of the mesh and the plan DRC (marker ``cuda``; they
skip without a card).  Run on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py

A 2-shard mesh on one card (`make_test_mesh(2, device="cuda:0")`): one
CUDA graph per shard and bucket, layers x shards launches per dispatch,
images equal to the single-device engine's (fp32 within 1e-5: the
per-shard plans may tile differently; int8 bit for bit); an elastic
remesh to one shard; the mesh trainer bit for bit ``z_shards=2``; the
DRC's shared memory, threads and split of every tiled layer equal to
what the launcher and the library say for the same launch; the engine's
gate refusing plans before any capture."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.check import PlanCheckError, check_network_plan
from repro_torch.analysis.check.plan_drc import launch_resources
from repro_torch.core.tree import tree_leaves
from repro_torch.dist import DeviceLoss, FaultInjector
from repro_torch.kernels.deconv2d import int8 as int8_kernel
from repro_torch.kernels.deconv2d import kernel as deconv_kernel
from repro_torch.kernels.deconv2d_sparse import kernel as sparse_kernel
from repro_torch.launch import make_test_mesh
from repro_torch.models import dcnn
from repro_torch.optim import AdamW
from repro_torch.serve import DcnnServeEngine, EngineConfig
from repro_torch.train import WganTrainer

pytestmark = pytest.mark.cuda
KERNEL_OF = {("cuda", "fp32"): deconv_kernel, ("cuda", "int8"): int8_kernel,
             ("cuda_sparse", "fp32"): sparse_kernel}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture
def mnist(card):
    return dcnn.generator_init(torch.Generator().manual_seed(0),
                               dcnn.MNIST_DCNN, card)


def _engines(params, precision, **kw):
    single = DcnnServeEngine.from_config(EngineConfig(
        model="mnist", buckets=(8,), precision=precision, **kw), params)
    mesh = DcnnServeEngine.from_config(EngineConfig(
        model="mnist", buckets=(8,), precision=precision,
        quant_cfg=single.quant_cfg, mesh=make_test_mesh(2, device="cuda:0"),
        **kw), params)
    return single, mesh


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_two_shards_on_one_card_equal_one_engine(mnist, precision):
    single, mesh = _engines(mnist, precision)
    z = np.random.RandomState(0).randn(21, 100).astype(np.float32)
    want = single.generate(z)
    mod = KERNEL_OF["cuda", precision]
    got = mesh.generate(z)
    if precision == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert mesh.capture_counts == {8: 1}
    assert [s.bucket for s in mesh._fns[8].shards] == [4, 4]
    assert all(s.graph is not None for s in mesh._fns[8].shards)
    dispatches = len(mesh.plan_chunks(21))
    assert mesh.launch_counts == {8: 3 * 2 * dispatches}
    before = mod.LAUNCHES
    mesh.generate(z)      # replays: the wrapper launches nothing
    assert mod.LAUNCHES == before
    for plan in mesh.plans.values():
        assert plan.batch == 4
        assert check_network_plan(plan, n_devices=2,
                                  buckets=mesh.buckets).ok(strict=True)


def test_elastic_remesh_to_one_shard_on_the_card(mnist):
    inj = FaultInjector()
    single, _ = _engines(mnist, "fp32")
    mesh = DcnnServeEngine.from_config(EngineConfig(
        model="mnist", buckets=(1, 8), mesh=make_test_mesh(2, device="cuda:0")),
        mnist, fault_injector=inj)
    assert mesh.buckets == (2, 8)
    z = np.random.RandomState(1).randn(8, 100).astype(np.float32)
    before = mesh.generate(z)
    inj.schedule(DeviceLoss(at_call=inj.calls, keep=1))
    after = mesh.generate(z)
    ev, = mesh.fault_stats["remesh_events"]
    assert (ev["devices_before"], ev["devices_after"]) == (2, 1)
    assert mesh.buckets == (1, 8) and ev["buckets"] == [1, 8]
    np.testing.assert_allclose(after, before, rtol=0, atol=1e-5)
    np.testing.assert_allclose(after, single.generate(z), rtol=0, atol=1e-5)


def test_mesh_trainer_equals_z_shards_on_the_card(card):
    """Within rounding, not bit for bit: the reverse loop's backward on
    the card need not sum in the same order twice (1.5e-7 on the losses,
    5.6e-8 on Adam's moments in `chip_smoke.py`'s MNIST run)."""
    cfg = dcnn.MNIST_DCNN
    real = np.random.RandomState(2).uniform(-1, 1, (16, 28, 28, 1)).astype(
        np.float32)

    def run(**kw):
        t = WganTrainer(cfg, AdamW(lr=1e-4, b1=0.5, b2=0.9),
                        AdamW(lr=1e-4, b1=0.5, b2=0.9), n_critic=1,
                        backend="cuda", **kw)
        gp, dp, gs, ds = t.init_state(0)
        dp, ds, dm = t.critic_step(dp, ds, gp, real, (0, 0, 0))
        gp, gs, gm = t.gen_step(gp, gs, dp, (0, 0, 1), 16)
        return tree_leaves((gp, dp, gs, ds)), dm, gm

    a, b = run(mesh=make_test_mesh(2, device="cuda:0")), run(z_shards=2,
                                                              device="cuda")
    for x, y in zip(a[0], b[0]):
        err = float((x.double() - y.double()).norm())
        assert err <= 1e-5 * max(float(y.double().norm()), 1e-30)
    for m, n in ((a[1], b[1]), (a[2], b[2])):
        for k in n:
            np.testing.assert_allclose(float(m[k]), float(n[k]), rtol=1e-5)


@pytest.mark.parametrize("backend, precision, dtype", [
    ("cuda", "fp32", "float32"), ("cuda", "int8", "float32"),
    ("cuda_sparse", "fp32", "float32"), ("cuda", "fp32", "bfloat16")])
def test_drc_launch_resources_equal_the_library(card, backend, precision,
                                                dtype, monkeypatch):
    cfg = dataclasses.replace(dcnn.CELEBA_DCNN, dtype=dtype)
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    eng = DcnnServeEngine.from_config(EngineConfig(
        model=cfg, backend=backend, precision=precision, buckets=(1, 64)),
        params)
    seen = []
    real = deconv_kernel._tc_launch_params

    def record(*args):
        out = real(*args)
        seen.append(out)
        return out

    monkeypatch.setattr(deconv_kernel, "_tc_launch_params", record)
    for b in eng.buckets:
        plan = eng._plan_for(b)
        seen.clear()
        with torch.no_grad():
            eng._apply(b, plan, torch.zeros((b, 100), device=card))
        assert len(seen) == len(plan.layers)
        for layer, params_ in zip(plan.layers, seen):
            assert launch_resources(layer) == \
                deconv_kernel.launch_report(params_)


def test_engine_gate_refuses_before_any_capture(mnist, monkeypatch):
    eng = DcnnServeEngine.from_config(EngineConfig(model="mnist",
                                                   buckets=(8,)), mnist)
    plan = eng._plan_for(8)
    l = plan.layers[1]
    bad = dataclasses.replace(plan, layers=plan.layers[:1] + (
        dataclasses.replace(l, tiles=dataclasses.replace(
            l.tiles, t_oh=512, t_ow=512, t_ci=2048, t_co=2048)),)
        + plan.layers[2:])
    pallas = dataclasses.replace(plan, backend="pallas", layers=tuple(
        dataclasses.replace(x, backend="pallas") for x in plan.layers))
    built = []
    monkeypatch.setattr(DcnnServeEngine, "_build_shard",
                        lambda *a: built.append(a))
    for p, rule in ((bad, "drc.smem_budget"), (pallas, "drc.backend")):
        with pytest.raises(PlanCheckError) as ei:
            DcnnServeEngine.from_config(EngineConfig(
                model="mnist", buckets=(8,), warmup=True), mnist, plan=p)
        assert rule in {v.rule_id for v in ei.value.violations}
    assert built == []


def test_mesh_results_within_and_past_the_pinned_budget(mnist, monkeypatch):
    """The shards' images gather into one pinned result while the budget
    allows, else into their staging buffers and a host concatenation;
    either way a kept result never changes after later dispatches."""
    from repro_torch.serve import engine as engine_mod

    single, mesh = _engines(mnist, "fp32")
    block = 1 << (8 * 28 * 28 * 4 - 1).bit_length()
    budget = engine_mod._PinnedBudget(block)
    monkeypatch.setattr(engine_mod, "PINNED_RESULTS", budget)
    rng = np.random.RandomState(3)
    zs = [rng.randn(7, 100).astype(np.float32) for _ in range(3)]
    kept = [mesh.generate(z) for z in zs[:2]]
    assert budget.held == block            # the first one is pinned
    want = [k.copy() for k in kept]
    mesh.generate(zs[2])
    for k, w, z in zip(kept, want, zs):
        np.testing.assert_array_equal(k, w)
        np.testing.assert_allclose(k, single.generate(z), rtol=0, atol=1e-5)
    del kept, k
    import gc
    gc.collect()
    assert budget.held == 0
