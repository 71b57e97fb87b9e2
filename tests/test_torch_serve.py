"""The port's serving engine against the JAX package's engine and
generator, on the CPU (``device="cpu"``; the "cuda" backend then runs the
kernel's plain version)."""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.models import dcnn as jdcnn
from repro.serve import DcnnServeEngine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve.engine import pow2_buckets as j_pow2_buckets
from repro_torch.models import dcnn
from repro_torch.serve import (AdmissionRejected, DcnnServeEngine,
                               DeadlineExceeded, EngineConfig, pow2_buckets)
from repro_torch.workloads import UnknownWorkloadError

TOL = 1e-4  # fp32, the same products summed in another order


@pytest.fixture(scope="module")
def mnist():
    p, _ = jdcnn.generator_init(jax.random.PRNGKey(0), jdcnn.MNIST_DCNN)
    pn = jax.tree_util.tree_map(np.asarray, p)
    return p, pn, dcnn.generator_params_from_numpy(pn, dcnn.MNIST_DCNN, "cpu")


def _engine(params, **kw):
    return DcnnServeEngine.from_config(
        EngineConfig(model="mnist", device="cpu", **kw), params)


def test_pow2_buckets_match_reference():
    for m in range(1, 131):
        assert pow2_buckets(m) == j_pow2_buckets(m)
    with pytest.raises(ValueError):
        pow2_buckets(0)


@pytest.mark.parametrize("max_batch,overhead", [(64, 8), (64, 0), (48, 32),
                                                (5, 8)])
def test_plan_chunks_match_reference(mnist, max_batch, overhead):
    p, _, tp = mnist
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JEngine.from_config(JEngineConfig(
            model=jdcnn.MNIST_DCNN, backend="reverse_loop",
            max_batch=max_batch, call_overhead_rows=overhead), p)
    eng = _engine(tp, max_batch=max_batch, call_overhead_rows=overhead)
    assert eng.buckets == ref.buckets
    for n in range(0, 131):
        assert eng.plan_chunks(n) == ref.plan_chunks(n), n
        assert eng.bucket_for(n) == ref.bucket_for(n)


@pytest.mark.parametrize("backend", ["cuda", "reverse_loop", "cudnn"])
def test_submit_collect_matches_reference_generator(mnist, backend):
    """Mixed sizes through buckets 1..4: chunking (9 rows) and padding
    (3 rows into bucket 4) both run."""
    p, _, tp = mnist
    eng = _engine(tp, backend=backend, max_batch=4)
    rng = np.random.RandomState(2)
    reqs = [rng.randn(n, 100).astype(np.float32) for n in (3, 1, 5)]
    tickets = [eng.submit(z) for z in reqs]
    outs = [eng.collect(t) for t in tickets]
    want = np.asarray(jdcnn.generator_apply(p, jdcnn.MNIST_DCNN,
                                            np.concatenate(reqs),
                                            backend="reverse_loop"))
    np.testing.assert_allclose(np.concatenate(outs), want, rtol=TOL, atol=TOL)
    assert [o.shape[0] for o in outs] == [3, 1, 5]
    assert eng.stats["images"] == 9
    assert eng.stats["padded_images"] == sum(b - t for t, b in
                                             eng.plan_chunks(9))
    # plain version on the CPU: no kernel launch is counted
    assert sum(eng.launch_counts.values()) == 0
    assert eng.plan_stats["builds"] == len(eng.plans)


def test_warmup_plans_every_bucket_and_times_steady_calls(mnist):
    _, _, tp = mnist
    eng = _engine(tp, max_batch=4, warmup=True)
    assert sorted(eng.plans) == [1, 2, 4]
    assert eng.plans[4].layers[0].tiles is not None
    z = np.zeros((4, 100), np.float32)
    for _ in range(3):
        eng.generate(z)
    tp4 = eng.throughput()[4]
    assert tp4["calls"] == 3 and tp4["img_per_s"] > 0 and tp4["cv"] >= 0
    assert eng.service_estimate(4) == pytest.approx(tp4["mean_s"])
    assert eng.generate(np.zeros((0, 100), np.float32)).shape == (0, 28, 28, 1)


def test_typed_errors(mnist):
    _, _, tp = mnist
    eng = _engine(tp, max_batch=2)
    with pytest.raises(KeyError, match="never issued"):
        eng.collect(7)
    t = eng.submit(np.zeros((100,), np.float32))
    assert eng.collect(t).shape == (1, 28, 28, 1)
    with pytest.raises(KeyError, match="already collected"):
        eng.collect(t)
    late = eng.submit(np.zeros((1, 100), np.float32), deadline_s=-1.0)
    ok = eng.submit(np.zeros((2, 100), np.float32))
    with pytest.raises(DeadlineExceeded):
        eng.collect(late)
    assert eng.collect(ok).shape == (2, 28, 28, 1)
    assert eng.fault_stats["deadline_expired"] == 1
    shed = eng.submit(np.zeros((1, 100), np.float32))
    assert eng.shed(shed) and not eng.shed(shed)
    with pytest.raises(AdmissionRejected):
        eng.collect(shed)


def test_config_rejects_what_this_slice_does_not_serve(mnist):
    _, _, tp = mnist
    with pytest.raises(UnknownWorkloadError, match="registered workloads"):
        DcnnServeEngine.from_config(EngineConfig(model="mnits", device="cpu"),
                                    tp)
    with pytest.raises(ValueError, match="precision"):
        EngineConfig(model="mnist", precision="fp16", device="cpu")
    with pytest.raises(ValueError, match="no quantized variant"):
        EngineConfig(model="mnist", precision="int8", backend="cudnn",
                     device="cpu")
    with pytest.raises(ValueError, match="no quantized variant"):
        EngineConfig(model="mnist", precision="int8", backend="cuda_sparse",
                     device="cpu")
    with pytest.raises(ValueError, match="backend"):
        EngineConfig(model="mnist", backend="pallas", device="cpu")


def test_default_device_is_the_card_and_never_falls_back(mnist):
    """EngineConfig's default device is "cuda": without a card the engine
    raises instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    _, _, tp = mnist
    cfg = EngineConfig(model="mnist")
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DcnnServeEngine.from_config(cfg, tp)


def test_engine_serves_a_reference_pinned_plan(mnist):
    """A plan pinned by the JAX package, re-tiled for the card, seeds its
    bucket; a plan for another backend is refused."""
    from repro.plan import build_network_plan as j_build_network_plan
    from repro_torch.plan import NetworkPlan

    p, _, tp = mnist
    ref = j_build_network_plan(jdcnn.MNIST_DCNN, batch=4, backend="pallas",
                               autotune=False)
    plan = NetworkPlan.from_json(ref.to_json()).for_hopper()
    eng = DcnnServeEngine.from_config(
        EngineConfig(model="mnist", device="cpu", max_batch=4), tp, plan=plan)
    assert eng.plans[4] is plan
    z = np.random.RandomState(3).randn(4, 100).astype(np.float32)
    want = np.asarray(jdcnn.generator_apply(p, jdcnn.MNIST_DCNN, z,
                                            backend="reverse_loop"))
    np.testing.assert_allclose(eng.generate(z), want, rtol=TOL, atol=TOL)
    assert eng.plan_stats["builds"] == 0
    with pytest.raises(ValueError, match="backend"):
        DcnnServeEngine.from_config(
            EngineConfig(model="mnist", device="cpu", backend="cudnn",
                         max_batch=4), tp, plan=plan)


# -- int8 and zero-skip engines ---------------------------------------------
def _reqs(seed=6):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, 100).astype(np.float32) for n in (3, 1, 5)]


def test_int8_engine_matches_reference_chain(mnist):
    """Given the reference's calibration, the int8 engine's images equal the
    JAX package's int8 oracle chain within 1e-5 (see test_torch_quant)."""
    import dataclasses

    from repro.quant import calibrate as j_calibrate
    from repro.quant import quantize_params as j_quantize_params
    from repro.quant import quantized_generator_ref as j_chain_ref
    from repro_torch.quant import QuantConfig

    p, _, tp = mnist
    reqs = _reqs()
    z = np.concatenate(reqs)
    jq = j_calibrate(p, jdcnn.MNIST_DCNN, z)
    want = np.asarray(j_chain_ref(j_quantize_params(p, jdcnn.MNIST_DCNN, jq),
                                  jdcnn.MNIST_DCNN, jq, z))
    eng = _engine(tp, precision="int8", max_batch=4,
                  quant_cfg=QuantConfig.from_dict(dataclasses.asdict(jq)))
    outs = [eng.collect(t) for t in [eng.submit(r) for r in reqs]]
    np.testing.assert_allclose(np.concatenate(outs), want, rtol=0, atol=1e-5)
    assert eng.params["l0"]["w_q"].dtype == torch.int8
    assert all(pl.precision == "int8" for pl in eng.plans.values())
    assert sum(eng.launch_counts.values()) == 0   # plain version on the CPU


def test_int8_engine_self_calibrates_on_its_calibration_input(mnist):
    from repro_torch.quant import (calibrate, quantize_params,
                                   quantized_generator_ref)
    from repro_torch.workloads import calibration_input

    _, _, tp = mnist
    eng = _engine(tp, precision="int8", max_batch=4, calib_batch=16,
                  calib_seed=3, calib_strategy="percentile")
    want_q = calibrate(tp, dcnn.MNIST_DCNN, calibration_input(
        dcnn.MNIST_DCNN, seed=3, batch=16), strategy="percentile")
    assert eng.quant_cfg == want_q
    z = _reqs()[2]
    want = quantized_generator_ref(quantize_params(tp, dcnn.MNIST_DCNN,
                                                   want_q),
                                   dcnn.MNIST_DCNN, want_q, torch.from_numpy(z))
    np.testing.assert_array_equal(eng.generate(z), want.numpy())


def test_int8_engine_serves_a_pinned_plan_and_refuses_a_conflict(mnist):
    from repro.plan import build_network_plan as j_build_network_plan
    from repro_torch.plan import NetworkPlan
    from repro_torch.quant import QuantConfig

    p, _, tp = mnist
    ref = j_build_network_plan(jdcnn.MNIST_DCNN, batch=4, backend="pallas",
                               precision="int8", params=p, autotune=False)
    plan = NetworkPlan.from_json(ref.to_json()).for_hopper()
    eng = DcnnServeEngine.from_config(EngineConfig(
        model="mnist", device="cpu", precision="int8", max_batch=4), tp,
        plan=plan)
    assert eng.quant_cfg == plan.quant_config() and eng.plans[4] is plan
    assert eng.generate(_reqs()[2][:4]).shape == (4, 28, 28, 1)
    other = QuantConfig.from_dict({**plan.quant_config().to_dict(),
                                   "strategy": "minmax"})
    with pytest.raises(ValueError, match="different calibrations"):
        DcnnServeEngine.from_config(EngineConfig(
            model="mnist", device="cpu", precision="int8", max_batch=4,
            quant_cfg=other), tp, plan=plan)


@pytest.fixture(scope="module")
def pruned(mnist):
    from repro.core.sparsity import prune_tree as j_prune_tree

    p, _, _ = mnist
    pp = j_prune_tree(p, 0.9)
    pn = jax.tree_util.tree_map(np.asarray, pp)
    return pp, dcnn.generator_params_from_numpy(pn, dcnn.MNIST_DCNN, "cpu")


def test_sparse_engine_matches_reference_generator(pruned, monkeypatch):
    """cuda_sparse against the JAX reverse loop on the same pruned params;
    the schedules go to the engine's device once per bucket plan."""
    from repro_torch.kernels import deconv2d_sparse

    pp, tpp = pruned
    copies = []
    real = deconv2d_sparse.schedule_tensors
    monkeypatch.setattr(deconv2d_sparse, "schedule_tensors",
                        lambda t, d: copies.append(1) or real(t, d))
    eng = _engine(tpp, backend="cuda_sparse", max_batch=4)
    reqs = _reqs()
    for _ in range(2):
        outs = [eng.collect(t) for t in [eng.submit(r) for r in reqs]]
    want = np.asarray(jdcnn.generator_apply(pp, jdcnn.MNIST_DCNN,
                                            np.concatenate(reqs),
                                            backend="reverse_loop"))
    np.testing.assert_allclose(np.concatenate(outs), want, rtol=TOL, atol=TOL)
    buckets = {b for _, b in eng.plan_chunks(9)}
    assert len(copies) == len(buckets) * 3
    assert all(pl.sparse_plans() is not None for pl in eng.plans.values())


def test_sparse_engine_refuses_a_stale_pinned_plan(pruned, mnist):
    from repro_torch.plan import build_network_plan

    _, tpp = pruned
    _, _, tp = mnist
    plan = build_network_plan(dcnn.MNIST_DCNN, batch=4, backend="cuda_sparse",
                              params=tpp)
    eng = DcnnServeEngine.from_config(EngineConfig(
        model="mnist", device="cpu", backend="cuda_sparse", max_batch=4), tpp,
        plan=plan)
    assert eng.plans[4] is plan
    with pytest.raises(ValueError, match="stale"):
        DcnnServeEngine.from_config(EngineConfig(
            model="mnist", device="cpu", backend="cuda_sparse", max_batch=4),
            tp, plan=plan)
