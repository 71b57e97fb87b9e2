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
        EngineConfig(model="mnist", precision="int8", device="cpu")
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
