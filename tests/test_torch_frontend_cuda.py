"""Card-only checks of the async frontend over graph engines (marker
``cuda``; they skip without a card).  Run on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_frontend_cuda.py

A retried dispatch replays the same captured graph (images bit-identical
to an unretried dispatch, no new capture); the frontend's worker thread
replays what the main thread replays, bit for bit; `prime()` captures
every bucket x precision before `start()`."""
import numpy as np
import pytest
import torch

from repro_torch.dist import FaultInjector, TransientFailure
from repro_torch.models import dcnn
from repro_torch.serve import (AsyncServeFrontend, DcnnServeEngine,
                               EngineConfig, TenantClass)

pytestmark = pytest.mark.cuda
WAIT_S = 120


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture
def mnist(card):
    return dcnn.generator_init(torch.Generator().manual_seed(0),
                               dcnn.MNIST_DCNN, card)


def test_retry_replays_the_same_graph(mnist):
    inj = FaultInjector()
    eng = DcnnServeEngine.from_config(
        EngineConfig(model="mnist", buckets=(4, 8), warmup=True,
                     retry_backoff_s=0.01), mnist, fault_injector=inj)
    z = np.random.RandomState(0).randn(8, 100).astype(np.float32)
    want = eng.generate(z)
    captures = dict(eng.capture_counts)
    inj.schedule(TransientFailure(at_call=inj.calls))
    got = eng.generate(z)
    np.testing.assert_array_equal(got, want)
    assert eng.fault_stats["retries"] == 1
    assert eng.capture_counts == captures == {4: 1, 8: 1}
    assert eng.throughput()[8]["tainted_calls"] == 1
    eng.close()


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_worker_thread_replays_equal_main_thread(mnist, precision):
    engines = {p: DcnnServeEngine.from_config(
        EngineConfig(model="mnist", buckets=(4, 8), precision=p), mnist)
        for p in ("fp32", precision)}
    eng = engines[precision]
    fe = AsyncServeFrontend(engines, [TenantClass("default")], start=False)
    try:
        fe.prime(reps=1)
        rng = np.random.RandomState(1)
        zs = [rng.randn(n, 100).astype(np.float32) for n in (8, 4, 3, 8)]
        want = [eng.generate(z) for z in zs]          # main thread
        if precision == "int8":
            for b in eng.buckets:     # fp32 can never make the SLO
                fe._model.override("fp32", b, 60.0)
                fe._model.override("int8", b, 1e-4)
        fe.start()
        for z, w in zip(zs, want):    # one wave per request
            rid = fe.submit(z, "default",
                            slo_ms=1e4 if precision == "int8" else None)
            np.testing.assert_array_equal(fe.result(rid, timeout_s=WAIT_S),
                                          w)
        assert fe.stats()["tenants"]["default"]["downgraded"] == (
            len(zs) if precision == "int8" else 0)
        assert eng.capture_counts == {4: 1, 8: 1}
    finally:
        fe.close(timeout_s=WAIT_S)


def test_prime_captures_every_bucket_precision_before_start(mnist):
    fe = AsyncServeFrontend.from_config(
        EngineConfig(model="mnist", buckets=(1, 2, 4)), mnist,
        [TenantClass("default")], prime=1)
    try:
        for eng in fe._engines.values():
            assert eng.capture_counts == {1: 1, 2: 1, 4: 1}
            assert all(ex.graph is not None for ex in eng._fns.values())
        z = np.random.RandomState(2).randn(3, 100).astype(np.float32)
        fe.result(fe.submit(z, "default"), timeout_s=WAIT_S)
        for eng in fe._engines.values():
            assert eng.capture_counts == {1: 1, 2: 1, 4: 1}
    finally:
        fe.close(timeout_s=WAIT_S)
