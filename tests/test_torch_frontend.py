"""The port's SLO frontend (`repro_torch.serve.frontend`, `scheduler`,
`admission`) against the JAX package's: the same scripted service-model
updates, EDF orders, precision choices and admission decisions are equal
in both packages; a port frontend and a reference frontend (reverse loop,
fp32, tenants without SLOs, so no decision depends on timing) give the
same requests images within 1e-5; and the port's counterparts of the
reference's single-device frontend tests on port engines on the CPU
(``device="cpu"``; int8 through its plain chain), the 2x overload among
them.  Every wait on the worker is bounded and every frontend closed.

The serving example `examples/serve_dcnn_torch.py` is driven here too,
sync and ``--async``, on MNIST on the CPU."""
import importlib.util
import pathlib
import time
import types
import warnings

import numpy as np
import pytest

from repro.plan import variant_fingerprints as j_variant_fingerprints
from repro.serve import AdmissionController as JAdmission
from repro.serve import AdmissionRejected as JAdmissionRejected
from repro.serve import AsyncServeFrontend as JFrontend
from repro.serve import EdfScheduler as JEdf
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServiceModel as JServiceModel
from repro.serve import TenantClass as JTenant
from repro_torch.dist import DeviceLoss, FaultInjector, TransientFailure
from repro_torch.plan import variant_fingerprints
from repro_torch.serve import (AdmissionController, AdmissionRejected,
                               AsyncServeFrontend, DcnnServeEngine,
                               EdfScheduler, EngineConfig, EngineDegraded,
                               ServiceModel, TenantClass)
from test_torch_fault import J_TINY, TINY, TOL, WAIT_S, tiny_setup  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _engines(params, precisions=("fp32",), buckets=(2, 4), injector=None,
             **cfg_over):
    return {p: DcnnServeEngine.from_config(
        EngineConfig(model=TINY, device="cpu", buckets=buckets, precision=p,
                     **cfg_over),
        params, fault_injector=(injector if p == "fp32" else None))
        for p in precisions}


def _req(rid=0, priority=1, deadline=None, rows=1, allow_degrade=True,
         tenant_cls=TenantClass):
    return types.SimpleNamespace(
        rid=rid, rows=rows, deadline=deadline,
        tenant=tenant_cls("t", priority=priority,
                          allow_degrade=allow_degrade))


# ---------------------------------------------------------------------------
# the same scripts through both packages (no engine, no threads)
# ---------------------------------------------------------------------------
def _model_script(cls, seed):
    rng = np.random.RandomState(seed)
    m = cls(decay=0.6)
    for _ in range(60):
        p, b = ("fp32", "int8")[rng.randint(2)], int(2 ** rng.randint(5))
        op = rng.randint(10)
        if op < 7:
            m.observe(p, b, float(rng.gamma(2.0, 0.001 * b)))
        elif op < 9:
            m.override(p, b, float(rng.rand()))
        else:
            m.scale(float(1 + rng.rand()))
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_service_model_equals_reference(seed):
    port, ref = _model_script(ServiceModel, seed), \
        _model_script(JServiceModel, seed)
    assert port.snapshot() == ref.snapshot()
    buckets = (1, 2, 4, 8, 16)
    for p in ("fp32", "int8", "bf16"):
        assert port.row_seconds(p) == ref.row_seconds(p)
        for rows in (0, 1, 3, 5, 16, 17, 40):
            assert (port.service_seconds(p, rows, buckets)
                    == ref.service_seconds(p, rows, buckets))
            assert (port.service_seconds(p, rows, (2, 4))
                    == ref.service_seconds(p, rows, (2, 4)))


def _requests(tenant_cls, seed, now):
    rng = np.random.RandomState(seed)
    out = []
    for rid in range(30):
        dl = None if rng.rand() < 0.2 else now + float(rng.rand() * 0.05)
        out.append(_req(rid=int(rng.permutation(100)[0]) * 100 + rid,
                        priority=int(rng.randint(3)), deadline=dl,
                        rows=int(rng.randint(1, 9)),
                        allow_degrade=bool(rng.rand() < 0.7),
                        tenant_cls=tenant_cls))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_and_admission_equal_reference(seed):
    """EDF order, the precision each request gets at a pinned ``now`` and
    backlog, and each admission decision (precision, or the rejection's
    stage and message) are equal in both packages."""
    now = 1000.0
    models = []
    for cls in (ServiceModel, JServiceModel):
        m = cls()
        for p, rate in (("fp32", 0.004), ("int8", 0.0015)):
            for b in (1, 2, 4, 8):
                m.override(p, b, rate * b + 0.001)
        models.append(m)
    port_s = EdfScheduler(models[0], (1, 2, 4, 8), ("fp32", "int8"))
    ref_s = JEdf(models[1], (1, 2, 4, 8), ("fp32", "int8"))
    preqs, rreqs = _requests(TenantClass, seed, now), \
        _requests(JTenant, seed, now)
    assert ([r.rid for r in EdfScheduler.order(preqs)]
            == [r.rid for r in JEdf.order(rreqs)])
    pa, ra = AdmissionController(port_s, 24), JAdmission(ref_s, 24)
    for backlog in (0.0, 0.005, 0.02):
        for pr, rr in zip(preqs, rreqs):
            assert (port_s.feasible_precision(pr, now, backlog)
                    == ref_s.feasible_precision(rr, now, backlog))
            for queued in (0, 12, 20):
                outs = []
                for ctl, req, exc in ((pa, pr, AdmissionRejected),
                                      (ra, rr, JAdmissionRejected)):
                    try:
                        outs.append(ctl.admit(req, queued, backlog, now))
                    except exc as e:
                        outs.append((e.stage, str(e)))
                assert outs[0] == outs[1]


def test_tenant_class_equals_reference():
    for kw in ({}, {"slo_ms": 50.0, "priority": 0},
               {"slo_ms": None, "allow_degrade": False}):
        port, ref = TenantClass("t", **kw), JTenant("t", **kw)
        assert [getattr(port, f) for f in ("name", "slo_ms", "priority",
                                           "allow_degrade")] == \
            [getattr(ref, f) for f in ("name", "slo_ms", "priority",
                                       "allow_degrade")]
    for cls in (TenantClass, JTenant):
        with pytest.raises(ValueError, match="slo_ms must be positive"):
            cls("bad", slo_ms=0.0)


def test_variant_fingerprints_equal_reference():
    def plan(batch, precision, h):
        return types.SimpleNamespace(batch=batch, precision=precision,
                                     stable_hash=lambda: h)

    plans = [plan(4, "fp32", "aaa"), plan(4, "int8", "bbb"),
             plan(2, "fp32", "ccc"), plan(4, "fp32", "aaa")]
    assert variant_fingerprints(plans) == j_variant_fingerprints(plans) == {
        "b4/fp32": "aaa", "b4/int8": "bbb", "b2/fp32": "ccc"}
    with pytest.raises(ValueError, match="b4/fp32 disagree"):
        variant_fingerprints([plan(4, "fp32", "aaa"),
                              plan(4, "fp32", "ccc")])


# ---------------------------------------------------------------------------
# scheduler / admission units
# ---------------------------------------------------------------------------
def test_service_model_estimates_and_scaling():
    m = ServiceModel(decay=0.5)
    assert m.estimate("fp32", 4) is None
    m.observe("fp32", 4, 1.0)
    assert m.estimate("fp32", 4) == 1.0
    m.observe("fp32", 4, 2.0)
    assert m.estimate("fp32", 4) == pytest.approx(1.5)
    m.override("fp32", 4, 0.4)
    assert m.estimate("fp32", 4) == 0.4
    m.scale(2.0)
    assert m.estimate("fp32", 4) == pytest.approx(0.8)
    assert m.snapshot() == {"fp32/b4": pytest.approx(0.8)}


def test_edf_order_priority_then_deadline_then_arrival():
    a = _req(rid=0, priority=1, deadline=9.0)
    b = _req(rid=1, priority=0, deadline=99.0)
    c = _req(rid=2, priority=1, deadline=1.0)
    d = _req(rid=3, priority=1, deadline=None)
    assert EdfScheduler.order([a, b, c, d]) == [b, c, a, d]


def test_feasible_precision_degrades_then_sheds():
    m = ServiceModel()
    m.override("fp32", 4, 10.0)
    m.override("int8", 4, 0.01)
    s = EdfScheduler(m, (4,), ("fp32", "int8"), safety=1.2)
    now = 100.0
    assert s.feasible_precision(_req(deadline=now + 0.5, rows=4),
                                now) == "int8"
    slow = _req(deadline=now + 60.0, rows=4)
    assert s.feasible_precision(slow, now) == "fp32"
    assert s.feasible_precision(_req(deadline=now + 0.5, rows=4,
                                     allow_degrade=False), now) is None
    assert s.feasible_precision(_req(deadline=None, rows=4), now) == "fp32"
    assert s.feasible_precision(slow, now, backlog_s=100.0) is None
    with pytest.raises(ValueError, match="lead with 'fp32'"):
        EdfScheduler(m, (4,), ("int8", "fp32"))


def test_admission_controller_typed_stages():
    m = ServiceModel()
    m.override("fp32", 4, 10.0)
    ctrl = AdmissionController(EdfScheduler(m, (4,), ("fp32",)),
                               max_queue_rows=8)
    now = 100.0
    with pytest.raises(AdmissionRejected, match="queue full") as ei:
        ctrl.admit(_req(rows=4), queued_rows=6, backlog_s=0.0, now=now)
    assert ei.value.stage == "queue_full"
    with pytest.raises(AdmissionRejected, match="cannot meet its SLO") as ei:
        ctrl.admit(_req(rows=4, deadline=now + 0.1), 0, 0.0, now)
    assert ei.value.stage == "predicted_slo"
    assert ctrl.admit(_req(rows=4, deadline=now + 60.0), 0, 0.0,
                      now) == "fp32"
    with pytest.raises(ValueError):
        AdmissionController(EdfScheduler(m, (4,), ("fp32",)), 0)


# ---------------------------------------------------------------------------
# port frontend against the reference frontend
# ---------------------------------------------------------------------------
def test_frontend_images_equal_reference_frontend(tiny_setup):
    """The same requests through a port frontend and a reference frontend
    (reverse loop, fp32, no SLOs): images within 1e-5, the same counters
    and the same ``stats()`` keys."""
    params, _, _, jp = tiny_setup
    rng = np.random.RandomState(11)
    reqs = [(rng.randn(n, TINY.z_dim).astype(np.float32),
             "gold" if i % 2 else "std")
            for i, n in enumerate((1, 3, 4, 2, 6, 5, 1, 4))]
    tenants = {"port": [TenantClass("gold", priority=0),
                        TenantClass("std", priority=1)],
               "ref": [JTenant("gold", priority=0),
                       JTenant("std", priority=1)]}
    fe = AsyncServeFrontend.from_config(
        EngineConfig(model=TINY, backend="reverse_loop", device="cpu",
                     buckets=(2, 4)), params, tenants["port"],
        precisions=("fp32",))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfe = JFrontend.from_config(
            JEngineConfig(model=J_TINY, backend="reverse_loop",
                          buckets=(2, 4)), jp, tenants["ref"],
            precisions=("fp32",))
    try:
        outs = {}
        for name, f in (("port", fe), ("ref", jfe)):
            rids = [f.submit(z, t) for z, t in reqs]
            outs[name] = [f.result(r, timeout_s=WAIT_S) for r in rids]
        for (z, _), a, b in zip(reqs, outs["port"], outs["ref"]):
            assert a.shape == b.shape == (len(z), 16, 16, 1)
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        st, jst = fe.stats(), jfe.stats()
        assert set(st) == set(jst)
        for t in ("gold", "std"):
            assert set(st["tenants"][t]) == set(jst["tenants"][t])
            for k in ("admitted", "completed", "downgraded", "shed"):
                assert st["tenants"][t][k] == jst["tenants"][t][k]
    finally:
        fe.close(timeout_s=WAIT_S)
        jfe.close(timeout_s=WAIT_S)


# ---------------------------------------------------------------------------
# port frontend end to end (single device, CPU)
# ---------------------------------------------------------------------------
def test_frontend_parity_with_direct_engine(tiny_setup):
    params, z, ref, _ = tiny_setup
    fe = AsyncServeFrontend(_engines(params),
                            [TenantClass("default", slo_ms=None)])
    try:
        direct = _engines(params)["fp32"]
        rid = fe.submit(z, "default")
        got = fe.result(rid, timeout_s=WAIT_S)
        np.testing.assert_array_equal(got, direct.generate(z))
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
        st = fe.stats()["tenants"]["default"]
        assert st["completed"] == 1 and st["shed"] == 0
        assert st["downgraded"] == 0
    finally:
        fe.close(timeout_s=WAIT_S)


def test_downgrade_serves_int8_chain(tiny_setup):
    """When fp32 cannot make the SLO a degrade-tolerant tenant is served by
    the int8 engine: bit-identical to that engine run directly, tagged
    ``downgraded``."""
    params, z, _, _ = tiny_setup
    fe = AsyncServeFrontend(
        _engines(params, ("fp32", "int8")),
        [TenantClass("gold", slo_ms=500.0, priority=0)], start=False)
    try:
        for b in (2, 4):
            fe._model.override("fp32", b, 30.0)
            fe._model.override("int8", b, 1e-4)
        expect = _engines(params, ("int8",))["int8"].generate(z)
        fe.start()
        rid = fe.submit(z, "gold")
        np.testing.assert_array_equal(fe.result(rid, timeout_s=WAIT_S),
                                      expect)
        st = fe.stats()["tenants"]["gold"]
        assert st["completed"] == 1 and st["downgraded"] == 1
        assert "b4/int8" in fe.plan_fingerprints()
        lat = fe.metrics.histogram("frontend.request_latency_seconds")
        assert lat.summary(tenant="gold", precision="int8")["count"] == 1
    finally:
        fe.close(timeout_s=WAIT_S)


def test_admission_rejects_unmeetable_slo_typed(tiny_setup):
    params, z, _, _ = tiny_setup
    fe = AsyncServeFrontend(
        _engines(params),
        [TenantClass("strict", slo_ms=50.0, allow_degrade=False)],
        start=False)
    try:
        fe._model.override("fp32", 2, 30.0)
        fe._model.override("fp32", 4, 30.0)
        with pytest.raises(AdmissionRejected, match="cannot meet") as ei:
            fe.submit(z, "strict")
        assert ei.value.stage == "predicted_slo"
        st = fe.stats()["tenants"]["strict"]
        assert st["shed_admission"] == 1 and st["admitted"] == 0
    finally:
        fe.close(drain=False, timeout_s=WAIT_S)


def test_backpressure_bounded_queue_rejects(tiny_setup):
    params, z, ref, _ = tiny_setup
    fe = AsyncServeFrontend(_engines(params),
                            [TenantClass("default", slo_ms=None)],
                            max_queue_rows=4, start=False)
    try:
        rid = fe.submit(z, "default")
        with pytest.raises(AdmissionRejected, match="queue full") as ei:
            fe.submit(z[:1], "default")
        assert ei.value.stage == "queue_full"
        fe.start()
        np.testing.assert_allclose(fe.result(rid, timeout_s=WAIT_S), ref,
                                   rtol=TOL, atol=TOL)
        assert fe.stats()["queue_rows"] == 0
        fe.submit(z[:1], "default")
        fe.drain(timeout_s=WAIT_S)
    finally:
        fe.close(timeout_s=WAIT_S)


def test_late_request_shed_typed_before_dispatch(tiny_setup):
    params, z, _, _ = tiny_setup
    fe = AsyncServeFrontend(_engines(params),
                            [TenantClass("gold", slo_ms=20.0)], start=False)
    try:
        rid = fe.submit(z[:2], "gold")
        time.sleep(0.1)
        fe.start()
        with pytest.raises(AdmissionRejected, match="no longer meet") as ei:
            fe.result(rid, timeout_s=WAIT_S)
        assert ei.value.stage == "late"
        assert fe.stats()["tenants"]["gold"]["shed_late"] == 1
    finally:
        fe.close(timeout_s=WAIT_S)


def test_dispatch_failure_requeues_then_completes(tiny_setup):
    params, z, ref, _ = tiny_setup
    inj = FaultInjector([TransientFailure(at_call=0)])
    fe = AsyncServeFrontend(_engines(params, injector=inj, max_retries=0),
                            [TenantClass("default", slo_ms=None)])
    try:
        rid = fe.submit(z, "default")
        np.testing.assert_allclose(fe.result(rid, timeout_s=WAIT_S), ref,
                                   rtol=TOL, atol=TOL)
        st = fe.stats()["tenants"]["default"]
        assert st["requeued"] == 1 and st["completed"] == 1
    finally:
        fe.close(timeout_s=WAIT_S)


def test_dispatch_failure_exhausted_resolves_typed(tiny_setup):
    params, z, _, _ = tiny_setup
    inj = FaultInjector([TransientFailure(0), TransientFailure(1)])
    fe = AsyncServeFrontend(_engines(params, injector=inj, max_retries=0),
                            [TenantClass("default", slo_ms=None)],
                            max_requeues=1)
    try:
        rid = fe.submit(z, "default")
        with pytest.raises(EngineDegraded, match="retries exhausted"):
            fe.result(rid, timeout_s=WAIT_S)
        assert fe.stats()["tenants"]["default"]["shed_requeue"] == 1
    finally:
        fe.close(timeout_s=WAIT_S)


def test_device_loss_requeues_then_completes_without_remesh(tiny_setup):
    """One device: a device loss fails the wave typed (`EngineDegraded`),
    the frontend requeues it and the next wave serves it; no remesh is
    recorded and nothing hangs."""
    params, z, ref, _ = tiny_setup
    inj = FaultInjector([DeviceLoss(at_call=0, keep=1)])
    fe = AsyncServeFrontend(_engines(params, injector=inj),
                            [TenantClass("default", slo_ms=None)])
    try:
        rid = fe.submit(z, "default")
        np.testing.assert_allclose(fe.result(rid, timeout_s=WAIT_S), ref,
                                   rtol=TOL, atol=TOL)
        st = fe.stats()
        assert st["remeshes"] == 0
        assert st["tenants"]["default"]["requeued"] == 1
        assert fe._engines["fp32"].fault_stats["remesh_events"] == []
    finally:
        fe.close(timeout_s=WAIT_S)


def test_close_resolves_queued_requests_typed(tiny_setup):
    params, z, _, _ = tiny_setup
    fe = AsyncServeFrontend(_engines(params),
                            [TenantClass("default", slo_ms=None)],
                            start=False)
    rid = fe.submit(z[:2], "default")
    fe.close(drain=False, timeout_s=WAIT_S)
    with pytest.raises(AdmissionRejected, match="shutdown") as ei:
        fe.result(rid, timeout_s=WAIT_S)
    assert ei.value.stage == "shutdown"
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(z[:1], "default")


def test_prime_builds_and_seeds_every_bucket_precision(tiny_setup):
    """`prime()` builds every bucket x precision before `start()` (one
    executable each) and measures each, so admission is estimate-backed
    from the first request."""
    params, _, _, _ = tiny_setup
    fe = AsyncServeFrontend(_engines(params, ("fp32", "int8")),
                            [TenantClass("default")], start=False)
    try:
        fe.prime(reps=1)
        assert not fe._worker.is_alive()
        for eng in fe._engines.values():
            assert eng.capture_counts == {2: 1, 4: 1}
        est = fe.stats()["estimates_s"]
        assert set(est) == {"fp32/b2", "fp32/b4", "int8/b2", "int8/b4"}
        assert all(v > 0 for v in est.values())
    finally:
        fe.close(drain=False, timeout_s=WAIT_S)


def test_from_config_wires_one_registry_and_the_injector(tiny_setup):
    params, z, _, _ = tiny_setup
    inj = FaultInjector()
    fe = AsyncServeFrontend.from_config(
        EngineConfig(model=TINY, device="cpu", buckets=(2, 4)), params,
        [TenantClass("default")], prime=1, fault_injector=inj)
    try:
        engines = fe._engines
        assert set(engines) == {"fp32", "int8"}
        assert engines["fp32"].fault_injector is inj
        assert engines["int8"].fault_injector is None
        assert all(e.metrics is fe.metrics for e in engines.values())
        assert inj.calls == 4          # prime: 2 buckets x (1 + 1) calls
        fe.result(fe.submit(z, "default"), timeout_s=WAIT_S)
    finally:
        fe.close(timeout_s=WAIT_S)
    with pytest.raises(ValueError, match="needs a 'fp32' engine"):
        AsyncServeFrontend(_engines(params, ("int8",)),
                           [TenantClass("default")], start=False)


def test_overload_2x_every_request_resolves_typed(tiny_setup):
    """Offered load at ~2x the queue bound with mixed tenant SLOs: every
    submission resolves typed (completed, possibly downgraded, or
    `AdmissionRejected`) within a bounded wait; none hangs."""
    params, _, _, _ = tiny_setup
    fe = AsyncServeFrontend(
        _engines(params, ("fp32", "int8")),
        [TenantClass("gold", slo_ms=30_000.0, priority=0),
         TenantClass("std", slo_ms=None, priority=1)],
        max_queue_rows=8, start=False)
    try:
        fe.prime(reps=1)
        fe.start()
        rng = np.random.RandomState(7)
        admitted, rejected = [], 0
        for i in range(40):
            zi = rng.randn(2, TINY.z_dim).astype(np.float32)
            try:
                admitted.append(fe.submit(zi, "gold" if i % 2 == 0
                                          else "std"))
            except AdmissionRejected as e:
                assert e.stage in ("queue_full", "predicted_slo")
                rejected += 1
        for rid in admitted:
            out = fe.result(rid, timeout_s=WAIT_S)
            assert out.shape == (2, TINY.img_hw, TINY.img_hw, TINY.img_c)
        st = fe.stats()
        gold, std = st["tenants"]["gold"], st["tenants"]["std"]
        assert gold["admitted"] + std["admitted"] == len(admitted)
        assert gold["shed_admission"] + std["shed_admission"] == rejected
        assert rejected > 0
        assert gold["completed"] + std["completed"] == len(admitted)
        assert gold["p99_ms"] <= 30_000.0
        assert st["queue_rows"] == 0 and st["inflight_rows"] == 0
    finally:
        fe.close(timeout_s=WAIT_S)


# ---------------------------------------------------------------------------
# examples/serve_dcnn_torch.py
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location(
        "serve_dcnn_torch", ROOT / "examples" / "serve_dcnn_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_sync_path_on_the_cpu(example, tmp_path, capsys):
    path = tmp_path / "trace.json"
    eng = example.main(["--net", "mnist", "--device", "cpu", "--backend",
                        "reverse_loop", "--reqs", "4", "--batch", "4",
                        "--trace", str(path)])
    assert eng.stats["images"] == sum(example.request_sizes(
        types.SimpleNamespace(reqs=4, batch=4)))
    assert eng.total_captures == len(eng.buckets)
    out = capsys.readouterr().out
    assert "dcnn-mnist x<= 4 via reverse_loop/fp32 on cpu" in out
    assert path.exists() and "trace:" in out


def test_example_async_path_on_the_cpu(example, capsys):
    st = example.main(["--net", "mnist", "--device", "cpu", "--backend",
                       "reverse_loop", "--reqs", "5", "--batch", "4",
                       "--async", "--slo-ms", "60000"])
    done = sum(t["completed"] + t["shed"] for t in st["tenants"].values())
    assert done == 5 and st["precisions"] == ["fp32"]
    assert "async serving on cpu" in capsys.readouterr().out


def test_example_defaults_to_the_card(example, monkeypatch):
    """Without a card the default device raises before anything runs; it
    never carries on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--net", "mnist", "--reqs", "1"])
