"""Single-device fault handling in the port against the JAX package: the
same fault scripts through both `FaultInjector`s and the same timings
through both `StragglerMonitor`s give equal results; the port's
`Heartbeat`; and the port's counterparts of the reference's single-device
fault-serving tests on port engines on the CPU (``device="cpu"``; int8
through its plain chain): retry, exhaustion, tainted accounting, drain
restore, device loss, deadlines, stragglers and heartbeats.  Every wait
on a thread is bounded, and every heartbeat is closed."""
import dataclasses
import threading
import time
import warnings

import jax
import numpy as np
import pytest

from repro.dist import fault as jfault
from repro.dist import inject as jinject
from repro.models import dcnn as jdcnn
from repro.serve import DcnnServeEngine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro_torch.dist import inject as tinject
from repro_torch.dist import (DeviceLoss, DeviceLossError, FaultInjector,
                              Heartbeat, SlowCall, StragglerMonitor,
                              TransientCallError, TransientFailure)
from repro_torch.models.dcnn import (DcnnConfig, DeconvLayerCfg,
                                     generator_params_from_numpy)
from repro_torch.serve import (DcnnServeEngine, DeadlineExceeded,
                               EngineConfig, EngineDegraded)
from repro_torch.serve.engine import CAPTURE_GATE

TINY = DcnnConfig(
    name="tiny-fault", z_dim=16, img_hw=16, img_c=1,
    layers=(DeconvLayerCfg(16, 32, 4, 1, 0, "relu"),
            DeconvLayerCfg(32, 16, 4, 2, 1, "relu"),
            DeconvLayerCfg(16, 1, 4, 2, 1, "tanh")))
J_TINY = jdcnn.DcnnConfig(
    name=TINY.name, z_dim=TINY.z_dim, img_hw=TINY.img_hw, img_c=TINY.img_c,
    layers=tuple(jdcnn.DeconvLayerCfg(l.c_in, l.c_out, l.kernel, l.stride,
                                      l.padding, l.activation)
                 for l in TINY.layers))
TOL = 1e-5   # fp32 against the reference's reverse loop
WAIT_S = 60


@pytest.fixture(scope="module")
def tiny_setup():
    """The reference's params (numpy) on the port, 4 rows of z and the
    reference generator's images of them."""
    jp, _ = jdcnn.generator_init(jax.random.PRNGKey(0), J_TINY)
    pn = jax.tree_util.tree_map(np.asarray, jp)
    params = generator_params_from_numpy(pn, TINY, "cpu")
    z = np.random.RandomState(0).randn(4, TINY.z_dim).astype(np.float32)
    ref = np.asarray(jdcnn.generator_apply(jp, J_TINY, z,
                                           backend="reverse_loop"))
    return params, z, ref, jp


def _engine(params, injector=None, **over):
    kw = dict(model=TINY, device="cpu", buckets=(4,))
    kw.update(over)
    return DcnnServeEngine.from_config(EngineConfig(**kw), params,
                                       fault_injector=injector)


# ---------------------------------------------------------------------------
# the same scripts through both packages
# ---------------------------------------------------------------------------
def _fault_script(mod, seed):
    rng = np.random.RandomState(seed)
    faults = []
    for idx in sorted(rng.choice(40, size=10, replace=False)):
        kind = rng.randint(3)
        if kind == 0:
            faults.append(mod.SlowCall(at_call=int(idx), delay_s=0.0))
        elif kind == 1:
            faults.append(mod.TransientFailure(at_call=int(idx)))
        else:
            faults.append(mod.DeviceLoss(at_call=int(idx),
                                         keep=int(rng.randint(1, 5))))
    return faults


def _drive(mod, faults, late):
    """40 hooked calls, one fault scheduled late; per call what came out
    (None, or the raised type's name, message and ``keep``)."""
    inj = mod.FaultInjector(faults)
    out = []
    for call in range(40):
        if call == 20:
            inj.schedule(late)
        try:
            inj.before_call(bucket=2 ** (call % 4))
            out.append(None)
        except mod.FaultError as e:
            out.append((type(e).__name__, str(e), getattr(e, "keep", None)))
    log = [(i, type(f).__name__, dataclasses.asdict(f)) for i, f in inj.log]
    return out, log, inj.calls


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_injector_replays_as_reference(seed):
    port = _drive(tinject, _fault_script(tinject, seed),
                  tinject.TransientFailure(at_call=20))
    ref = _drive(jinject, _fault_script(jinject, seed),
                 jinject.TransientFailure(at_call=20))
    assert port == ref
    assert port[2] == 40


def test_injector_rejects_unknown_fault_as_reference():
    @dataclasses.dataclass(frozen=True)
    class Weird:
        at_call: int

    for mod in (jinject, tinject):
        inj = mod.FaultInjector([Weird(0)])
        with pytest.raises(TypeError, match="unknown fault"):
            inj.before_call(1)


@pytest.mark.parametrize("factor,warmup", [(3.0, 2), (1.5, 0), (2.0, 5)])
def test_straggler_monitor_equals_reference(factor, warmup):
    rng = np.random.RandomState(int(factor * 10) + warmup)
    dts = rng.gamma(4.0, 0.001, size=300)
    dts[rng.choice(300, size=15, replace=False)] *= 8.0   # outliers
    port = StragglerMonitor(factor=factor, warmup_steps=warmup)
    ref = jfault.StragglerMonitor(factor=factor, warmup_steps=warmup)
    assert port.estimate() is None and ref.estimate() is None
    for i, dt in enumerate(dts):
        assert port.observe(i, float(dt)) == ref.observe(i, float(dt))
        assert port.estimate() == ref.estimate()
    assert port.flagged == ref.flagged and port.flagged


def test_straggler_monitor_flags_slow_steps():
    m = StragglerMonitor(factor=3.0, warmup_steps=2)
    for i in range(10):
        m.observe(i, 0.1)
    assert m.observe(10, 0.5) is True
    assert m.flagged == [10]
    assert m.ema < 0.12
    assert m.observe(11, 0.1) is False


def test_config_fault_knobs_equal_reference():
    names = ("max_retries", "retry_backoff_s", "heartbeat_timeout_s",
             "straggler_factor", "straggler_warmup")
    port = EngineConfig(model=TINY, device="cpu")
    ref = JEngineConfig(model=J_TINY)
    assert {n: getattr(port, n) for n in names} == \
        {n: getattr(ref, n) for n in names}


# ---------------------------------------------------------------------------
# heartbeat
# ---------------------------------------------------------------------------
def test_heartbeat_fires_once_per_silence():
    fired = []
    hb = Heartbeat(timeout_s=0.1, on_failure=lambda: fired.append(1))
    try:
        time.sleep(0.4)
        assert len(fired) == 1 and hb.fire_count == 1   # once per silence
        hb.tick()
        time.sleep(0.4)
        assert len(fired) == 2
    finally:
        hb.close()


def test_heartbeat_disarmed_is_silent_and_closed_never_fires():
    fired = []
    hb = Heartbeat(timeout_s=0.3, on_failure=lambda: fired.append(1))
    try:
        hb.disarm()
        time.sleep(0.6)
        assert not fired
        hb.arm()
        time.sleep(0.9)
        assert len(fired) == 1
    finally:
        hb.close()
    n = len(fired)
    time.sleep(0.2)
    assert len(fired) == n and not hb._thread.is_alive()


def test_heartbeat_records_callback_errors():
    def boom():
        raise RuntimeError("callback failed")

    hb = Heartbeat(timeout_s=0.05, on_failure=boom)
    try:
        time.sleep(0.3)
        assert hb.callback_errors and hb._thread.is_alive()
    finally:
        hb.close()


# ---------------------------------------------------------------------------
# retry / degraded semantics on the port engine
# ---------------------------------------------------------------------------
def test_transient_failure_retried_transparently(tiny_setup):
    """One injected transient failure: the retry replays the same
    executable (no new build) and the images equal an uninjected
    engine's bit for bit."""
    params, z, ref, _ = tiny_setup
    inj = FaultInjector([TransientFailure(at_call=0)])
    eng = _engine(params, inj, max_retries=2, retry_backoff_s=0.01)
    plain = _engine(params)
    got = eng.generate(z)
    np.testing.assert_array_equal(got, plain.generate(z))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert eng.fault_stats["retries"] == 1
    assert eng.fault_stats["transient_failures"] == 1
    assert inj.calls == 2
    assert eng.capture_counts == {4: 1}


def test_retry_exhaustion_raises_typed(tiny_setup):
    params, z, _, _ = tiny_setup
    inj = FaultInjector([TransientFailure(0), TransientFailure(1)])
    eng = _engine(params, inj, max_retries=1, retry_backoff_s=0.01)
    with pytest.raises(EngineDegraded, match="retries exhausted") as ei:
        eng.generate(z)
    assert isinstance(ei.value.__cause__, TransientCallError)
    assert eng.fault_stats["transient_failures"] == 2
    assert eng.fault_stats["retries"] == 1


def test_retried_dispatch_tainted_not_in_healthy_cv(tiny_setup):
    """A dispatch that needed a retry is tainted: out of the healthy
    mean/std/CV samples, out of the straggler EMA, counted in
    ``throughput()`` and the registry's ``engine.tainted_calls``."""
    params, z, _, _ = tiny_setup
    inj = FaultInjector([TransientFailure(at_call=1)])
    eng = _engine(params, inj, max_retries=2, retry_backoff_s=0.01)
    eng.generate(z)                    # call 0 builds: never sampled
    assert eng.bucket_stats == {}
    eng.generate(z)                    # call 1 fails -> retried success
    bs = eng.bucket_stats[4]
    assert bs["tainted_calls"] == 1 and bs["tainted_seconds"] > 0
    assert bs["calls"] == 0 and bs["seconds"] == 0.0
    assert eng.throughput() == {}
    assert eng.service_estimate(4) is None
    eng.generate(z)                    # healthy steady call
    row = eng.throughput()[4]
    assert row["calls"] == 1 and row["tainted_calls"] == 1
    assert row["tainted_seconds"] == bs["tainted_seconds"]
    assert row["img_per_s_per_device"] == row["img_per_s"]
    assert row["mean_s"] == pytest.approx(bs["seconds"])
    assert eng.service_estimate(4) == pytest.approx(bs["seconds"])
    assert eng.metrics.counter("engine.tainted_calls").total(bucket=4) == 1
    assert eng.metrics.histogram("engine.dispatch_seconds").merged_summary(
        bucket=4)["count"] == 1
    assert eng.capture_counts == {4: 1}


def test_throughput_rows_and_fault_stats_carry_reference_keys(tiny_setup):
    params, z, _, jp = tiny_setup
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JEngine.from_config(JEngineConfig(
            model=J_TINY, backend="reverse_loop", buckets=(4,)), jp)
    eng = _engine(params)
    for e in (jeng, eng):
        for _ in range(3):
            e.generate(z)
    assert set(eng.throughput()[4]) == set(jeng.throughput()[4])
    assert set(eng.fault_stats) == set(jeng.fault_stats)
    assert eng.fault_stats["remesh_events"] == []
    assert set(eng.bucket_stats[4]) == set(jeng.bucket_stats[4])
    assert eng.stats["device_count"] == jeng.stats["device_count"] == 1


def test_service_estimate_takes_the_ema_first(tiny_setup):
    """With the straggler monitor past its warmup the estimate is its EMA,
    not the plain mean (they differ once a later sample moves the EMA)."""
    params, z, _, _ = tiny_setup
    eng = _engine(params, straggler_warmup=1, straggler_factor=1e9)
    for _ in range(6):
        eng.generate(z)
    mon = eng._stragglers[4]
    assert eng.service_estimate(4) == mon.estimate()
    bs = eng.bucket_stats[4]
    assert mon.estimate() != bs["seconds"] / bs["calls"]


def test_backoff_sleeps_outside_dispatch_lock_and_capture_gate(tiny_setup):
    """While a retry backs off, another caller takes the engine's dispatch
    lock and a build takes `CAPTURE_GATE` exclusive: the sleep blocks
    neither."""
    params, z, _, _ = tiny_setup
    inj = FaultInjector([TransientFailure(at_call=1)])
    eng = _engine(params, inj, max_retries=1, retry_backoff_s=2.0)
    eng.generate(z)
    done = threading.Event()
    worker = threading.Thread(target=lambda: (eng.generate(z), done.set()))
    worker.start()
    try:
        t0 = time.perf_counter()
        while eng.fault_stats["retries"] == 0:
            assert time.perf_counter() - t0 < WAIT_S
            time.sleep(0.005)
        t_lock = time.perf_counter()
        assert eng._dispatch_lock.acquire(timeout=0.5)
        eng._dispatch_lock.release()
        got = threading.Event()

        def build():
            with CAPTURE_GATE.exclusive():
                got.set()

        b = threading.Thread(target=build)
        b.start()
        b.join(timeout=0.5)
        assert got.is_set() and time.perf_counter() - t_lock < 1.5
        assert not done.is_set()       # still backing off
    finally:
        worker.join(timeout=WAIT_S)
    assert done.is_set()
    assert eng.fault_stats["retries"] == 1


def test_drain_restores_pending_on_failure(tiny_setup):
    params, z, ref, _ = tiny_setup
    inj = FaultInjector([TransientFailure(at_call=0)])
    eng = _engine(params, inj, max_retries=0)
    r1, r2 = eng.submit(z[:2]), eng.submit(z[2:])
    with pytest.raises(EngineDegraded):
        eng.collect(r1, timeout_s=WAIT_S)
    assert len(eng._pending) == 2
    out = np.concatenate([eng.collect(r1, timeout_s=WAIT_S),
                          eng.collect(r2, timeout_s=WAIT_S)], axis=0)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_device_loss_without_mesh_is_degraded(tiny_setup, precision):
    params, z, _, _ = tiny_setup
    inj = FaultInjector([DeviceLoss(at_call=0, keep=1)])
    eng = _engine(params, inj, precision=precision)
    with pytest.raises(EngineDegraded, match="elastic mesh") as ei:
        eng.generate(z)
    assert isinstance(ei.value.__cause__, DeviceLossError)
    assert eng.fault_stats["retries"] == 0
    assert eng.fault_stats["remesh_events"] == []
    # the loss is spent: the engine serves again
    assert eng.generate(z).shape == (4, 16, 16, 1)


# ---------------------------------------------------------------------------
# deadlines + collect semantics
# ---------------------------------------------------------------------------
def test_deadline_exceeded_is_typed_and_queue_survives(tiny_setup):
    params, z, ref, _ = tiny_setup
    eng = _engine(params)
    rid = eng.submit(z, deadline_s=0.0)
    time.sleep(0.02)
    with pytest.raises(DeadlineExceeded, match="missed its deadline"):
        eng.collect(rid, timeout_s=WAIT_S)
    assert eng.fault_stats["deadline_expired"] == 1
    assert eng.metrics.counter("engine.fault_events").total(
        event="deadline_expired") == 1
    rid2 = eng.submit(z)
    np.testing.assert_allclose(eng.collect(rid2, timeout_s=WAIT_S), ref,
                               rtol=TOL, atol=TOL)


def test_default_deadline_from_config(tiny_setup):
    params, z, _, _ = tiny_setup
    eng = _engine(params, default_deadline_s=0.0)
    rid = eng.submit(z)
    time.sleep(0.02)
    with pytest.raises(DeadlineExceeded):
        eng.collect(rid, timeout_s=WAIT_S)
    rid2 = eng.submit(z, deadline_s=60.0)
    assert eng.collect(rid2, timeout_s=WAIT_S).shape == (4, 16, 16, 1)


def test_collect_distinguishes_unknown_from_collected(tiny_setup):
    params, z, _, _ = tiny_setup
    eng = _engine(params)
    rid = eng.submit(z)
    eng.collect(rid, timeout_s=WAIT_S)
    with pytest.raises(KeyError, match="already collected"):
        eng.collect(rid)
    with pytest.raises(KeyError, match="never issued"):
        eng.collect(rid + 999)


def test_shed_counts_in_registry(tiny_setup):
    params, z, _, _ = tiny_setup
    eng = _engine(params)
    rid = eng.submit(z)
    assert eng.shed(rid, "load")
    assert eng.fault_stats["shed"] == 1
    assert eng.metrics.counter("engine.fault_events").total(event="shed") == 1
    assert not eng.shed(rid)


# ---------------------------------------------------------------------------
# straggler + heartbeat wiring
# ---------------------------------------------------------------------------
def test_straggler_flagged_and_heartbeat_fires_on_stall(tiny_setup):
    """An injected slow dispatch lands in the timed window: the bucket's
    monitor flags it and the armed heartbeat records the stall; an idle
    engine afterwards fires nothing (disarmed between calls)."""
    params, z, _, _ = tiny_setup
    inj = FaultInjector([SlowCall(at_call=3, delay_s=1.0)])
    # cudnn: on the CPU the fastest backend (tens of ms a dispatch here),
    # so the 1 s delay stands well past 3x the healthy EMA
    eng = _engine(params, inj, backend="cudnn", straggler_warmup=1,
                  heartbeat_timeout_s=0.2)
    try:
        for _ in range(4):   # call 0 builds; 1 seeds; 2 steady; 3 slow
            eng.generate(z)
        assert eng.fault_stats["stragglers"] == 1
        assert eng.fault_stats["heartbeat_fires"] >= 1
        fires = eng.fault_stats["heartbeat_fires"]
        time.sleep(0.5)
        assert eng.fault_stats["heartbeat_fires"] == fires
        ev = eng.metrics.counter("engine.fault_events")
        assert ev.total(event="stragglers") == 1
        assert ev.total(event="heartbeat_fires") == fires
        # the straggler is a healthy steady sample: it is in the CV
        assert eng.throughput()[4]["calls"] == 3
    finally:
        eng.close()
    assert not eng._heartbeat._thread.is_alive()


def test_warmup_runs_outside_the_injector(tiny_setup):
    """Warmup builds every bucket without consuming a scripted call (the
    reference's warmup does not reach the hook either)."""
    params, z, _, _ = tiny_setup
    inj = FaultInjector([TransientFailure(at_call=0)])
    eng = _engine(params, inj, buckets=(2, 4), warmup=True, max_retries=0)
    assert inj.calls == 0 and eng.capture_counts == {2: 1, 4: 1}
    with pytest.raises(EngineDegraded):
        eng.generate(z)
    assert inj.calls == 1
