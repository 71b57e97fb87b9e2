"""The port's observability layer (`repro_torch.obs`) against the JAX
package's (`repro.obs`): the same scripted metric operations give equal
snapshots, Table II rows and rendered tables; the port's own metric,
tracer and exporter behaviour; and the dual-write contract on port
engines and frontends on the CPU (``device="cpu"``), with the metric
names, label keys and span names of the reference."""
import json
import threading

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.obs import report as jreport
from repro_torch.models.dcnn import generator_init
from repro_torch.obs import clock, trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, MetricTypeError)
from repro_torch.obs.report import render_table2, table2_rows
from repro_torch.serve import (AsyncServeFrontend, DcnnServeEngine,
                               EngineConfig, TenantClass)
from test_torch_fault import J_TINY, TINY, WAIT_S


@pytest.fixture(scope="module")
def tiny():
    params = generator_init(torch.Generator().manual_seed(0), TINY, "cpu")
    z = np.random.RandomState(0).randn(4, TINY.z_dim).astype(np.float32)
    return params, z


def _engine(params, reg=None, **kw):
    cfg = dict(model=TINY, device="cpu", buckets=(2, 4), warmup=True)
    cfg.update(kw)
    return DcnnServeEngine.from_config(EngineConfig(**cfg), params,
                                       metrics=reg)


# ---------------------------------------------------------------------------
# the same scripts through both packages
# ---------------------------------------------------------------------------
def _script(seed):
    """A seeded list of registry operations (counter incs, gauge sets,
    histogram observes over a few label sets, custom bounds included)."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(200):
        labels = {"net": f"n{rng.randint(2)}",
                  "precision": ("fp32", "int8")[rng.randint(2)],
                  "bucket": int(2 ** rng.randint(4))}
        kind = rng.randint(4)
        if kind == 0:
            ops.append(("counter", "engine.tainted_calls",
                        float(rng.randint(1, 3)), labels))
        elif kind == 1:
            ops.append(("gauge", "engine.device_count",
                        float(rng.randint(1, 9)), labels))
        elif kind == 2:
            ops.append(("histogram", "engine.dispatch_seconds",
                        float(rng.gamma(2.0, 0.002)), labels))
        else:
            ops.append(("custom", "frontend.queue_wait_seconds",
                        float(rng.rand()), {"tenant": f"t{rng.randint(3)}"}))
    return ops


def _run_script(mod, ops):
    reg = mod.MetricsRegistry()
    for kind, name, v, labels in ops:
        if kind == "counter":
            reg.counter(name).inc(v, **labels)
        elif kind == "gauge":
            reg.gauge(name).set(v, **labels)
        elif kind == "histogram":
            reg.histogram(name).observe(v, **labels)
        else:
            reg.histogram(name, buckets=(0.1, 0.5, 0.9)).observe(v, **labels)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_registry_equals_reference(seed):
    """Snapshots, Table II rows and the rendered table of the same
    operations are equal in both packages (exactly: the same float
    operations in the same order)."""
    from repro_torch.obs import metrics as tmetrics

    ops = _script(seed)
    ref, port = _run_script(jmetrics, ops), _run_script(tmetrics, ops)
    assert port.names() == ref.names()
    assert port.snapshot() == ref.snapshot()
    rows = table2_rows(port)
    assert rows and rows == jreport.table2_rows(ref)
    assert render_table2(rows) == jreport.render_table2(rows)
    h, jh = (r.histogram("engine.dispatch_seconds") for r in (port, ref))
    assert h.merged_summary(net="n0") == jh.merged_summary(net="n0")
    assert h.label_values("bucket") == jh.label_values("bucket")
    assert (port.counter("engine.tainted_calls").total(precision="int8")
            == ref.counter("engine.tainted_calls").total(precision="int8"))


def test_empty_and_rendered_tables_equal_reference():
    assert table2_rows(MetricsRegistry()) == []
    assert render_table2([]) == jreport.render_table2([])
    assert (table2_rows(MetricsRegistry(), metric="nope")
            == jreport.table2_rows(jmetrics.MetricsRegistry(), metric="nope"))


# ---------------------------------------------------------------------------
# metrics: statistics vs numpy, labels, registry
# ---------------------------------------------------------------------------
def test_histogram_stats_match_numpy():
    rng = np.random.RandomState(7)
    samples = rng.gamma(2.0, 0.01, size=500)
    h = Histogram("t")
    for s in samples:
        h.observe(float(s), net="a", bucket=4)
    st = h.summary(net="a", bucket=4)
    assert st["count"] == 500
    assert st["mean"] == pytest.approx(samples.mean(), rel=1e-9)
    assert st["std"] == pytest.approx(samples.std(), rel=1e-6)
    assert st["cv"] == pytest.approx(samples.std() / samples.mean(), rel=1e-6)
    assert st["min"] == pytest.approx(samples.min())
    assert st["max"] == pytest.approx(samples.max())
    h2 = Histogram("t2")
    for _ in range(100):
        h2.observe(0.123456789)
    assert h2.summary()["std"] == pytest.approx(0.0, abs=1e-9)


def test_histogram_merged_summary_pools_across_labels():
    rng = np.random.RandomState(3)
    a, b = rng.rand(40) + 1.0, rng.rand(60) + 2.0
    h = Histogram("t")
    for s in a:
        h.observe(float(s), net="x", bucket=2)
    for s in b:
        h.observe(float(s), net="x", bucket=4)
    pooled = np.concatenate([a, b])
    st = h.merged_summary(net="x")
    assert st["count"] == 100
    assert st["mean"] == pytest.approx(pooled.mean())
    assert st["std"] == pytest.approx(pooled.std(), rel=1e-6)
    assert h.summary(net="x", bucket=2)["count"] == 40
    assert h.label_values("bucket") == ["2", "4"]


def test_histogram_bucket_counts_and_bounds_validation():
    h = Histogram("t", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    (row,) = h.snapshot()["series"]
    assert row["bucket_counts"] == [1, 1, 1, 1]
    with pytest.raises(ValueError):
        Histogram("bad", buckets=(1.0, 1.0, 2.0))
    with pytest.raises(ValueError):
        Histogram("bad", buckets=(2.0, 1.0))


def test_counter_and_gauge_semantics():
    c = Counter("c")
    c.inc(tenant="a", outcome="ok")
    c.inc(2, tenant="a", outcome="shed")
    c.inc(tenant="b", outcome="ok")
    assert c.value(tenant="a", outcome="ok") == 1
    assert c.total(tenant="a") == 3
    assert c.total() == 4
    assert c.value(tenant="zzz") == 0
    with pytest.raises(ValueError):
        c.inc(-1)
    g = Gauge("g")
    assert g.value(dev="all") is None
    g.set(8, dev="all")
    g.set(4, dev="all")
    assert g.value(dev="all") == 4


def test_registry_get_or_create_and_type_conflict():
    reg = MetricsRegistry()
    c1 = reg.counter("x", "first help wins")
    assert reg.counter("x") is c1
    with pytest.raises(MetricTypeError):
        reg.gauge("x")
    reg.histogram("h")
    assert reg.names() == ["h", "x"]
    assert reg.get("nope") is None


def test_registry_snapshot_json_round_trip():
    reg = MetricsRegistry()
    reg.counter("c").inc(3, net="a", bucket=4)
    reg.gauge("g").set(1.5)
    reg.histogram("h").observe(0.25, net="a")
    doc = json.loads(json.dumps(reg.snapshot()))
    assert doc["c"]["type"] == "counter"
    assert doc["c"]["series"] == [
        {"labels": {"net": "a", "bucket": "4"}, "value": 3}]
    assert doc["h"]["series"][0]["count"] == 1
    assert doc["h"]["bounds"] == list(Histogram.DEFAULT_BUCKETS)


def test_registry_threaded_writes_lose_nothing():
    reg = MetricsRegistry()
    n, threads = 200, 8

    def work(i):
        c = reg.counter("ops")
        h = reg.histogram("lat")
        for k in range(n):
            c.inc(worker=i % 2)
            h.observe(0.001 * (k + 1))

    ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in ts)
    assert reg.counter("ops").total() == n * threads
    assert reg.histogram("lat").summary()["count"] == n * threads


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------
def test_disabled_tracer_is_free_and_silent():
    t = trace.Tracer(enabled=False)
    assert t.span("a") is t.span("b")
    with t.span("a"):
        pass
    t.complete("x", 0.0, 1.0)
    t.instant("y")
    t.end(t.begin("z"))
    assert len(t) == 0 and not t.enabled


def test_span_nesting_and_exception_class():
    t = trace.Tracer(enabled=True)
    with t.span("outer", rows=4):
        with t.span("inner"):
            pass
    inner, outer = t.events()
    assert inner["name"] == "inner" and outer["name"] == "outer"
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    assert outer["args"] == {"rows": 4}
    with pytest.raises(RuntimeError):
        with t.span("boom"):
            raise RuntimeError("x")
    assert t.events()[-1]["args"]["error"] == "RuntimeError"


def test_begin_end_attributes_to_begin_thread():
    t = trace.Tracer(enabled=True)
    with t.span("marker"):
        pass
    h = t.begin("queue_wait", rid=1)
    worker = threading.Thread(target=lambda: t.end(h, outcome="dispatched"),
                              name="worker-0")
    worker.start()
    worker.join(timeout=WAIT_S)
    marker, qw = t.events()
    assert qw["tid"] == marker["tid"]
    assert qw["args"] == {"rid": 1, "outcome": "dispatched"}
    assert qw["dur"] >= 0


def test_ring_buffer_keeps_newest():
    t = trace.Tracer(capacity=4, enabled=True)
    for i in range(10):
        t.instant(f"e{i}")
    assert len(t) == 4
    assert [e["name"] for e in t.events()] == ["e6", "e7", "e8", "e9"]


def test_perfetto_export_round_trip(tmp_path):
    t = trace.Tracer(enabled=True)
    t0 = clock.now()
    t.complete("dispatch b4", t0, t0 + 0.25, bucket=4)
    t.instant("retry", attempt=1)
    path = tmp_path / "trace.json"
    assert t.export(str(path)) == 2
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    metas = [e for e in evs if e["ph"] == "M"]
    assert {"process_name", "thread_name"} <= {e["name"] for e in metas}
    (x,) = [e for e in evs if e["ph"] == "X"]
    assert x["dur"] == pytest.approx(0.25 * 1e6, rel=1e-6)
    (i,) = [e for e in evs if e["ph"] == "i"]
    assert i["s"] == "t"
    assert all({"ph", "name", "pid", "tid"} <= set(e) for e in evs)


def test_clock_is_monotonic():
    ts = [clock.now() for _ in range(100)]
    assert all(b >= a for a, b in zip(ts, ts[1:]))


# ---------------------------------------------------------------------------
# dual-write contract + reporter, against live port engines on the CPU
# ---------------------------------------------------------------------------
def test_engine_registry_matches_bucket_stats(tiny):
    params, z = tiny
    reg = MetricsRegistry()
    eng = _engine(params, reg)
    for _ in range(3):
        eng.generate(z)
        eng.generate(z[:2])
    hist = reg.histogram("engine.dispatch_seconds")
    for bucket, bs in eng.bucket_stats.items():
        st = hist.summary(net=TINY.name, workload=TINY.name,
                          precision="fp32", bucket=bucket)
        assert st["count"] == bs["calls"]
        assert st["total"] == pytest.approx(bs["seconds"])
        mean = bs["seconds"] / bs["calls"]
        var = max(bs["sumsq_seconds"] / bs["calls"] - mean * mean, 0.0)
        assert st["std"] == pytest.approx(np.sqrt(var), abs=1e-12)
    assert reg.counter("engine.generate_calls").total() == 6
    assert reg.counter("engine.images").total() == 3 * 4 + 3 * 2
    assert reg.gauge("engine.device_count").value(
        net=TINY.name, workload=TINY.name, precision="fp32") == 1
    # warmup built both buckets: one plan build each, observed
    assert reg.histogram("engine.plan_build_seconds").merged_summary(
        net=TINY.name)["count"] == 2
    rows = table2_rows(reg)
    by_bucket = {r["bucket"]: r for r in rows}
    assert set(by_bucket) == {2, 4, "all"}
    assert by_bucket[4]["calls"] == eng.bucket_stats[4]["calls"]
    assert by_bucket[4]["tainted_calls"] == 0
    assert by_bucket["all"]["calls"] == sum(
        bs["calls"] for bs in eng.bucket_stats.values())
    assert by_bucket["all"]["img_per_s"] > 0


def test_engine_series_names_and_labels_equal_reference(tiny):
    """The port's engine registers the reference engine's metric names, and
    its series carry the same label keys."""
    import warnings

    import jax
    from repro.models import dcnn as jdcnn
    from repro.serve import DcnnServeEngine as JEngine
    from repro.serve import EngineConfig as JEngineConfig

    jp, _ = jdcnn.generator_init(jax.random.PRNGKey(0), J_TINY)
    params, z = tiny
    jreg, reg = jmetrics.MetricsRegistry(), MetricsRegistry()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JEngine.from_config(JEngineConfig(
            model=J_TINY, backend="reverse_loop", buckets=(2, 4),
            warmup=True), jp, metrics=jreg)
    eng = _engine(params, reg)
    for e in (jeng, eng):
        e.generate(z)
        e.generate(z[:3])
    assert reg.names() == jreg.names()
    jsnap, snap = jreg.snapshot(), reg.snapshot()
    for name in jsnap:
        assert snap[name]["type"] == jsnap[name]["type"]
        assert ([sorted(r["labels"]) for r in snap[name]["series"]]
                == [sorted(r["labels"]) for r in jsnap[name]["series"]])
    for name in ("engine.generate_calls", "engine.images",
                 "engine.padded_images", "engine.device_count"):
        assert snap[name]["series"] == jsnap[name]["series"]


def test_table2_rollup_weights_cv_by_calls():
    reg = MetricsRegistry()
    h = reg.histogram("engine.dispatch_seconds")
    for v in (1.0, 1.0, 1.0):
        h.observe(v, net="n", precision="fp32", bucket=2)
    for v in (1.0, 3.0):
        h.observe(v, net="n", precision="fp32", bucket=4)
    reg.counter("engine.tainted_calls").inc(
        net="n", precision="fp32", bucket=4)
    by_bucket = {r["bucket"]: r for r in table2_rows(reg)}
    assert by_bucket[2]["cv"] == pytest.approx(0.0)
    assert by_bucket[4]["cv"] == pytest.approx(0.5)
    assert by_bucket[4]["tainted_calls"] == 1
    assert by_bucket["all"]["cv"] == pytest.approx((0 * 3 + 0.5 * 2) / 5)
    assert by_bucket["all"]["mean_s"] == pytest.approx((3.0 + 4.0) / 5)


def test_frontend_registry_matches_stats(tiny):
    """Concurrent submitters: the typed counters and the per-tenant dicts
    are written at the same sites, so they agree exactly."""
    params, z = tiny
    reg = MetricsRegistry()
    fe = AsyncServeFrontend({"fp32": _engine(params, reg)},
                            [TenantClass("default", slo_ms=None)],
                            metrics=reg)
    try:
        rids = []
        rlock = threading.Lock()

        def client(i):
            rid = fe.submit(z[: 1 + i % 4], "default")
            with rlock:
                rids.append(rid)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT_S)
        for rid in rids:
            fe.result(rid, timeout_s=WAIT_S)
        st = fe.stats()["tenants"]["default"]
        req = fe.metrics.counter("frontend.requests")
        assert req.value(tenant="default", outcome="admitted") == 8
        assert req.value(tenant="default", outcome="completed") == 8
        assert st["admitted"] == 8 and st["completed"] == 8
        lat = fe.metrics.histogram("frontend.request_latency_seconds")
        lsum = lat.merged_summary(tenant="default")
        assert lsum["count"] == 8
        assert lsum["mean"] == pytest.approx(st["mean_ms"] / 1e3, rel=1e-6)
        qw = fe.metrics.histogram("frontend.queue_wait_seconds")
        assert qw.merged_summary(tenant="default")["count"] == 8
        fe.reset_stats()
        assert req.total() == 0
        assert fe.stats()["tenants"]["default"]["admitted"] == 0
        assert fe.metrics.counter("engine.generate_calls").total() > 0
    finally:
        fe.close(timeout_s=WAIT_S)


def test_trace_covers_request_lifecycle(tiny, tmp_path):
    """One traced request renders admission -> queue wait -> wave
    dispatch -> per-bucket dispatch -> collect, under the reference's
    span names, with the dispatch nested in its wave."""
    params, z = tiny
    fe = AsyncServeFrontend({"fp32": _engine(params, buckets=(4,))},
                            [TenantClass("default", slo_ms=None)])
    trace.enable(clear=True)
    try:
        rid = fe.submit(z, "default")
        fe.result(rid, timeout_s=WAIT_S)
    finally:
        trace.disable()
        fe.close(timeout_s=WAIT_S)
    path = tmp_path / "t.json"
    tracer = trace.get_tracer()
    assert tracer.export(str(path)) == len(tracer.events())
    names = [e["name"] for e in tracer.events()]
    for expected in ("submit", "queue_wait", "wave_dispatch", "dispatch b4",
                     "generate", "collect"):
        assert expected in names, (expected, names)
    doc = json.loads(path.read_text())
    by_name = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            by_name.setdefault(ev["name"], ev)
    wave, disp = by_name["wave_dispatch"], by_name["dispatch b4"]
    assert wave["ts"] <= disp["ts"]
    assert wave["ts"] + wave["dur"] >= disp["ts"] + disp["dur"]
    assert disp["args"]["steady"] and not disp["args"]["retried"]
    qw = by_name["queue_wait"]
    assert qw["args"]["outcome"] == "dispatched"
    assert qw["ts"] + qw["dur"] <= disp["ts"] + disp["dur"]


def test_plan_build_span_recorded(tiny):
    params, _ = tiny
    trace.enable(clear=True)
    try:
        _engine(params, buckets=(2,))
    finally:
        trace.disable()
    names = [e["name"] for e in trace.get_tracer().events()]
    assert "plan_build b2" in names


# ---------------------------------------------------------------------------
# the engine's span tree, parents and requests, drops, the profiler mirror
# ---------------------------------------------------------------------------
def _traced(fn, profiler=False):
    """``fn()`` with the process tracer on (mirroring when ``profiler``),
    then its complete events."""
    trace.enable(clear=True, profiler=profiler)
    try:
        fn()
    finally:
        trace.disable()
    return [e for e in trace.get_tracer().events() if e["ph"] == "X"]


def _inside(child, parent):
    return (parent["ts"] <= child["ts"] and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"])


def _check_tree(events):
    """Every event names an existing parent (or none), lies inside it and
    carries its request; returns the events by id."""
    by_id = {e["id"]: e for e in events}
    assert len(by_id) == len(events)
    for e in events:
        if e["parent"] is None:
            continue
        parent = by_id[e["parent"]]
        assert _inside(e, parent), (e["name"], parent["name"])
        assert e["req"] == parent["req"]
    return by_id


def _children(by_id, parent):
    return sorted((e for e in by_id.values() if e["parent"] == parent["id"]),
                  key=lambda e: e["ts"])


def test_generate_records_the_span_tree(tiny):
    params, z = tiny
    eng = _engine(params, buckets=(4,))
    events = _traced(lambda: eng.generate(z))
    by_id = _check_tree(events)
    gen, = [e for e in events if e["name"] == "generate"]
    assert gen["parent"] is None and gen["req"] is not None
    assert gen["args"]["rows"] == 4
    assert [e["name"] for e in _children(by_id, gen)] == [
        "lock", "sync", "dispatch b4", "account", "account"]
    disp = by_id[_children(by_id, gen)[2]["id"]]
    assert disp["args"]["bucket"] == 4 and disp["args"]["steady"]
    assert not disp["args"]["retried"]
    # on the CPU the eager body takes the enqueue's place; no stream wait
    assert [e["name"] for e in _children(by_id, disp)] == ["stage", "enqueue"]
    assert all(e["req"] == gen["req"] for e in events)
    # a second request gets a number of its own
    again = _traced(lambda: eng.generate(z[:2]))
    assert {e["req"] for e in again} == {again[-1]["req"]} != {gen["req"]}


def test_two_chunk_request_concatenates_inside_generate(tiny):
    params, z = tiny
    eng = _engine(params)
    rows = np.concatenate([z, z[:2]])
    events = _traced(lambda: eng.generate(rows))
    by_id = _check_tree(events)
    gen, = [e for e in events if e["name"] == "generate"]
    names = [e["name"] for e in _children(by_id, gen)]
    assert names == ["lock", "sync", "dispatch b4", "account",
                     "lock", "sync", "dispatch b2", "account",
                     "account", "concat"]
    concat = _children(by_id, gen)[-1]
    assert _inside(concat, gen)


def test_disabled_tracer_records_nothing_and_opens_no_range(tiny):
    from torch.profiler import ProfilerActivity, profile

    params, z = tiny
    eng = _engine(params, buckets=(4,))
    tracer = trace.get_tracer()
    trace.enable(clear=True, profiler=True)
    trace.disable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.generate(z)
    assert len(tracer) == 0 and tracer.dropped == 0
    spans = {"generate", "lock", "sync", "dispatch b4", "stage", "enqueue",
             "account"}
    assert not [e.name for e in prof.events() if e.name in spans]


def test_dropped_counts_what_the_ring_pushes_out():
    t = trace.Tracer(capacity=4, enabled=True)
    for i in range(10):
        with t.span(f"s{i}"):
            pass
    assert len(t) == 4 and t.dropped == 6
    assert [e["name"] for e in t.events()] == ["s6", "s7", "s8", "s9"]
    t.instant("i")
    assert t.dropped == 7
    t.clear()
    assert len(t) == 0 and t.dropped == 0


def test_parents_and_requests_across_styles():
    t = trace.Tracer(enabled=True)
    with t.span("outer", req=7):
        with t.span("inner"):
            t0 = clock.now()
            t.complete("done", t0, t0)
        h = t.begin("handed")
    t.end(h)
    with t.span("alone"):
        pass
    ev = {e["name"]: e for e in t.events()}
    assert ev["outer"]["parent"] is None and ev["outer"]["req"] == 7
    assert ev["inner"]["parent"] == ev["outer"]["id"]
    assert ev["done"]["parent"] == ev["inner"]["id"]
    assert ev["handed"]["parent"] == ev["outer"]["id"]
    assert {ev[n]["req"] for n in ("inner", "done", "handed")} == {7}
    assert ev["alone"]["parent"] is None and ev["alone"]["req"] is None
    assert len({e["id"] for e in t.events()}) == 5


@pytest.mark.parametrize("profiler", [True, False])
def test_profiler_mirror_of_scoped_spans(tiny, profiler):
    """With the mirror, a CPU profiler sees a range of each scoped span's
    name, nested as the spans are; without it, none."""
    from torch.profiler import ProfilerActivity, profile

    params, z = tiny
    eng = _engine(params, buckets=(4,))

    def serve():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.generate(z)
        serve.events = prof.events()

    spans = _traced(serve, profiler=profiler)
    names = {e["name"] for e in spans}
    ranges = [e for e in serve.events if e.name in names]
    if not profiler:
        assert not ranges
        return
    assert sorted(e.name for e in ranges) == sorted(e["name"] for e in spans)
    parent_of = {e["id"]: e["parent"] for e in spans}
    name_of = {e["id"]: e["name"] for e in spans}
    want = sorted((e["name"], name_of.get(parent_of[e["id"]]))
                  for e in spans)
    got = sorted((r.name, r.cpu_parent.name if r.cpu_parent else None)
                 for r in ranges)
    assert got == want
    by_name = {r.name: r for r in ranges}
    gen, disp = by_name["generate"], by_name["dispatch b4"]
    for child in ("stage", "enqueue"):
        r = by_name[child]
        assert (disp.time_range.start <= r.time_range.start
                and r.time_range.end <= disp.time_range.end)
    assert (gen.time_range.start <= disp.time_range.start
            and disp.time_range.end <= gen.time_range.end)
