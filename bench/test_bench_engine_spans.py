"""The engine metrics read from the program's tracer: host time per
dispatch (``generate`` less ``wait``) and the synchronise per dispatch,
on synthetic spans; no reading without a trace, with events dropped, or
where the spans and the stretch's dispatches disagree."""
import types

import pytest

from benchkit import spec
from repro_torch.obs import trace

CELLS = ("celeba.batch64", "mnist.batch64", "celeba.single", "celeba.mixed")
METRICS = ("engine.host_us_per_dispatch", "engine.sync_us_per_dispatch")


@pytest.fixture
def tracer(monkeypatch):
    """A fresh process tracer (the readers read `trace.get_tracer()`)."""
    t = trace.Tracer(capacity=64)
    monkeypatch.setattr(trace, "_tracer", t)
    return t


def readers():
    return {name: spec.load_module("metrics", name).read for name in METRICS}


def record(t, requests):
    """Each request ``(generate_us, [(sync_us, wait_us), ...])`` recorded
    as the engine names its spans: ``generate``, and per dispatch
    ``sync``, ``dispatch b64`` and ``wait``."""
    t.clear()
    t.enable()
    for gen_us, dispatches in requests:
        t.complete("generate", 0.0, gen_us * 1e-6)
        for sync_us, wait_us in dispatches:
            t.complete("sync", 0.0, sync_us * 1e-6)
            t.complete("dispatch b64", 0.0, (wait_us + 5) * 1e-6)
            t.complete("wait", 0.0, wait_us * 1e-6)
    t.instant("straggler")
    t.disable()


def run_with(dispatches):
    return types.SimpleNamespace(
        trace=None if dispatches is None else
        types.SimpleNamespace(dispatches=[64] * dispatches))


def test_values_per_dispatch(tracer):
    record(tracer, [(300.0, [(20.0, 100.0)]),
                    (500.0, [(30.0, 120.0), (10.0, 80.0)])])
    got = {name: read(run_with(3)) for name, read in readers().items()}
    assert got["engine.host_us_per_dispatch"] == pytest.approx(
        (300 + 500 - (100 + 120 + 80)) / 3)
    assert got["engine.sync_us_per_dispatch"] == pytest.approx(
        (20 + 30 + 10) / 3)


@pytest.mark.parametrize("case", ["no_trace", "dropped", "fewer_spans",
                                  "more_spans", "no_drop_count"])
def test_no_reading(tracer, monkeypatch, case):
    requests = [(300.0, [(20.0, 100.0)])] * 4
    dispatches = 4
    if case == "no_trace":
        dispatches = None
    elif case == "dropped":
        monkeypatch.setattr(trace, "_tracer", trace.Tracer(capacity=8))
        tracer = trace.get_tracer()
    elif case == "fewer_spans":
        dispatches = 5
    elif case == "more_spans":
        dispatches = 3
    record(tracer, requests)
    if case == "dropped":
        assert tracer.dropped > 0
    elif case == "no_drop_count":
        # a program whose tracer counts no drops records no span tree
        monkeypatch.setattr(trace, "_tracer", types.SimpleNamespace(
            events=tracer.events))
    for name, read in readers().items():
        assert read(run_with(dispatches)) is None, name


def test_benchmark_lists_both_metrics_in_every_cell():
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        m = entries[name]
        assert m["unit"] == "us/dispatch" and m["better"] == "lower"
        assert m["source"] == "program_counter"
        assert m["layer"] == "serve engine"
        assert m["moves"] == "images_per_s"
        assert tuple(m["workloads"]) == CELLS
    assert list(entries)[-2:] == list(METRICS)
    for cell in CELLS:
        got = {m["name"] for m in spec.find_cell(bench, cell).per_layer}
        assert set(METRICS) <= got
