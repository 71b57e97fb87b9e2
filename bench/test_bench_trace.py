"""The reduction of a device trace: time by kind, busy time, idle gaps by
host span, and the refusal of a trace that lost launches."""
import re

import pytest
import torch

from benchkit import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
MAIN = re.compile(r"deconv2d_tc_kernel")
OFFSET = 1_000_000          # perf_counter_ns + OFFSET == the trace's clock


class Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def dispatch(t):
    """One dispatch's device work from ``t`` (trace clock), 100 ns apart."""
    k = "void (anonymous namespace)::deconv2d_tc_kernel<false, 2, 4>(float)"
    return [Ev("Memcpy HtoD (Pinned -> Device)", CUDA, t, 10),
            Ev(k, CUDA, t + 100, 300),
            Ev(k, CUDA, t + 500, 300),
            Ev("void at::native::elementwise_kernel<128>(int)", CUDA,
               t + 900, 50),
            Ev("Memcpy DtoH (Device -> Pinned)", CUDA, t + 1000, 20),
            Ev("Stream Sync", CUDA, t + 1020, 500),
            Ev("cudaGraphLaunch", CPU, t + 20, 60)]


def reading(drop=0):
    events = dispatch(OFFSET + 1000) + dispatch(OFFSET + 3000)
    if drop:
        events = [e for e in events if not MAIN.search(e.name())][:drop] + [
            e for e in events if MAIN.search(e.name())][drop:]
    requests = [(1000, 2100, 64), (3000, 4100, 64)]
    spans = [trace.Span("generate", 1000, 2100),
             trace.Span("generate", 3000, 4100)]
    return trace.reduce(events, OFFSET, requests, spans, [64, 64], MAIN, 2)


def test_device_time_by_kind_and_busy_share():
    r = reading()
    assert r.main_launches == 4
    assert r.main_s == pytest.approx(1200e-9)
    assert r.copy_s == pytest.approx(60e-9)
    assert r.other_s == pytest.approx(100e-9)
    assert r.images == 128 and r.dispatches == [64, 64]
    assert r.window_s == pytest.approx(3100e-9)
    assert r.busy_s == pytest.approx(2 * 680e-9)
    assert r.device_ops[0] == ("deconv2d_tc_kernel<false, 2, 4>",
                               pytest.approx(1200e-9))


def test_idle_gaps_carry_the_host_spans_they_fall_in():
    gaps = dict(reading().idle_gaps)
    assert gaps["request > generate > cudaGraphLaunch"] == pytest.approx(
        2 * 90e-9)
    # a gap is labelled by its middle: the one between the requests
    assert gaps["harness loop"] == pytest.approx(980e-9)
    assert gaps["request > generate"] == pytest.approx(2 * 250e-9 + 80e-9)
    assert sum(gaps.values()) == pytest.approx(3100e-9 - 2 * 680e-9)


def test_a_trace_that_lost_a_launch_is_refused():
    with pytest.raises(trace.IncompleteTrace):
        reading(drop=1)


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36)]
    assert trace.union_ns(iv, 0, 50) == 30
    assert trace.union_ns(iv, 8, 32) == 14
    assert trace.gaps_ns(iv, 0, 50) == [(20, 30), (40, 50)]
    assert trace.gaps_ns(iv, -5, 38) == [(-5, 0), (20, 30)]
    assert trace.top([("a", 1.0), ("b", 3.0), ("a", 2.5)], 1) == [("a", 3.5)]


def test_short_names_drop_namespaces_and_arguments():
    assert trace.short_name(
        "void (anonymous namespace)::deconv2d_tc_kernel<true, 1, 2>("
        "float const*, int)") == "deconv2d_tc_kernel<true, 1, 2>"
    assert trace.short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert trace.device_kind("Memcpy DtoD (Device -> Device)", MAIN) == "other"
