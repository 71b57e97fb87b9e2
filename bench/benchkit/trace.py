"""The device trace of a steady stretch of the window, reduced to what the
per-layer metrics read.

`Stretch` runs ``torch.profiler`` (CPU and CUDA activities) over whole
requests of the window: it starts and stops between two requests, when
the card is idle.  `reduce` turns the raw records into a `TraceReading`:
device time by kind (the system's main kernel, the host-device copies,
everything else), the busy time as the union of the device operations,
and the idle gaps, each labelled with the host spans it fell in (the
harness's requests and loop, the program's own spans, the profiler's host
operations).  A stretch whose trace lacks main-kernel launches (the
profiler can lose records) is refused with `IncompleteTrace`: no share is
ever read from a partial trace."""
from __future__ import annotations

import collections
import dataclasses
import re
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

TOP = 10
# device records of waits, not work (CUPTI's synchronization activities)
_SYNC = re.compile(r"^\w+ Sync\b")


class IncompleteTrace(RuntimeError):
    """The trace holds another number of main-kernel launches than the
    stretch's dispatches made."""


@dataclasses.dataclass(frozen=True)
class Span:
    """An interval on the trace's clock (ns) with a name."""
    name: str
    start: int
    end: int


@dataclasses.dataclass
class TraceReading:
    window_s: float
    busy_s: float
    images: int
    dispatches: List[int]
    main_s: float
    copy_s: float
    other_s: float
    main_launches: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0].strip()[:96]


def device_kind(name: str, main: re.Pattern) -> str:
    """``"main"`` (the system's main kernel), ``"copy"`` (a host-device
    copy either way) or ``"other"`` (every other kernel, a memset, a copy
    within the device)."""
    if name.startswith("Memcpy HtoD") or name.startswith("Memcpy DtoH"):
        return "copy"
    if main.search(name):
        return "main"
    return "other"


def union_ns(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps_ns(intervals: Iterable[Tuple[int, int]], lo: int,
            hi: int) -> List[Tuple[int, int]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def label_gaps(gaps: Sequence[Tuple[int, int]],
               spans: Sequence[Span]) -> List[Tuple[str, int]]:
    """Each gap with the names of the host spans open at its middle, outer
    first (``"request > generate > dispatch b64 > cudaGraphLaunch"``)."""
    spans = sorted(spans, key=lambda s: s.start)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    labels: List[Optional[Tuple[str, int]]] = [None] * len(gaps)
    active: List[Span] = []
    j = 0
    for i in order:
        a, b = gaps[i]
        mid = (a + b) // 2
        while j < len(spans) and spans[j].start <= mid:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s.end > mid]
        chain = sorted(active, key=lambda s: (s.start, -s.end))
        labels[i] = (" > ".join(s.name for s in chain) or "no host span",
                     b - a)
    return labels


def top(pairs: Iterable[Tuple[str, float]], n: int = TOP):
    """The ``n`` names with the most summed value, largest first."""
    acc: Dict[str, float] = collections.defaultdict(float)
    for name, v in pairs:
        acc[name] += v
    return sorted(acc.items(), key=lambda kv: -kv[1])[:n]


def reduce(events, offset_ns: int, requests: Sequence[Tuple[int, int, int]],
           program_spans: Sequence[Span], dispatches: List[int],
           main: re.Pattern, launches_per_dispatch: int) -> TraceReading:
    """``events``: the profiler's raw records (``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``).  ``requests``:
    ``(start, end, rows)`` of each request in the stretch on this
    process's ``perf_counter_ns`` clock;
    ``program_spans`` on that clock too; ``offset_ns`` takes that clock to
    the trace's."""
    import torch

    lo = requests[0][0] + offset_ns
    hi = requests[-1][1] + offset_ns
    device, host = [], []
    for e in events:
        start = e.start_ns()
        end = start + max(e.duration_ns(), 0)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _SYNC.match(e.name()):
                continue
            device.append((e.name(), start, end))
        elif end > start:
            host.append(Span(e.name(), start, end))
    host += [Span("request", a + offset_ns, b + offset_ns)
             for a, b, _ in requests]
    host += [Span("harness loop", b0 + offset_ns, a1 + offset_ns)
             for (_, b0, _), (a1, _, _) in zip(requests, requests[1:])]
    host += [Span(s.name, s.start + offset_ns, s.end + offset_ns)
             for s in program_spans]
    seconds = {"main": 0, "copy": 0, "other": 0}
    launches = 0
    named = []
    for name, a, b in device:
        kind = device_kind(name, main)
        seconds[kind] += b - a
        launches += kind == "main"
        named.append((short_name(name), (b - a) / 1e9))
    expect = launches_per_dispatch * len(dispatches)
    if launches != expect:
        raise IncompleteTrace(
            f"the trace holds {launches} main-kernel launches; the stretch's "
            f"{len(dispatches)} dispatches made {expect}")
    spans = [(a, b) for _, a, b in device]
    gaps = gaps_ns(spans, lo, hi)
    return TraceReading(
        window_s=(hi - lo) / 1e9, busy_s=union_ns(spans, lo, hi) / 1e9,
        images=sum(n for _, _, n in requests), dispatches=dispatches,
        main_s=seconds["main"] / 1e9, copy_s=seconds["copy"] / 1e9,
        other_s=seconds["other"] / 1e9, main_launches=launches,
        device_ops=top(named),
        idle_gaps=top((lab, ns / 1e9) for lab, ns in label_gaps(gaps, host)))


class Stretch:
    """``torch.profiler`` over a stretch of whole requests; `warm` once in
    set-up so that the profiler's own start-up stays out of the window."""

    def __init__(self):
        self._prof = None
        self.offset_ns = 0

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self, fn) -> None:
        prof = self._profile()
        prof.start()
        fn()
        prof.stop()

    def start(self) -> None:
        from torch.profiler import record_function

        self._prof = self._profile()
        self._prof.start()
        with record_function("bench.clock"):
            self._clock_ns = time.perf_counter_ns()

    def stop(self):
        """The raw records, with `offset_ns` set from the clock mark."""
        import torch

        torch.cuda.synchronize()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == "bench.clock")
        self.offset_ns = mark.start_ns() - self._clock_ns
        self._prof = None
        return events
