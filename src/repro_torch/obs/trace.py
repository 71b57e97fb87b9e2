"""Lightweight span tracing with a Chrome/Perfetto ``trace_event`` exporter.

A request's whole life — admission → EDF queue wait → wave dispatch →
per-bucket kernel call → collect — renders as one timeline in
https://ui.perfetto.dev (or chrome://tracing), with fault-injection
retries, stragglers, heartbeat fires and elastic-remesh events as
instant markers.

Design constraints, in order:

* **near-zero overhead when disabled** — the hot path is one attribute
  read; :meth:`Tracer.span` returns a shared null singleton (`NULL`, no
  allocation), :meth:`Tracer.complete`/:meth:`Tracer.instant` return
  immediately.  A call site that would build an argument dict, an
  f-string name or a label merge checks :attr:`Tracer.enabled` first.
* **monotonic-clock only** — all timestamps come from
  :func:`repro_torch.obs.clock.now`; wall-clock never leaks into a trace.
* **ring-buffered** — a bounded ``deque`` keeps the newest ``capacity``
  events; a long soak can stay traced without growing memory.  Every
  event pushed out of the ring is counted in :attr:`Tracer.dropped`, so a
  reader can tell a whole record from a truncated one.

Three recording styles cover the serve stack's shapes:

* ``with tracer.span("generate", rows=n):`` — scoped work on one thread.
* ``h = tracer.begin("queue_wait"); ... tracer.end(h)`` — spans that
  start on one thread (submit) and finish on another (worker).
* ``tracer.complete(name, t0, t1)`` — retroactive, for code that already
  timed itself.

**Parents and requests.**  While enabled, the tracer keeps a stack of the
open scoped spans of each thread.  Every complete (``"X"``) event carries
``id`` (its own, unique in the process), ``parent`` (the ``id`` of the
scoped span open around it on its thread, or None) and ``req`` (the
request number given to the span, or else its parent's: the serve engine
numbers each ``generate``, and every span inside it carries that number).
A begin/end span takes its parent and request on the thread that began it.

**One clock with the device trace.**  ``enable(profiler=True)`` mirrors
every scoped span as a ``torch.profiler.record_function`` range of the
same name, opened around the span while a profiler records (and not
opened otherwise).  The program's host phases then sit in any
``torch.profiler`` trace an operator takes, on the profiler's own clock,
beside the CUDA runtime calls and device operations they issue::

    from repro_torch.obs import trace
    trace.enable(clear=True, profiler=True)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        engine.generate(z)
    prof.export_chrome_trace("serve.json")  # "sync", "enqueue", "wait", ...

The mirror is off by default: a profiled run whose own labels come from
the tracer's events would otherwise see every phase twice.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from . import clock

__all__ = ["Tracer", "get_tracer", "enable", "disable", "NULL"]

# the densest benchmark stretch (one-row requests, ~9 events each, ~3 k
# requests a second, 2 s) holds ~55 k events
DEFAULT_CAPACITY = 1 << 17


class _NullSpan:
    """Shared no-op span/handle returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL = _NullSpan()


class _Stack(threading.local):
    """The open scoped spans of one thread, innermost last."""

    def __init__(self) -> None:
        self.spans: List["_Span"] = []


class _Span:
    """Context-manager span; records one complete event on exit if the
    tracer is still enabled.  On entry it takes a new id, its parent (the
    innermost open span of the thread) and its request (its own, else the
    parent's), and opens its profiler range where the tracer mirrors."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "id",
                 "parent", "req", "_range")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 req: Optional[int], args: dict) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0
        self.id = 0
        self.parent: Optional[int] = None
        self.req = req
        self._range = None

    def __enter__(self) -> "_Span":
        tracer = self._tracer
        stack = tracer._stack.spans
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.req is None:
                self.req = top.req
        self.id = next(tracer._ids)
        stack.append(self)
        self._range = tracer._open_range(self._name)
        self._t0 = clock.now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = clock.now()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        stack = self._tracer._stack.spans
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if not self._tracer._enabled:
            return False
        if exc_type is not None:
            self._args["error"] = exc_type.__name__
        self._tracer._record("X", self._name, self._cat, self._t0, t1,
                             self._args, (self.id, self.parent, self.req))
        return False


class SpanHandle:
    """Explicit begin/end handle; may be ended from a different thread."""

    __slots__ = ("name", "cat", "args", "t0", "ident", "tname", "parent",
                 "req")

    def __init__(self, name: str, cat: str, args: dict, t0: float,
                 ident: int, tname: str, parent: Optional[int] = None,
                 req: Optional[int] = None) -> None:
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = t0
        self.ident = ident
        self.tname = tname
        self.parent = parent
        self.req = req


class Tracer:
    """Ring-buffered span recorder emitting Chrome ``trace_event`` JSON."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = False) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._dropped = 0
        # OS thread ident -> (small display tid, thread name at first record)
        self._tids: Dict[int, Tuple[int, str]] = {}
        self._ids = itertools.count(1)
        self._stack = _Stack()
        # (record_function, profiler_enabled) while mirroring, else None
        self._mirror = None
        self._enabled = bool(enabled)

    # -- enable/disable: plain flag writes, deliberately lock-free so the
    # -- disabled fast path is a single unguarded attribute read
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, profiler: bool = False) -> None:
        """Start recording; ``profiler=True`` also mirrors each scoped span
        as a ``torch.profiler.record_function`` range while a profiler
        records (off unless asked for at each enable)."""
        mirror = None
        if profiler:
            from torch._C._autograd import _profiler_enabled
            from torch.autograd.profiler import record_function

            mirror = (record_function, _profiler_enabled)
        self._mirror = mirror
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def _open_range(self, name: str):
        """The profiler range mirroring a span of ``name``, entered, or
        None when not mirroring or no profiler records."""
        mirror = self._mirror
        if mirror is None or not mirror[1]():
            return None
        rng = mirror[0](name)
        rng.__enter__()
        return rng

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "serve", req: Optional[int] = None,
             **args: object):
        """Scoped span; returns the shared `NULL` while disabled.  ``req``
        numbers the request the span serves (inherited from the parent
        when None)."""
        if not self._enabled:
            return NULL
        return _Span(self, name, cat, req, args)

    def _enclosing(self, req: Optional[int]):
        """``(parent id, request)`` for an event recorded now on this
        thread."""
        stack = self._stack.spans
        if not stack:
            return None, req
        top = stack[-1]
        return top.id, top.req if req is None else req

    def begin(self, name: str, cat: str = "serve",
              req: Optional[int] = None, **args: object):
        """Start a span that may be ended from another thread."""
        if not self._enabled:
            return NULL
        th = threading.current_thread()
        parent, req = self._enclosing(req)
        return SpanHandle(name, cat, args, clock.now(), th.ident or 0,
                          th.name, parent, req)

    def end(self, handle, **extra: object) -> None:
        """Finish a :meth:`begin` handle; attributed to the begin thread."""
        if handle is None or handle is NULL or not self._enabled:
            return
        t1 = clock.now()
        args = dict(handle.args)
        args.update(extra)
        self._record("X", handle.name, handle.cat, handle.t0, t1, args,
                     (next(self._ids), handle.parent, handle.req),
                     handle.ident, handle.tname)

    def complete(self, name: str, t0: float, t1: float, cat: str = "serve",
                 req: Optional[int] = None, **args: object) -> None:
        """Record an already-timed span retroactively (current thread)."""
        if not self._enabled:
            return
        parent, req = self._enclosing(req)
        self._record("X", name, cat, t0, t1, args,
                     (next(self._ids), parent, req))

    def instant(self, name: str, cat: str = "serve", **args: object) -> None:
        """Thread-scoped instant marker (retries, remesh, sheds...)."""
        if not self._enabled:
            return
        t = clock.now()
        self._record("i", name, cat, t, t, args)

    def _record(self, ph: str, name: str, cat: str, t0: float, t1: float,
                args: dict, ids: Optional[tuple] = None,
                ident: Optional[int] = None,
                tname: Optional[str] = None) -> None:
        if ident is None:
            th = threading.current_thread()
            ident, tname = th.ident or 0, th.name
        ev = {"ph": ph, "name": name, "cat": cat, "ts": t0 * 1e6,
              "args": args}
        if ph == "X":
            ev["dur"] = max(t1 - t0, 0.0) * 1e6
            ev["id"], ev["parent"], ev["req"] = ids
        else:
            ev["s"] = "t"
        with self._lock:
            ev["tid"] = self._tid_locked(ident, tname)
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)

    def _tid_locked(self, ident: int, tname: str) -> int:
        # small stable display ids beat raw pthread idents in the UI
        entry = self._tids.get(ident)
        if entry is None:
            entry = (len(self._tids) + 1, tname)
            self._tids[ident] = entry
        return entry[0]

    # -- inspection / export ------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        """Events pushed out of the ring since the last `clear`."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._tids.clear()
            self._dropped = 0

    def to_chrome(self) -> dict:
        """Chrome/Perfetto ``trace_event`` document (JSON object format);
        every event gets this process's ``pid`` here, not when recorded
        (a system call on the hot path)."""
        pid = os.getpid()
        with self._lock:
            events = [dict(ev, pid=pid) for ev in self._events]
            tids = dict(self._tids)
        meta: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "repro-serve"}}]
        for tid, tname in sorted(tids.values()):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": tname}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the trace JSON; returns the number of non-meta events."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return sum(1 for ev in doc["traceEvents"] if ev["ph"] != "M")


_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer the serve stack records into."""
    return _tracer


def enable(clear: bool = False, profiler: bool = False) -> Tracer:
    """Turn on the global tracer (optionally dropping old events);
    ``profiler=True`` mirrors its scoped spans into ``torch.profiler``."""
    if clear:
        _tracer.clear()
    _tracer.enable(profiler=profiler)
    return _tracer


def disable() -> Tracer:
    _tracer.disable()
    return _tracer
