"""Lightweight span tracing with a Chrome/Perfetto ``trace_event`` exporter.

A request's whole life — admission → EDF queue wait → wave dispatch →
per-bucket kernel call → collect — renders as one timeline in
https://ui.perfetto.dev (or chrome://tracing), with fault-injection
retries, stragglers, heartbeat fires and elastic-remesh events as
instant markers.

Design constraints, in order:

* **near-zero overhead when disabled** — the hot path is one attribute
  read; :meth:`Tracer.span` returns a shared null singleton (no
  allocation), :meth:`Tracer.complete`/:meth:`Tracer.instant` return
  immediately.
* **monotonic-clock only** — all timestamps come from
  :func:`repro_torch.obs.clock.now`; wall-clock never leaks into a trace.
* **ring-buffered** — a bounded ``deque`` keeps the newest ``capacity``
  events; a long soak can stay traced without growing memory.

Three recording styles cover the serve stack's shapes:

* ``with tracer.span("generate", rows=n):`` — scoped work on one thread.
* ``h = tracer.begin("queue_wait"); ... tracer.end(h)`` — spans that
  start on one thread (submit) and finish on another (worker).
* ``tracer.complete(name, t0, t1)`` — retroactive, for code that already
  timed itself (dispatch retries keep their own ``t0``).
"""
from __future__ import annotations

import collections
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from . import clock

__all__ = ["Tracer", "get_tracer", "enable", "disable"]


class _NullSpan:
    """Shared no-op span/handle returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


class _Span:
    """Context-manager span; records one complete event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: dict) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = clock.now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._args["error"] = exc_type.__name__
        self._tracer.complete(self._name, self._t0, clock.now(),
                              cat=self._cat, **self._args)
        return False


class SpanHandle:
    """Explicit begin/end handle; may be ended from a different thread."""

    __slots__ = ("name", "cat", "args", "t0", "ident", "tname")

    def __init__(self, name: str, cat: str, args: dict, t0: float,
                 ident: int, tname: str) -> None:
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = t0
        self.ident = ident
        self.tname = tname


class Tracer:
    """Ring-buffered span recorder emitting Chrome ``trace_event`` JSON."""

    def __init__(self, capacity: int = 65536, enabled: bool = False) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=capacity)
        # OS thread ident -> (small display tid, thread name at first record)
        self._tids: Dict[int, Tuple[int, str]] = {}
        self._enabled = bool(enabled)

    # -- enable/disable: plain flag writes, deliberately lock-free so the
    # -- disabled fast path is a single unguarded attribute read
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "serve", **args: object):
        """Scoped span; returns a shared null object while disabled."""
        if not self._enabled:
            return _NULL
        return _Span(self, name, cat, dict(args))

    def begin(self, name: str, cat: str = "serve", **args: object):
        """Start a span that may be ended from another thread."""
        if not self._enabled:
            return _NULL
        th = threading.current_thread()
        return SpanHandle(name, cat, dict(args), clock.now(),
                          th.ident or 0, th.name)

    def end(self, handle, **extra: object) -> None:
        """Finish a :meth:`begin` handle; attributed to the begin thread."""
        if handle is None or handle is _NULL or not self._enabled:
            return
        t1 = clock.now()
        args = dict(handle.args)
        args.update(extra)
        self._record("X", handle.name, handle.cat, handle.t0, t1,
                     handle.ident, handle.tname, args)

    def complete(self, name: str, t0: float, t1: float, cat: str = "serve",
                 **args: object) -> None:
        """Record an already-timed span retroactively (current thread)."""
        if not self._enabled:
            return
        th = threading.current_thread()
        self._record("X", name, cat, t0, t1, th.ident or 0, th.name,
                     dict(args))

    def instant(self, name: str, cat: str = "serve", **args: object) -> None:
        """Thread-scoped instant marker (retries, remesh, sheds...)."""
        if not self._enabled:
            return
        th = threading.current_thread()
        t = clock.now()
        self._record("i", name, cat, t, t, th.ident or 0, th.name,
                     dict(args))

    def _record(self, ph: str, name: str, cat: str, t0: float, t1: float,
                ident: int, tname: str, args: dict) -> None:
        ev = {"ph": ph, "name": name, "cat": cat, "ts": t0 * 1e6,
              "pid": os.getpid(), "args": args}
        if ph == "X":
            ev["dur"] = max(t1 - t0, 0.0) * 1e6
        else:
            ev["s"] = "t"
        with self._lock:
            ev["tid"] = self._tid_locked(ident, tname)
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

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._tids.clear()

    def to_chrome(self) -> dict:
        """Chrome/Perfetto ``trace_event`` document (JSON object format)."""
        with self._lock:
            events = list(self._events)
            tids = dict(self._tids)
        pid = os.getpid()
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


def enable(clear: bool = False) -> Tracer:
    """Turn on the global tracer (optionally dropping old events)."""
    if clear:
        _tracer.clear()
    _tracer.enable()
    return _tracer


def disable() -> Tracer:
    _tracer.disable()
    return _tracer
