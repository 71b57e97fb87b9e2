"""Deterministic fault injection for the serving stack.

A `FaultInjector` is a scripted schedule over *bucket dispatches*: the
serving engine calls `before_call` immediately before every generator
dispatch (warmup calls excluded), and whatever is scripted for that
global call index fires — a sleep (`SlowCall`, a straggler the
`StragglerMonitor` should flag), a raised `TransientCallError`
(retryable: the engine backs off and re-dispatches), or a raised
`DeviceLossError` (not retryable: the JAX package's engine shrinks onto
the surviving device prefix via an elastic remesh; the port's engine,
on one device, has nothing to shrink onto and fails typed,
`serve.errors.EngineDegraded`).

Everything is counted, not timed, so a fault sequence replays
identically across runs — the property that turns "fail call k" from a
flake into an assertable scenario.  A copy of the JAX package's
``dist/inject.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Tuple


class FaultError(RuntimeError):
    """Base class for injected (or detected) serving-call faults."""


class TransientCallError(FaultError):
    """A retryable per-call failure — the moral equivalent of a dropped
    RPC or a preempted dispatch.  The engine retries with backoff."""


class DeviceLossError(FaultError):
    """``keep`` devices survive (the leading prefix of the mesh's device
    list); the rest are gone.  The engine answers with an elastic
    remesh, not a retry — the failed dispatch re-runs on the shrunken
    mesh."""

    def __init__(self, keep: int, message: str = ""):
        super().__init__(
            message or f"device loss: {keep} device(s) survive")
        self.keep = keep


@dataclasses.dataclass(frozen=True)
class SlowCall:
    """Delay call ``at_call`` by ``delay_s`` — a straggler, not an error."""
    at_call: int
    delay_s: float


@dataclasses.dataclass(frozen=True)
class TransientFailure:
    """Fail call ``at_call`` with `TransientCallError` (fires once; the
    retry is a new call index, so consecutive indices model a repeated
    failure)."""
    at_call: int


@dataclasses.dataclass(frozen=True)
class DeviceLoss:
    """At call ``at_call``, lose every device but the first ``keep``."""
    at_call: int
    keep: int


class FaultInjector:
    """Replayable fault script, indexed by global dispatch count.

    ``calls`` is the number of dispatches seen so far; ``log`` records
    every fault that fired as ``(call_index, fault)``.  Faults may be
    passed at construction or armed later with `schedule` —
    ``schedule(DeviceLoss(at_call=inj.calls, keep=4))`` fires at the
    NEXT dispatch, which is how the degraded-mode bench injects a loss
    "now" after a warm-up phase of unknown call count."""

    def __init__(self, faults: Sequence = ()):
        self.calls = 0
        self.log: List[Tuple[int, object]] = []
        self._scripted: Dict[int, List[object]] = {}
        for f in faults:
            self.schedule(f)

    def schedule(self, fault) -> None:
        self._scripted.setdefault(fault.at_call, []).append(fault)

    def before_call(self, bucket: int) -> None:
        """Engine hook: fire whatever is scripted for this dispatch."""
        idx = self.calls
        self.calls += 1
        for f in self._scripted.get(idx, ()):
            self.log.append((idx, f))
            if isinstance(f, SlowCall):
                time.sleep(f.delay_s)
            elif isinstance(f, TransientFailure):
                raise TransientCallError(
                    f"injected transient failure at call {idx} "
                    f"(bucket {bucket})")
            elif isinstance(f, DeviceLoss):
                raise DeviceLossError(
                    f.keep,
                    f"injected device loss at call {idx}: "
                    f"{f.keep} device(s) survive")
            else:
                raise TypeError(f"unknown fault {f!r}")
