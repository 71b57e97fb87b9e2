"""Deadline-aware scheduling for the async serving frontend.

Two pieces, both deliberately engine-agnostic and side-effect free so
they are unit-testable without a worker thread:

* `ServiceModel` — per (precision, bucket) service-time estimates: an
  EMA over measured dispatch wall clocks, seeded from the engine's own
  monitors (`DcnnServeEngine.service_estimate`, i.e. the per-bucket
  `dist.fault.StragglerMonitor` EMAs and the healthy `bucket_stats`
  means).  This is the shared capacity signal: admission control asks it
  "can this request make its SLO at all?", the scheduler asks "at which
  precision?", and the frontend scales it down when a device-loss remesh
  shrinks the mesh.
* `EdfScheduler` — earliest-deadline-first within tenant priority class:
  requests order by (tenant priority, absolute deadline, arrival), and
  per request the scheduler picks the cheapest acceptable *precision* —
  fp32 when its predicted completion meets the deadline, the pinned int8
  plan chain when only the quantized path can make it (graceful
  degradation: reduced-precision deconv is the lever traded for latency,
  per "Hardware-Efficient Deconvolution-Based GAN for Edge Computing"),
  and None when even int8 would bust the SLO — the caller sheds typed
  instead of burning device time on a guaranteed deadline miss.

A copy of the JAX package's ``serve/scheduler.py``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

FP32 = "fp32"
INT8 = "int8"


class ServiceModel:
    """Per (precision, bucket) dispatch-time estimates.

    ``observe`` feeds measured wall clocks (EMA, recent-weighted);
    ``override`` pins an estimate exactly (tests and benches make
    scheduling decisions deterministic with it); ``scale`` multiplies
    every estimate — the capacity-shrink lever the frontend pulls after
    an elastic remesh (half the devices ≈ double the per-dispatch time
    until fresh measurements take over).  Thread-safe: the worker
    observes while callers' admission checks read."""

    def __init__(self, decay: float = 0.6):
        self.decay = decay
        self._est: Dict[Tuple[str, int], float] = {}
        self._lock = threading.Lock()

    def observe(self, precision: str, bucket: int, seconds: float) -> None:
        with self._lock:
            key = (precision, int(bucket))
            prev = self._est.get(key)
            self._est[key] = (seconds if prev is None
                              else self.decay * prev
                              + (1.0 - self.decay) * seconds)

    def override(self, precision: str, bucket: int, seconds: float) -> None:
        with self._lock:
            self._est[(precision, int(bucket))] = float(seconds)

    def scale(self, factor: float) -> None:
        with self._lock:
            for k in self._est:
                self._est[k] *= factor

    def estimate(self, precision: str, bucket: int) -> Optional[float]:
        with self._lock:
            return self._est.get((precision, int(bucket)))

    def seed_from_engine(self, precision: str, engine) -> None:
        """Pull whatever the engine already learned (straggler EMAs /
        healthy bucket means) without overwriting fresher local data."""
        with self._lock:
            for b in engine.buckets:
                est = engine.service_estimate(b)
                if est is not None:
                    self._est.setdefault((precision, int(b)), est)

    def snapshot(self) -> Dict[str, float]:
        """{"precision/bucket": seconds} view for stats()/bench JSON."""
        with self._lock:
            return {f"{p}/b{b}": s for (p, b), s in sorted(self._est.items())}

    # -- derived quantities --------------------------------------------
    def row_seconds(self, precision: str) -> Optional[float]:
        """Best known per-row service time (min over buckets of est/b) —
        the backlog-estimation rate; None with no data."""
        with self._lock:
            rates = [s / b for (p, b), s in self._est.items()
                     if p == precision and b > 0]
        return min(rates) if rates else None

    def service_seconds(self, precision: str, rows: int,
                        buckets: Sequence[int]) -> Optional[float]:
        """Predicted dispatch time for a ``rows``-row request chunked over
        ``buckets`` (greedy largest-first, mirroring the engine's chunk
        planner closely enough for admission).  Falls back to the best
        per-row rate for buckets without direct estimates; None when the
        model knows nothing about this precision yet (the caller then
        admits optimistically — no data must not mean reject-everything).
        """
        if rows <= 0:
            return 0.0
        buckets = sorted(int(b) for b in buckets)
        if not buckets:
            return None
        total, remaining = 0.0, rows
        row_rate = self.row_seconds(precision)
        while remaining > 0:
            b = next((x for x in buckets if x >= remaining), buckets[-1])
            est = self.estimate(precision, b)
            if est is None:
                if row_rate is None:
                    return None
                est = row_rate * b
            total += est
            remaining -= b
        return total


class EdfScheduler:
    """Earliest-deadline-first within tenant class, with precision as the
    degrade lever.

    ``precisions`` lists what the frontend actually pinned plans for, in
    preference order (fp32 first); ``safety`` inflates estimates so a
    request predicted to *just* fit is not dispatched into a miss."""

    def __init__(self, model: ServiceModel, buckets: Sequence[int],
                 precisions: Sequence[str] = (FP32,), safety: float = 1.2):
        if not precisions or precisions[0] != FP32:
            raise ValueError(
                f"precisions must lead with '{FP32}' (the undegraded "
                f"path); got {tuple(precisions)}")
        self.model = model
        self.buckets = tuple(int(b) for b in buckets)
        self.precisions = tuple(precisions)
        self.safety = safety

    @staticmethod
    def order(pending: List, now: Optional[float] = None) -> List:
        """EDF within tenant class: sort by (tenant priority, absolute
        deadline, arrival).  Deadline-less requests sort after deadlined
        ones of the same class (batch work yields to latency work)."""
        return sorted(
            pending,
            key=lambda r: (r.tenant.priority,
                           r.deadline if r.deadline is not None
                           else float("inf"),
                           r.rid))

    def feasible_precision(self, req, now: float,
                           backlog_s: float = 0.0) -> Optional[str]:
        """The cheapest-degradation precision predicted to meet the
        request's deadline: fp32 if it fits, else (tenant permitting)
        each degraded precision in order, else None — shed, don't
        dispatch a guaranteed miss.  Unknown estimates admit
        optimistically at fp32 (the model learns from the dispatch)."""
        if req.deadline is None:
            return self.precisions[0]
        allowed = (self.precisions if req.tenant.allow_degrade
                   else self.precisions[:1])
        for precision in allowed:
            est = self.model.service_seconds(precision, req.rows,
                                             self.buckets)
            if est is None:
                return precision
            if now + backlog_s + self.safety * est <= req.deadline:
                return precision
        return None
