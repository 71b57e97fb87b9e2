"""Admission control for the async serving frontend.

The overload contract is *reject up front, typed* — a request that
cannot meet its SLO even on the degraded int8 path must be refused at
`submit` (`AdmissionRejected`), not accepted into a queue where it will
burn device time and fail anyway.  Two gates:

* **Backpressure** — the request queue is bounded in rows; a full queue
  rejects immediately.  Combined with the frontend's bounded worker this
  caps memory and tail latency instead of letting overload grow an
  unbounded backlog (the paper's predictability claim, Table II, is a
  statement about admitted work).
* **Predictive SLO check** — predicted completion (now + queue backlog +
  safety x service estimate from `scheduler.ServiceModel`) is tested
  against the request deadline at fp32 first, then at each degraded
  precision the tenant allows; only if none fits is the request shed.

`TenantClass` is the multi-tenant knob: per-class SLO default, priority
(scheduling order), and whether the class tolerates precision
degradation (a preview tenant might; a fidelity-critical one won't).
A copy of the JAX package's ``serve/admission.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .errors import AdmissionRejected
from .scheduler import EdfScheduler


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One request class sharing SLO/priority/degrade policy.

    * ``slo_ms``        — default per-request latency budget (None: no
                          deadline; batch work that yields to SLO work).
    * ``priority``      — scheduling class, lower first; EDF orders
                          within a class.
    * ``allow_degrade`` — whether the scheduler may serve this tenant
                          through the pinned int8 plans when fp32 cannot
                          make the deadline."""

    name: str
    slo_ms: Optional[float] = None
    priority: int = 1
    allow_degrade: bool = True

    def __post_init__(self):
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError(f"tenant {self.name!r}: slo_ms must be "
                             f"positive, got {self.slo_ms}")


class AdmissionController:
    """The submit-time gate; shares the `EdfScheduler` (and through it
    the `ServiceModel`) with dispatch so admission and scheduling agree
    on what "can make it" means."""

    def __init__(self, scheduler: EdfScheduler, max_queue_rows: int = 256):
        if max_queue_rows < 1:
            raise ValueError("max_queue_rows must be >= 1")
        self.max_queue_rows = max_queue_rows
        self._sched = scheduler

    def admit(self, req, queued_rows: int, backlog_s: float,
              now: float) -> str:
        """Return the precision the request is predicted to need, or
        raise `AdmissionRejected` (typed, with the gate that fired)."""
        if queued_rows + req.rows > self.max_queue_rows:
            raise AdmissionRejected(
                f"queue full: {queued_rows} rows pending against a "
                f"{self.max_queue_rows}-row bound (backpressure — back "
                "off and resubmit)", stage="queue_full")
        precision = self._sched.feasible_precision(req, now, backlog_s)
        if precision is None:
            raise AdmissionRejected(
                f"request of {req.rows} row(s) for tenant "
                f"{req.tenant.name!r} cannot meet its SLO "
                f"({(req.deadline - now) * 1e3:.1f} ms budget against a "
                f"{backlog_s * 1e3:.1f} ms backlog) even at the most "
                "degraded precision; rejected before burning device "
                "time", stage="predicted_slo")
        return precision
