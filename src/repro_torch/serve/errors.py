"""Typed serving failures.

The engine's contract is *complete or fail typed*: a request either
returns images or raises one of these — it never silently drops a queued
ticket.  A copy of the JAX package's error types, so callers of either
engine catch the same names.
"""
from __future__ import annotations


class EngineError(RuntimeError):
    """Base class for `DcnnServeEngine` failures."""


class DeadlineExceeded(EngineError):
    """The per-request deadline passed before the request executed; the
    ticket was failed instead of serving stale work.  Submit again (or
    raise the deadline)."""


class AdmissionRejected(EngineError):
    """The request was refused *before* burning device time: the bounded
    queue is full (backpressure), or the predicted completion time —
    queue backlog plus the service-time estimate at the cheapest
    precision the tenant allows — would bust its SLO, or the scheduler
    shed it after a failure-requeue could no longer make the deadline.
    ``stage`` says which gate fired ("queue_full", "predicted_slo",
    "late", "requeue", "shed", "shutdown").  Back off and resubmit, or
    relax the SLO."""

    def __init__(self, message: str, stage: str = "shed"):
        super().__init__(message)
        self.stage = stage


class EngineDegraded(EngineError):
    """The engine cannot currently honor the request: transient-failure
    retries exhausted, a device loss with no elastic mesh to shrink
    onto, or post-remesh re-planning that did not re-derive the
    validated executables.  The queue is intact — pending tickets stay
    pending and a later drain retries them."""
