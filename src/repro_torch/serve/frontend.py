"""Async multi-tenant SLO frontend over the bucketed serving engines.

`AsyncServeFrontend` is the overload-robust entry point, in the style of
MaxText's MLPerf ``OfflineInference``: a background worker thread drains
a bounded request queue into coalesced waves over *pinned per-bucket
executables* — one `DcnnServeEngine` per precision, each holding one
`plan.NetworkPlan` and one `BucketExecutable` (on a card, one captured
CUDA graph) per bucket, so the frontend's cache is executables per
bucket x precision.  The JAX package's frontend, ported: the same
control loop, counters, metric and span names.

The control loop per request:

* **submit** — `admission.AdmissionController` gates up front: a full
  queue rejects immediately (backpressure), and a request whose
  predicted completion (queue backlog + `scheduler.ServiceModel`
  estimate) busts its SLO even on the degraded int8 path is refused
  typed (`AdmissionRejected`) instead of queued toward a guaranteed
  deadline miss.
* **schedule** — the worker orders the queue earliest-deadline-first
  within tenant priority class (`scheduler.EdfScheduler`) and picks the
  wave's precision: fp32 when it makes the deadline, the pinned int8
  chain when only reduced precision can (graceful degradation; the
  request is tagged ``downgraded``), a typed late shed when nothing can.
* **dispatch** — one coalesced `generate` per wave, on the worker
  thread (a replay runs on that thread's current stream; builds go
  through `engine.CAPTURE_GATE`); measured wall clocks feed the
  `ServiceModel` (healthy dispatches only).  A dispatch failure
  (`EngineDegraded` after exhausted retries, or a device loss, which
  one device cannot remesh around) requeues the wave's requests while
  their deadlines hold and sheds the rest typed — never a hang, never a
  silent drop.  Remesh events (scaled capacity after a device loss)
  come only from a multi-device engine; on one device there are none.

Requests are staged as float32 whatever the tower's dtype: the engines
take float32 rows and a bf16 tower casts on the card.

`stats()` reports per-tenant p50/p99/CV over completed-request latency
plus shed/downgrade/requeue counters — the serving bench's ``slo``
section is this dict over an offered-load sweep.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs import clock as obsclock
from ..obs import metrics as obsmetrics
from ..obs import trace as obstrace
from .admission import AdmissionController, TenantClass
from .errors import (AdmissionRejected, DeadlineExceeded, EngineDegraded,
                     EngineError)
from .scheduler import FP32, EdfScheduler, ServiceModel


class _FrontendRequest:
    """One admitted request: rows + deadline + resolution slot."""

    __slots__ = ("rid", "tenant", "z", "rows", "submit_t", "deadline",
                 "precision_hint", "precision", "downgraded", "requeues",
                 "event", "result", "error", "qspan")

    def __init__(self, rid: int, tenant: TenantClass, z: np.ndarray,
                 submit_t: float, deadline: Optional[float]):
        self.rid = rid
        self.tenant = tenant
        self.z = z
        self.rows = int(z.shape[0])
        self.submit_t = submit_t
        self.deadline = deadline
        self.precision_hint = FP32
        self.precision: Optional[str] = None
        self.downgraded = False
        self.requeues = 0
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        # open queue_wait trace handle (begun at submit, ended when the
        # worker picks or sheds the request; None while not queued)
        self.qspan = None


def _tenant_zero() -> Dict[str, object]:
    return {"admitted": 0, "completed": 0, "downgraded": 0, "requeued": 0,
            "shed_admission": 0, "shed_late": 0, "shed_requeue": 0,
            "latencies_s": []}


class AsyncServeFrontend:
    """Async submit/result over one `DcnnServeEngine` per precision.

    ``engines`` maps precision -> engine; "fp32" is mandatory (the
    undegraded path) and every engine must share one bucket set, so the
    scheduler's per-bucket estimates apply across precisions.  All
    engine dispatch happens on the single worker thread; callers only
    touch the queue (thread-safe) and their own request's event."""

    def __init__(self, engines: Dict[str, "object"],
                 tenants: Sequence[TenantClass], *,
                 max_queue_rows: int = 256, safety: float = 1.2,
                 max_requeues: int = 1,
                 model: Optional[ServiceModel] = None, start: bool = True,
                 metrics: Optional[obsmetrics.MetricsRegistry] = None):
        if FP32 not in engines:
            raise ValueError(
                "AsyncServeFrontend needs a 'fp32' engine (the undegraded "
                f"path); got precisions {tuple(engines)}")
        self._engines = dict(engines)
        self._precisions = (FP32,) + tuple(
            p for p in engines if p != FP32)
        buckets = {p: tuple(e.buckets) for p, e in engines.items()}
        if len(set(buckets.values())) != 1:
            raise ValueError(
                f"engines must share one bucket set, got {buckets}: the "
                "scheduler's per-bucket estimates could not transfer "
                "across precisions")
        self._buckets = engines[FP32].buckets
        self._max_bucket = engines[FP32].max_bucket
        self._input_shape = engines[FP32].cfg.input_shape
        self._workload = getattr(engines[FP32], "workload",
                                 engines[FP32].cfg.name)
        if not tenants:
            raise ValueError("at least one TenantClass is required")
        self._tenants: Dict[str, TenantClass] = {}
        for t in tenants:
            if t.name in self._tenants:
                raise ValueError(f"duplicate tenant class {t.name!r}")
            self._tenants[t.name] = t

        # typed observability, dual-written beside the legacy per-tenant
        # dicts at the same sites (tests assert exact equality).  Pass the
        # engines' shared registry (see from_config) so the whole stack's
        # series — engine dispatch histograms included — land in one place.
        self.metrics = (metrics if metrics is not None
                        else obsmetrics.MetricsRegistry())
        self._tracer = obstrace.get_tracer()
        self._m_req = self.metrics.counter(
            "frontend.requests",
            "request outcomes by tenant (labels: tenant, outcome)")
        self._m_latency = self.metrics.histogram(
            "frontend.request_latency_seconds",
            "submit-to-completion latency (labels: tenant, precision)")
        self._m_qwait = self.metrics.histogram(
            "frontend.queue_wait_seconds",
            "submit-to-wave-pick queue wait (label: tenant)")
        self._m_qrows = self.metrics.gauge(
            "frontend.queue_rows", "rows currently queued")

        self._model = model if model is not None else ServiceModel()
        for precision, eng in self._engines.items():
            self._model.seed_from_engine(precision, eng)
        self._sched = EdfScheduler(self._model, self._buckets,
                                   self._precisions, safety=safety)
        self._admission = AdmissionController(self._sched, max_queue_rows)
        self._max_requeues = max_requeues

        # queue state under _cond's lock; request registry + per-tenant
        # stats under _slock (lock order: _cond before _slock)
        self._cond = threading.Condition()
        self._queue: List[_FrontendRequest] = []
        self._inflight: List[_FrontendRequest] = []
        self._stop = False
        self._next_rid = 0
        self._slock = threading.Lock()
        self._requests: Dict[int, _FrontendRequest] = {}
        self._tenant_stats: Dict[str, Dict] = {
            name: _tenant_zero() for name in self._tenants}
        self._remeshes = 0
        self._worker_errors: List[BaseException] = []
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="serve-frontend")
        self._started = False
        if start:
            self.start()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg, params, tenants,
                    precisions: Sequence[str] = (FP32, "int8"),
                    plan=None, prime: int = 0,
                    fault_injector=None, **kwargs) -> "AsyncServeFrontend":
        """Build one engine per precision from a single `EngineConfig`
        (``cfg.precision`` is overridden per variant; a pinned ``plan``
        seeds the engine whose precision it matches).  ``prime`` > 0 runs
        that many measured warmup dispatches per bucket x precision
        before the worker starts — the service model the offered-load
        admission decisions need (without it the first requests admit
        optimistically while estimates are learned from live traffic).
        ``fault_injector`` is wired into the fp32 engine (drills).
        Engines run where ``cfg.device`` says (the card unless the caller
        asks for the CPU)."""
        from .engine import DcnnServeEngine

        # one registry for the whole deployment: every per-precision
        # engine and the frontend record into the same series space
        metrics = kwargs.pop("metrics", None)
        if metrics is None:
            metrics = obsmetrics.MetricsRegistry()
        engines = {}
        for precision in precisions:
            ecfg = (cfg if cfg.precision == precision
                    else dataclasses.replace(cfg, precision=precision))
            engines[precision] = DcnnServeEngine.from_config(
                ecfg, params,
                plan=(plan if plan is not None
                      and plan.precision == precision else None),
                fault_injector=(fault_injector if precision == FP32
                                else None),
                metrics=metrics)
        self = cls(engines, tenants, start=False, metrics=metrics, **kwargs)
        if prime:
            self.prime(reps=prime)
        self.start()
        return self

    def start(self) -> None:
        # check-and-set under _cond: two racing start() calls must not
        # both see _started False (Thread.start raises on the loser)
        with self._cond:
            if self._started:
                return
            self._started = True
        self._worker.start()

    def prime(self, reps: int = 2) -> None:
        """Measured warmup: build (on a card, capture) every bucket x
        precision and feed ``reps`` steady dispatch timings into the
        service model.  Call before `start` (engine dispatch is
        single-threaded: the worker owns it once started), so the first
        timed waves replay graphs that already exist."""
        for precision, eng in self._engines.items():
            for b in eng.buckets:
                z = np.zeros((b,) + self._input_shape, np.float32)
                for r in range(reps + 1):
                    t0 = obsclock.now()
                    eng.generate(z)
                    dt = obsclock.now() - t0
                    if r:  # first call builds: not a steady sample
                        self._model.observe(precision, b, dt)

    # ------------------------------------------------------------------
    # caller API
    # ------------------------------------------------------------------
    def submit(self, z: np.ndarray, tenant: str = "default",
               slo_ms: Optional[float] = None) -> int:
        """Admit a request (rows of z) for ``tenant``; returns a request
        id for `result`.  ``slo_ms`` overrides the tenant's default SLO.
        Raises `AdmissionRejected` when the bounded queue is full or the
        predicted completion busts the SLO at every allowed precision."""
        t = self._tenants.get(tenant)
        if t is None:
            raise ValueError(f"unknown tenant {tenant!r}; classes: "
                             f"{sorted(self._tenants)}")
        z = np.asarray(z, dtype=np.float32)
        if z.ndim == len(self._input_shape):
            z = z[None]
        if z.shape[0] == 0:
            raise ValueError("empty request: z has no rows")
        now = obsclock.now()
        slo = slo_ms if slo_ms is not None else t.slo_ms
        deadline = None if slo is None else now + slo / 1e3
        req = _FrontendRequest(-1, t, z, now, deadline)
        with self._cond:
            if self._stop:
                raise RuntimeError("frontend is closed")
            queued_rows = (sum(r.rows for r in self._queue)
                           + sum(r.rows for r in self._inflight))
            backlog_s = self._backlog_seconds_locked()
            try:
                req.precision_hint = self._admission.admit(
                    req, queued_rows, backlog_s, now)
            except AdmissionRejected as e:
                with self._slock:
                    self._tenant_stats[t.name]["shed_admission"] += 1
                self._m_req.inc(tenant=t.name, outcome="shed_admission")
                if self._tracer.enabled:
                    self._tracer.instant("admission_rejected", cat="frontend",
                                         tenant=t.name, stage=e.stage,
                                         rows=req.rows)
                raise
            req.rid = self._next_rid
            self._next_rid += 1
            self._queue.append(req)
            with self._slock:
                self._requests[req.rid] = req
                self._tenant_stats[t.name]["admitted"] += 1
            self._m_req.inc(tenant=t.name, outcome="admitted")
            self._m_qrows.set(queued_rows + req.rows)
            if self._tracer.enabled:
                req.qspan = self._tracer.begin("queue_wait", cat="frontend",
                                               rid=req.rid, tenant=t.name,
                                               rows=req.rows)
            self._cond.notify()
        if self._tracer.enabled:
            self._tracer.complete("submit", now, obsclock.now(),
                                  cat="frontend", rid=req.rid, tenant=t.name,
                                  rows=req.rows,
                                  precision_hint=req.precision_hint)
        return req.rid

    def result(self, rid: int,
               timeout_s: Optional[float] = None) -> np.ndarray:
        """Block for request ``rid``'s images (or its typed failure).
        Results are handed out exactly once.  ``timeout_s`` bounds the
        wait: expiry raises `DeadlineExceeded` without consuming the
        request (a later `result` call can still pick it up)."""
        t0 = obsclock.now()
        with self._slock:
            req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request {rid}: never admitted, or "
                           "its result was already handed out")
        if not req.event.wait(timeout_s):
            raise DeadlineExceeded(
                f"request {rid} unresolved after {timeout_s:.3f}s")
        with self._slock:
            self._requests.pop(rid, None)
        if self._tracer.enabled:
            self._tracer.complete("collect", t0, obsclock.now(),
                                  cat="frontend", rid=rid,
                                  tenant=req.tenant.name,
                                  failed=req.error is not None)
        if req.error is not None:
            raise req.error
        return req.result

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Block until the queue and in-flight wave are empty."""
        deadline = (None if timeout_s is None
                    else obsclock.now() + timeout_s)
        while True:
            with self._cond:
                if not self._queue and not self._inflight:
                    return
            if deadline is not None and obsclock.now() >= deadline:
                raise DeadlineExceeded(
                    f"frontend not drained within {timeout_s:.3f}s")
            time.sleep(0.002)

    def close(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Stop the worker.  ``drain=True`` (default) serves everything
        still queued first; ``drain=False`` resolves queued requests
        typed (`AdmissionRejected`, stage="shutdown") — a shutdown never
        silently drops a caller."""
        doomed: List[_FrontendRequest] = []
        with self._cond:
            self._stop = True
            started = self._started
            if not drain:
                doomed, self._queue = self._queue, []
            self._cond.notify_all()
        for req in doomed:
            self._tracer.end(req.qspan, outcome="shutdown")
            req.qspan = None
            self._resolve_error(req, AdmissionRejected(
                f"request {req.rid} dropped by frontend shutdown",
                stage="shutdown"), counter=None)
        if started:
            self._worker.join(timeout=timeout_s)
        for eng in self._engines.values():
            eng.close()

    def stats(self) -> Dict:
        """Per-tenant latency percentiles + shed/downgrade counters and
        the frontend-global capacity picture."""
        with self._slock:
            tenants = {}
            for name, st in self._tenant_stats.items():
                lat = np.asarray(st["latencies_s"], dtype=np.float64)
                row = {k: v for k, v in st.items() if k != "latencies_s"}
                row["shed"] = (st["shed_admission"] + st["shed_late"]
                               + st["shed_requeue"])
                if lat.size:
                    mean = float(lat.mean())
                    row.update(
                        p50_ms=float(np.percentile(lat, 50)) * 1e3,
                        p99_ms=float(np.percentile(lat, 99)) * 1e3,
                        mean_ms=mean * 1e3,
                        cv=float(lat.std() / max(mean, 1e-12)),
                    )
                tenants[name] = row
            remeshes = self._remeshes
        with self._cond:
            queue_rows = sum(r.rows for r in self._queue)
            inflight_rows = sum(r.rows for r in self._inflight)
        return {
            "workload": self._workload,
            "tenants": tenants,
            "queue_rows": queue_rows,
            "inflight_rows": inflight_rows,
            "remeshes": remeshes,
            "precisions": list(self._precisions),
            "buckets": list(self._buckets),
            "estimates_s": self._model.snapshot(),
        }

    def reset_stats(self) -> None:
        """Zero the per-tenant counters/latency samples (offered-load
        sweeps measure each load point fresh); capacity estimates and
        pinned plans are kept — they are state, not statistics."""
        with self._slock:
            for name in self._tenant_stats:
                self._tenant_stats[name] = _tenant_zero()
        # keep the registry's frontend series in lockstep with the legacy
        # dicts (engine series are cumulative state and stay)
        self._m_req.reset()
        self._m_latency.reset()
        self._m_qwait.reset()

    def plan_fingerprints(self) -> Dict[str, str]:
        """{"b{batch}/{precision}": stable hash} over every pinned
        NetworkPlan across the precision-variant engines (see
        `plan.variant_fingerprints`) — what a deployment compares across
        hosts to show the same executables everywhere."""
        from ..plan import variant_fingerprints

        return variant_fingerprints(
            p for eng in self._engines.values()
            for p in eng.plans.values())

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------
    def _backlog_seconds_locked(self) -> float:
        total = 0.0
        for req in self._queue + self._inflight:
            est = self._model.service_seconds(
                req.precision_hint or FP32, req.rows, self._buckets)
            if est is not None:
                total += est
        return total

    def _resolve_error(self, req: _FrontendRequest, error: Exception,
                       counter: Optional[str]) -> None:
        req.error = error
        if counter is not None:
            with self._slock:
                self._tenant_stats[req.tenant.name][counter] += 1
            self._m_req.inc(tenant=req.tenant.name, outcome=counter)
        if self._tracer.enabled:
            self._tracer.instant("request_failed", cat="frontend", rid=req.rid,
                                 tenant=req.tenant.name,
                                 error=type(error).__name__)
        req.event.set()

    def _record_completion(self, req: _FrontendRequest, precision: str,
                           done_t: float) -> None:
        req.precision = precision
        req.downgraded = precision != FP32
        with self._slock:
            st = self._tenant_stats[req.tenant.name]
            st["completed"] += 1
            if req.downgraded:
                st["downgraded"] += 1
            st["latencies_s"].append(done_t - req.submit_t)
        self._m_req.inc(tenant=req.tenant.name, outcome="completed")
        if req.downgraded:
            self._m_req.inc(tenant=req.tenant.name, outcome="downgraded")
        self._m_latency.observe(done_t - req.submit_t,
                                tenant=req.tenant.name, precision=precision)
        req.event.set()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(timeout=0.05)
                if self._stop and not self._queue:
                    break
                wave, precision, sheds = self._pick_wave_locked()
                self._inflight = list(wave)
                self._m_qrows.set(sum(r.rows for r in self._queue))
            picked_t = obsclock.now()
            for req in wave:
                self._tracer.end(req.qspan, outcome="dispatched")
                req.qspan = None
                self._m_qwait.observe(picked_t - req.submit_t,
                                      tenant=req.tenant.name)
            for req in sheds:
                self._tracer.end(req.qspan, outcome="shed_late")
                req.qspan = None
            for req in sheds:
                self._resolve_error(req, AdmissionRejected(
                    f"request {req.rid} ({req.tenant.name}) can no longer "
                    "meet its deadline in queue; shed before dispatch "
                    "(never a post-dispatch DeadlineExceeded)",
                    stage="late"), counter="shed_late")
            if not wave:
                continue
            try:
                self._dispatch_wave(wave, precision)
            except Exception as e:   # worker must never die: that's a hang
                self._worker_errors.append(e)
                for req in wave:
                    if not req.event.is_set():
                        self._resolve_error(req, EngineDegraded(
                            f"frontend worker error: {e!r}"),
                            counter="shed_requeue")
            finally:
                with self._cond:
                    self._inflight = []
                    self._cond.notify_all()

    def _pick_wave_locked(self):
        """EDF order the queue, shed requests that can no longer make
        their deadlines, and cut one wave: the head request fixes the
        precision, following same-precision requests coalesce until the
        largest bucket is full (one dispatch per wave keeps per-request
        latency equal to wave latency — predictable, per Table II)."""
        now = obsclock.now()
        ordered = EdfScheduler.order(self._queue)
        wave: List[_FrontendRequest] = []
        sheds: List[_FrontendRequest] = []
        precision: Optional[str] = None
        rows = 0
        for req in ordered:
            choice = (None
                      if req.deadline is not None and now > req.deadline
                      else self._sched.feasible_precision(req, now))
            if choice is None:
                sheds.append(req)
                continue
            if precision is None:
                precision = choice
            if choice != precision:
                continue          # different precision: next wave
            if rows and rows + req.rows > self._max_bucket:
                continue          # wave bounded to one largest-bucket call
            wave.append(req)
            rows += req.rows
        for req in wave + sheds:
            self._queue.remove(req)
        return wave, precision, sheds

    def _dispatch_wave(self, wave: List[_FrontendRequest],
                       precision: str) -> None:
        eng = self._engines[precision]
        remesh_before = len(eng.fault_stats["remesh_events"])
        retries_before = eng.fault_stats["retries"]
        z = (wave[0].z if len(wave) == 1
             else np.concatenate([r.z for r in wave], axis=0))
        t0 = obsclock.now()
        try:
            imgs = eng.generate(z)
        except Exception as err:
            self._check_remesh(eng, remesh_before)
            self._requeue_or_shed(wave, err)
            return
        done_t = obsclock.now()
        if self._tracer.enabled:
            self._tracer.complete("wave_dispatch", t0, done_t, cat="frontend",
                                  precision=precision, rows=int(len(z)),
                                  reqs=len(wave))
        remeshed = self._check_remesh(eng, remesh_before)
        retried = eng.fault_stats["retries"] != retries_before
        if not remeshed and not retried and len(z) <= self._max_bucket:
            # healthy dispatch at a known bucket: feed the capacity model
            # (a wave that rode a remesh or retries is not a healthy
            # sample — same outcome-tagging rule as engine.bucket_stats)
            self._model.observe(precision, eng.bucket_for(len(z)),
                                done_t - t0)
        ofs = 0
        for req in wave:
            req.result = imgs[ofs:ofs + req.rows]
            ofs += req.rows
            self._record_completion(req, precision, done_t)

    def _check_remesh(self, eng, remesh_before: int) -> bool:
        """Scale capacity estimates down by the lost-device ratio after
        an elastic remesh: admission must start shedding at the shrunken
        capacity *now*, not after estimates drift there.  A one-device
        engine records no remesh events, so this finds none."""
        events = eng.fault_stats["remesh_events"]
        if len(events) == remesh_before:
            return False
        for ev in events[remesh_before:]:
            factor = ev["devices_before"] / max(1, ev["devices_after"])
            self._model.scale(factor)
        with self._slock:
            self._remeshes += len(events) - remesh_before
        return True

    def _requeue_or_shed(self, wave: List[_FrontendRequest],
                         err: Exception) -> None:
        """Dispatch failed typed: requeue requests whose deadlines still
        hold (bounded by max_requeues), shed the rest — every request
        resolves, in both directions."""
        now = obsclock.now()
        requeue: List[_FrontendRequest] = []
        for req in wave:
            if (req.requeues < self._max_requeues
                    and (req.deadline is None or now < req.deadline)):
                req.requeues += 1
                requeue.append(req)
            else:
                typed = (err if isinstance(err, EngineError)
                         else EngineDegraded(f"dispatch failed: {err!r}"))
                self._resolve_error(req, typed, counter="shed_requeue")
        if requeue:
            with self._slock:
                for req in requeue:
                    self._tenant_stats[req.tenant.name]["requeued"] += 1
            for req in requeue:
                self._m_req.inc(tenant=req.tenant.name, outcome="requeued")
                if self._tracer.enabled:
                    req.qspan = self._tracer.begin(
                        "queue_wait", cat="frontend", rid=req.rid,
                        tenant=req.tenant.name, rows=req.rows,
                        requeue=req.requeues)
            with self._cond:
                self._queue[:0] = requeue
                self._cond.notify()
