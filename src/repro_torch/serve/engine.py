"""Bucketed DCNN serving engine on one device.

`DcnnServeEngine` is the paper's serving path: batched z -> image
generation through a selectable deconvolution backend.  Request batches
are padded to a fixed set of power-of-two *buckets*, each bucket runs a
pinned `plan.NetworkPlan` whose tiles (including the batch tile ``t_n``)
were resolved for that bucket's batch, and a ``submit``/``collect`` queue
coalesces small requests into the largest fitting buckets.

Three kernel paths: fp32 on "cuda" (the dense kernel), int8 on "cuda"
(the int8 kernel chain: params calibrated and quantized once at
construction and kept on the device) and fp32 on "cuda_sparse" (the
zero-skip kernel on pruned params; schedules built on the host once per
layer and channel tiles, and copied to the device once per plan).
``launch_counts`` maps bucket -> launches of the kernel the engine's path
uses, made by that bucket's dispatches, so a run can show that serving
went through it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..kernels.deconv2d import int8 as int8_kernel
from ..kernels.deconv2d import kernel as deconv_kernel
from ..kernels.deconv2d_sparse import kernel as sparse_kernel
from ..models.dcnn import generator_apply
from ..workloads import resolve_model, workload_name_for
from .config import EngineConfig
from .errors import AdmissionRejected, DeadlineExceeded


def pow2_buckets(max_batch: int) -> Tuple[int, ...]:
    """1, 2, 4, ... up to (and including) max_batch."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return tuple(sorted(set(out)))


class DcnnServeEngine:
    """The paper's inference workload: batched image generation through
    fixed batch buckets, one pinned plan per bucket.

    * **Bucketing** — `plan_chunks` decomposes a request batch into bucket
      calls, trading padded rows against per-call overhead.
    * **Plan/execute** — each bucket's `NetworkPlan` is built once (lazily,
      or at construction with ``warmup=True``) and every dispatch executes
      it unchanged; ``plan_stats`` counts builds.
    * **Queue** — ``submit`` enqueues rows, ``drain`` runs everything
      pending as one coalesced `generate`, ``collect`` hands a ticket's
      images out exactly once (or raises its typed failure).
    * **Timing** — ``throughput()`` reports per-bucket images/s and the
      run-to-run mean/std/CV of the per-dispatch wall clock, from padding
      the rows to the bucket to the images back on the host, started after
      a ``torch.cuda.synchronize()``.
    """

    @classmethod
    def from_config(cls, cfg: EngineConfig, params,
                    plan=None) -> "DcnnServeEngine":
        """``params`` is a ``{"l{i}": {"w", "b"}}`` tree of fp32 tensors
        (moved to the engine's device; pruned for "cuda_sparse"); ``plan``
        an optional pinned `NetworkPlan` (for example a JAX-pinned document
        after `for_hopper`) for the bucket whose batch matches
        ``plan.batch``.  An int8 plan also supplies the calibration when
        ``cfg.quant_cfg`` is None, so a pinned deployment never
        re-calibrates."""
        self = cls.__new__(cls)
        self._setup(cfg, params, plan)
        return self

    def _setup(self, config: EngineConfig, params, plan) -> None:
        self.config = config
        self.device = config.torch_device()
        self.cfg = resolve_model(config.model)
        self.workload = workload_name_for(self.cfg)
        self.backend = config.backend
        self.precision = config.precision
        self.call_overhead_rows = config.call_overhead_rows
        self.quant_cfg = config.quant_cfg
        dtype = self.cfg.torch_dtype
        params = {k: {n: t.to(device=self.device, dtype=dtype)
                      for n, t in v.items()} for k, v in params.items()}
        self.buckets = tuple(sorted(set(
            int(b) for b in (config.buckets if config.buckets
                             else pow2_buckets(config.max_batch)))))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive: {self.buckets}")
        self.max_bucket = self.buckets[-1]
        self.plans: Dict[int, object] = {}
        self.launch_counts: Dict[int, int] = {}
        self._kernel = {("cuda", "fp32"): deconv_kernel,
                        ("cuda", "int8"): int8_kernel,
                        ("cuda_sparse", "fp32"): sparse_kernel}.get(
                            (self.backend, self.precision))
        # host schedules memoised under (layer, t_ci, t_co) across buckets;
        # their device copies once per bucket plan
        self._sparse_tables: Dict[tuple, tuple] = {}
        self._sparse_device: Dict[int, Dict[int, tuple]] = {}
        self._warm: Set[int] = set()
        self.plan_stats = {"builds": 0, "build_seconds": 0.0}
        if plan is not None:
            if (plan.backend, plan.precision) != (self.backend,
                                                  self.precision):
                raise ValueError(
                    f"plan was built for backend={plan.backend!r} / "
                    f"precision={plan.precision!r}; the engine config says "
                    f"{self.backend!r} / {self.precision!r}")
            plan.validate_for(self.cfg)
            if plan.batch not in self.buckets:
                raise ValueError(f"plan.batch={plan.batch} matches no bucket "
                                 f"(buckets={self.buckets})")
            # a stale zero-skip schedule would skip now-nonzero slabs
            plan.verify_sparse_tables(params)
            if self.precision == "int8":
                if self.quant_cfg is None:
                    self.quant_cfg = plan.quant_config()
                elif plan.quant_config() != self.quant_cfg:
                    raise ValueError(
                        "EngineConfig.quant_cfg and the pinned plan carry "
                        "different calibrations; drop one of them (the "
                        "plan's scales are the ones its epilogues use)")
            self.plans[plan.batch] = plan
        if self.precision == "int8":
            from ..quant.calibrate import calibrate, quantize_params
            from ..workloads import calibration_input

            if self.quant_cfg is None:
                z_cal = calibration_input(self.cfg, seed=config.calib_seed,
                                          batch=config.calib_batch)
                self.quant_cfg = calibrate(params, self.cfg,
                                           z_cal.to(self.device),
                                           strategy=config.calib_strategy)
            params = quantize_params(params, self.cfg, self.quant_cfg,
                                     device=self.device)
        self.params = params
        # queue entries are (ticket, rows, absolute deadline or None).
        # _qlock guards the queue state; _drain_lock serializes drains;
        # _inflight names tickets a drain has taken off the queue but not
        # yet resolved, so a concurrent collect waits for that drain.
        self._qlock = threading.Lock()
        self._drain_lock = threading.Lock()
        self._inflight: Set[int] = set()
        self._pending: List[Tuple[int, np.ndarray, Optional[float]]] = []
        self._results: Dict[int, np.ndarray] = {}
        self._failures: Dict[int, Exception] = {}
        self._next_id = 0
        self.stats = {"generate_calls": 0, "images": 0, "padded_images": 0}
        self.fault_stats = {"deadline_expired": 0, "shed": 0}
        self.bucket_stats: Dict[int, Dict[str, float]] = {}
        if config.warmup:
            for b in self.buckets:
                self._warmup_bucket(b)

    # -- per-bucket plans -----------------------------------------------
    def _plan_for(self, bucket: int):
        """The bucket's pinned `NetworkPlan`, built on first use."""
        if bucket not in self.plans:
            from ..plan import build_network_plan

            t0 = time.perf_counter()
            self.plans[bucket] = build_network_plan(
                self.cfg, batch=bucket, backend=self.backend,
                precision=self.precision, quant_cfg=self.quant_cfg,
                params=(self.params if self.backend == "cuda_sparse"
                        else None),
                sparse_table_cache=self._sparse_tables)
            self.plan_stats["builds"] += 1
            self.plan_stats["build_seconds"] += time.perf_counter() - t0
        return self.plans[bucket]

    def _apply(self, bucket: int, plan, z: torch.Tensor) -> torch.Tensor:
        """The generator of the engine's path on one padded bucket."""
        if self.precision == "int8":
            from ..quant.infer import quantized_generator_apply

            return quantized_generator_apply(self.params, self.cfg,
                                             self.quant_cfg, z, plan=plan)
        sparse = None
        if self.backend == "cuda_sparse":
            from ..kernels.deconv2d_sparse import schedule_tensors

            sparse = self._sparse_device.get(bucket)
            if sparse is None:
                sparse = self._sparse_device[bucket] = {
                    i: schedule_tensors(t, self.device)
                    for i, t in plan.sparse_plans().items()}
        return generator_apply(self.params, self.cfg, z, plan=plan,
                               sparse_plans=sparse)

    def _warmup_bucket(self, bucket: int) -> None:
        z = np.zeros((bucket,) + self.cfg.input_shape, self.cfg.dtype)
        self._dispatch(bucket, z)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch(self, bucket: int, rows: np.ndarray):
        """One bucket call on ``rows`` (at most ``bucket`` of them):
        ``(images, seconds, steady)``.  ``seconds`` is the wall clock of the
        whole call: padding the rows to the bucket, the host-to-device copy,
        the generator and the device-to-host copy of the images.  The first
        call of a bucket (which may build the kernel library) is not steady
        and stays out of the timing stats."""
        plan = self._plan_for(bucket)
        take = rows.shape[0]
        launches0 = self._launches()
        self._sync()
        t0 = time.perf_counter()
        if take < bucket:
            rows = np.concatenate(
                [rows, np.zeros((bucket - take,) + rows.shape[1:], rows.dtype)],
                axis=0)
        z = torch.from_numpy(rows).to(self.device)
        y = self._apply(bucket, plan, z)
        images = y[:take].cpu().numpy()   # returns once the copy is done
        dt = time.perf_counter() - t0
        self.launch_counts[bucket] = (self.launch_counts.get(bucket, 0)
                                      + self._launches() - launches0)
        steady = bucket in self._warm
        self._warm.add(bucket)
        return images, dt, steady

    def _launches(self) -> int:
        """Launches so far of the kernel of the engine's path (0 on the
        backends without one)."""
        return self._kernel.LAUNCHES if self._kernel is not None else 0

    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering n requests (largest bucket if n exceeds
        them all — the caller then chunks)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_bucket

    def plan_chunks(self, n: int) -> List[Tuple[int, int]]:
        """Chunk plan for an n-row batch: ``[(take, bucket), ...]`` with
        ``sum(take) == n``: full max-bucket chunks first, then a cost-aware
        tail (computed rows plus ``call_overhead_rows`` per dispatch)."""
        if n < 0:
            raise ValueError(f"negative batch: {n}")
        plan: List[Tuple[int, int]] = []
        remaining = n
        while remaining >= self.max_bucket:
            plan.append((self.max_bucket, self.max_bucket))
            remaining -= self.max_bucket
        plan.extend(self._plan_tail(remaining))
        return plan

    def _plan_cost(self, plan: List[Tuple[int, int]]) -> int:
        return sum(b for _, b in plan) + self.call_overhead_rows * len(plan)

    def _plan_tail(self, r: int) -> List[Tuple[int, int]]:
        """Cost-aware plan for a tail below the largest bucket: the
        smallest covering bucket (one padded call) against slicing the
        largest exact-fitting bucket and recursing."""
        if r == 0:
            return []
        cover = self.bucket_for(r)
        best = [(r, cover)] if cover >= r else None
        fit = [b for b in self.buckets if b <= r]
        if fit:
            b = max(fit)
            cand = [(b, b)] + self._plan_tail(r - b)
            if best is None or self._plan_cost(cand) < self._plan_cost(best):
                best = cand
        if best is None:
            raise RuntimeError(f"no chunk plan for {r} rows over "
                               f"{self.buckets}")
        return best

    # -- synchronous path ----------------------------------------------
    def generate(self, z: np.ndarray) -> np.ndarray:
        """z: (B, z_dim) for ANY B, chunked/padded to the bucket set via
        `plan_chunks`."""
        z = np.asarray(z, dtype=self.cfg.dtype)
        n = z.shape[0]
        outs: List[np.ndarray] = []
        i = 0
        for take, bucket in self.plan_chunks(n):
            self.stats["padded_images"] += bucket - take
            y, dt, steady = self._dispatch(bucket, z[i:i + take])
            if steady:
                bs = self.bucket_stats.setdefault(
                    bucket, {"calls": 0, "images": 0, "seconds": 0.0,
                             "sumsq_seconds": 0.0})
                bs["calls"] += 1
                bs["images"] += take
                bs["seconds"] += dt
                bs["sumsq_seconds"] += dt * dt
            outs.append(y)
            i += take
        self.stats["generate_calls"] += 1
        self.stats["images"] += n
        if not outs:
            return np.zeros((0,) + self.output_shape, self.cfg.dtype)
        return np.concatenate(outs, axis=0) if len(outs) != 1 else outs[0]

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        return (self.cfg.img_hw, self.cfg.img_hw, self.cfg.img_c)

    def throughput(self) -> Dict[int, Dict[str, float]]:
        """Per-bucket steady-state serving rates: useful images/s, and the
        run-to-run mean, std and CV (std/mean) of the per-dispatch wall
        clock (the paper's Table II methodology).  A dispatch's clock runs
        from padding its rows to the bucket to its images on the host (both
        copies included); the host work between dispatches of one
        `generate` (chunking, the final concatenation) is not in it."""
        out = {}
        for bucket, bs in self.bucket_stats.items():
            if bs["seconds"] <= 0.0:
                continue
            mean_s = bs["seconds"] / bs["calls"]
            var = max(0.0, bs["sumsq_seconds"] / bs["calls"] - mean_s ** 2)
            std_s = var ** 0.5
            out[bucket] = {
                "img_per_s": bs["images"] / bs["seconds"],
                "calls": bs["calls"],
                "mean_s": mean_s,
                "std_s": std_s,
                "cv": std_s / max(mean_s, 1e-12),
            }
        return out

    def service_estimate(self, bucket: int) -> Optional[float]:
        """Mean steady dispatch wall clock for ``bucket``, or None before
        the first steady call."""
        bs = self.bucket_stats.get(bucket)
        if bs and bs["calls"] > 0:
            return bs["seconds"] / bs["calls"]
        return None

    # -- micro-batching queue --------------------------------------------
    def submit(self, z: np.ndarray,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue a request of one or more z rows; returns a ticket id.
        ``deadline_s`` (default: `EngineConfig.default_deadline_s`) bounds
        how long the ticket may wait: a drain that reaches it later fails
        it with `DeadlineExceeded` instead of executing stale work."""
        z = np.asarray(z, dtype=self.cfg.dtype)
        if z.ndim == len(self.cfg.input_shape):
            z = z[None]
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        deadline = (None if deadline_s is None
                    else time.perf_counter() + deadline_s)
        with self._qlock:
            rid = self._next_id
            self._next_id += 1
            self._pending.append((rid, z, deadline))
        return rid

    def shed(self, rid: int, reason: str = "") -> bool:
        """Remove a still-pending ticket and fail it typed
        (`AdmissionRejected`); False if it is no longer pending."""
        with self._qlock:
            for i, (t, _, _) in enumerate(self._pending):
                if t == rid:
                    del self._pending[i]
                    self.fault_stats["shed"] += 1
                    self._failures[rid] = AdmissionRejected(
                        reason or f"ticket {rid} shed before execution",
                        stage="shed")
                    return True
        return False

    def drain(self) -> None:
        """Run everything pending as one coalesced `generate`.  Expired
        tickets fail typed without executing; if `generate` fails, every
        drained ticket is restored to the queue before the error
        propagates."""
        with self._drain_lock:
            self._drain_locked()

    def _drain_locked(self) -> None:
        with self._qlock:
            if not self._pending:
                return
            reqs, self._pending = self._pending, []
            live = []
            now = time.perf_counter()
            for rid, z, deadline in reqs:
                if deadline is not None and now > deadline:
                    self.fault_stats["deadline_expired"] += 1
                    self._failures[rid] = DeadlineExceeded(
                        f"ticket {rid} missed its deadline by "
                        f"{now - deadline:.3f}s before execution")
                else:
                    live.append((rid, z, deadline))
                    self._inflight.add(rid)
        if not live:
            return
        rows = np.concatenate([z for _, z, _ in live], axis=0)
        try:
            imgs = self.generate(rows)
        except Exception:
            with self._qlock:
                self._pending = live + self._pending
                self._inflight.difference_update(r for r, _, _ in live)
            raise
        with self._qlock:
            ofs = 0
            for rid, z, _ in live:
                self._results[rid] = imgs[ofs:ofs + len(z)]
                ofs += len(z)
                self._inflight.discard(rid)

    def collect(self, rid: int,
                timeout_s: Optional[float] = None) -> np.ndarray:
        """Images for ticket ``rid`` (drains the queue if still pending).

        Raises the ticket's typed failure if it failed, a KeyError that
        tells a ticket never issued from one already collected, and
        `DeadlineExceeded` when ``timeout_s`` passes first."""
        deadline = (None if timeout_s is None
                    else time.perf_counter() + timeout_s)
        while True:
            with self._qlock:
                if rid in self._failures:
                    raise self._failures.pop(rid)
                if rid in self._results:
                    return self._results.pop(rid)
                pending = any(t == rid for t, _, _ in self._pending)
                inflight = rid in self._inflight
                issued = 0 <= rid < self._next_id
            if not issued:
                raise KeyError(f"unknown ticket {rid}: this engine never "
                               "issued it")
            if not (pending or inflight):
                raise KeyError(
                    f"ticket {rid} was already collected (results are "
                    "handed out exactly once)")
            remaining = (None if deadline is None
                         else deadline - time.perf_counter())
            if remaining is not None and remaining <= 0:
                raise DeadlineExceeded(
                    f"ticket {rid} unresolved after {timeout_s:.3f}s")
            # drive the queue ourselves, or wait for the drain that owns
            # the ticket to release the lock
            if not self._drain_lock.acquire(
                    timeout=-1 if remaining is None else remaining):
                continue
            try:
                self._drain_locked()
            finally:
                self._drain_lock.release()
