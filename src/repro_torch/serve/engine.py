"""Serving engines: the bucketed DCNN engine, on one device or a
data-parallel mesh, and the LM's continuous-batching `ServeEngine`.

`DcnnServeEngine` is the paper's serving path: batched z -> image
generation through a selectable deconvolution backend.  It serves the
pix2pix U-Net (`models.unet.UnetConfig`, image -> image) through the same
buckets, capture, staging and spans, fp32 on one device: its bucket body
is `models.unet.unet_apply` on the B1 operands rearranged once per engine
and a zero-kept input buffer per launch and bucket.  Request batches
are padded to a fixed set of power-of-two *buckets*, each bucket runs a
pinned `plan.NetworkPlan` whose tiles (including the batch tile ``t_n``)
were resolved for that bucket's batch, and a ``submit``/``collect`` queue
coalesces small requests into the largest fitting buckets.

Three kernel paths: fp32 or bf16 on "cuda" (the dense kernel), int8 on
"cuda" (the int8 kernel chain: params calibrated, quantized and packed for
the kernel once at construction and kept on the device) and fp32 or bf16
on "cuda_sparse" (the zero-skip kernel on pruned params; schedules built
on the host once per layer and channel tiles, and copied to the device
once per plan).  The layers' static operands (weights, biases, int8
scales, padded for the plan's channel tiles) are prepared once per layer
and tiles and held.  The tower's dtype (`DcnnConfig.dtype`, "float32" or
"bfloat16") is the dtype of its params and of the chain on the device;
the host side is float32 whatever it is: a bf16 tower's inputs are cast
to bf16 on the device and its images cast up to float32 there (exactly),
so it returns float32 arrays whose values are all bf16 values.  (The JAX
package returns bfloat16 arrays, which numpy cannot hold without
``ml_dtypes``.)

Each bucket runs one `ShardedExecutable`, built once from its pinned plan
(the counterpart of the JAX engine's per-bucket ``jax.jit``): on a card,
after one eager pass, everything from the static input z to the cropped
images in a static output is captured in one CUDA graph, and a dispatch
is a pinned host-to-device copy, one replay and a device-to-host copy of
the images into pinned memory of their own, within a process-wide bound
(`PINNED_RESULT_BYTES`), else into the bucket's pinned buffer and a copy
out of it.  On one device the executable holds one shard.  Capture or replay
failures raise; nothing falls back to eager execution on the card.  A
capture runs alone among the process's engines: their construction and
dispatches wait for it (`CAPTURE_GATE`).  On the CPU (when the caller asks for it) the same
executable runs eagerly.
``capture_counts`` maps bucket -> executables built (``total_captures``
sums them; the counterparts of ``trace_counts`` and ``total_compiles``);
``launch_counts`` maps bucket -> launches of the kernel of the engine's
path made by that bucket's dispatches, so a run can show that serving went
through it; ``wgmma_launch_counts`` those of them on the kernel's wgmma
path (on a card: per replay, the capture's launches that `launch_info`
puts there).

A pinned plan passes the plan DRC (`analysis.check.check_network_plan`)
before anything else happens: a plan that would fail the kernel's launch
checks (a tile over the card's shared memory, a reference backend not
mapped by `NetworkPlan.for_hopper`, a broken int8 scale chain) is refused
with a typed `PlanCheckError`, before any planning, static-operand
preparation, kernel build or graph capture.

With ``EngineConfig.mesh`` (a `launch.mesh.DeviceMesh`) the engine is one
controller over the mesh's data axis, as the JAX engine's ``shard_map``
is: buckets round up to multiples of the device count
(`shard_aligned_buckets`), each bucket's plan is built for the per-shard
batch (`shard_batch`), every device holds its own replica of the params
and of the static operands and its own CUDA graph per bucket, and a
dispatch splits the staged rows into contiguous shards, replays each
device's graph and gathers the shards in order, through the same
`ShardedExecutable` as one device's single shard.
``throughput()`` then reports per-device rates.

Faults and observability follow the JAX package's engine.  Every dispatch
is guarded: an optional `dist.inject.FaultInjector` hook inside the timed
window, a `dist.fault.Heartbeat` armed around each attempt (its callback
only counts), bounded retry with backoff on `TransientCallError` (a retry
replays the same executable; the backoff sleeps outside the dispatch lock
and `CAPTURE_GATE`), exhausted retries raised as `EngineDegraded`, a
device loss remeshed onto the surviving devices when the engine serves an
elastic mesh (`_remesh`; else `EngineDegraded`), and a per-bucket
`StragglerMonitor` over the healthy steady samples.  A retried dispatch
is *tainted*: counted beside, never inside, the Table II mean/std/CV.  The
engine dual-writes an `obs.MetricsRegistry` (``engine.*`` series labelled
``net``, ``workload``, ``precision`` and ``bucket``) and records spans
into the process tracer (`obs.trace`; one attribute read a site unless
enabled).  One ``generate`` records, on its thread and under its request
number, the tree ``generate`` > (``lock``, ``sync``, ``dispatch b{n}`` >
(``stage``, ``enqueue``, ``wait``, ``copy_out``), ``account``) per
dispatch, then ``account`` and, for a request of several chunks,
``concat``: the wait for the locks, the device-wide synchronise, the
timed window and its phases, the bookkeeping and the images put
together.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import threading
import time
import weakref
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..dist.fault import Heartbeat, StragglerMonitor, elastic_mesh
from ..dist.sharding import batch_slices, replicate
from ..dist.inject import DeviceLossError, TransientCallError
from ..kernels.deconv2d import int8 as int8_kernel
from ..kernels.deconv2d import kernel as deconv_kernel
from ..kernels.deconv2d_sparse import kernel as sparse_kernel
from ..core.tree import tree_map
from ..models import unet
from ..models.dcnn import generator_apply
from ..models.transformer import apply_lm, init_cache
from ..obs import clock as obsclock
from ..obs import metrics as obsmetrics
from ..obs import trace as obstrace
from ..workloads import resolve_model, workload_name_for
from .config import EngineConfig
from .errors import AdmissionRejected, DeadlineExceeded, EngineDegraded
from .sampling import sample


class _CaptureGate:
    """Lets a CUDA graph capture run alone among the process's engines.
    While a stream captures, a device-wide synchronise in any thread breaks
    the capture, and in the capturing thread CUDA refuses the calls a
    dispatch makes (synchronising, cudaMalloc, pinned allocations).  Every
    engine's construction and dispatch holds the gate shared; a build
    (planning, the eager pass, the capture) holds it exclusive: it waits
    for the holders in flight and holds new ones back until it ends.
    Other code's CUDA work in other threads is not held back: the capture
    runs in thread-local mode, which lets work on other streams through,
    but not a device-wide synchronise or a draw from the default CUDA
    generator."""

    def __init__(self):
        self._cond = threading.Condition()
        self._active = 0
        self._building = False

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._building)
            self._active += 1
        try:
            yield
        finally:
            with self._cond:
                self._active -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._building)
            self._building = True
            self._cond.wait_for(lambda: self._active == 0)
        try:
            yield
        finally:
            with self._cond:
                self._building = False
                self._cond.notify_all()


CAPTURE_GATE = _CaptureGate()

# Pinned host bytes that the images handed out may hold at once, over every
# engine of the process.  Within it a dispatch's images come back into a
# pinned tensor of their own and no host copy is made; past it they come
# back into the bucket's pinned buffer and are copied out of it (on an
# H100's host that copy took 0.5 ms of a 1.3 ms CelebA int8 dispatch).
PINNED_RESULT_BYTES = 128 << 20


class _PinnedBudget:
    """Pinned bytes held by images handed out and not yet dropped, counted
    at the host allocator's power-of-two block sizes, so the pinned memory
    that results keep (and the allocator caches after them) stays below
    ``limit``."""

    def __init__(self, limit: int):
        self.limit, self.held = limit, 0
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> bool:
        with self._lock:
            if self.held + nbytes > self.limit:
                return False
            self.held += nbytes
            return True

    def give(self, nbytes: int) -> None:
        with self._lock:
            self.held -= nbytes


PINNED_RESULTS = _PinnedBudget(PINNED_RESULT_BYTES)

# request numbers of the traced ``generate`` calls, unique in the process
_REQUESTS = itertools.count(1)


def pinned_result(shape, dtype):
    """``(tensor, its numpy view)``: new pinned memory for a dispatch's
    images while `PINNED_RESULTS` allows (the budget gets its bytes back
    when the view and every slice of it are dropped), else None."""
    nbytes = int(np.prod(shape)) * dtype.itemsize
    block = 1 << max(0, nbytes - 1).bit_length()
    if not PINNED_RESULTS.take(block):
        return None
    try:
        dst = torch.empty(shape, dtype=dtype, pin_memory=True)
    except Exception:
        PINNED_RESULTS.give(block)
        raise
    # the view holds the memory but not ``dst`` itself: watch the view
    view = dst.numpy()
    weakref.finalize(view, PINNED_RESULTS.give, block)
    return dst, view


class BucketExecutable:
    """One device's part of a bucket's dispatch, built once: one batch
    shard (the whole bucket on a single device).

    ``z_dev`` is the static input ``(rows, *input_shape)`` and ``out_dev``
    the static output ``(rows, H, W, C)``; ``z_host`` and ``out_host``
    their host staging buffers (pinned on a card; on the CPU ``z_dev`` and
    ``out_dev`` themselves).  ``graph`` is the captured
    `torch.cuda.CUDAGraph` (None on the CPU, where ``body`` runs eagerly),
    and ``launches`` the launches of the path's kernel one replay makes
    (counted while capturing; None on the CPU), ``wgmma_launches`` those
    of them on its wgmma path (0 on the CPU) and ``kind_launches`` a
    U-Net's launches by kind (`models.unet.LAUNCHES`; empty on the CPU and
    for a DCNN tower)."""

    def __init__(self, bucket, body, z_dev, out_dev, z_host, out_host,
                 graph=None, launches=None, wgmma_launches=0,
                 kind_launches=None):
        self.bucket = bucket
        self.body = body
        self.z_dev, self.out_dev = z_dev, out_dev
        self.z_host, self.out_host = z_host, out_host
        self.graph = graph
        self.launches = launches
        self.wgmma_launches = wgmma_launches
        self.kind_launches = dict(kind_launches or {})

    def stage(self, rows: np.ndarray) -> None:
        """``rows`` into the host staging input, the rows past them zero
        (the JAX engine pads with zeros)."""
        take = rows.shape[0]
        self.z_host[:take].copy_(torch.from_numpy(rows))
        self.z_host[take:].zero_()

    def replay(self) -> None:
        """The captured graph once, on the current stream."""
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"bucket {self.bucket}: CUDA graph replay "
                               f"failed: {e}") from e


class ShardedExecutable:
    """One bucket's dispatch: a `BucketExecutable` per batch shard, each
    at the per-shard batch on its device (one shard on a single device).
    A call splits the rows into contiguous shards in shard order and
    stages each (padded with zeros), then per shard in order copies its
    rows to its device, replays its graph and copies its images back:
    into its rows of one new pinned result while `PINNED_RESULTS` allows
    (the result is its numpy view), else into the shard's ``out_host``,
    copied out on the host (the next dispatch reuses the staging buffers,
    so no result aliases them).  On the CPU each shard's body runs
    eagerly.  ``launches`` and ``wgmma_launches`` sum the shards'.  A call
    records its phases
    as spans of the process tracer (`obs.trace`): ``stage``, ``enqueue``
    (on the CPU the eager bodies take its place), ``wait`` and, where the
    images come back through ``out_host``, ``copy_out``."""

    def __init__(self, bucket, shards: List[BucketExecutable]):
        self.bucket = bucket
        self.shards = shards
        self._tracer = obstrace.get_tracer()
        self.slices = batch_slices(len(shards), bucket)
        self.graph = shards[0].graph
        self.launches = (None if shards[0].launches is None
                         else sum(s.launches for s in shards))
        self.wgmma_launches = sum(s.wgmma_launches for s in shards)
        self.kind_launches = {k: sum(s.kind_launches.get(k, 0)
                                     for s in shards)
                              for k in shards[0].kind_launches}

    def _takes(self, take: int):
        """Per shard, its slice and how many of the first ``take`` rows
        fall in it."""
        return [(s, sl, max(0, min(take, sl.stop) - sl.start))
                for s, sl in zip(self.shards, self.slices)]

    def stage(self, rows: np.ndarray) -> None:
        for s, sl in zip(self.shards, self.slices):
            s.stage(rows[sl])

    def enqueue(self, take: int):
        """Per shard: the host-to-device copy, the replay and the copy of
        its share of the first ``take`` images back (read them after
        `wait`): into one new pinned tensor, returned with its numpy view,
        while `PINNED_RESULTS` allows; else into each shard's
        ``out_host``, and None is returned."""
        out = self.shards[0].out_dev
        got = pinned_result((take,) + tuple(out.shape[1:]), out.dtype)
        for s, sl, n in self._takes(take):
            with torch.cuda.device(s.z_dev.device):
                s.z_dev.copy_(s.z_host, non_blocking=True)
                s.replay()
                if n:
                    dst = (got[0][sl.start:sl.start + n] if got is not None
                           else s.out_host[:n])
                    dst.copy_(s.out_dev[:n], non_blocking=True)
        return got

    def wait(self) -> None:
        for dev in {s.out_dev.device for s in self.shards}:
            torch.cuda.current_stream(dev).synchronize()

    def images(self, got, take: int) -> np.ndarray:
        """`enqueue`'s images in memory of their own: its pinned view, or a
        host copy out of the shards' ``out_host`` (one thread's copy:
        spread over torch's intra-op threads, the copy waited on
        straggling threads often enough to raise the mean and the CV;
        ``tools/probe_dispatch.py``)."""
        if got is not None:
            return got[1]
        return np.concatenate([s.out_host[:n].numpy()
                               for s, _, n in self._takes(take)])

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        """Images of ``rows`` (at most ``bucket`` of them), in memory of
        their own."""
        tracer = self._tracer
        take = rows.shape[0]
        with tracer.span("stage"):
            self.stage(rows)
        if self.graph is None:
            with tracer.span("enqueue"):
                for s in self.shards:
                    s.body()
                return np.concatenate([s.out_dev[:n].numpy()
                                       for s, _, n in self._takes(take)])
        with tracer.span("enqueue"):
            got = self.enqueue(take)
        with tracer.span("wait"):
            self.wait()
        if got is not None:
            return got[1]
        with tracer.span("copy_out"):
            return self.images(got, take)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int
    out: Optional[np.ndarray] = None


class ServeEngine:
    """LM serving over a fixed batch of sequence slots (the JAX package's
    ``ServeEngine``): a static-batch `generate` and a continuous-batching
    `serve` with the reference's slot scheduler.  The model
    (`models.transformer.apply_lm`) runs eagerly on ``device`` ("cuda"
    unless the caller asks for "cpu"; a missing card raises), under
    ``torch.inference_mode``; each step's tokens come back to the host for
    the scheduler, as the reference's do.  Sampling draws from a
    ``torch.Generator`` of the device seeded with ``seed``.

    Every family serves through the same scheduler: the cache is a tree of
    KV caches and recurrent states (`models.transformer.init_cache`), and
    each step replaces it whole (a decode step holds the old cache and the
    new one; an admission drops the old one before its re-prefill), so an
    xlstm-1.3b batch of 4 never holds its 2.7 GB of mLSTM state more than
    twice.  A recurrent block runs through the left pads of a re-prefill
    as through any token, as in the reference."""

    def __init__(self, cfg, params, batch_size: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine(device='cuda') but no CUDA device "
                               "is available; pass device='cpu'")
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.batch = batch_size
        self.max_len = max_len
        self.temperature = temperature
        self.generator = torch.Generator(self.device).manual_seed(seed)
        # scheduler observability (reset per serve() call)
        self.prefill_steps = 0
        self.decode_steps = 0
        self.sample_steps = 0

    def _prefill(self, tokens: np.ndarray):
        with torch.inference_mode():
            cache = init_cache(self.cfg, self.batch, self.max_len,
                               self.device)
            logits, cache, _ = apply_lm(self.params, self.cfg,
                                        torch.from_numpy(tokens),
                                        mode="prefill", cache=cache)
        return logits[:, -1], cache

    def _decode(self, cache, tokens: torch.Tensor):
        with torch.inference_mode():
            logits, cache, _ = apply_lm(self.params, self.cfg, tokens,
                                        mode="decode", cache=cache)
        return logits[:, -1], cache

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self.generator, self.temperature)

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 eos_id: int = -1) -> np.ndarray:
        """prompts: (B, S) int32 (B == engine batch).  Static batch path."""
        assert prompts.shape[0] == self.batch
        logits, cache = self._prefill(np.asarray(prompts, np.int32))
        nxt = self._sample(logits)
        toks = [nxt.cpu().numpy()]
        for _ in range(max_new_tokens - 1):
            logits, cache = self._decode(cache, nxt[:, None])
            nxt = self._sample(logits)
            toks.append(nxt.cpu().numpy())
        return np.stack(toks, axis=1)

    # ------------------------------------------------------------------
    # continuous batching: slot scheduler over queued requests
    # ------------------------------------------------------------------
    def serve(self, requests: List[Request]) -> List[Request]:
        """Continuous batching over the fixed slot batch, as the
        reference's: a request is admitted the moment a slot frees;
        admission re-prefills the accumulated histories of every active
        slot, left-padded so all slots share the scalar cache position
        (left-pad tokens are ordinary tokens to the causal, unmasked
        model); between admissions every slot advances through one decode
        step.  Each request generates exactly its ``max_new_tokens``; a
        zero-budget request completes empty without a slot, and a
        history plus budget past ``max_len`` fails an assertion."""
        queue = list(requests)
        done: List[Request] = []
        slots: List[Optional[dict]] = [None] * self.batch
        self.prefill_steps = self.decode_steps = self.sample_steps = 0
        nxt = None
        cache = None
        while queue or any(s is not None for s in slots):
            admitted = False
            for i in range(self.batch):
                while slots[i] is None and queue:
                    r = queue.pop(0)
                    if r.max_new_tokens <= 0:
                        r.out = np.zeros((0,), np.int32)
                        done.append(r)
                        continue
                    slots[i] = {
                        "req": r,
                        "hist": [int(t) for t in np.asarray(r.prompt)],
                        "left": int(r.max_new_tokens),
                        "gen": [],
                    }
                    admitted = True
            if not any(s is not None for s in slots):
                break  # every remaining request was zero-budget
            if admitted:
                s_max = max(len(s["hist"]) for s in slots if s is not None)
                worst = s_max + max(s["left"] for s in slots
                                    if s is not None)
                assert worst <= self.max_len, (
                    f"history+budget ({worst}) exceeds max_len "
                    f"({self.max_len}); the KV cache would overflow")
                pad = np.zeros((self.batch, s_max), np.int32)
                for i, s in enumerate(slots):
                    if s is not None:
                        pad[i, s_max - len(s["hist"]):] = s["hist"]
                cache = None   # re-prefilled from the histories: let it go
                logits, cache = self._prefill(pad)
                self.prefill_steps += 1
            else:
                logits, cache = self._decode(cache, nxt[:, None])
                self.decode_steps += 1
            nxt = self._sample(logits)
            self.sample_steps += 1
            nxt_np = nxt.cpu().numpy()
            for i, s in enumerate(slots):
                if s is None:
                    continue
                tok = int(nxt_np[i])
                s["gen"].append(tok)
                s["hist"].append(tok)
                s["left"] -= 1
                if s["left"] == 0:
                    s["req"].out = np.asarray(s["gen"], np.int32)
                    done.append(s["req"])
                    slots[i] = None   # freed: admitted from queue next step
        return done


def pow2_buckets(max_batch: int) -> Tuple[int, ...]:
    """1, 2, 4, ... up to (and including) max_batch."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return tuple(sorted(set(out)))


def shard_aligned_buckets(buckets, n_shards: int) -> Tuple[int, ...]:
    """Round every bucket up to a multiple of the data-shard count (so each
    device owns an equal sub-batch) and dedupe.  n_shards=1 is identity."""
    if n_shards <= 1:
        return tuple(sorted(set(int(b) for b in buckets)))
    return tuple(sorted({-(-int(b) // n_shards) * n_shards for b in buckets}))


class DcnnServeEngine:
    """The paper's inference workload: batched image generation through
    fixed batch buckets, one pinned plan per bucket.

    * **Bucketing** — `plan_chunks` decomposes a request batch into bucket
      calls, trading padded rows against per-call overhead.
    * **Plan/execute** — each bucket's `NetworkPlan` and `ShardedExecutable`
      are built once (lazily, or at construction with ``warmup=True``) and
      every dispatch executes them unchanged; ``plan_stats`` counts plan
      builds, ``capture_counts`` executables.
    * **Queue** — ``submit`` enqueues rows, ``drain`` runs everything
      pending as one coalesced `generate`, ``collect`` hands a ticket's
      images out exactly once (or raises its typed failure).
    * **Timing** — ``throughput()`` reports per-bucket images/s and the
      run-to-run mean/std/CV of the per-dispatch wall clock, from padding
      the rows to the bucket to the images back on the host, started after
      a ``torch.cuda.synchronize()``; retried dispatches are tainted and
      kept out of those samples.
    * **Mesh** — with ``EngineConfig.mesh`` each bucket's batch splits
      over the mesh's data axis, one shard per device; buckets are rounded
      up to device-count multiples and plans fitted to `shard_batch`.
    * **Faults** — ``fault_stats`` counts retries, transient failures,
      stragglers, heartbeat fires, expired deadlines and sheds, and lists
      the remesh events of an elastic mesh (the JAX package's keys).
    """

    @classmethod
    def from_config(cls, cfg: EngineConfig, params, plan=None,
                    fault_injector=None, metrics=None) -> "DcnnServeEngine":
        """``params`` is a ``{"l{i}": {"w", "b"}}`` tree of float tensors
        (moved to the engine's device and cast to the tower's dtype; pruned
        for "cuda_sparse"); ``plan`` an optional pinned `NetworkPlan` (for
        example a JAX-pinned document after `for_hopper`) for the bucket
        whose per-device batch matches ``plan.batch``.  The plan passes the
        plan DRC first (`PlanCheckError` on a failure, before anything is
        planned, prepared, built or captured).  An int8 plan also supplies
        the calibration when ``cfg.quant_cfg`` is None, so a pinned
        deployment never re-calibrates.  ``fault_injector`` is an optional
        `dist.inject.FaultInjector` hooked before every bucket dispatch
        (fault drills); ``metrics`` an optional shared
        `obs.MetricsRegistry` (the async frontend passes one to every
        engine), else the engine makes its own."""
        self = cls.__new__(cls)
        # the device work of construction (params moved, calibrated,
        # quantized) stays out of other engines' captures
        with CAPTURE_GATE.shared():
            self._setup(cfg, params, plan, fault_injector, metrics)
        if cfg.warmup:
            for b in self.buckets:
                self._warmup_bucket(b)
        return self

    def _setup(self, config: EngineConfig, params, plan,
               fault_injector=None, metrics=None) -> None:
        self.config = config
        self.device = config.torch_device()
        self.mesh = config.mesh
        self.n_devices = self.mesh.data if self.mesh is not None else 1
        self.cfg = resolve_model(config.model)
        self.is_unet = isinstance(self.cfg, unet.UnetConfig)
        if self.is_unet:
            if config.precision != "fp32":
                raise unet.refuse(f"precision {config.precision!r}")
            if config.backend not in unet.BACKENDS:
                raise unet.refuse(f"backend {config.backend!r}")
            if config.mesh is not None:
                raise unet.refuse("a mesh")
        self.workload = workload_name_for(self.cfg)
        self.backend = config.backend
        self.precision = config.precision
        self.call_overhead_rows = config.call_overhead_rows
        self.quant_cfg = config.quant_cfg
        dtype = self.cfg.torch_dtype
        params = {k: {n: t.to(device=self.device, dtype=dtype)
                      for n, t in v.items()} for k, v in params.items()}
        self.buckets = shard_aligned_buckets(
            config.buckets if config.buckets
            else pow2_buckets(config.max_batch), self.n_devices)
        if plan is not None:
            # static DRC before anything is planned, prepared, built or
            # captured: a pinned plan that drifted from the code or was
            # resolved for another part is refused here with the
            # rule-by-rule report, not in a kernel's launch check
            from ..analysis.check.plan_drc import check_network_plan

            check_network_plan(plan, n_devices=self.n_devices,
                               buckets=self.buckets).raise_if_failed()
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive: {self.buckets}")
        self.max_bucket = self.buckets[-1]
        self.plans: Dict[int, object] = {}
        # launch_counts: per bucket, launches of the path's kernel by its
        # dispatches (on a card: per replay, the launches its capture
        # recorded; on the CPU: the wrapper's count over each eager run).
        # capture_counts: per bucket, executables built (one, ever).
        # wgmma_launch_counts: per bucket, those launches on the kernel's
        # wgmma path (a replay's, as its capture recorded them).
        self.launch_counts: Dict[int, int] = {}
        self.wgmma_launch_counts: Dict[int, int] = {}
        # kind_launch_counts: per bucket, a U-Net's launches by kind
        # (b1_enc, b1_dec, norm), a replay's as its capture recorded them
        # (on a card only, as wgmma_launch_counts)
        self.kind_launch_counts: Dict[int, Dict[str, int]] = {}
        self.capture_counts: Dict[int, int] = {}
        self._fns: Dict[int, ShardedExecutable] = {}
        # per batch shard, the launches' static operands under (layer, CIp,
        # COp), across buckets; they live as long as the engine (graphs
        # hold their addresses).  ``_static`` is the first shard's.
        self._statics: List[Dict[tuple, object]] = [
            {} for _ in range(self.n_devices)]
        self._static = self._statics[0]
        # per device, all its buckets' graphs share one memory pool
        # (dispatches never overlap) and one capture stream on that device
        # (torch.cuda.graph's default stream is made once per process, on
        # whichever device captured first)
        self._capture = {d: (torch.cuda.graph_pool_handle(),
                             torch.cuda.Stream(device=d))
                         for d in set(self._shard_devices())
                         if d.type == "cuda"}
        # guards every bucket's static buffers: generate may be called
        # outside drain, from another thread (CAPTURE_GATE orders it
        # against other engines' captures)
        self._dispatch_lock = threading.Lock()
        self._kernel = {("cuda", "fp32"): deconv_kernel,
                        ("cuda", "int8"): int8_kernel,
                        ("cuda_sparse", "fp32"): sparse_kernel}.get(
                            (self.backend, self.precision))
        # host schedules memoised under (layer, t_ci, t_co) across buckets;
        # their device copies once per bucket plan and shard
        self._sparse_tables: Dict[tuple, tuple] = {}
        self._sparse_device: Dict[tuple, Dict[int, tuple]] = {}
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
            seeded = [b for b in self.buckets
                      if self.shard_batch(b) == plan.batch]
            if not seeded:
                raise ValueError(
                    f"plan.batch={plan.batch} matches no bucket's per-device "
                    f"batch (buckets={self.buckets}, {self.n_devices} "
                    "device(s))")
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
            for b in seeded:
                self.plans[b] = plan
        if self.precision == "int8":
            from ..quant.calibrate import calibrate, quantize_params
            from ..quant.infer import pack_quantized_params
            from ..workloads import calibration_input

            if self.quant_cfg is None:
                z_cal = calibration_input(self.cfg, seed=config.calib_seed,
                                          batch=config.calib_batch)
                self.quant_cfg = calibrate(params, self.cfg,
                                           z_cal.to(self.device),
                                           strategy=config.calib_strategy)
            # the kernel's packed weights, once: no dispatch transposes one
            params = pack_quantized_params(
                quantize_params(params, self.cfg, self.quant_cfg,
                                device=self.device), self.cfg)
        self.params = params
        # one replica per batch shard: the first is ``params`` itself, the
        # others copies on their devices (even where a device repeats)
        self._replicas = [params] + replicate(
            params, self._shard_devices()[1:])
        # the U-Net's B1 operands, rearranged once (encoder convs in their
        # space-to-depth form); per bucket its "cuda" path's input buffers
        self._b1_params = ([unet.b1_weights(r, self.cfg)
                            for r in self._replicas] if self.is_unet
                           else None)
        self._workspaces: Dict[int, dict] = {}
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
        # the JAX package's keys; a U-Net engine also counts the request
        # bytes it stages (its rows are images)
        self.stats = {"generate_calls": 0, "images": 0, "padded_images": 0,
                      "device_count": self.n_devices}
        if self.is_unet:
            self.stats["input_bytes"] = 0
            self._row_bytes = 4 * int(np.prod(self.cfg.input_shape))
        self.bucket_stats: Dict[int, Dict[str, float]] = {}
        # the registry's series are written at the same sites as the dicts
        # above (one registry may hold a whole multi-engine deployment)
        self.metrics = (metrics if metrics is not None
                        else obsmetrics.MetricsRegistry())
        self._tracer = obstrace.get_tracer()
        self._mlabels = {"net": self.cfg.name, "workload": self.workload,
                         "precision": self.precision}
        self._m_dispatch = self.metrics.histogram(
            "engine.dispatch_seconds",
            "healthy steady-state dispatch wall clock (Table II samples)")
        self._m_plan_build = self.metrics.histogram(
            "engine.plan_build_seconds", "NetworkPlan build wall clock")
        self._m_tainted = self.metrics.counter(
            "engine.tainted_calls",
            "steady dispatches excluded from Table II (transient retries)")
        self._m_fault = self.metrics.counter(
            "engine.fault_events", "fault-path events by kind (label: event)")
        self._m_generate_calls = self.metrics.counter(
            "engine.generate_calls", "generate() invocations")
        self._m_images = self.metrics.counter(
            "engine.images", "useful (unpadded) images generated")
        self._m_padded = self.metrics.counter(
            "engine.padded_images", "padded rows burned on bucket alignment")
        self._m_devices = self.metrics.gauge(
            "engine.device_count", "devices serving this engine")
        if self.is_unet:
            # series of their own beside the JAX package's
            self._m_input_bytes = self.metrics.counter(
                "engine.input_bytes", "request bytes staged")
            self._m_kind_launches = self.metrics.counter(
                "engine.kernel_launches",
                "kernel launches of the dispatches by kind (label: kind: "
                "b1_enc, b1_dec, norm)")
        self._m_devices.set(self.n_devices, **self._mlabels)
        # fault machinery: injector hook, per-bucket straggler monitors over
        # the healthy steady samples, an optional stall heartbeat (armed
        # per dispatch attempt only), and the counters the bench reports
        self.fault_injector = fault_injector
        self._stragglers: Dict[int, StragglerMonitor] = {}
        self._dispatches = 0
        self.fault_stats = {
            "retries": 0, "transient_failures": 0, "stragglers": 0,
            "heartbeat_fires": 0, "deadline_expired": 0, "shed": 0,
            "remesh_events": [],
        }
        self._heartbeat = None
        if config.heartbeat_timeout_s is not None:
            self._heartbeat = Heartbeat(config.heartbeat_timeout_s,
                                        self._on_stall)
            self._heartbeat.disarm()

    # -- per-bucket plans -----------------------------------------------
    def _shard_devices(self) -> Tuple[torch.device, ...]:
        """The device of each batch shard, in shard order."""
        if self.mesh is None:
            return (self.device,)
        return self.mesh.data_devices

    def shard_batch(self, bucket: int) -> int:
        """The batch one device runs for a bucket (the bucket itself on one
        device); plans and tiles are fitted to it."""
        return bucket // self.n_devices

    def _plan_for(self, bucket: int):
        """The bucket's pinned `NetworkPlan` (at its per-device batch),
        built on first use."""
        if bucket not in self.plans:
            from ..plan import build_network_plan

            t0 = obsclock.now()
            self.plans[bucket] = build_network_plan(
                self.cfg, batch=self.shard_batch(bucket),
                backend=self.backend,
                precision=self.precision, quant_cfg=self.quant_cfg,
                params=(self.params if self.backend == "cuda_sparse"
                        else None),
                sparse_table_cache=self._sparse_tables,
                refine=self.config.refine)
            dt = obsclock.now() - t0
            self.plan_stats["builds"] += 1
            self.plan_stats["build_seconds"] += dt
            self._m_plan_build.observe(dt, bucket=bucket, **self._mlabels)
            if self._tracer.enabled:
                self._tracer.complete(f"plan_build b{bucket}", t0, t0 + dt,
                                      cat="engine", bucket=bucket,
                                      **self._mlabels)
        return self.plans[bucket]

    def _apply(self, bucket: int, plan, z: torch.Tensor,
               shard: int = 0) -> torch.Tensor:
        """The generator of the engine's path on one padded bucket (on a
        mesh: one shard of it, on that shard's device), on the shard's
        params and prepared static operands."""
        params = self._replicas[shard]
        if self.is_unet:
            return unet.unet_apply(
                params, self.cfg, z, plan=plan,
                prepared=self._prepared(plan, shard),
                workspace=self._workspaces.setdefault(bucket, {}))
        if self.precision == "int8":
            from ..quant.infer import quantized_generator_apply

            return quantized_generator_apply(params, self.cfg,
                                             self.quant_cfg, z, plan=plan)
        sparse = None
        if self.backend == "cuda_sparse":
            from ..kernels.deconv2d_sparse import schedule_tensors

            sparse = self._sparse_device.get((bucket, shard))
            if sparse is None:
                sparse = self._sparse_device[bucket, shard] = {
                    i: schedule_tensors(t, z.device)
                    for i, t in plan.sparse_plans().items()}
        return generator_apply(params, self.cfg, z, plan=plan,
                               sparse_plans=sparse,
                               prepared=self._prepared(plan, shard))

    def _prepared(self, plan, shard: int = 0) -> Optional[Dict[int, object]]:
        """Per layer the `StaticOperands` of ``plan``'s tiles on the shard's
        device, prepared at the first plan that needs them and held (None
        on untiled backends); a layer whose fp32 tiles take the wgmma path
        gets its weight packed CI-minor once too (`ops.with_ci_minor`)."""
        if self.backend not in ("cuda", "cuda_sparse"):
            return None
        from ..kernels.deconv2d.ops import (_round_up, prepare_static,
                                            takes_fp32_wgmma, with_ci_minor)

        out = {}
        for i, l in enumerate(plan.layers):
            g, t = l.geometry, l.tiles
            key = (i, _round_up(g.c_in, t.t_ci), _round_up(g.c_out, t.t_co))
            statics = self._statics[shard]
            st = statics.get(key)
            if st is None:
                p = (self._b1_params[shard][i] if self.is_unet
                     else self._replicas[shard][f"l{i}"])
                st = statics[key] = prepare_static(p["w"], p["b"], *key[1:])
            if st.wt is None and st.w.device.type == "cuda" and \
                    takes_fp32_wgmma(l):
                st = statics[key] = with_ci_minor(st)
            out[i] = st
        return out

    def _get_fn(self, bucket: int) -> ShardedExecutable:
        """The bucket's executable, built once from its pinned plan, with
        `CAPTURE_GATE` held exclusive (planning may time tiles on the
        card)."""
        ex = self._fns.get(bucket)
        if ex is None:
            with CAPTURE_GATE.exclusive():
                ex = self._fns[bucket] = self._build(bucket,
                                                     self._plan_for(bucket))
            self.capture_counts[bucket] = \
                self.capture_counts.get(bucket, 0) + 1
        return ex

    def _build(self, bucket: int, plan) -> ShardedExecutable:
        """The bucket's executable: a `BucketExecutable` per batch shard."""
        return ShardedExecutable(bucket, [
            self._build_shard(bucket, plan, i)
            for i in range(self.n_devices)])

    def _build_shard(self, bucket: int, plan, shard: int) -> BucketExecutable:
        """One shard's `BucketExecutable` at the per-device batch, on the
        shard's device.  On a card: one eager pass (it builds the kernel
        library, sets the kernels' shared-memory attribute, copies the
        schedules, prepares the static operands and warms the allocator),
        then the capture of everything from the static input to the static
        output on a side stream, in thread-local mode (`CAPTURE_GATE` keeps
        the engines' dispatches out of it; other threads' CUDA work does
        not break it).  On the CPU the body runs eagerly at each dispatch.
        The static input and output are float32 whatever the tower's
        dtype: the body casts z to it and the images back."""
        dtype = torch.float32
        device = self._shard_devices()[shard]
        rows = self.shard_batch(bucket)
        z_dev = torch.zeros((rows,) + self.cfg.input_shape, dtype=dtype,
                            device=device)
        out_dev = torch.empty((rows,) + self.output_shape, dtype=dtype,
                              device=device)

        def body():
            with torch.no_grad():
                out_dev.copy_(self._apply(bucket, plan, z_dev, shard))

        if device.type == "cpu":
            return BucketExecutable(rows, body, z_dev, out_dev, z_dev,
                                    out_dev)
        try:
            with torch.cuda.device(device):
                body()
                torch.cuda.synchronize(device)
                graph = torch.cuda.CUDAGraph()
                pool, stream = self._capture[device]
                before = self._launches()
                wg_before = self._wgmma_launches()
                kinds_before = dict(unet.LAUNCHES) if self.is_unet else {}
                capturing = self._tracer.span("capture", cat="engine",
                                              bucket=bucket, **self._mlabels)
                # a collection inside the capture could free a dropped
                # engine's graph or pinned buffers: calls a capture refuses
                # (torch.cuda.graph collects before it begins)
                gc_on = gc.isenabled()
                gc.disable()
                try:
                    with capturing, torch.cuda.graph(
                            graph, pool=pool, stream=stream,
                            capture_error_mode="thread_local"):
                        body()
                finally:
                    if gc_on:
                        gc.enable()
                launches = self._launches() - before
                wgmma_launches = self._wgmma_launches() - wg_before
                kinds = {k: unet.LAUNCHES[k] - v
                         for k, v in kinds_before.items()
                         if unet.LAUNCHES[k] > v}
        except Exception as e:
            where = f" shard {shard} ({device})" if self.mesh is not None else ""
            raise RuntimeError(f"bucket {bucket}{where}: capturing its CUDA "
                               f"graph failed: {e}") from e
        z_host = torch.zeros(z_dev.shape, dtype=dtype, pin_memory=True)
        out_host = torch.empty(out_dev.shape, dtype=dtype, pin_memory=True)
        return BucketExecutable(rows, body, z_dev, out_dev, z_host,
                                out_host, graph, launches, wgmma_launches,
                                kinds)

    @property
    def total_captures(self) -> int:
        """Executables built over all buckets."""
        return sum(self.capture_counts.values())

    def _warmup_bucket(self, bucket: int) -> None:
        """Build the bucket's executable and run it once, outside the fault
        injector and the timing stats."""
        z = np.zeros((bucket,) + self.cfg.input_shape, np.float32)
        with self._dispatch_lock:
            ex = self._get_fn(bucket)
        made = self._call(bucket, ex, z, inject=False)[3]
        with self._qlock:
            self._add_launches_locked(bucket, made)

    def _sync(self) -> None:
        for device in set(self._shard_devices()):
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    # -- guarded dispatch -----------------------------------------------
    def _on_stall(self) -> None:
        # heartbeat callback, on the watcher thread: a dispatch attempt has
        # been silent past the timeout.  It only counts: no CUDA call may
        # run here (a synchronise would break another thread's capture).
        self._count_fault("heartbeat_fires")
        if self._tracer.enabled:
            self._tracer.instant("heartbeat_fire", cat="fault",
                                 **self._mlabels)

    def _count_fault(self, event: str) -> None:
        with self._qlock:
            self.fault_stats[event] += 1
        self._m_fault.inc(event=event, **self._mlabels)

    def close(self) -> None:
        """Release the stall-watcher thread (no-op without a heartbeat)."""
        if self._heartbeat is not None:
            self._heartbeat.close()

    def _call(self, bucket: int, ex: ShardedExecutable, rows: np.ndarray,
              inject: bool = True, retried: bool = False):
        """One attempt of a bucket call on ``rows`` (at most ``bucket`` of
        them): ``(images, seconds, steady, launches)``.  The clock starts
        after the stream has synchronised and runs over the injector's
        hook, staging the rows (padded with zeros to the bucket), the
        host-to-device copy, the replay (on the CPU the eager run) and the
        device-to-host copy of the images; the heartbeat is armed over the
        same window, and the ``dispatch b{n}`` span covers it (every
        attempt, the warm-up's too; ``retried`` is its argument).  Before
        it, ``lock`` spans the wait for the dispatch lock and
        `CAPTURE_GATE`, and ``sync`` the device-wide synchronise.  The
        first call of a bucket is not steady and stays out of the timing
        stats.  ``images`` is a new array each call; ``launches`` counts
        the path's kernel launches it made (`_account` adds them up)."""
        tracer = self._tracer
        waiting = tracer.span("lock").__enter__()
        with self._dispatch_lock:
            with CAPTURE_GATE.shared():
                waiting.__exit__(None, None, None)
                launches0 = self._launches()
                with tracer.span("sync"):
                    self._sync()
                steady = bucket in self._warm
                window = (tracer.span(f"dispatch b{bucket}", cat="engine",
                                      bucket=bucket, steady=steady,
                                      retried=retried,
                                      input_bytes=int(rows.nbytes),
                                      **self._mlabels)
                          if tracer.enabled else obstrace.NULL)
                if self._heartbeat is not None:
                    self._heartbeat.arm()
                try:
                    with window:
                        t0 = obsclock.now()
                        if inject and self.fault_injector is not None:
                            self.fault_injector.before_call(bucket)
                        images = ex(rows)
                        dt = obsclock.now() - t0
                finally:
                    if self._heartbeat is not None:
                        self._heartbeat.disarm()
                made = (ex.launches if ex.launches is not None
                        else self._launches() - launches0)
            self._warm.add(bucket)
        return images, dt, steady, made

    def _dispatch(self, bucket: int, rows: np.ndarray):
        """One guarded bucket dispatch: ``(images, seconds, steady,
        retried, launches)``.  The executable is built first, once; each
        attempt replays it (`_call`).  `TransientCallError` is retried up
        to ``max_retries`` times with exponential backoff, slept outside
        the dispatch lock and `CAPTURE_GATE`, then raised as
        `EngineDegraded`; ``retried`` says a retry preceded the success.
        `DeviceLossError` escapes to `generate`."""
        with self._dispatch_lock:
            ex = self._get_fn(bucket)
        tracer = self._tracer
        attempts = self.config.max_retries + 1
        for attempt in range(attempts):
            try:
                images, dt, steady, made = self._call(
                    bucket, ex, rows, retried=attempt > 0)
            except TransientCallError as e:
                self._count_fault("transient_failures")
                if tracer.enabled:
                    tracer.instant("transient_failure", cat="fault",
                                   bucket=bucket, attempt=attempt,
                                   **self._mlabels)
                if attempt + 1 >= attempts:
                    raise EngineDegraded(
                        f"bucket-{bucket} call failed {attempts} "
                        "time(s); retries exhausted") from e
                self._count_fault("retries")
                if tracer.enabled:
                    tracer.instant("retry", cat="fault", bucket=bucket,
                                   attempt=attempt, **self._mlabels)
                time.sleep(self.config.retry_backoff_s * (2 ** attempt))
                continue
            return images, dt, steady, attempt > 0, made

    def _add_launches_locked(self, bucket: int, made: int) -> None:
        self.launch_counts[bucket] = (self.launch_counts.get(bucket, 0)
                                      + made)
        # one replay a dispatch: its capture's wgmma launches
        ex = self._fns.get(bucket)
        wg = ex.wgmma_launches if ex is not None else 0
        if wg:
            self.wgmma_launch_counts[bucket] = (
                self.wgmma_launch_counts.get(bucket, 0) + wg)
        if ex is not None and ex.kind_launches:
            counts = self.kind_launch_counts.setdefault(bucket, {})
            for kind, k in ex.kind_launches.items():
                counts[kind] = counts.get(kind, 0) + k
                self._m_kind_launches.inc(k, kind=kind, bucket=bucket,
                                          **self._mlabels)

    def _account(self, bucket: int, take: int, dt: float, steady: bool,
                 retried: bool, made: int) -> None:
        """A served dispatch's bookkeeping: its launches, the straggler
        monitor (fed only steady, unretried samples), the padded rows and
        the Table II samples, in the dicts and the registry."""
        flagged = False
        with self._qlock:
            self._add_launches_locked(bucket, made)
            self._dispatches += 1
            if steady and not retried:
                # a retried dispatch must not seed the straggler baseline
                mon = self._stragglers.get(bucket)
                if mon is None:
                    mon = self._stragglers[bucket] = StragglerMonitor(
                        factor=self.config.straggler_factor,
                        warmup_steps=self.config.straggler_warmup)
                flagged = mon.observe(self._dispatches, dt)
        if flagged:
            self._count_fault("stragglers")
            if self._tracer.enabled:
                self._tracer.instant("straggler", cat="fault",
                                     bucket=bucket, seconds=dt,
                                     **self._mlabels)
        if self.is_unet:
            self.stats["input_bytes"] += take * self._row_bytes
            self._m_input_bytes.inc(take * self._row_bytes, **self._mlabels)
        pad = bucket - take
        if pad:
            self.stats["padded_images"] += pad
            self._m_padded.inc(pad, **self._mlabels)
        if not steady:
            return
        bs = self.bucket_stats.setdefault(
            bucket, {"calls": 0, "images": 0, "seconds": 0.0,
                     "sumsq_seconds": 0.0, "tainted_calls": 0,
                     "tainted_seconds": 0.0})
        if retried:
            # real work, but not a healthy run: out of the Table II
            # mean/std/CV samples
            bs["tainted_calls"] += 1
            bs["tainted_seconds"] += dt
            self._m_tainted.inc(bucket=bucket, **self._mlabels)
        else:
            bs["calls"] += 1
            bs["images"] += take
            bs["seconds"] += dt
            bs["sumsq_seconds"] += dt * dt
            self._m_dispatch.observe(dt, bucket=bucket, **self._mlabels)

    def _remesh(self, keep: int) -> None:
        """Elastic recovery from a device loss, as the JAX engine's: shrink
        onto the surviving ``keep``-device prefix of the mesh, re-align the
        bucket set to the new device count, keep the survivors' replicas,
        drop every executable, re-plan every bucket and DRC each plan
        again, recording `plan.executable_fingerprints` before and after,
        so that "the same plan for the same per-device batch" is asserted,
        not assumed: a hash mismatch raises `EngineDegraded`.  The event
        goes to ``fault_stats["remesh_events"]``, ``stats["device_count"]``
        and the ``engine.device_count`` gauge, and a ``remesh`` tracer
        instant."""
        if self.mesh is None or not self.config.elastic:
            raise EngineDegraded(
                "device loss without an elastic mesh: nothing to shrink "
                "onto (serve with mesh=... and elastic=True)")
        from ..analysis.check.plan_drc import check_network_plan
        from ..plan import executable_fingerprints

        t0 = obsclock.now()
        devs = list(self.mesh.devices)
        if not 1 <= keep <= len(devs):
            raise EngineDegraded(
                f"cannot remesh: {keep} survivor(s) of {len(devs)} "
                "device(s)")
        before = executable_fingerprints(self.plans.values())
        devices_before = self.n_devices
        # planning may time tiles on the card: no capture runs meanwhile
        with CAPTURE_GATE.exclusive():
            self.mesh = elastic_mesh(devs[:keep],
                                     model_parallel=self.mesh.model)
            self.n_devices = self.mesh.data
            # the survivors keep their replicas, static operands and pools
            self._replicas = self._replicas[:self.n_devices]
            self._statics = self._statics[:self.n_devices]
            self.buckets = shard_aligned_buckets(
                self.config.buckets if self.config.buckets
                else pow2_buckets(self.config.max_batch), self.n_devices)
            self.max_bucket = self.buckets[-1]
            # executables and plans were fitted to the old device count;
            # re-plan everything up front (recovery pays it once)
            self._fns.clear()
            self._sparse_device.clear()
            with self._qlock:
                self._stragglers.clear()
            self._warm.clear()
            self.plans = {}
            for b in self.buckets:
                check_network_plan(self._plan_for(b),
                                   n_devices=self.n_devices,
                                   buckets=self.buckets).raise_if_failed()
        after = executable_fingerprints(self.plans.values())
        matches = {sb: after[sb] == h for sb, h in before.items()
                   if sb in after}
        self.stats["device_count"] = self.n_devices
        # timing samples of the lost mesh describe a capacity that no longer
        # exists: snapshot them into the event and start afresh
        stats_before = {b: dict(st) for b, st in self.bucket_stats.items()}
        self.bucket_stats = {}
        event = {
            "bucket_stats_before": stats_before,
            "devices_before": devices_before,
            "devices_after": self.n_devices,
            "buckets": list(self.buckets),
            "plan_hashes_before": before,
            "plan_hashes_after": after,
            "plan_hash_matches": matches,
            "seconds": obsclock.now() - t0,
        }
        with self._qlock:
            self.fault_stats["remesh_events"].append(event)
        self._m_fault.inc(event="remesh_events", **self._mlabels)
        self._m_devices.set(self.n_devices, **self._mlabels)
        if self._tracer.enabled:
            self._tracer.instant("remesh", cat="fault",
                                 devices_before=devices_before,
                                 devices_after=self.n_devices,
                                 seconds=event["seconds"], **self._mlabels)
        if not all(matches.values()):
            raise EngineDegraded(
                f"post-remesh plan hash mismatch {matches}: the shrunken "
                "mesh did not re-derive the validated executables")

    def _launches(self) -> int:
        """Launches so far of the kernel of the engine's path through its
        Python wrapper (the module's ``LAUNCHES``: eager runs and captures;
        a replay does not pass through it).  0 on the backends without
        one."""
        return self._kernel.LAUNCHES if self._kernel is not None else 0

    def _wgmma_launches(self) -> int:
        """`_launches` on the kernel's wgmma path (``WGMMA_LAUNCHES``; 0
        where the kernel has none)."""
        return getattr(self._kernel, "WGMMA_LAUNCHES", 0)

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
        """Images of z: (B, *input_shape) for ANY B, any float dtype,
        chunked and padded to the bucket set via `plan_chunks`.  Returns
        float32 ``(B, H, W, C)``; for a bf16 tower every value is a bf16
        value (the JAX package returns the bf16 array itself).

        A transient dispatch failure retries inside `_dispatch`; a retried
        dispatch counts as ``tainted_calls``/``tainted_seconds`` and stays
        out of the timing samples.  A device loss remeshes onto the
        survivors of an elastic mesh (`_remesh`); then the interrupted
        chunk and everything after it are re-chunked against the new
        bucket set and run there.  Without an elastic mesh it raises
        `EngineDegraded`."""
        z = np.asarray(z, dtype=np.float32)
        n = z.shape[0]
        tracer = self._tracer
        with (tracer.span("generate", cat="engine", req=next(_REQUESTS),
                          rows=n, **self._mlabels)
              if tracer.enabled else obstrace.NULL):
            outs: List[np.ndarray] = []
            i = 0
            chunks = self.plan_chunks(n)
            while chunks:
                take, bucket = chunks[0]
                try:
                    y, dt, steady, retried, made = self._dispatch(
                        bucket, z[i:i + take])
                except DeviceLossError as e:
                    try:
                        self._remesh(e.keep)
                    except EngineDegraded as err:
                        raise err from e
                    chunks = self.plan_chunks(n - i)
                    continue
                chunks.pop(0)
                with tracer.span("account"):
                    self._account(bucket, take, dt, steady, retried, made)
                outs.append(y)
                i += take
            with tracer.span("account"):
                self.stats["generate_calls"] += 1
                self.stats["images"] += n
                self._m_generate_calls.inc(**self._mlabels)
                self._m_images.inc(n, **self._mlabels)
            if not outs:
                return np.zeros((0,) + self.output_shape, np.float32)
            if len(outs) == 1:
                return outs[0]
            with tracer.span("concat"):
                return np.concatenate(outs, axis=0)

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        return (self.cfg.img_hw, self.cfg.img_hw, self.cfg.img_c)

    def throughput(self) -> Dict[int, Dict[str, float]]:
        """Per-bucket steady-state serving rates: useful images/s, and the
        run-to-run mean, std and CV (std/mean) of the per-dispatch wall
        clock (the paper's Table II methodology).  A dispatch's clock runs
        from padding its rows to the bucket to its images on the host (both
        copies included); the host work between dispatches of one
        `generate` (chunking, the final concatenation) is not in it.  Only
        healthy dispatches feed these; retried ones surface as
        ``tainted_calls``/``tainted_seconds`` beside them."""
        out = {}
        for bucket, bs in self.bucket_stats.items():
            if bs["seconds"] <= 0.0:
                continue
            rate = bs["images"] / bs["seconds"]
            mean_s = bs["seconds"] / bs["calls"]
            var = max(0.0, bs["sumsq_seconds"] / bs["calls"] - mean_s ** 2)
            std_s = var ** 0.5
            out[bucket] = {
                "img_per_s": rate,
                "img_per_s_per_device": rate / self.n_devices,
                "calls": bs["calls"],
                "mean_s": mean_s,
                "std_s": std_s,
                "cv": std_s / max(mean_s, 1e-12),
                "tainted_calls": bs["tainted_calls"],
                "tainted_seconds": bs["tainted_seconds"],
            }
        return out

    def service_estimate(self, bucket: int) -> Optional[float]:
        """Best current estimate of one steady dispatch's wall clock for
        ``bucket``: the bucket's `StragglerMonitor` EMA when it has
        observations (tracks drift, ignores outliers), else the healthy
        mean, else None.  The async frontend's capacity signal."""
        mon = self._stragglers.get(bucket)
        if mon is not None and mon.estimate() is not None:
            return mon.estimate()
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
        it with `DeadlineExceeded` instead of executing stale work.  z is
        any float array, taken as float32 (as in `generate`)."""
        z = np.asarray(z, dtype=np.float32)
        if z.ndim == len(self.cfg.input_shape):
            z = z[None]
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        deadline = (None if deadline_s is None
                    else obsclock.now() + deadline_s)
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
                    self._m_fault.inc(event="shed", **self._mlabels)
                    if self._tracer.enabled:
                        self._tracer.instant("shed", cat="fault", rid=rid,
                                             **self._mlabels)
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
            now = obsclock.now()
            for rid, z, deadline in reqs:
                if deadline is not None and now > deadline:
                    self.fault_stats["deadline_expired"] += 1
                    self._failures[rid] = DeadlineExceeded(
                        f"ticket {rid} missed its deadline by "
                        f"{now - deadline:.3f}s before execution")
                    self._m_fault.inc(event="deadline_expired",
                                      **self._mlabels)
                    if self._tracer.enabled:
                        self._tracer.instant("deadline_expired",
                                             cat="fault", rid=rid,
                                             **self._mlabels)
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
                    else obsclock.now() + timeout_s)
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
                         else deadline - obsclock.now())
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
