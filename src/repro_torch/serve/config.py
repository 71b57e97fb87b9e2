"""Engine configuration for the DCNN serving path."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..models.dcnn import BACKENDS


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything a `DcnnServeEngine` needs besides params and plans.

    * ``model``     — the tower being served: a `models.dcnn.DcnnConfig`
                      (its ``dtype`` "float32" or "bfloat16") or a
                      registered `repro_torch.workloads` name ("mnist",
                      "celeba", "sr", "denoise", or an alias); unknown
                      names raise a typed `UnknownWorkloadError`.
    * ``backend``   — deconv formulation: "cuda" (the hand-written kernel),
                      "cuda_sparse" (the zero-skip kernel on pruned
                      params; fp32), "cudnn" or "reverse_loop".
    * ``precision`` — "fp32", or "int8" on "cuda" (the int8 kernel chain).
    * ``quant_cfg`` — a pre-computed `quant.QuantConfig` for int8; None
                      self-calibrates with the ``calib_*`` knobs on
                      `workloads.calibration_input` (or takes the
                      calibration pinned in a provided int8 plan).
    * ``mesh``      — an optional `launch.mesh.DeviceMesh`: every
                      bucket's batch splits over the mesh's data axis,
                      buckets round up to multiples of the device count,
                      params replicate on every device, and the engine
                      runs on the mesh's devices (``device`` is then not
                      read).
    * ``buckets``/``max_batch`` — explicit bucket set, or power-of-two
                      buckets up to ``max_batch``.
    * ``warmup``    — build every bucket's executable (its plan and, on a
                      card, its CUDA graph) at construction.
    * ``refine``    — tiles when a bucket is planned
                      (`kernels.autotune.choose_tiles`): a timed entry of
                      the tile cache where there is one, else the model's
                      pick (False) or candidates timed on the card, the
                      fastest stored (True).  A pinned plan keeps its
                      tiles.
    * ``call_overhead_rows`` — chunk-planning cost of one extra dispatch.

    Fault-tolerance knobs (`serve.errors` / `dist.fault` semantics):

    * ``max_retries``/``retry_backoff_s`` — bounded retry with
      exponential backoff for transient bucket-call failures; exhausted
      retries raise `EngineDegraded` instead of looping.  A retry replays
      the bucket's executable again (no new capture), and its backoff
      holds neither the engine's dispatch lock nor `CAPTURE_GATE`.
    * ``heartbeat_timeout_s`` — when set, a `dist.fault.Heartbeat` is
      armed around every dispatched call: a call silent longer than this
      is recorded as a stall in ``fault_stats`` (None: no watcher
      thread).
    * ``straggler_factor``/``straggler_warmup`` — per-bucket
      `StragglerMonitor` over the steady-state per-call wall clock (the
      same samples `throughput()` reports); flagged calls count into
      ``fault_stats["stragglers"]``.
    * ``default_deadline_s`` — queue deadline applied to `submit` when
      the caller gives none; an expired ticket fails typed
      (`DeadlineExceeded`) instead of executing stale work.
    * ``elastic``   — on a device loss, remesh onto the survivors,
                      re-align the buckets and re-plan (needs a mesh;
                      False, or no mesh: the loss raises `EngineDegraded`).
    * ``device``    — where the engine runs: "cuda" unless the caller asks
                      for "cpu".  A missing card raises; the engine never
                      carries on quietly on the CPU.
    """

    model: Any
    backend: str = "cuda"
    precision: str = "fp32"
    quant_cfg: Any = None
    mesh: Any = None
    calib_batch: int = 64
    calib_seed: int = 0
    calib_strategy: str = "mean_ksigma"
    max_batch: int = 64
    buckets: Optional[Tuple[int, ...]] = None
    warmup: bool = False
    call_overhead_rows: int = 8
    max_retries: int = 2
    retry_backoff_s: float = 0.05
    heartbeat_timeout_s: Optional[float] = None
    straggler_factor: float = 3.0
    straggler_warmup: int = 3
    default_deadline_s: Optional[float] = None
    elastic: bool = True
    device: str = "cuda"
    refine: bool = False

    def __post_init__(self):
        if self.precision not in ("fp32", "int8"):
            raise ValueError(f"unknown precision {self.precision!r}; "
                             "expected 'fp32' or 'int8'")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {BACKENDS}")
        if self.precision == "int8" and self.backend != "cuda":
            raise ValueError("precision='int8' runs the dense int8 kernel; "
                             f"backend={self.backend!r} has no quantized "
                             "variant")

    def torch_device(self) -> torch.device:
        """The engine's device (the mesh's first where there is a mesh);
        raises if it is a CUDA device and no card is present."""
        dev = (self.mesh.devices[0] if self.mesh is not None
               else torch.device(self.device))
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"EngineConfig.device={str(dev)!r} but no CUDA device is "
                "available; pass device='cpu' to serve on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {str(dev)!r}")
        return dev
