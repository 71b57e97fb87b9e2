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
                      or a registered `repro_torch.workloads` name
                      ("mnist", "celeba"); unknown names raise a typed
                      `UnknownWorkloadError`.
    * ``backend``   — deconv formulation: "cuda" (the hand-written kernel),
                      "cudnn" or "reverse_loop".
    * ``precision`` — "fp32" (int8 arrives with its kernel).
    * ``buckets``/``max_batch`` — explicit bucket set, or power-of-two
                      buckets up to ``max_batch``.
    * ``warmup``    — run every bucket once at construction.
    * ``call_overhead_rows`` — chunk-planning cost of one extra dispatch.
    * ``default_deadline_s`` — queue deadline applied to `submit` when the
                      caller gives none (`DeadlineExceeded` when missed).
    * ``device``    — where the engine runs: "cuda" unless the caller asks
                      for "cpu".  A missing card raises; the engine never
                      carries on quietly on the CPU.
    """

    model: Any
    backend: str = "cuda"
    precision: str = "fp32"
    max_batch: int = 64
    buckets: Optional[Tuple[int, ...]] = None
    warmup: bool = False
    call_overhead_rows: int = 8
    default_deadline_s: Optional[float] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.precision != "fp32":
            raise ValueError(f"precision {self.precision!r} is not served by "
                             "this package yet; only 'fp32' is")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {BACKENDS}")

    def torch_device(self) -> torch.device:
        """The engine's device; raises if it is a CUDA device and no card
        is present."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"EngineConfig.device={self.device!r} but no CUDA device is "
                "available; pass device='cpu' to serve on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device!r}")
        return dev
