"""The system under test for the pix2pix U-Net: `repro_torch`'s
`DcnnServeEngine` serving a `models.unet.UnetConfig` on the fp32 "cuda"
path (16 B1 launches and 15 launches of the norm kernel a dispatch, one
CUDA graph replayed per bucket), built from a configuration's sizes and
the benchmark's own weights.

What the benchmark takes from the program: ``generate`` (the entry the
window drives; a request is (rows, H, W, C) images, here the pool's flat
rows seen as NHWC), the engine's ``images`` / ``padded_images`` /
``input_bytes`` counters, its chunk plan, its host spans, and the B1
kernel's name in the device trace."""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

# the fp32 kernel of `src/repro_torch/csrc/deconv2d_tc.cu` (B1); the norm
# kernel (`norm_act_kernel`) does not match
MAIN_KERNEL = re.compile(r"deconv2d_tc_kernel")


class System:
    def __init__(self, cfg: dict, traffic: dict, weights, device):
        from repro_torch.models.unet import UnetConfig
        from repro_torch.obs import trace as obstrace
        from repro_torch.serve import DcnnServeEngine, EngineConfig

        if cfg["dtype"] != "float32":
            raise ValueError(f"{cfg['name']}: this system serves float32, "
                             f"not {cfg['dtype']}")
        model = UnetConfig(name=cfg["name"], in_hw=cfg["in_hw"],
                           in_c=cfg["in_c"], out_c=cfg["out_c"],
                           ngf=cfg["ngf"], num_downs=cfg["num_downs"],
                           eps=cfg["eps"], slope=cfg["slope"])
        self.shape = model.input_shape
        buckets = traffic.get("buckets")
        self.engine = DcnnServeEngine.from_config(EngineConfig(
            model=model, backend="cuda", precision="fp32",
            buckets=tuple(buckets) if buckets else None,
            max_batch=int(traffic.get("max_batch", 16)),
            warmup=True, refine=False, device=str(device)), weights)
        self.launches_per_dispatch = len(model.layers)
        self._tracer = obstrace.get_tracer()

    def serve(self, z: np.ndarray) -> np.ndarray:
        return self.engine.generate(z.reshape((z.shape[0],) + self.shape))

    def dispatches(self, rows: int) -> List[int]:
        """The buckets that a request of ``rows`` dispatches."""
        return [b for _, b in self.engine.plan_chunks(rows)]

    def counters(self) -> Dict[str, int]:
        s = self.engine.stats
        return {"images": s["images"], "padded_images": s["padded_images"],
                "input_bytes": s["input_bytes"]}

    def spans_on(self) -> None:
        self._tracer.clear()
        self._tracer.enable()

    def spans_off(self) -> List[tuple]:
        """``(name, start, end)`` of the program's host spans since
        `spans_on`, in ``perf_counter`` nanoseconds."""
        self._tracer.disable()
        return [(e["name"], int(e["ts"] * 1e3),
                 int((e["ts"] + e["dur"]) * 1e3))
                for e in self._tracer.events() if e["ph"] == "X"]

    def close(self) -> None:
        self.engine.close()
        self.engine = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
