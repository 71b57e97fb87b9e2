"""The system under test for the DCNN towers: `repro_torch`'s
`DcnnServeEngine` on the fp32 "cuda" path (the hand-written B1 kernel, one
CUDA graph replayed per bucket), built from a configuration's sizes and
the benchmark's own weights.

What the benchmark takes from the program: ``generate`` (the entry the
window drives), the engine's ``images`` / ``padded_images`` counters, its
chunk plan (which buckets a request dispatches), its host spans
(``generate``, ``dispatch b{n}``), and the main kernel's name in the
device trace."""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

# the fp32 kernel of `src/repro_torch/csrc/deconv2d_tc.cu`
MAIN_KERNEL = re.compile(r"deconv2d_tc_kernel")


class System:
    def __init__(self, cfg: dict, traffic: dict, weights, device):
        from repro_torch.models.dcnn import DcnnConfig, DeconvLayerCfg
        from repro_torch.obs import trace as obstrace
        from repro_torch.serve import DcnnServeEngine, EngineConfig

        if cfg["dtype"] != "float32":
            raise ValueError(f"{cfg['name']}: this system serves float32 "
                             f"towers, not {cfg['dtype']}")
        tower = DcnnConfig(
            name=cfg["name"], z_dim=cfg["z_dim"], img_hw=cfg["img_hw"],
            img_c=cfg["img_c"], dtype="float32",
            layers=tuple(DeconvLayerCfg(l["c_in"], l["c_out"], l["kernel"],
                                        l["stride"], l["padding"],
                                        l["activation"])
                         for l in cfg["layers"]))
        params = {f"l{i}": {"w": w, "b": b}
                  for i, (w, b) in enumerate(weights)}
        buckets = traffic.get("buckets")
        self.engine = DcnnServeEngine.from_config(EngineConfig(
            model=tower, backend="cuda", precision="fp32",
            buckets=tuple(buckets) if buckets else None,
            max_batch=int(traffic.get("max_batch", 64)),
            warmup=True, refine=False, device=str(device)), params)
        self.launches_per_dispatch = len(tower.layers)
        self._tracer = obstrace.get_tracer()

    def serve(self, z: np.ndarray) -> np.ndarray:
        return self.engine.generate(z)

    def dispatches(self, rows: int) -> List[int]:
        """The buckets that a request of ``rows`` dispatches."""
        return [b for _, b in self.engine.plan_chunks(rows)]

    def counters(self) -> Dict[str, int]:
        s = self.engine.stats
        return {"images": s["images"], "padded_images": s["padded_images"]}

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
