"""Three-term roofline of one step on H100s, from the counter's figures
(`analysis.cost`): the counterpart of the JAX package's
``repro.analysis.roofline``.

    compute term    = FLOPs a device      / PEAK_FLOPS
    memory term     = bytes a device      / HBM_BW
    collective term = link bytes a device / the link's rate

Every count is per device (the counter sees this rank's shards), so each
term is per device over one card's peak.  The collective bytes come from
the counter's collectives (the reference parses them from HLO text); each
is filed under the link it crosses (`analysis.cost.link_of`; a
`cost.Cost`'s ``collectives``, {kind: (calls, link bytes)}, plays the
reference's ``parse_collective_bytes``' role): an axis
whose ranks lie within one 8-card node moves over NVLink, an axis that
spans nodes over InfiniBand.  Ranks number node by node and the last mesh
axis is the fastest, so on the production meshes ((16, 16) and (2, 16,
16)) the model axis's 16 ranks span two nodes and the data and pod axes
span sixteen: every axis crosses InfiniBand.  On one 4- or 8-card node
every axis stays on NVLink.  A step counted without its links is charged
the InfiniBand rate (the slowest link: conservative, as the reference's
single-link figure).

Hardware constants: an H100 SXM5 from NVIDIA's data sheets (spec-sheet
rates, dense, not measurements): 989e12 FLOP/s bf16 on the tensor cores
(`core.dse.H100_SXM`), 3.35e12 B/s HBM3, NVLink 4 at 450e9 B/s a
direction, and 50e9 B/s a card for a 400 Gb/s NDR InfiniBand adapter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..core.dse import H100_SXM

PEAK_FLOPS = H100_SXM.bf16_peak_ops
HBM_BW = H100_SXM.bandwidth
NVLINK_BW = 450e9
IB_BW = 50e9
LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, Tuple[int, float]]
    peak_bytes_per_device: Optional[float]
    model_flops_global: float
    # collective bytes by the link they cross ("nvlink", "ib"); None: all
    # on the slowest link
    link_bytes: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.link_bytes is None:
            return self.collective_bytes_per_device / IB_BW
        return sum(b / LINK_BW[k] for k, b in self.link_bytes.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=lambda k: terms[k])

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs over every device (catches remat
        and redundant work)."""
        counted = self.flops_per_device * self.chips
        return self.model_flops_global / max(counted, 1.0)

    @property
    def step_time_bound(self) -> float:
        """Roofline step-time lower bound (the terms overlap perfectly)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the roofline-bound step: how close
        the step is to spending all its time on model FLOPs."""
        useful_t = (self.model_flops_global / self.chips) / PEAK_FLOPS
        return useful_t / max(self.step_time_bound, 1e-30)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_global,
            "counted_flops_global": self.flops_per_device * self.chips,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_bytes_per_device": self.peak_bytes_per_device,
            "collectives": {k: v for k, v in self.collectives.items()
                            if v[0]},
        }


def model_flops(cfg, suite) -> float:
    """MODEL_FLOPS: 6*N*D for training (fwd+bwd), 2*N*D for inference,
    with N = active params, D = processed tokens."""
    n = cfg.active_param_count()
    if suite.kind == "train":
        d = suite.global_batch * suite.seq_len
        return 6.0 * n * d
    if suite.kind == "prefill":
        d = suite.global_batch * suite.seq_len
        return 2.0 * n * d
    d = suite.global_batch * 1  # decode: one token per sequence
    return 2.0 * n * d
