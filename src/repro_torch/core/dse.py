"""Design-space exploration over output tiling factors (paper §V-A, Fig. 5).

Methodology of Zhang et al. [25] as used by the paper: for every *legal*
tiling factor, compute the computation-to-communication (CTC) ratio and the
attainable throughput

    attainable(T) = min(peak_ops, CTC(T) * sustainable_bandwidth)

then pick the tiling factor maximizing attainable throughput (solutions left
of the bandwidth slope are infeasible).  The paper optimizes one *unified*
T_OH across all layers of a network (the accelerator multiplexes layers);
we reproduce that and also report the per-layer optimum it sacrifices.

On TPU, VMEM capacity plays BRAM's role and HBM bandwidth plays DDR's; the
same construction drove the JAX package's Pallas block-shape choice.  This
module is that package's DSE, copied under the same names, with the port's
target card `H100_SXM` beside its `TPU_V5E` and `PYNQ_Z2`.  No tile choice
of the port reads it (``kernels.autotune`` has its own cost model).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .tiling import (KERNEL_MAX_SMEM, DeconvGeometry, deconv_traffic_batched,
                     legal_tile_factors, vmem_footprint)


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    peak_ops: float          # ops/s (1 MAC = 2 ops)
    bandwidth: float         # sustainable external bytes/s
    onchip_bytes: int        # VMEM / BRAM capacity available to the kernel
    dtype_bytes: int = 4
    # on-chip footprint model: our kernel ("full_spatial") vs the paper's
    # FPGA streaming dataflow ("eq5")
    footprint_model: str = "full_spatial"
    # int8 MXU rate (ops/s); 0.0 = no dedicated int8 path (fall back to
    # peak_ops).  This is the compute-roofline side of the paper's
    # low-precision advantage — quantization also quarters the traffic.
    int8_peak_ops: float = 0.0
    # the port's additions for a GPU: its dense TF32 and bf16 tensor-core
    # rates (ops/s); 0.0 = none.  `peak_for` and the DSE do not read them.
    tf32_peak_ops: float = 0.0
    bf16_peak_ops: float = 0.0

    def peak_for(self, dtype_bytes: Optional[int] = None) -> float:
        """Compute roofline for a given element width: the int8 datapath
        doubles the MXU rate where the hardware has one."""
        if dtype_bytes == 1 and self.int8_peak_ops > 0.0:
            return self.int8_peak_ops
        return self.peak_ops

    def __str__(self) -> str:  # pragma: no cover
        return self.name


# TPU v5e chip (target hardware; roofline constants from the task spec).
TPU_V5E = Device(
    name="tpu-v5e",
    peak_ops=197e12,
    bandwidth=819e9,
    onchip_bytes=16 * 1024 * 1024,
    dtype_bytes=2,  # bf16
    int8_peak_ops=394e12,  # the MXU's doubled int8 rate
)

# The paper's PYNQ-Z2 point design: 16 CUs @ 125 MHz, 1 MAC/cycle/CU,
# STREAM-measured DDR bandwidth on the PS-PL interface.
PYNQ_Z2 = Device(
    name="pynq-z2",
    peak_ops=16 * 125e6 * 2,
    bandwidth=2.0e9,
    onchip_bytes=int(0.6 * 1024 * 1024),  # 140 x 36Kb BRAMs, ~60% usable
    dtype_bytes=4,  # 32-bit fixed point
    footprint_model="eq5",  # the FPGA streams Eq.-5 input tiles
)

# The port's card: an H100 SXM5 (NVIDIA's data-sheet figures, dense; not
# measurements).  peak_ops is the fp32 rate outside the tensor cores, the
# int8, TF32 and bf16 peaks the tensor cores', bandwidth HBM3's; the
# kernels' shared-memory budget per block stands in for VMEM.
H100_SXM = Device(
    name="h100-sxm",
    peak_ops=67e12,
    bandwidth=3.35e12,
    onchip_bytes=KERNEL_MAX_SMEM,
    dtype_bytes=4,
    int8_peak_ops=1979e12,
    tf32_peak_ops=495e12,
    bf16_peak_ops=989e12,
)


@dataclasses.dataclass(frozen=True)
class DsePoint:
    t_oh: int
    ctc: float                # ops per external byte
    attainable_ops: float     # ops/s
    vmem_bytes: int
    bandwidth_bound: bool


def layer_dse(
    geom: DeconvGeometry,
    device: Device = TPU_V5E,
    co_tile: int = 128,
) -> List[DsePoint]:
    """All legal (T_OH = T_OW) design points for one layer on one device."""
    points: List[DsePoint] = []
    for t in legal_tile_factors(
        geom, vmem_budget_bytes=device.onchip_bytes,
        dtype_bytes=device.dtype_bytes, co_tile=co_tile,
        model=device.footprint_model,
    ):
        ctc = _ctc_ratio(geom, t, co_tile, device.dtype_bytes)
        attainable = min(device.peak_ops, ctc * device.bandwidth)
        points.append(
            DsePoint(
                t_oh=t,
                ctc=ctc,
                attainable_ops=attainable,
                vmem_bytes=vmem_footprint(geom, t, co_tile,
                                           device.dtype_bytes,
                                           device.footprint_model),
                bandwidth_bound=ctc * device.bandwidth < device.peak_ops,
            )
        )
    return points


def _ctc_ratio(geom: DeconvGeometry, t_oh: int, co_tile: int,
               dtype_bytes: int) -> float:
    """Computation-to-communication ratio for tiling factor t_oh.

    External traffic per tile (paper §III enhancement (3)): one Eq.-5 input
    block, one weight block, one one-shot output block."""
    from .tiling import input_tile_extent

    s = geom.stride
    t_ih = input_tile_extent(t_oh, geom.kernel, s)
    co_t = min(co_tile, geom.c_out)
    n_tiles_h = -(-geom.out_h // t_oh)
    n_tiles_w = -(-geom.out_w // t_oh)
    n_tiles_co = -(-geom.c_out // co_t)
    n_tiles = n_tiles_h * n_tiles_w * n_tiles_co
    in_bytes = t_ih * t_ih * geom.c_in * dtype_bytes
    w_bytes = geom.kernel ** 2 * geom.c_in * co_t * dtype_bytes
    out_bytes = t_oh * t_oh * co_t * dtype_bytes
    total_bytes = n_tiles * (in_bytes + w_bytes + out_bytes)
    return geom.ops / max(total_bytes, 1)


def tile_attainable(
    geom: DeconvGeometry,
    t_oh: int,
    t_ow: int,
    t_ci: int,
    t_co: int,
    device: Device = TPU_V5E,
    t_n: int = 1,
    batch: Optional[int] = None,
    dtype_bytes: Optional[int] = None,
    out_dtype_bytes: Optional[int] = None,
) -> DsePoint:
    """Roofline-attainable throughput for one *full* tile choice.

    Generalizes `layer_dse` (square spatial, fixed co_tile) to the five
    tile factors the Pallas kernel actually takes — this is the scoring
    function the autotuner (kernels/autotune.py) ranks candidates by.
    CTC uses the halo-streaming traffic model: the kernel re-streams
    ``t_n`` Eq. 5 windows + ONE weight slab per CI step of every output
    tile, so batch tiling amortizes weight traffic AND fills the MXU row
    dimension (``t_n * T_OH/S * T_OW/S`` contraction rows).  The MXU-fill
    factor scales the compute roofline: a tap matmul with fewer than 128
    rows leaves the systolic array proportionally idle.

    ``dtype_bytes`` makes the model precision-aware: it sets the
    bytes/element of the streamed traffic AND selects the device's peak
    for that width (int8 runs the doubled MXU rate), defaulting to the
    device's native ``dtype_bytes``."""
    batch = t_n if batch is None else batch
    dtype_bytes = device.dtype_bytes if dtype_bytes is None else dtype_bytes
    peak = device.peak_for(dtype_bytes)
    traffic = deconv_traffic_batched(geom, batch, t_n, t_oh, t_ow, t_ci,
                                     t_co, dtype_bytes,
                                     out_dtype_bytes=out_dtype_bytes)
    ctc = batch * geom.ops / max(traffic.total_bytes, 1)
    rows = t_n * (t_oh // geom.stride) * (t_ow // geom.stride)
    mxu_fill = min(1.0, rows / 128.0)
    attainable = min(peak * mxu_fill, ctc * device.bandwidth)
    from .tiling import kernel_vmem_bytes

    return DsePoint(
        t_oh=t_oh,
        ctc=ctc,
        attainable_ops=attainable,
        vmem_bytes=kernel_vmem_bytes(geom, t_oh, t_ow, t_ci, t_co,
                                     dtype_bytes, t_n=t_n,
                                     out_dtype_bytes=out_dtype_bytes),
        bandwidth_bound=ctc * device.bandwidth < peak * mxu_fill,
    )


def optimize_unified_tile(
    geoms: Sequence[DeconvGeometry],
    device: Device = TPU_V5E,
    co_tile: int = 128,
) -> Tuple[int, Dict[int, float]]:
    """Paper §V-A: one unified T_OH across all layers of a network, chosen to
    maximize the *network* attainable throughput (total ops / sum of per-layer
    times).  A layer whose output is smaller than T_OH clamps the tile to its
    own extent (the paper's MNIST T=12 vs L1's 7x7 output).
    Returns (optimal T_OH, {T_OH: network attainable ops/s})."""
    per_layer = [{p.t_oh: p for p in layer_dse(g, device, co_tile)}
                 for g in geoms]
    if any(not pts for pts in per_layer):
        raise ValueError("a layer has no legal tiling factor on this device")
    candidates = sorted(set().union(*[set(p) for p in per_layer]))
    scores: Dict[int, float] = {}
    for t in candidates:
        total_ops = 0.0
        total_time = 0.0
        feasible = True
        for g, pts in zip(geoms, per_layer):
            legal = [k for k in pts if k <= t]
            if not legal:
                feasible = False
                break
            eff = max(legal)  # clamp the unified tile to this layer
            total_ops += g.ops
            total_time += g.ops / pts[eff].attainable_ops
        if feasible:
            scores[t] = total_ops / total_time
    best = max(scores, key=lambda t: scores[t])
    return best, scores


def per_layer_optimum(
    geoms: Sequence[DeconvGeometry],
    device: Device = TPU_V5E,
    co_tile: int = 128,
) -> List[DsePoint]:
    """What dynamically reconfiguring per layer (paper's future work) buys."""
    best = []
    for g in geoms:
        pts = layer_dse(g, device, co_tile)
        best.append(max(pts, key=lambda p: p.attainable_ops))
    return best
