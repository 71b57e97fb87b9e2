"""Output-space tile calculus (paper Eq. 5) and the CUDA kernel's resources.

The reverse-loop algorithm tiles the *output* space into disjoint
``T_OH x T_OW`` blocks (no overlapping-sum problem), and the input tile
required per output tile has the *constant* extent of Eq. 5:

    T_IH = ceil(T_OH / S) + ceil(K / S)                       (Eq. 5)

independent of the tile position.  In the CUDA kernels (``csrc/``) one
thread block owns one output tile and stages that window (or the part of
it that reads real input) in shared memory.

The geometry half mirrors ``repro.core.tiling``; ``kernel_smem_bytes`` and
``block_threads`` describe what the Hopper kernels allocate and launch,
in place of the TPU VMEM model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from .offsets import PhasePlan, make_phase_plan

# The kernels' launch limits, as `csrc/deconv2d_tc.cu` defines them
# (kMaxStride, kMaxTaps, kMaxThreads, kMaxDynamicSmem); the launcher checks
# that the two agree when it loads the library.
KERNEL_MAX_STRIDE = 4
KERNEL_MAX_TAPS = 8              # taps per output phase and dimension
KERNEL_MAX_THREADS = 512         # the kernel's __launch_bounds__
KERNEL_MAX_SMEM = 232448 - 4096  # 227 KB of opt-in shared memory less the static tables


def out_size(in_size: int, kernel: int, stride: int, padding: int) -> int:
    """Transposed-conv output extent (PyTorch ConvTranspose2d convention)."""
    return (in_size - 1) * stride + kernel - 2 * padding


def in_size_for(out_size_: int, kernel: int, stride: int, padding: int) -> int:
    n = out_size_ - kernel + 2 * padding
    assert n % stride == 0, "inconsistent deconv geometry"
    return n // stride + 1


def input_tile_extent(t_oh: int, kernel: int, stride: int) -> int:
    """Paper Eq. 5 (an upper bound on the exact extent; see tests)."""
    return math.ceil(t_oh / stride) + math.ceil(kernel / stride)


def exact_input_extent(
    t_oh: int, kernel: int, stride: int, padding: int
) -> int:
    """Exact max-over-tiles input extent max(i)-min(i)+1 for an S-aligned tile
    of T_OH output pixels (never above Eq. 5's bound)."""
    plan = make_phase_plan(kernel, stride, padding)
    lo = plan.delta_min
    hi = (t_oh - 1) // stride + plan.delta_max
    return hi - lo + 1


@dataclasses.dataclass(frozen=True)
class HaloTile:
    """Eq. 5 input-tile geometry for one spatial dim of the kernel.

    An S-aligned output tile of ``t_out`` pixels starting at output row
    ``j * t_out`` reads the *constant-extent* input window

        rows [ j * (t_out // S) + base,  j * (t_out // S) + base + extent )

    of the host-padded input; ``base >= 0`` because the host pads
    ``left_halo`` rows on the left.  Tap displacement ``d`` lives at local
    row ``d - delta_min`` of the window.
    """

    t_out: int       # output tile extent (multiple of S)
    stride: int
    extent: int      # input window extent T_I (rows staged per tile)
    base: int        # element offset of tile j's window: j*(t_out/S) + base
    local_zero: int  # local row of displacement delta=0 == -delta_min

    @property
    def step(self) -> int:
        """Window start advance per output tile (t_out / S input rows)."""
        return self.t_out // self.stride

    @property
    def overlap(self) -> int:
        """Halo rows shared by consecutive windows."""
        return self.extent - self.step

    def local_offset(self, delta: int) -> int:
        """In-window row of a tap with input displacement ``delta``."""
        return delta + self.local_zero

    def min_padded_extent(self, n_tiles: int) -> int:
        """Smallest padded input extent covering all n_tiles windows."""
        return (n_tiles - 1) * self.step + self.base + self.extent


def halo_tile(t_out: int, kernel: int, stride: int, padding: int) -> HaloTile:
    """Input-window geometry for an S-aligned output tile (paper Eq. 5)."""
    if t_out % stride:
        raise ValueError(f"tile {t_out} is not a multiple of stride {stride}")
    plan = make_phase_plan(kernel, stride, padding)
    step = t_out // stride
    return HaloTile(
        t_out=t_out,
        stride=stride,
        extent=step + plan.delta_max - plan.delta_min,
        # host pads left_halo = max(0, -delta_min) rows; window j then
        # starts at j*step + max(0, delta_min) >= 0
        base=plan.left_halo + plan.delta_min,
        local_zero=-plan.delta_min,
    )


@dataclasses.dataclass(frozen=True)
class DeconvGeometry:
    """Static geometry of one deconv layer."""

    in_h: int
    in_w: int
    c_in: int
    c_out: int
    kernel: int
    stride: int
    padding: int

    @property
    def out_h(self) -> int:
        return out_size(self.in_h, self.kernel, self.stride, self.padding)

    @property
    def out_w(self) -> int:
        return out_size(self.in_w, self.kernel, self.stride, self.padding)

    @property
    def macs(self) -> int:
        """Multiply-accumulates for the full layer (per batch element).
        Every (input pixel, tap, c_in, c_out) combination is one MAC."""
        return self.in_h * self.in_w * self.kernel * self.kernel * self.c_in * self.c_out

    @property
    def ops(self) -> int:
        """GOps convention of the paper: 2 ops per MAC."""
        return 2 * self.macs

    @property
    def output_macs(self) -> int:
        """Multiply-accumulates whose products land in the output (per batch
        element): `macs` less the contributions to the ``padding`` border
        that the transposed convolution crops away.  The work a layer needs."""
        return (_contributions(self.in_h, self.kernel, self.stride, self.padding)
                * _contributions(self.in_w, self.kernel, self.stride, self.padding)
                * self.c_in * self.c_out)

    def phase_plan(self) -> PhasePlan:
        return make_phase_plan(self.kernel, self.stride, self.padding)

    def halo_padding(self) -> Tuple[int, int]:
        """(pad_left, pad_right) applied to the input spatial dims so that
        every tap access of every S-aligned output tile is in bounds."""
        plan = self.phase_plan()
        pad_l = plan.left_halo
        i_max = (self.out_h - 1) // self.stride + plan.delta_max
        pad_r = max(0, i_max - (self.in_h - 1))
        return pad_l, pad_r


def _contributions(in_size: int, kernel: int, stride: int,
                   padding: int) -> int:
    """(input index, tap) pairs of one dimension whose output index
    ``i*stride + k - padding`` lies inside the output."""
    out = out_size(in_size, kernel, stride, padding)
    return sum(1 for i in range(in_size) for k in range(kernel)
               if 0 <= i * stride + k - padding < out)


# ---------------------------------------------------------------------------
# The paper's models of the TPU kernel: its VMEM footprint, its HBM traffic
# and the legal tiling factors of the DSE (`core.dse`), as the JAX package
# defines them (copied, under the same names).  No tile choice of the port
# reads them; the CUDA kernels' own resources follow further down.
# ---------------------------------------------------------------------------
def kernel_vmem_bytes(
    geom: DeconvGeometry,
    t_oh: int,
    t_ow: int,
    t_ci: int,
    t_co: int,
    dtype_bytes: int = 4,
    t_n: int = 1,
    out_dtype_bytes: Optional[int] = None,
) -> int:
    """Precise VMEM footprint of the halo-streaming Pallas kernel.

    Input/weight/bias blocks are double-buffered by the Mosaic pipeline
    (x2); the 4-byte accumulator scratch (f32 for the dense/sparse
    kernels, int32 for the int8 kernel) and the output block are single.
    ``t_n`` is the batch tile: each grid program owns ``t_n`` images' halo
    windows / output blocks (the weight slab is batch-stationary).
    ``dtype_bytes`` is the streamed element width (1 for the int8 kernel);
    ``out_dtype_bytes`` overrides the output block's width when it differs
    from the inputs' (an int8 layer whose epilogue emits f32)."""
    ht_h = halo_tile(t_oh, geom.kernel, geom.stride, geom.padding)
    ht_w = halo_tile(t_ow, geom.kernel, geom.stride, geom.padding)
    out_b = dtype_bytes if out_dtype_bytes is None else out_dtype_bytes
    x_bytes = t_n * ht_h.extent * ht_w.extent * t_ci * dtype_bytes
    w_bytes = geom.kernel * geom.kernel * t_ci * t_co * dtype_bytes
    # epilogue vectors stream as f32: bias for the float kernels, bias AND
    # the per-channel requant scale for the int8 kernel (two in_specs)
    b_bytes = (2 if dtype_bytes == 1 else 1) * t_co * max(dtype_bytes, 4)
    y_bytes = t_n * t_oh * t_ow * t_co * out_b
    acc_bytes = t_n * t_oh * t_ow * t_co * 4
    return 2 * (x_bytes + w_bytes + b_bytes) + y_bytes + acc_bytes



@dataclasses.dataclass(frozen=True)
class DeconvTraffic:
    """Modeled HBM traffic of the halo-streaming kernel for one layer
    (per batch element).  ``in_bytes_per_tile`` is the Eq. 5 window — a
    constant per tile, independent of image size (the paper's point).
    Bytes only; CTC / attainable throughput live in `dse.tile_attainable`.
    """

    n_tiles: int              # spatial x C_out output tiles
    n_ci_steps: int           # C_in grid steps per output tile
    in_bytes_per_tile: int    # halo window bytes per (tile, ci step)
    w_bytes_per_tile: int     # weight slab bytes per (tile, ci step)
    out_bytes_per_tile: int   # one-shot output block bytes
    total_bytes: int


def deconv_traffic(
    geom: DeconvGeometry,
    t_oh: int,
    t_ow: int,
    t_ci: int,
    t_co: int,
    dtype_bytes: int = 4,
) -> DeconvTraffic:
    """HBM bytes moved by the halo-streaming kernel (per batch element).

    Per output tile the CI grid re-streams one Eq. 5 input window and one
    weight slab per CI step; the output block is written once.  This is the
    modeled side of the modeled-vs-measured accounting in
    benchmarks/bench_deconv.py."""
    ht_h = halo_tile(t_oh, geom.kernel, geom.stride, geom.padding)
    ht_w = halo_tile(t_ow, geom.kernel, geom.stride, geom.padding)
    n_h = -(-geom.out_h // t_oh)
    n_w = -(-geom.out_w // t_ow)
    n_co = -(-geom.c_out // t_co)
    n_ci = -(-geom.c_in // t_ci)
    in_b = ht_h.extent * ht_w.extent * t_ci * dtype_bytes
    w_b = geom.kernel * geom.kernel * t_ci * t_co * dtype_bytes
    out_b = t_oh * t_ow * t_co * dtype_bytes
    n_tiles = n_h * n_w * n_co
    total = n_tiles * (n_ci * (in_b + w_b) + out_b)
    return DeconvTraffic(
        n_tiles=n_tiles,
        n_ci_steps=n_ci,
        in_bytes_per_tile=in_b,
        w_bytes_per_tile=w_b,
        out_bytes_per_tile=out_b,
        total_bytes=total,
    )


def deconv_traffic_batched(
    geom: DeconvGeometry,
    batch: int,
    t_n: int,
    t_oh: int,
    t_ow: int,
    t_ci: int,
    t_co: int,
    dtype_bytes: int = 4,
    out_dtype_bytes: Optional[int] = None,
) -> DeconvTraffic:
    """HBM bytes moved for a *batch* under the batch-fused kernel.

    The batch dimension is tiled by ``t_n`` (batch folded into the MXU row
    dimension): each grid program streams ``t_n`` halo windows but only ONE
    weight slab per CI step, so weight traffic per image falls by ``t_n`` —
    the spatio-temporal amortization that makes the batched path win on the
    fat-channel early layers.  ``dtype_bytes`` is the streamed element
    width — 1 on the int8 path, where the quartered stream is half the
    paper's low-precision advantage — and ``out_dtype_bytes`` overrides
    the written block's width when the epilogue changes precision."""
    ht_h = halo_tile(t_oh, geom.kernel, geom.stride, geom.padding)
    ht_w = halo_tile(t_ow, geom.kernel, geom.stride, geom.padding)
    o_bytes = dtype_bytes if out_dtype_bytes is None else out_dtype_bytes
    n_n = -(-batch // t_n)
    n_h = -(-geom.out_h // t_oh)
    n_w = -(-geom.out_w // t_ow)
    n_co = -(-geom.c_out // t_co)
    n_ci = -(-geom.c_in // t_ci)
    in_b = t_n * ht_h.extent * ht_w.extent * t_ci * dtype_bytes
    w_b = geom.kernel * geom.kernel * t_ci * t_co * dtype_bytes
    out_b = t_n * t_oh * t_ow * t_co * o_bytes
    n_tiles = n_n * n_h * n_w * n_co
    total = n_tiles * (n_ci * (in_b + w_b) + out_b)
    return DeconvTraffic(
        n_tiles=n_tiles,
        n_ci_steps=n_ci,
        in_bytes_per_tile=in_b,
        w_bytes_per_tile=w_b,
        out_bytes_per_tile=out_b,
        total_bytes=total,
    )


def full_image_traffic(
    geom: DeconvGeometry,
    t_oh: int,
    t_ow: int,
    t_ci: int,
    t_co: int,
    dtype_bytes: int = 4,
) -> DeconvTraffic:
    """HBM traffic of the pre-halo pipeline (every grid program re-streamed
    the whole padded input per CI step) — the baseline the tentpole kills.
    Same structure as `deconv_traffic`; only ``in_bytes_per_tile`` differs
    (the whole padded image instead of the Eq. 5 window)."""
    pad_l, pad_r = geom.halo_padding()
    ihp = geom.in_h + pad_l + pad_r
    iwp = geom.in_w + pad_l + pad_r
    n_h = -(-geom.out_h // t_oh)
    n_w = -(-geom.out_w // t_ow)
    n_co = -(-geom.c_out // t_co)
    n_ci = -(-geom.c_in // t_ci)
    in_b = ihp * iwp * t_ci * dtype_bytes
    w_b = geom.kernel * geom.kernel * t_ci * t_co * dtype_bytes
    out_b = t_oh * t_ow * t_co * dtype_bytes
    n_tiles = n_h * n_w * n_co
    return DeconvTraffic(
        n_tiles=n_tiles,
        n_ci_steps=n_ci,
        in_bytes_per_tile=in_b,
        w_bytes_per_tile=w_b,
        out_bytes_per_tile=out_b,
        total_bytes=n_tiles * (n_ci * (in_b + w_b) + out_b),
    )


def legal_tile_factors(
    geom: DeconvGeometry,
    vmem_budget_bytes: int = 12 * 1024 * 1024,
    dtype_bytes: int = 4,
    co_tile: int = 128,
    model: str = "full_spatial",
) -> List[int]:
    """Enumerate legal square output tiling factors T_OH = T_OW (the paper
    explores square tiles).  Legality (the paper's Fig. 5 'legal solutions'):

    * S | T_OH       — tiles are stride-aligned so the phase structure is
                        identical for every tile (uniform CU workloads);
    * on-chip fit    — input block + weight block + output block + f32
                        accumulator fit the budget (VMEM / BRAM).

    `model`: "full_spatial" budgets our Pallas kernel (whole input spatial
    resident per C_in tile); "eq5" budgets the paper's FPGA dataflow (an
    Eq.-5 T_IH x T_IW input tile per output tile)."""
    out: List[int] = []
    s = geom.stride
    for t in range(s, geom.out_h + s, s):
        if t % s:
            continue
        t_oh = min(t, geom.out_h)
        footprint = _vmem_footprint(geom, t_oh, co_tile, dtype_bytes, model)
        if footprint <= vmem_budget_bytes:
            out.append(t)
        if t >= geom.out_h:
            break
    return sorted(set(out))


def _vmem_footprint(
    geom: DeconvGeometry, t_oh: int, co_tile: int, dtype_bytes: int,
    model: str = "full_spatial",
) -> int:
    co_t = min(co_tile, geom.c_out)
    if model == "eq5":
        # the FPGA dataflow streams Eq.-5 input tiles AND input-channel
        # blocks (Algorithm 1's i_c loop) through BRAM
        t_ih = input_tile_extent(t_oh, geom.kernel, geom.stride)
        in_spatial = t_ih * t_ih
        ci_t = min(32, geom.c_in)
    else:
        pad_l, pad_r = geom.halo_padding()
        in_spatial = ((geom.in_h + pad_l + pad_r)
                      * (geom.in_w + pad_l + pad_r))
        ci_t = geom.c_in
    x_bytes = in_spatial * ci_t * dtype_bytes
    w_bytes = geom.kernel * geom.kernel * ci_t * co_t * dtype_bytes
    y_bytes = t_oh * t_oh * co_t * dtype_bytes
    acc_bytes = t_oh * t_oh * co_t * 4  # f32 accumulator scratch
    return x_bytes + w_bytes + y_bytes + acc_bytes


def vmem_footprint(geom: DeconvGeometry, t_oh: int, co_tile: int = 128,
                   dtype_bytes: int = 4, model: str = "full_spatial") -> int:
    return _vmem_footprint(geom, t_oh, co_tile, dtype_bytes, model)


# ---------------------------------------------------------------------------
# The kernels' resources.  "tc" is the tensor-core library
# (`csrc/deconv2d_tc.cu`: the fp32 and bf16 dense and zero-skip kernels and
# the int8 kernel, whose staged layouts differ by dtype), the one kernel
# library of the port.  Each function here mirrors the C code that
# launches the kernel; the launcher checks that the two agree on the
# shared memory of every launch shape.
# ---------------------------------------------------------------------------
KERNELS = ("tc",)


def dtype_name(dtype) -> str:
    """A torch or numpy dtype (or scalar type), or its name, as "float32",
    "bfloat16", "int8", ...: the JAX package's names, without numpy, which
    knows no bfloat16."""
    if isinstance(dtype, type):          # np.float32 and the like
        dtype = dtype.__name__
    name = str(dtype).replace("torch.", "")
    return {"fp32": "float32", "bf16": "bfloat16"}.get(name, name)


# bytes per element and the channels one k-step of the kernel's mma takes
# (its CI chunks are a multiple of it: m16n8k8 TF32, m16n8k16 bf16,
# m16n8k32 s8), per dtype name
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
CI_STEP = {"float32": 8, "bfloat16": 16, "int8": 32}


def dtype_bytes(dtype) -> int:
    """Bytes per element of a dtype (or its name)."""
    return DTYPE_BYTES[dtype_name(dtype)]


def kernel_for(dtype) -> str:
    """The kernel that runs a layer of ``dtype``: fp32, bf16 and int8 all
    on the tensor cores."""
    return "tc"


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")


def tc_warp_tile(pix: int, t_co: int) -> Tuple[int, int]:
    """(WM, WN) of the "tc" kernel: the m16 row tiles and n8 column tiles
    of one warp's share of a phase (the kernel has an instance for each
    pair).  Rows are a phase's output pixels, columns output channels."""
    mt, nt = -(-pix // 16), -(-t_co // 8)
    return (2 if mt >= 2 else 1), (4 if nt >= 4 else 2 if nt >= 2 else 1)


def tc_columns(t_co: int) -> int:
    """Output channels the "tc" kernel's warps cover: ``t_co`` rounded up
    to whole warp tiles of WN n8 columns (the staged weights are zero past
    ``t_co``)."""
    wn = tc_warp_tile(1, t_co)[1]
    return -(-(-(-t_co // 8)) // wn) * wn * 8


def tc_weight_stride(t_co: int) -> int:
    """Elements per staged weight row of the fp32 and bf16 "tc" kernels:
    `tc_columns`, padded so that the row stride is 8 mod 16 elements.
    fp32 (words): the four k-rows of a B fragment land on different banks;
    bf16 (16 mod 32 bytes): the eight 16-byte k-rows of an ldmatrix phase
    land in different bank groups."""
    cols = tc_columns(t_co)
    return cols + 8 if cols % 16 == 0 else cols


def bf16_row_stride(t_ci: int) -> int:
    """Elements per staged input row of the bf16 "tc" kernel (a pixel's
    ``t_ci`` channels): t_ci + 8, a whole and odd number of 16-byte pieces
    at every t_ci it takes (16, 32, 64), so that the 16-byte rows of 8
    consecutive pixels that one ldmatrix phase reads fall in distinct bank
    groups."""
    return t_ci + 8


def int8_row_stride(t_ci: int) -> int:
    """Bytes per staged row of the int8 "tc" kernel (an input pixel's or a
    (tap, channel)'s ``t_ci`` bytes): t_ci + 16, so that the 8 rows x 4
    words of an A fragment (consecutive pixels) or a B fragment fall in 32
    distinct banks at every t_ci the tiles take (32, 64, 128)."""
    return t_ci + 16


def block_threads(stride: int, t_oh: int, t_ow: int, t_co: int, t_n: int,
                  kernel: str = "tc") -> int:
    """Threads of one block that compute: one warp per (phase, WM*16
    rows, WN*8 columns) of the tile, over all S*S output phases."""
    _check_kernel(kernel)
    pix = t_n * (t_oh // stride) * (t_ow // stride)
    wm, wn = tc_warp_tile(pix, t_co)
    return 32 * stride * stride * (-(-(-(-pix // 16)) // wm)
                                   * -(-(-(-t_co // 8)) // wn))


def launch_threads(stride: int, t_oh: int, t_ow: int, t_co: int, t_n: int,
                   kernel: str = "tc") -> int:
    """Threads a block is launched with: `block_threads`, but at least 128
    and a whole number of warps; the threads past the last phase only
    stage (a small tile's CI chunks are not staged by one warp)."""
    return -(-max(block_threads(stride, t_oh, t_ow, t_co, t_n, kernel),
                  128) // 32) * 32


def staged_window(in_size: int, out_padded: int, t_out: int, kernel: int,
                  stride: int, padding: int) -> Tuple[int, int]:
    """(rows, taps) of one spatial dim of the "tc" kernel: the most input
    rows any block stages and the most kernel taps whose rows read real
    input in any block.

    A block stages only the rows its valid taps read, so a 1x1 root stages
    one row and one tap of K per S-pixel tile, and the shared window and
    weight slab are sized by these maxima, not by Eq. 5's extent and K."""
    plan = make_phase_plan(kernel, stride, padding)
    step = t_out // stride
    base = plan.left_halo + plan.delta_min
    lo_real, hi_real = plan.left_halo, plan.left_halo + in_size
    rows = taps = 0
    for j in range(out_padded // t_out):
        o0 = j * step + base
        ds = [d - plan.delta_min for ph in range(stride)
              for _, d in plan.taps[ph]
              if o0 + d - plan.delta_min < hi_real
              and o0 + d - plan.delta_min + step > lo_real]
        if ds:
            rows = max(rows, max(ds) + step - min(ds))
            taps = max(taps, len(ds))
    return rows, taps


TC_STAGE_BUDGET = 100 * 1024   # the ring holds as many stages (2..4) as fit


def tc_smem_layout(in_h: int, in_w: int, kernel: int, stride: int,
                   padding: int, ohp: int, owp: int, t_oh: int, t_ow: int,
                   t_ci: int, t_co: int, t_n: int, split: int = 1,
                   dtype="float32") -> Tuple[int, int]:
    """(stages, bytes) of the "tc" kernels' dynamic shared memory.

    One stage holds a CI chunk.  fp32: the staged windows of the ``t_n``
    images, ``(t_n, rows_h, rows_w, t_ci + 4)`` words (channel stride t_ci
    + 4, so the eight rows of an A fragment hit different banks), rounded
    to 16 bytes, then the weight rows of the block's valid taps, ``(taps_h
    * taps_w, t_ci, tc_weight_stride(t_co))``.  bf16: the same two arrays
    of 2-byte elements, the windows' rows `bf16_row_stride` long (whole
    16-byte pieces, so nothing to round).  int8: the windows as ``(t_n,
    rows_h, rows_w)`` rows of `int8_row_stride` bytes, then per valid tap
    `tc_columns` weight rows (CI-minor) of the same stride.  Under a
    cluster split the same memory then holds the block's partial tile,
    S*S*pixels*t_co 4-byte sums."""
    rows_h, taps_h = staged_window(in_h, ohp, t_oh, kernel, stride, padding)
    rows_w, taps_w = staged_window(in_w, owp, t_ow, kernel, stride, padding)
    name = dtype_name(dtype)
    if name == "int8":
        row = int8_row_stride(t_ci)
        stage = row * (t_n * rows_h * rows_w
                       + taps_h * taps_w * tc_columns(t_co))
    elif name == "bfloat16":
        stage = 2 * (t_n * rows_h * rows_w * bf16_row_stride(t_ci)
                     + taps_h * taps_w * t_ci * tc_weight_stride(t_co))
    else:
        x_words = -(-t_n * rows_h * rows_w * (t_ci + 4) // 4) * 4
        stage = 4 * (x_words
                     + taps_h * taps_w * t_ci * tc_weight_stride(t_co))
    stages = max([n for n in (2, 3, 4) if n * stage <= TC_STAGE_BUDGET],
                 default=2)
    pix = t_n * (t_oh // stride) * (t_ow // stride)
    partial = 4 * stride * stride * pix * t_co if split > 1 else 0
    return stages, max(stages * stage, partial)


def int8_acc_bound(kernel: int, stride: int, padding: int, cip: int) -> int:
    """The largest magnitude an int8 output's int32 sum can reach: the most
    taps of one phase per dimension, squared, times ``cip`` channels times
    127^2.  The int8 kernel (and the reference's accumulator) needs it
    below 2^31; on the served nets it is at most 4 x 1024 x 127^2."""
    plan = make_phase_plan(kernel, stride, padding)
    taps = max(len(t) for t in plan.taps.values())
    return taps * taps * cip * 127 * 127


def kernel_smem_bytes(geom: DeconvGeometry, t_oh: int, t_ow: int, t_ci: int,
                      t_co: int, t_n: int = 1, kernel: str = "tc",
                      split: int = 1, dtype="float32") -> int:
    """Dynamic shared memory of one kernel block, in bytes: `tc_smem_layout`
    for ``dtype`` at the layer's tile-padded output."""
    _check_kernel(kernel)
    return tc_smem_layout(
        geom.in_h, geom.in_w, geom.kernel, geom.stride, geom.padding,
        -(-geom.out_h // t_oh) * t_oh, -(-geom.out_w // t_ow) * t_ow,
        t_oh, t_ow, t_ci, t_co, t_n, split, dtype)[1]
