"""Tile choice for the Hopper deconv kernels.

Deterministic choices of the same ``TileChoice`` fields as the JAX
package's autotuner (``t_oh, t_ow, t_ci, t_co, t_n``), one per dtype's
kernel.  In all, ``t_oh``/``t_ow`` are square
multiples of the stride (every tile has the same phase structure), a block
has at most 512 threads (the kernels' launch bound), and a 1x1 root layer
takes S-pixel spatial tiles, one valid tap each.

Every dtype runs on the tensor-core kernels (``csrc/deconv2d_tc.cu``),
`_tc_tiles`: every candidate the kernel takes (fp32: ``t_ci`` a multiple of
8; bf16: 16, 32 or 64; int8: 32, 64 or 128; ``t_co`` a multiple of 8, or
C_out itself below 8; at most 16 warps and 227 KB) is scored by `tc_cost`,
a model of one SM's clock, and the cheapest whose grid (cluster split
included, `ci_split`) fills the 132 SMs wins; where no candidate fills
them, the cheapest of all.  fp32 at bucket 1 takes a rule of its own
(`_bucket1_tiles`: one wave of the largest spatial tile), and the tiles
on the wgmma paths are costed by `_wgmma_cost` (bf16) and
`_wgmma_f32_cost` (fp32).  The model counts per block and CI chunk the
instructions issued, the tensor-core products (fp32 3xTF32: three ``mma``
per m16n8k8 tile; bf16: one m16n8k16 ``mma``; int8: one m16n8k32
``mma``), the shared-memory wavefronts of the fragment loads, the bytes
staged from L2 and the bulk copies (one per staged row), plus one copy
latency per chunk over the stages in flight; blocks share an SM's rates
and run in waves.  Its constants were fitted by hand to timed tiles on an
H100, each dtype's to its own kernel, so it ranks tiles, it does not
predict times.

The TPU tiles do not carry over: the JAX plan picks ``t_ci = t_co = 128`` on
CelebA's wide layers, a 1 MB weight slab.

`choose_tiles` puts the JAX package's three stages on top of those models,
cheapest first:

1. **Cache** -- a JSON store of *timed* choices only, at
   ``$REPRO_TORCH_AUTOTUNE_CACHE`` (default
   ``~/.cache/repro_torch/autotune.json``; never the JAX package's file),
   keyed by the layer's `DeconvPlan.stable_hash(scope="tiles")`, the card's
   name and the digest of the kernel library's source, so a changed kernel
   or another card never reuses a time.  ``clear_cache()`` wipes it.
2. **Model** -- `hopper_tiles`.  A model pick costs microseconds and is
   never stored: a stored one would hide a later change of the model.
3. **On-card timing** (``refine=True``, fp32 only) -- the model's pick and
   the next cheapest candidates by `tc_cost` *without* the fill-the-SMs
   preference, each launched through the serving launcher and timed with
   CUDA events (`time_ms`); the fastest is kept and stored.  int8 and bf16
   keep the model ranking, as in the JAX package.  On
   a machine without a card ``refine=True`` raises: the clock of a plain
   version says nothing about the kernel.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import statistics
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.tiling import (KERNEL_MAX_SMEM, KERNEL_MAX_THREADS,
                           DeconvGeometry, bf16_wgmma_tile, block_threads,
                           dtype_name, fp32_wgmma_tile, launch_threads,
                           staged_window, tc_columns, tc_smem_layout,
                           tc_warp_tile)

SMS = 132                      # streaming multiprocessors of an H100
MAX_SPLIT = 8                  # blocks of a cluster (the portable limit)


@dataclasses.dataclass(frozen=True)
class TileChoice:
    """One resolved tile assignment for the deconv kernel grid."""

    t_oh: int
    t_ow: int
    t_ci: int
    t_co: int
    t_n: int = 1              # batch tile (images per thread block)
    # provenance, not semantics: two choices with the same factors are the
    # same launch wherever they came from (plan equality relies on it)
    source: str = dataclasses.field(default="hopper", compare=False)

    def as_kwargs(self) -> Dict[str, int]:
        return {"t_oh": self.t_oh, "t_ow": self.t_ow,
                "t_ci": self.t_ci, "t_co": self.t_co, "t_n": self.t_n}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m




def grid_blocks(geom: DeconvGeometry, batch: int, t: int, t_co: int,
                t_n: int) -> int:
    """Thread blocks of one launch at square spatial tile ``t``, before a
    cluster split."""
    return (-(-batch // t_n) * (-(-geom.out_h // t)) * (-(-geom.out_w // t))
            * (-(-geom.c_out // t_co)))


def ci_split(blocks: int, n_chunks: int) -> int:
    """Blocks of a cluster that share one output tile's CI chunks (the
    "tc" kernel): doubled while the grid is under the card's SMs, up to 8
    and at most one per chunk.  1 leaves the reduction in one block."""
    split = 1
    while blocks * split < SMS and split * 2 <= min(MAX_SPLIT, n_chunks):
        split *= 2
    return split


def hopper_tiles(geom: DeconvGeometry, batch: int = 1,
                 dtype="float32", sparse: bool = False) -> TileChoice:
    """Tiles for one layer at the batch its kernel will see, for the
    tensor-core kernel that runs ``dtype`` (``sparse``: its zero-skip
    launch, which has no fp32 wgmma path)."""
    return _tc_tiles(geom, batch, dtype_name(dtype), sparse)


def fill_tiles(geom: DeconvGeometry, batch: int, dtype="float32",
               **given) -> TileChoice:
    """The tiles given by name (``t_oh=...``), the ones left out or None
    taken from `hopper_tiles` at this batch and dtype."""
    return dataclasses.replace(hopper_tiles(geom, batch, dtype),
                               **{f: v for f, v in given.items() if v is not None})


# -- the tensor-core kernels --------------------------------------------
# A model of one SM's clock, not measurements: the constants were fitted by
# hand to timed tiles of both generators' layers on an H100 (PERF.md), the
# shared ones and MMA_CLK to the fp32 kernel, the INT8_ ones to the int8
# kernel and the BF16_ ones to the bf16 kernels (every tile each takes,
# timed by tools/sweep_tiles.py).  On int8 the mma never binds; the
# per-chunk cost does (a 128-channel chunk ran up to 1.25x faster than two
# of 64 at equal tiles), and a cluster split costs more than fp32's
# constant says.  bf16 likewise: a 16-channel chunk is one k-step, and on
# CelebA's wide layers at bucket 64 64-channel chunks ran up to 1.9x
# faster than 16-channel ones at equal spatial tiles; but a ring that
# leaves room for one block per SM lost to one that leaves room for two
# (CelebA layer 1: 0.27 vs 0.20 ms), so a bf16 block's per-chunk stall is
# taken as hidden by the other resident blocks.
ISSUE_PER_CLK = 4       # instructions an SM issues per clock (4 schedulers)
MMA_CLK = 1.5           # SM clocks per m16n8k8 TF32 mma.sync, as sustained
INT8_MMA_CLK = 2.0      # SM clocks per m16n8k32 s8 mma.sync, as sustained
INT8_CHUNK_CLK = 750    # SM clocks per block and chunk not hidden (int8)
INT8_REDUCE_CLK = 5000  # the int8 split's cluster barriers and int32 sums
INT8_T_CI = (32, 64, 128)  # the int8 kernel's CI chunks (whole k32 steps)
BF16_MMA_CLK = 1.5      # SM clocks per m16n8k16 bf16 mma.sync, as sustained
BF16_CHUNK_CLK = 500    # SM clocks per block and chunk not hidden (bf16)
BF16_T_CI = (16, 32, 64)  # the bf16 kernels' CI chunks (whole k16 steps)
WG_MMA_CLK = 4.0        # SM clocks per m64n8k16 unit of a bf16 wgmma, at peak
WG_CHUNK_CLK = 2500     # per block and chunk of the wgmma path: barriers, latency
WG_L2_BYTES_PER_CLK = 54  # bytes the wgmma path's producer stages per clock
WG_SPLIT_CLK = 12000    # the wgmma path's cluster barriers under a split
WG_REDUCE_CLK = 0.11    # per byte of the partial tile the split's ranks read
# the fp32 wgmma path, in this model's clocks (about half an SM clock: the
# fp32 mma.sync picks ran 1.8-2.5 SM clocks a modelled one at bucket 64):
# a warpgroup's tap groups run one after another, each a fixed latency
# and one per wgmma; a block pays a fixed cost
WG_F32_GROUP_CLK = 110  # per tap group (ldmatrix, split, commit, wait)
WG_F32_MMA_CLK = 44     # per m64n64k8 wgmma of a group
WG_F32_BLOCK_CLK = 8000  # per block: tap lists, pipeline fill, epilogue
WG_F32_SPLIT_CLK = 8000  # per rank of a cluster split: barriers, partial tiles
WG_F32_XROW_CLK = 0.5   # per staged window pixel and chunk (ldmatrix rows, TMA)
LOAD_INSTR = 8          # instructions per plain 2-byte load and store (bf16)
TC_T_CO = (8, 16, 32, 64, 128)  # channel tiles of C_out >= 8 (n8 columns)
COPY_INSTR = 12         # instructions per bulk copy (a staged row)
COPY_CLK = 4.0          # SM clocks of the copy engine per bulk copy
COPY4_INSTR = 10        # instructions per 4-byte cp.async (thin weight rows)
CHUNK_INSTR = 60        # per warp and chunk: barrier, waits, partial sums
L2_BYTES_PER_CLK = 16   # bytes one SM stages per clock with every SM busy
LATENCY_CLK = 4000      # one chunk's copies in flight, from issue to landed
REDUCE_CLK = 1500       # the two cluster barriers of a split's reduction
FULL_WARPS = 8          # warps an SM needs to keep its tensor cores busy
REGS_PER_THREAD = 128   # the launch bound's register cap
WAVE_CLK = 2.0          # SM clocks per shared-memory wavefront of the loads


def _tc_candidates(geom: DeconvGeometry, batch: int, dtype="float32",
                   sparse: bool = False):
    s = geom.stride
    if geom.in_h == geom.in_w == 1:
        spatial = [s]
    else:
        full = _round_up(max(geom.out_h, geom.out_w), s)
        spatial = sorted({min(full, s * 2 ** j) for j in range(5)
                          if s * 2 ** j <= 32})
    t_ns = [2 ** j for j in range(7) if 2 ** j <= batch]
    if geom.c_out < 8:
        t_cos = [geom.c_out]
    else:
        t_cos = [c for c in TC_T_CO if c <= _round_up(geom.c_out, 8)]
    # 8-channel chunks pay a barrier and a partial sum per 8 channels and
    # stage 32-byte input rows: on the wide layers they ran slower than 16
    # or 32 at every mma.sync tile timed, so there they are taken on the
    # fp32 wgmma path alone (whose ring holds two 8-channel stages where
    # it holds no wider one)
    fp32 = dtype_name(dtype) == "float32"
    t_cis = [c for c in (8, 16, 32) if c <= _round_up(geom.c_in, 8)]
    if dtype_name(dtype) == "int8":
        t_cis = [c for c in INT8_T_CI if c <= _round_up(geom.c_in, 32)]
    elif dtype_name(dtype) == "bfloat16":
        t_cis = [c for c in BF16_T_CI if c <= _round_up(geom.c_in, 16)]
    for t in spatial:
        for t_n in t_ns:
            for t_co in t_cos:
                for t_ci in t_cis:
                    if fp32 and t_ci == 8 and geom.c_in >= 128:
                        split = ci_split(grid_blocks(geom, batch, t, t_co,
                                                     t_n),
                                         _round_up(geom.c_in, 8) // 8)
                        if fp32_wgmma_tile(geom.stride, t, t, t_co, t_n,
                                           geom.kernel, 8, split,
                                           sparse) is None:
                            continue
                    yield t, t_n, t_co, t_ci


def _a_conflicts(tw: int, t_n: int, win_w: int, win_h: int) -> float:
    """Shared-memory wavefronts of one A-fragment load: the most of its 8
    rows (consecutive output pixels of a phase) whose window pixels meet
    mod 8, the channel stride being 4 mod 8 words."""
    th = max(1, 16 // max(tw, 1))
    pix = [((n * win_h + (r // tw)) * win_w + r % tw) % 8
           for n in range(t_n) for r in range(min(th, 16) * tw)][:8]
    return float(max(pix.count(p) for p in set(pix)))


def tc_cost(geom: DeconvGeometry, batch: int, t: int, t_n: int, t_co: int,
            t_ci: int, dtype="float32", sparse: bool = False):
    """Modelled SM clocks of one "tc" launch of ``dtype`` (fp32, bf16 or
    int8; ``sparse``: the zero-skip launch) at these tiles, or None where
    the kernel does not take them.

    Per block and CI chunk: the instructions its warps issue (fragment
    loads, fp32's 3xTF32 splits, the mma, one bulk copy per staged input and
    weight row) against the SMs' issue rate, its mma against the tensor
    cores' rate, its staged bytes against L2, and one copy latency divided
    by the stages in flight.  Blocks resident on one SM share its rates;
    the grid runs in waves; a split adds its cluster reduction."""
    int8 = dtype_name(dtype) == "int8"
    bf16 = dtype_name(dtype) == "bfloat16"
    s = geom.stride
    pix = t_n * (t // s) ** 2
    ohp, owp = _round_up(geom.out_h, t), _round_up(geom.out_w, t)
    cip = _round_up(geom.c_in, t_ci)
    n_chunks = cip // t_ci
    blocks = grid_blocks(geom, batch, t, t_co, t_n)
    split = ci_split(blocks, n_chunks)
    if block_threads(s, t, t, t_co, t_n, dtype=dtype, k_size=geom.kernel,
                     t_ci=t_ci, sparse=sparse,
                     split=split) > KERNEL_MAX_THREADS:
        return None
    threads = launch_threads(s, t, t, t_co, t_n, dtype=dtype,
                             k_size=geom.kernel, t_ci=t_ci, sparse=sparse,
                             split=split)
    stages, smem = tc_smem_layout(geom.in_h, geom.in_w, geom.kernel, s,
                                  geom.padding, ohp, owp, t, t, t_ci, t_co,
                                  t_n, split, dtype, sparse)
    if smem > KERNEL_MAX_SMEM:
        return None
    rows_h, taps_h = staged_window(geom.in_h, ohp, t, geom.kernel, s,
                                   geom.padding)
    rows_w, taps_w = staged_window(geom.in_w, owp, t, geom.kernel, s,
                                   geom.padding)
    wm, wn = tc_warp_tile(pix, t_co)
    mgroups = -(-(-(-pix // 16)) // wm)
    ngroups = -(-(-(-t_co // 8)) // wn)
    warps = s * s * mgroups * ngroups
    x_rows = t_n * rows_h * rows_w
    # per chunk: every valid tap is one phase's, over that phase's warps;
    # the shared-memory wavefronts of a k-step: B rows are conflict-free,
    # A rows conflict where a fragment's 8 rows share a bank
    conflicts = _a_conflicts(t // s, t_n, rows_w, rows_h)
    waves_k = 4 * wm * conflicts + 2 * wn
    wg = bf16_wgmma_tile(s, pix, t_co, geom.kernel, t_ci) if bf16 else None
    if wg is not None:
        return _wgmma_cost(geom, t_n, t_co, t_ci, pix, wg, blocks, split,
                           n_chunks, rows_h * rows_w, taps_h * taps_w)
    wg = None if bf16 or int8 else fp32_wgmma_tile(s, t, t, t_co, t_n,
                                                   geom.kernel, t_ci, split,
                                                   sparse)
    if wg is not None:
        return _wgmma_f32_cost(geom, t_n, t_ci, wg, blocks, split, n_chunks,
                               rows_h * rows_w, taps_h * taps_w)
    if bf16:
        # one m16n8k16 mma per tile and 16-deep k-step; per k-step one
        # ldmatrix.x4 (4 wavefronts) per m16 tile of A and per pair of n8
        # tiles of B (x2, 2 wavefronts, for a single tile); bf16 rows,
        # thin weight rows by plain loads
        ksteps = taps_h * taps_w * mgroups * ngroups * (t_ci // 16)
        mma = ksteps * wm * wn
        frag = wm + -(-wn // 2)
        waves_k = 4 * wm * conflicts + 4 * (wn // 2) + 2 * (wn % 2)
        w_rows = taps_h * taps_w * t_ci
        copies = (x_rows + w_rows) * COPY_INSTR if t_co % 8 == 0 else \
            x_rows * COPY_INSTR + w_rows * t_co * LOAD_INSTR
        staged = 2 * t_ci * (x_rows + taps_h * taps_w * t_co)
        mma_clk, chunk_clk = BF16_MMA_CLK, BF16_CHUNK_CLK
        copied = x_rows + (w_rows if t_co % 8 == 0 else 0)
    elif int8:
        # one m16n8k32 mma per tile and 32-deep k-step, 32-bit fragment
        # loads, one bulk copy per staged (tap, channel) weight row
        ksteps = taps_h * taps_w * mgroups * ngroups * (t_ci // 32)
        mma = ksteps * wm * wn
        frag = 4 * wm + 2 * wn
        w_rows = taps_h * taps_w * t_co
        copies = (x_rows + w_rows) * COPY_INSTR
        staged = t_ci * (x_rows + taps_h * taps_w * tc_columns(t_co))
        mma_clk, copied, chunk_clk = INT8_MMA_CLK, x_rows + w_rows, \
            INT8_CHUNK_CLK
    else:
        ksteps = taps_h * taps_w * mgroups * ngroups * (t_ci // 8)
        mma = ksteps * 3 * wm * wn
        frag = 3 * (4 * wm + 2 * wn)     # loads and splits per k-step
        w_rows = taps_h * taps_w * t_ci
        copies = (x_rows + w_rows) * COPY_INSTR if t_co % 4 == 0 else \
            x_rows * COPY_INSTR + w_rows * t_co * COPY4_INSTR
        staged = 4 * t_ci * (x_rows + taps_h * taps_w * t_co)
        mma_clk, chunk_clk = MMA_CLK, 0
        copied = x_rows + (w_rows if t_co % 4 == 0 else 0)
    instr = mma + ksteps * frag + copies + warps * CHUNK_INSTR
    chunks = -(-n_chunks // split)
    per_sm = -(-blocks * split // SMS)
    resident = max(1, min(per_sm, 2048 // threads,
                          65536 // (threads * REGS_PER_THREAD),
                          (KERNEL_MAX_SMEM + 4096) // max(smem, 1)))
    if bf16:
        # a block's per-chunk stall overlaps the other resident blocks' work
        chunk_clk /= resident
    work = chunks * (chunk_clk + max(
        instr / ISSUE_PER_CLK, mma * mma_clk, ksteps * waves_k * WAVE_CLK,
        staged / L2_BYTES_PER_CLK, copied * COPY_CLK))
    chain = chunks * LATENCY_CLK / (stages - 1)
    busy = min(1.0, resident * warps / FULL_WARPS)
    waves = -(-per_sm // resident)
    clk = waves * (max(resident * work / busy, chain) + LATENCY_CLK)
    if split > 1:
        clk += waves * ((INT8_REDUCE_CLK if int8 else REDUCE_CLK)
                        + 4 * s * s * pix * t_co / L2_BYTES_PER_CLK)
    return clk


def _wgmma_cost(geom, t_n, t_co, t_ci, pix, wg, blocks, split, n_chunks,
                window, slots):
    """`tc_cost` of the bf16 kernels' wgmma path, one block per SM (a
    producer warpgroup and one or two consumer warpgroups at the launch
    bound's registers).  Per block and CI chunk a fixed cost (the ring's
    barriers, a copy's latency, the fresh partial's adds) and the larger
    of the wgmma (m64nNk16, N/8 units of WG_MMA_CLK) and the bytes staged
    (the window's rows and the weight boxes) against WG_L2_BYTES_PER_CLK;
    a split adds its cluster barriers and the partial tile's reads.  Fitted
    to `tools/sweep_tiles.py --dtype bfloat16` on an H100 (median error 17 %
    of a tile's time); the chunk's fixed cost dominates, so wide CI chunks
    win."""
    consumers, wm, n = wg
    s = geom.stride
    taps = max(1, slots // (s * s))           # valid taps of a phase
    units = consumers * wm * taps * (t_ci // 16) * (n // 8)
    staged = 2 * t_ci * (t_n * window + slots * t_co)
    chunks = -(-n_chunks // split)
    waves = -(-blocks * split // SMS)
    clk = waves * chunks * (WG_CHUNK_CLK + max(units * WG_MMA_CLK,
                                               staged / WG_L2_BYTES_PER_CLK))
    if split > 1:
        clk += waves * (WG_SPLIT_CLK + WG_REDUCE_CLK * 4 * s * s * pix * t_co)
    return clk


def _wgmma_f32_cost(geom, t_n, t_ci, wg, blocks, split, n_chunks, window,
                    slots):
    """`tc_cost` of the fp32 dense kernel's wgmma path, one block per SM.
    A consumer warpgroup issues its WM tiles' tap groups one after another
    (a group: one tap's ``t_ci / 8`` k8 steps of three dependent m64n64k8
    wgmma), each group waiting on the one before it; on the H100 a group's
    time was its latency, so the model is per chunk WM x taps groups of
    WG_F32_GROUP_CLK and WG_F32_MMA_CLK a wgmma, and WG_F32_XROW_CLK per staged
    window pixel (a small tile's halo: 16x16 tiles of one image ran 2 %
    faster than 4x4 tiles of 16), plus WG_F32_BLOCK_CLK a block;
    the producer's copies and lo planes ran faster than that at every
    timed tile.  A cluster split adds WG_F32_SPLIT_CLK a rank (its
    barriers and the partial tiles' reads, which cost splits of 4 and 8
    more than the bf16 path's constant says).  Fitted to
    `tools/sweep_tiles.py --dtype float32 --wgmma-only` on an H100
    (CelebA layers 1-3 and MNIST layer 1 at buckets 16, 32 and 64)."""
    wm = wg[1]
    s = geom.stride
    taps = max(1, slots // (s * s))           # valid taps of a phase
    group = WG_F32_GROUP_CLK + 3 * (t_ci // 8) * WG_F32_MMA_CLK
    chunks = -(-n_chunks // split)
    waves = -(-blocks * split // SMS)
    clk = waves * (WG_F32_BLOCK_CLK + chunks * (wm * taps * group
                                                + t_n * window * WG_F32_XROW_CLK))
    if split > 1:
        clk += waves * WG_F32_SPLIT_CLK * split
    return clk


@functools.lru_cache(maxsize=1024)
def _tc_scored(geom: DeconvGeometry, batch: int, dtype: str = "float32",
               sparse: bool = False) -> Tuple[Tuple[bool, float,
                                                    TileChoice], ...]:
    """Every tile the tensor-core kernel of ``dtype`` (``sparse``: its
    zero-skip launch) takes, in enumeration order, as ``(fills the SMs,
    modelled clocks, tiles)``."""
    out = []
    for t, t_n, t_co, t_ci in _tc_candidates(geom, batch, dtype, sparse):
        clk = tc_cost(geom, batch, t, t_n, t_co, t_ci, dtype, sparse)
        if clk is None:
            continue
        blocks = grid_blocks(geom, batch, t, t_co, t_n)
        split = ci_split(blocks, _round_up(geom.c_in, t_ci) // t_ci)
        out.append((blocks * split >= SMS, clk,
                    TileChoice(t_oh=t, t_ow=t, t_ci=t_ci, t_co=t_co,
                               t_n=t_n)))
    if not out:
        raise ValueError(f"no tile of the {dtype} tensor-core kernel fits "
                         f"{geom}")
    return tuple(out)


# bucket 1, fp32: the fewest blocks of a cluster-split grid that the rule
# below keeps (one image runs on a single wave of them)
BUCKET1_MIN_CTAS = 64


def _tc_tiles(geom: DeconvGeometry, batch: int, dtype: str = "float32",
              sparse: bool = False) -> TileChoice:
    """The cheapest tiles by `tc_cost` among those whose grid, split
    included, fills the card's SMs; the cheapest of all where none does.
    fp32 at bucket 1 (`_bucket1_tiles`) is the exception, but on a 1x1
    root."""
    scored = _tc_scored(geom, batch, dtype, sparse)
    if batch == 1 and dtype == "float32" and (geom.in_h, geom.in_w) != (1, 1):
        return _bucket1_tiles(geom, scored)
    return min(scored, key=lambda s: (not s[0], s[1]))[2]


def _bucket1_tiles(geom: DeconvGeometry, scored) -> TileChoice:
    """fp32 at bucket 1: the largest spatial tile; among its candidates
    whose cluster-split grid has at least BUCKET1_MIN_CTAS blocks (else
    all of them), the widest channel tile; then the cheapest by `tc_cost`,
    a tie going to the larger CI chunk.  On the H100 (`tools/
    sweep_tiles.py --dtype float32 --buckets 1`) every candidate of both
    generators' layers 1-4 ran fastest in one wave of 64-128 blocks at
    the largest spatial tile, and `tc_cost`, whose waves and fill-the-SMs
    preference are those of a full card, put them 1.3-2.0x behind its
    pick; this rule's picks ran within 6 % of the fastest."""
    t = max(c.t_oh for _, _, c in scored)
    cands = [(clk, c) for _, clk, c in scored if c.t_oh == t]

    def ctas(c):
        blocks = grid_blocks(geom, 1, c.t_oh, c.t_co, c.t_n)
        return blocks * ci_split(blocks, _round_up(geom.c_in, c.t_ci) // c.t_ci)

    wide = [(clk, c) for clk, c in cands if ctas(c) >= BUCKET1_MIN_CTAS]
    if not wide:
        most = max(ctas(c) for _, c in cands)
        wide = [(clk, c) for clk, c in cands if ctas(c) == most]
    t_co = max(c.t_co for _, c in wide)
    return min(((clk, c) for clk, c in wide if c.t_co == t_co),
               key=lambda e: (e[0], -e[1].t_ci))[1]


# how many candidates ``refine=True`` times per layer
REFINE_TOP_K = 3


def refine_candidates(geom: DeconvGeometry, batch: int, dtype="float32",
                      k: int = REFINE_TOP_K,
                      sparse: bool = False) -> List[TileChoice]:
    """What ``refine=True`` times: the model's pick, then the next ``k - 1``
    tiles by `tc_cost` alone, without the fill-the-SMs preference."""
    model = hopper_tiles(geom, batch, dtype, sparse)
    ranked = sorted(_tc_scored(geom, batch, dtype_name(dtype), sparse),
                    key=lambda s: s[1])
    return [model] + [c for _, _, c in ranked if c != model][:max(0, k - 1)]


# -- timing on the card -------------------------------------------------
TIMED_RUNS = 25
BACKLOG_CYCLES = 400_000_000   # ~0.2 s of queued sleep at the H100's clocks
BACKLOG_TRIES = 3              # the sleep doubles after each failed try


def time_ms(fn: Callable[[], object], runs: int = TIMED_RUNS,
            warmup: int = 3, backlog: bool = True):
    """``(ms, held)``: the median of ``runs`` CUDA-event timings of ``fn``
    after ``warmup`` calls.

    With ``backlog`` the card first runs a queued sleep while the host
    enqueues every timed run, so that each event pair brackets device time
    only (a short kernel would otherwise be timed together with the host
    work of its own launch).  ``held`` says whether that worked: the event
    after the sleep had not completed when the host had enqueued the last
    run.  If it had, the sleep is doubled and the timing taken again, up to
    ``BACKLOG_TRIES`` times; a timing that never held is returned with
    ``held`` False.  Without ``backlog``, ``held`` is None."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = BACKLOG_CYCLES
    for _ in range(BACKLOG_TRIES if backlog else 1):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
        if backlog:
            torch.cuda._sleep(cycles)
            slept = torch.cuda.Event()
            slept.record()
        for e0, e1 in events:
            e0.record()
            fn()
            e1.record()
        held = (not slept.query()) if backlog else None
        torch.cuda.synchronize()
        ms = statistics.median(e0.elapsed_time(e1) for e0, e1 in events)
        if held is not False:
            break
        cycles *= 2
    return ms, held


def _time_candidate(geom: DeconvGeometry, choice: TileChoice, dtype,
                    backend: str, batch: int = 1,
                    runs: int = TIMED_RUNS) -> Optional[float]:
    """Median device ms of one launch of the serving launcher at
    ``choice``, on seeded random inputs at the layer's shapes on the card:
    one warm launch, then `time_ms`.  None where the launcher refuses the
    tiles before launching (its shape or shared-memory checks); a CUDA
    error raises.  For "cuda_sparse" the dense random weights keep every
    slab in the schedule (the JAX package's own caveat): the time is that
    of the dense walk, not of a pruned network's."""
    from .deconv2d.kernel import LaunchRefused, deconv2d_launch, pack_ci_minor
    from .deconv2d.ops import launch_args

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name(dtype))
    gen = torch.Generator(device=dev).manual_seed(0)
    g = geom
    x = torch.randn((batch, g.in_h, g.in_w, g.c_in), generator=gen,
                    device=dev).to(dt)
    w = (torch.randn((g.kernel, g.kernel, g.c_in, g.c_out), generator=gen,
                     device=dev) / (g.c_in * g.kernel ** 2) ** 0.5).to(dt)
    b = (0.1 * torch.randn((g.c_out,), generator=gen, device=dev)).to(dt)
    try:
        xp, wp, bp, kw, _ = launch_args(x, w, b, g.stride, g.padding,
                                        *choice.as_kwargs().values(), None)
        if backend == "cuda_sparse":
            from .deconv2d_sparse import (deconv2d_sparse_launch,
                                          make_sparse_plan, schedule_tensors)

            sched = schedule_tensors(make_sparse_plan(
                w, g.stride, g.padding, choice.t_ci, choice.t_co), dev)

            def fn():
                return deconv2d_sparse_launch(xp, wp, bp, *sched, **kw)
        else:
            wt = pack_ci_minor(wp)     # a serving engine's, packed once

            def fn():
                return deconv2d_launch(xp, wp, bp, wt=wt, **kw)
        fn()
    except (LaunchRefused, ValueError):
        return None
    return time_ms(fn, runs=runs, warmup=0)[0]


# -- the cache ----------------------------------------------------------
_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
# 1: timed entries only, keyed by plan hash, card name and kernel source
CACHE_VERSION = 1
_TILE_FIELDS = ("t_oh", "t_ow", "t_ci", "t_co", "t_n")
_lock = threading.Lock()
_cache: Optional[Dict[str, dict]] = None


def cache_path() -> pathlib.Path:
    """``$REPRO_TORCH_AUTOTUNE_CACHE``, default
    ``~/.cache/repro_torch/autotune.json``."""
    default = pathlib.Path.home() / ".cache" / "repro_torch" / "autotune.json"
    return pathlib.Path(os.environ.get(_CACHE_ENV, str(default)))


def card_name() -> Optional[str]:
    """The name of the current CUDA device, None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(torch.cuda.current_device())


def cache_key(geom: DeconvGeometry, dtype, backend: str, batch: int = 1,
              out_dtype_bytes: Optional[int] = None) -> str:
    """``v{CACHE_VERSION}|card|source digest|plan hash``: the plan hash is
    `DeconvPlan.stable_hash(scope="tiles")` of the request, the source
    digest that of the kernel library's source."""
    from ..plan import DeconvPlan
    from ._build import source_digest

    plan = DeconvPlan(geometry=geom, batch=batch, dtype=dtype_name(dtype),
                      backend=backend, out_dtype_bytes=out_dtype_bytes)
    return (f"v{CACHE_VERSION}|{card_name() or 'no card'}|"
            f"{source_digest('deconv2d_tc')}|"
            f"{plan.stable_hash(scope='tiles')}")


def _valid_entry(v) -> bool:
    return (isinstance(v, dict) and v.get("source") == "timed"
            and all(isinstance(v.get(f), int) and v[f] > 0
                    for f in _TILE_FIELDS))


def _load_cache() -> Dict[str, dict]:
    """The cache, read once per process; a corrupt file, a foreign version
    and malformed entries are dropped."""
    global _cache
    if _cache is None:
        try:
            raw = json.loads(cache_path().read_text())
        except (OSError, ValueError):
            raw = {}
        if not isinstance(raw, dict):
            raw = {}
        prefix = f"v{CACHE_VERSION}|"
        _cache = {k: v for k, v in raw.items()
                  if k.startswith(prefix) and _valid_entry(v)}
    return _cache


def _store(key: str, entry: dict) -> None:
    """Keep ``entry`` and rewrite the file through a temporary one; a file
    that cannot be written never fails the call."""
    with _lock:
        cache = _load_cache()
        cache[key] = entry
        path = cache_path()
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(path.name + ".tmp")
            tmp.write_text(json.dumps(cache, indent=1, sort_keys=True))
            os.replace(tmp, path)
        except OSError:
            pass


def clear_cache() -> None:
    """Drop the in-memory cache and delete the cache file."""
    global _cache
    with _lock:
        _cache = {}
        try:
            cache_path().unlink()
        except OSError:
            pass


def cached_entry(geom: DeconvGeometry, dtype="float32", backend="cuda",
                 batch: int = 1,
                 out_dtype_bytes: Optional[int] = None) -> Optional[dict]:
    """The stored timed entry of a request, or None: the pick's tiles,
    ``ms``, ``model`` (the model's pick) and ``model_ms``, ``k`` and every
    timed candidate under ``timed``."""
    return _load_cache().get(cache_key(geom, dtype, backend, batch,
                                       out_dtype_bytes))


def choose_tiles(geom: DeconvGeometry, dtype="float32", backend: str = "cuda",
                 refine: bool = False, batch: int = 1,
                 out_dtype_bytes: Optional[int] = None) -> TileChoice:
    """Tiles for one layer at ``batch``: a timed entry of the cache where
    one exists (``source="cache"``), else with ``refine`` the fastest of
    `refine_candidates` timed on the card (stored; ``source="timed"``),
    else the model's pick (`hopper_tiles`, never stored).  int8 and bf16
    keep the model's pick under ``refine``; without a card ``refine``
    raises.  The model alone, the cache unread, is `hopper_tiles` (what
    ``build_layer_plan(autotune=False)`` takes)."""
    name = dtype_name(dtype)
    if refine and card_name() is None:
        raise RuntimeError("refine=True times the kernels on a CUDA card; "
                           "there is none (the plain version's clock says "
                           "nothing about the kernel)")
    refine = refine and name == "float32"
    key = cache_key(geom, name, backend, batch, out_dtype_bytes)
    hit = _load_cache().get(key)
    if hit is not None:
        return TileChoice(**{f: hit[f] for f in _TILE_FIELDS},
                          source="cache")
    sparse = backend == "cuda_sparse"
    model = hopper_tiles(geom, batch, name, sparse)
    if not refine:
        return model
    timed = []
    for c in refine_candidates(geom, batch, name, sparse=sparse):
        ms = _time_candidate(geom, c, name, backend, batch=batch)
        if ms is not None:
            timed.append((ms, c))
    if not timed:
        return model
    best_ms, best = min(timed, key=lambda t: t[0])
    model_ms = next((ms for ms, c in timed if c == model), None)
    _store(key, {**best.as_kwargs(), "source": "timed", "ms": best_ms,
                 "model": model.as_kwargs(), "model_ms": model_ms,
                 "k": REFINE_TOP_K,
                 "timed": [{"tiles": c.as_kwargs(), "ms": ms}
                           for ms, c in timed]})
    return dataclasses.replace(best, source="timed")
