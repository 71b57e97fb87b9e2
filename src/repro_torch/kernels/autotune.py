"""Tile choice for the Hopper deconv kernel.

A deterministic heuristic picks the same ``TileChoice`` fields as the JAX
package's autotuner (``t_oh, t_ow, t_ci, t_co, t_n``), for the kernel in
``csrc/deconv2d.cu`` on an H100:

* ``t_oh``/``t_ow`` are multiples of the stride (every tile has the same
  phase structure);
* the weight slab of one CI chunk stays within a 64 KB budget, so
  ``kernel_smem_bytes`` is far under the 227 KB a block may have and
  several blocks share an SM;
* a block has at most 512 threads (``block_threads``; the kernel's launch
  bound), aiming at 256;
* a 1x1 root layer takes S-pixel spatial tiles, one valid tap each;
* the grid fills the 132 SMs: at small batch the channel tile narrows
  (down to 4; a block then re-reads only the small input window), and
  only below 66 blocks does the spatial tile shrink (each spatial tile
  re-reads the whole weight slab), while a block keeps 16 threads; at
  large batch the batch tile grows while threads, blocks and a 100 KB
  shared-memory target allow, so each staged weight feeds more pixels.

The TPU tiles do not carry over: the JAX plan picks ``t_ci = t_co = 128`` on
CelebA's wide layers, a 1 MB weight slab.  Timed tuning and its cache are
later work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..core.tiling import DeconvGeometry, block_threads, kernel_smem_bytes

SMS = 132                      # streaming multiprocessors of an H100
SMEM_TARGET = 100 * 1024       # the batch tile grows only within this
W_SLAB_BUDGET = 64 * 1024      # weight slab per CI chunk, bytes
TARGET_THREADS = 256
MAX_SPATIAL = 16
MAX_CO_TILE = 64
MIN_CO_TILE = 4
MIN_THREADS = 16               # smallest block the spatial shrink makes
MAX_CI_TILE = 32


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


def _ci_tile(c_in: int, kernel: int, t_co: int) -> int:
    """Largest CI chunk whose weight slab fits the budget, then, within a
    factor of two of it, the one that pads C_in least (ties: larger)."""
    cap = W_SLAB_BUDGET // (kernel * kernel * t_co * 4)
    cap = max(1, min(cap, MAX_CI_TILE, c_in))
    lo = max(1, -(-cap // 2))
    return min(range(lo, cap + 1), key=lambda t: (_round_up(c_in, t), -t))


def grid_blocks(geom: DeconvGeometry, batch: int, t: int, t_co: int,
                t_n: int) -> int:
    """Thread blocks of one launch at square spatial tile ``t``."""
    return (-(-batch // t_n) * (-(-geom.out_h // t)) * (-(-geom.out_w // t))
            * (-(-geom.c_out // t_co)))


def hopper_tiles(geom: DeconvGeometry, batch: int = 1) -> TileChoice:
    """Tiles for one layer at the batch its kernel will see."""
    s = geom.stride
    t_co = min(geom.c_out, MAX_CO_TILE)
    if geom.in_h == geom.in_w == 1:
        # a 1x1 root: each S-pixel tile has exactly one valid tap (the
        # kernel skips the taps that read only halo padding)
        t = s
    else:
        t = min(_round_up(geom.out_h, s), _round_up(MAX_SPATIAL, s))
    while block_threads(s, t, t, t_co, 1) > TARGET_THREADS and t > s:
        t = max(s, _round_up(t // 2, s))
    while grid_blocks(geom, batch, t, t_co, 1) < SMS and t_co > MIN_CO_TILE:
        t_co = max(MIN_CO_TILE, t_co // 2)
    while grid_blocks(geom, batch, t, t_co, 1) < SMS // 2 and t > s:
        smaller = max(s, _round_up(t // 2, s))
        if block_threads(s, smaller, smaller, t_co, 1) < MIN_THREADS:
            break
        t = smaller
    t_ci = _ci_tile(geom.c_in, geom.kernel, t_co)
    t_n = 1
    while (t_n * 2 <= batch
           and block_threads(s, t, t, t_co, t_n * 2) <= TARGET_THREADS
           and grid_blocks(geom, batch, t, t_co, t_n * 2) >= SMS
           and kernel_smem_bytes(geom, t, t, t_ci, t_co, t_n * 2) <= SMEM_TARGET):
        t_n *= 2
    return TileChoice(t_oh=t, t_ow=t, t_ci=t_ci, t_co=t_co, t_n=t_n)


def fill_tiles(geom: DeconvGeometry, batch: int, **given) -> TileChoice:
    """The tiles given by name (``t_oh=...``), the ones left out or None
    taken from `hopper_tiles` at this batch."""
    return dataclasses.replace(hopper_tiles(geom, batch),
                               **{f: v for f, v in given.items() if v is not None})

