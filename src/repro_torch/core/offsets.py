"""Stride-hole-skipping offsets (paper Eq. 3) and their phase-decomposition.

The paper's enhancement (1): the offset

    f_h = mod(S - mod(P - k_h, S), S)                       (Eq. 3)

depends only on the filter-tap index ``k_h`` (not on the output pixel), so the
2K offsets are precomputed once per layer.  This package goes one step further
and folds the offsets into a *host-side phase decomposition*: output pixel
``o`` receives tap ``k`` iff ``(o + P - k) % S == 0``, i.e. iff the output
phase ``o % S`` equals ``(k - P) % S`` (== ``f_h``).  The CUDA kernel reads
the resulting (phase -> taps, displacement) table, so its tap loop executes
no modulo instruction.

A numpy-only copy of ``repro.core.offsets``: the PyTorch port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


def offset(k: int, stride: int, padding: int) -> int:
    """Paper Eq. 3: f = mod(S - mod(P - k, S), S).

    ``np.mod`` follows the mathematical (non-negative) convention assumed by
    the paper's derivation.
    """
    s = int(stride)
    return int(np.mod(s - np.mod(padding - k, s), s))


def offset_table(kernel_size: int, stride: int, padding: int) -> np.ndarray:
    """Precompute the K offsets of enhancement (1).  2K ops total per layer
    (one table per spatial dim; square kernels share the table)."""
    return np.array(
        [offset(k, stride, padding) for k in range(kernel_size)], dtype=np.int32
    )


def taps_for_phase(phase: int, kernel_size: int, stride: int, padding: int) -> List[int]:
    """All tap indices k whose contributions land on output pixels of
    ``o % S == phase``; equivalently {k : f(k) == phase} (Eq. 3)."""
    return [k for k in range(kernel_size) if offset(k, stride, padding) == phase]


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """Static per-layer plan: for each output phase, the contributing taps and
    their input displacements ``delta = (phase + P - k) // S`` (an exact
    integer division by construction — this is Eq. 4 with the modulo removed).
    """

    kernel_size: int
    stride: int
    padding: int
    # phase -> list of (tap k, delta)
    taps: Dict[int, List[Tuple[int, int]]]
    delta_min: int
    delta_max: int

    @property
    def left_halo(self) -> int:
        """Input rows needed before the tile's base row (>= 0)."""
        return max(0, -self.delta_min)

    @property
    def right_halo(self) -> int:
        return max(0, self.delta_max)


def make_phase_plan(kernel_size: int, stride: int, padding: int) -> PhasePlan:
    taps: Dict[int, List[Tuple[int, int]]] = {p: [] for p in range(stride)}
    deltas: List[int] = []
    for phase in range(stride):
        for k in taps_for_phase(phase, kernel_size, stride, padding):
            num = phase + padding - k
            assert num % stride == 0, "phase decomposition must be exact"
            delta = num // stride
            taps[phase].append((k, delta))
            deltas.append(delta)
    if not deltas:  # degenerate (K == 0) — never used, keep total
        deltas = [0]
    return PhasePlan(
        kernel_size=kernel_size,
        stride=stride,
        padding=padding,
        taps=taps,
        delta_min=min(deltas),
        delta_max=max(deltas),
    )


def modulo_op_count_naive(kernel_size: int, out_h: int, out_w: int) -> int:
    """Modulo ops executed by the un-enhanced reverse-loop algorithm (Eq. 4
    evaluated per (tap, output pixel))."""
    return 2 * kernel_size * kernel_size * out_h * out_w


def modulo_op_count_paper(kernel_size: int) -> int:
    """Modulo ops with the paper's enhancement (1): 2K per layer."""
    return 2 * kernel_size


def modulo_op_count_ours() -> int:
    """Modulo ops in the kernel's tap loop with the phase decomposition: zero."""
    return 0
