"""Weight pruning and zero-skipping analysis (paper §V-C, Fig. 6).

The JAX package's ``repro.core.sparsity`` on torch tensors and numpy:
magnitude pruning as in Han et al. [11], and the zero-skipping
execution-time model at element granularity (the FPGA's conditional
execution) and at block granularity ((C_in-block x C_out-block) slabs, the
granularity at which the zero-skip kernel drops whole CI chunks).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch


def magnitude_prune(w: torch.Tensor, sparsity: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the smallest-|w| fraction ``sparsity`` of entries.  Returns
    (pruned weights, keep-mask)."""
    if sparsity <= 0.0:
        return w, torch.ones_like(w, dtype=torch.bool)
    flat = w.abs().reshape(-1)
    k = int(np.clip(round(sparsity * flat.numel()), 0, flat.numel()))
    if k == 0:
        return w, torch.ones_like(w, dtype=torch.bool)
    thresh = torch.sort(flat).values[k - 1]
    mask = w.abs() > thresh
    return w * mask, mask


def prune_tree(params, sparsity: float,
               key_filter: Callable[[str], bool] = lambda path: True):
    """Magnitude-prune every weight leaf (``ndim >= 2``) of a nested dict of
    tensors whose path passes ``key_filter``.  Paths are spelled as the
    reference's ``jax.tree_util.keystr`` spells them (``"['l0']['w']"``), so
    a filter written for the reference selects the same leaves here."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}[{k!r}]") for k, v in node.items()}
        if key_filter(path) and node.ndim >= 2:
            return magnitude_prune(node, sparsity)[0]
        return node

    return walk(params, "")


@dataclasses.dataclass(frozen=True)
class SkipStats:
    total_macs: int
    element_macs: int        # MACs under element-level zero-skip (FPGA)
    block_macs: int          # MACs under block-level zero-skip (the kernel)
    element_speedup: float   # t0 / tp model: total / executed
    block_speedup: float


def _nonzero(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    return np.asarray(w) != 0.0


def zero_skip_stats(w, block_ci: int = 8, block_co: int = 128) -> SkipStats:
    """Execution-time model of zero-skipping for one (K,K,CI,CO) weight.

    * element level: every zero weight's MAC is skipped (paper's FPGA CUs);
    * block level: a (block_ci x block_co) slab of a tap is skipped iff it
      is entirely zero (the zero-skip kernel's static schedule).
    """
    nz = _nonzero(w)
    k1, k2, ci, co = nz.shape
    total = k1 * k2 * ci * co
    element = int(nz.sum())
    live = block_mask(nz, block_ci, block_co)
    # a live slab counts its real (unpadded) channels
    ci_sizes = np.minimum(block_ci, ci - block_ci * np.arange(live.shape[2]))
    co_sizes = np.minimum(block_co, co - block_co * np.arange(live.shape[3]))
    block = int((live * ci_sizes[:, None] * co_sizes[None, :]).sum())
    return SkipStats(
        total_macs=total,
        element_macs=element,
        block_macs=block,
        element_speedup=total / max(element, 1),
        block_speedup=total / max(block, 1),
    )


def block_mask(w, block_ci: int, block_co: int) -> np.ndarray:
    """(K, K, n_ci_blocks, n_co_blocks) bool: True where the slab has any
    nonzero (must be computed).  Consumed by kernels/deconv2d_sparse."""
    nz = _nonzero(w)
    k1, k2, ci, co = nz.shape
    n_ci = -(-ci // block_ci)
    n_co = -(-co // block_co)
    nz = np.pad(nz, ((0, 0), (0, 0), (0, n_ci * block_ci - ci),
                     (0, n_co * block_co - co)))
    nz = nz.reshape(k1, k2, n_ci, block_ci, n_co, block_co)
    return nz.any(axis=(3, 5))
