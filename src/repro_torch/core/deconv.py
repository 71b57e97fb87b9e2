"""The paper's reverse-loop deconvolution algorithm, in numpy and PyTorch.

* ``deconv2d_algorithm1_numpy`` — a literal, instrumented transcription of
  the paper's Algorithm 1 (a copy of the JAX package's oracle).
* ``deconv2d_reverse_loop`` — the phase-decomposed formulation in plain
  torch: per output phase and contributing tap, a shifted slice of x times
  one ``(C_in, C_out)`` weight matrix, accumulated in f32, then one pixel
  shuffle.  The CUDA kernel computes the same sums per output tile.
* ``deconv2d_zero_insertion`` — the conventional formulation through
  ``F.conv_transpose2d`` (cuDNN on the card): the paper's GPU baseline.

All take NHWC activations and (K, K, C_in, C_out) weights, with the
PyTorch-style geometry  O = (I-1)*S + K - 2P.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .offsets import PhasePlan, make_phase_plan, offset_table
from .tiling import out_size


def fp32_exact(device: torch.device) -> None:
    """Keep float32 products in full float32 on the card.

    cuDNN's float32 convolutions default to TF32, which keeps about three
    decimal digits; the 1e-4 parity tolerance needs full float32.  Both
    flags are process-wide, so this is called wherever a plain or library
    float32 product is about to run on a CUDA device."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# Literal Algorithm 1 (numpy, instrumented)
# ---------------------------------------------------------------------------
def deconv2d_algorithm1_numpy(
    x: np.ndarray,
    w: np.ndarray,
    b: Optional[np.ndarray],
    stride: int,
    padding: int,
    t_oh: Optional[int] = None,
    t_ow: Optional[int] = None,
    zero_skip: bool = False,
) -> Tuple[np.ndarray, int]:
    """Paper Algorithm 1, per output tile, with Eq. 3 offsets precomputed.

    x: (IH, IW, CI);  w: (K, K, CI, CO);  returns (y (OH, OW, CO), macs).
    ``zero_skip`` reproduces the conditional-execution paradigm: weights equal
    to zero are skipped and the returned MAC count drops accordingly.
    """
    ih, iw, ci = x.shape
    k = w.shape[0]
    oh = out_size(ih, k, stride, padding)
    ow = out_size(iw, k, stride, padding)
    t_oh = t_oh or oh
    t_ow = t_ow or ow
    f = offset_table(k, stride, padding)  # enhancement (1): 2K modulo ops total
    y = np.zeros((oh, ow, w.shape[3]), dtype=np.float64)
    if b is not None:
        y += b  # initializeToBias()
    macs = 0
    # spatially-parallel CU workloads: disjoint output tiles
    for base_h in range(0, oh, t_oh):
        for base_w in range(0, ow, t_ow):
            # enhancement (2): weight loops outermost (loop interchange)
            for kh in range(k):
                for kw in range(k):
                    fh, fw = int(f[kh]), int(f[kw])
                    for oh_hat in range(0, t_oh, stride):
                        for ow_hat in range(0, t_ow, stride):
                            o_h = base_h + oh_hat + fh
                            o_w = base_w + ow_hat + fw
                            if o_h >= oh or o_w >= ow:
                                continue
                            i_h, rh = divmod(o_h + padding - kh, stride)
                            i_w, rw = divmod(o_w + padding - kw, stride)
                            assert rh == 0 and rw == 0, "offset math broken"
                            if not (0 <= i_h < ih and 0 <= i_w < iw):
                                continue
                            wv = w[kh, kw]  # (CI, CO)
                            if zero_skip:
                                nz = wv != 0.0
                                y[o_h, o_w] += x[i_h, i_w] @ (wv * nz)
                                macs += int(nz.sum())
                            else:
                                y[o_h, o_w] += x[i_h, i_w] @ wv
                                macs += wv.size
    return y.astype(x.dtype), macs


# ---------------------------------------------------------------------------
# Phase-decomposed reverse loop (plain torch)
# ---------------------------------------------------------------------------
def phase_products(xp: torch.Tensor, w: torch.Tensor, plan: PhasePlan,
                   n_h: int, n_w: int, init: torch.Tensor) -> torch.Tensor:
    """The reverse loop over a halo-padded input, in f32.

    ``xp`` is padded by ``plan.left_halo`` rows/cols on the top/left and far
    enough on the bottom/right that every phase grid of ``n_h x n_w`` pixels
    is in bounds.  Output phase-row ``t`` of tap displacement ``d`` reads
    input row ``t + left_halo + d``.  Every phase accumulator starts at
    ``init`` (broadcast over ``(N, n_h, n_w, C_out)``).  Returns the pixel
    shuffled ``(N, n_h*S, n_w*S, C_out)`` f32 result."""
    n = xp.shape[0]
    s = plan.stride
    co = w.shape[3]
    x32 = xp.float()
    w32 = w.float()
    base = plan.left_halo
    rows = []
    for ph in range(s):
        cols = []
        for pw in range(s):
            acc = init.float().expand(n, n_h, n_w, co).clone()
            for kh, dh in plan.taps[ph]:
                for kw, dw in plan.taps[pw]:
                    xs = x32[:, base + dh:base + dh + n_h,
                             base + dw:base + dw + n_w, :]
                    acc = acc + torch.matmul(xs, w32[kh, kw])
            cols.append(acc)
        rows.append(torch.stack(cols, dim=0))   # (S_w, N, n_h, n_w, CO)
    y = torch.stack(rows, dim=0)                # (S_h, S_w, N, n_h, n_w, CO)
    # pixel shuffle: (N, n_h, S_h, n_w, S_w, CO) -> (N, n_h*S, n_w*S, CO)
    return y.permute(2, 3, 0, 4, 1, 5).reshape(n, n_h * s, n_w * s, co)


def deconv2d_reverse_loop(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int,
    padding: int,
) -> torch.Tensor:
    """Reverse-loop deconvolution with the host-side phase decomposition,
    accumulated in f32 and cast back to x's dtype."""
    fp32_exact(x.device)
    n, ih, iw, _ = x.shape
    k = w.shape[0]
    s = stride
    oh = out_size(ih, k, s, padding)
    ow = out_size(iw, k, s, padding)
    plan = make_phase_plan(k, s, padding)
    n_h = -(-oh // s)  # ceil: padded phase grid
    n_w = -(-ow // s)
    pad_l = plan.left_halo
    pad_rh = max(0, (n_h - 1 + plan.delta_max) - (ih - 1))
    pad_rw = max(0, (n_w - 1 + plan.delta_max) - (iw - 1))
    xp = F.pad(x, (0, 0, pad_l, pad_rw, pad_l, pad_rh))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    y = phase_products(xp, w, plan, n_h, n_w, zero)[:, :oh, :ow, :]
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Conventional zero-insertion formulation (the cuDNN baseline)
# ---------------------------------------------------------------------------
def deconv2d_zero_insertion(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int,
    padding: int,
) -> torch.Tensor:
    """Transposed conv through ``F.conv_transpose2d``: the standard
    formulation the paper contrasts against (cuDNN on the card).  Takes and
    returns the NHWC / KKCiCo layouts; TF32 is off on the card."""
    fp32_exact(x.device)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1), b,
                           stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)
