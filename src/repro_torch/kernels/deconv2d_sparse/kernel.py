"""Launcher, plain version and schedule of the zero-skip deconv kernel.

The counterpart of the JAX package's ``_sparse_kernel``.  Inference
weights are static, so after magnitude pruning the host lists, per C_out
tile, the C_in slabs (``t_ci`` input channels by ``t_co`` output channels
of one tap) that hold any nonzero (`build_schedule`).  The kernel
(``deconv2d_sparse_forward`` in ``csrc/deconv2d.cu``) is the dense kernel
with its CI loop walking only the listed slabs and each tap's products
skipped where the slab's tap bit is 0.  Skipping an all-zero slab changes
no sum, so the result is the dense result on the pruned weights.

* On a CUDA tensor `deconv2d_sparse_launch` launches the kernel or raises.
  The schedule tensors must already be on the card (`schedule_tensors`),
  so a serving engine copies them once per plan.
* On a CPU tensor it runs `deconv2d_sparse_launch_plain`: the dense plain
  version on the weights the schedule keeps (zeroed elsewhere), so a
  schedule that drops a nonzero slab changes its result as it changes
  the kernel's.

``LAUNCHES`` counts launches of the zero-skip kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.offsets import PhasePlan
from ..deconv2d.kernel import (_check_shapes, check_rc,
                               deconv2d_launch_plain, launch_params, library)

LAUNCHES = 0

Schedule = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def build_schedule(block_tap_mask: np.ndarray):
    """Compress the CI-tile dimension per CO tile (the reference's
    ``build_schedule``, verbatim).

    block_tap_mask: (K, K, n_ci, n_co) bool, a slab has any nonzero.
    Returns (ci_idx (n_co, L) int32, valid (n_co, L) int32,
             tap_mask (n_co, L, K*K) int32, L), L = max surviving CI tiles.
    Padding entries repeat index 0 with valid=0 (not computed).
    """
    k1, k2, n_ci, n_co = block_tap_mask.shape
    any_tap = block_tap_mask.any(axis=(0, 1))  # (n_ci, n_co)
    lists = [np.nonzero(any_tap[:, co])[0] for co in range(n_co)]
    max_len = max(1, max(len(l) for l in lists))
    ci_idx = np.zeros((n_co, max_len), dtype=np.int32)
    valid = np.zeros((n_co, max_len), dtype=np.int32)
    tap_mask = np.zeros((n_co, max_len, k1 * k2), dtype=np.int32)
    for co, l in enumerate(lists):
        for j, ci in enumerate(l):
            ci_idx[co, j] = ci
            valid[co, j] = 1
            tap_mask[co, j] = block_tap_mask[:, :, ci, co].reshape(-1)
    return ci_idx, valid, tap_mask, max_len


def schedule_tensors(tables: Sequence, device) -> Schedule:
    """``(ci_idx, valid, tap_mask)`` (numpy or tensors) as contiguous int32
    tensors on ``device``."""
    return tuple(torch.as_tensor(np.asarray(a, np.int32) if not
                                 isinstance(a, torch.Tensor) else a)
                 .to(device=device, dtype=torch.int32).contiguous()
                 for a in tables)


def _check_schedule(ci_idx, valid, tap_mask, k: int, cop: int,
                    t_co: int) -> None:
    n_co = cop // t_co
    if ci_idx.ndim != 2 or valid.shape != ci_idx.shape or \
            tuple(tap_mask.shape) != (*ci_idx.shape, k * k):
        raise ValueError(f"schedule shapes ci_idx {tuple(ci_idx.shape)}, valid "
                         f"{tuple(valid.shape)}, tap_mask "
                         f"{tuple(tap_mask.shape)} do not fit K={k}")
    if ci_idx.shape[0] != n_co:
        raise ValueError(f"sparse plan was built for {ci_idx.shape[0]} C_out "
                         f"tiles but t_co={t_co} yields {n_co}; rebuild the "
                         "plan with the same channel tiles")


def schedule_weight_mask(ci_idx: torch.Tensor, valid: torch.Tensor,
                         tap_mask: torch.Tensor, k: int, cip: int, cop: int,
                         t_ci: int, t_co: int) -> torch.Tensor:
    """(K, K, CIp, COp) bool: the weights the schedule keeps, those of the
    listed (valid) slabs at the taps whose bit is set."""
    n_co, length = ci_idx.shape
    dev = ci_idx.device
    live = ((tap_mask != 0) & (valid != 0)[..., None]).reshape(-1, k * k)
    slab = torch.zeros((cip // t_ci, n_co, k * k), dtype=torch.int32,
                       device=dev)
    co_idx = torch.arange(n_co, device=dev).repeat_interleave(length)
    slab.index_put_((ci_idx.reshape(-1).long(), co_idx), live.int(),
                    accumulate=True)
    keep = (slab > 0).permute(2, 0, 1).reshape(k, k, cip // t_ci, n_co)
    return keep.repeat_interleave(t_ci, 2).repeat_interleave(t_co, 3)


def deconv2d_sparse_launch_plain(
    xp: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
    ci_idx: torch.Tensor, valid: torch.Tensor, tap_mask: torch.Tensor, *,
    plan: PhasePlan, ih: int, iw: int, ohp: int, owp: int, t_oh: int,
    t_ow: int, t_ci: int, t_co: int, t_n: int, activation: Optional[str],
) -> torch.Tensor:
    """The zero-skip kernel's function in plain torch, on its launch
    arguments: the dense plain version on the scheduled weights."""
    k, _, cip, cop = wp.shape
    _check_schedule(ci_idx, valid, tap_mask, k, cop, t_co)
    _check_shapes(tuple(xp.shape), tuple(wp.shape), plan, ih, iw, ohp, owp,
                  t_oh, t_ow, t_ci, t_co, t_n)
    keep = schedule_weight_mask(ci_idx, valid, tap_mask, k, cip, cop, t_ci,
                                t_co)
    return deconv2d_launch_plain(
        xp, wp * keep.to(wp.dtype), bp, plan=plan, ih=ih, iw=iw, ohp=ohp,
        owp=owp, t_oh=t_oh, t_ow=t_ow, t_ci=t_ci, t_co=t_co, t_n=t_n,
        activation=activation)


def deconv2d_sparse_launch(
    xp: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
    ci_idx: torch.Tensor, valid: torch.Tensor, tap_mask: torch.Tensor, *,
    plan: PhasePlan, ih: int, iw: int, ohp: int, owp: int, t_oh: int,
    t_ow: int, t_ci: int, t_co: int, t_n: int, activation: Optional[str],
) -> torch.Tensor:
    """One zero-skip kernel launch on a CUDA tensor; the plain version on a
    CPU one.  ``ci_idx``/``valid``/``tap_mask`` are int32 tensors on x's
    device, built at this ``t_ci``/``t_co``."""
    global LAUNCHES
    kw = dict(plan=plan, ih=ih, iw=iw, ohp=ohp, owp=owp, t_oh=t_oh, t_ow=t_ow,
              t_ci=t_ci, t_co=t_co, t_n=t_n, activation=activation)
    if xp.device.type == "cpu":
        return deconv2d_sparse_launch_plain(xp, wp, bp, ci_idx, valid,
                                            tap_mask, **kw)
    if xp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"deconv2d zero-skip kernel takes float32 or "
                        f"bfloat16, got {xp.dtype}")
    _check_schedule(ci_idx, valid, tap_mask, wp.shape[0], wp.shape[3], t_co)
    for name, t in (("ci_idx", ci_idx), ("valid", valid),
                    ("tap_mask", tap_mask)):
        if t.device != xp.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{xp.device}; got {t.dtype} on {t.device}")
    params = launch_params(xp, wp, [("b", bp, xp.dtype)], **kw)
    y = torch.empty((xp.shape[0], ohp, owp, wp.shape[3]), dtype=xp.dtype,
                    device=xp.device)
    with torch.cuda.device(xp.device):
        rc = library().deconv2d_sparse_forward(
            xp.data_ptr(), wp.data_ptr(), bp.data_ptr(), y.data_ptr(),
            ci_idx.data_ptr(), valid.data_ptr(), tap_mask.data_ptr(),
            ci_idx.shape[1],
            params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            torch.cuda.current_stream().cuda_stream)
    check_rc("deconv2d zero-skip", rc)
    LAUNCHES += 1
    return y
