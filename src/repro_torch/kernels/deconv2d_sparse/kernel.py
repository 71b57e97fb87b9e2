"""Launcher, plain version and schedule of the zero-skip deconv kernel.

The counterpart of the JAX package's ``_sparse_kernel``.  Inference
weights are static, so after magnitude pruning the host lists, per C_out
tile, the C_in slabs (``t_ci`` input channels by ``t_co`` output channels
of one tap) that hold any nonzero (`build_schedule`, the reference's
``(ci_idx, valid, tap_mask)`` tables).  Once per plan those tables are
packed for the device (`pack_schedule`, `schedule_tensors`): per CO tile
the count of listed slabs, their CI tiles in order, and each slab's tap
bits in ``ceil(K*K/32)`` words.  The kernel (fp32 and bf16:
``deconv2d_tc_sparse_forward`` in ``csrc/deconv2d_tc.cu``) is the dense kernel
with its CI loop walking only the listed slabs and each tap's products
skipped where the slab's tap bit is 0.  Skipping an all-zero slab changes
no sum, so the result is the dense result on the pruned weights.

* On a CUDA tensor `deconv2d_sparse_launch` launches the kernel or raises.
  The packed schedule must already be on the card (`schedule_tensors`),
  so a serving engine copies it once per plan.
* On a CPU tensor it runs `deconv2d_sparse_launch_plain`: the dense plain
  version on the weights the schedule keeps (zeroed elsewhere), so a
  schedule that drops a nonzero slab changes its result as it changes
  the kernel's.

``LAUNCHES`` counts launches of the zero-skip kernel; ``WGMMA_LAUNCHES``
those on its wgmma path (bf16 alone: fp32 zero-skip stays on mma.sync).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ...core.counting import is_fake
from ...core.offsets import PhasePlan
from ..deconv2d.kernel import (_check_shapes, aligned, check_rc,
                               deconv2d_launch_plain, launch_params,
                               takes_wgmma, tc_library)

LAUNCHES = 0
WGMMA_LAUNCHES = 0


class Schedule(NamedTuple):
    """The packed zero-skip schedule: int32 ``count (n_co,)``, ``ci (n_co,
    L)`` (the first count[t] entries of row t are listed) and ``bits
    (n_co, L, ceil(K*K/32))`` (bit ``kh*K + kw`` of the flat tap index,
    word by word)."""

    count: torch.Tensor
    ci: torch.Tensor
    bits: torch.Tensor


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


def pack_schedule(ci_idx, valid, tap_mask):
    """The reference's ``(ci_idx, valid, tap_mask)`` tables as the packed
    ``(count, ci, bits)`` int32 arrays: per CO tile the valid entries'
    CI tiles compacted in order, and each entry's K*K tap bits in 32-bit
    words."""
    ci_idx, valid, tap_mask = (np.asarray(a) for a in (ci_idx, valid,
                                                          tap_mask))
    n_co, length, taps = tap_mask.shape
    nbw = -(-taps // 32)
    count = np.zeros((n_co,), np.int32)
    ci = np.zeros((n_co, length), np.int32)
    bits = np.zeros((n_co, length, nbw), np.uint32)
    weights = np.uint32(1) << (np.arange(32, dtype=np.uint32))
    for t in range(n_co):
        keep = np.flatnonzero(valid[t])
        count[t] = len(keep)
        ci[t, :len(keep)] = ci_idx[t, keep]
        on = np.pad(tap_mask[t, keep] != 0, ((0, 0), (0, nbw * 32 - taps)))
        bits[t, :len(keep)] = (on.reshape(len(keep), nbw, 32)
                               * weights).sum(-1, dtype=np.uint32)
    return count, ci, bits.view(np.int32)


def unpack_schedule(count, ci, bits, k: int):
    """The ``(ci_idx, valid, tap_mask)`` tables a packed schedule lists
    (tensors on the schedule's device): entry l < count[t] of CO tile t is
    valid with its CI tile and tap bits; the rest are padding (CI tile 0,
    not valid)."""
    count, ci, bits = (torch.as_tensor(a) for a in (count, ci, bits))
    n_co, length = ci.shape
    valid = (torch.arange(length, device=ci.device)[None, :]
             < count[:, None]).to(torch.int32)
    shifts = torch.arange(32, device=ci.device, dtype=torch.int64)
    words = bits.to(torch.int64) & 0xFFFFFFFF
    on = (words[..., None] >> shifts) & 1
    tap_mask = on.reshape(n_co, length, -1)[..., :k * k].to(torch.int32)
    return ci * valid, valid, tap_mask * valid[..., None]


def schedule_tensors(tables: Sequence, device) -> Schedule:
    """The schedule on ``device``, packed: ``tables`` is the reference's
    ``(ci_idx, valid, tap_mask)`` (numpy or tensors), or a `Schedule`,
    which is moved (and not copied where it is already there)."""
    if not isinstance(tables, Schedule):
        tables = pack_schedule(*(t.cpu().numpy() if isinstance(t, torch.Tensor)
                                 else t for t in tables))
    return Schedule(*(torch.as_tensor(a).to(device=device, dtype=torch.int32)
                      .contiguous() for a in tables))


def _check_schedule(count, ci, bits, k: int, cop: int, t_co: int) -> None:
    n_co = cop // t_co
    if ci.ndim != 2 or tuple(count.shape) != (ci.shape[0],) or \
            tuple(bits.shape) != (*ci.shape, -(-k * k // 32)):
        raise ValueError(f"schedule shapes count {tuple(count.shape)}, ci "
                         f"{tuple(ci.shape)}, bits {tuple(bits.shape)} do not "
                         f"fit K={k}")
    if ci.shape[0] != n_co:
        raise ValueError(f"sparse plan was built for {ci.shape[0]} C_out "
                         f"tiles but t_co={t_co} yields {n_co}; rebuild the "
                         "plan with the same channel tiles")


def schedule_weight_mask(count: torch.Tensor, ci: torch.Tensor,
                         bits: torch.Tensor, k: int, cip: int, cop: int,
                         t_ci: int, t_co: int) -> torch.Tensor:
    """(K, K, CIp, COp) bool: the weights the schedule keeps, those of the
    listed slabs at the taps whose bit is set."""
    ci_idx, valid, tap_mask = unpack_schedule(count, ci, bits, k)
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
    count: torch.Tensor, ci: torch.Tensor, bits: torch.Tensor, *,
    plan: PhasePlan, ih: int, iw: int, ohp: int, owp: int, t_oh: int,
    t_ow: int, t_ci: int, t_co: int, t_n: int, activation: Optional[str],
    split: int = 1,
) -> torch.Tensor:
    """The zero-skip kernel's function in plain torch, on its launch
    arguments (the packed schedule): the dense plain version on the
    scheduled weights, its sum split over ``split`` ranges of CI chunks
    (the kernel's cluster ranks take ranges of the listed entries: the
    same ranges where the schedule lists every chunk)."""
    k, _, cip, cop = wp.shape
    _check_schedule(count, ci, bits, k, cop, t_co)
    _check_shapes(tuple(xp.shape), tuple(wp.shape), plan, ih, iw, ohp, owp,
                  t_oh, t_ow, t_ci, t_co, t_n)
    keep = schedule_weight_mask(count, ci, bits, k, cip, cop, t_ci, t_co)
    return deconv2d_launch_plain(
        xp, wp * keep.to(wp.dtype), bp, plan=plan, ih=ih, iw=iw, ohp=ohp,
        owp=owp, t_oh=t_oh, t_ow=t_ow, t_ci=t_ci, t_co=t_co, t_n=t_n,
        activation=activation, split=split)


def deconv2d_sparse_launch(
    xp: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
    count: torch.Tensor, ci: torch.Tensor, bits: torch.Tensor, *,
    plan: PhasePlan, ih: int, iw: int, ohp: int, owp: int, t_oh: int,
    t_ow: int, t_ci: int, t_co: int, t_n: int, activation: Optional[str],
) -> torch.Tensor:
    """One zero-skip kernel launch on a CUDA tensor; the plain version on a
    CPU one.  ``count``/``ci``/``bits`` are the packed schedule
    (`schedule_tensors`), int32 tensors on x's device built at this
    ``t_ci``/``t_co``."""
    global LAUNCHES, WGMMA_LAUNCHES
    kw = dict(plan=plan, ih=ih, iw=iw, ohp=ohp, owp=owp, t_oh=t_oh, t_ow=t_ow,
              t_ci=t_ci, t_co=t_co, t_n=t_n, activation=activation)
    if is_fake(xp):     # a cost count: the output's shape and dtype alone
        return xp.new_empty((xp.shape[0], ohp, owp, wp.shape[3]))
    if xp.device.type == "cpu":
        return deconv2d_sparse_launch_plain(xp, wp, bp, count, ci, bits, **kw)
    if xp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"deconv2d zero-skip kernel takes float32 or "
                        f"bfloat16, got {xp.dtype}")
    _check_schedule(count, ci, bits, wp.shape[0], wp.shape[3], t_co)
    for name, t in (("count", count), ("ci", ci), ("bits", bits)):
        if t.device != xp.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{xp.device}; got {t.dtype} on {t.device}")
    xp, wp = aligned(xp), aligned(wp)
    params = launch_params(xp, wp, [("b", bp, xp.dtype)], sparse=True, **kw)
    y = torch.empty((xp.shape[0], ohp, owp, wp.shape[3]), dtype=xp.dtype,
                    device=xp.device)
    args = (xp.data_ptr(), wp.data_ptr(), bp.data_ptr(), y.data_ptr(),
            count.data_ptr(), ci.data_ptr(), bits.data_ptr(), ci.shape[1],
            bits.shape[2], params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = tc_library().deconv2d_tc_sparse_forward(*args, stream)
    check_rc("deconv2d zero-skip", rc)
    LAUNCHES += 1
    WGMMA_LAUNCHES += takes_wgmma(params)
    return y
