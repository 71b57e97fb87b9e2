"""Launcher and plain version of the Hopper reverse-loop deconv kernel.

``deconv2d_launch`` takes what the TPU kernel's ``deconv2d_pallas_call``
took: the host-padded input ``(N, IHp, IWp, CIp)``, weights ``(K, K, CIp,
COp)``, bias ``(1, COp)``, the layer's `PhasePlan`, the padded output grid
and the tiles, plus the unpadded input extent ``(ih, iw)`` (the kernel
skips taps that read only host padding).  It returns the padded output
``(N, OHp, OWp, COp)`` in x's dtype.

* On a CUDA tensor it launches ``csrc/deconv2d.cu`` (built at first use) on
  the current stream, or raises: on a failed build, a refused launch, or an
  input the kernel does not take.  There is no fallback.
* On a CPU tensor it runs ``deconv2d_launch_plain``, the same function in
  plain torch (vectorised over the whole padded arrays, not a tile loop).

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ...core.deconv import fp32_exact, phase_products
from ...core.offsets import PhasePlan, make_phase_plan
from ...core.tiling import (KERNEL_MAX_SMEM, KERNEL_MAX_STRIDE,
                            KERNEL_MAX_TAPS, KERNEL_MAX_THREADS,
                            DeconvGeometry, halo_tile, kernel_smem_bytes,
                            launch_threads, register_tile)

ACTIVATIONS = (None, "none", "relu", "tanh")
_ACT_CODE = {None: 0, "none": 0, "relu": 1, "tanh": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# In step with `enum Param` in csrc/deconv2d.cu; the tap table follows.
_PARAM_FIELDS = ("n", "ihp", "iwp", "cip", "k", "cop", "ohp", "owp", "s",
                 "t_n", "t_oh", "t_ow", "t_ci", "t_co", "t_ih", "t_iw",
                 "base_h", "base_w", "act", "rp", "rc", "dtype", "ih", "iw",
                 "pad_l", "threads")
_ARG_ERRORS = {
    -1: "arguments the kernel does not take (geometry, tiles or padding)",
    -2: f"more than {KERNEL_MAX_THREADS} threads per block at these tiles",
    -3: "more shared memory than a block can have at these tiles",
    -4: "no kernel instance for this register tile",
}

LAUNCHES = 0


def apply_activation(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """Epilogue nonlinearity on the f32 accumulator (shared with refs)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation!r}; "
                         f"expected one of {ACTIVATIONS}")
    if activation == "relu":
        return torch.relu(y)
    if activation == "tanh":
        return torch.tanh(y)
    return y


def deconv2d_launch_plain(
    xp: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, *,
    plan: PhasePlan, ih: int, iw: int, ohp: int, owp: int, t_oh: int,
    t_ow: int, t_ci: int, t_co: int, t_n: int, activation: Optional[str],
) -> torch.Tensor:
    """The kernel's function in plain torch, on the launcher's arguments.

    Output phase-row ``t`` of the padded grid reads input row
    ``t + left_halo + delta`` for each tap: exactly the rows the kernel's
    halo window ``j*step + base + local`` reaches.  The tiles only order the
    kernel's sums, so they do not enter here beyond the checks."""
    _check_shapes(tuple(xp.shape), tuple(wp.shape), plan, ih, iw, ohp, owp,
                  t_oh, t_ow, t_ci, t_co, t_n)
    fp32_exact(xp.device)
    s = plan.stride
    y = phase_products(xp, wp, plan, ohp // s, owp // s, bp.reshape(-1))
    return apply_activation(y, activation).to(xp.dtype)


def _check_shapes(x_shape, w_shape, plan, ih, iw, ohp, owp, t_oh, t_ow, t_ci,
                  t_co, t_n) -> None:
    n, ihp, iwp, cip = x_shape
    k, _, wci, cop = w_shape
    s = plan.stride
    if wci != cip or k != plan.kernel_size:
        raise ValueError(f"w{tuple(w_shape)} does not match x{tuple(x_shape)}"
                         f" / kernel {plan.kernel_size}")
    if not (1 <= ih and plan.left_halo + ih <= ihp
            and 1 <= iw and plan.left_halo + iw <= iwp):
        raise ValueError(f"input extent ({ih}, {iw}) does not fit x"
                         f"{tuple(x_shape)} after {plan.left_halo} halo rows")
    if t_oh % s or t_ow % s:
        raise ValueError(f"tiles ({t_oh}, {t_ow}) are not stride-aligned")
    if cip % t_ci or cop % t_co or n % t_n or ohp % t_oh or owp % t_ow:
        raise ValueError("padded extents must be tile multiples")
    ht_h = halo_tile(t_oh, k, s, plan.padding)
    ht_w = halo_tile(t_ow, k, s, plan.padding)
    if ihp < ht_h.min_padded_extent(ohp // t_oh) or \
            iwp < ht_w.min_padded_extent(owp // t_ow):
        raise ValueError("input under-padded for its halo windows")


def _tap_words(plan: PhasePlan) -> list:
    s = plan.stride
    counts = [0] * KERNEL_MAX_STRIDE
    ks = [0] * (KERNEL_MAX_STRIDE * KERNEL_MAX_TAPS)
    local = [0] * (KERNEL_MAX_STRIDE * KERNEL_MAX_TAPS)
    for ph in range(s):
        taps = plan.taps[ph]
        if len(taps) > KERNEL_MAX_TAPS:
            raise ValueError(f"{len(taps)} taps per phase; the kernel takes "
                             f"at most {KERNEL_MAX_TAPS}")
        counts[ph] = len(taps)
        for a, (k, d) in enumerate(taps):
            ks[ph * KERNEL_MAX_TAPS + a] = k
            local[ph * KERNEL_MAX_TAPS + a] = d - plan.delta_min
    return counts + ks + local


def deconv2d_launch(
    xp: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, *,
    plan: PhasePlan, ih: int, iw: int, ohp: int, owp: int, t_oh: int,
    t_ow: int, t_ci: int, t_co: int, t_n: int, activation: Optional[str],
) -> torch.Tensor:
    """One kernel launch on a CUDA tensor; the plain version on a CPU one."""
    kw = dict(plan=plan, ih=ih, iw=iw, ohp=ohp, owp=owp, t_oh=t_oh, t_ow=t_ow,
              t_ci=t_ci, t_co=t_co, t_n=t_n, activation=activation)
    if xp.device.type == "cpu":
        return deconv2d_launch_plain(xp, wp, bp, **kw)
    return _launch_cuda(xp, wp, bp, **kw)


def _launch_cuda(xp, wp, bp, *, plan, ih, iw, ohp, owp, t_oh, t_ow, t_ci, t_co,
                 t_n, activation):
    global LAUNCHES
    if xp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"deconv2d kernel takes float32 or bfloat16, got "
                        f"{xp.dtype}")
    params = launch_params(xp, wp, [("b", bp, xp.dtype)], plan=plan, ih=ih,
                           iw=iw, ohp=ohp, owp=owp, t_oh=t_oh, t_ow=t_ow,
                           t_ci=t_ci, t_co=t_co, t_n=t_n,
                           activation=activation)
    y = torch.empty((xp.shape[0], ohp, owp, wp.shape[3]), dtype=xp.dtype,
                    device=xp.device)
    with torch.cuda.device(xp.device):
        rc = library().deconv2d_forward(
            xp.data_ptr(), wp.data_ptr(), bp.data_ptr(), y.data_ptr(),
            params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            torch.cuda.current_stream().cuda_stream)
    check_rc("deconv2d", rc)
    LAUNCHES += 1
    return y


def launch_params(xp, wp, others, *, plan, ih, iw, ohp, owp, t_oh, t_ow, t_ci,
                  t_co, t_n, activation) -> np.ndarray:
    """Check one launch's tensors and return its int32 parameter array.

    ``others`` lists ``(name, tensor, dtype)`` of the per-channel vectors
    (bias, scale) that must hold one value per padded output channel.
    Shared by the three kernels of ``csrc/deconv2d.cu``."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation!r}")
    if xp.device.type != "cuda":
        raise ValueError(f"deconv2d kernels: no kernel for device {xp.device}")
    if wp.device != xp.device or wp.dtype != xp.dtype:
        raise ValueError(f"w is {wp.dtype} on {wp.device}; x is {xp.dtype} "
                         f"on {xp.device}")
    if not (xp.is_contiguous() and wp.is_contiguous()):
        raise ValueError("deconv2d kernels take contiguous tensors")
    for name, t, dtype in others:
        if t.device != xp.device or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the kernel "
                             f"takes {dtype} on {xp.device}")
        if not t.is_contiguous() or t.numel() != wp.shape[3]:
            raise ValueError(f"{name} has {t.numel()} values for "
                             f"{wp.shape[3]} output channels")
    return _launch_params(tuple(xp.shape), tuple(wp.shape), plan.kernel_size,
                          plan.stride, plan.padding, ih, iw, ohp, owp, t_oh,
                          t_ow, t_ci, t_co, t_n, _ACT_CODE[activation],
                          _DTYPE_CODE[xp.dtype])


def check_rc(name: str, rc: int) -> None:
    """Raise on a launch the C function refused or CUDA reported."""
    if rc != 0:
        why = _ARG_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{name} kernel launch failed: {why}")


@functools.lru_cache(maxsize=256)
def _launch_params(x_shape, w_shape, k, s, p, ih, iw, ohp, owp, t_oh, t_ow,
                   t_ci, t_co, t_n, act, dtype) -> np.ndarray:
    """The kernel's int32 parameter array for one launch shape, checked
    once per shape and tiles (a serving engine launches a handful of
    shapes over and over).  Read-only: every caller shares it."""
    plan = make_phase_plan(k, s, p)
    _check_shapes(x_shape, w_shape, plan, ih, iw, ohp, owp, t_oh, t_ow, t_ci,
                  t_co, t_n)
    n, ihp, iwp, cip = x_shape
    cop = w_shape[3]
    if s > KERNEL_MAX_STRIDE:
        raise ValueError(f"stride {s} > {KERNEL_MAX_STRIDE} is not supported")
    ht_h = halo_tile(t_oh, k, s, p)
    ht_w = halo_tile(t_ow, k, s, p)
    rp, rc = register_tile(t_co)
    fields = dict(n=n, ihp=ihp, iwp=iwp, cip=cip, k=k, cop=cop, ohp=ohp,
                  owp=owp, s=s, t_n=t_n, t_oh=t_oh, t_ow=t_ow, t_ci=t_ci,
                  t_co=t_co, t_ih=ht_h.extent, t_iw=ht_w.extent,
                  base_h=ht_h.base, base_w=ht_w.base, act=act, rp=rp, rc=rc,
                  dtype=dtype, ih=ih, iw=iw, pad_l=plan.left_halo,
                  threads=launch_threads(s, t_oh, t_ow, t_co, t_n))
    params = np.array([fields[f] for f in _PARAM_FIELDS] + _tap_words(plan),
                      dtype=np.int32)
    want = kernel_smem_bytes(DeconvGeometry(1, 1, cip, cop, k, s, p), t_oh,
                             t_ow, t_ci, t_co, t_n)
    got = library().deconv2d_smem_bytes(
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if got != want:
        raise RuntimeError(f"deconv2d kernel: shared-memory model says {want}"
                           f" bytes, the kernel {got}")
    params.flags.writeable = False
    return params


_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The library of ``csrc/deconv2d.cu`` (the dense, int8 and zero-skip
    kernels), built at first use; its launch limits are checked against
    ``core.tiling``'s."""
    global _lib
    if _lib is None:
        from .._build import load

        lib = load("deconv2d")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        params = ctypes.POINTER(ctypes.c_int)
        lib.deconv2d_forward.argtypes = [ptr, ptr, ptr, ptr, params, ptr]
        lib.deconv2d_int8_forward.argtypes = [ptr, ptr, ptr, ptr, ptr, params,
                                              f32, i32, ptr]
        lib.deconv2d_sparse_forward.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                                ptr, i32, params, ptr]
        for fn in (lib.deconv2d_forward, lib.deconv2d_int8_forward,
                   lib.deconv2d_sparse_forward):
            fn.restype = ctypes.c_int
        lib.deconv2d_smem_bytes.argtypes = [params]
        lib.deconv2d_smem_bytes.restype = ctypes.c_longlong
        lib.deconv2d_limits.argtypes = [params]
        lib.deconv2d_limits.restype = None
        got = (ctypes.c_int * 4)()
        lib.deconv2d_limits(got)
        want = (KERNEL_MAX_STRIDE, KERNEL_MAX_TAPS, KERNEL_MAX_THREADS,
                KERNEL_MAX_SMEM)
        if tuple(got) != want:
            raise RuntimeError(f"deconv2d kernel: its launch limits {tuple(got)}"
                               f" are not core.tiling's {want}")
        _lib = lib
    return _lib


def build() -> None:
    """Build and load the kernel library now (``chip_smoke.py`` times it)."""
    library()
