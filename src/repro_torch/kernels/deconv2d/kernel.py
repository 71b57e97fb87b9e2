"""Launcher and plain version of the Hopper reverse-loop deconv kernels.

``deconv2d_launch`` takes what the TPU kernel's ``deconv2d_pallas_call``
took: the host-padded input ``(N, IHp, IWp, CIp)``, weights ``(K, K, CIp,
COp)``, bias ``(1, COp)``, the layer's `PhasePlan`, the padded output grid
and the tiles, plus the unpadded input extent ``(ih, iw)`` (the kernels
skip taps that read only host padding).  It returns the padded output
``(N, OHp, OWp, COp)`` in x's dtype.

* On a CUDA tensor it launches, on the current stream, the fp32 or the
  bf16 tensor-core kernel of ``csrc/deconv2d_tc.cu`` (built at first use),
  or raises: on a failed build, a refused launch, or an input the kernel
  does not take.  There is no fallback.  Where the grid would not fill the
  card, the kernel splits the CI chunks over the blocks of a cluster
  (`autotune.ci_split`).  The int8 kernel of the same library has its own
  launcher (`int8.py`) and shares the parameter checks here.
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
from ...core.tiling import (CI_STEP, KERNEL_MAX_SMEM, KERNEL_MAX_STRIDE,
                            KERNEL_MAX_TAPS, KERNEL_MAX_THREADS, halo_tile,
                            launch_threads, tc_smem_layout)
from ..autotune import MAX_SPLIT, ci_split

ACTIVATIONS = (None, "none", "relu", "tanh")
_ACT_CODE = {None: 0, "none": 0, "relu": 1, "tanh": 2}
# In step with `enum Dtype` in csrc/deconv2d_tc.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# per dtype code: its name, its kernel's, and the channels the kernel's CI
# chunks are a multiple of (`core.tiling.CI_STEP`)
_KERNEL_OF_CODE = {code: (name, short, CI_STEP[name]) for code, name, short
                   in ((0, "float32", "fp32"), (1, "bfloat16", "bf16"),
                       (2, "int8", "int8"))}
# In step with `enum Param` in csrc/deconv2d_tc.cu; the tap table follows.
_TC_PARAM_FIELDS = ("n", "ihp", "iwp", "cip", "k", "cop", "ohp", "owp", "s",
                    "t_n", "t_oh", "t_ow", "t_ci", "t_co", "t_ih", "t_iw",
                    "base_h", "base_w", "act", "ih", "iw", "pad_l", "threads",
                    "split", "dtype")
_ARG_ERRORS = {
    -1: "arguments the kernel does not take (geometry, tiles or padding)",
    -2: f"more than {KERNEL_MAX_THREADS} threads per block at these tiles",
    -3: "more shared memory than a block can have at these tiles",
    -4: "no kernel instance for this register tile",
    -5: "x or w is not 16-byte aligned",
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
    split: int = 1,
) -> torch.Tensor:
    """The kernel's function in plain torch, on the launcher's arguments.

    Output phase-row ``t`` of the padded grid reads input row
    ``t + left_halo + delta`` for each tap: exactly the rows the kernel's
    halo window ``j*step + base + local`` reaches.  The tiles only order the
    kernel's sums, so they do not enter here beyond the checks.  With
    ``split`` > 1 the sum is taken as the fp32 kernel's cluster takes it:
    rank r's partial over the r-th contiguous range of the CI chunks, the
    partials added in rank order, then the bias (the tensor-core kernels'
    cluster, fp32 and bf16 alike)."""
    _check_shapes(tuple(xp.shape), tuple(wp.shape), plan, ih, iw, ohp, owp,
                  t_oh, t_ow, t_ci, t_co, t_n)
    fp32_exact(xp.device)
    s = plan.stride
    n_ci = xp.shape[3] // t_ci
    if not 1 <= split <= n_ci:
        raise ValueError(f"split {split} over {n_ci} CI chunks")
    if split == 1:
        y = phase_products(xp, wp, plan, ohp // s, owp // s, bp.reshape(-1))
    else:
        zero = torch.zeros_like(bp.reshape(-1))
        y = None
        for r in range(split):
            c0, c1 = (r * n_ci // split) * t_ci, ((r + 1) * n_ci // split) * t_ci
            part = phase_products(xp[..., c0:c1], wp[:, :, c0:c1], plan,
                                  ohp // s, owp // s, zero)
            y = part if y is None else y + part
        y = y + bp.reshape(-1).float()
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


def launch_split(n: int, cip: int, cop: int, ohp: int, owp: int, t_oh: int,
                 t_ow: int, t_ci: int, t_co: int, t_n: int) -> int:
    """Blocks of a cluster that share one output tile's CI chunks in a
    tensor-core kernel's launch (fp32 or int8) at these padded extents and
    tiles."""
    blocks = (n // t_n) * (ohp // t_oh) * (owp // t_ow) * (cop // t_co)
    return ci_split(blocks, cip // t_ci)


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
    xp, wp = aligned(xp), aligned(wp)
    params = launch_params(xp, wp, [("b", bp, xp.dtype)], plan=plan, ih=ih,
                           iw=iw, ohp=ohp, owp=owp, t_oh=t_oh, t_ow=t_ow,
                           t_ci=t_ci, t_co=t_co, t_n=t_n,
                           activation=activation)
    y = torch.empty((xp.shape[0], ohp, owp, wp.shape[3]), dtype=xp.dtype,
                    device=xp.device)
    args = (xp.data_ptr(), wp.data_ptr(), bp.data_ptr(), y.data_ptr(),
            params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = tc_library().deconv2d_tc_forward(*args, stream)
    check_rc("deconv2d", rc)
    LAUNCHES += 1
    return y


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    kernels stage whole 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_params(xp, wp, others, *, plan, ih, iw, ohp, owp, t_oh, t_ow, t_ci,
                  t_co, t_n, activation, w_shape=None) -> np.ndarray:
    """Check one launch's tensors and return its int32 parameter array, for
    the tensor-core kernel of x's dtype.

    ``others`` lists ``(name, tensor, dtype)`` of the per-channel vectors
    (bias, scale) that must hold one value per padded output channel.
    ``w_shape`` is the weight's shape in the reference layout ``(K, K,
    CIp, COp)`` where ``wp`` is laid out otherwise (the int8 kernel's
    packed weight).  Shared by every kernel of ``csrc/deconv2d_tc.cu``."""
    w_shape = tuple(wp.shape) if w_shape is None else tuple(w_shape)
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
        if not t.is_contiguous() or t.numel() != w_shape[3]:
            raise ValueError(f"{name} has {t.numel()} values for "
                             f"{w_shape[3]} output channels")
    return _tc_launch_params(
        tuple(xp.shape), w_shape, plan.kernel_size, plan.stride, plan.padding,
        ih, iw, ohp, owp, t_oh, t_ow, t_ci, t_co, t_n, _ACT_CODE[activation],
        _DTYPE_CODE[xp.dtype])


class LaunchRefused(RuntimeError):
    """The C function refused a launch's arguments: nothing was launched."""


def check_rc(name: str, rc: int) -> None:
    """Raise on a launch the C function refused (`LaunchRefused`) or CUDA
    reported (RuntimeError)."""
    if rc < 0:
        why = _ARG_ERRORS.get(rc, f"refusal {rc}")
        raise LaunchRefused(f"{name} kernel launch failed: {why}")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _common_fields(x_shape, w_shape, k, s, p, ih, iw, ohp, owp, t_oh, t_ow,
                   t_ci, t_co, t_n, act) -> dict:
    plan = make_phase_plan(k, s, p)
    _check_shapes(x_shape, w_shape, plan, ih, iw, ohp, owp, t_oh, t_ow, t_ci,
                  t_co, t_n)
    if s > KERNEL_MAX_STRIDE:
        raise ValueError(f"stride {s} > {KERNEL_MAX_STRIDE} is not supported")
    n, ihp, iwp, cip = x_shape
    ht_h = halo_tile(t_oh, k, s, p)
    ht_w = halo_tile(t_ow, k, s, p)
    return dict(n=n, ihp=ihp, iwp=iwp, cip=cip, k=k, cop=w_shape[3], ohp=ohp,
                owp=owp, s=s, t_n=t_n, t_oh=t_oh, t_ow=t_ow, t_ci=t_ci,
                t_co=t_co, t_ih=ht_h.extent, t_iw=ht_w.extent,
                base_h=ht_h.base, base_w=ht_w.base, act=act, ih=ih, iw=iw,
                pad_l=plan.left_halo)


@functools.lru_cache(maxsize=256)
def _tc_launch_params(x_shape, w_shape, k, s, p, ih, iw, ohp, owp, t_oh, t_ow,
                      t_ci, t_co, t_n, act, dtype) -> np.ndarray:
    """The int32 parameter array of the fp32, bf16 or int8 tensor-core
    kernel (``dtype``) for one launch shape (split included), checked once
    per shape and tiles (a serving engine launches a handful of shapes over
    and over).  Read-only: every caller shares it."""
    fields = _common_fields(x_shape, w_shape, k, s, p, ih, iw, ohp, owp, t_oh,
                            t_ow, t_ci, t_co, t_n, act)
    dtype_name, name, step = _KERNEL_OF_CODE[dtype]
    if t_ci % step:
        raise ValueError(f"t_ci={t_ci}: the {name} kernel takes CI chunks of "
                         f"a multiple of {step} channels")
    split = launch_split(x_shape[0], x_shape[3], w_shape[3], ohp, owp, t_oh,
                         t_ow, t_ci, t_co, t_n)
    fields.update(threads=launch_threads(s, t_oh, t_ow, t_co, t_n, "tc"),
                  split=split, dtype=dtype)
    params = np.array([fields[f] for f in _TC_PARAM_FIELDS]
                      + _tap_words(make_phase_plan(k, s, p)), dtype=np.int32)
    got = tc_library().deconv2d_tc_smem_bytes(
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    check_rc("deconv2d", min(got, 0))
    want = tc_smem_layout(ih, iw, k, s, p, ohp, owp, t_oh, t_ow, t_ci, t_co,
                          t_n, split, dtype_name)[1]
    if got != want:
        raise RuntimeError(f"deconv2d {name} kernel: shared-memory model "
                           f"says {want} bytes, the kernel {got}")
    params.flags.writeable = False
    return params


def launch_report(params: np.ndarray) -> dict:
    """What a launch with the parameter array ``params`` (from
    `launch_params`) takes on the card: ``smem_bytes`` as the library's
    ``deconv2d_tc_smem_bytes`` computes it, ``threads`` and ``split``."""
    got = tc_library().deconv2d_tc_smem_bytes(
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    check_rc("deconv2d", min(got, 0))
    return {"smem_bytes": int(got),
            "threads": int(params[_TC_PARAM_FIELDS.index("threads")]),
            "split": int(params[_TC_PARAM_FIELDS.index("split")])}


_lib: Optional[ctypes.CDLL] = None
_LIMITS = (KERNEL_MAX_STRIDE, KERNEL_MAX_TAPS, KERNEL_MAX_THREADS,
           KERNEL_MAX_SMEM, MAX_SPLIT)


def tc_library() -> ctypes.CDLL:
    """The library of ``csrc/deconv2d_tc.cu`` (the fp32 and bf16 dense and
    zero-skip kernels and the int8 kernel, on the tensor cores), built at
    first use; its launch limits are checked against ``core.tiling``'s and
    ``autotune``'s."""
    global _lib
    if _lib is None:
        from .._build import load

        lib = load("deconv2d_tc")
        lib.deconv2d_tc_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.deconv2d_tc_limits.restype = None
        got = (ctypes.c_int * len(_LIMITS))()
        lib.deconv2d_tc_limits(got)
        if tuple(got) != _LIMITS:
            raise RuntimeError(f"deconv2d_tc kernel: its launch limits "
                               f"{tuple(got)} are not core.tiling's and "
                               f"autotune's {_LIMITS}")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        params = ctypes.POINTER(ctypes.c_int)
        lib.deconv2d_tc_forward.argtypes = [ptr, ptr, ptr, ptr, params, ptr]
        lib.deconv2d_tc_sparse_forward.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                                   ptr, ptr, i32, i32, params,
                                                   ptr]
        lib.deconv2d_tc_int8_forward.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                                 params, f32, i32, ptr]
        for fn in (lib.deconv2d_tc_forward, lib.deconv2d_tc_sparse_forward,
                   lib.deconv2d_tc_int8_forward):
            fn.restype = ctypes.c_int
        lib.deconv2d_tc_smem_bytes.argtypes = [params]
        lib.deconv2d_tc_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def build() -> dict:
    """Build the kernel library now (``chip_smoke.py`` times it) and load
    it.  Returns the compiler's per-kernel resource report
    (`_build.ptxas_report`) per library."""
    from .._build import ptxas_report

    tc_library()
    return {"deconv2d_tc": ptxas_report("deconv2d_tc")}
