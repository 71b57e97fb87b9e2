"""The int8 reverse-loop deconv kernel: launcher, plain version and op.

The quantized twin of `kernel.py`, and the counterpart of the JAX
package's ``_deconv2d_int8_kernel``: the same tiles and halo windows, int8
inputs and weights multiplied into an int32 accumulator that starts at 0,
and a fused requant epilogue (`requant_epilogue`): ``acc * scale[c] + b``
in f32, the activation, then either f32 out (the last layer) or int8 at
the next layer's input scale ``out_scale``.

* On a CUDA tensor `deconv2d_int8_launch` launches the kernel of
  ``csrc/deconv2d.cu`` (``deconv2d_int8_forward``) or raises.
* On a CPU tensor it runs `deconv2d_int8_launch_plain`: the same sums in
  float64, exact for int8 products below 2**53, cast to int32, then the
  same epilogue.

``LAUNCHES`` counts launches of the int8 kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ...core.deconv import phase_products
from ...core.offsets import PhasePlan
from ...quant.qmath import quantize_symmetric
from .kernel import (_check_shapes, apply_activation, check_rc, launch_params,
                     library)
from .ops import launch_args, pad_channels, resolve_call

LAUNCHES = 0


def requant_epilogue(acc_i32: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, activation: Optional[str],
                     out_scale: Optional[float]) -> torch.Tensor:
    """The fused epilogue: ``acc * scale + bias`` as a separate f32 multiply
    and add, the activation, then int8 at ``out_scale`` through
    `quant.qmath.quantize_symmetric`, or f32 when ``out_scale`` is None.
    The kernel rounds each step the same way (``__fmul_rn``,
    ``__fadd_rn``, ``__fdiv_rn``, ``rintf``)."""
    y = acc_i32.float() * scale.float()
    y = y + bias.float()
    y = apply_activation(y, activation)
    if out_scale is None:
        return y
    return quantize_symmetric(y, out_scale)


def deconv2d_int8_launch_plain(
    xp: torch.Tensor, wp: torch.Tensor, sp: torch.Tensor, bp: torch.Tensor, *,
    plan: PhasePlan, ih: int, iw: int, ohp: int, owp: int, t_oh: int,
    t_ow: int, t_ci: int, t_co: int, t_n: int, activation: Optional[str],
    out_scale: Optional[float],
) -> torch.Tensor:
    """The int8 kernel's function in plain torch, on its launch arguments."""
    _check_shapes(tuple(xp.shape), tuple(wp.shape), plan, ih, iw, ohp, owp,
                  t_oh, t_ow, t_ci, t_co, t_n)
    s = plan.stride
    zero = torch.zeros((), dtype=torch.float64, device=xp.device)
    acc = phase_products(xp, wp, plan, ohp // s, owp // s, zero,
                         dtype=torch.float64).to(torch.int32)
    return requant_epilogue(acc, sp.reshape(-1), bp.reshape(-1), activation,
                            out_scale)


def deconv2d_int8_launch(
    xp: torch.Tensor, wp: torch.Tensor, sp: torch.Tensor, bp: torch.Tensor, *,
    plan: PhasePlan, ih: int, iw: int, ohp: int, owp: int, t_oh: int,
    t_ow: int, t_ci: int, t_co: int, t_n: int, activation: Optional[str],
    out_scale: Optional[float],
) -> torch.Tensor:
    """One int8 kernel launch on a CUDA tensor; the plain version on a CPU
    one.  x, w int8; scale, bias f32 ``(1, COp)``; the output is int8, or
    f32 when ``out_scale`` is None."""
    global LAUNCHES
    kw = dict(plan=plan, ih=ih, iw=iw, ohp=ohp, owp=owp, t_oh=t_oh, t_ow=t_ow,
              t_ci=t_ci, t_co=t_co, t_n=t_n, activation=activation)
    if xp.device.type == "cpu":
        return deconv2d_int8_launch_plain(xp, wp, sp, bp, out_scale=out_scale,
                                          **kw)
    if xp.dtype != torch.int8:
        raise TypeError(f"deconv2d int8 kernel takes int8, got {xp.dtype}")
    params = launch_params(xp, wp, [("scale", sp, torch.float32),
                                    ("b", bp, torch.float32)], **kw)
    out_dtype = torch.float32 if out_scale is None else torch.int8
    y = torch.empty((xp.shape[0], ohp, owp, wp.shape[3]), dtype=out_dtype,
                    device=xp.device)
    with torch.cuda.device(xp.device):
        rc = library().deconv2d_int8_forward(
            xp.data_ptr(), wp.data_ptr(), sp.data_ptr(), bp.data_ptr(),
            y.data_ptr(), params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            float(np.float32(out_scale if out_scale is not None else 1.0)),
            int(out_scale is not None),
            torch.cuda.current_stream().cuda_stream)
    check_rc("deconv2d int8", rc)
    LAUNCHES += 1
    return y


def launch_args_int8(x, w, scale, b, stride, padding, t_oh, t_ow, t_ci, t_co,
                     t_n, activation, out_scale):
    """The host padding of one int8 launch, as in the JAX package's
    ``_deconv2d_int8_jit``: ``(xp, wp, sp, bp, kwargs, crop)`` where
    ``deconv2d_int8_launch(xp, wp, sp, bp, **kwargs)[crop]`` is the
    layer's output.  int8 zero is real zero, so padding needs no offset."""
    xp, wp, bp, kwargs, crop = launch_args(
        x, w, b, stride, padding, t_oh, t_ow, t_ci, t_co, t_n, activation,
        bias_dtype=torch.float32)
    sp = pad_channels(scale.to(torch.float32), wp.shape[3]).contiguous()
    return xp, wp, sp, bp, {**kwargs, "out_scale": out_scale}, crop


def deconv2d_int8(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: Optional[int] = None,
    padding: Optional[int] = None,
    t_oh: Optional[int] = None,
    t_ow: Optional[int] = None,
    t_ci: Optional[int] = None,
    t_co: Optional[int] = None,
    t_n: Optional[int] = None,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    plan=None,
) -> torch.Tensor:
    """Quantized transposed conv through the int8 kernel, on x's device.

    x: (N, IH, IW, CI) int8; w: (K, K, CI, CO) int8; scale: (CO,) f32, the
    combined ``x_scale * w_scale`` per output channel
    (`quant.calibrate.quantize_params`); b: (CO,) f32 or None.
    ``out_scale`` re-quantizes the activated output to int8 for the next
    layer; None emits f32.

    With ``plan`` (a `repro_torch.plan.DeconvPlan` of an int8 plan on
    backend "cuda"), tiles, activation and ``out_scale`` come from the
    plan.  Without one, ``stride`` and ``padding`` are required and the
    tiles left out come from `autotune.hopper_tiles` at this batch."""
    stride, padding, tiles, activation = resolve_call(
        plan, x, w, "cuda", "deconv2d_int8", stride, padding, activation,
        (t_oh, t_ow, t_ci, t_co, t_n))
    if plan is not None and out_scale is None:
        out_scale = plan.out_scale
    xp, wp, sp, bp, kwargs, crop = launch_args_int8(
        x, w, scale, b, stride, padding, *tiles, activation, out_scale)
    return deconv2d_int8_launch(xp, wp, sp, bp, **kwargs)[crop]
