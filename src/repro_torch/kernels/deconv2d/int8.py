"""The int8 reverse-loop deconv kernel: weight packing, launcher, plain
version and op.

The quantized twin of `kernel.py`, and the counterpart of the JAX
package's ``_deconv2d_int8_kernel``: the same tiles and halo windows, int8
inputs and weights multiplied into an int32 accumulator that starts at 0,
and a fused requant epilogue (`requant_epilogue`): ``acc * scale[c] + b``
in f32, the activation, then either f32 out (the last layer) or int8 at
the next layer's input scale ``out_scale``.

* On a CUDA tensor `deconv2d_int8_launch` launches the int8 kernel of
  ``csrc/deconv2d_tc.cu`` (``deconv2d_tc_int8_forward``: s8 ``mma.sync``
  on the tensor cores, exact int32 sums, the CI chunks split over a
  cluster where the grid would not fill the card) or raises.
* On a CPU tensor it runs `deconv2d_int8_launch_plain`: the same sums in
  float64, exact for int8 products below 2**53, cast to int32, then the
  same epilogue.

The kernel's B operand wants four consecutive input channels per output
channel, so it takes the weight packed CI-minor, ``(K, K, COp, CIp)``, as
a `PackedInt8Weights` from `pack_int8_weights`.  A serving engine packs
each layer once (`quant.infer.pack_quantized_params`); the public
`deconv2d_int8` also takes the reference layout ``(K, K, CI, CO)`` and
packs per call.

``LAUNCHES`` counts launches of the int8 kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...core.counting import is_fake
from ...core.deconv import phase_products
from ...core.offsets import PhasePlan
from ...core.tiling import int8_acc_bound
from ...quant.qmath import quantize_symmetric
from ..autotune import INT8_T_CI, TC_T_CO
from .kernel import (_check_shapes, aligned, apply_activation, check_rc,
                     launch_params, launch_split, tc_library)
from .ops import (StaticOperands, call_args, pad_channels, refuse_graph,
                  report_launch, resolve_call)

LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class PackedInt8Weights:
    """An int8 weight packed for the kernel: ``data`` is ``(K, K, COp,
    CIp)`` int8, contiguous, zero past the real ``c_in`` / ``c_out``
    channels (int8 has no zero point, so the padding adds exactly 0)."""

    data: torch.Tensor
    c_in: int
    c_out: int

    @property
    def shape(self):
        """The reference shape ``(K, K, CI, CO)`` of the weight it packs."""
        return (self.kernel, self.kernel, self.c_in, self.c_out)

    @property
    def kernel(self) -> int:
        return self.data.shape[0]

    @property
    def cip(self) -> int:
        return self.data.shape[3]

    @property
    def cop(self) -> int:
        return self.data.shape[2]

    @property
    def device(self) -> torch.device:
        return self.data.device


def pack_int8_weights(w: torch.Tensor, cip: int, cop: int) -> PackedInt8Weights:
    """``w`` ``(K, K, CI, CO)`` int8 zero-padded to ``cip`` / ``cop``
    channels and laid out ``(K, K, COp, CIp)``: each (tap, output channel)
    row holds its input channels contiguously."""
    k, k2, ci, co = w.shape
    if w.dtype != torch.int8 or k != k2:
        raise ValueError(f"pack_int8_weights takes (K, K, CI, CO) int8, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if cip < ci or cop < co:
        raise ValueError(f"cannot pack {ci}x{co} channels into {cip}x{cop}")
    data = F.pad(w, (0, cop - co, 0, cip - ci)).permute(0, 1, 3, 2)
    return PackedInt8Weights(data.contiguous(), ci, co)


def _pack_to(c: int, chunks, align: int) -> int:
    """``c`` rounded up to a multiple of the largest of ``chunks`` (powers
    of two, each dividing the next) that a tile of ``c`` channels can take,
    at most ``c`` rounded up to ``align``: every smaller chunk divides it."""
    m = max(t for t in chunks if t <= -(-c // align) * align)
    return -(-c // m) * m


def packed_width(c: int) -> int:
    """The output channels a layer's weight is packed to once for every
    plan: ``c`` below 8 (a thin layer's t_co is C_out itself), else a
    multiple of the largest CO tile its tiles can take (`autotune.TC_T_CO`,
    at most ``c`` rounded up to 8): 32 for 24 channels, multiples of 128
    for the generators' layers."""
    return c if c < 8 else _pack_to(c, TC_T_CO, 8)


def packed_ci_width(c: int) -> int:
    """The input channels a layer's weight is packed to once for every
    plan: a multiple of the largest int8 CI chunk its tiles can take
    (`autotune.INT8_T_CI`, at most ``c`` rounded up to 32).  A thin layer
    (C_in = 1) packs to 32 channels; C_in = 100 and the wider layers to
    multiples of 128."""
    return _pack_to(c, INT8_T_CI, 32)


def unpack_int8_weights(pk: PackedInt8Weights) -> torch.Tensor:
    """The padded reference layout ``(K, K, CIp, COp)`` of a packed weight:
    a view (no copy), for the plain version."""
    return pk.data.permute(0, 1, 3, 2)


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


def check_acc_range(plan: PhasePlan, cip: int) -> None:
    """Refuse a layer whose int32 sums could overflow (`int8_acc_bound`)."""
    bound = int8_acc_bound(plan.kernel_size, plan.stride, plan.padding, cip)
    if bound >= 2 ** 31:
        raise ValueError(f"int8 deconv: taps x {cip} channels x 127^2 = "
                         f"{bound} does not fit the int32 accumulator")


def int8_acc_plain(xp: torch.Tensor, wp: torch.Tensor, plan: PhasePlan,
                   ohp: int, owp: int, t_ci: int,
                   split: int = 1) -> torch.Tensor:
    """The int32 sums of the int8 kernel, ``(N, OHp, OWp, COp)``, in plain
    torch: float64 products and sums (exact below 2**53) cast to int32.
    ``wp`` is the padded reference layout ``(K, K, CIp, COp)``.  With
    ``split`` > 1 they are taken as the kernel's cluster takes them: rank
    r's partial over the r-th contiguous range of the CI chunks, the
    partials added in rank order (integer sums: the same in any order)."""
    check_acc_range(plan, xp.shape[3])
    s = plan.stride
    n_ci = xp.shape[3] // t_ci
    if not 1 <= split <= n_ci:
        raise ValueError(f"split {split} over {n_ci} CI chunks")
    zero = torch.zeros((), dtype=torch.float64, device=xp.device)
    acc = None
    for r in range(split):
        c0, c1 = (r * n_ci // split) * t_ci, ((r + 1) * n_ci // split) * t_ci
        part = phase_products(xp[..., c0:c1], wp[:, :, c0:c1], plan, ohp // s,
                              owp // s, zero, dtype=torch.float64)
        part = part.to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def deconv2d_int8_launch_plain(
    xp: torch.Tensor, wp: torch.Tensor, sp: torch.Tensor, bp: torch.Tensor, *,
    plan: PhasePlan, ih: int, iw: int, ohp: int, owp: int, t_oh: int,
    t_ow: int, t_ci: int, t_co: int, t_n: int, activation: Optional[str],
    out_scale: Optional[float], split: int = 1,
) -> torch.Tensor:
    """The int8 kernel's function in plain torch, on its launch arguments
    with the weight in the padded reference layout ``(K, K, CIp, COp)``
    (`unpack_int8_weights` of the packed one): `int8_acc_plain` (at
    ``split``), then `requant_epilogue`."""
    _check_shapes(tuple(xp.shape), tuple(wp.shape), plan, ih, iw, ohp, owp,
                  t_oh, t_ow, t_ci, t_co, t_n)
    acc = int8_acc_plain(xp, wp, plan, ohp, owp, t_ci, split)
    return requant_epilogue(acc, sp.reshape(-1), bp.reshape(-1), activation,
                            out_scale)


def deconv2d_int8_launch(
    xp: torch.Tensor, wpk: PackedInt8Weights, sp: torch.Tensor,
    bp: torch.Tensor, *, plan: PhasePlan, ih: int, iw: int, ohp: int,
    owp: int, t_oh: int, t_ow: int, t_ci: int, t_co: int, t_n: int,
    activation: Optional[str], out_scale: Optional[float],
) -> torch.Tensor:
    """One int8 kernel launch on a CUDA tensor; the plain version on a CPU
    one.  x int8 ``(N, IHp, IWp, CIp)``; ``wpk`` the packed weight (CIp
    its channels); scale, bias f32 ``(1, COp)``; the output ``(N, OHp,
    OWp, COp)`` is int8, or f32 when ``out_scale`` is None.  Raises before
    the launch on an unpacked weight and on a layer whose sums could leave
    the int32 range; on the card also on CI chunks that are not a multiple
    of 32 and on tiles whose shared memory exceeds a block's."""
    global LAUNCHES
    if not isinstance(wpk, PackedInt8Weights):
        raise TypeError("the int8 kernel takes a PackedInt8Weights "
                        "(pack_int8_weights), not a raw weight tensor")
    kw = dict(plan=plan, ih=ih, iw=iw, ohp=ohp, owp=owp, t_oh=t_oh, t_ow=t_ow,
              t_ci=t_ci, t_co=t_co, t_n=t_n, activation=activation)
    out_dtype = torch.float32 if out_scale is None else torch.int8
    if is_fake(xp):     # a cost count: the output's shape and dtype alone
        return xp.new_empty((xp.shape[0], ohp, owp, wpk.cop),
                            dtype=out_dtype)
    if xp.device.type == "cpu":
        return deconv2d_int8_launch_plain(xp, unpack_int8_weights(wpk), sp,
                                          bp, out_scale=out_scale, **kw)
    if xp.dtype != torch.int8:
        raise TypeError(f"deconv2d int8 kernel takes int8, got {xp.dtype}")
    check_acc_range(plan, xp.shape[3])
    xp, wq = aligned(xp), aligned(wpk.data)
    params = launch_params(xp, wq, [("scale", sp, torch.float32),
                                    ("b", bp, torch.float32)],
                           w_shape=wpk.shape[:2] + (wpk.cip, wpk.cop), **kw)
    y = torch.empty((xp.shape[0], ohp, owp, wpk.cop), dtype=out_dtype,
                    device=xp.device)
    with torch.cuda.device(xp.device):
        rc = tc_library().deconv2d_tc_int8_forward(
            xp.data_ptr(), wq.data_ptr(), sp.data_ptr(), bp.data_ptr(),
            y.data_ptr(), params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            float(np.float32(out_scale if out_scale is not None else 1.0)),
            int(out_scale is not None),
            torch.cuda.current_stream().cuda_stream)
    check_rc("deconv2d int8", rc)
    LAUNCHES += 1
    return y


def launch_split_int8(xp: torch.Tensor, wpk: PackedInt8Weights, kw) -> int:
    """The cluster split of one int8 launch (``kw`` the launch kwargs)."""
    return launch_split(xp.shape[0], xp.shape[3], wpk.cop, kw["ohp"],
                        kw["owp"], kw["t_oh"], kw["t_ow"], kw["t_ci"],
                        kw["t_co"], kw["t_n"])


def prepare_int8_static(w, scale: torch.Tensor, b: Optional[torch.Tensor],
                        cip: int, cop: int) -> StaticOperands:
    """The static part of an int8 launch: ``w`` packed at ``cip`` /
    ``cop`` channels (kept as it is when already a `PackedInt8Weights`,
    whose channels then rule), the scale and the bias (None: zeros) in f32
    padded to its ``COp``, contiguous."""
    wpk = w if isinstance(w, PackedInt8Weights) else \
        pack_int8_weights(w, cip, cop)
    bp = (b if b is not None else torch.zeros((wpk.c_out,), device=wpk.device))
    bp = pad_channels(bp.to(torch.float32), wpk.cop).contiguous()
    sp = pad_channels(scale.to(torch.float32), wpk.cop).contiguous()
    return StaticOperands(w=wpk, b=bp, scale=sp)


def _int8_call(x, w, scale, b, static, stride, padding, t_oh, t_ow, t_ci,
               t_co, t_n, activation, out_scale):
    n, ih, iw, ci = x.shape
    k, _, wci, co = w.shape
    if wci != ci:
        raise ValueError(f"w has {wci} input channels, x {ci}")
    packed = static.w if static is not None else \
        (w if isinstance(w, PackedInt8Weights) else None)
    # x at a packed weight's channels, which every CI chunk its tiles can
    # take divides (`packed_ci_width`)
    cip = None if packed is None else packed.cip
    if cip is not None and cip % t_ci:
        raise ValueError(f"a weight packed at {cip} input channels does not "
                         f"split into CI chunks of {t_ci}")
    xp, kwargs, crop, (cip_t, cop_t) = call_args(
        x, k, co, stride, padding, t_oh, t_ow, t_ci, t_co, t_n, activation,
        cip=cip)
    if static is None:
        static = prepare_int8_static(w, scale, b, cip_t, cop_t)
    kwargs["out_scale"] = out_scale
    return xp, static, kwargs, crop


def launch_args_int8(x, w, scale, b, stride, padding, t_oh, t_ow, t_ci, t_co,
                     t_n, activation, out_scale):
    """The host padding of one int8 launch, as in the JAX package's
    ``_deconv2d_int8_jit``: ``(xp, wpk, sp, bp, kwargs, crop)`` where
    ``deconv2d_int8_launch(xp, wpk, sp, bp, **kwargs)[crop]`` is the
    layer's output.  ``w`` is the reference layout ``(K, K, CI, CO)``,
    packed here at the launch's padded channels, or a `PackedInt8Weights`
    (packed once), whose channels x is padded to.  int8 zero is real
    zero, so padding needs no offset."""
    xp, st, kwargs, crop = _int8_call(x, w, scale, b, None, stride, padding,
                                      t_oh, t_ow, t_ci, t_co, t_n, activation,
                                      out_scale)
    return xp, st.w, st.scale, st.b, kwargs, crop


def deconv2d_int8(
    x: torch.Tensor,
    w: Union[torch.Tensor, PackedInt8Weights],
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
    static: Optional[StaticOperands] = None,
) -> torch.Tensor:
    """Quantized transposed conv through the int8 kernel, on x's device.

    x: (N, IH, IW, CI) int8; w: (K, K, CI, CO) int8 (packed per call), or
    its `PackedInt8Weights` (packed once); scale: (CO,) f32, the combined
    ``x_scale * w_scale`` per output channel
    (`quant.calibrate.quantize_params`); b: (CO,) f32 or None.
    ``out_scale`` re-quantizes the activated output to int8 for the next
    layer; None emits f32.

    With ``plan`` (a `repro_torch.plan.DeconvPlan` of an int8 plan on
    backend "cuda"), tiles, activation and ``out_scale`` come from the
    plan.  Without one, ``stride`` and ``padding`` are required and the
    tiles left out come from `autotune.hopper_tiles` at this batch.
    ``static`` holds the packed weight, scale and bias already padded
    (`prepare_int8_static`; a serving engine's, once per layer); without
    it they are prepared here.  Raises when grad mode is on and an
    operand requires grad (`ops.refuse_graph`)."""
    refuse_graph("deconv2d_int8", x, w, scale, b)
    stride, padding, tiles, activation = resolve_call(
        plan, x, w, "cuda", "deconv2d_int8", stride, padding,
        activation, (t_oh, t_ow, t_ci, t_co, t_n))
    if plan is not None and out_scale is None:
        out_scale = plan.out_scale
    xp, st, kwargs, crop = _int8_call(x, w, scale, b, static, stride, padding,
                                      *tiles, activation, out_scale)
    y = deconv2d_int8_launch(xp, st.w, st.scale, st.b, **kwargs)
    report_launch("B2", x, w.shape, stride, padding,
                  (xp, st.w.data, st.scale, st.b), y)
    return y[crop]

