"""Public wrapper for the deconv2d kernel.

`deconv2d` takes a pre-built `plan.DeconvPlan` (geometry, tiles and fused
epilogue pinned at plan time), or ``stride``/``padding`` with tiles that
the caller gives or the Hopper heuristic fills.  Both paths pad on the
host exactly as the JAX package's ``_deconv2d_jit`` does, make one
`deconv2d_launch`, and slice the padding off again.  The launch runs the
CUDA kernel on a CUDA tensor and the plain version on a CPU tensor.

A launch's arguments come in two parts: the static part
(`prepare_static`: w padded to ``(K, K, CIp, COp)`` and the bias to
``(1, COp)``, contiguous; for a layer whose fp32 tiles take the wgmma
path, `with_ci_minor` adds w packed CI-minor), which a serving engine
prepares once per layer and channel tiles and passes as ``static=``, and
the per-call part (`call_args`: x padded).  Called without ``static``,
the op prepares both per call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ...core.offsets import make_phase_plan
from ...core.tiling import DeconvGeometry, fp32_wgmma_tile, out_size
from .kernel import aligned, deconv2d_launch, launch_split, pack_ci_minor


def check_layer_plan(plan, x: torch.Tensor, w: torch.Tensor, backend: str,
                     fn_name: str) -> None:
    """Fail loudly when a plan is executed against data it was not built
    for — the pinned-configuration contract."""
    n, ih, iw, ci = x.shape
    k, _, wci, co = w.shape
    g = plan.geometry
    if (ih, iw, ci, co, k) != (g.in_h, g.in_w, g.c_in, g.c_out, g.kernel) \
            or wci != g.c_in:
        raise ValueError(
            f"{fn_name}: plan geometry {g} does not match x{tuple(x.shape)} / "
            f"w{tuple(w.shape)}")
    if plan.backend != backend:
        raise ValueError(
            f"{fn_name}: plan was built for backend={plan.backend!r}")
    if plan.tiles is None:
        raise ValueError(f"{fn_name}: plan has no resolved tiles")


def refuse_graph(fn_name: str, *operands) -> None:
    """Raise when grad mode is on and an operand requires grad: a kernel
    launch returns a tensor with no ``grad_fn``, so a loss through it would
    silently train nothing (and the plain version on the CPU would
    differentiate another formulation than the reference's)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in operands):
        raise RuntimeError(
            f"{fn_name} builds no autograd graph; train through "
            "models.dcnn.make_fused_generator (the kernel forward with the "
            "reverse-loop backward), or call it under torch.no_grad()")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def halo_pad_geometry(n: int, ih: int, iw: int, ci: int, co: int,
                      plan, t_oh: int, t_ow: int, t_ci: int, t_co: int,
                      t_n: int):
    """Host-side padded geometry of one launch.

    Returns ``(oh, ow, ohp, owp, pad_l, pad_rh, pad_rw, cip, cop, t_n,
    np_)``: the true output extents, the tile-multiple output grid, the
    halo padding that keeps every per-tile window in bounds, the channel
    tiles' padded extents, the batch tile clamped to the batch, and the
    t_n-multiple padded batch."""
    oh = out_size(ih, plan.kernel_size, plan.stride, plan.padding)
    ow = out_size(iw, plan.kernel_size, plan.stride, plan.padding)
    ohp = _round_up(oh, t_oh)
    owp = _round_up(ow, t_ow)
    n_h_pad = ohp // plan.stride
    n_w_pad = owp // plan.stride
    pad_l = plan.left_halo
    pad_rh = max(0, (n_h_pad - 1 + plan.delta_max) - (ih - 1))
    pad_rw = max(0, (n_w_pad - 1 + plan.delta_max) - (iw - 1))
    cip = _round_up(ci, t_ci)
    cop = _round_up(co, t_co)
    t_n = min(t_n, n) if n > 0 else 1
    np_ = _round_up(n, t_n)
    return oh, ow, ohp, owp, pad_l, pad_rh, pad_rw, cip, cop, t_n, np_


@dataclasses.dataclass(frozen=True)
class StaticOperands:
    """The operands of a layer's launch that no call changes: ``w`` padded
    to ``(K, K, CIp, COp)`` (for int8 a `int8.PackedInt8Weights`), ``b``
    and, for int8, ``scale`` padded to ``(1, COp)``; for fp32 tiles on the
    wgmma path ``wt``, w packed CI-minor (`kernel.pack_ci_minor`); all
    contiguous."""

    w: Any
    b: torch.Tensor
    scale: Optional[torch.Tensor] = None
    wt: Optional[torch.Tensor] = None


def takes_fp32_wgmma(layer) -> bool:
    """Whether a tiled layer plan's launches take the fp32 dense kernel's
    wgmma path (`core.tiling.fp32_wgmma_tile`, at the batch tile and the
    cluster split of its launch), and so read w packed CI-minor."""
    if layer.dtype != "float32" or layer.backend != "cuda" or \
            layer.tiles is None:
        return False
    g, t = layer.geometry, layer.tiles
    (_, _, ohp, owp, _, _, _, cip, cop, t_n, np_) = layer.padded_geometry()
    split = launch_split(np_, cip, cop, ohp, owp, t.t_oh, t.t_ow, t.t_ci,
                         t.t_co, t_n)
    return fp32_wgmma_tile(g.stride, t.t_oh, t.t_ow, t.t_co, t_n, g.kernel,
                           t.t_ci, split) is not None


def with_ci_minor(st: StaticOperands) -> StaticOperands:
    """``st`` with ``wt``, its weight packed CI-minor, added (the same ``w``
    and ``b`` tensors: a graph that captured them keeps its addresses)."""
    if st.wt is not None:
        return st
    return dataclasses.replace(st, wt=pack_ci_minor(st.w))


def prepare_static(w: torch.Tensor, b: Optional[torch.Tensor], cip: int,
                   cop: int, bias_dtype=None) -> StaticOperands:
    """``w`` and ``b`` (None: zeros) zero-padded to ``cip`` / ``cop``
    channels, the bias in ``bias_dtype`` (default w's), contiguous; a
    weight that needs no padding is kept as it is."""
    k, _, ci, co = w.shape
    wp = F.pad(w, (0, cop - co, 0, cip - ci)) if (cip, cop) != (ci, co) else w
    bp = (b if b is not None else torch.zeros((co,), device=w.device))
    bp = pad_channels(bp.to(w.dtype if bias_dtype is None else bias_dtype),
                      cop)
    return StaticOperands(w=aligned(wp.contiguous()), b=bp.contiguous())


def call_args(x, k, co, stride, padding, t_oh, t_ow, t_ci, t_co, t_n,
              activation, cip=None):
    """The per-call part of one launch: ``(xp, kwargs, crop, (cip_t,
    cop_t))``.  ``xp`` is x padded with the halo rows, the batch tile and
    its channels up to ``cip`` (default ``cip_t``, the ``t_ci`` multiple;
    ``cop_t`` is the ``t_co`` multiple), and ``deconv2d_launch(xp, wp, bp,
    **kwargs)[crop]`` is the layer's output."""
    n, ih, iw, ci = x.shape
    plan = make_phase_plan(k, stride, padding)
    (oh, ow, ohp, owp, pad_l, pad_rh, pad_rw, cip_t, cop_t, t_n,
     np_) = halo_pad_geometry(n, ih, iw, ci, co, plan, t_oh, t_ow, t_ci,
                              t_co, t_n)
    cip = cip_t if cip is None else cip
    # F.pad lists the last dim first: C, W, H, N; a tensor that needs no
    # padding is passed as it is (F.pad would copy it)
    x_pad = (0, cip - ci, pad_l, pad_rw, pad_l, pad_rh, 0, np_ - n)
    xp = F.pad(x, x_pad) if any(x_pad) else x
    kwargs = dict(plan=plan, ih=ih, iw=iw, ohp=ohp, owp=owp, t_oh=t_oh,
                  t_ow=t_ow, t_ci=t_ci, t_co=t_co, t_n=t_n,
                  activation=activation)
    crop = (slice(0, n), slice(0, oh), slice(0, ow), slice(0, co))
    return xp.contiguous(), kwargs, crop, (cip_t, cop_t)


def launch_args(x, w, b, stride, padding, t_oh, t_ow, t_ci, t_co, t_n,
                activation):
    """Both parts of one launch, prepared here: ``(xp, wp, bp, kwargs,
    crop)`` where ``deconv2d_launch(xp, wp, bp, **kwargs)[crop]`` is the
    layer's output (the bias in x's dtype)."""
    k, _, _, co = w.shape
    xp, kwargs, crop, (cip, cop) = call_args(
        x, k, co, stride, padding, t_oh, t_ow, t_ci, t_co, t_n, activation)
    st = prepare_static(w, b, cip, cop, bias_dtype=x.dtype)
    return xp, st.w, st.b, kwargs, crop


def static_for(static: Optional[StaticOperands], w, b, cip: int, cop: int,
               bias_dtype=None) -> StaticOperands:
    """``static`` checked against this launch's padded channels, or the
    static part prepared now when it is None."""
    if static is None:
        return prepare_static(w, b, cip, cop, bias_dtype)
    if tuple(static.w.shape) != (w.shape[0], w.shape[1], cip, cop):
        raise ValueError(f"prepared weight {tuple(static.w.shape)} does not "
                         f"fit this launch's {cip}x{cop} channels")
    return static


def pad_channels(v: torch.Tensor, cop: int) -> torch.Tensor:
    """A per-channel vector zero-padded to ``cop`` channels, as ``(1, cop)``."""
    v = F.pad(v, (0, cop - v.shape[0])) if v.shape[0] != cop else v
    return v.reshape(1, cop)


def resolve_call(plan, x, w, backend, fn_name, stride, padding, activation,
                 tiles):
    """``(stride, padding, (t_oh, t_ow, t_ci, t_co, t_n), activation)`` of
    one call: all from ``plan`` (an explicit ``activation`` overrides the
    plan's), or ``stride``/``padding`` as given with the tiles left out
    filled by `autotune.hopper_tiles` at this batch, for the kernel that
    runs x's dtype."""
    if plan is not None:
        check_layer_plan(plan, x, w, backend, fn_name)
        t = plan.tiles
        return (plan.geometry.stride, plan.geometry.padding,
                (t.t_oh, t.t_ow, t.t_ci, t.t_co, t.t_n),
                plan.activation if activation is None else activation)
    if stride is None or padding is None:
        raise TypeError(f"{fn_name} needs stride and padding (or a plan=)")
    if None in tiles:
        from ..autotune import fill_tiles

        n, ih, iw, ci = x.shape
        k, _, _, co = w.shape
        c = fill_tiles(DeconvGeometry(ih, iw, ci, co, k, stride, padding), n,
                       x.dtype, **dict(zip(("t_oh", "t_ow", "t_ci", "t_co", "t_n"),
                                  tiles)))
        tiles = (c.t_oh, c.t_ow, c.t_ci, c.t_co, c.t_n)
    return stride, padding, tiles, activation


def report_launch(name: str, x, w_shape, stride: int, padding: int,
                  operands, y) -> None:
    """One kernel launch reported to an active cost counter
    (`core.counting.record_kernel`: no dispatch mode sees a ctypes
    launch), where a kernel launched: on the card, or on FakeTensors.  A
    CPU tensor ran the plain version, whose ops were counted as they ran.
    FLOPs are the layer geometry's ``ops`` (the reverse loop's useful
    work) for each image; bytes the operands' and the result's."""
    from ...core.counting import active, is_fake, nbytes, record_kernel

    if active() is None or (x.device.type == "cpu" and not is_fake(x)):
        return
    n, ih, iw, ci = x.shape
    g = DeconvGeometry(ih, iw, ci, w_shape[3], w_shape[0], stride, padding)
    record_kernel(name, g.ops * n,
                  sum(nbytes(t) for t in operands) + nbytes(y))


def deconv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: Optional[int] = None,
    padding: Optional[int] = None,
    t_oh: Optional[int] = None,
    t_ow: Optional[int] = None,
    t_ci: Optional[int] = None,
    t_co: Optional[int] = None,
    t_n: Optional[int] = None,
    activation: Optional[str] = None,
    plan=None,
    static: Optional[StaticOperands] = None,
) -> torch.Tensor:
    """Transposed conv y = act(deconv(x, w) + b) through the reverse-loop
    kernel, on the device of ``x``.

    x: (N, IH, IW, CI); w: (K, K, CI, CO); b: (CO,) or None.
    Output: (N, OH, OW, CO), OH = (IH-1)*S + K - 2P.
    ``activation`` ("relu"/"tanh"/None) runs fused in the kernel epilogue.

    With ``plan`` (a `repro_torch.plan.DeconvPlan` for backend "cuda"),
    stride, padding, tiles and activation come from the plan; an explicit
    ``activation`` overrides the plan's.  Without one, ``stride`` and
    ``padding`` are required and unspecified tiles come from
    `autotune.hopper_tiles` at this batch.  ``static`` holds w and b
    already padded for these tiles (`prepare_static`; a serving engine's);
    without it they are padded here.

    Raises when grad mode is on and x, w or b requires grad (`refuse_graph`).
    """
    refuse_graph("deconv2d", x, w, b)
    stride, padding, tiles, activation = resolve_call(
        plan, x, w, "cuda", "deconv2d", stride, padding, activation,
        (t_oh, t_ow, t_ci, t_co, t_n))
    xp, kwargs, crop, (cip, cop) = call_args(
        x, w.shape[0], w.shape[3], stride, padding, *tiles, activation)
    st = static_for(static, w, b, cip, cop, x.dtype)
    y = deconv2d_launch(xp, st.w, st.b, wt=st.wt, **kwargs)
    report_launch("B1", x, w.shape, stride, padding, (xp, st.w, st.b), y)
    return y[crop]
