"""Public wrapper for the deconv2d kernel.

`deconv2d` takes a pre-built `plan.DeconvPlan` (geometry, tiles and fused
epilogue pinned at plan time), or ``stride``/``padding`` with tiles that
the caller gives or the Hopper heuristic fills.  Both paths pad on the
host exactly as the JAX package's ``_deconv2d_jit`` does, make one
`deconv2d_launch`, and slice the padding off again.  The launch runs the
CUDA kernel on a CUDA tensor and the plain version on a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...core.offsets import make_phase_plan
from ...core.tiling import DeconvGeometry, out_size
from .kernel import deconv2d_launch


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


def launch_args(x, w, b, stride, padding, t_oh, t_ow, t_ci, t_co, t_n,
                activation, bias_dtype=None):
    """The host padding of one launch: ``(xp, wp, bp, kwargs, crop)`` where
    ``deconv2d_launch(xp, wp, bp, **kwargs)[crop]`` is the layer's output.
    The bias is cast to ``bias_dtype`` (default: x's dtype; the int8 kernel
    takes an f32 bias)."""
    n, ih, iw, ci = x.shape
    k, _, _, co = w.shape
    plan = make_phase_plan(k, stride, padding)
    (oh, ow, ohp, owp, pad_l, pad_rh, pad_rw, cip, cop, t_n,
     np_) = halo_pad_geometry(n, ih, iw, ci, co, plan, t_oh, t_ow, t_ci,
                              t_co, t_n)
    # F.pad lists the last dim first: C, W, H, N; a tensor that needs no
    # padding is passed as it is (F.pad would copy it)
    x_pad = (0, cip - ci, pad_l, pad_rw, pad_l, pad_rh, 0, np_ - n)
    xp = F.pad(x, x_pad) if any(x_pad) else x
    wp = F.pad(w, (0, cop - co, 0, cip - ci)) if (cip, cop) != (ci, co) else w
    bias_dtype = x.dtype if bias_dtype is None else bias_dtype
    bp = (b if b is not None else torch.zeros((co,), device=x.device)).to(
        bias_dtype)
    bp = pad_channels(bp, cop)
    kwargs = dict(plan=plan, ih=ih, iw=iw, ohp=ohp, owp=owp, t_oh=t_oh,
                  t_ow=t_ow, t_ci=t_ci, t_co=t_co, t_n=t_n,
                  activation=activation)
    crop = (slice(0, n), slice(0, oh), slice(0, ow), slice(0, co))
    return (xp.contiguous(), wp.contiguous(), bp.contiguous(), kwargs, crop)


def pad_channels(v: torch.Tensor, cop: int) -> torch.Tensor:
    """A per-channel vector zero-padded to ``cop`` channels, as ``(1, cop)``."""
    v = F.pad(v, (0, cop - v.shape[0])) if v.shape[0] != cop else v
    return v.reshape(1, cop)


def resolve_call(plan, x, w, backend, fn_name, stride, padding, activation,
                 tiles):
    """``(stride, padding, (t_oh, t_ow, t_ci, t_co, t_n), activation)`` of
    one call: all from ``plan`` (an explicit ``activation`` overrides the
    plan's), or ``stride``/``padding`` as given with the tiles left out
    filled by `autotune.hopper_tiles` at this batch."""
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
                       **dict(zip(("t_oh", "t_ow", "t_ci", "t_co", "t_n"),
                                  tiles)))
        tiles = (c.t_oh, c.t_ow, c.t_ci, c.t_co, c.t_n)
    return stride, padding, tiles, activation


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
    `autotune.hopper_tiles` at this batch.
    """
    stride, padding, tiles, activation = resolve_call(
        plan, x, w, "cuda", "deconv2d", stride, padding, activation,
        (t_oh, t_ow, t_ci, t_co, t_n))
    xp, wp, bp, kwargs, crop = launch_args(x, w, b, stride, padding, *tiles,
                                           activation)
    return deconv2d_launch(xp, wp, bp, **kwargs)[crop]
