"""Public wrapper for the zero-skip deconv kernel.

The schedule is built on the host from the static pruned weights
(`make_sparse_plan`), the paper's zero-skipping hoisted to load time.
`deconv2d_sparse` pads on the host exactly as the dense `deconv2d` does,
makes one `deconv2d_sparse_launch`, and slices the padding off again."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...core.sparsity import block_mask
from ..deconv2d.ops import (_round_up, call_args, refuse_graph,
                            report_launch, resolve_call, static_for)
from .kernel import build_schedule, deconv2d_sparse_launch, schedule_tensors


def make_sparse_plan(
    w, stride: int, padding: int, t_ci: int, t_co: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side schedule ``(ci_idx, valid, tap_mask)`` from pruned weights
    (a tensor or an array), at the kernel's CI chunk ``t_ci`` and CO tile
    ``t_co``.  ``stride`` and ``padding`` are not used, as in the
    reference."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w)
    cip = _round_up(w.shape[2], t_ci)
    cop = _round_up(w.shape[3], t_co)
    wp = np.pad(w, ((0, 0), (0, 0), (0, cip - w.shape[2]),
                    (0, cop - w.shape[3])))
    ci_idx, valid, tap_mask, _ = build_schedule(block_mask(wp, t_ci, t_co))
    return ci_idx, valid, tap_mask


def deconv2d_sparse(
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
    schedule=None,
    static=None,
) -> torch.Tensor:
    """Zero-skip transposed conv y = act(deconv(x, w) + b) on pruned weights,
    on the device of ``x``.

    With ``plan`` (a `repro_torch.plan.DeconvPlan` for backend
    "cuda_sparse"), stride, padding, tiles, activation and the schedule
    come from the plan.  ``schedule`` gives the ``make_sparse_plan`` tables
    (packed here), or a packed `kernel.Schedule` (already on x's device, it
    is not copied); without either, the schedule is built here from ``w``
    at the tiles, which the caller gives or the Hopper heuristic fills.
    ``static`` holds w and b already padded for these tiles
    (`deconv2d.ops.prepare_static`; a serving engine's); without it they
    are padded here.  Raises when grad mode is on and x, w or b requires
    grad (`deconv2d.ops.refuse_graph`)."""
    refuse_graph("deconv2d_sparse", x, w, b)
    stride, padding, tiles, activation = resolve_call(
        plan, x, w, "cuda_sparse", "deconv2d_sparse", stride, padding,
        activation, (t_oh, t_ow, t_ci, t_co, t_n))
    t_ci, t_co = tiles[2], tiles[3]
    if schedule is None and plan is not None:
        schedule = plan.sparse_tables
    if schedule is None:
        schedule = make_sparse_plan(w, stride, padding, t_ci, t_co)
    n_co = _round_up(w.shape[3], t_co) // t_co
    if schedule[0].shape[0] != n_co:
        raise ValueError(
            f"sparse plan was built for {schedule[0].shape[0]} C_out tiles but"
            f" the resolved t_co={t_co} yields {n_co}; rebuild the plan with "
            "the same channel tiles (or pass matching t_ci/t_co overrides)")
    xp, kwargs, crop, (cip, cop) = call_args(
        x, w.shape[0], w.shape[3], stride, padding, *tiles, activation)
    st = static_for(static, w, b, cip, cop, x.dtype)
    sched = schedule_tensors(schedule, x.device)
    y = deconv2d_sparse_launch(xp, st.w, st.b, *sched, **kwargs)
    report_launch("B3", x, w.shape, stride, padding, (xp, st.w, st.b, *sched),
                  y)
    return y[crop]
