"""int8 inference path for the DCNN generators.

`quantized_generator_apply` is the quantized twin of
``models.dcnn.generator_apply(backend="cuda")``: the calibrated input scale
quantizes z once, then every deconv layer runs the int8 kernel with its
fused requant epilogue re-quantizing straight into the next layer's
calibrated range.  Activations stay int8 on the device between layers;
only the final tanh layer emits f32 images.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.dcnn import DcnnConfig, tower_input
from .calibrate import QuantConfig
from .qmath import quantize_symmetric


def _check_qcfg(cfg: DcnnConfig, qcfg: Optional[QuantConfig]) -> QuantConfig:
    if qcfg is None:
        raise ValueError("the int8 chain needs a QuantConfig (directly or "
                         "through an int8 plan)")
    if len(qcfg.layers) != len(cfg.layers):
        raise ValueError(f"QuantConfig has {len(qcfg.layers)} layers; "
                         f"{cfg.name} has {len(cfg.layers)}")
    return qcfg


def quantized_generator_apply(
    qp: Dict[str, Dict[str, torch.Tensor]],
    cfg: DcnnConfig,
    qcfg: Optional[QuantConfig],
    z: torch.Tensor,
    plan=None,
) -> torch.Tensor:
    """z: (B, z_dim) f32 -> images (B, H, W, C) f32 in [-1, 1], on z's
    device (``qp`` on the same device).

    ``qp`` is the `quant.calibrate.quantize_params` tree (int8 ``w_q``, f32
    ``b``, f32 per-channel combined ``scale``); ``qcfg`` carries the
    activation scales that chain the layers.  With ``plan`` (an int8
    `repro_torch.plan.NetworkPlan`), tiles and requant scales come from
    the plan and ``qcfg`` may be None."""
    from ..kernels.deconv2d import deconv2d_int8

    if plan is not None:
        if plan.precision != "int8":
            raise ValueError(f"quantized_generator_apply needs an int8 plan, "
                             f"got {plan.precision!r}")
        plan.validate_for(cfg)
        if qcfg is None:
            qcfg = plan.quant_config()
    qcfg = _check_qcfg(cfg, qcfg)
    x = quantize_symmetric(tower_input(cfg, z), qcfg.layers[0].x_scale)
    for i, l in enumerate(cfg.layers):
        lq = qp[f"l{i}"]
        if plan is not None:
            x = deconv2d_int8(x, lq["w_q"], lq["scale"], lq["b"],
                              plan=plan.layers[i])
        else:
            x = deconv2d_int8(x, lq["w_q"], lq["scale"], lq["b"], l.stride,
                              l.padding, activation=l.activation,
                              out_scale=qcfg.out_scale(i))
    return x


def quantized_generator_ref(
    qp: Dict[str, Dict[str, torch.Tensor]],
    cfg: DcnnConfig,
    qcfg: QuantConfig,
    z: torch.Tensor,
) -> torch.Tensor:
    """Oracle of the whole chain: the same quantize -> exact integer conv
    -> requant per layer through `deconv2d_int8_ref`."""
    from ..kernels.deconv2d import deconv2d_int8_ref

    qcfg = _check_qcfg(cfg, qcfg)
    x = quantize_symmetric(tower_input(cfg, z), qcfg.layers[0].x_scale)
    for i, l in enumerate(cfg.layers):
        lq = qp[f"l{i}"]
        x = deconv2d_int8_ref(x, lq["w_q"], lq["scale"], lq["b"], l.stride,
                              l.padding, activation=l.activation,
                              out_scale=qcfg.out_scale(i))
    return x
