"""int8 inference path for the DCNN generators.

`quantized_generator_apply` is the quantized twin of
``models.dcnn.generator_apply(backend="cuda")``: the calibrated input scale
quantizes z once, then every deconv layer runs the int8 kernel with its
fused requant epilogue re-quantizing straight into the next layer's
calibrated range.  Activations stay int8 on the device between layers;
only the final tanh layer emits f32 images.  The kernel takes its weights
packed CI-minor (`kernels.deconv2d.int8.pack_int8_weights`):
`pack_quantized_params` prepares every layer's static operands once (the
packed weight, the scale and the bias padded to its channels, as
``"static"``), and the chain passes them to the kernel where the tree has
them, so that no launch of the chain prepares an operand that does not
change.
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


def pack_quantized_params(qp: Dict[str, Dict[str, torch.Tensor]],
                          cfg: DcnnConfig) -> Dict[str, Dict[str, object]]:
    """``qp`` with each layer's static operands for the int8 kernel as
    ``"static"`` (`kernels.deconv2d.int8.prepare_int8_static`): ``w_q``
    packed at channel widths that every tile choice divides
    (`kernels.deconv2d.int8.packed_ci_width` and ``packed_width``), so one
    packing serves every bucket's plan, and the scale and bias padded to
    them.  ``w_q`` stays in the reference layout."""
    from ..kernels.deconv2d.int8 import (packed_ci_width, packed_width,
                                         prepare_int8_static)

    return {f"l{i}": {**qp[f"l{i}"], "static": prepare_int8_static(
        qp[f"l{i}"]["w_q"], qp[f"l{i}"]["scale"], qp[f"l{i}"]["b"],
        packed_ci_width(l.c_in), packed_width(l.c_out))}
        for i, l in enumerate(cfg.layers)}


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
    ``b``, f32 per-channel combined ``scale``), with ``static`` per layer
    where `pack_quantized_params` added it (passed to the kernel as it is;
    else each launch packs ``w_q`` and pads the scale and bias); ``qcfg``
    carries the
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
        static = lq.get("static")
        if plan is not None:
            x = deconv2d_int8(x, lq["w_q"], lq["scale"], lq["b"],
                              plan=plan.layers[i], static=static)
        else:
            x = deconv2d_int8(x, lq["w_q"], lq["scale"], lq["b"], l.stride,
                              l.padding, activation=l.activation,
                              out_scale=qcfg.out_scale(i), static=static)
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
