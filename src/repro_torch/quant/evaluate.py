"""Accuracy harness for the int8 inference path.

The paper's quality metric is distribution-level (MMD, §V-C), so the
quantization acceptance metric is the MMD between the images the int8
generator produces and the fp32 images from identical latents, per
calibration strategy; per-pixel error is reported beside it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..core.mmd import mmd
from ..models.dcnn import DcnnConfig, generator_apply
from .calibrate import OBSERVERS, calibrate, quantize_params
from .infer import quantized_generator_apply, quantized_generator_ref


def mmd_degradation(
    params,
    cfg: DcnnConfig,
    generator: torch.Generator,
    strategies: Sequence[str] = OBSERVERS,
    n: int = 64,
    calib_n: int = 64,
    percentile: float = 99.9,
    k: float = 6.0,
    use_kernel: bool = True,
) -> List[Dict[str, float]]:
    """MMD-vs-fp32 degradation of the int8 path per calibration strategy,
    on the params' device.

    Calibrates on ``calib_n`` latents and evaluates on ``n`` others, both
    drawn from ``generator`` (a CPU `torch.Generator`, in place of the
    reference's jax key; the draws differ from the reference's).
    ``use_kernel=False`` runs the integer-exact plain chain instead of the
    int8 kernel."""
    device = params["l0"]["w"].device
    z_cal = torch.randn((calib_n, cfg.z_dim), generator=generator).to(device)
    z_ev = torch.randn((n, cfg.z_dim), generator=generator).to(device)
    with torch.no_grad():
        base = generator_apply(params, cfg, z_ev, backend="reverse_loop")
    rows = []
    for strategy in strategies:
        qcfg = calibrate(params, cfg, z_cal, strategy=strategy,
                         percentile=percentile, k=k)
        qp = quantize_params(params, cfg, qcfg)
        chain = quantized_generator_apply if use_kernel else \
            quantized_generator_ref
        imgs = chain(qp, cfg, qcfg, z_ev)
        err = (imgs - base).abs()
        rows.append({
            "net": cfg.name,
            "strategy": strategy,
            "mmd_vs_fp32": float(mmd(base.reshape(n, -1),
                                     imgs.reshape(n, -1))),
            "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()),
        })
    return rows
