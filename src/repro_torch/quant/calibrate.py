"""Statistical calibration of per-layer, per-channel int8 ranges.

The JAX package's ``repro.quant.calibrate``, on torch tensors:

* activation observers ``minmax`` (clip at max|x|), ``percentile`` (clip at
  the p-th percentile of |x|) and ``mean_ksigma`` (clip at mean(|x|) +
  k * std(|x|), the paper's statistical clipping), computed in numpy on the
  host exactly as the reference computes them;
* ``calibrate`` pushes a calibration batch through the plain
  ``generator_apply(backend="reverse_loop")`` and observes the *input* of
  every deconv layer, the tensor the int8 kernel quantizes;
* weights are quantized per output channel (amax over each C_out's
  (K, K, C_in) slab).

`LayerQuant` and `QuantConfig` hold plain Python floats, field for field
the reference's, so a plan that carries them hashes the same in both
packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.dcnn import DcnnConfig, generator_apply
from .qmath import QMAX, quantize_symmetric, symmetric_scale

OBSERVERS = ("minmax", "percentile", "mean_ksigma")


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def observe_amax(x, strategy: str = "mean_ksigma", percentile: float = 99.9,
                 k: float = 6.0) -> float:
    """Clip value (pre-scale absolute max) for one activation tensor."""
    a = np.abs(_numpy(x)).ravel()
    if strategy == "minmax":
        return float(a.max())
    if strategy == "percentile":
        return float(np.percentile(a, percentile))
    if strategy == "mean_ksigma":
        return float(min(a.max(), a.mean() + k * a.std()))
    raise ValueError(
        f"unknown observer {strategy!r}; expected one of {OBSERVERS}")


@dataclasses.dataclass(frozen=True)
class LayerQuant:
    """Calibrated ranges for one deconv layer: ``x_scale`` the per-tensor
    scale of the layer's input, ``w_scale`` the per-output-channel weight
    scales (length C_out)."""

    x_scale: float
    w_scale: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Per-layer calibration result for a whole generator network."""

    name: str
    strategy: str
    layers: Tuple[LayerQuant, ...]

    def out_scale(self, i: int):
        """Requant scale of layer i's output == layer i+1's input scale
        (None for the last layer, which stays f32 after its epilogue)."""
        return (self.layers[i + 1].x_scale
                if i + 1 < len(self.layers) else None)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuantConfig":
        """From `to_dict`'s layout, which is also ``dataclasses.asdict`` of
        the JAX package's ``QuantConfig``: both packages then compute with
        the same scales."""
        return cls(name=str(d["name"]), strategy=str(d["strategy"]),
                   layers=tuple(LayerQuant(
                       x_scale=float(l["x_scale"]),
                       w_scale=tuple(float(v) for v in l["w_scale"]))
                       for l in d["layers"]))


def calibrate(params, cfg: DcnnConfig, z: torch.Tensor,
              strategy: str = "mean_ksigma", percentile: float = 99.9,
              k: float = 6.0) -> QuantConfig:
    """Observe a calibration batch ``z`` (on the params' device) and emit
    the per-layer `QuantConfig`.  The observed tensors are each layer's
    input: z itself for layer 0, then every post-activation intermediate
    of the fp32 plain chain."""
    if strategy not in OBSERVERS:
        raise ValueError(
            f"unknown observer {strategy!r}; expected one of {OBSERVERS}")
    with torch.no_grad():
        _, inters = generator_apply(params, cfg, z, backend="reverse_loop",
                                    return_intermediates=True)
    layers = []
    for i, x_in in enumerate(inters):
        amax = observe_amax(x_in, strategy, percentile=percentile, k=k)
        w = _numpy(params[f"l{i}"]["w"])
        w_amax = np.abs(w).reshape(-1, w.shape[3]).max(axis=0)
        layers.append(LayerQuant(
            x_scale=float(symmetric_scale(amax)),
            w_scale=tuple(float(symmetric_scale(a)) for a in w_amax),
        ))
    return QuantConfig(name=cfg.name, strategy=strategy,
                       layers=tuple(layers))


def quantize_params(params, cfg: DcnnConfig, qcfg: QuantConfig,
                    device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The int8 weight tree of the quantized serving path, on ``device``
    (default: the device of the fp32 weights).

    Per layer: ``w_q`` (K, K, C_in, C_out) int8 quantized per output
    channel, ``b`` the f32 bias, and ``scale`` the combined requant factor
    x_scale * w_scale per channel, computed in numpy as the reference does
    (``(x_scale * w_scale).astype(float32)``), so it is bit-equal."""
    qp: Dict[str, Dict[str, torch.Tensor]] = {}
    for i in range(len(cfg.layers)):
        w = params[f"l{i}"]["w"]
        dev = device if device is not None else (
            w.device if isinstance(w, torch.Tensor) else "cpu")
        lq = qcfg.layers[i]
        w_scale = np.asarray(lq.w_scale, np.float32)
        w_q = quantize_symmetric(torch.from_numpy(_numpy(w)),
                                 torch.from_numpy(w_scale), QMAX)
        qp[f"l{i}"] = {
            "w_q": w_q.to(dev),
            "b": torch.from_numpy(_numpy(params[f"l{i}"]["b"])).to(dev),
            "scale": torch.from_numpy(
                (lq.x_scale * w_scale).astype(np.float32)).to(dev),
        }
    return qp
