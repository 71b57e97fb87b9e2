"""The paper's DCNN generators (Fig. 4) for WGAN-GP on MNIST and CelebA.

The generator's deconvolution layers run through a selectable backend:
  * "reverse_loop" — the paper's algorithm, phase-decomposed plain torch,
  * "cuda"         — the hand-written CUDA kernel (the JAX package's
                     "pallas"); the plain version of that kernel on CPU
                     tensors,
  * "cuda_sparse"  — the hand-written zero-skip kernel on pruned weights
                     (the JAX package's "pallas_sparse"; inference only),
  * "cudnn"        — conventional zero-insertion ``F.conv_transpose2d``
                     (the JAX package's "xla"; the GPU baseline of Table II).

Layouts are the JAX package's: NHWC activations, (K, K, C_in, C_out)
weights and params ``{"l{i}": {"w", "b"}}``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.deconv import deconv2d_reverse_loop, deconv2d_zero_insertion
from ..core.tiling import DeconvGeometry

BACKENDS = ("reverse_loop", "cuda", "cuda_sparse", "cudnn")
_FUSED = ("cuda", "cuda_sparse")   # bias and activation in the kernel


@dataclasses.dataclass(frozen=True)
class DeconvLayerCfg:
    c_in: int
    c_out: int
    kernel: int
    stride: int
    padding: int
    activation: str  # relu | tanh


@dataclasses.dataclass(frozen=True)
class DcnnConfig:
    """A deconv tower: input root -> stacked deconv layers -> image.

    Latent-rooted towers (``in_hw == 1``) take a flat ``(z_dim,)`` vector
    reshaped to a 1x1 spatial root; ``in_hw > 1`` declares an image-rooted
    tower whose input is ``(in_hw, in_hw, in_c)``."""

    name: str
    z_dim: int
    img_hw: int
    img_c: int
    layers: Tuple[DeconvLayerCfg, ...]
    dtype: str = "float32"
    in_hw: int = 1

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def in_c(self) -> int:
        """Input channel count of the tower root (== layers[0].c_in)."""
        return self.layers[0].c_in

    @property
    def is_latent(self) -> bool:
        """True for the WGAN-style 1x1 latent root (flat z input)."""
        return self.in_hw == 1

    @property
    def input_shape(self) -> Tuple[int, ...]:
        """Per-example input shape: ``(z_dim,)`` for latent towers,
        ``(in_hw, in_hw, in_c)`` for image-rooted towers."""
        if self.is_latent:
            return (self.z_dim,)
        return (self.in_hw, self.in_hw, self.in_c)

    def geometries(self) -> List[DeconvGeometry]:
        h = w = self.in_hw
        out = []
        for l in self.layers:
            g = DeconvGeometry(h, w, l.c_in, l.c_out, l.kernel, l.stride, l.padding)
            out.append(g)
            h, w = g.out_h, g.out_w
        return out


MNIST_DCNN = DcnnConfig(
    name="dcnn-mnist",
    z_dim=100,
    img_hw=28,
    img_c=1,
    layers=(
        DeconvLayerCfg(100, 256, 7, 1, 0, "relu"),   # 1x1 -> 7x7
        DeconvLayerCfg(256, 128, 4, 2, 1, "relu"),   # 7x7 -> 14x14
        DeconvLayerCfg(128, 1, 4, 2, 1, "tanh"),     # 14x14 -> 28x28
    ),
)

CELEBA_DCNN = DcnnConfig(
    name="dcnn-celeba",
    z_dim=100,
    img_hw=64,
    img_c=3,
    layers=(
        DeconvLayerCfg(100, 1024, 4, 1, 0, "relu"),  # 1x1 -> 4x4
        DeconvLayerCfg(1024, 512, 4, 2, 1, "relu"),  # 4x4 -> 8x8
        DeconvLayerCfg(512, 256, 4, 2, 1, "relu"),   # 8x8 -> 16x16
        DeconvLayerCfg(256, 128, 4, 2, 1, "relu"),   # 16x16 -> 32x32
        DeconvLayerCfg(128, 3, 4, 2, 1, "tanh"),     # 32x32 -> 64x64
    ),
)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def lecun_init(generator: torch.Generator, shape, dtype: torch.dtype,
               fan_in: int) -> torch.Tensor:
    """N(0, 1/fan_in) weights drawn from ``generator`` (on the CPU, so a
    seed gives the same weights whatever device they go to)."""
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (scale * torch.randn(shape, generator=generator)).to(dtype)


def generator_init(generator: torch.Generator, cfg: DcnnConfig,
                   device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random generator params on ``device``: LeCun-normal weights, zero
    biases.  Draws do not match the JAX package's ``jax.random`` init;
    parity tests load the JAX params through `generator_params_from_numpy`."""
    p: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, l in enumerate(cfg.layers):
        w = lecun_init(generator, (l.kernel, l.kernel, l.c_in, l.c_out),
                       cfg.torch_dtype, fan_in=l.c_in * l.kernel * l.kernel)
        p[f"l{i}"] = {"w": w.to(device),
                      "b": torch.zeros((l.c_out,), dtype=cfg.torch_dtype,
                                       device=device)}
    return p


def generator_params_from_numpy(tree, cfg: DcnnConfig,
                                device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's params from a ``{"l{i}": {"w", "b"}}`` tree of arrays (the
    JAX package's params as numpy), every shape checked against ``cfg``."""
    if set(tree) != {f"l{i}" for i in range(len(cfg.layers))}:
        raise ValueError(f"{cfg.name} expects params l0..l{len(cfg.layers) - 1}"
                         f", got {sorted(tree)}")
    p: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, l in enumerate(cfg.layers):
        want = {"w": (l.kernel, l.kernel, l.c_in, l.c_out), "b": (l.c_out,)}
        p[f"l{i}"] = {}
        for name, shape in want.items():
            a = np.asarray(tree[f"l{i}"][name])
            if a.shape != shape:
                raise ValueError(f"{cfg.name} l{i}.{name}: expected shape "
                                 f"{shape}, got {a.shape}")
            p[f"l{i}"][name] = torch.as_tensor(
                np.array(a, dtype=np.float32)).to(device=device,
                                                  dtype=cfg.torch_dtype)
    return p


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------
def tower_input(cfg: DcnnConfig, x: torch.Tensor) -> torch.Tensor:
    """Canonicalize a tower input to the 4D root ``(B, in_hw, in_hw,
    in_c)``; a shape that matches neither root fails loudly."""
    expect = (cfg.in_hw, cfg.in_hw, cfg.in_c)
    if cfg.is_latent and x.ndim == 2 and x.shape[1] == cfg.z_dim:
        return x.reshape(x.shape[0], 1, 1, cfg.z_dim)
    if x.ndim == 4 and tuple(x.shape[1:]) == expect:
        return x
    want = (f"(B, {cfg.z_dim})" if cfg.is_latent
            else f"(B, {expect[0]}, {expect[1]}, {expect[2]})")
    raise ValueError(
        f"{cfg.name} expects input rows shaped {want}; got {tuple(x.shape)}")


def generator_apply(
    p, cfg: DcnnConfig, z: torch.Tensor, backend: str = "reverse_loop",
    return_intermediates: bool = False,
    plan=None,
    sparse_plans=None,
    prepared=None,
):
    """z: (B, z_dim) latents -> images (B, H, W, C) in [-1, 1], on the
    device of ``z`` (the params must be on the same device).

    ``plan`` is an fp32 `repro_torch.plan.NetworkPlan`: its backend and
    per-layer tiles, epilogues and zero-skip schedules are used.  On
    "cuda" and "cuda_sparse" each layer's bias and activation run fused in
    the kernel; the other backends apply the activation afterwards.
    ``sparse_plans`` maps layer index -> ``make_sparse_plan`` tables for
    "cuda_sparse" (int32 tensors already on z's device are used without a
    copy; a serving engine keeps them there).  ``prepared`` maps layer
    index -> `kernels.deconv2d.ops.StaticOperands`, the layer's weight and
    bias already padded for the plan's tiles (a serving engine prepares
    them once); on "cuda" and "cuda_sparse" they are passed to the kernel
    as they are, else padded per call.  ``return_intermediates=True``
    also returns the per-layer *inputs*: ``(images, [x_0, ..., x_{L-1}])``.
    Nothing on "cuda_sparse" takes a gradient: its schedule is built from
    frozen weights.
    """
    if plan is not None:
        if plan.precision != "fp32":
            raise ValueError(
                f"generator_apply executes fp32 plans; a {plan.precision!r} "
                "plan runs through quant.infer.quantized_generator_apply")
        plan.validate_for(cfg)
        backend = plan.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    x = tower_input(cfg, z).to(cfg.torch_dtype)
    inters = []
    for i, l in enumerate(cfg.layers):
        if return_intermediates:
            inters.append(x)
        w, b = p[f"l{i}"]["w"], p[f"l{i}"]["b"]
        static = (prepared or {}).get(i)
        if backend == "reverse_loop":
            x = deconv2d_reverse_loop(x, w, b, l.stride, l.padding)
        elif backend == "cudnn":
            x = deconv2d_zero_insertion(x, w, b, l.stride, l.padding)
        elif backend == "cuda_sparse":
            from ..kernels.deconv2d_sparse import deconv2d_sparse

            schedule = (sparse_plans or {}).get(i)
            with torch.no_grad():
                if plan is not None:
                    x = deconv2d_sparse(x, w, b, plan=plan.layers[i],
                                        schedule=schedule, static=static)
                else:
                    x = deconv2d_sparse(x, w, b, l.stride, l.padding,
                                        activation=l.activation,
                                        schedule=schedule, static=static)
        else:
            from ..kernels.deconv2d import deconv2d

            if plan is not None:
                x = deconv2d(x, w, b, plan=plan.layers[i], static=static)
            else:
                x = deconv2d(x, w, b, l.stride, l.padding,
                             activation=l.activation, static=static)
        if backend not in _FUSED:
            x = torch.tanh(x) if l.activation == "tanh" else torch.relu(x)
    if return_intermediates:
        return x, inters
    return x
