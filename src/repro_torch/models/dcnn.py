"""The paper's DCNN generators (Fig. 4) for WGAN-GP on MNIST and CelebA,
and their critics.

The generator's deconvolution layers run through a selectable backend:
  * "reverse_loop" — the paper's algorithm, phase-decomposed plain torch,
  * "cuda"         — the hand-written CUDA kernel (the JAX package's
                     "pallas"); the plain version of that kernel on CPU
                     tensors,
  * "cuda_sparse"  — the hand-written zero-skip kernel on pruned weights
                     (the JAX package's "pallas_sparse"; inference only),
  * "cudnn"        — conventional zero-insertion ``F.conv_transpose2d``
                     (the JAX package's "xla"; the GPU baseline of Table II).

Training runs "cuda" through `make_fused_generator`: the kernel forward
with the reverse loop's autograd as its backward.

Layouts are the JAX package's: NHWC activations, (K, K, C_in, C_out)
weights and params ``{"l{i}": {"w", "b"}}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.deconv import (deconv2d_reverse_loop, deconv2d_zero_insertion,
                           fp32_exact)
from ..core.tiling import DeconvGeometry
from . import nn
from .nn import lecun_init

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

    def feeds(self) -> None:
        """A tower is a chain: each layer reads the one before
        (`plan.NetworkPlan.feeds`)."""
        return None


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


def generator_shapes(cfg: DcnnConfig) -> Dict[str, Dict[str, tuple]]:
    """``{"l{i}": {"w": (K, K, C_in, C_out), "b": (C_out,)}}``."""
    return {f"l{i}": {"w": (l.kernel, l.kernel, l.c_in, l.c_out),
                      "b": (l.c_out,)} for i, l in enumerate(cfg.layers)}


def _params_from_numpy(tree, shapes, cfg: DcnnConfig, device, names: str):
    """Tensors in ``cfg``'s dtype on ``device`` from a tree of arrays whose
    keys (``names``, for the message) and shapes are exactly ``shapes``'."""
    if set(tree) != set(shapes):
        raise ValueError(f"{cfg.name} expects params {names}, got "
                         f"{sorted(tree)}")
    p: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, want in shapes.items():
        if set(tree[key]) != set(want):
            raise ValueError(f"{cfg.name} {key}: expected leaves "
                             f"{sorted(want)}, got {sorted(tree[key])}")
        p[key] = {}
        for name, shape in want.items():
            a = np.asarray(tree[key][name])
            if a.shape != shape:
                raise ValueError(f"{cfg.name} {key}.{name}: expected shape "
                                 f"{shape}, got {a.shape}")
            p[key][name] = torch.as_tensor(
                np.array(a, dtype=np.float32)).to(device=device,
                                                  dtype=cfg.torch_dtype)
    return p


def generator_params_from_numpy(tree, cfg: DcnnConfig,
                                device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's params from a ``{"l{i}": {"w", "b"}}`` tree of arrays (the
    JAX package's params as numpy), every shape checked against ``cfg``."""
    return _params_from_numpy(tree, generator_shapes(cfg), cfg, device,
                              f"l0..l{len(cfg.layers) - 1}")


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

    "cuda" and "cuda_sparse" build no autograd graph: their ops raise when
    asked to (grad mode on and an operand that requires grad).  Training
    runs "cuda" through `make_fused_generator`; "cuda_sparse" does not
    train (its schedule is built from frozen weights).
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


def make_fused_generator(cfg: DcnnConfig, fwd_backend: str = "cuda",
                         plan=None):
    """Differentiable generator ``apply(p, z)`` whose forward runs the
    serving kernel and whose backward is autograd of the reverse loop:
    the JAX package's ``make_fused_generator`` (a ``custom_vjp``) as a
    ``torch.autograd.Function``.

    The forward is ``generator_apply(backend=fwd_backend)``, or the pinned
    fp32 ``plan``'s backend and tiles: on "cuda" one B1 launch per layer
    on the card, the kernel's plain version on CPU tensors.  The backward
    rematerialises the reverse-loop forward on detached copies of the
    params and ``z`` and takes ``torch.autograd.grad`` through it; nothing
    of the kernel's forward is reused, as in the reference.  Every call
    reads the params it is given: no padded copy of a weight is kept
    across calls, so an optimizer step is seen by the next forward.

    "cuda_sparse" is rejected: its zero-skip schedule is built from frozen
    weights, which training updates each step."""
    if not isinstance(cfg, DcnnConfig):
        raise ValueError(f"make_fused_generator trains a DCNN tower, not a "
                         f"{type(cfg).__name__}: the U-Net does not train "
                         "here")
    if plan is not None:
        fwd_backend = plan.backend
    if fwd_backend == "cuda_sparse":
        raise ValueError(
            "cuda_sparse is inference-only: the static zero-skip plan is "
            "derived from frozen weights, which training updates each step")
    keys = [(f"l{i}", n) for i in range(len(cfg.layers)) for n in ("w", "b")]

    def tree(leaves):
        p: Dict[str, Dict[str, torch.Tensor]] = {}
        for (layer, name), t in zip(keys, leaves):
            p.setdefault(layer, {})[name] = t
        return p

    class FusedGenerator(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z, *leaves):
            ctx.save_for_backward(z, *leaves)
            return generator_apply(tree(leaves), cfg, z, backend=fwd_backend,
                                   plan=plan)

        @staticmethod
        @torch.autograd.function.once_differentiable
        def backward(ctx, ct):
            saved = ctx.saved_tensors
            needs = ctx.needs_input_grad
            with torch.enable_grad():
                inputs = [t.detach().requires_grad_(need)
                          for t, need in zip(saved, needs)]
                y = generator_apply(tree(inputs[1:]), cfg, inputs[0],
                                    backend="reverse_loop")
                wanted = [t for t in inputs if t.requires_grad]
                grads = iter(torch.autograd.grad(y, wanted, ct))
            return tuple(next(grads) if need else None for need in needs)

    def apply(p, z):
        return FusedGenerator.apply(z, *(p[l][n] for l, n in keys))

    return apply


# ---------------------------------------------------------------------------
# Critic (WGAN-GP discriminator: strided convs, LeakyReLU, no norm)
# ---------------------------------------------------------------------------
def _critic_channels(cfg: DcnnConfig) -> List[int]:
    return [cfg.img_c] + [64 * (2 ** i) for i in range(len(cfg.layers) - 1)]


def critic_shapes(cfg: DcnnConfig) -> Dict[str, Dict[str, tuple]]:
    """``{"c{i}": {"w": (4, 4, C_in, C_out), "b"}, "head": {"w": (D, 1),
    "b": (1,)}}``: one stride-2 conv per generator layer but the first,
    then a dense head over the flattened NHWC features."""
    chans = _critic_channels(cfg)
    shapes = {f"c{i}": {"w": (4, 4, chans[i], chans[i + 1]),
                        "b": (chans[i + 1],)} for i in range(len(chans) - 1)}
    hw = cfg.img_hw
    for _ in range(len(chans) - 1):
        hw //= 2
    shapes["head"] = {"w": (hw * hw * chans[-1], 1), "b": (1,)}
    return shapes


def critic_init(generator: torch.Generator, cfg: DcnnConfig,
                device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random critic params on ``device``: LeCun-normal weights (fan-in
    C_in x 16 for the convs), zero biases.  Draws do not match the JAX
    package's; parity tests load its params through
    `critic_params_from_numpy`."""
    p: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, want in critic_shapes(cfg).items():
        if key == "head":
            d_flat = want["w"][0]
            p[key] = nn.dense_init(generator, d_flat, 1, cfg.torch_dtype,
                                   bias=True, device=device)
            continue
        k, _, ci, co = want["w"]
        p[key] = {"w": lecun_init(generator, want["w"], cfg.torch_dtype,
                                  fan_in=ci * k * k).to(device),
                  "b": torch.zeros((co,), dtype=cfg.torch_dtype,
                                   device=device)}
    return p


def critic_params_from_numpy(tree, cfg: DcnnConfig,
                             device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's critic params from the JAX package's ``{"c{i}": {"w",
    "b"}, "head": {"w", "b"}}`` as numpy, every shape checked."""
    return _params_from_numpy(tree, critic_shapes(cfg), cfg, device,
                              f"c0..c{len(cfg.layers) - 2}, head")


def critic_apply(p, cfg: DcnnConfig, x: torch.Tensor) -> torch.Tensor:
    """Scores ``(B,)`` of NHWC images ``x``: per conv ``F.conv2d`` (stride
    2, padding 1; cuDNN on the card, TF32 off) on NCHW views of the NHWC
    activations and HWIO weights, then LeakyReLU(0.2); the head flattens
    the features in NHWC order, as the reference does."""
    fp32_exact(x.device)
    n_conv = len([k for k in p if k.startswith("c")])
    h = x.permute(0, 3, 1, 2)
    for i in range(n_conv):
        h = F.conv2d(h, p[f"c{i}"]["w"].permute(3, 2, 0, 1), p[f"c{i}"]["b"],
                     stride=2, padding=1)
        h = F.leaky_relu(h, 0.2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return nn.dense(p["head"], h)[:, 0]
