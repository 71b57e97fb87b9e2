"""The DCNN towers' plain reference, the benchmark's weights and latents,
and the operation and byte counts of the yardstick.

A tower (``dcnn-celeba.json``, ``dcnn-mnist.json``) takes a latent of
``z_dim`` as a 1 x 1 root and runs transposed convolutions: layer ``i``
reads ``x`` (B, C_in, H, W) and writes ``y[b, co, oh, ow] = bias[co] +
sum x[b, ci, ih, iw] * w[kh, kw, ci, co]`` over the taps with ``oh = ih *
stride - padding + kh`` (and ``ow`` alike) inside the output, then ReLU,
or tanh on the last layer.  Images come out NHWC.  Weights are stored as
the program takes them, ``(K, K, C_in, C_out)``.

The reference is ``F.conv_transpose2d`` in float32 with TF32 off; it
imports nothing of the program.  The control computes the same with each
layer's input and weight rounded to TF32 (10 mantissa bits, to nearest
even), the precision below float32 that the tensor cores offer, then
multiplied and summed in float32 as the tensor cores do."""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BIAS_STD = 0.1


def layers(cfg: dict) -> List[dict]:
    """Each layer's sizes with its input and output side."""
    out, hw = [], 1
    for spec in cfg["layers"]:
        k, s, p = spec["kernel"], spec["stride"], spec["padding"]
        o = (hw - 1) * s - 2 * p + k
        out.append({**spec, "in_hw": hw, "out_hw": o})
        hw = o
    if hw != cfg["img_hw"] or out[-1]["c_out"] != cfg["img_c"]:
        raise ValueError(f"{cfg['name']}: the layers give {hw} x {hw} x "
                         f"{out[-1]['c_out']}, not the image's "
                         f"{cfg['img_hw']} x {cfg['img_hw']} x {cfg['img_c']}")
    if out[0]["c_in"] != cfg["z_dim"]:
        raise ValueError(f"{cfg['name']}: layer 0 reads {out[0]['c_in']} "
                         f"channels, the latent has {cfg['z_dim']}")
    return out


def taps_1d(in_size: int, k: int, s: int, p: int, out_size: int) -> int:
    """Pairs (input index, kernel index) whose output index lies inside
    the output along one axis: the taps that padding does not crop."""
    return sum(1 for i in range(in_size) for kk in range(k)
               if 0 <= i * s - p + kk < out_size)


def layer_counts(cfg: dict, batch: int) -> List[Tuple[float, float]]:
    """Per layer, at ``batch`` rows: ``(flops, bytes)``.  FLOPs are twice
    the multiply-adds that land inside the output; bytes read each input,
    weight and bias once and write each output once, in float32."""
    out = []
    for l in layers(cfg):
        t = taps_1d(l["in_hw"], l["kernel"], l["stride"], l["padding"],
                    l["out_hw"])
        macs = batch * t * t * l["c_in"] * l["c_out"]
        elems = (batch * l["in_hw"] ** 2 * l["c_in"]
                 + l["kernel"] ** 2 * l["c_in"] * l["c_out"] + l["c_out"]
                 + batch * l["out_hw"] ** 2 * l["c_out"])
        out.append((2.0 * macs, 4.0 * elems))
    return out


def flops_per_image(cfg: dict) -> float:
    return sum(f for f, _ in layer_counts(cfg, 1))


def make_weights(cfg: dict, seed: int, device) -> List[Tuple[torch.Tensor,
                                                           torch.Tensor]]:
    """Per layer ``(w (K, K, C_in, C_out), bias (C_out,))`` in float32 on
    ``device``, from one draw of a generator on that device.  Weights are
    LeCun-normal over the products that make one output (C_in times the
    mean taps an output gets), so activations keep their scale down the
    tower; biases are N(0, BIAS_STD**2), never all zero, so the kernel's
    fused bias is checked."""
    ls = layers(cfg)
    sizes = [(l["kernel"] ** 2 * l["c_in"] * l["c_out"], l["c_out"])
             for l in ls]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    flat = torch.randn(sum(a + b for a, b in sizes), generator=gen,
                       device=device, dtype=torch.float32)
    out, at = [], 0
    for l, (nw, nb), (flops, _) in zip(ls, sizes, layer_counts(cfg, 1)):
        fan_in = flops / 2.0 / (l["out_hw"] ** 2 * l["c_out"])
        k = l["kernel"]
        w = flat[at:at + nw].view(k, k, l["c_in"], l["c_out"])
        w.mul_(1.0 / math.sqrt(fan_in))
        b = flat[at + nw:at + nw + nb].mul_(BIAS_STD)
        out.append((w, b))
        at += nw + nb
    return out


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def forward(cfg: dict, weights, z: torch.Tensor,
            precision: str = "float32") -> torch.Tensor:
    """Images (B, H, W, C) of latents ``z`` (B, z_dim), in ``precision``:
    ``"float32"`` (the reference) or ``"tf32"`` (the control)."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = z.reshape(z.shape[0], -1, 1, 1).to(torch.float32)
    for l, (w, b) in zip(layers(cfg), weights):
        w = w.permute(2, 3, 0, 1)       # (C_in, C_out, K, K)
        if precision == "tf32":
            x, w = to_tf32(x), to_tf32(w)
        x = F.conv_transpose2d(x, w, b, stride=l["stride"],
                               padding=l["padding"])
        x = torch.tanh(x) if l["activation"] == "tanh" else torch.relu(x)
    return x.permute(0, 2, 3, 1)


def max_abs_err(cfg: dict, weights, z: np.ndarray, images: np.ndarray,
                device, block: int = 256) -> float:
    """The largest ``|images - forward(z)|`` over every value, the float32
    reference run in blocks of ``block`` rows on ``device``."""
    if images.shape[0] != z.shape[0] or not np.isfinite(images).all():
        return math.inf
    worst = 0.0
    with torch.no_grad():
        for i in range(0, z.shape[0], block):
            ref = forward(cfg, weights,
                          torch.from_numpy(z[i:i + block]).to(device))
            got = torch.from_numpy(np.ascontiguousarray(
                images[i:i + block])).to(device)
            if got.shape != ref.shape:
                return math.inf
            worst = max(worst, float((got - ref).abs().max()))
    return worst


def control_images(cfg: dict, weights, z: np.ndarray, device,
                   block: int = 256) -> np.ndarray:
    """The control put in the program's place: the reference in TF32."""
    with torch.no_grad():
        return np.concatenate([
            forward(cfg, weights, torch.from_numpy(z[i:i + block]).to(device),
                    "tf32").cpu().numpy()
            for i in range(0, z.shape[0], block)])
