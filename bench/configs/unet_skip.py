"""The pix2pix U-Net generator's plain reference, the benchmark's weights,
and the operation and byte counts of the yardstick.

Isola et al., arXiv:1611.07004, Appendix 6.1.1 (``unet_256``): blocks
l = 1 (outermost) .. L = ``num_downs``; every conv 4 x 4, stride 2,
padding 1, no bias; LReLU slope ``slope``:

    h_1 = conv_1(x_1),  h_l = conv_l(LReLU(x_l))          (l >= 2)
    x_{l+1} = IN_l(h_l) for 2 <= l <= L-1, else h_l
    s_{L+1} = x_{L+1};  u_l = IN'_l(convT_l(ReLU(s_{l+1})))
    s_l = cat_C(LReLU(x_l), u_l)                           (l = L .. 2)
    y = tanh(convT_1(ReLU(s_2)) + b)

IN is each image's channel over its own H x W, biased variance, ``eps``,
with a gamma and beta per channel (pix2pix's BatchNorm at batch 1);
dropout is left out.  Channels of conv_l: ngf * min(2^(l-1), 8).  A row of
the harness's pool (``z_dim`` = H * W * C_in values) is one NHWC image.
Weights are stored as the program takes them: HWIO ``(4, 4, C_in,
C_out)``, under ``d{l}``, ``u{l}``; ``n{l}`` / ``m{l}`` hold ``g``, ``b``.

The reference is ``F.conv2d`` / ``F.conv_transpose2d`` in float32 with
TF32 off; it imports nothing of the program.  The control rounds every
conv's input and weight to TF32 (10 mantissa bits, to nearest even), the
precision below float32 that the tensor cores offer.

The yardstick counts the model's own work, whatever implements it: per B1
launch (conv_1 .. conv_L, then convT_L .. convT_1) twice the
multiply-adds that read inside the input and land inside the output, and
the bytes of reading its input, weight and bias once and writing its
output once; per launch of the norm kernel (the image's space-to-depth,
h_1, the normalised maps in launch order) the bytes of reading its map
and the affine once and writing every place it fills."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

W_STD = 0.02      # pix2pix's init_weights: N(0, 0.02)
G_STD = 0.02      # gamma ~ N(1, 0.02)
B_STD = 0.1       # beta and the head's bias, so the fused paths are checked
BLOCK = 16        # rows of the reference at a time


def channels(cfg: dict) -> List[int]:
    return [cfg["ngf"] * min(1 << i, 8) for i in range(cfg["num_downs"])]


def shapes(cfg: dict) -> Dict[str, Dict[str, tuple]]:
    ch, big_l = channels(cfg), cfg["num_downs"]
    out: Dict[str, Dict[str, tuple]] = {}
    c_in = cfg["in_c"]
    for l in range(1, big_l + 1):
        out[f"d{l}"] = {"w": (4, 4, c_in, ch[l - 1])}
        if 2 <= l <= big_l - 1:
            out[f"n{l}"] = {"g": (ch[l - 1],), "b": (ch[l - 1],)}
        c_in = ch[l - 1]
    for l in range(big_l, 1, -1):
        cin = ch[l - 1] * (1 if l == big_l else 2)
        out[f"u{l}"] = {"w": (4, 4, cin, ch[l - 2])}
        out[f"m{l}"] = {"g": (ch[l - 2],), "b": (ch[l - 2],)}
    out["u1"] = {"w": (4, 4, 2 * ch[0], cfg["out_c"]), "b": (cfg["out_c"],)}
    return out


def _taps_conv(in_size: int, out_size: int) -> int:
    """Pairs (output, kernel index) of a 4 x 4 / 2 / 1 conv along one axis
    whose input index lies inside the input."""
    return sum(1 for o in range(out_size) for k in range(4)
               if 0 <= 2 * o - 1 + k < in_size)


def _taps_convt(in_size: int, out_size: int) -> int:
    """Pairs (input, kernel index) of a 4 x 4 / 2 / 1 transposed conv
    along one axis whose output index lies inside the output."""
    return sum(1 for i in range(in_size) for k in range(4)
               if 0 <= 2 * i - 1 + k < out_size)


def convs(cfg: dict) -> List[dict]:
    """Each conv of the model in launch order: encoder, then decoder."""
    ch, big_l = channels(cfg), cfg["num_downs"]
    out, hw, c_in = [], cfg["in_hw"], cfg["in_c"]
    for l in range(1, big_l + 1):
        out.append({"up": False, "in_hw": hw, "out_hw": hw // 2,
                    "c_in": c_in, "c_out": ch[l - 1], "bias": 0})
        hw, c_in = hw // 2, ch[l - 1]
    for l in range(big_l, 0, -1):
        cin = ch[l - 1] * (1 if l == big_l else 2)
        cout = cfg["out_c"] if l == 1 else ch[l - 2]
        out.append({"up": True, "in_hw": hw, "out_hw": 2 * hw, "c_in": cin,
                    "c_out": cout, "bias": cout if l == 1 else 0})
        hw *= 2
    return out


def layer_counts(cfg: dict, batch: int) -> List[Tuple[float, float]]:
    """Per B1 launch, at ``batch`` rows: ``(flops, bytes)`` in float32."""
    out = []
    for c in convs(cfg):
        taps = (_taps_convt if c["up"] else _taps_conv)(c["in_hw"],
                                                       c["out_hw"])
        macs = batch * taps * taps * c["c_in"] * c["c_out"]
        elems = (batch * c["in_hw"] ** 2 * c["c_in"]
                 + 16 * c["c_in"] * c["c_out"] + c["bias"]
                 + batch * c["out_hw"] ** 2 * c["c_out"])
        out.append((2.0 * macs, 4.0 * elems))
    return out


def flops_per_image(cfg: dict) -> float:
    return sum(f for f, _ in layer_counts(cfg, 1))


def norm_bytes(cfg: dict, batch: int) -> List[float]:
    """Per launch of the norm kernel, in launch order, at ``batch`` rows:
    the image's space-to-depth (read, one write), h_1 (read, two writes),
    x_3 .. x_L (read with the affine, two writes), u_L .. u_2 (read with
    the affine, one write)."""
    ch, big_l, hw = channels(cfg), cfg["num_downs"], cfg["in_hw"]
    out = [4.0 * 2 * batch * hw * hw * cfg["in_c"]]
    for l in range(1, big_l):
        hw //= 2
        m = batch * hw * hw * ch[l - 1]
        affine = 0 if l == 1 else 2 * ch[l - 1]
        out.append(4.0 * (3 * m + affine))
    for l in range(big_l, 1, -1):
        hw = cfg["in_hw"] >> (l - 1)
        c = ch[l - 2]
        out.append(4.0 * (2 * batch * hw * hw * c + 2 * c))
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, Dict[str,
                                                                torch.Tensor]]:
    """The params in the program's layout, float32 on ``device``, from one
    draw of a generator on that device: weights N(0, W_STD), gamma
    N(1, G_STD), beta and the head's bias N(0, B_STD)."""
    sh = shapes(cfg)
    sizes = [(key, name, shape, math.prod(shape))
             for key in sh for name, shape in sh[key].items()]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    flat = torch.randn(sum(s[3] for s in sizes), generator=gen,
                       device=device, dtype=torch.float32)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    for key, name, shape, n in sizes:
        v = flat[at:at + n].view(shape)
        if name == "w":
            v.mul_(W_STD)
        elif name == "g":
            v.mul_(G_STD).add_(1.0)
        else:
            v.mul_(B_STD)
        out.setdefault(key, {})[name] = v
        at += n
    return out


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _instance_norm(x, g, b, eps):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((x - mean) / torch.sqrt(var + eps) * g.view(1, -1, 1, 1)
            + b.view(1, -1, 1, 1))


def forward(cfg: dict, weights, x: torch.Tensor,
            precision: str = "float32") -> torch.Tensor:
    """Images (B, H, W, out_c) of rows ``x`` (B, H * W * in_c or NHWC), in
    ``precision``: ``"float32"`` (the reference) or ``"tf32"`` (the
    control)."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hw, big_l = cfg["in_hw"], cfg["num_downs"]
    eps, slope = cfg["eps"], cfg["slope"]
    rnd = to_tf32 if precision == "tf32" else (lambda t: t)

    def conv(v, w):
        return F.conv2d(rnd(v), rnd(w.permute(3, 2, 0, 1)), stride=2,
                        padding=1)

    def convt(v, w, bias=None):
        return F.conv_transpose2d(rnd(v), rnd(w.permute(2, 3, 0, 1)), bias,
                                  stride=2, padding=1)

    p = weights
    x = x.reshape(x.shape[0], hw, hw, cfg["in_c"]).permute(0, 3, 1, 2)
    h = conv(x.float(), p["d1"]["w"])
    skips = []
    for l in range(2, big_l + 1):
        xl = h if l == 2 else _instance_norm(h, p[f"n{l - 1}"]["g"],
                                             p[f"n{l - 1}"]["b"], eps)
        a = F.leaky_relu(xl, slope)
        skips.append(a)
        h = conv(a, p[f"d{l}"]["w"])
    s = h
    for l in range(big_l, 1, -1):
        u = _instance_norm(convt(torch.relu(s), p[f"u{l}"]["w"]),
                           p[f"m{l}"]["g"], p[f"m{l}"]["b"], eps)
        s = torch.cat([skips[l - 2], u], dim=1)
    y = torch.tanh(convt(torch.relu(s), p["u1"]["w"], p["u1"]["b"]))
    return y.permute(0, 2, 3, 1)


def max_abs_err(cfg: dict, weights, z: np.ndarray, images: np.ndarray,
                device, block: int = BLOCK) -> float:
    """The largest ``|images - forward(z)|`` over every value, the float32
    reference run in blocks of ``block`` rows on ``device``; inf on a
    count, shape or non-finite value that does not fit."""
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
                   block: int = BLOCK) -> np.ndarray:
    """The control put in the program's place: the reference in TF32."""
    with torch.no_grad():
        return np.concatenate([
            forward(cfg, weights, torch.from_numpy(z[i:i + block]).to(device),
                    "tf32").cpu().numpy()
            for i in range(0, z.shape[0], block)])
