"""The pix2pix U-Net generator ``unet_256`` in plain torch: the reference
that the port's U-Net (`models.unet`) is compared with.

Isola et al., "Image-to-Image Translation with Conditional Adversarial
Networks" (arXiv:1611.07004), Appendix 6.1.1; its code's
``UnetGenerator`` / ``UnetSkipConnectionBlock``.  Blocks l = 1 (outermost)
.. L (innermost), every conv 4 x 4, stride 2, padding 1, no bias:

    h_1 = conv_1(x_1),  h_l = conv_l(LReLU_0.2(x_l))      (l >= 2)
    x_{l+1} = IN_l(h_l) for 2 <= l <= L-1, else h_l
    s_{L+1} = x_{L+1};  u_l = IN'_l(convT_l(ReLU(s_{l+1})))
    s_l = cat_C(LReLU_0.2(x_l), u_l)                       (l = L .. 2)
    y = tanh(convT_1(ReLU(s_2)) + b)

Departures from the published model, both deliberate:

* dropout (0.5, kept at test time in blocks L-3 .. L-1 as pix2pix's noise)
  is left out, so the function is deterministic and can be compared;
* the normalisation is instance normalisation with BatchNorm's affine:
  each image's channel over its own H x W, biased variance, eps 1e-5
  (pix2pix tests its BatchNorm in train mode at batch 1, which is this).

``F.conv2d`` and ``F.conv_transpose2d`` in float32, with TF32 off for
matrix products and cuDNN.  Params as `models.unet` keeps them: HWIO
weights ``(4, 4, C_in, C_out)`` under ``d{l}`` / ``u{l}``, ``{"g", "b"}``
under ``n{l}`` / ``m{l}``, the head's bias ``u1.b``; images NHWC.  This
file imports nothing of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def instance_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """NCHW ``x`` normalised per image and channel over H x W."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((x - mean) / torch.sqrt(var + eps) * g.view(1, -1, 1, 1)
            + b.view(1, -1, 1, 1))


def unet_reference(p, x: torch.Tensor, num_downs: int, eps: float = 1e-5,
                   slope: float = 0.2) -> torch.Tensor:
    """Images ``x`` (B, H, W, C_in) -> (B, H, W, C_out) in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def conv(v, w):
        return F.conv2d(v, w.permute(3, 2, 0, 1), stride=2, padding=1)

    def convt(v, w, bias=None):
        return F.conv_transpose2d(v, w.permute(2, 3, 0, 1), bias, stride=2,
                                  padding=1)

    def lrelu(v):
        return F.leaky_relu(v, slope)

    h = conv(x.permute(0, 3, 1, 2).float(), p["d1"]["w"])
    skips = []
    for l in range(2, num_downs + 1):
        xl = h if l == 2 else instance_norm(h, p[f"n{l - 1}"]["g"],
                                            p[f"n{l - 1}"]["b"], eps)
        skips.append(lrelu(xl))
        h = conv(lrelu(xl), p[f"d{l}"]["w"])
    s = h
    for l in range(num_downs, 1, -1):
        u = instance_norm(convt(torch.relu(s), p[f"u{l}"]["w"]),
                          p[f"m{l}"]["g"], p[f"m{l}"]["b"], eps)
        s = torch.cat([skips[l - 2], u], dim=1)
    y = torch.tanh(convt(torch.relu(s), p["u1"]["w"], p["u1"]["b"]))
    return y.permute(0, 2, 3, 1)
