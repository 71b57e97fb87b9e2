"""Built-in workloads: the two paper WGAN generators plus the edge
workloads the paper motivates DCNN inference with — an ESPCN/FSRCNN-style
x2 super-resolution head and a denoising autoencoder decoder.

The SR head maps a 14x14 low-res digit to its 28x28 reconstruction:
stride-1 feature extraction / nonlinear mapping stages followed by one
strided deconv doing the x2 upsample (the FSRCNN layout, with the final
deconv exactly the paper's accelerable primitive).  The denoiser is the
decoder of a convolutional DAE: a stride-1 hourglass that maps a
noise-corrupted 28x28 digit back to the clean image.  Both are
image-rooted towers (`DcnnConfig.in_hw > 1`) and ride the same kernels,
plans, quantization and serving engine as the generators.  The towers,
names, aliases and synthesizers are the JAX package's
(``repro.workloads.zoo``), so the two packages draw the same pairs.

Training pairs are synthesized from `data.synthetic.digit_images`
(deterministic in the seed, so calibration batches — and therefore
pinned int8 plan hashes — are reproducible)."""
from __future__ import annotations

import numpy as np

from ..data.synthetic import digit_images
from ..models.dcnn import CELEBA_DCNN, MNIST_DCNN, DcnnConfig, DeconvLayerCfg
from .registry import Workload, register

__all__ = ["SR_X2", "DAE_DENOISE", "SR", "DENOISE", "MNIST", "CELEBA"]


# ---------------------------------------------------------------------------
# Super-resolution head: 14x14x1 -> 28x28x1 (x2, FSRCNN-style)
# ---------------------------------------------------------------------------
SR_X2 = DcnnConfig(
    name="sr-espcn-x2",
    z_dim=1,          # unused for image-rooted towers (input is in_hw^2*in_c)
    img_hw=28,
    img_c=1,
    in_hw=14,
    layers=(
        DeconvLayerCfg(1, 32, 5, 1, 2, "relu"),    # 14x14 feature extraction
        DeconvLayerCfg(32, 16, 3, 1, 1, "relu"),   # nonlinear mapping
        DeconvLayerCfg(16, 1, 4, 2, 1, "tanh"),    # 14x14 -> 28x28 upsample
    ),
)


def _sr_pairs(seed: int, n: int):
    """(low-res 14x14 input, clean 28x28 target) pairs: the target is a
    synthetic digit, the input its 2x2 box-downsampled copy."""
    y = np.asarray(digit_images(seed, n, hw=28), np.float32)
    x = y.reshape(n, 14, 2, 14, 2, 1).mean(axis=(2, 4))
    return x, y


def _sr_calib(seed: int, n: int):
    return _sr_pairs(seed, n)[0]


SR = register(Workload(
    name="sr",
    cfg=SR_X2,
    kind="supervised",
    description="FSRCNN-style x2 super-resolution head (14x14 -> 28x28)",
    aliases=("sr-x2", "super-resolution"),
    pair_fn=_sr_pairs,
    calib_fn=_sr_calib,
))


# ---------------------------------------------------------------------------
# Denoising autoencoder decoder: noisy 28x28x1 -> clean 28x28x1
# ---------------------------------------------------------------------------
DAE_DENOISE = DcnnConfig(
    name="dae-denoise",
    z_dim=1,
    img_hw=28,
    img_c=1,
    in_hw=28,
    layers=(
        DeconvLayerCfg(1, 24, 5, 1, 2, "relu"),    # encode to feature maps
        DeconvLayerCfg(24, 8, 3, 1, 1, "relu"),    # channel bottleneck
        DeconvLayerCfg(8, 24, 3, 1, 1, "relu"),    # expand
        DeconvLayerCfg(24, 1, 5, 1, 2, "tanh"),    # reconstruct the image
    ),
)

DENOISE_SIGMA = 0.5


def _denoise_pairs(seed: int, n: int):
    """(noise-corrupted input, clean target) pairs at a fixed Gaussian
    corruption level, both clipped to the image range."""
    y = np.asarray(digit_images(seed, n, hw=28), np.float32)
    rng = np.random.default_rng(seed + 0x5EED)
    x = np.clip(y + DENOISE_SIGMA * rng.standard_normal(
        y.shape, dtype=np.float32), -1.0, 1.0)
    return x, y


def _denoise_calib(seed: int, n: int):
    return _denoise_pairs(seed, n)[0]


DENOISE = register(Workload(
    name="denoise",
    cfg=DAE_DENOISE,
    kind="supervised",
    description="denoising autoencoder decoder (noisy 28x28 -> clean 28x28)",
    aliases=("dae", "denoising"),
    pair_fn=_denoise_pairs,
    calib_fn=_denoise_calib,
))


# ---------------------------------------------------------------------------
# The paper's two WGAN generators, registered under their CLI names
# ---------------------------------------------------------------------------
MNIST = register(Workload(
    name="mnist",
    cfg=MNIST_DCNN,
    kind="generative",
    description="paper Fig.4 MNIST WGAN-GP generator (z100 -> 28x28x1)",
))

CELEBA = register(Workload(
    name="celeba",
    cfg=CELEBA_DCNN,
    kind="generative",
    description="paper Fig.4 CelebA WGAN-GP generator (z100 -> 64x64x3)",
))
