"""Synthetic datasets (offline container: no MNIST/CelebA downloads).

The paper's evaluation targets are throughput/power and distribution-level
quality (MMD) — not label accuracy — so structured synthetic distributions
suffice: procedural "digit stroke" images for the MNIST stand-in and smooth
"face blob" compositions for CelebA, both deterministic functions of a seed.
Token streams for LM training come from a mixture of Zipfian unigrams with
injected bigram structure so the loss has learnable signal.
"""
from __future__ import annotations

import numpy as np


def digit_images(seed: int, n: int, hw: int = 28) -> np.ndarray:
    """(n, hw, hw, 1) float32 in [-1, 1] — randomized stroke patterns."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    imgs = np.zeros((n, hw, hw, 1), np.float32)
    for i in range(n):
        img = np.zeros((hw, hw), np.float32)
        for _ in range(rng.randint(2, 5)):  # a few strokes
            x0, y0 = rng.rand(2)
            x1, y1 = rng.rand(2)
            t = np.linspace(0, 1, 40)[:, None]
            pts = np.stack([x0 + (x1 - x0) * t[:, 0], y0 + (y1 - y0) * t[:, 0]], 1)
            for px, py in pts:
                d2 = (xx - px) ** 2 + (yy - py) ** 2
                img += np.exp(-d2 / 0.004)
        img = np.clip(img, 0, 1.5) / 1.5
        imgs[i, :, :, 0] = img * 2 - 1
    return imgs


def face_images(seed: int, n: int, hw: int = 64) -> np.ndarray:
    """(n, hw, hw, 3) float32 in [-1, 1] — smooth blob compositions."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    imgs = np.zeros((n, hw, hw, 3), np.float32)
    for i in range(n):
        img = np.zeros((hw, hw, 3), np.float32)
        base = rng.rand(3) * 0.6 + 0.2
        img += base  # skin-tone-ish base
        for _ in range(rng.randint(3, 7)):  # features as gaussian blobs
            cx, cy = rng.rand(2) * 0.6 + 0.2
            sig = rng.rand() * 0.05 + 0.01
            col = rng.rand(3)
            g = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig))
            img += g[:, :, None] * (col - base) * 0.8
        imgs[i] = np.clip(img, 0, 1) * 2 - 1
    return imgs


def token_stream(seed: int, n_tokens: int, vocab: int) -> np.ndarray:
    """Zipfian unigrams + deterministic bigram successor structure."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    base = rng.choice(vocab, size=n_tokens, p=probs)
    # bigram structure: with p=0.5, token t+1 = f(token t)
    succ = rng.permutation(vocab)
    follow = rng.rand(n_tokens) < 0.5
    out = base.copy()
    out[1:][follow[1:]] = succ[out[:-1][follow[1:]]]
    return out.astype(np.int32)
