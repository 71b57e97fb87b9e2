"""Maximum Mean Discrepancy (paper §V-C) with the Gaussian kernel.

The JAX package's ``repro.core.mmd`` in torch: k(x,x') = exp(-||x-x'||^2 /
(2 sigma^2)) with sigma the median pairwise distance between the
ground-truth samples (the median heuristic the paper references)."""
from __future__ import annotations

from typing import Optional

import torch


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a2 = torch.sum(a * a, dim=1)[:, None]
    b2 = torch.sum(b * b, dim=1)[None, :]
    return torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)


def median_bandwidth(x: torch.Tensor) -> torch.Tensor:
    """Median euclidean distance between ground-truth samples (off-diagonal).
    The median of an even count is the mean of the two middle values, as
    ``jnp.median`` takes it (``torch.median`` would take the lower)."""
    d2 = _sq_dists(x, x)
    n = x.shape[0]
    i, j = torch.triu_indices(n, n, offset=1, device=x.device)
    return torch.sqrt(torch.quantile(d2[i, j], 0.5))


def mmd2(
    x: torch.Tensor,
    y: torch.Tensor,
    bandwidth: Optional[torch.Tensor] = None,
    unbiased: bool = True,
) -> torch.Tensor:
    """Squared MMD between sample sets x ~ P_g (ground truth) and
    y ~ P_theta; x, y: (n, ...) / (m, ...) samples, flattened here."""
    x = x.reshape(x.shape[0], -1).float()
    y = y.reshape(y.shape[0], -1).float()
    sigma = median_bandwidth(x) if bandwidth is None else bandwidth
    gamma = 1.0 / (2.0 * sigma ** 2 + 1e-12)
    kxx = torch.exp(-gamma * _sq_dists(x, x))
    kyy = torch.exp(-gamma * _sq_dists(y, y))
    kxy = torch.exp(-gamma * _sq_dists(x, y))
    n, m = x.shape[0], y.shape[0]
    if unbiased:
        exx = (kxx.sum() - torch.trace(kxx)) / (n * (n - 1))
        eyy = (kyy.sum() - torch.trace(kyy)) / (m * (m - 1))
    else:
        exx = kxx.mean()
        eyy = kyy.mean()
    exy = kxy.mean()
    return exx + eyy - 2.0 * exy


def mmd(x: torch.Tensor, y: torch.Tensor,
        bandwidth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MMD distance (non-negative sqrt of the clipped squared estimate)."""
    return torch.sqrt(torch.clamp(mmd2(x, y, bandwidth), min=0.0))
