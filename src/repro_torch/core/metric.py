"""The paper's sparsity operating-point metric (Eq. 6).

    M(p) = (d0 / dp) * (t0 / tp)

where (t0, d0) are latency / MMD of the dense network and (tp, dp) of the
pruned network.  Latency drops with sparsity (zero-skipping) while MMD rises,
so M is concave with an interior peak — the sparsity balancing image quality
against execution time (paper Fig. 6)."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def quality_speed_metric(
    t0: float, d0: float, tp: Sequence[float], dp: Sequence[float]
) -> np.ndarray:
    tp = np.asarray(tp, dtype=np.float64)
    dp = np.asarray(dp, dtype=np.float64)
    return (d0 / dp) * (t0 / tp)


def optimal_sparsity(
    sparsities: Sequence[float],
    t0: float,
    d0: float,
    tp: Sequence[float],
    dp: Sequence[float],
) -> Tuple[float, np.ndarray]:
    """Returns (argmax sparsity, metric curve)."""
    m = quality_speed_metric(t0, d0, tp, dp)
    idx = int(np.argmax(m))
    return float(np.asarray(sparsities)[idx]), m
