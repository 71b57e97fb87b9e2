"""Request statistics and the yardstick's peaks.

Every end-to-end number is taken over all requests and all the time of
the window, never as a median of chunks."""
from __future__ import annotations

import math
from typing import Sequence

# NVIDIA's published dense rates for one H100 SXM at its 700 W limit.  No
# float32-exact scheme on this card runs faster than TF32 on the tensor
# cores, so a float32 share of this rate cannot pass 100 %.
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the TF32 peak and the bytes over the HBM peak."""
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def quantile(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile of all ``values``, linearly interpolated between
    the two nearest ranks (rank ``q * (n - 1)``)."""
    if not values:
        raise ValueError("quantile of no values")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must lie in [0, 1], got {q}")
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
