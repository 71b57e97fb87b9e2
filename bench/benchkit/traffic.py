"""The one traffic generator: a mix's data file in, request sizes out.

A mix is a closed loop of ``clients`` callers (one, so far), each calling
the system again as soon as its images are back, as an offline or edge
caller that waits for them does.  ``rows`` says how many latents a request
carries:

* ``{"kind": "fixed", "value": n}`` -- every request ``n`` rows;
* ``{"kind": "log_uniform", "low": a, "high": b, "cycle": m}`` -- ``m``
  sizes at the quantiles ``(j + 1/2) / m`` of a log-uniform law over the
  whole numbers ``a..b``.

Every seed gets the same multiset of sizes, in an order of its own, so the
seed changes the order and the values of the work, never its amount.  The
window walks the cycle round and round.  Each request takes its latents
from a pool drawn from the seed, as the contiguous rows after the previous
request's (wrapping before the pool's end), so a request's inputs are
known from its offset and size alone."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

KINDS = ("fixed", "log_uniform")


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream ``stream`` of ``seed`` (any whole number;
    negative ones are taken modulo 2**64)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def _log_uniform(low: int, high: int, cycle: int) -> np.ndarray:
    if not 1 <= low <= high or cycle < 1:
        raise ValueError(f"log_uniform needs 1 <= low <= high and cycle >= 1, "
                         f"got low={low} high={high} cycle={cycle}")
    span = math.log(high + 1) - math.log(low)
    sizes = [math.floor(low * math.exp(span * (j + 0.5) / cycle))
             for j in range(cycle)]
    return np.minimum(np.asarray(sizes, np.int64), high)


def request_cycle(traffic: dict, seed: int) -> np.ndarray:
    """The sizes of one cycle of requests, in this seed's order."""
    if traffic.get("loop", "closed") != "closed" or traffic.get(
            "clients", 1) != 1:
        raise ValueError("the generator drives one closed-loop client; the "
                         f"mix asks for loop={traffic.get('loop')!r}, "
                         f"clients={traffic.get('clients')!r}")
    rows = traffic["rows"]
    if rows["kind"] == "fixed":
        sizes = np.asarray([int(rows["value"])], np.int64)
    elif rows["kind"] == "log_uniform":
        sizes = _log_uniform(int(rows["low"]), int(rows["high"]),
                             int(rows["cycle"]))
    else:
        raise ValueError(f"unknown rows kind {rows['kind']!r}; expected one "
                         f"of {KINDS}")
    if sizes.min() < 1:
        raise ValueError(f"a request of {sizes.min()} rows")
    return rng(seed, 1).permutation(sizes)


def latent_pool(seed: int, rows: int, width: int) -> np.ndarray:
    """``rows`` latents N(0, 1) of ``width``, float32, on the host."""
    return rng(seed, 2).standard_normal((rows, width), dtype=np.float32)


def next_offset(offset: int, size: int, pool_rows: int, max_size: int) -> int:
    """Where the request after one of ``size`` rows at ``offset`` starts."""
    return (offset + size) % (pool_rows - max_size + 1)


def pool_shape(traffic: dict, sizes: np.ndarray) -> Tuple[int, int]:
    """``(pool rows, largest request)``; the pool holds a few requests."""
    pool_rows = int(traffic["pool_rows"])
    if pool_rows < 2 * int(sizes.max()):
        raise ValueError(f"pool_rows={pool_rows} holds fewer than two of the "
                         f"largest requests ({int(sizes.max())} rows)")
    return pool_rows, int(sizes.max())
