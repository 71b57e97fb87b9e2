"""The one timebase for the serve stack.

Before this module existed the engine timed dispatches with
``time.perf_counter`` while the frontend stamped deadlines with
``time.monotonic`` — two clocks that happen to agree on Linux but are
not guaranteed to share an epoch or a rate anywhere else.  Spans,
dispatch timings, queue deadlines, and heartbeat windows all flow
through :func:`now` so every duration and every deadline comparison is
taken on a single monotonic timebase.

``perf_counter`` is the choice: it is monotonic (safe for deadlines)
and is the highest-resolution clock Python exposes (what Table II's
run-to-run CV actually needs).
"""
from __future__ import annotations

import time


def now() -> float:
    """Seconds on the process-wide monotonic timebase.

    Only differences and comparisons between two :func:`now` values are
    meaningful; the epoch is arbitrary.
    """
    return time.perf_counter()
