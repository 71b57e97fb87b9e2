"""The serve engine's own host spans over a traced stretch, as the
program's tracer (`repro_torch.obs.trace`) holds them (the engine metrics'
adapter to the program, beside `dcnn_serve`): `dcnn_serve`'s
`spans_on` clears the tracer when the stretch starts and `spans_off`
stops it when it ends, so what it holds is that stretch and nothing else.

A stretch is vouched for only when the tracer counts what its ring pushed
out (a program whose tracer does not records no span tree either), nothing
was pushed out, and it holds one ``dispatch b{n}`` span for each of the
stretch's dispatches."""
from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple


def span_sums(run) -> Optional[Tuple[Dict[str, float], int]]:
    """``(microseconds summed by span name, dispatches)`` over the traced
    stretch, or None where there is none or it cannot be vouched for."""
    if run.trace is None:
        return None
    from repro_torch.obs import trace

    tracer = trace.get_tracer()
    dropped = getattr(tracer, "dropped", None)
    if dropped is None or dropped > 0:
        return None
    sums: Dict[str, float] = collections.defaultdict(float)
    dispatches = 0
    for e in tracer.events():
        if e["ph"] != "X":
            continue
        dispatches += e["name"].startswith("dispatch b")
        sums[e["name"]] += e["dur"]
    if dispatches == 0 or dispatches != len(run.trace.dispatches):
        return None
    return sums, dispatches
