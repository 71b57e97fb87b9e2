"""The serve engine's device-wide synchronise before each dispatch's timed
window (its ``sync`` spans), summed over the traced stretch, per
dispatch."""
from benchkit import spec


def read(run):
    got = spec.load_module("systems", "engine_spans").span_sums(run)
    if got is None:
        return None
    sums, dispatches = got
    return sums["sync"] / dispatches
