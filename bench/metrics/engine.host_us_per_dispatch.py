"""The serve engine thread's time in the traced stretch when it is not
waiting on its own stream, per dispatch: the summed ``generate`` spans
less the summed ``wait`` spans (locks, the synchronise before each
dispatch, staging, the enqueue, the bookkeeping and putting images
together all count)."""
from benchkit import spec


def read(run):
    got = spec.load_module("systems", "engine_spans").span_sums(run)
    if got is None:
        return None
    sums, dispatches = got
    return (sums["generate"] - sums["wait"]) / dispatches
