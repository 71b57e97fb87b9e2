"""Rows padded to fill a bucket, as a share of all rows computed in the
window (the engine's ``padded_images`` and ``images`` counters)."""


def read(run):
    c = run.counters
    total = c["images"] + c["padded_images"]
    if run.trace is None or total == 0:
        return None
    return 100.0 * c["padded_images"] / total
