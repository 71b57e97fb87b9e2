"""Device time of the B1 kernel in the traced stretch, per image."""


def read(run):
    if run.trace is None or run.trace.images == 0:
        return None
    return run.trace.main_s / run.trace.images * 1e6
