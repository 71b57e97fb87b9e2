"""Device time of the host-to-device and device-to-host copies in the
traced stretch, per image served in it."""


def read(run):
    if run.trace is None or run.trace.images == 0:
        return None
    return run.trace.copy_s / run.trace.images * 1e6
