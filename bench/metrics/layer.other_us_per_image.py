"""Device time of every operation but the main kernel and the host-device
copies (pads, crops, casts, copies within the device) in the traced
stretch, per image."""


def read(run):
    if run.trace is None or run.trace.images == 0:
        return None
    return run.trace.other_s / run.trace.images * 1e6
