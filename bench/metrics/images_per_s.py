"""Images returned to the host in the window, over the window's seconds."""


def read(run):
    return run.images / run.window_s
