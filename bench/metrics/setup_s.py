"""Seconds from the start of the run to the start of the window: imports,
the card, weights, build and warm-up of every bucket the traffic uses."""


def read(run):
    return run.setup_s
