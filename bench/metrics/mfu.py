"""The model FLOPs of the images served in the traced stretch, over its
seconds, as a share of the card's dense TF32 peak."""
from benchkit.stats import TF32_FLOPS


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    flops = run.trace.images * run.flops_per_image
    return 100.0 * flops / run.trace.window_s / TF32_FLOPS
