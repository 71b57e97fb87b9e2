"""The 95th percentile of every request's latency in the window, from the
call to its images on the host."""
from benchkit.stats import quantile


def read(run):
    return quantile(run.latencies_s, 0.95) * 1e3
