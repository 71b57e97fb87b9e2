"""The B1 launches' roofline bound, summed over the stretch's launches at
each dispatch's bucket, over B1's device time there (the yardstick's
counts and peaks: TF32 rate and HBM bandwidth)."""


def read(run):
    if run.trace is None or not run.trace.main_s or run.bound_s is None:
        return None
    return 100.0 * run.bound_s / run.trace.main_s
