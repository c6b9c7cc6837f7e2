"""step_ms_p95: the 95th percentile over all the window's steps of each
step's wall, read by a pair of CUDA events around the step (the device's
clock; the host's is off by some half a millisecond)."""

import statistics


def read(run):
    t = run.step_times_ms
    return statistics.quantiles(t, n=20)[-1] if len(t) >= 2 else None
