"""step_ms: the window's wall by the host clock over the hourly steps it
completed."""


def read(run):
    return 1e3 * run.window_s / run.steps if run.steps else None
