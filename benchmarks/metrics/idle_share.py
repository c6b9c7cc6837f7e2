"""idle_share: the share of the traced slice in which no kernel, copy or
fill ran on the device, in %."""


def read(run):
    t = run.trace
    if t is None or not t.records or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
