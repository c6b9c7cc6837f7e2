"""launches_per_step: kernel launches by the host (cudaLaunch* calls in
the profiler's trace) per step of the traced slice."""


def read(run):
    t = run.trace
    return t.launches / t.steps if t is not None and t.steps else None
