"""cg_per_step: mean Krylov iterations per step over the window's steps
(an ensemble's over its members too), from the step's diagnostics."""


def read(run):
    return float(run.diag["cg_iters"].mean()) if run.steps else None
