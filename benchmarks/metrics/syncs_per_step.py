"""syncs_per_step: host syncs (aten::_local_scalar_dense, a value read
back to the host) per step of the traced slice."""


def read(run):
    t = run.trace
    return t.syncs / t.steps if t is not None and t.steps else None
