"""member_steps_per_s: members times the ensemble steps completed, over the
window's wall by the host clock."""


def read(run):
    return run.members * run.steps / run.window_s if run.steps else None
