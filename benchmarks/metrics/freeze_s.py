"""freeze_s: the host clock around api/model.ModelSetup.freeze (RCB order,
operator plans, the mg hierarchy), ending in a synchronize."""


def read(run):
    return run.freeze_s
