"""setup_s: process start to the first timed step (imports, mesh, freeze,
hierarchy, kernel build or load, warm-up)."""


def read(run):
    return run.setup_s
