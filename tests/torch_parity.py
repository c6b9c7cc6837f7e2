"""Helpers for the parity tests between shakti_tpu (JAX) and
shakti_tpu_torch: frozen JAX dataclasses -> dicts of numpy arrays, the form
shakti_tpu_torch.convert.problem_from_numpy reads.

Every port test file imports this module, which pins torch's intra-op
threads to the worker's share of the cores: under pytest-xdist each worker
would otherwise start a pool of one thread per core, and six such pools on
the same cores (beside XLA's) make the port's small-mesh tests several
times slower than alone."""

import dataclasses
import os

import numpy as np
import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def to_numpy(obj) -> dict:
    """Dataclass of jax arrays -> dict field name -> numpy array (None and
    non-array fields dropped; a lag_op tuple keeps its slots)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, str) or f.name in ("mg", "halo"):
            continue
        if f.name == "lag_op":
            out[f.name] = tuple(None if a is None else np.asarray(a) for a in v)
        else:
            out[f.name] = np.asarray(v)
    return out


def frozen_to_numpy(mesh, static, state, cfg):
    """shakti_tpu freeze() outputs -> problem_from_numpy arguments."""
    return (to_numpy(mesh), to_numpy(static), to_numpy(state),
            dataclasses.asdict(cfg))


def rel_err(got, ref):
    """max |got - ref| / max |ref| (max |ref| = 0 -> absolute)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max() or 1.0
    return float(np.abs(got - ref).max() / scale)
