"""Helpers for the parity tests between shakti_tpu (JAX) and
shakti_tpu_torch: frozen JAX dataclasses -> dicts of numpy arrays, the form
shakti_tpu_torch.convert.problem_from_numpy reads."""

import dataclasses

import numpy as np


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
