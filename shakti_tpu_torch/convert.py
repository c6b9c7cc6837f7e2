"""Carry a frozen problem ("weights and state") between the two packages.

:func:`problem_from_numpy` takes shakti_tpu's ``freeze()`` outputs as plain
numpy data (mesh/static/state: dicts field name -> array; cfg: dict of
NewtonConfig fields) and returns this package's Mesh, StaticFields, State
and NewtonConfig on ``device``, lag carry included, in whichever operator
format the JAX mesh carries (bell_*, ell_* or bcsr_* fields, or none: the
matrix-free operator).  An ELL or block-CSR lag carry arrives in the JAX
package's dense layout and becomes the port's structural values
(fem/ell.from_dense).  :func:`state_to_numpy` is the reverse for a State
(with its mesh, for such a carry).  No jax is imported: the caller does the
``np.asarray`` on the JAX side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shakti_tpu_torch.fem.ell import from_dense, to_dense
from shakti_tpu_torch.mesh.mesh import mesh_from_arrays
from shakti_tpu_torch.solve.newton import NewtonConfig
from shakti_tpu_torch.solve.timestep import State, StaticFields
from shakti_tpu_torch.utils.backend import resolve_device

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def _lag_from_numpy(lag, mesh, dtype, dev):
    if lag is None:
        return None
    ok, age, vals, a_diag, A_inv, floor, fage = lag

    def t(a):
        return None if a is None else torch.as_tensor(np.array(a), dtype=dtype,
                                                       device=dev)

    vals = t(vals)
    if mesh.structural:
        vals = from_dense(vals, mesh)
    return (bool(ok), int(age), vals, t(a_diag), t(A_inv), float(floor),
            int(fage))


def problem_from_numpy(mesh: dict, static: dict, state: dict, cfg: dict,
                       device="cpu"):
    """(Mesh, StaticFields, State, NewtonConfig) from numpy dicts."""
    dev = resolve_device(device)
    dtype = _TORCH_DTYPE[np.asarray(mesh["nodes"]).dtype]
    names = {f.name for f in dataclasses.fields(NewtonConfig)}
    ncfg = NewtonConfig(**{k: v for k, v in cfg.items() if k in names})
    m = mesh_from_arrays(mesh, dtype=dtype, device=dev)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    st = StaticFields(
        z_b=t(static["z_b"]), z_s=t(static["z_s"]), G=t(static["G"]),
        inputs=t(static["inputs"]), storage=t(static["storage"]),
        gb0=t(static["gb0"]),
        dirichlet=torch.as_tensor(np.array(static["dirichlet"], bool),
                                  device=dev),
        N_bdry=t(static["N_bdry"]), b_min=t(static["b_min"]),
        b_max=None if static.get("b_max") is None else t(static["b_max"]))
    s = State(N=t(state["N"]), b=t(state["b"]), q=t(state["q"]),
              melt=t(state["melt"]),
              N_prev=None if state.get("N_prev") is None else t(state["N_prev"]),
              lag_op=_lag_from_numpy(state.get("lag_op"), m, dtype, dev))
    return m, st, s, ncfg


def state_to_numpy(state: State, mesh=None) -> dict:
    """dict field name -> numpy array (lag_op as a tuple of numpy/python
    values), the layout problem_from_numpy reads; ``mesh`` is required for
    an ELL or block-CSR lag carry (written in the JAX package's layout; the
    call raises without it)."""
    def a(x):
        return None if x is None else x.detach().cpu().numpy()

    out = {k: a(getattr(state, k)) for k in ("N", "b", "q", "melt", "N_prev")}
    lag = state.lag_op
    if lag is not None and mesh is None and lag[2].dim() != 4:
        raise ValueError("state_to_numpy: an ELL or block-CSR lag carry "
                         f"(values of shape {tuple(lag[2].shape)}) needs its "
                         "mesh")
    if lag is not None and mesh is not None and mesh.structural:
        lag = lag[:2] + (to_dense(lag[2], mesh),) + lag[3:]
    out["lag_op"] = None if lag is None else (
        np.asarray(lag[0]), np.asarray(lag[1]), a(lag[2]), a(lag[3]),
        a(lag[4]), np.asarray(lag[5]), np.asarray(lag[6]))
    return out
