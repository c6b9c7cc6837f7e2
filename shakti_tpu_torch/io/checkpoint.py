"""Checkpoint / resume: the port of shakti_tpu/io/checkpoint.py.

A checkpoint is the full marching state plus the loop counters, so a run
continues where it stopped.  The file, ``checkpoint.npz``, has the JAX
package's keys and dtypes, so either package resumes the other's:

    N b q melt N_prev          state arrays in the marching dtype
    n_nodes next_step next_row int64
    mesh_crc                   uint32 (:func:`mesh_fingerprint`)
    lag_ok                     bool          } the carried operator
    lag_age lag_floor_age      int32         } (State.lag_op), when it is
    lag_vals lag_adiag lag_Ainv lag_floor    } saved; lag_Ainv only with a
                                               two-level coarse inverse

The port's lag tuple holds Python scalars where the JAX package holds 0-d
arrays (ok, age, floor, floor_age); they are mapped on save and load.  For
ELL and block-CSR the port carries the structural values (W, n)
(fem/ell.py); ``lag_vals`` keeps the JAX package's layout ((n, K) rows,
(nnzb, B, B) blocks): given the mesh, :func:`save_state` scatters them
(fem/ell.to_dense) and :func:`load_state` gathers them back
(fem/ell.from_dense).  Without the mesh both raise on such a carry (only a
block-ELL carry, four-dimensional, is the same in file and memory).
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from shakti_tpu_torch.fem.ell import dense_shape, from_dense, to_dense
from shakti_tpu_torch.solve.timestep import State

CHECKPOINT_FILE = "checkpoint.npz"


def mesh_fingerprint(nodes) -> int:
    """crc32 of the node coordinates (float64, the caller's order): a resume
    into the results of another mesh fails instead of misassigning nodal
    state."""
    a = np.ascontiguousarray(np.asarray(nodes, dtype=np.float64))
    return zlib.crc32(a.tobytes()) & 0xFFFFFFFF


def _np(t):
    return t.detach().cpu().numpy()


def _need_mesh(vals, who):
    """Raise for lag values that are not block-ELL's (NB, KB, B, B): an ELL
    or block-CSR carry differs between file and memory, and only the mesh
    maps one to the other."""
    if vals.dim() != 4:
        raise ValueError(
            f"{who}: an ELL or block-CSR lag carry (values of shape "
            f"{tuple(vals.shape)}) needs mesh=; without it the file would "
            "not hold the layout either package resumes")


def save_state(results_dir: str, state: State, next_step: int, next_row: int,
               fingerprint: int | None = None, include_lag: bool = True,
               mesh=None):
    """Write ``checkpoint.npz`` atomically.  ``include_lag=False`` omits the
    carried operator (a recomputable cache that dominates the volume): the
    run layer's rolling checkpoints leave it out, its final one keeps it, so
    a planned resume replays bit for bit.  ``mesh``: the state's mesh,
    required to write an ELL or block-CSR carry in the file's layout."""
    path = os.path.join(results_dir, CHECKPOINT_FILE)
    tmp = path + ".tmp.npz"
    dtype = _np(state.N).dtype
    extra = {}
    if fingerprint is not None:
        extra["mesh_crc"] = np.uint32(fingerprint)
    if state.lag_op is not None and include_lag:
        ok, age, vals, a_diag, A_inv, floor, fage = state.lag_op
        if mesh is None:
            _need_mesh(vals, "save_state")
        elif mesh.structural:
            vals = to_dense(vals, mesh)
        extra.update(lag_ok=np.asarray(bool(ok)),
                     lag_age=np.asarray(int(age), np.int32),
                     lag_vals=_np(vals), lag_adiag=_np(a_diag),
                     lag_floor=np.asarray(floor, dtype),
                     lag_floor_age=np.asarray(int(fage), np.int32))
        if A_inv is not None:
            extra["lag_Ainv"] = _np(A_inv)
    N_prev = state.N if state.N_prev is None else state.N_prev
    np.savez(tmp, N=_np(state.N), b=_np(state.b), q=_np(state.q),
             melt=_np(state.melt), N_prev=_np(N_prev),
             n_nodes=np.int64(state.N.shape[-1]),
             next_step=np.int64(next_step), next_row=np.int64(next_row),
             **extra)
    os.replace(tmp, path)


def load_state(results_dir: str, dtype=torch.float32, device="cpu",
               fingerprint: int | None = None, mesh=None):
    """Returns (state, next_step, next_row), or None when there is no
    checkpoint.  Raises when ``fingerprint`` (of the current mesh) differs
    from the one the checkpoint recorded.  ``mesh``: the mesh the run
    resumes on, required to read an ELL or block-CSR carry; one stored in
    its layout is read into the structural values (one of another format or
    mesh stays as stored, and the run layer reseeds it)."""
    path = os.path.join(results_dir, CHECKPOINT_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if (fingerprint is not None and "mesh_crc" in z.files
                and int(z["mesh_crc"]) != int(fingerprint)):
            raise ValueError(
                f"checkpoint in '{results_dir}' was written for a different "
                f"mesh (fingerprint {int(z['mesh_crc']):#010x} != current "
                f"{int(fingerprint):#010x}); refusing to resume")

        def t(k):
            return torch.as_tensor(z[k], dtype=dtype, device=device)

        lag_op = None
        if "lag_vals" in z.files and "lag_floor_age" in z.files:
            vals = t("lag_vals")
            if mesh is None:
                _need_mesh(vals, "load_state")
            elif (mesh.structural
                  and tuple(vals.shape) == dense_shape(mesh)):
                vals = from_dense(vals, mesh)
            lag_op = (bool(z["lag_ok"]), int(z["lag_age"]), vals,
                      t("lag_adiag"),
                      t("lag_Ainv") if "lag_Ainv" in z.files else None,
                      float(z["lag_floor"]), int(z["lag_floor_age"]))
        state = State(N=t("N"), b=t("b"), q=t("q"), melt=t("melt"),
                      N_prev=t("N_prev" if "N_prev" in z.files else "N"),
                      lag_op=lag_op)
        return state, int(z["next_step"]), int(z["next_row"])
