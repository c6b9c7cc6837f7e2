"""Scalar ELL (padded row-sparse) operator format on torch tensors, and
the structural storage the solve path keeps for it and for block-CSR.

Port of shakti_tpu/fem/ell.py.  In the JAX package's layout the assembled
operator is row storage ``vals`` (n, K) with neighbour ids ``cols`` (n, K);
K is the largest node degree + 1, and padding slots point at the row's own
node and hold zeros.  :func:`ell_from_elements`, :func:`ell_matvec` and
:func:`ell_diag` keep that layout: they mirror the JAX package's functions
and are the yardsticks of the structural ones.

The solve path stores only the structural entries, for this format and for
block-CSR (fem/bcsr.py): ``svals`` (W, n), column-major in the order
:func:`scalar_view` fixes.  ``svals[m, i]`` is row i's m-th structural
entry (exactly 0 on a padding slot) and ``mesh.nz_col[m, i]`` its column
(the row itself on padding).  That is the layout the CUDA kernel
csrc/ell_spmv.cu reads: a warp's m-th loads are consecutive.
:func:`fold_structural` writes it straight from the element blocks through
a fold plan renumbered to the view (:func:`structural_plan`), a
deterministic gather with the dense fold's summation order per entry;
:func:`structural_diag` reads the diagonal through a per-row slot
(:func:`diag_slots`).  ``mesh.nz_pos`` maps each slot to its flat position
in the JAX layout, for :func:`to_dense` / :func:`from_dense` (checkpoints
and tests) only.
"""

from __future__ import annotations

import numpy as np
import torch

from shakti_tpu_torch.fem.ops import fixed_sum, plan_sum


def build_ell_map(cells: np.ndarray, n_nodes: int):
    """Host-side: the ELL sparsity and the element->slot mapping (numpy; a
    copy of shakti_tpu/fem/ell.py:build_ell_map, its numpy path).

    Returns (cols (n, K) int32, slot_map (9 * n_cells,) int32, diag_slot
    (n,) int32): ``slot_map[e]`` is the flat n*K position receiving flat
    element-Jacobian entry e (J_c.reshape(-1): (c, i, j) row-major)."""
    c = cells.shape[0]
    flat_rows = np.broadcast_to(cells[:, :, None], (c, 3, 3)).reshape(-1).astype(np.int64)
    flat_cols = np.broadcast_to(cells[:, None, :], (c, 3, 3)).reshape(-1).astype(np.int64)
    key = flat_rows * n_nodes + flat_cols
    uniq_key = np.unique(key)
    uniq_r = uniq_key // n_nodes
    uniq_c = (uniq_key % n_nodes).astype(np.int32)
    deg = np.bincount(uniq_r, minlength=n_nodes)
    K = int(deg.max())
    row_start = np.concatenate([[0], np.cumsum(deg)])
    slot_k = np.arange(uniq_key.size) - row_start[uniq_r]
    cols = np.broadcast_to(np.arange(n_nodes, dtype=np.int32)[:, None],
                           (n_nodes, K)).copy()              # pad = self
    cols[uniq_r, slot_k] = uniq_c
    pos = np.searchsorted(uniq_key, key)
    slot_map = (flat_rows * K + slot_k[pos]).astype(np.int32)
    diag_key = np.arange(n_nodes, dtype=np.int64) * (n_nodes + 1)
    diag_pos = np.clip(np.searchsorted(uniq_key, diag_key), 0, uniq_key.size - 1)
    diag_slot = np.where(uniq_key[diag_pos] == diag_key,
                         slot_k[diag_pos], 0).astype(np.int32)
    return cols, slot_map, diag_slot


def scalar_view(row, pos, col, n: int, wide: bool = False):
    """Host-side column-major scalar-ELL view of a sparse operator's
    structural entries: entry e lies in row ``row[e]`` at flat position
    ``pos[e]`` of its values, column ``col[e]``.  Returns (view_pos,
    view_col), both (W, n) int32 with W the largest row count (at least 1):
    row i's entries in input order, padded with position -1 and column i.
    Raises when a position does not fit int32, unless ``wide``: then the
    positions are int64 (a view no kernel reads positions from)."""
    row = np.asarray(row, np.int64)
    pos = np.asarray(pos, np.int64)
    if not wide and pos.size and pos.max() >= 2 ** 31:
        raise ValueError(f"a flat position ({int(pos.max())}) does not fit "
                         "the view's int32")
    order = np.argsort(row, kind="stable")
    counts = np.bincount(row, minlength=n)
    W = max(int(counts.max()) if n else 0, 1)
    rank = np.arange(row.size) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    view_pos = np.full((W, n), -1, np.int64 if wide else np.int32)
    view_col = np.broadcast_to(np.arange(n, dtype=np.int32), (W, n)).copy()
    view_pos[rank, row[order]] = pos[order]
    view_col[rank, row[order]] = np.asarray(col, np.int64)[order]
    return view_pos, view_col


def ell_view(cols, fold_slots):
    """The view of ELL values (n, K): the fold's slots i*K + m, columns from
    ``cols``; padding slots (pointing at the row itself, zero) are left
    out."""
    cols = np.asarray(cols)
    n, K = cols.shape
    slots = np.unique(np.asarray(fold_slots, np.int64))
    return scalar_view(slots // K, slots, cols.reshape(-1)[slots], n,
                       wide=True)


def structural_plan(view_pos, fold_slots, fold_idx, sentinel: int):
    """Host-side: the fold plan (fem/ops.gather_plan: sorted distinct flat
    positions ``fold_slots`` (U,), their element entries ``fold_idx``
    (U, M), padded with ``sentinel``) renumbered to the view: (W * n, M),
    row m * n + i holding the element entries of view slot (m, i) in the
    same order; a padding slot's row is all sentinel (the appended
    zero)."""
    pos = np.asarray(view_pos, np.int64).reshape(-1)
    pad_row = np.full((1, fold_idx.shape[1]), sentinel, np.int64)
    at = np.searchsorted(fold_slots, np.maximum(pos, 0))
    ext = np.concatenate([np.asarray(fold_idx, np.int64), pad_row])
    return ext[np.where(pos >= 0, at, fold_slots.size)]


def diag_slots(view_pos, diag_pos):
    """Host-side: flat index m * n + i into ``svals`` of row i's diagonal
    entry, whose flat dense position is ``diag_pos[i]``; a row without one
    (a node in no cell: all padding) points at its slot 0, which holds 0."""
    view_pos = np.asarray(view_pos, np.int64)
    n = view_pos.shape[1]
    hit = view_pos == np.asarray(diag_pos, np.int64)[None, :]
    m = np.where(hit.any(0), hit.argmax(0), 0)
    return m * n + np.arange(n, dtype=np.int64)


def fold_structural(J_c, mesh):
    """Fold element blocks (c, 3, 3) into the structural values ``svals``
    (W, n) of an ELL or BCSR mesh: one gather over the renumbered plan and a
    fixed-order sum; nothing is zero-filled or index-written."""
    flat = J_c.reshape(-1)
    ext = torch.cat([flat, flat.new_zeros(1)])
    return fixed_sum(ext[mesh.nz_fold_idx], 1).reshape(mesh.nz_col.shape)


def structural_diag(svals, mesh):
    """Assembled diagonal (n,) from the structural values."""
    return svals.reshape(-1)[mesh.nz_diag]


def dense_shape(mesh):
    """Shape of an ELL or BCSR mesh's values in the JAX package's layout:
    (nnzb, B, B) or (n, K)."""
    if mesh.bcsr_brow is not None:
        return (mesh.bcsr_brow.shape[0], mesh.bcsr_B, mesh.bcsr_B)
    return tuple(mesh.ell_cols.shape)


def to_dense(svals, mesh):
    """Structural values (W, n) scattered into the JAX package's layout
    (zero outside the structure): what a checkpoint stores."""
    shape = dense_shape(mesh)
    valid = mesh.nz_pos >= 0
    out = svals.new_zeros(int(np.prod(shape)))
    out[mesh.nz_pos[valid]] = svals[valid]
    return out.reshape(shape)


def from_dense(vals, mesh):
    """The structural values (W, n) of values in the JAX package's layout;
    padding slots are exactly 0."""
    pos = mesh.nz_pos
    return torch.where(pos >= 0, vals.reshape(-1)[pos.clamp_min(0)], 0.0)


def dense_fold(J_c, mesh):
    """The fold into the JAX layout, zero outside the structure: the same
    plan written at the dense positions (what :func:`ell_from_elements` and
    fem/bcsr.bcsr_from_elements return)."""
    shape = dense_shape(mesh)
    valid = (mesh.nz_pos >= 0).reshape(-1)
    return plan_sum(J_c, mesh.nz_pos.reshape(-1)[valid],
                    mesh.nz_fold_idx[valid], int(np.prod(shape))).reshape(shape)


def ell_from_elements(J_c, mesh):
    """Fold element blocks (c, 3, 3) into ELL values (n, K)."""
    return dense_fold(J_c, mesh)


def ell_matvec(vals, cols, x):
    """y = A x with A in ELL form: gather and row sum
    (shakti_tpu/fem/ell.py:ell_matvec)."""
    return torch.sum(vals * x[cols], dim=1)


def ell_diag(vals, diag_slot):
    n, K = vals.shape
    return vals.reshape(-1)[torch.arange(n, device=vals.device) * K + diag_slot]
