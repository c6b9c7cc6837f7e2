"""Scalar ELL (padded row-sparse) operator format on torch tensors.

Port of shakti_tpu/fem/ell.py.  The assembled operator is row storage
``vals`` (n, K) with neighbour ids ``cols`` (n, K); K is the largest node
degree + 1, and padding slots point at the row's own node and hold zeros.
The element -> row fold is a deterministic gather (fem/ops.gather_plan),
not an atomic scatter.

:func:`scalar_view` builds the column-major (W, n) view of the structural
entries that the CUDA kernel csrc/ell_spmv.cu reads, for this format and
for block-CSR (fem/bcsr.py).
"""

from __future__ import annotations

import numpy as np
import torch

from shakti_tpu_torch.fem.ops import plan_sum


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


def scalar_view(row, pos, col, n: int):
    """Host-side column-major scalar-ELL view of a sparse operator's
    structural entries: entry e lies in row ``row[e]`` at flat position
    ``pos[e]`` of its values, column ``col[e]``.  Returns (view_pos,
    view_col), both (W, n) int32 with W the largest row count (at least 1):
    row i's entries in input order, padded with position -1 and column i.
    Raises when a position does not fit int32."""
    row = np.asarray(row, np.int64)
    pos = np.asarray(pos, np.int64)
    if pos.size and pos.max() >= 2 ** 31:
        raise ValueError(f"a flat position ({int(pos.max())}) does not fit "
                         "the view's int32")
    order = np.argsort(row, kind="stable")
    counts = np.bincount(row, minlength=n)
    W = max(int(counts.max()) if n else 0, 1)
    rank = np.arange(row.size) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    view_pos = np.full((W, n), -1, np.int32)
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
    return scalar_view(slots // K, slots, cols.reshape(-1)[slots], n)


def ell_from_elements(J_c, mesh):
    """Fold element blocks (c, 3, 3) into ELL values (n, K)."""
    n, K = mesh.ell_cols.shape
    return plan_sum(J_c, mesh.ell_fold_slots, mesh.ell_fold_idx,
                    n * K).reshape(n, K)


def ell_matvec(vals, cols, x):
    """y = A x with A in ELL form: gather and row sum (the plain twin of
    csrc/ell_spmv.cu, shakti_tpu/fem/ell.py:ell_matvec)."""
    return torch.sum(vals * x[cols], dim=1)


def ell_diag(vals, diag_slot):
    n, K = vals.shape
    return vals.reshape(-1)[torch.arange(n, device=vals.device) * K + diag_slot]
