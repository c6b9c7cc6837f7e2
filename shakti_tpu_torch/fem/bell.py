"""Block-ELL (BSR-style) operator format on torch tensors.

Port of shakti_tpu/fem/bell.py.  Nodes are RCB-ordered (api/model.freeze)
and chunked into blocks of B; the assembled operator is dense B x B blocks
``vals`` (NB, KB, B, B) with neighbour-block ids ``nbr`` (NB, KB) (padding
slots point at their own row block and hold zeros).

The element -> block fold is a deterministic gather (fem/ops.gather_plan):
CUDA's ``index_add_`` would sum shared slots with atomics, in an order that
changes from run to run.  The matvec on CUDA tensors reads only the
structural nonzeros of ``vals`` through :func:`structural_view`
(ops/spmv_cuda.py).
"""

from __future__ import annotations

import numpy as np

from shakti_tpu_torch.fem.ell import scalar_view
from shakti_tpu_torch.fem.ops import plan_sum
from shakti_tpu_torch.ops.spmv_cuda import W_MAX

BLOCK = 128


def build_block_ell(cells: np.ndarray, n_nodes: int, B: int = BLOCK):
    """Host-side: block sparsity + element->slot mapping (numpy; a copy of
    shakti_tpu/fem/bell.py:build_block_ell, its numpy path).

    Returns (nbr (NB, KB) int32, slot_map (9*c,) flat positions into
    vals (NB, KB, B, B), diag_pos (n_nodes,), KB)."""
    NB = -(-n_nodes // B)
    c = cells.shape[0]
    rows = np.broadcast_to(cells[:, :, None], (c, 3, 3)).reshape(-1).astype(np.int64)
    cols = np.broadcast_to(cells[:, None, :], (c, 3, 3)).reshape(-1).astype(np.int64)
    brow, bcol = rows // B, cols // B

    bkey = brow * NB + bcol
    uniq = np.unique(bkey)
    ur, uc = uniq // NB, (uniq % NB).astype(np.int32)
    deg = np.bincount(ur, minlength=NB)
    KB = int(deg.max())
    start = np.concatenate([[0], np.cumsum(deg)])
    kb_of_pair = np.arange(uniq.size) - start[ur]

    nbr = np.broadcast_to(np.arange(NB, dtype=np.int32)[:, None], (NB, KB)).copy()
    nbr[ur, kb_of_pair] = uc

    pos = np.searchsorted(uniq, bkey)
    kb = kb_of_pair[pos]
    slot_map = (((brow * KB + kb) * B + rows % B) * B + cols % B).astype(np.int64)

    r = np.arange(n_nodes, dtype=np.int64)
    br = r // B
    dkey = br * NB + br
    dpos = np.clip(np.searchsorted(uniq, dkey), 0, uniq.size - 1)
    dkb = np.where(uniq[dpos] == dkey, kb_of_pair[dpos], 0)
    diag_pos = (((br * KB + dkb) * B + r % B) * B + r % B).astype(np.int64)
    return nbr, slot_map, diag_pos, KB


def structural_view(nbr, fold_slots, n: int, B: int):
    """Host-side scalar-ELL view of the operator's structural nonzeros.

    ``fold_slots`` are the distinct flat positions of vals (NB, KB, B, B)
    that the fold writes (fem/ops.gather_plan).  Returns nz_pos (W, n)
    int32, column-major: ``nz_pos[m, i]`` is the flat position of row i's
    m-th structural entry, in (k, j) order (the dense product's summation
    order without its zeros), padded with -1.  A position names its column
    through ``nbr`` (ops/spmv_cuda.view_columns).  W is the largest row
    count.  Raises when positions do not fit int32 or W exceeds the
    kernel's maximum."""
    nbr = np.asarray(nbr, np.int64)
    NB, KB = nbr.shape
    if NB * KB * B * B >= 2 ** 31:
        raise ValueError(f"vals ({NB}, {KB}, {B}, {B}) has >= 2**31 entries: "
                         "its positions do not fit the view's int32")
    slots = np.unique(np.asarray(fold_slots, np.int64))
    blk = slots // (B * B)
    r, k = blk // KB, blk % KB
    row = r * B + (slots // B) % B
    col = nbr[r, k] * B + slots % B
    if slots.size and max(row.max(), col.max()) >= n:
        raise ValueError(f"fold slots address rows/columns beyond n = {n}")
    # slots ascend in (r, k, i, j) order, so each row keeps its entries in
    # (k, j) order
    nz_pos, _ = scalar_view(row, slots, col, n)
    if nz_pos.shape[0] > W_MAX:
        raise ValueError(f"a row has {nz_pos.shape[0]} structural entries; "
                         f"the kernel takes at most {W_MAX}")
    return nz_pos


def bell_from_elements(J_c, mesh):
    """Fold element blocks (c, 3, 3) into vals (NB, KB, B, B)."""
    NB, KB = mesh.bell_nbr.shape
    B = mesh.bell_B
    vals = plan_sum(J_c, mesh.bell_fold_slots, mesh.bell_fold_idx,
                    NB * KB * B * B)
    return vals.reshape(NB, KB, B, B)


def bell_diag(vals, diag_pos):
    return vals.reshape(-1)[diag_pos]
