"""Block-CSR operator format on torch tensors: the large-mesh path.

Port of shakti_tpu/fem/bcsr.py.  In the JAX package's layout only the
nonzero B x B blocks are stored: ``vals`` (nnzb, B, B) with block-row ids
``brow`` (sorted) and block-column ids ``bcol``.  :func:`bcsr_from_elements`,
:func:`bcsr_matvec` and :func:`bcsr_diag` keep that layout, as mirrors of
the JAX package's functions and yardsticks.  The solve path never builds
the blocks: it keeps the structural entries alone, ``svals`` (W, n) in the
order of :func:`bcsr_view` (fem/ell.py: fold_structural, structural_diag,
to_dense / from_dense), which the kernel csrc/ell_spmv.cu reads.
"""

from __future__ import annotations

import numpy as np
import torch

from shakti_tpu_torch.fem.ell import dense_fold, scalar_view
from shakti_tpu_torch.fem.ops import fixed_sum


def build_bcsr(cells: np.ndarray, n_nodes: int, B: int = 128):
    """Host-side: block sparsity + element->slot mapping (numpy; a copy of
    shakti_tpu/fem/bcsr.py:build_bcsr, its numpy path).  Assumes
    locality-ordered nodes (RCB).  Returns (brow (nnzb,), bcol (nnzb,),
    blk_map (9c,), off_map (9c,), diag_blk (n,), diag_off (n,)), all
    int32, and NB."""
    NB = -(-n_nodes // B)
    c = cells.shape[0]
    rows = np.broadcast_to(cells[:, :, None], (c, 3, 3)).reshape(-1).astype(np.int64)
    cols = np.broadcast_to(cells[:, None, :], (c, 3, 3)).reshape(-1).astype(np.int64)
    br, bc = rows // B, cols // B
    bkey = br * NB + bc
    uniq = np.unique(bkey)
    brow = (uniq // NB).astype(np.int32)
    bcol = (uniq % NB).astype(np.int32)
    blk_map = np.searchsorted(uniq, bkey).astype(np.int32)
    off_map = ((rows % B) * B + cols % B).astype(np.int32)
    r = np.arange(n_nodes, dtype=np.int64)
    dkey = (r // B) * NB + (r // B)
    diag_blk = np.clip(np.searchsorted(uniq, dkey), 0,
                       uniq.size - 1).astype(np.int32)
    diag_off = ((r % B) * B + r % B).astype(np.int32)
    return brow, bcol, blk_map, off_map, diag_blk, diag_off, NB


def fold_keys(blk_map, off_map, B: int):
    """Flat (nnzb*B*B) position of every element entry, in int64 (the JAX
    package keeps (block, offset) int32 pairs instead)."""
    return (np.asarray(blk_map, np.int64) * (B * B)
            + np.asarray(off_map, np.int64))


def bcsr_view(brow, bcol, fold_slots, n: int, B: int):
    """The view of BCSR values (nnzb, B, B): each structural entry's flat
    position (blk*B + i%B)*B + j and column bcol[blk]*B + j, row i's
    entries in (blk, j) order."""
    slots = np.unique(np.asarray(fold_slots, np.int64))
    blk, off = slots // (B * B), slots % (B * B)
    row = np.asarray(brow, np.int64)[blk] * B + off // B
    col = np.asarray(bcol, np.int64)[blk] * B + off % B
    return scalar_view(row, slots, col, n, wide=True)


def bcsr_from_elements(J_c, mesh):
    """Fold element blocks (c, 3, 3) into (nnzb, B, B), zero outside the
    structure."""
    return dense_fold(J_c, mesh)


def bcsr_matvec(vals, mesh, x):
    """y = A x: block-column gather, batched product, and a fixed-order sum
    over each block row's blocks (shakti_tpu/fem/bcsr.py:bcsr_matvec)."""
    n, NB, B = mesh.n_nodes, mesh.bcsr_NB, mesh.bcsr_B
    xg = torch.nn.functional.pad(x, (0, NB * B - n)).reshape(NB, B)[mesh.bcsr_bcol]
    z = torch.einsum("kij,kj->ki", vals, xg)
    ext = torch.cat([z, z.new_zeros(1, B)])
    y = z.new_zeros(NB, B)
    y[mesh.bcsr_row_slots] = fixed_sum(ext[mesh.bcsr_row_idx], 1)
    return y.reshape(-1)[:n]


def bcsr_diag(vals, diag_blk, diag_off):
    nnzb, B, _ = vals.shape
    return vals.reshape(nnzb, B * B)[diag_blk, diag_off]
