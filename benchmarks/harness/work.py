"""The work a kernel needs, counted from the mesh, and the card's peaks.

The bytes of one operator application are counted from the mesh's
connectivity, not from the port's storage, so that a change of format or
kernel leaves the count as it is: P1 triangles couple a node with itself
and with each node it shares an edge with, so A has n + 2 * edges
structural nonzeros.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM (80 GB HBM3) data sheet: HBM bandwidth, at the full
# 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INDEX_BYTES = 4     # one int32 column per structural nonzero
ROW_BYTES = 4       # one int32 length or offset per row
MASK_BYTES = 1      # the Dirichlet mask, a bool per row


def edge_count(cells) -> int:
    """Distinct edges of a triangle mesh (c, 3)."""
    c = np.asarray(cells, np.int64)
    e = np.sort(np.concatenate([c[:, [0, 1]], c[:, [1, 2]], c[:, [2, 0]]]),
                axis=1)
    return int(np.unique(e[:, 0] * (int(c.max()) + 1) + e[:, 1]).size)


def structural_nonzeros(cells, n: int) -> int:
    return n + 2 * edge_count(cells)


def operator_bytes(cells, n: int, value_bytes: int, members: int = 1,
                   epilogue: bool = True) -> int:
    """Bytes one application of the operator (or of ``members`` operators
    on one mesh at once) needs: a value per structural nonzero and member,
    the column indices and row lengths once, x read and y written once per
    member, and with the epilogue the Dirichlet mask once and the diagonal
    increment once per member."""
    nnz = structural_nonzeros(cells, n)
    b = members * (nnz * value_bytes + 2 * n * value_bytes)
    b += nnz * INDEX_BYTES + n * ROW_BYTES
    if epilogue:
        b += n * MASK_BYTES + members * n * value_bytes
    return b
