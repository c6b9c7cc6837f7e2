"""The operator's bytes counted from the connectivity, against a hand
count on an 8 x 8 square mesh."""

import numpy as np

from benchmarks.harness import work


def square_mesh(k):
    """k x k squares, each cut by one diagonal: (k+1)^2 nodes, 2 k^2
    triangles."""
    idx = np.arange((k + 1) ** 2).reshape(k + 1, k + 1)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, 1:].ravel(), idx[1:, :-1].ravel()
    return np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])


def test_edges_and_nonzeros_by_hand():
    cells = square_mesh(8)
    # 9 rows of 8 horizontal edges, 9 columns of 8 vertical ones, and 64
    # diagonals: 208 edges; every node couples with itself
    assert work.edge_count(cells) == 9 * 8 + 9 * 8 + 64 == 208
    assert work.structural_nonzeros(cells, 81) == 81 + 2 * 208 == 497


def test_operator_bytes_by_hand():
    cells = square_mesh(8)
    n, nnz = 81, 497
    # f32: a value and a 4-byte column per nonzero, 4 bytes a row, x and y,
    # then the mask (1 byte a row) and the diagonal increment (4 bytes)
    single = nnz * 4 + nnz * 4 + n * 4 + 2 * n * 4 + n * 1 + n * 4
    assert single == 5353
    assert work.operator_bytes(cells, n, 4) == single
    assert work.operator_bytes(cells, n, 4, epilogue=False) == single - 5 * n
    # 3 members share the structure and the mask
    three = 3 * (nnz * 4 + 2 * n * 4 + n * 4) + nnz * 4 + n * 4 + n
    assert work.operator_bytes(cells, n, 4, members=3) == three
    assert work.operator_bytes(cells, n, 8) == single + nnz * 4 + 3 * n * 4
