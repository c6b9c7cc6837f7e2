"""Host-side partitioning by recursive coordinate bisection (RCB).

The port's copy of the numpy path of shakti_tpu/parallel/partition.py:
rcb_order, which renumbers mesh nodes so the block-ELL operator's 128-node
blocks are spatially compact, and rcb_partition / partition_cells /
pad_to_blocks, which split the cells between the ranks of the cell-sharded
step (parallel/shard.py).
"""

from __future__ import annotations

import numpy as np


def rcb_order(points: np.ndarray, leaf: int = 32) -> np.ndarray:
    """Spatial ordering by recursive coordinate bisection: a permutation that
    makes spatially-close points contiguous (compact node blocks minimize
    the block-sparsity fill of fem/bell.py)."""
    points = np.asarray(points, dtype=np.float64)
    out = []

    def rec(idx):
        if idx.size <= leaf:
            out.append(idx)
            return
        pts = points[idx]
        axis = 0 if (pts[:, 0].max() - pts[:, 0].min()
                     >= pts[:, 1].max() - pts[:, 1].min()) else 1
        order = np.argsort(pts[:, axis], kind="stable")
        h = idx.size // 2
        rec(idx[order[:h]])
        rec(idx[order[h:]])

    rec(np.arange(points.shape[0]))
    return np.concatenate(out)


def rcb_partition(points: np.ndarray, n_parts: int) -> np.ndarray:
    """Assign each point (m, 2) to one of ``n_parts`` parts by recursive
    coordinate bisection.  Deterministic; part sizes differ by at most 1."""
    points = np.asarray(points, dtype=np.float64)
    m = points.shape[0]
    part = np.zeros(m, dtype=np.int32)

    def split(idx: np.ndarray, parts: int, base: int):
        if parts == 1 or idx.size == 0:
            part[idx] = base
            return
        p_lo = parts // 2
        n_lo = int(np.floor(idx.size * p_lo / parts + 0.5))   # half up
        pts = points[idx]
        axis = 0 if (pts[:, 0].max() - pts[:, 0].min()
                     >= pts[:, 1].max() - pts[:, 1].min()) else 1
        order = np.argsort(pts[:, axis], kind="stable")
        split(idx[order[:n_lo]], p_lo, base)
        split(idx[order[n_lo:]], parts - p_lo, base + p_lo)

    split(np.arange(m), n_parts, 0)
    return part


def partition_cells(nodes: np.ndarray, cells: np.ndarray, n_parts: int):
    """Partition cells by RCB on their centroids.  Returns (order, counts):
    ``order`` a cell permutation grouping cells by part (part 0 first),
    ``counts[p]`` the number of cells in part p."""
    centroids = nodes[cells].mean(axis=1)
    part = rcb_partition(centroids, n_parts)
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=n_parts)
    return order, counts


def pad_to_blocks(order: np.ndarray, counts: np.ndarray, pad_cell: int = -1):
    """Each part's cell list padded to the largest part: (padded_idx
    (n_parts, block), valid mask)."""
    n_parts = counts.size
    block = int(counts.max())
    idx = np.full((n_parts, block), 0, dtype=np.int64)
    valid = np.zeros((n_parts, block), dtype=bool)
    off = 0
    for p in range(n_parts):
        c = int(counts[p])
        idx[p, :c] = order[off:off + c]
        valid[p, :c] = True
        off += c
    return idx, valid
