"""Host-side node ordering by recursive coordinate bisection (RCB).

The port's copy of the numpy path of shakti_tpu/parallel/partition.py:
rcb_order, which renumbers mesh nodes so the block-ELL operator's 128-node
blocks are spatially compact.
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
