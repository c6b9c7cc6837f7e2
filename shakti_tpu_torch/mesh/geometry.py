"""Host-side mesh topology/geometry utilities (numpy).

The port's copy of the numpy paths of shakti_tpu/mesh/geometry.py:
boundary edges and Dirichlet node location (the reference's DOLFINx
``locate_entities_boundary`` + ``locate_dofs_topological``) and the
vectorized point-in-polygon lake mask (the reference's shapely loop).
They run once at setup time.
"""

from __future__ import annotations

import numpy as np


def boundary_edges(cells: np.ndarray) -> np.ndarray:
    """(n_bedges, 2) node pairs of edges that belong to exactly one triangle."""
    e = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]])
    key = np.sort(e, axis=1)
    _, idx, counts = np.unique(key, axis=0, return_index=True, return_counts=True)
    return e[idx[counts == 1]]


def locate_boundary_nodes(nodes: np.ndarray, cells: np.ndarray, predicate) -> np.ndarray:
    """Node ids of boundary *facets* whose vertices all satisfy ``predicate``
    (a facet is marked only when every vertex satisfies it; its P1 dofs are
    its vertices).  ``predicate`` maps an (m, 2) coordinate array -> (m,)
    bool."""
    be = boundary_edges(cells)
    ok = predicate(nodes[be[:, 0]]) & predicate(nodes[be[:, 1]])
    return np.unique(be[ok])


def dirichlet_mask(n_nodes: int, node_ids: np.ndarray) -> np.ndarray:
    mask = np.zeros(n_nodes, dtype=bool)
    mask[node_ids] = True
    return mask


def points_in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Vectorized even-odd ray casting: which of ``points`` (m, 2) lie inside
    the closed ``polygon`` (k, 2)?  NaN rows delimit rings (multi-polygon
    outlines); a point is inside if it is inside any ring."""
    points = np.asarray(points, dtype=np.float64)
    polygon = np.asarray(polygon, dtype=np.float64)

    isnan = np.isnan(polygon[:, 0])
    if isnan.any():
        rings, cur = [], []
        for row, bad in zip(polygon, isnan):
            if bad:
                if len(cur) >= 3:
                    rings.append(np.asarray(cur))
                cur = []
            else:
                cur.append(row)
        if len(cur) >= 3:
            rings.append(np.asarray(cur))
    else:
        rings = [polygon]

    inside = np.zeros(points.shape[0], dtype=bool)
    for ring in rings:
        # drop duplicated closing vertex if present
        if np.allclose(ring[0], ring[-1]):
            ring = ring[:-1]
        x, y = points[:, 0][:, None], points[:, 1][:, None]
        x1, y1 = ring[:, 0][None, :], ring[:, 1][None, :]
        x2, y2 = np.roll(ring[:, 0], -1)[None, :], np.roll(ring[:, 1], -1)[None, :]
        crosses = ((y1 > y) != (y2 > y)) & (
            x < (x2 - x1) * (y - y1) / np.where(y2 == y1, np.inf, y2 - y1) + x1)
        inside |= (crosses.sum(axis=1) % 2).astype(bool)
    return inside
