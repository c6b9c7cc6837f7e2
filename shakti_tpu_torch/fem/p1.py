"""P1 reference-element quadrature (host numpy).

The port's copy of shakti_tpu/fem/p1.py:quadrature.  For P1 triangles the
basis functions are the barycentric coordinates, so a quadrature rule in
barycentric coordinates doubles as the shape-function matrix:
``phi[q, i] = bary[q, i]``.  Rules are exact for polynomial degree d on the
triangle; weights sum to 1 (the assembler weights by the cell area).
"""

from __future__ import annotations

import numpy as np

# barycentric points (nq, 3) and weights (nq,), weights sum to 1
_QUAD = {}

_QUAD[1] = (np.array([[1 / 3, 1 / 3, 1 / 3]]), np.array([1.0]))

# 3-point midpoint rule, exact to degree 2
_QUAD[2] = (
    np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]]),
    np.array([1 / 3, 1 / 3, 1 / 3]),
)

# 4-point rule, exact to degree 3
_QUAD[3] = (
    np.array([
        [1 / 3, 1 / 3, 1 / 3],
        [0.6, 0.2, 0.2], [0.2, 0.6, 0.2], [0.2, 0.2, 0.6],
    ]),
    np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48]),
)

# 6-point Dunavant rule, exact to degree 4
_a1, _b1 = 0.816847572980459, 0.091576213509771
_a2, _b2 = 0.108103018168070, 0.445948490915965
_w1, _w2 = 0.109951743655322, 0.223381589678011
_QUAD[4] = (
    np.array([
        [_a1, _b1, _b1], [_b1, _a1, _b1], [_b1, _b1, _a1],
        [_a2, _b2, _b2], [_b2, _a2, _b2], [_b2, _b2, _a2],
    ]),
    np.array([_w1, _w1, _w1, _w2, _w2, _w2]),
)


def quadrature(degree: int):
    """(phi, weights): phi (nq, 3) barycentric/shape values, weights (nq,)."""
    if degree not in _QUAD:
        degree = min(d for d in _QUAD if d >= degree) if degree <= 4 else 4
    pts, w = _QUAD[degree]
    return pts.copy(), w.copy()
