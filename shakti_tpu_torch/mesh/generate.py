"""Host-side structured mesh generator (numpy).

The port's copy of shakti_tpu/mesh/generate.py:rectangle_mesh, which the
built-in setups and the tests mesh with.
"""

from __future__ import annotations

import numpy as np


def rectangle_mesh(nx: int, ny: int, lx: float, ly: float,
                   x0: float = 0.0, y0: float = 0.0,
                   diagonal: str = "alternating",
                   jitter: float = 0.0, seed: int = 0):
    """Triangulated rectangle [x0, x0+lx] x [y0, y0+ly] with (nx+1)*(ny+1) nodes.

    diagonal:
      - 'right': all diagonals in the same direction (like DOLFINx
        create_rectangle default)
      - 'alternating': union-jack-ish pattern, milder anisotropy
    jitter: optional fraction of h by which *interior* nodes are perturbed
    (deterministic, for exercising unstructured code paths in tests/bench).
    """
    xs = np.linspace(x0, x0 + lx, nx + 1)
    ys = np.linspace(y0, y0 + ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    nodes = np.column_stack([X.ravel(), Y.ravel()])

    if jitter > 0.0:
        rng = np.random.default_rng(seed)
        hx, hy = lx / nx, ly / ny
        interior = ((nodes[:, 0] > xs[0]) & (nodes[:, 0] < xs[-1])
                    & (nodes[:, 1] > ys[0]) & (nodes[:, 1] < ys[-1]))
        pert = rng.uniform(-1.0, 1.0, size=nodes.shape)
        nodes[interior] += jitter * pert[interior] * np.array([hx, hy])

    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    ii, jj = ii.ravel(), jj.ravel()
    a = jj * (nx + 1) + ii
    b = a + 1
    c = b + (nx + 1)
    d = a + (nx + 1)
    flip = (diagonal == "alternating") & (((ii + jj) % 2) == 1)
    t1 = np.where(flip[:, None], np.stack([a, b, d], 1),
                  np.stack([a, b, c], 1))
    t2 = np.where(flip[:, None], np.stack([b, c, d], 1),
                  np.stack([a, c, d], 1))
    cells = np.empty((2 * a.size, 3), dtype=np.int32)
    cells[0::2] = t1
    cells[1::2] = t2
    return nodes, cells
