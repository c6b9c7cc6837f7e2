"""Reading the repository's raw asset files for a configuration: a gmsh
mesh and a polygon's inside, in numpy alone, so that the benchmark makes
the inputs it hands to the port and to the plain reference itself.
"""

from __future__ import annotations

import numpy as np

TRIANGLE = 2    # gmsh's element type of a 3-node triangle


def read_msh(path) -> tuple[np.ndarray, np.ndarray]:
    """The triangles of an ASCII gmsh MSH 4.1 file: nodes (n, 2) float64
    and cells (c, 3) int64, the nodes numbered densely in file order."""
    lines = iter(open(path).read().split("\n"))
    fmt = nodes = cells = None
    for line in lines:
        if line == "$MeshFormat":
            fmt = next(lines).split()
        elif line == "$Nodes":
            blocks, count = (int(v) for v in next(lines).split()[:2])
            tags, xy = [], []
            for _ in range(blocks):
                k = int(next(lines).split()[3])
                tags += [int(next(lines)) for _ in range(k)]
                xy += [next(lines).split()[:2] for _ in range(k)]
            nodes = np.asarray(xy, np.float64)
            order = {t: i for i, t in enumerate(tags)}
        elif line == "$Elements":
            blocks = int(next(lines).split()[0])
            tri = []
            for _ in range(blocks):
                _, _, kind, k = (int(v) for v in next(lines).split())
                rows = [next(lines).split() for _ in range(k)]
                if kind == TRIANGLE:
                    tri += [[order[int(t)] for t in r[1:4]] for r in rows]
            cells = np.asarray(tri, np.int64)
    if fmt is None or fmt[:2] != ["4.1", "0"]:
        raise ValueError(f"{path}: not an ASCII MSH 4.1 file")
    if nodes is None or cells is None or nodes.shape[0] != count \
            or not cells.size:
        raise ValueError(f"{path}: no nodes or no triangles")
    return nodes, cells


def points_in_polygon(points, polygon) -> np.ndarray:
    """Bool (m,): which ``points`` (m, 2) lie inside the closed ``polygon``
    (k, 2), by even-odd ray casting."""
    px, py = np.asarray(points, np.float64).T
    ring = np.asarray(polygon, np.float64)
    ring = ring[np.isfinite(ring).all(1)]
    inside = np.zeros(px.shape, bool)
    for (x0, y0), (x1, y1) in zip(ring, np.roll(ring, -1, 0)):
        if y0 == y1:
            continue
        crosses = (y0 > py) != (y1 > py)
        at = x0 + (py - y0) * (x1 - x0) / (y1 - y0)
        inside ^= crosses & (px < at)
    return inside
