"""Host-side mesh generators (numpy).

The port's copy of shakti_tpu/mesh/generate.py: rectangle_mesh, which the
built-in setups and the tests mesh with, polygon_mesh (Delaunay over
scipy.spatial), which the SHMIP valley suites E and F mesh with, and
disk_mesh, the crude ring disk of synthetic lake tests.
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


def polygon_mesh(outline: np.ndarray, resolution: float, *, margin: float = 0.45,
                 jitter: float = 0.0, seed: int = 0):
    """Triangulate the interior of a polygon at roughly uniform ``resolution``.

    Self-contained replacement for the reference's pygmsh polygon meshing
    step (create_mesh.ipynb cell 17: outline points at 2 km resolution ->
    plane surface -> triangles): boundary nodes resampled along the outline
    at ~resolution spacing + interior nodes on a staggered (hex-ish) grid,
    Delaunay-triangulated, keeping triangles whose centroid lies inside.
    For production-grade meshes gmsh remains supported via mesh/msh_io.
    """
    from scipy.spatial import Delaunay

    from shakti_tpu_torch.mesh.geometry import points_in_polygon

    outline = np.asarray(outline, dtype=np.float64)
    if np.allclose(outline[0], outline[-1]):
        outline = outline[:-1]

    # resample the boundary at ~resolution spacing
    seg = np.diff(np.vstack([outline, outline[:1]]), axis=0)
    seg_len = np.hypot(seg[:, 0], seg[:, 1])
    bpts = []
    for k in range(outline.shape[0]):
        n_sub = max(1, int(np.ceil(seg_len[k] / resolution)))
        for s in range(n_sub):
            bpts.append(outline[k] + seg[k] * (s / n_sub))
    bpts = np.asarray(bpts)

    # staggered interior lattice, kept a margin away from the boundary
    xmin, ymin = outline.min(axis=0) - resolution
    xmax, ymax = outline.max(axis=0) + resolution
    dy = resolution * np.sqrt(3) / 2
    rows = []
    y = ymin
    j = 0
    while y <= ymax:
        xs = np.arange(xmin + (resolution / 2 if j % 2 else 0.0), xmax,
                       resolution)
        rows.append(np.column_stack([xs, np.full(xs.size, y)]))
        y += dy
        j += 1
    grid = np.concatenate(rows)
    if jitter > 0.0:
        # perturb the interior lattice (deterministic) so the Delaunay
        # connectivity is genuinely unstructured, like a gmsh frontal mesh
        rng = np.random.default_rng(seed)
        grid = grid + jitter * resolution * rng.uniform(-1, 1, grid.shape)
    inside = points_in_polygon(grid, outline)
    # drop interior points too close to boundary nodes
    if bpts.size:
        d2 = ((grid[:, None, :] - bpts[None, :, :]) ** 2).sum(-1).min(axis=1) \
            if grid.shape[0] * bpts.shape[0] < 5e7 else _min_dist2_chunked(grid, bpts)
        inside &= d2 > (margin * resolution) ** 2
    nodes = np.vstack([bpts, grid[inside]])

    tri = Delaunay(nodes)
    cells = tri.simplices.astype(np.int32)
    centroids = nodes[cells].mean(axis=1)
    keep = points_in_polygon(centroids, outline)
    # drop slivers (degenerate aspect) on the hull
    p = nodes[cells]
    area = 0.5 * np.abs((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
                        - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    keep &= area > 1e-6 * resolution ** 2
    cells = cells[keep]
    # compact node numbering
    used = np.unique(cells)
    remap = -np.ones(nodes.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    return nodes[used], remap[cells].astype(np.int32)


def _min_dist2_chunked(grid, bpts, chunk=4096):
    out = np.empty(grid.shape[0])
    for i in range(0, grid.shape[0], chunk):
        g = grid[i:i + chunk]
        out[i:i + chunk] = ((g[:, None, :] - bpts[None, :, :]) ** 2).sum(-1).min(axis=1)
    return out


def disk_mesh(n_rings: int, radius: float = 1.0, center=(0.0, 0.0)):
    """Crude structured disk triangulation: a center node and rings of 6 r
    nodes, ring r - 1 stitched to ring r by advancing whichever ring lags
    in angle.  Used by synthetic lake tests; not a production mesher."""
    nodes = [np.array(center, dtype=float)]
    ring_start = [0]
    for r in range(1, n_rings + 1):
        k = 6 * r
        ring_start.append(len(nodes))
        th = np.linspace(0, 2 * np.pi, k, endpoint=False)
        rad = radius * r / n_rings
        for t in th:
            nodes.append(np.array([center[0] + rad * np.cos(t),
                                   center[1] + rad * np.sin(t)]))
    nodes = np.asarray(nodes)

    cells = []
    for r in range(1, n_rings + 1):
        k_out = 6 * r
        k_in = 6 * (r - 1) if r > 1 else 1
        out0 = ring_start[r]
        in0 = ring_start[r - 1]
        if r == 1:
            for i in range(k_out):
                cells.append([0, out0 + i, out0 + (i + 1) % k_out])
            continue
        ii, oo = 0, 0
        for _ in range(k_in + k_out):
            a_in = in0 + (ii % k_in)
            a_out = out0 + (oo % k_out)
            ang_in_next = 2 * np.pi * (ii + 1) / k_in
            ang_out_next = 2 * np.pi * (oo + 1) / k_out
            if ang_out_next <= ang_in_next:
                cells.append([a_in, a_out, out0 + ((oo + 1) % k_out)])
                oo += 1
            else:
                cells.append([a_in, a_out, in0 + ((ii + 1) % k_in)])
                ii += 1
    return nodes, np.asarray(cells, dtype=np.int32)
