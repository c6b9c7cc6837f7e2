"""Device-side mesh: a frozen dataclass of tensors.

Port of shakti_tpu/mesh/mesh.py for the block-ELL operator.  For P1
triangles the dof map is the cell connectivity, so the function space is
the arrays below plus derived static geometry.  Index arrays are int64
(torch's indexing type); the JAX package's int32 ids map onto them
value for value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shakti_tpu_torch.fem import bell as bellm


@dataclasses.dataclass(frozen=True)
class Mesh:
    nodes: torch.Tensor        # (n_nodes, 2) float: vertex coordinates
    cells: torch.Tensor        # (n_cells, 3) int64: vertex ids per triangle
    area: torch.Tensor         # (n_cells,) float: |triangle area|
    grads: torch.Tensor        # (n_cells, 3, 2) float: grad(phi_i) per cell
    node_area: torch.Tensor    # (n_nodes,) float: sum of adjacent cell areas
    cell_valid: torch.Tensor   # (n_cells,) float: 1.0 (no padded cells here)
    # node->(cell, corner) incidence: flat indices into (3*n_cells,) corner
    # arrays, invalid slots = sentinel 3*n_cells (fem/ops.scatter_add_cells)
    inc_map: torch.Tensor      # (n_nodes, KI) int64
    # block-ELL structure (fem/bell.py)
    bell_nbr: torch.Tensor     # (NB, KB) int64 neighbour block ids
    bell_map: torch.Tensor     # (9*n_cells,) element -> flat vals position
    bell_diag_pos: torch.Tensor  # (n_nodes,) flat diagonal positions
    bell_B: int
    # deterministic fold of the 9c element entries (fem/bell.gather_plan)
    bell_fold_slots: torch.Tensor  # (U,) distinct flat vals positions
    bell_fold_idx: torch.Tensor    # (U, M) element entries per slot
    # scalar-ELL view of the structural nonzeros (fem/bell.structural_view),
    # what the matvec kernel reads
    bell_nz_pos: torch.Tensor  # (W, n_nodes) int32 flat vals positions, -1 pad

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]


def cell_geometry(nodes: np.ndarray, cells: np.ndarray):
    """Per-cell signed area and constant P1 basis gradients (host numpy):
    grad(phi_0) = [y1 - y2, x2 - x1] / (2 A_signed), cyclic in (0, 1, 2)."""
    p = nodes[cells]
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    signed_area = 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    x, y = p[..., 0], p[..., 1]
    gx = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], axis=1)
    gy = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], axis=1)
    grads = np.stack([gx, gy], axis=-1) / (2.0 * signed_area)[:, None, None]
    return signed_area, grads


def incidence_map(cells: np.ndarray, n_nodes: int) -> np.ndarray:
    """(n_nodes, KI) flat corner positions incident to each node, padded
    with the sentinel 3*n_cells (shakti_tpu/mesh/mesh.py:174-189)."""
    flat_pos = np.arange(cells.size, dtype=np.int64)
    flat_nodes = cells.reshape(-1)
    order = np.argsort(flat_nodes, kind="stable")
    counts = np.bincount(flat_nodes, minlength=n_nodes)
    KI = int(counts.max()) if counts.size else 0
    inc = np.full((n_nodes, KI), cells.size, dtype=np.int64)
    rank = np.arange(flat_nodes.size) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    inc[flat_nodes[order], rank] = flat_pos[order]
    return inc


def mesh_from_arrays(a: dict, *, dtype, device) -> Mesh:
    """Mesh from host arrays: nodes, cells, area, grads, node_area,
    cell_valid, inc_map, bell_nbr, bell_map, bell_diag_pos, bell_B (the
    field names of both packages' Mesh).  Derives the deterministic fold
    plan and the structural view."""
    def f(k):
        return torch.as_tensor(np.array(a[k], np.float64), dtype=dtype,
                               device=device)

    def i(x):
        return torch.as_tensor(np.array(x, np.int64), device=device)

    B = int(a["bell_B"])
    nbr = np.asarray(a["bell_nbr"], np.int64)
    NB, KB = nbr.shape
    fold_slots, fold_idx = bellm.gather_plan(a["bell_map"])
    if fold_slots.size and fold_slots[-1] >= NB * KB * B * B:
        raise ValueError("bell_map addresses slots outside (NB, KB, B, B)")
    n = np.asarray(a["nodes"]).shape[0]
    nz_pos = bellm.structural_view(nbr, fold_slots, n, B)
    return Mesh(
        nodes=f("nodes"), cells=i(a["cells"]), area=f("area"),
        grads=f("grads"), node_area=f("node_area"),
        cell_valid=f("cell_valid"), inc_map=i(a["inc_map"]),
        bell_nbr=i(nbr), bell_map=i(a["bell_map"]),
        bell_diag_pos=i(a["bell_diag_pos"]), bell_B=B,
        bell_fold_slots=i(fold_slots), bell_fold_idx=i(fold_idx),
        bell_nz_pos=torch.as_tensor(nz_pos, device=device))


def build_mesh(nodes: np.ndarray, cells: np.ndarray, *, dtype=torch.float64,
               device="cpu", operator: str = "bell",
               bell_block: int = 128) -> Mesh:
    """Construct a device Mesh from raw arrays (host-side preprocessing).
    Nodes should already be ordered for block locality (RCB, api/model)."""
    if operator != "bell":
        raise NotImplementedError(
            f"operator {operator!r}: the port has block-ELL only so far; "
            "scalar ELL and block-CSR are ROADMAP, still to port, item 1")
    nodes = np.asarray(nodes, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int32)
    if cells.size and (cells.min() < 0 or cells.max() >= nodes.shape[0]):
        raise ValueError("cell connectivity references nonexistent nodes")
    signed_area, grads = cell_geometry(nodes, cells)
    if np.any(signed_area == 0.0):
        raise ValueError("mesh contains degenerate (zero-area) cells")
    area = np.abs(signed_area)
    n = nodes.shape[0]
    node_area = np.zeros(n)
    np.add.at(node_area, cells.reshape(-1), np.repeat(area, 3))
    nbr, bmap, dpos, _ = bellm.build_block_ell(cells, n, bell_block)
    arrays = dict(
        nodes=nodes, cells=cells, area=area, grads=grads,
        node_area=np.where(node_area == 0.0, 1.0, node_area),
        cell_valid=np.ones(cells.shape[0]),
        inc_map=incidence_map(cells, n),
        bell_nbr=nbr, bell_map=bmap, bell_diag_pos=dpos, bell_B=bell_block)
    return mesh_from_arrays(arrays, dtype=dtype, device=device)
