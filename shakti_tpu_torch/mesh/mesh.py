"""Device-side mesh: a frozen dataclass of tensors.

Port of shakti_tpu/mesh/mesh.py.  For P1 triangles the dof map is the cell
connectivity, so the function space is the arrays below plus derived static
geometry, and at most one assembled-operator format: block-ELL ('bell'),
scalar ELL ('ell'), block-CSR ('bcsr'), or none ('cells': the matrix-free
operator).  Index arrays are int64 (torch's indexing type); the JAX
package's int32 ids map onto them value for value.  The deterministic fold
plans (fem/ops.gather_plan) and the scalar-ELL views the CUDA kernels read
are derived here, once per mesh; for ELL and block-CSR the plan is
renumbered to the view, so the fold writes the structural values the kernel
reads (fem/ell.fold_structural).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shakti_tpu_torch.fem import bcsr as bcsrm
from shakti_tpu_torch.fem import bell as bellm
from shakti_tpu_torch.fem import ell as ellm
from shakti_tpu_torch.fem.ops import gather_plan

OPERATORS = ("bell", "ell", "bcsr", "cells")


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
    bell_nbr: torch.Tensor | None = None       # (NB, KB) neighbour block ids
    bell_map: torch.Tensor | None = None       # (9c,) element -> flat position
    bell_diag_pos: torch.Tensor | None = None  # (n_nodes,) flat diagonal
    bell_B: int | None = None
    # deterministic fold of the 9c element entries: distinct flat positions
    # (U,) and the element entries of each (U, M)
    bell_fold_slots: torch.Tensor | None = None
    bell_fold_idx: torch.Tensor | None = None
    # scalar-ELL view of the structural nonzeros (fem/bell.structural_view),
    # what csrc/bell_spmv.cu reads: (W, n_nodes) int32 flat positions, -1 pad
    bell_nz_pos: torch.Tensor | None = None
    # scalar ELL structure (fem/ell.py)
    ell_cols: torch.Tensor | None = None       # (n_nodes, K) neighbour ids
    ell_map: torch.Tensor | None = None        # (9c,) element -> flat slot
    ell_diag_slot: torch.Tensor | None = None  # (n_nodes,) diagonal slot
    # block-CSR structure (fem/bcsr.py)
    bcsr_brow: torch.Tensor | None = None      # (nnzb,) block rows (sorted)
    bcsr_bcol: torch.Tensor | None = None      # (nnzb,) block columns
    bcsr_blk: torch.Tensor | None = None       # (9c,) element -> block id
    bcsr_off: torch.Tensor | None = None       # (9c,) within-block offset
    bcsr_diag_blk: torch.Tensor | None = None  # (n_nodes,)
    bcsr_diag_off: torch.Tensor | None = None  # (n_nodes,)
    bcsr_B: int | None = None
    bcsr_NB: int | None = None
    # the plain matvec's fixed-order sum over each block row's blocks
    bcsr_row_slots: torch.Tensor | None = None  # (NB',) block rows
    bcsr_row_idx: torch.Tensor | None = None    # (NB', M) block ids, pad nnzb
    # the ELL or BCSR structural storage (fem/ell.py): values svals
    # (W, n_nodes) in the order of fem/ell.scalar_view
    nz_col: torch.Tensor | None = None  # (W, n) int32 columns (pads: the row)
    # (W, n) int64 flat positions in the JAX package's dense layout, -1 pad
    # (to_dense / from_dense only)
    nz_pos: torch.Tensor | None = None
    # the fold of the 9c element entries in view order: (W * n, M), the
    # element entries of each slot, sentinel 9c on pads
    nz_fold_idx: torch.Tensor | None = None
    nz_diag: torch.Tensor | None = None  # (n,) flat slot of the diagonal
    # the multilevel hierarchy (solve/mg.MGPlan) when precond='mg'
    mg: object | None = None
    # node-sharded ranks (parallel/dist.py): this mesh is one rank's
    # [owned | ghosts | dump] view; assembly completes through
    # halo.accumulate and reductions through halo.dot / halo.norm
    halo: object | None = None
    # cell-sharded ranks (parallel/shard.py): this mesh holds the rank's
    # cells over the replicated global nodes; assembly completes with one
    # paxis.allsum (parallel/halo.Collectives)
    paxis: object | None = None
    # halo meshes: the GLOBAL coarse aggregate (solver-order node id //
    # block) of each local slot, for the global two-level preconditioner
    # (solve/precond.make_global_two_level), and the aggregate count
    coarse_agg: torch.Tensor | None = None
    coarse_m: int | None = None

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def structural(self) -> bool:
        """Does the operator store its structural entries alone (``svals``
        (W, n), fem/ell.py)?  Block-CSR and scalar ELL do; block-ELL keeps
        its dense blocks, the matrix-free operator stores nothing."""
        return self.nz_col is not None


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
    """Mesh from host arrays under the field names of both packages' Mesh:
    nodes, cells, area, grads, node_area, cell_valid, inc_map, and the
    bell_*, ell_* or bcsr_* fields of one operator format (none: the
    matrix-free 'cells' operator).  Derives the fold plans and the
    scalar-ELL view of that format."""
    def f(k):
        return torch.as_tensor(np.array(a[k], np.float64), dtype=dtype,
                               device=device)

    def i(x):
        return torch.as_tensor(np.array(x, np.int64), device=device)

    def i32(x):
        return torch.as_tensor(x, device=device)

    def structural(pos, col, slots, idx, diag_pos, n_entries):
        """The structural storage's tables from a format's view and fold
        plan."""
        return dict(nz_pos=i(pos), nz_col=i32(col),
                    nz_fold_idx=i(ellm.structural_plan(pos, slots, idx,
                                                       n_entries)),
                    nz_diag=i(ellm.diag_slots(pos, diag_pos)))

    n = np.asarray(a["nodes"]).shape[0]
    kw = {}
    if a.get("bcsr_brow") is not None:
        B, NB = int(a["bcsr_B"]), int(a["bcsr_NB"])
        brow, bcol = a["bcsr_brow"], a["bcsr_bcol"]
        slots, idx = gather_plan(bcsrm.fold_keys(a["bcsr_blk"], a["bcsr_off"], B))
        nnzb = np.asarray(brow).shape[0]
        if slots.size and slots[-1] >= nnzb * B * B:
            raise ValueError("bcsr_blk/bcsr_off address slots outside "
                             "(nnzb, B, B)")
        row_slots, row_idx = gather_plan(brow)
        pos, col = bcsrm.bcsr_view(brow, bcol, slots, n, B)
        dpos = (np.asarray(a["bcsr_diag_blk"], np.int64) * (B * B)
                + np.asarray(a["bcsr_diag_off"], np.int64))
        kw = dict(bcsr_brow=i(brow), bcsr_bcol=i(bcol), bcsr_blk=i(a["bcsr_blk"]),
                  bcsr_off=i(a["bcsr_off"]), bcsr_diag_blk=i(a["bcsr_diag_blk"]),
                  bcsr_diag_off=i(a["bcsr_diag_off"]), bcsr_B=B, bcsr_NB=NB,
                  bcsr_row_slots=i(row_slots), bcsr_row_idx=i(row_idx),
                  **structural(pos, col, slots, idx, dpos,
                               np.asarray(a["bcsr_blk"]).size))
    elif a.get("bell_nbr") is not None:
        B = int(a["bell_B"])
        nbr = np.asarray(a["bell_nbr"], np.int64)
        NB, KB = nbr.shape
        slots, idx = gather_plan(a["bell_map"])
        if slots.size and slots[-1] >= NB * KB * B * B:
            raise ValueError("bell_map addresses slots outside (NB, KB, B, B)")
        kw = dict(bell_nbr=i(nbr), bell_map=i(a["bell_map"]),
                  bell_diag_pos=i(a["bell_diag_pos"]), bell_B=B,
                  bell_fold_slots=i(slots), bell_fold_idx=i(idx),
                  bell_nz_pos=i32(bellm.structural_view(nbr, slots, n, B)))
    elif a.get("ell_cols") is not None:
        cols = np.asarray(a["ell_cols"])
        slots, idx = gather_plan(a["ell_map"])
        if slots.size and slots[-1] >= cols.size:
            raise ValueError("ell_map addresses slots outside (n, K)")
        pos, col = ellm.ell_view(cols, slots)
        dpos = (np.arange(n, dtype=np.int64) * cols.shape[1]
                + np.asarray(a["ell_diag_slot"], np.int64))
        kw = dict(ell_cols=i(cols), ell_map=i(a["ell_map"]),
                  ell_diag_slot=i(a["ell_diag_slot"]),
                  **structural(pos, col, slots, idx, dpos,
                               np.asarray(a["ell_map"]).size))
    return Mesh(
        nodes=f("nodes"), cells=i(a["cells"]), area=f("area"),
        grads=f("grads"), node_area=f("node_area"),
        cell_valid=f("cell_valid"), inc_map=i(a["inc_map"]), **kw)


def build_mesh(nodes: np.ndarray, cells: np.ndarray, *, dtype=torch.float64,
               device="cpu", operator: str = "bell",
               bell_block: int = 128, node_area=None,
               cell_valid=None) -> Mesh:
    """Construct a device Mesh from raw arrays (host-side preprocessing).

    ``operator``: 'bell', 'ell', 'bcsr' (both block formats with block edge
    ``bell_block``) or 'cells' (no assembled operator).  Nodes should
    already be ordered for block locality (RCB, api/model) for the block
    formats.  ``node_area``: the nodal areas to use as they are (a rank's
    share of a distributed mesh: the global areas of its slots, zero at its
    dead slots) instead of the sums over ``cells``.  ``cell_valid``: 1 for
    real cells, 0 for padding cells (zero area and gradients, so they
    contribute nothing; a distributed rank that owns no cell keeps one)."""
    if operator not in OPERATORS:
        raise ValueError(f"operator must be one of {OPERATORS}, got "
                         f"{operator!r}")
    nodes = np.asarray(nodes, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int32)
    if cells.size and (cells.min() < 0 or cells.max() >= nodes.shape[0]):
        raise ValueError("cell connectivity references nonexistent nodes")
    valid = (np.ones(cells.shape[0]) if cell_valid is None
             else np.asarray(cell_valid, np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        signed_area, grads = cell_geometry(nodes, cells)
    if np.any((signed_area == 0.0) & (valid > 0)):
        raise ValueError("mesh contains degenerate (zero-area) cells")
    area = np.where(valid > 0, np.abs(signed_area), 0.0)
    grads = np.where(valid[:, None, None] > 0, grads, 0.0)
    n = nodes.shape[0]
    if node_area is None:
        node_area = np.bincount(cells.reshape(-1), weights=np.repeat(area, 3),
                                minlength=n)
        node_area = np.where(node_area == 0.0, 1.0, node_area)
    arrays = dict(
        nodes=nodes, cells=cells, area=area, grads=grads,
        node_area=np.asarray(node_area, np.float64), cell_valid=valid,
        inc_map=incidence_map(cells, n))
    if operator == "bell":
        nbr, bmap, dpos, _ = bellm.build_block_ell(cells, n, bell_block)
        arrays.update(bell_nbr=nbr, bell_map=bmap, bell_diag_pos=dpos,
                      bell_B=bell_block)
    elif operator == "ell":
        cols, smap, dslot = ellm.build_ell_map(cells, n)
        arrays.update(ell_cols=cols, ell_map=smap, ell_diag_slot=dslot)
    elif operator == "bcsr":
        br, bc, blk, off, dblk, doff, NB = bcsrm.build_bcsr(cells, n, bell_block)
        arrays.update(bcsr_brow=br, bcsr_bcol=bc, bcsr_blk=blk, bcsr_off=off,
                      bcsr_diag_blk=dblk, bcsr_diag_off=doff,
                      bcsr_B=bell_block, bcsr_NB=NB)
    return mesh_from_arrays(arrays, dtype=dtype, device=device)
