"""Core FEM data-movement primitives on torch tensors: gather, cellwise
gradients, incidence-gather accumulation and cell->node averaging.

Port of shakti_tpu/fem/ops.py.  Every sum over a short axis (3 corners, the
quadrature points, the 2 gradient components, the node incidence slots) is
:func:`fixed_sum`: elementwise adds in index order.  That makes each result
independent of any trailing batch axis (the multi-column residual is then
bit-identical per column to the single-column one) and identical from run
to run on CUDA, where ``index_add_``/``scatter_add_`` would sum with atomics
in a varying order.
"""

from __future__ import annotations

import numpy as np
import torch


def fixed_sum(x, dim: int):
    """Sum over ``dim`` as left-to-right elementwise adds (fixed order)."""
    parts = torch.unbind(x, dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def center(fc):
    """Corner values minus their per-cell mean (axis 1 holds the corners).
    Exact in real arithmetic because the P1 basis gradients sum to zero, and
    essential in f32: N ~ 1e6 Pa varies by ~1e2-1e3 within a cell."""
    return fc - (fixed_sum(fc, 1) / 3.0).unsqueeze(1)


def gather_cells(mesh, f):
    """(n_nodes, ...) -> (n_cells, 3, ...): values at each cell's corners."""
    return f[mesh.cells]


def cell_grad(mesh, f):
    """Cellwise-constant gradient of a P1 nodal field, mean-centred.

    f: (n_nodes,) -> (n_cells, 2);  f: (n_nodes, k) -> (n_cells, k, 2)."""
    fc = center(f[mesh.cells])
    if f.dim() == 1:
        return fixed_sum(fc[:, :, None] * mesh.grads, 1)
    return fixed_sum(fc[:, :, :, None] * mesh.grads[:, :, None, :], 1)


def scatter_add_cells(mesh, contrib):
    """Accumulate per-cell-corner contributions into nodal arrays.

    contrib: (n_cells, 3) or (n_cells, 3, k) -> (n_nodes,) / (n_nodes, k).
    A gather over the node->(cell, corner) incidence map: invalid slots hold
    the sentinel 3*n_cells, which indexes one appended zero row."""
    flat = contrib.reshape((-1,) + tuple(contrib.shape[2:]))
    ext = torch.cat([flat, flat.new_zeros((1,) + tuple(flat.shape[1:]))])
    return fixed_sum(ext[mesh.inc_map], 1)


def cell_to_node_avg(mesh, fc):
    """Area-weighted average of a cellwise-constant quantity at nodes.

    fc: (n_cells,) or (n_cells, k) -> (n_nodes,) / (n_nodes, k)."""
    w = mesh.area * mesh.cell_valid
    wf = fc * w if fc.dim() == 1 else fc * w[:, None]
    contrib = wf[:, None].expand((mesh.n_cells, 3) + tuple(wf.shape[1:]))
    s = scatter_add_cells(mesh, contrib)
    na = mesh.node_area if fc.dim() == 1 else mesh.node_area[:, None]
    live = na > 0
    return torch.where(live, s / torch.where(live, na, 1.0), 0.0)


def cellnodal_to_node_avg(mesh, v):
    """Area-weighted average of per-(cell, corner) values at nodes.

    v: (n_cells, 3) or (n_cells, 3, k) -> (n_nodes,) / (n_nodes, k).
    Dead slots (zero node area) yield 0, not 0/0 = NaN."""
    w = mesh.area * mesh.cell_valid
    wv = v * w[:, None] if v.dim() == 2 else v * w[:, None, None]
    s = scatter_add_cells(mesh, wv)
    na = mesh.node_area if v.dim() == 2 else mesh.node_area[:, None]
    live = na > 0
    return torch.where(live, s / torch.where(live, na, 1.0), 0.0)


def interpolate_at_quad(phi, fc):
    """P1 fields at quadrature points from corner values.

    phi: (nq, 3); fc: (c, 3) or (c, 3, k) -> (c, nq) or (c, nq, k)."""
    if fc.dim() == 2:
        return fixed_sum(phi[None, :, :] * fc[:, None, :], 2)
    return fixed_sum(phi[None, :, :, None] * fc[:, None, :, :], 2)


def gather_plan(keys: np.ndarray):
    """Host-side plan for a deterministic segment sum over ``keys``.

    Returns (slots (U,) the distinct keys, idx (U, M) the positions of each
    key's values in input order, padded with the sentinel len(keys), which
    indexes an appended zero).  :func:`plan_sum` applies it."""
    keys = np.asarray(keys, dtype=np.int64).reshape(-1)
    order = np.argsort(keys, kind="stable")
    slots, start, counts = np.unique(keys[order], return_index=True,
                                     return_counts=True)
    M = int(counts.max()) if counts.size else 0
    idx = np.full((slots.size, M), keys.size, dtype=np.int64)
    rank = np.arange(keys.size) - np.repeat(start, counts)
    idx[np.repeat(np.arange(slots.size), counts), rank] = order
    return slots, idx


def plan_sum(values, slots, idx, size: int):
    """out (size,) with out[slots[u]] = sum_m values[idx[u, m]] summed in m
    order, zero elsewhere: a segment sum without atomics."""
    flat = values.reshape(-1)
    ext = torch.cat([flat, flat.new_zeros(1)])
    out = flat.new_zeros(size)
    out[slots] = fixed_sum(ext[idx], 1)
    return out


def chunked_plan(keys: np.ndarray, positions: np.ndarray, sentinel: int,
                 chunk: int = 64):
    """Host-side plan for a deterministic segment sum whose segments are
    long and of very different lengths (a coarse operator's aggregate
    pairs): value ``positions[e]`` belongs to segment ``keys[e]``.

    Each segment's values, in input order, are cut into chunks of at most
    ``chunk``.  Returns (slots (U,) the distinct keys, idx1 (C, chunk) the
    value positions of every chunk padded with ``sentinel`` (an appended
    zero), idx2 (U, M) the chunks of every segment padded with the sentinel
    C).  :func:`chunked_sum` applies it: two gathers and two sums whatever
    the longest segment, where :func:`gather_plan` would pad every segment
    to it."""
    keys = np.asarray(keys, np.int64).reshape(-1)
    positions = np.asarray(positions, np.int64).reshape(-1)
    order = np.argsort(keys, kind="stable")
    slots, start, counts = np.unique(keys[order], return_index=True,
                                     return_counts=True)
    rank = np.arange(keys.size) - np.repeat(start, counts)
    nchunks = -(-counts // chunk)                       # chunks per segment
    first = np.concatenate([[0], np.cumsum(nchunks)[:-1]]).astype(np.int64)
    C = int(nchunks.sum())
    idx1 = np.full((C, chunk), sentinel, np.int64)
    idx1[np.repeat(first, counts) + rank // chunk, rank % chunk] = \
        positions[order]
    M = int(nchunks.max()) if nchunks.size else 0
    idx2 = np.full((slots.size, M), C, np.int64)
    within = np.arange(C) - np.repeat(first, nchunks)
    idx2[np.repeat(np.arange(slots.size), nchunks), within] = np.arange(C)
    return slots, idx1, idx2


def chunked_sum(values, slots, idx1, idx2, size: int):
    """out (size,) with out[slots[u]] = the sum of segment u's values of
    :func:`chunked_plan`, zero elsewhere: each chunk summed, then each
    segment's chunks; no atomics, the same order in every run."""
    flat = values.reshape(-1)
    part = torch.cat([flat, flat.new_zeros(1)])[idx1].sum(dim=1)
    seg = torch.cat([part, part.new_zeros(1)])[idx2].sum(dim=1)
    out = flat.new_zeros(size)
    out[slots] = seg
    return out
