"""Preconditioners for the Newton linear solves: Jacobi and the additive
two-level (Jacobi + Galerkin coarse correction over contiguous aggregates).

Port of shakti_tpu/solve/precond.py.  The coarse operator is rebuilt from
the folded values where they tile the aggregates
(:func:`coarse_from_values`: always for ELL and block-CSR, whose values are
stored entry by entry (fem/ell.py); for block-ELL when the aggregate is a
multiple of the block edge or divides it), else from the element blocks
(:func:`coarse_inverse`, also the matrix-free operator's).  Every aggregate
sum is a deterministic gather over a host-built plan, cached per
(structure, block), not an atomic scatter.  The multilevel
preconditioner ('mg') is not ported yet (ROADMAP).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from shakti_tpu_torch.fem.ops import (chunked_plan, chunked_sum, gather_plan,
                                      plan_sum)


def make_jacobi(a_diag, dirichlet, tiny):
    safe = torch.where(torch.abs(a_diag) < tiny, 1.0, a_diag)
    minv = torch.where(dirichlet, 1.0, 1.0 / safe)
    return lambda r: minv * r


def _regularized_inverse(A_c, m, dtype, tiny):
    # regularize empty / fully-constrained aggregates, then invert once:
    # the per-Krylov-iteration apply is one small matvec
    dmean = torch.mean(torch.abs(torch.diagonal(A_c))) + tiny
    A_c = A_c + (1e-8 * dmean) * torch.eye(m, dtype=dtype, device=A_c.device)
    return torch.linalg.inv(A_c)


def vals_coarse_ok(mesh, block: int) -> bool:
    """Can :func:`coarse_from_values` build the coarse operator from the
    folded values?  Scalar ELL and block-CSR always (scalar entries tile
    any aggregate); block-ELL when its blocks tile the aggregates exactly
    (the aggregate a multiple of the block edge, or dividing it); the
    matrix-free operator never."""
    if mesh.structural:
        return True
    if mesh.bell_nbr is not None:
        B = int(mesh.bell_B)
        return block % B == 0 or B % block == 0
    return False


def _tile_ids(rb, cb, B: int, block: int, m: int):
    """Aggregate ids (row, col) of every (K, sb, sb) sub-tile (or (K,) whole
    block) at block-row/col ids rb/cb, clipped into [0, m): tiles wholly
    past the last node are all-zero (free mask 0), so clipping adds exact
    zeros."""
    if block % B == 0:
        spb = block // B
        ar, ac = rb // spb, cb // spb
    else:
        sb = B // block
        i = np.arange(sb)
        ar = rb[:, None, None] * sb + i[None, :, None]
        ac = cb[:, None, None] * sb + i[None, None, :]
        ar, ac = np.broadcast_arrays(ar, ac)
    return np.minimum(ar, m - 1).reshape(-1), np.minimum(ac, m - 1).reshape(-1)


def coarse_plan(rb, cb, B: int, block: int, n: int):
    """Host-side gather plan summing the masked whole-block or sub-tile sums
    of :func:`coarse_from_values` (blocks at block-row/col ids rb/cb) into
    the flat (m*m,) coarse operator."""
    m = -(-n // block)
    ar, ac = _tile_ids(np.asarray(rb, np.int64), np.asarray(cb, np.int64), B,
                       block, m)
    return gather_plan(ar * m + ac)


def _host_plan(mesh, block: int, elements: bool):
    """The plan of a coarse build's aggregate sum: a gather plan over the
    9c element entries (``elements``, :func:`coarse_inverse`) or over
    block-ELL's stored blocks or sub-tiles; for the structural values of
    ELL and block-CSR a chunked plan over the structural slots (an
    aggregate pair holds up to ~W * block of them, a neighbouring pair a
    few: fem/ops.chunked_plan)."""
    n = mesh.n_nodes
    m = -(-n // block)
    if elements:
        agg = mesh.cells.cpu().numpy() // block
        return gather_plan((agg[:, :, None] * m + agg[:, None, :]).reshape(-1))
    if mesh.structural:
        col = mesh.nz_col.cpu().numpy().astype(np.int64)
        at = np.flatnonzero(mesh.nz_pos.cpu().numpy().reshape(-1) >= 0)
        keys = (at % n) // block * m + col.reshape(-1)[at] // block
        return chunked_plan(keys, at, col.size)
    nbr = mesh.bell_nbr.cpu().numpy()
    NB, KB = nbr.shape
    return coarse_plan(np.repeat(np.arange(NB), KB), nbr.reshape(-1),
                       mesh.bell_B, block, n)


# (id(structure), block, n) -> the plan on the structure's device (the
# structure: the mesh's cells for the element path, else its format's index
# table); an entry is dropped when its structure tensor is freed, so an id
# is never reused stale
_PLANS: dict = {}


def _device_coarse_plan(mesh, block: int, elements: bool = False):
    """The coarse gather plan for this mesh and aggregate size, built on the
    host once per (structure, block) and kept on the mesh's device.
    ``elements``: the element path's plan (:func:`coarse_inverse`)."""
    owner = (mesh.cells if elements else mesh.nz_col
             if mesh.structural else mesh.bell_nbr)
    key = (id(owner), block, mesh.n_nodes)
    plan = _PLANS.get(key)
    if plan is None:
        plan = tuple(torch.as_tensor(a, device=owner.device)
                     for a in _host_plan(mesh, block, elements))
        _PLANS[key] = plan
        weakref.finalize(owner, _PLANS.pop, key, None)
    return plan


def coarse_inverse(J_c, mesh, dirichlet, block: int = 64):
    """Inverse of the Galerkin coarse operator A_c = P^T (-J)|_free P from
    the element blocks: the free-masked 9c element entries summed by
    (row aggregate, column aggregate).  For the matrix-free operator, and
    for block formats whose blocks do not tile the aggregates."""
    n = mesh.n_nodes
    m = -(-n // block)
    dtype = J_c.dtype
    free = (~dirichlet).to(dtype)
    wc = free[mesh.cells]                                        # (c, 3)
    flat = -J_c * (wc[:, :, None] * wc[:, None, :])
    slots, idx = _device_coarse_plan(mesh, block, elements=True)
    A_c = plan_sum(flat, slots, idx, m * m).reshape(m, m)
    return _regularized_inverse(A_c, m, dtype, torch.finfo(dtype).tiny)


def coarse_from_values(vals, mesh, dirichlet, block: int = 64):
    """Inverse of the Galerkin coarse operator from the folded values:
    A_c[I, J] sums the free-masked entries with row aggregate I and column
    aggregate J (the same sum as :func:`coarse_inverse`, grouped per stored
    entry first).  Needs :func:`vals_coarse_ok`."""
    if not vals_coarse_ok(mesh, block):
        raise ValueError(f"coarse_block={block} does not tile the mesh's "
                         "operator blocks; use coarse_inverse")
    n = mesh.n_nodes
    m = -(-n // block)
    dtype = vals.dtype
    free = (~dirichlet).to(dtype)
    if mesh.structural:             # structural values: ELL, BCSR
        s = vals * free * free[mesh.nz_col]
        A_c = chunked_sum(s, *_device_coarse_plan(mesh, block), m * m)
    else:
        B = int(mesh.bell_B)
        NB, KB = mesh.bell_nbr.shape
        freep = torch.nn.functional.pad(free, (0, NB * B - n)).reshape(NB, B)
        fc = freep[mesh.bell_nbr]                                # (NB, KB, B)
        masked = (vals * freep[:, None, :, None]
                  * fc[:, :, None, :]).reshape(NB * KB, B, B)
        if block % B == 0:
            s = masked.sum(dim=(1, 2))
        else:
            sb = B // block
            s = masked.reshape(NB * KB, sb, block, sb, block).sum(dim=(2, 4))
        A_c = plan_sum(s, *_device_coarse_plan(mesh, block), m * m)
    A_c = A_c.reshape(m, m)
    return _regularized_inverse(A_c, m, dtype, torch.finfo(dtype).tiny)


def two_level_from_inverse(A_inv, a_diag, dirichlet, block: int, n: int):
    """Two-level apply z = D^{-1} r + P A_inv P^T r from a prebuilt coarse
    inverse (possibly carried from an earlier step)."""
    m = A_inv.shape[0]
    pad = m * block - n
    tiny = torch.finfo(a_diag.dtype).tiny
    jacobi = make_jacobi(a_diag, dirichlet, tiny)

    def apply(r):
        rf = torch.where(dirichlet, 0.0, r)
        rc = torch.nn.functional.pad(rf, (0, pad)).reshape(m, block).sum(dim=1)
        zc = A_inv @ rc
        z_coarse = torch.repeat_interleave(zc, block)[:n]
        return jacobi(r) + torch.where(dirichlet, 0.0, z_coarse)

    return apply


def make_preconditioner(name: str, mesh, dirichlet, a_diag,
                        coarse_block: int = 64, *, vals=None, J_c=None):
    """'jacobi', or the additive 'two_level' for A = -J with its coarse
    operator built from the folded ``vals`` where they tile the aggregates,
    else from the element blocks ``J_c``."""
    if name == "two_level":
        if vals is not None and vals_coarse_ok(mesh, coarse_block):
            A_inv = coarse_from_values(vals, mesh, dirichlet, coarse_block)
        else:
            A_inv = coarse_inverse(J_c, mesh, dirichlet, coarse_block)
        return two_level_from_inverse(A_inv, a_diag, dirichlet, coarse_block,
                                      mesh.n_nodes)
    if name == "jacobi":
        return make_jacobi(a_diag, dirichlet, torch.finfo(a_diag.dtype).tiny)
    raise NotImplementedError(
        f"preconditioner {name!r}: the multilevel V-cycle ('mg') is not "
        "ported yet (ROADMAP, still to port, item 3)")
