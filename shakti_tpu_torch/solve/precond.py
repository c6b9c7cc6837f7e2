"""Preconditioners for the Newton linear solves: Jacobi, the additive
two-level (Jacobi + Galerkin coarse correction over contiguous aggregates)
and the multilevel V-cycle 'mg' (solve/mg.py).

Port of shakti_tpu/solve/precond.py.  The two-level coarse
operator is rebuilt from the folded values where they tile the aggregates
(:func:`coarse_from_values`: always for ELL and block-CSR, whose values are
stored entry by entry (fem/ell.py); for block-ELL when the aggregate is a
multiple of the block edge or divides it), else from the element blocks
(:func:`coarse_inverse`, also the matrix-free operator's).  Every aggregate
sum is a deterministic gather over a host-built plan, cached per
(structure, block), not an atomic scatter.  On a rank's share of a
node-sharded mesh (parallel/dist.py) 'two_level' is the global two-level
(one coarse operator summed over the ranks) or the per-rank one
(:func:`make_global_two_level`, :func:`make_local_two_level`).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from shakti_tpu_torch.fem.ops import (chunked_plan, chunked_sum, gather_plan,
                                      plan_sum)
from shakti_tpu_torch.ops import element_cuda
PRECONDITIONERS = ("jacobi", "two_level", "mg")


def make_jacobi(a_diag, dirichlet, tiny):
    safe = torch.where(torch.abs(a_diag) < tiny, 1.0, a_diag)
    minv = torch.where(dirichlet, 1.0, 1.0 / safe)
    return lambda r: minv * r


def regularized_inverse(A_c, m, dtype, tiny):
    """Inverse of a dense coarse operator with 1e-8 * mean|diag| added to
    its diagonal (empty or fully constrained aggregates), inverted once so
    that each apply is one small matvec."""
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
    return regularized_inverse(A_c, m, dtype, torch.finfo(dtype).tiny)


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
    return regularized_inverse(A_c, m, dtype, torch.finfo(dtype).tiny)


def two_level_from_inverse(A_inv, a_diag, dirichlet, block: int, n: int):
    """Two-level apply z = D^{-1} r + P A_inv P^T r from a prebuilt coarse
    inverse (possibly carried from an earlier step).  A batch: A_inv (M, m,
    m), a_diag and r (M, n), the coarse product ``torch.matmul``."""
    m = A_inv.shape[-1]
    pad = m * block - n
    tiny = torch.finfo(a_diag.dtype).tiny
    jacobi = make_jacobi(a_diag, dirichlet, tiny)

    def apply(r):
        rf = torch.where(dirichlet, 0.0, r)
        rc = torch.nn.functional.pad(rf, (0, pad)).reshape(
            *rf.shape[:-1], m, block).sum(dim=-1)
        zc = (A_inv @ rc if A_inv.dim() == 2
              else torch.matmul(A_inv, rc.unsqueeze(-1)).squeeze(-1))
        z_coarse = torch.repeat_interleave(zc, block, dim=-1)[..., :n]
        return jacobi(r) + torch.where(dirichlet, 0.0, z_coarse)

    return apply


def make_two_level(J_c, mesh, dirichlet, a_diag, block: int = 64,
                   vals=None):
    """Additive two-level preconditioner for A = -J: z = D^{-1} r +
    P (A_c^{-1} (P^T r)), P piecewise constant over contiguous aggregates of
    ``block`` nodes.  The coarse operator comes from the folded row-storage
    ``vals`` where they tile the aggregates, else from the element blocks
    ``J_c``."""
    if vals is not None and vals_coarse_ok(mesh, block):
        A_inv = coarse_from_values(vals, mesh, dirichlet, block)
    else:
        A_inv = coarse_inverse(J_c, mesh, dirichlet, block)
    return two_level_from_inverse(A_inv, a_diag, dirichlet, block,
                                  mesh.n_nodes)


def _rank_plans(mesh, block=None):
    """The host plans of the distributed two-level builds on ``mesh`` (a
    rank's share), cached on its cells tensor: the coarse operator's sum
    over the 9c element entries by (row, column) aggregate (chunked: an
    aggregate pair gathers up to ~18 * block entries) and, for the global
    two-level, the restriction's sum over ``coarse_agg``."""
    key = ("rank", id(mesh.cells), block, mesh.n_nodes)
    plan = _PLANS.get(key)
    if plan is None:
        cells = mesh.cells.cpu().numpy()
        if block is None:               # global aggregates
            agg = mesh.coarse_agg.cpu().numpy().astype(np.int64)
            a3, m = agg[cells], mesh.coarse_m
        else:
            a3, m = cells // block, -(-mesh.n_nodes // block)
        keys = (a3[:, :, None] * m + a3[:, None, :]).reshape(-1)
        dev = mesh.cells.device
        plan = tuple(torch.as_tensor(a, device=dev) for a in
                     chunked_plan(keys, np.arange(keys.size), keys.size))
        if block is None:
            plan = plan + tuple(torch.as_tensor(a, device=dev)
                                for a in gather_plan(agg))
        _PLANS[key] = plan
        weakref.finalize(mesh.cells, _PLANS.pop, key, None)
    return plan


def _free_coarse(J_c, mesh, free, plan, m):
    """The Galerkin coarse sum of the rank's free-masked element entries,
    (m*m,): the rank's share, before any sum over the ranks."""
    wc = free[mesh.cells]                                        # (c, 3)
    flat = -J_c * (wc[:, :, None] * wc[:, None, :])
    return chunked_sum(flat, *plan[:3], m * m)


def make_local_two_level(J_c, mesh, dirichlet, a_diag, block: int = 64):
    """Per-rank additive two-level on a node-sharded mesh (``mesh.halo``):
    each rank Galerkin-coarsens its own cells over contiguous local
    aggregates restricted to its owned rows, inverts its coarse problem, and
    pushes the owners' corrections into the ghost copies (one exchange per
    apply).  Block-Jacobi across ranks at the coarse level (the JAX
    package's make_local_two_level)."""
    halo = mesh.halo
    n = mesh.n_nodes
    m = -(-n // block)
    dtype = a_diag.dtype
    tiny = torch.finfo(dtype).tiny
    jacobi = make_jacobi(a_diag, dirichlet, tiny)
    own = halo.owned_mask
    free = (~dirichlet).to(dtype) * own
    A_c = _free_coarse(J_c, mesh, free, _rank_plans(mesh, block), m)
    A_inv = regularized_inverse(A_c.reshape(m, m), m, dtype, tiny)
    pad = m * block - n

    def apply(r):
        rf = torch.where(dirichlet, 0.0, r) * own
        rc = torch.nn.functional.pad(rf, (0, pad)).reshape(m, block).sum(dim=1)
        z = torch.repeat_interleave(A_inv @ rc, block)[:n] * own
        return jacobi(r) + torch.where(dirichlet, 0.0, halo.push(z))

    return apply


def make_global_two_level(J_c, mesh, dirichlet, a_diag):
    """The global additive two-level on a node-sharded mesh (``mesh.halo``
    with ``mesh.coarse_agg``, the global aggregate of each local slot): each
    rank sums its own cells' entries of the one global Galerkin coarse
    operator, a sum over the ranks completes it (cells are partitioned
    disjointly), and every rank inverts the same matrix.  An apply is an
    owned-masked restriction, one sum of the m-vector over the ranks and a
    small product; the prolonged correction is the same on every copy of a
    node, so no push (the JAX package's make_global_two_level)."""
    halo = mesh.halo
    agg, m = mesh.coarse_agg, mesh.coarse_m
    dtype = a_diag.dtype
    tiny = torch.finfo(dtype).tiny
    jacobi = make_jacobi(a_diag, dirichlet, tiny)
    plan = _rank_plans(mesh)
    free = (~dirichlet).to(dtype)
    A_c = halo.allsum(_free_coarse(J_c, mesh, free, plan, m))
    A_inv = regularized_inverse(A_c.reshape(m, m), m, dtype, tiny)
    own = halo.owned_mask

    def apply(r):
        rf = torch.where(dirichlet, 0.0, r) * own
        rc = halo.allsum(plan_sum(rf, *plan[3:], m))
        return jacobi(r) + torch.where(dirichlet, 0.0, (A_inv @ rc)[agg])

    return apply


def make_preconditioner(name: str, mesh, dirichlet, a_diag,
                        coarse_block: int = 64, *, vals=None, J_c=None,
                        matvec=None, mg_omega: float = 0.8,
                        mg_smoother: str = "jacobi", mg_cheb_deg: int = 2,
                        mg_cheb_frac: float = 0.25, mg_cycle: str = "v",
                        mg_smooth_p: float = 0.0):
    """'jacobi'; the additive 'two_level' for A = -J with its coarse
    operator built from the folded ``vals`` where they tile the aggregates,
    else from the element blocks ``J_c``; or the multilevel 'mg' V-cycle
    (solve/mg.py) from ``J_c`` and the fine ``matvec`` the Krylov solver
    gets, which becomes 'two_level' on a mesh without a hierarchy (at or
    below mg_coarse_cap nodes).

    On a rank's share of a distributed mesh: the cell-sharded step
    (``mesh.paxis``) takes Jacobi whatever ``name``; a node-sharded rank
    (``mesh.halo``) takes for 'two_level' the global two-level when the
    mesh carries global aggregates, else the per-rank one when the rank has
    at least 4 aggregates' worth of slots, else Jacobi (the JAX package's
    dispatch)."""
    tiny = torch.finfo(a_diag.dtype).tiny
    if mesh.paxis is not None:
        return make_jacobi(a_diag, dirichlet, tiny)
    if name == "mg":
        if mesh.mg is not None:
            from shakti_tpu_torch.solve.mg import make_multilevel
            return make_multilevel(J_c, mesh, dirichlet, a_diag, matvec,
                                   omega=mg_omega, smoother=mg_smoother,
                                   cheb_deg=mg_cheb_deg,
                                   cheb_frac=mg_cheb_frac, cycle=mg_cycle,
                                   smooth_p=mg_smooth_p)
        name = "two_level"
    if name == "two_level" and mesh.halo is not None:
        if mesh.coarse_agg is not None:
            return make_global_two_level(J_c, mesh, dirichlet, a_diag)
        if mesh.n_nodes >= 4 * coarse_block:
            return make_local_two_level(J_c, mesh, dirichlet, a_diag,
                                        coarse_block)
        return make_jacobi(a_diag, dirichlet, tiny)
    if name == "two_level":
        return make_two_level(J_c, mesh, dirichlet, a_diag, coarse_block,
                              vals=vals)
    if name == "jacobi":
        return make_jacobi(a_diag, dirichlet, tiny)
    raise ValueError(f"preconditioner must be one of {PRECONDITIONERS}, "
                     f"got {name!r}")


def make_preconditioner_batched(name: str, mesh, dirichlet, a_diag,
                                coarse_block: int = 64, *, J_c=None,
                                matvecs=None, **mg_kw):
    """:func:`make_preconditioner` for an ensemble's M operators (a_diag
    (M, n), ``J_c`` (M, c, 3, 3), ``matvecs`` the members' single matvecs):
    an apply (M, n) -> (M, n).  Jacobi and two-level are batched (the coarse
    operators from ops/element_cuda.coarse, their inverses (M, m, m) by
    ``torch.func.vmap``); 'mg' builds and applies each member's own V-cycle
    in turn (a batched mg apply is future work)."""
    if name == "mg" and mesh.mg is not None:
        applies = [make_preconditioner(
            "mg", mesh, dirichlet, a_diag[m], coarse_block, J_c=J_c[m],
            matvec=matvecs[m], **mg_kw) for m in range(a_diag.shape[0])]
        return lambda r: torch.stack([f(r[m]) for m, f in enumerate(applies)])
    if name in ("mg", "two_level"):
        A_c = element_cuda.coarse(mesh, J_c, dirichlet, coarse_block)
        m, dtype = A_c.shape[-1], A_c.dtype
        A_inv = torch.func.vmap(lambda A: regularized_inverse(
            A, m, dtype, torch.finfo(dtype).tiny))(A_c)
        return two_level_from_inverse(A_inv, a_diag, dirichlet, coarse_block,
                                      mesh.n_nodes)
    return make_preconditioner(name, mesh, dirichlet, a_diag, coarse_block)
