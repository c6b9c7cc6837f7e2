"""Preconditioners for the Newton linear solves: Jacobi and the additive
two-level (Jacobi + Galerkin coarse correction over contiguous aggregates).

Port of shakti_tpu/solve/precond.py for the block-ELL operator.  The coarse
operator is rebuilt from the folded block values; its aggregate sum is a
deterministic gather (:func:`coarse_plan`), not an atomic scatter.  The
multilevel preconditioner ('mg') is not ported yet (ROADMAP).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from shakti_tpu_torch.fem.bell import gather_plan, plan_sum


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
    """Do the block-ELL blocks tile the coarse aggregates exactly (the
    aggregate a multiple of the block edge, or dividing it)?"""
    B = int(mesh.bell_B)
    return block % B == 0 or B % block == 0


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


def coarse_plan(nbr: np.ndarray, B: int, block: int, n: int):
    """Host-side gather plan summing the (NB*KB [*sb*sb]) masked tile sums
    of :func:`coarse_from_values` into the flat (m*m,) coarse operator."""
    nbr = np.asarray(nbr, np.int64)
    NB, KB = nbr.shape
    m = -(-n // block)
    rb = np.repeat(np.arange(NB, dtype=np.int64), KB)
    ar, ac = _tile_ids(rb, nbr.reshape(-1), B, block, m)
    return gather_plan(ar * m + ac)


# (id(mesh.bell_nbr), block, n) -> the plan on nbr's device; an entry is
# dropped when its nbr tensor is freed, so an id is never reused stale
_PLANS: dict = {}


def _device_coarse_plan(mesh, block: int):
    """:func:`coarse_plan` for this mesh's block structure, built on the
    host once per (nbr, block) and kept on the operator's device."""
    nbr = mesh.bell_nbr
    key = (id(nbr), block, mesh.n_nodes)
    plan = _PLANS.get(key)
    if plan is None:
        slots, idx = coarse_plan(nbr.cpu().numpy(), int(mesh.bell_B), block,
                                 mesh.n_nodes)
        plan = (torch.as_tensor(slots, device=nbr.device),
                torch.as_tensor(idx, device=nbr.device))
        _PLANS[key] = plan
        weakref.finalize(nbr, _PLANS.pop, key, None)
    return plan


def coarse_from_values(vals, mesh, dirichlet, block: int = 64):
    """Inverse of the Galerkin coarse operator A_c = P^T A|_free P from the
    folded block-ELL values: A_c[I, J] sums the free-masked entries with
    row aggregate I and column aggregate J."""
    if not vals_coarse_ok(mesh, block):
        raise NotImplementedError(
            f"coarse_block={block} neither divides nor is a multiple of the "
            f"block edge {mesh.bell_B}; the element-scatter coarse build is "
            "not ported yet (ROADMAP, still to port, item 1)")
    n = mesh.n_nodes
    m = -(-n // block)
    dtype = vals.dtype
    tiny = torch.finfo(dtype).tiny
    B = int(mesh.bell_B)
    NB, KB = mesh.bell_nbr.shape
    free = (~dirichlet).to(dtype)
    freep = torch.nn.functional.pad(free, (0, NB * B - n)).reshape(NB, B)
    fc = freep[mesh.bell_nbr]                                    # (NB, KB, B)
    masked = (vals * freep[:, None, :, None]
              * fc[:, :, None, :]).reshape(NB * KB, B, B)
    if block % B == 0:
        s = masked.sum(dim=(1, 2))
    else:
        sb = B // block
        s = masked.reshape(NB * KB, sb, block, sb, block).sum(dim=(2, 4))
    slots, idx = _device_coarse_plan(mesh, block)
    A_c = plan_sum(s, slots, idx, m * m).reshape(m, m)
    return _regularized_inverse(A_c, m, dtype, tiny)


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
                        coarse_block: int = 64, *, vals=None):
    """'jacobi', or the additive 'two_level' for A = -J with its coarse
    operator built from the folded values."""
    if name == "two_level":
        A_inv = coarse_from_values(vals, mesh, dirichlet, coarse_block)
        return two_level_from_inverse(A_inv, a_diag, dirichlet, coarse_block,
                                      mesh.n_nodes)
    if name == "jacobi":
        return make_jacobi(a_diag, dirichlet, torch.finfo(a_diag.dtype).tiny)
    raise NotImplementedError(
        f"preconditioner {name!r}: the multilevel V-cycle ('mg') is not "
        "ported yet (ROADMAP, still to port, item 8)")
