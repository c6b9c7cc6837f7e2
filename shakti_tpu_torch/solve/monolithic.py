r"""Monolithic coupled steady-state Newton: solve for (N, b) simultaneously.

Port of shakti_tpu/solve/monolithic.py (its module docstring gives the
method, its design history and its measurements).  In brief: the staggered
PTC march (solve/steady.py) plateaus in channelized regimes (SHMIP A3-A6)
because the staggered b<->N coupling pins its pseudo-step; this module
solves the transient step's own fixed-point equations (:func:`_exact_residual`)
directly, in the unknowns (N, log b), with

- an exact, sparsity-compressed Jacobian: a greedy coloring of the 4-hop
  node conflict graph (:func:`_coloring_plan`, host numpy/scipy) lets 2K
  tangents of one batched forward-mode pass (``torch.func.vmap`` over
  ``torch.func.jvp``) fill the dense (n, 2, n, 2) matrix, which a dense LU
  solves (``linear="direct"``, up to ``dense_max_nodes``); beyond that an
  inexact Newton with element blocks and block-Jacobi BiCGStab;
- the gap bounds as a semismooth active set (bound-fixed b rows act as
  identity and may re-activate);
- Armijo on the trial point's own free set down a half-decade alpha ladder,
  every candidate evaluated in one batched residual, and pseudo-transient
  damping of the b row when pure Newton stalls.

Each ``lax.while_loop`` of the JAX package is a Python loop whose one test
per Newton iteration is the only host sync; every other decision stays
tensor arithmetic (``torch.where``).  :func:`steady_polish` repeats
:func:`polish` in segments, refreshing the frozen Warburton term, with the
JAX package's ``polish.npz`` (either package resumes the other's file).
Single device, suite-S scale.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any

import numpy as np
import torch

from shakti_tpu_torch.fem import ops
from shakti_tpu_torch.fem.p1 import quadrature
from shakti_tpu_torch.params import PhysicalParams
from shakti_tpu_torch.physics import constitutive as law
from shakti_tpu_torch.physics import residual as res
from shakti_tpu_torch.solve.krylov import bicgstab
from shakti_tpu_torch.utils.trace import span

YEAR = 3.1536e7


def _frozen_fields(mesh, static, state, params, quad_degree, dtype):
    """Per-polish frozen data: static forcing at quad points and the
    Warburton m_diff evaluated from the entry state (lagged, like the
    reference; refreshed between polish calls by steady_polish)."""
    dev = mesh.nodes.device
    phi_np, wq_np = quadrature(quad_degree)
    phi = torch.as_tensor(phi_np, dtype=dtype, device=dev)
    wq = torch.as_tensor(wq_np, dtype=dtype, device=dev)

    def at_q(f):
        return ops.interpolate_at_quad(phi, ops.gather_cells(mesh, f))

    sc = ops.gather_cells(mesh, torch.stack([state.b, state.melt], dim=1))
    s_q = ops.interpolate_at_quad(phi, sc)                    # (c, nq, 2)
    grads_sc = torch.sum(ops.center(sc)[:, :, :, None]
                         * mesh.grads[:, :, None, :], dim=1)  # (c, 2, 2)
    gb, gm = grads_sc[:, 0][:, None, :], grads_sc[:, 1][:, None, :]
    mdiff_q = law.melt_regularization(s_q[..., 0], s_q[..., 1], gb, gm)
    # the nodal lagged Warburton term of the transient (solve/timestep.py)
    mdiff_old_n = ops.cellnodal_to_node_avg(mesh, law.melt_regularization(
        ops.gather_cells(mesh, state.b), ops.gather_cells(mesh, state.melt),
        gb, gm))
    return {
        "phi": phi, "wq": wq, "gb0": static.gb0,
        "G_q": at_q(static.G), "inputs_q": at_q(static.inputs),
        "mdiff_q": mdiff_q, "mdiff_old_n": mdiff_old_n,
        "melt_entry": state.melt, "quad_degree": quad_degree,
        "sq": res.static_quad_fields(mesh, static, quad_degree, dtype),
    }


def _nan_safe_norm(gh2):
    """|v| from |v|^2 with the subgradient 0 at 0 (sqrt's tangent is NaN)."""
    live = gh2 > 0
    return torch.where(live, torch.sqrt(torch.where(live, gh2, 1.0)), 0.0)


def _cell_physics(N_c, b_c, fr, mesh, params: PhysicalParams):
    """Live per-cell physics from corner values: everything the two residual
    rows share.  Returns (q_q, m_q, C_q, N_q, b_q, grad_h)."""
    p = params
    grad_N = torch.sum(ops.center(N_c)[:, :, None] * mesh.grads, dim=1)
    grad_h = fr["gb0"] - grad_N / (p.rho_w * p.g)              # (c, 2)
    gh_mag = _nan_safe_norm(torch.sum(grad_h * grad_h, dim=-1))
    phi = fr["phi"]
    N_q = torch.sum(phi[None, :, :] * N_c[:, None, :], dim=2)  # (c, nq)
    b_q = torch.sum(phi[None, :, :] * b_c[:, None, :], dim=2)
    k_q = (torch.abs(b_q) ** 3) * p.g / (12.0 * p.nu)
    a = p.omega / p.nu
    s_q = k_q * gh_mag[:, None]
    qmag = 2.0 * s_q / (1.0 + torch.sqrt(1.0 + 4.0 * a * s_q))  # resolved |q|
    q_q = -(k_q / (1.0 + a * qmag))[:, :, None] * grad_h[:, None, :]
    diss_q = p.rho_w * p.g * qmag * gh_mag[:, None]           # -rho_w g q.grad h
    m_q = (fr["G_q"] + diss_q) / p.Lh + fr["mdiff_q"]
    C_q = law.closure(b_q, N_q, p)
    return q_q, m_q, C_q, N_q, b_q, grad_h


def _nodal_fields(u, fr, mesh, static, params: PhysicalParams):
    """The transient step's own q/melt data flow at its fixed point: nodal
    grad h (node average of the cellwise gradient), nodal q with the lagged
    Re self-consistent (the stable quadratic root), nodal melt with the
    frozen m_diff.  Returns (q (n, 2), melt (n,), grad_h_n (n, 2))."""
    p = params
    N, b = u[:, 0], _b_of(u, fr)
    grad_N = torch.sum(ops.center(ops.gather_cells(mesh, N))[:, :, None]
                       * mesh.grads, dim=1)
    grad_h_c = fr["gb0"] - grad_N / (p.rho_w * p.g)
    grad_h_n = ops.cellnodal_to_node_avg(
        mesh, grad_h_c[:, None, :].expand(-1, 3, -1))
    gh_mag = _nan_safe_norm(torch.sum(grad_h_n * grad_h_n, dim=-1))
    k = (torch.abs(b) ** 3) * p.g / (12.0 * p.nu)
    a = p.omega / p.nu
    s = k * gh_mag
    qmag = 2.0 * s / (1.0 + torch.sqrt(1.0 + 4.0 * a * s))
    q = -(k / (1.0 + a * qmag))[:, None] * grad_h_n
    melt = (static.G + p.rho_w * p.g * qmag * gh_mag) / p.Lh \
        + fr["mdiff_old_n"]
    return q, melt, grad_h_n


def _exact_residual(u, fr, mesh, static, params: PhysicalParams):
    """The transient step's own fixed-point defect (n, 2):

      R_N = the transient weak-form residual (physics/residual.py) with pre
            built from the live (N, b, q(u), melt(u));
      R_b = node_mass * (melt_i / rho_i - A b_i N_i |N_i|^2), the
            transient's nodal gap update frozen."""
    p = params
    N, b = u[:, 0], _b_of(u, fr)
    q, melt, _ = _nodal_fields(u, fr, mesh, static, params)
    # dt enters only the storage term, identically zero at N_n = N
    pre = res.precompute_step(mesh, N, b, q, fr["melt_entry"], static,
                              torch.ones((), dtype=N.dtype, device=N.device),
                              p, quad_degree=fr["quad_degree"], sq=fr["sq"])
    R_N = res.assemble_residual(N, pre, mesh, p)
    R_b = mesh.node_area / 3.0 * (melt / p.rho_i - law.closure(b, N, p))
    return torch.stack([R_N, R_b], dim=-1)


def _b_of(u_c, fr):
    """Gap values from the unknown's second slot: plain b, or exp(w) under
    the log-b parametrization (fr["log_b"])."""
    w = u_c[..., 1]
    return torch.exp(w) if fr.get("log_b") else w


def _corner_residual(u_c, fr, mesh, params: PhysicalParams):
    """Coupled element residual: u_c (c, 3, 2) with [..., 0] = N corner
    values, [..., 1] = b (or log b) -> (c, 3, 2)."""
    p = params
    N_c, b_c = u_c[..., 0], _b_of(u_c, fr)
    q_q, m_q, C_q, _, _, _ = _cell_physics(N_c, b_c, fr, mesh, params)
    wq, phi = fr["wq"], fr["phi"]
    c_m = 1.0 / p.rho_i - 1.0 / p.rho_w
    srcN_q = c_m * m_q - C_q - fr["inputs_q"]
    rb_q = m_q / p.rho_i - C_q                                  # db/dt [m/s]
    w_cell = mesh.area * mesh.cell_valid
    term_flux = -torch.sum(wq[None, :, None, None] * q_q[:, :, None, :]
                           * mesh.grads[:, None, :, :], dim=(1, 3))
    wphi = (wq[:, None] * phi)[None, :, :]                      # (1, nq, 3)
    term_srcN = torch.sum(wphi * srcN_q[:, :, None], dim=1)
    term_b = torch.sum(wphi * rb_q[:, :, None], dim=1)
    return torch.stack([w_cell[:, None] * (term_flux + term_srcN),
                        w_cell[:, None] * term_b], dim=-1)


def _tangents(fn, x, seeds):
    """d fn(x) . s for every seed s (leading axis), as one batched
    forward-mode pass."""
    return torch.func.vmap(lambda s: torch.func.jvp(fn, (x,), (s,))[1])(seeds)


def _element_jacobian6(u, fr, mesh, params):
    """(c, 3, 2, 3, 2) element blocks dR_ci,f / du_cj,g from six tangents
    (the coupled analogue of physics/residual.element_jacobian)."""
    u_c = ops.gather_cells(mesh, u)                             # (c, 3, 2)
    seeds = torch.eye(6, dtype=u.dtype, device=u.device).reshape(6, 1, 3, 2)
    T = _tangents(lambda x: _corner_residual(x, fr, mesh, params), u_c,
                  seeds.expand((6,) + tuple(u_c.shape)))        # (6, c, 3, 2)
    return T.permute(1, 2, 3, 0).reshape(u_c.shape + (3, 2))


@dataclasses.dataclass(frozen=True)
class _Masks:
    dirichlet: Any     # (n,) bool: N pinned
    active: Any        # (n,) bool: node participates at all (area > 0)


def _assemble_residual(u, fr, mesh, params, masks, fix_b):
    u_c = ops.gather_cells(mesh, u)
    R = ops.scatter_add_cells(mesh, _corner_residual(u_c, fr, mesh, params))
    RN = torch.where(masks.dirichlet | ~masks.active, 0.0, R[:, 0])
    Rb = torch.where(fix_b | ~masks.active, 0.0, R[:, 1])
    return torch.stack([RN, Rb], dim=-1)


def _make_matvec(J6, mesh, masks, fix_b, rb_scale, extra_diag_b=None):
    """Matrix-free action of the constrained, row-scaled Jacobian:
    constrained rows act as identity with their inputs zeroed first;
    ``extra_diag_b`` (n,) adds to the (b, b) diagonal (the pseudo-transient
    damping's Jacobian, scaled like its row)."""
    freeN = ~(masks.dirichlet | ~masks.active)
    freeb = ~(fix_b | ~masks.active)

    def matvec(x):
        xN = torch.where(freeN, x[:, 0], 0.0)
        xb = torch.where(freeb, x[:, 1], 0.0)
        xc = ops.gather_cells(mesh, torch.stack([xN, xb], dim=-1))
        yc = torch.sum(J6 * xc[:, None, None, :, :], dim=(3, 4))
        y = ops.scatter_add_cells(mesh, yc)
        yb_raw = y[:, 1]
        if extra_diag_b is not None:
            yb_raw = yb_raw + extra_diag_b * xb
        yN = torch.where(freeN, y[:, 0], x[:, 0])
        yb = torch.where(freeb, yb_raw * rb_scale, x[:, 1])
        return torch.stack([yN, yb], dim=-1)

    return matvec


def _block_jacobi_inv(J6, mesh, masks, fix_b, rb_scale, dtype,
                      extra_diag_b=None):
    """Nodal 2x2 block-Jacobi preconditioner from the assembled diagonal
    blocks (constrained rows/cols replaced by identity)."""
    diag_c = torch.stack([J6[:, i, :, i, :] for i in range(3)], dim=1)
    D = ops.scatter_add_cells(mesh, diag_c)                     # (n, 2, 2)
    if extra_diag_b is not None:
        D[:, 1, 1] += extra_diag_b
    D[:, 1, :] *= rb_scale
    freeN = ~(masks.dirichlet | ~masks.active)
    freeb = ~(fix_b | ~masks.active)

    def mat(rows):
        return torch.tensor(rows, dtype=dtype, device=D.device)

    D = torch.where(freeN[:, None, None], D,
                    mat([[1.0, 0.0], [0.0, 0.0]]) + D * mat([[0.0, 0.0],
                                                             [0.0, 1.0]]))
    D = torch.where(freeb[:, None, None], D,
                    D * mat([[1.0, 0.0], [0.0, 0.0]])
                    + mat([[0.0, 0.0], [0.0, 1.0]]))
    det = D[:, 0, 0] * D[:, 1, 1] - D[:, 0, 1] * D[:, 1, 0]
    safe = torch.where(torch.abs(det) > torch.finfo(dtype).tiny, det, 1.0)
    inv = torch.stack([
        torch.stack([D[:, 1, 1], -D[:, 0, 1]], dim=-1),
        torch.stack([-D[:, 1, 0], D[:, 0, 0]], dim=-1)], dim=1) \
        / safe[:, None, None]

    def apply_pc(r):
        return torch.sum(inv * r[:, None, :], dim=2)

    return apply_pc


def _coloring_plan(mesh):
    """Host-side sparse-Jacobian coloring for the exact fixed-point residual
    (numpy/scipy, like the JAX package's, which runs at trace time).  The
    residual couples 2-hop node neighbours, so two columns can share a
    tangent seed iff they are not 4-hop neighbours: a greedy coloring of
    the 4-hop conflict graph.  Returns (seeds (2K, n, 2), pair_i, pair_j,
    color_of, K) as numpy arrays and K."""
    import scipy.sparse as sp

    cells = mesh.cells.cpu().numpy()
    cells = cells[mesh.cell_valid.cpu().numpy() > 0]
    n = int(mesh.nodes.shape[0])
    nc = cells.shape[0]
    B = sp.csr_matrix(
        (np.ones(3 * nc), (np.repeat(np.arange(nc), 3), cells.ravel())),
        shape=(nc, n))
    A1 = ((B.T @ B) > 0)                      # 1-hop (incl self)
    A2 = ((A1 @ A1) > 0).tocsr()              # 2-hop: the Jacobian pattern
    C = ((A2 @ A2.T) > 0).tocsr()             # 4-hop: the conflict graph

    color = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        nbr_colors = set(color[C.indices[C.indptr[i]:C.indptr[i + 1]]])
        c = 0
        while c in nbr_colors:
            c += 1
        color[i] = c
    K = int(color.max()) + 1

    seeds = np.zeros((2 * K, n, 2))
    for g in range(2):
        seeds[color * 2 + g, np.arange(n), g] = 1.0

    coo = A2.tocoo()
    return seeds, coo.row.astype(np.int32), coo.col.astype(np.int32), \
        color.astype(np.int32), K


def _plan_on(plan, dtype, device):
    """The coloring plan's arrays as tensors on ``device`` (once per polish)."""
    seeds, pi, pj, color, K = plan

    def ix(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return (torch.as_tensor(seeds, dtype=dtype, device=device), ix(pi), ix(pj),
            ix(color), K)


def _colored_jacobian(raw_residual, u, plan, dtype):
    """The dense (n, 2, n, 2) Jacobian from the 2K compressed tangents of one
    batched forward-mode pass (see _coloring_plan; ``plan`` as it returns
    it, or already on the device by _plan_on).  Exact: every column class
    has disjoint row supports by construction."""
    seeds, pi, pj, color, K = _plan_on(plan, dtype, u.device)
    T = _tangents(raw_residual, u, seeds)                       # (2K, n, 2)
    n = u.shape[0]
    Tg = T.reshape(K, 2, n, 2)                   # [color, g, i, f]
    # block[p, f, g] = J[i_p, f, j_p, g] = Tg[color(j_p), g, i_p, f]
    blk = Tg[color[pj], :, pi, :].transpose(1, 2)               # (p, f, g)
    # the (pi, pj) pairs are unique: a plain (deterministic) index_put
    A = torch.zeros((n, n, 2, 2), dtype=dtype, device=u.device)
    A.index_put_((pi, pj), blk)
    return A.permute(0, 2, 1, 3)


def _dense_solve_A(A, masks, fix_b, rb_scale, R, dtype, extra_diag_b=None):
    """Exact Newton step by dense LU from the assembled (n, 2, n, 2)
    Jacobian: constrained rows/cols eliminated to identity, the b rows
    scaled by ``rb_scale``, ``extra_diag_b`` added to the (b, b) diagonal
    first.  ``linalg.solve_ex`` without its error check, like the JAX
    package's solve (no host sync; a singular matrix gives non-finite
    values, which the line search rejects)."""
    n = R.shape[0]
    M = A.reshape(2 * n, 2 * n)
    if extra_diag_b is not None:
        M = M + torch.diag(torch.stack([torch.zeros_like(extra_diag_b),
                                        extra_diag_b], dim=-1).reshape(-1))
    rows = torch.stack([torch.ones_like(rb_scale), rb_scale]).repeat(n)
    M = M * rows[:, None]
    freeN = ~(masks.dirichlet | ~masks.active)
    freeb = ~(fix_b | ~masks.active)
    free = torch.stack([freeN, freeb], dim=-1).reshape(-1)
    M = torch.where(free[:, None] & free[None, :], M, 0.0)
    M = M + torch.diag(torch.where(free, 0.0, 1.0).to(dtype))
    du = torch.linalg.solve_ex(M, -R.reshape(-1), check_errors=False)[0]
    return du.reshape(n, 2), {"iters": 1}


def polish(mesh, static, params: PhysicalParams, state, *,
           quad_degree: int = 4, tol: float = 1e-3, t_ref: float = YEAR,
           max_newton: int = 40, krylov_rtol: float = 1e-8,
           krylov_maxiter: int = 2000, max_b_factor: float = 10.0,
           armijo_cuts: int = 8, n_tol: float = 1e-8,
           pin_b_dirichlet: bool = True, linear: str = "auto",
           dense_max_nodes: int = 2048, log_b: bool = True,
           dtau0: float | None = None, dtau_seed: float | None = 3e5,
           dtau_min: float = 1.0):
    """One monolithic Newton solve for the coupled steady state from
    ``state`` (typically a PTC plateau), m_diff frozen from ``state``.

    Converged when the gap-row drift rate ||db/dt|| t_ref / ||b|| (mass-
    lumped, free rows) is below ``tol`` and the N-row residual below
    ``n_tol`` of its natural scale.  Returns (state, info), info's scalars
    0-d tensors (``newton``, ``krylov_total``: ints): converged, rate_b,
    resN_rel, newton, dtau, t_pseudo, steps_done, krylov_total, backtracks,
    n_fixed, stalled.

    ``pin_b_dirichlet`` freezes the gap at the N-pinned margin to its entry
    value (an unreachable boundary layer; the PTC certificate excludes it
    too).  ``linear``: "direct" (dense LU of the colored Jacobian),
    "bicgstab" (matrix-free element blocks + nodal 2x2 block-Jacobi) or
    "auto" (direct up to ``dense_max_nodes`` nodes).  ``dtau0``: the entry
    pseudo-step (None: pure Newton); ``dtau_seed``: the pseudo-step a failed
    pure-Newton line search falls back to (None: never damp)."""
    p = params
    dtype, dev = state.N.dtype, state.N.device

    def f(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    fr = _frozen_fields(mesh, static, state, params, quad_degree, dtype)
    fr["log_b"] = bool(log_b)
    masks = _Masks(dirichlet=static.dirichlet, active=mesh.node_area > 0)
    pinned = masks.dirichlet | ~masks.active
    b_min = static.b_min
    b_cap = static.b_max if static.b_max is not None else f(math.inf)
    tinyv = f(torch.finfo(dtype).tiny)
    lumped = torch.maximum(mesh.node_area / 3.0, tinyv)
    if linear == "auto":
        linear = "direct" if mesh.n_nodes <= dense_max_nodes else "bicgstab"

    N0 = torch.where(masks.dirichlet, static.N_bdry, state.N)
    b0 = torch.minimum(torch.maximum(state.b, b_min), b_cap)
    # bounds and unknowns in the marching parametrization (w = log b)
    tr = torch.log if log_b else (lambda x: x)
    itr = torch.exp if log_b else (lambda x: x)
    u_lo, u_hi = tr(b_min), tr(b_cap)
    u0 = torch.stack([N0, tr(b0)], dim=-1)

    def fix_mask(u, R_raw):
        # semismooth active set: a bound binds where b sits on it and the
        # equation pushes further out; the margin b optionally pinned
        eps_lo = torch.abs(u_lo) * 1e-12 + 1e-300
        at_lo = u[:, 1] <= u_lo + eps_lo
        at_hi = (u[:, 1] >= u_hi - 1e-12) if log_b \
            else (u[:, 1] >= b_cap * (1.0 - 1e-12))
        fix = (at_lo & (R_raw[:, 1] < 0)) | (at_hi & (R_raw[:, 1] > 0))
        return fix | masks.dirichlet if pin_b_dirichlet else fix

    def raw_residual(u):
        return _exact_residual(u, fr, mesh, static, params)

    color_plan = (_plan_on(_coloring_plan(mesh), dtype, dev)
                  if linear == "direct" else None)
    R0_raw = raw_residual(u0)
    fix0 = fix_mask(u0, R0_raw)

    def nrm(x):
        return torch.linalg.vector_norm(x)

    def _nat_scales(u):
        # row scales from the natural term magnitudes (assembled |term|
        # norms), not the entry residual (~roundoff at a converged entry)
        u_c = ops.gather_cells(mesh, u)
        q_q, m_q, C_q, _, _, _ = _cell_physics(u_c[..., 0], _b_of(u_c, fr),
                                               fr, mesh, params)
        wq, phi = fr["wq"], fr["phi"]
        c_m = 1.0 / p.rho_i - 1.0 / p.rho_w
        absrcN = torch.abs(c_m * m_q) + torch.abs(C_q) \
            + torch.abs(fr["inputs_q"])
        absrcb = torch.abs(m_q) / p.rho_i + torch.abs(C_q)
        w_cell = mesh.area * mesh.cell_valid
        tf = torch.sum(torch.abs(wq[None, :, None, None] * q_q[:, :, None, :]
                                 * mesh.grads[:, None, :, :]), dim=(1, 3))
        wphi = (wq[:, None] * phi)[None]
        ts = torch.sum(wphi * absrcN[:, :, None], dim=1)
        tb = torch.sum(wphi * absrcb[:, :, None], dim=1)
        S = ops.scatter_add_cells(mesh, torch.stack(
            [w_cell[:, None] * (tf + ts), w_cell[:, None] * tb], dim=-1))
        sN = nrm(torch.where(pinned, 0.0, S[:, 0]))
        sb = nrm(torch.where(fix0 | ~masks.active, 0.0, S[:, 1]))
        return torch.maximum(sN, tinyv), torch.maximum(sb, tinyv)

    n_scale0, b_scale0 = _nat_scales(u0)
    rb_scale = n_scale0 / b_scale0

    def rates(u, R_raw, fix_b):
        """(rate_b drift/yr, resN_rel): the certificate quantities."""
        dbdt = torch.where(fix_b | ~masks.active, 0.0, R_raw[:, 1]) / lumped
        bn = torch.maximum(nrm(torch.where(masks.active, itr(u[:, 1]), 0.0)),
                           tinyv)
        rate_b = nrm(dbdt) * t_ref / bn
        rN = nrm(torch.where(pinned, 0.0, R_raw[:, 0]))
        return rate_b, rN / n_scale0

    def damped(u, R_raw, fix_b, b_ref, inv_dtau):
        """Row-scaled damped residual rows (RN, Rb): the b row carries the
        backward-Euler pseudo-transient term -(b - b_ref) M / dtau
        (inv_dtau = 0: pure Newton)."""
        Rb_d = R_raw[:, 1] - (itr(u[:, 1]) - b_ref) * lumped * inv_dtau
        RN = torch.where(pinned, 0.0, R_raw[:, 0])
        Rb = torch.where(fix_b | ~masks.active, 0.0, Rb_d) * rb_scale
        return RN, Rb

    def merit(RN, Rb):
        return torch.sqrt(nrm(RN) ** 2 + nrm(Rb) ** 2)

    def scaled_norm(u, b_ref, inv_dtau):
        """Merit: the row-scaled damped residual over the trial point's own
        free set (recomputing the active set credits steps that land nodes
        on the gap floor)."""
        R_raw = raw_residual(u)
        return merit(*damped(u, R_raw, fix_mask(u, R_raw), b_ref, inv_dtau))

    inf = f(math.inf)
    seed = inf if dtau_seed is None else f(dtau_seed)
    lim = math.log(max_b_factor)
    # half-decade ladder down to ~10^-(cuts-1)/2 (the coupled direction's
    # merit is V-shaped near strong b-N rebalancing)
    alphas = f(10.0) ** (-torch.arange(armijo_cuts, dtype=dtype, device=dev)
                         / 2.0)

    def body(c):
        u = c["u"]
        inv_dtau = 1.0 / c["dtau"]
        R_raw = raw_residual(u)
        fix_b = fix_mask(u, R_raw)
        RN, Rb = damped(u, R_raw, fix_b, c["b_ref"], inv_dtau)
        R = torch.stack([RN, Rb], dim=-1)
        # damping Jacobian: d/dw of -(b - b_ref) M / dtau
        dbdw = itr(u[:, 1]) if log_b else torch.ones_like(u[:, 1])
        extra = -lumped * inv_dtau * dbdw
        if linear == "direct":
            with span("polish.jacobian"):
                A = _colored_jacobian(raw_residual, u, color_plan, dtype)
            with span("polish.lu"):
                du, kinfo = _dense_solve_A(A, masks, fix_b, rb_scale, R,
                                           dtype, extra_diag_b=extra)
        else:
            # large-mesh fallback: inexact Newton, the exact residual with
            # the cell-local approximate operator
            J6 = _element_jacobian6(u, fr, mesh, params)
            mv = _make_matvec(J6, mesh, masks, fix_b, rb_scale,
                              extra_diag_b=extra)
            pc = _block_jacobi_inv(J6, mesh, masks, fix_b, rb_scale, dtype,
                                   extra_diag_b=extra)
            du, kinfo = bicgstab(mv, -R, minv=pc, rtol=krylov_rtol,
                                 maxiter=krylov_maxiter)

        with span("polish.armijo"):
            # every rung of the ladder at once, the elementwise trust
            # region on b applied; the first rung that descends is taken
            norm_old = merit(RN, Rb)
            a = alphas[:, None]
            N_new = torch.where(masks.dirichlet, static.N_bdry,
                                u[:, 0] + a * du[:, 0])
            b_new = u[:, 1] + a * du[:, 1]
            if log_b:
                b_new = torch.minimum(torch.maximum(b_new, u[:, 1] - lim),
                                      u[:, 1] + lim)
            else:
                b_new = torch.minimum(
                    torch.maximum(b_new, u[:, 1] / max_b_factor),
                    u[:, 1] * max_b_factor)
            b_new = torch.minimum(torch.maximum(b_new, u_lo), u_hi)
            U = torch.stack([N_new, b_new], dim=-1)             # (A, n, 2)
            norms = torch.func.vmap(
                lambda v: scaled_norm(v, c["b_ref"], inv_dtau))(U)
            oks = (norms < (1.0 - 1e-4 * alphas) * norm_old) \
                & torch.isfinite(norms)
            accepted = oks.any()
            # index_select: a 0-d index would be read on the host
            first = torch.argmax(oks.to(torch.int32)).reshape(1)
            u_new = torch.where(accepted, U.index_select(0, first)[0], u)
            norm_new = torch.where(accepted, norms.index_select(0, first)[0],
                                   norm_old)

        R_new_raw = raw_residual(u_new)
        fix_new = fix_mask(u_new, R_new_raw)
        rate_b, resN = rates(u_new, R_new_raw, fix_new)
        conv = (rate_b < tol) & (resN < n_tol)

        # pseudo-transient step control: Newton-iterate the same damped
        # system until its residual dropped 20x from the pseudo-step entry,
        # then advance b_ref and grow dtau 10x; on line-search failure
        # shrink dtau 5x (dtau = inf is pure Newton; it becomes finite only
        # through the failure branch, seeded at dtau_seed)
        step_done = accepted & (norm_new < 0.05 * c["step_norm0"])
        dtau = c["dtau"]
        dtau_new = torch.where(
            step_done, torch.minimum(dtau * 10.0, inf),
            torch.where(accepted, dtau,
                        torch.where(torch.isinf(dtau), seed,
                                    torch.maximum(dtau * 0.2, f(dtau_min)))))
        b_ref_new = torch.where(step_done, itr(u_new[:, 1]), c["b_ref"])
        # the damped system changed whenever dtau or b_ref moved
        norm_reset = scaled_norm(u_new, b_ref_new, 1.0 / dtau_new)
        stalled = ~accepted & (
            (torch.isinf(dtau) & torch.isinf(seed))
            | (~torch.isinf(dtau) & (dtau <= dtau_min)))
        return {
            "u": u_new, "b_ref": b_ref_new, "dtau": dtau_new,
            "step_norm0": torch.where(step_done | ~accepted, norm_reset,
                                      c["step_norm0"]),
            "t_pseudo": c["t_pseudo"] + torch.where(
                step_done & ~torch.isinf(dtau), dtau, f(0.0)),
            "steps_done": c["steps_done"] + step_done.to(torch.int32),
            "k": c["k"] + 1,
            "converged": conv & accepted,
            "stalled": stalled,
            "rate_b": rate_b, "resN": resN,
            "krylov_total": c["krylov_total"] + kinfo["iters"],
            "backtracks": c["backtracks"] + (~oks[0]).to(torch.int32),
            "n_fixed": fix_new.sum().to(torch.int32),
        }

    rate_b0, resN0 = rates(u0, R0_raw, fix0)
    dtau_init = inf if dtau0 is None else f(dtau0)
    i32 = torch.zeros((), dtype=torch.int32, device=dev)
    c = {"u": u0, "b_ref": itr(u0[:, 1]), "dtau": dtau_init,
         "step_norm0": scaled_norm(u0, itr(u0[:, 1]), 1.0 / dtau_init),
         "t_pseudo": f(0.0), "steps_done": i32, "k": 0,
         "converged": (rate_b0 < tol) & (resN0 < n_tol),
         "stalled": torch.zeros((), dtype=torch.bool, device=dev),
         "rate_b": rate_b0, "resN": resN0, "krylov_total": 0,
         "backtracks": i32, "n_fixed": fix0.sum().to(torch.int32)}
    # the loop test is the one host sync of a Newton iteration
    while c["k"] < max_newton and not bool(c["converged"] | c["stalled"]):
        c = body(c)

    u = c["u"]
    # self-consistent nodal q and melt from the transient's update rules
    q_node, m_node, _ = _nodal_fields(u, fr, mesh, static, params)
    new_state = dataclasses.replace(
        state, N=u[:, 0], b=itr(u[:, 1]), q=q_node, melt=m_node,
        N_prev=None if state.N_prev is None else u[:, 0])
    info = {"converged": c["converged"], "rate_b": c["rate_b"],
            "resN_rel": c["resN"], "newton": c["k"], "dtau": c["dtau"],
            "t_pseudo": c["t_pseudo"], "steps_done": c["steps_done"],
            "krylov_total": c["krylov_total"], "backtracks": c["backtracks"],
            "n_fixed": c["n_fixed"], "stalled": c["stalled"]}
    return new_state, info


def _as_np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def steady_polish(mesh, static, params: PhysicalParams, state0, *,
                  tol: float = 1e-3, t_ref: float = YEAR,
                  refreshes: int = 3, max_newton: int = 400,
                  max_newton_total: int = 6000, patience: int = 3,
                  max_wall_s: float = float("inf"),
                  checkpoint: str | None = None, **polish_kw):
    """Outer loop: :func:`polish` in segments of ``max_newton`` iterations,
    the frozen Warburton m_diff (and the nodal melt it is built from)
    refreshed from the current iterate between segments.

    Converged segments repeat until the refresh is a fixed point (up to
    ``refreshes`` times); unconverged segments restart, continuing the
    pseudo-transient march at half the reached dtau, while the drift rate
    improves, giving up after ``patience`` consecutive segments without
    improvement, after ``max_newton_total`` iterations or past
    ``max_wall_s`` seconds of host wall clock (segment granularity).  When
    no fixed point was reached, the pseudo-time-weighted trajectory of
    segment-end states yields the centroid wander rate and amplitudes and
    the time-mean state (``info["mean_state"]``).

    ``checkpoint``: path of the ``.npz`` written after every segment with
    the complete host-loop state, under the JAX package's keys (either
    package resumes the other's file); a resumed march replays the rest of
    the uninterrupted one exactly.  The file is removed on a conclusive
    return and kept on a wall-clock or Newton-budget exit.  Returns
    (state, info), info's values numpy scalars and host numbers."""
    def run(st, d0=None):
        kw = dict(polish_kw)
        if d0 is not None:
            kw["dtau0"] = d0
        return polish(mesh, static, params, st, tol=tol, t_ref=t_ref,
                      max_newton=max_newton, **kw)

    t_start = time.time()
    state = state0
    newton = krylov = 0
    info = None
    dstate = float("inf")
    refreshed = 0
    best_rate = np.inf
    stale = 0
    seg = 0
    dtau_carry = None
    spent = 0.0                 # wall seconds of the resumed-over runs
    wall_broke = False          # wall-budget exits keep the checkpoint
    # segment-end states and the pseudo-time each segment advanced
    traj = []
    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint, allow_pickle=False) as ck:
            def cast(k):
                return torch.as_tensor(ck[k], dtype=state0.N.dtype,
                                       device=state0.N.device)

            state = dataclasses.replace(
                state0, N=cast("N"), b=cast("b"), q=cast("q"),
                melt=cast("melt"),
                N_prev=None if state0.N_prev is None else cast("N_prev"))
            newton, krylov = int(ck["newton"]), int(ck["krylov"])
            seg, refreshed, stale = (int(ck["seg"]), int(ck["refreshed"]),
                                     int(ck["stale"]))
            best_rate, dstate = float(ck["best_rate"]), float(ck["dstate"])
            dtau_carry = (float(ck["dtau_carry"])
                          if np.isfinite(ck["dtau_carry"]) else None)
            spent = float(ck["spent"])
            traj = [(ck["traj_b"][i], ck["traj_N"][i], float(ck["traj_t"][i]))
                    for i in range(ck["traj_t"].shape[0])]
            info = {k[5:]: ck[k] for k in ck.files if k.startswith("info_")}

    def save_ck():
        if not checkpoint:
            return
        n = state0.N.shape[0]
        extra = {"info_" + k: np.asarray(_as_np(v))
                 for k, v in (info or {}).items() if np.ndim(_as_np(v)) == 0}
        np.savez(checkpoint + ".tmp.npz",
                 N=_as_np(state.N), b=_as_np(state.b), q=_as_np(state.q),
                 melt=_as_np(state.melt),
                 N_prev=_as_np(state.N_prev if state.N_prev is not None
                               else state.N),
                 newton=np.int64(newton), krylov=np.int64(krylov),
                 seg=np.int64(seg), refreshed=np.int64(refreshed),
                 stale=np.int64(stale), best_rate=np.float64(best_rate),
                 dstate=np.float64(dstate),
                 dtau_carry=np.float64(dtau_carry if dtau_carry is not None
                                       else np.nan),
                 spent=np.float64(spent + time.time() - t_start),
                 traj_b=np.stack([b for (b, _, _) in traj])
                 if traj else np.zeros((0, n)),
                 traj_N=np.stack([N for (_, N, _) in traj])
                 if traj else np.zeros((0, n)),
                 traj_t=np.asarray([t for (_, _, t) in traj]),
                 **extra)
        os.replace(checkpoint + ".tmp.npz", checkpoint)

    while newton < max_newton_total:
        seg += 1
        prev_b = _as_np(state.b)
        state, info = run(state, dtau_carry)
        traj.append((_as_np(state.b).astype(np.float64),
                     _as_np(state.N).astype(np.float64),
                     float(info["t_pseudo"])))
        newton += int(info["newton"])
        krylov += int(info["krylov_total"])
        db = np.linalg.norm(_as_np(state.b) - prev_b)
        dstate = db / max(np.linalg.norm(prev_b), 1e-300)
        rate = float(info["rate_b"])
        if bool(info["converged"]):
            refreshed += 1
            if refreshed >= max(refreshes, 1) or dstate < 1e-10:
                break
            best_rate = np.inf      # converged segment: refresh and verify
            stale = 0
            save_ck()
            continue
        # unconverged: restart while the drift keeps improving, continuing
        # the march at half the reached dtau
        if rate < 0.9 * best_rate:
            best_rate = rate
            stale = 0
        else:
            stale += 1
            if stale >= max(patience, 1):
                break
        d = float(info["dtau"])
        dtau_carry = max(min(d, 1e30) * 0.5, 1.0) if np.isfinite(d) else None
        save_ck()
        if spent + (time.time() - t_start) > max_wall_s:
            wall_broke = True
            break
    info = {k: _as_np(v) for k, v in info.items()}
    info["newton"] = newton
    info["krylov_total"] = krylov
    info["refreshes"] = seg
    info["refresh_dstate"] = dstate

    # centroid stationarity of the implicit march (only when the fixed
    # point was not reached): the half-mean drift per t_ref of the
    # pseudo-time-weighted trajectory is the wander rate, the RMS spread
    # around the overall mean the amplitude
    if not bool(info["converged"]) and len(traj) >= 6:
        w = np.asarray([t for (_, _, t) in traj])
        T = w.sum()
        if T > 0:
            cum = np.cumsum(w)
            half = np.searchsorted(cum, T / 2.0) + 1
            half = min(max(half, 1), len(traj) - 1)
            bs = np.stack([b for (b, _, _) in traj])
            Ns = np.stack([N for (_, N, _) in traj])

            def wm(X, s):
                return np.average(X[s], axis=0, weights=w[s])

            b1, b2 = wm(bs, slice(0, half)), wm(bs, slice(half, None))
            N1, N2 = wm(Ns, slice(0, half)), wm(Ns, slice(half, None))
            nrm = np.linalg.norm
            rate_w = max(nrm(b2 - b1) / max(nrm(b1), 1e-300),
                         nrm(N2 - N1) / max(nrm(N1), 1e-300)) \
                * t_ref / (T / 2.0)
            bm, Nm = wm(bs, slice(None)), wm(Ns, slice(None))
            amp_b = np.sqrt(np.average([nrm(b - bm) ** 2 for b in bs],
                                       weights=w)) / max(nrm(bm), 1e-300)
            amp_N = np.sqrt(np.average([nrm(N - Nm) ** 2 for N in Ns],
                                       weights=w)) / max(nrm(Nm), 1e-300)
            info["wander_rate"] = rate_w
            info["wander_amp_b"] = float(amp_b)
            info["wander_amp_N"] = float(amp_N)
            info["t_march"] = float(T)
            # the time-mean state, q/melt through the transient's own
            # update rules at the mean fields
            dtype, dev = state.N.dtype, state.N.device
            fr2 = _frozen_fields(mesh, static, state, params,
                                 polish_kw.get("quad_degree", 4), dtype)
            fr2["log_b"] = False
            u_mean = torch.stack([torch.as_tensor(Nm, dtype=dtype, device=dev),
                                  torch.as_tensor(bm, dtype=dtype, device=dev)],
                                 dim=-1)
            qm, mm, _ = _nodal_fields(u_mean, fr2, mesh, static, params)
            info["mean_state"] = dataclasses.replace(
                state, N=u_mean[:, 0], b=u_mean[:, 1], q=qm, melt=mm,
                N_prev=None if state.N_prev is None else u_mean[:, 0])
    resumable = wall_broke or (newton >= max_newton_total
                               and not bool(info["converged"]))
    if checkpoint and not resumable and os.path.exists(checkpoint):
        os.remove(checkpoint)
    return state, info
