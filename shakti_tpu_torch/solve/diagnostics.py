"""Physical diagnostics: boundary discharge, water production and the
certified mass budget.

Port of shakti_tpu/solve/diagnostics.py.  ``boundary_discharge`` uses the
FEM reaction identity: at a converged solve the residual vanishes at free
nodes, so the unmasked residual summed over the Dirichlet nodes is the
boundary flux the weak form dropped, sum_{j in D} F_j = -oint q.n ds.
``water_production`` integrates the interior sources independently,
int (inputs + C - (1/rho_i - 1/rho_w) m) dx.  At steady state the two
agree (global mass conservation of the discretization).
"""

from __future__ import annotations

import dataclasses

import torch

from shakti_tpu_torch.fem import ops
from shakti_tpu_torch.fem.ops import fixed_sum
from shakti_tpu_torch.params import PhysicalParams
from shakti_tpu_torch.physics import constitutive as law
from shakti_tpu_torch.physics import residual as res
from shakti_tpu_torch.solve.newton import NewtonConfig, newton_solve


def _pre(mesh, static, state, params, quad_degree, dt):
    return res.precompute_step(
        mesh, state.N, state.b, state.q, state.melt, static,
        torch.as_tensor(dt, dtype=state.N.dtype, device=state.N.device),
        params, quad_degree)


def _outflow(F, static) -> float:
    # sum_D F_j = -oint q.n ds  =>  net outflow = -sum_D F_j
    return -float(torch.sum(torch.where(static.dirichlet, F, 0.0)))


def boundary_discharge(mesh, static, state, params: PhysicalParams,
                       quad_degree: int = 4, dt: float = 1.0) -> float:
    """Net outflow through the Dirichlet boundary [m^3/s] (positive = out).
    Valid at (near-)steady state, where the free-node residual is ~0; the
    lake-storage term is evaluated with N_n = N, so it drops out."""
    pre = _pre(mesh, static, state, params, quad_degree, dt)
    return _outflow(res.assemble_residual(state.N, pre, mesh, params), static)


def water_production(mesh, static, state, params: PhysicalParams,
                     quad_degree: int = 4) -> float:
    """int (inputs + C(b, N) - (1/rho_i - 1/rho_w) m) dx  [m^3/s]: the
    interior net water source that must leave through the boundary."""
    p = params
    pre = _pre(mesh, static, state, params, quad_degree, 1.0)
    grad_h = pre.gb0 - ops.cell_grad(mesh, state.N) / (p.rho_w * p.g)
    qdgh = fixed_sum(pre.q_q * grad_h[:, None, :], 2)
    m_q = (pre.G_q - p.rho_w * p.g * qdgh) / p.Lh + pre.mdiff_q
    N_q = ops.interpolate_at_quad(pre.phi, ops.gather_cells(mesh, state.N))
    C_q = law.closure(pre.b_q, N_q, p)
    c_m = 1.0 / p.rho_i - 1.0 / p.rho_w
    src_q = pre.inputs_q + C_q - c_m * m_q
    w_cell = mesh.area * mesh.cell_valid
    return float(torch.sum(w_cell * (pre.wq * src_q).sum(dim=1)))


def certified_budget(mesh, static, state, params: PhysicalParams, cfg=None,
                     quad_degree: int = 4):
    """The budget at a certified solution of the frozen final fields:
    (Q_out, Q_src, solve_stats).  The transient leaves N converged against
    the pre-update explicit fields, so the reaction identity on the
    post-update state is polluted wherever those fields still move step to
    step; one extra Newton solve on the frozen fields (no time advance)
    restores it to solver tolerance."""
    cfg = NewtonConfig() if cfg is None else cfg
    cfg = dataclasses.replace(cfg, lag_operator=False, adaptive_dt_levels=0)
    pre = _pre(mesh, static, state, params, quad_degree, 1.0)
    N, stats = newton_solve(state.N, pre, mesh, static.dirichlet,
                            static.N_bdry, params, cfg)
    Q_out = _outflow(res.assemble_residual(N, pre, mesh, params), static)
    Q_src = water_production(mesh, static, dataclasses.replace(state, N=N),
                             params, quad_degree)
    info = {"converged": bool(stats["converged"]),
            "iters": int(stats["iters"]), "rnorm": float(stats["rnorm"])}
    return Q_out, Q_src, info
