"""Damped Newton solver for the nonlinear effective-pressure equation.

Port of shakti_tpu/solve/newton.py (the default path).  The solve state
machine is the same; ``lax.while_loop`` becomes Python loops whose tests
are host syncs.  Convergence: ||r|| < atol_eff or ||r|| <= rtol * ||r_ref||
with atol_eff floored at the residual's roundoff sensitivity (the
3-column probe); a lazy backtracking line search; stall detection with
best-iterate acceptance; and the lagged-operator carry (iteration 0 of a
step reuses the previous step's folded operator and coarse inverse while
the carry is young enough).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from shakti_tpu_torch.physics import residual as res
from shakti_tpu_torch.solve import krylov
from shakti_tpu_torch.solve import precond as pc


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Solver configuration: the fields and defaults of
    shakti_tpu.solve.newton.NewtonConfig (see there for each knob's
    rationale).  ``precond``: 'jacobi', 'two_level' or 'mg' (the multilevel
    V-cycle of solve/mg.py, tuned by the mg_* fields).  differentiable=True
    is accepted for compatibility but not ported yet; using it raises
    NotImplementedError."""

    rtol: float = 1e-9
    atol: float = 1e-10
    max_iter: int = 50
    relaxation: float = 1.0
    lin_rtol: float = 1e-8
    lin_maxiter: int = 2000
    krylov: str = "cg"
    quad_degree: int = 4
    precond: str = "two_level"
    mg_omega: float = 0.9
    mg_agg: int = 4
    mg_coarse_cap: int = 1536
    mg_smoother: str = "cheb"
    mg_cheb_deg: int = 2
    mg_cheb_frac: float = 0.10
    mg_cycle: str = "v"
    mg_smooth_p: float = 0.0
    coarse_block: int | None = None
    diag_floor_rel: float = 1e-10
    floor_mult: float = 1.0
    adaptive_dt_levels: int = 0
    stall_rtol: float = 1e-4
    stall_factor: float = 0.9
    stall_patience: int = 4
    ls_backtracks: int = 4
    extrapolate_guess: bool = True
    lag_operator: bool | None = None
    lag_max_age: int = 8
    inc_rtol: float = 0.0
    differentiable: bool = False

    def for_dtype(self, dtype) -> "NewtonConfig":
        """Loosen tolerances to what float32 can resolve."""
        if dtype == torch.float32:
            return dataclasses.replace(
                self,
                rtol=max(self.rtol, 2e-5),
                atol=max(self.atol, 0.0),
                lin_rtol=max(self.lin_rtol, 1e-6),
                stall_rtol=max(self.stall_rtol, 3e-3),
                stall_patience=max(self.stall_patience, 3),
                inc_rtol=max(self.inc_rtol, 1e-6),
            )
        return self


def diag_floor_extra(a_diag, dirichlet, mesh, rel):
    """Per-row increment lifting near-zero (collapsed-sheet) operator rows
    to ``rel * max|diag|`` (NewtonConfig.diag_floor_rel)."""
    dmax = torch.max(torch.where(dirichlet, 0.0, torch.abs(a_diag)))
    return torch.where(dirichlet, 0.0, torch.clamp_min(rel * dmax - a_diag, 0.0))


def zero_lag(mesh, dtype, cfg: NewtonConfig):
    """Invalid-but-shape-correct lag carry for State.lag_op:
    (ok, age, vals, a_diag, A_inv, floor, floor_age) with ok=False, in the
    mesh's operator format (raises for the matrix-free operator, which has
    no values to carry).  Only 'two_level' carries a coarse inverse: the
    carry never holds an 'mg' hierarchy (freeze turns the carry off)."""
    dev = mesh.nodes.device
    vals = torch.zeros(res.operator_values_shape(mesh), dtype=dtype, device=dev)
    a_diag = torch.zeros(mesh.n_nodes, dtype=dtype, device=dev)
    block = 64 if cfg.coarse_block is None else cfg.coarse_block
    A_inv = None
    if cfg.precond == "two_level":
        m = -(-mesh.n_nodes // block)
        A_inv = torch.zeros((m, m), dtype=dtype, device=dev)
    return (False, 0, vals, a_diag, A_inv, 0.0, 0)


def check_config(cfg: NewtonConfig):
    """Raise ValueError for an unknown preconditioner and
    NotImplementedError for the options the port does not have yet."""
    if cfg.precond not in pc.PRECONDITIONERS:
        raise ValueError(f"precond must be one of {pc.PRECONDITIONERS}, "
                         f"got {cfg.precond!r}")
    if cfg.differentiable:
        raise NotImplementedError(
            "differentiable=True: the implicit-function adjoint "
            "(solve/implicit.py) is not ported yet (ROADMAP, still to port: "
            "implicit)")


def newton_solve(N_init, pre, mesh, dirichlet, dirichlet_value, params,
                 cfg: NewtonConfig, N_ref=None, lag=None):
    """Solve F(N) = 0 for effective pressure.

    ``N_init`` is the starting iterate (possibly time-extrapolated);
    ``N_ref`` the trusted previous solution (default N_init), the only
    state the nothing-to-solve early exit may return.  ``lag`` is the
    carried operator when cfg.lag_operator; the updated carry is returned
    in stats["lag"].

    Returns (N, stats) with stats = dict(iters, rnorm0, rnorm, converged,
    cg_iters[, lag]) as Python numbers."""
    check_config(cfg)
    if cfg.coarse_block is None:
        cfg = dataclasses.replace(cfg, coarse_block=64)
    lin_solve = krylov.get_solver(cfg.krylov)
    norm = krylov.norm

    def resid(N):
        return torch.where(dirichlet, 0.0,
                           res.assemble_residual(N, pre, mesh, params))

    N0 = torch.where(dirichlet, dirichlet_value, N_init)
    Nr = N0 if N_ref is None else torch.where(dirichlet, dirichlet_value, N_ref)
    fi = torch.finfo(N0.dtype)
    tiny, eps = fi.tiny, fi.eps
    use_two_level = cfg.precond == "two_level"
    lag_on = bool(cfg.lag_operator)
    if lag_on and lag is None:
        lag = zero_lag(mesh, N0.dtype, cfg)
    # one batched assembly: the trusted-state residual, the guess residual
    # and the roundoff-sensitivity probe r(N + eps|N|) (the floor below
    # which no representable update can reduce the residual)
    sign = 1.0 - 2.0 * (torch.arange(N0.shape[0], device=N0.device) % 2).to(N0.dtype)
    cols = res.assemble_residual_multi(
        torch.stack([Nr, N0, Nr + eps * torch.abs(Nr) * sign], dim=1),
        pre, mesh, params)
    cols = torch.where(dirichlet[:, None], 0.0, cols)
    r_ref, r0 = cols[:, 0], cols[:, 1]
    floor_b = float(norm(cols[:, 2] - r_ref))
    floor_age_this = 0
    rnorm_ref = float(norm(r_ref))
    rnorm0 = float(norm(r0))
    atol_eff = max(cfg.atol, cfg.floor_mult * floor_b)
    skip = rnorm_ref <= atol_eff
    rscale = max(rnorm_ref, tiny)

    def converged_fn(rnorm):
        return rnorm < atol_eff or rnorm <= cfg.rtol * rscale

    def build_op(N):
        J_c = res.element_jacobian(N, pre, mesh, params)
        vals = res.fold_operator_values(J_c, mesh)
        a_diag = res.operator_diag_from_values(vals, mesh)
        A_inv = None
        if use_two_level:
            A_inv = (pc.coarse_from_values(vals, mesh, dirichlet,
                                           cfg.coarse_block)
                     if pc.vals_coarse_ok(mesh, cfg.coarse_block)
                     else pc.coarse_inverse(J_c, mesh, dirichlet,
                                            cfg.coarse_block))
        return (True, 0, vals, a_diag, A_inv, floor_b, floor_age_this)

    s = dict(N=N0, r=r0, rnorm=rnorm0, N_best=N0, rn_best=rnorm0, stall=0,
             k=0, cg_total=0, bad=not math.isfinite(rnorm0), done=skip,
             op=lag if lag_on else None)

    def running():
        return (not s["done"] and s["k"] < cfg.max_iter and not s["bad"]
                and s["stall"] < cfg.stall_patience)

    def iterate(reuse_op: bool):
        N, rnorm = s["N"], s["rnorm"]
        J_c = vals = None
        if reuse_op:
            # iteration 0 under cfg.lag_operator: the carried operator
            _, _, vals, a_diag, A_inv, _, _ = s["op"]
        elif lag_on:
            # rebuild at the current iterate and refresh the carry
            s["op"] = build_op(N)
            _, _, vals, a_diag, A_inv, _, _ = s["op"]
        else:
            J_c = res.element_jacobian(N, pre, mesh, params)
            if res.has_values(mesh):
                vals = res.fold_operator_values(J_c, mesh)
                a_diag = res.operator_diag_from_values(vals, mesh)
            else:
                a_diag = -res.jacobian_diag(J_c, mesh)
        # regularize degenerate (clamped-sheet) rows: see diag_floor_rel
        extra = diag_floor_extra(a_diag, dirichlet, mesh, cfg.diag_floor_rel)
        if vals is not None:
            matvec = res.operator_from_values(vals, mesh, dirichlet, extra)
        else:
            matvec = res.make_matvec(J_c, mesh, dirichlet, extra)
        a_diag = a_diag + extra
        if lag_on:
            minv = (pc.two_level_from_inverse(A_inv, a_diag, dirichlet,
                                              cfg.coarse_block, mesh.n_nodes)
                    if use_two_level
                    else pc.make_jacobi(a_diag, dirichlet, tiny))
        else:
            # mg smooths with ``matvec``, the regularized operator CG gets:
            # the cycle is SPD only with that exact operator
            minv = pc.make_preconditioner(
                cfg.precond, mesh, dirichlet, a_diag, cfg.coarse_block,
                vals=vals, J_c=J_c, matvec=matvec, mg_omega=cfg.mg_omega,
                mg_smoother=cfg.mg_smoother, mg_cheb_deg=cfg.mg_cheb_deg,
                mg_cheb_frac=cfg.mg_cheb_frac, mg_cycle=cfg.mg_cycle,
                mg_smooth_p=cfg.mg_smooth_p)
        dN, lin_info = lin_solve(matvec, s["r"], minv, rtol=cfg.lin_rtol,
                                 atol=0.1 * atol_eff, maxiter=cfg.lin_maxiter)
        a = cfg.relaxation
        N_new = N + a * dN
        r = resid(N_new)
        rnorm_new = float(norm(r))
        # lazy backtracking: extra residuals only when the full step failed
        # to reduce the residual enough
        tries = 0
        while (rnorm_new > (1.0 - 1e-4 * a) * rnorm
               and tries < cfg.ls_backtracks):
            a *= 0.5
            N_new = N + a * dN
            r = resid(N_new)
            rnorm_new = float(norm(r))
            tries += 1
        inc_ok = cfg.inc_rtol > 0.0 and (
            float(norm(dN)) <= cfg.inc_rtol * float(norm(N_new)))
        progress = rnorm_new < cfg.stall_factor * s["rn_best"]
        if rnorm_new < s["rn_best"]:
            s["N_best"], s["rn_best"] = N_new, rnorm_new
        s.update(N=N_new, r=r, rnorm=rnorm_new,
                 stall=0 if progress else s["stall"] + 1, k=s["k"] + 1,
                 cg_total=s["cg_total"] + lin_info["iters"],
                 bad=not math.isfinite(rnorm_new),
                 done=converged_fn(rnorm_new) or inc_ok)

    if lag_on:
        # peeled iteration 0 with the carried operator, only when the carry
        # is valid and young enough; it must not pre-charge the rebuild
        # loop's stall budget (max_iter still counts it)
        op = s["op"]
        if running() and op[0] and op[1] <= cfg.lag_max_age:
            iterate(True)
            s["stall"] = 0
    while running():
        iterate(False)

    done = s["done"]
    if skip:
        N_out, rn_out = Nr, rnorm_ref
    elif done:
        N_out, rn_out = s["N"], s["rnorm"]
    else:
        N_out, rn_out = s["N_best"], s["rn_best"]
    accepted = skip or done or rn_out <= cfg.stall_rtol * rscale
    stats = {"iters": s["k"], "rnorm0": rnorm0, "rnorm": rn_out,
             "converged": bool(accepted and not s["bad"]),
             "cg_iters": s["cg_total"]}
    if lag_on:
        # the step's floor always enters the carry, even on reuse-only steps
        stats["lag"] = s["op"][:5] + (floor_b, floor_age_this)
    return N_out, stats
