"""Damped Newton solver for the nonlinear effective-pressure equation.

Port of shakti_tpu/solve/newton.py (the default path).  The solve state
machine is the same; ``lax.while_loop`` becomes Python loops whose tests
are host syncs.  Convergence: ||r|| < atol_eff or ||r|| <= rtol * ||r_ref||
with atol_eff floored at the residual's roundoff sensitivity (the
3-column probe); a lazy backtracking line search; stall detection with
best-iterate acceptance; and the lagged-operator carry (iteration 0 of a
step reuses the previous step's folded operator and coarse inverse while
the carry is young enough).

:func:`newton_solve_batched` solves an ensemble's M problems at once, as
``jax.vmap`` of the JAX solve does: every control quantity is an (M,)
tensor, a member that has stopped keeps its iterate, and each loop runs
while any member is running (one host read per iteration).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from shakti_tpu_torch.ops import element_cuda
from shakti_tpu_torch.physics import residual as res
from shakti_tpu_torch.solve import krylov
from shakti_tpu_torch.solve import precond as pc
from shakti_tpu_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Solver configuration: the fields and defaults of
    shakti_tpu.solve.newton.NewtonConfig (see there for each knob's
    rationale).  ``precond``: 'jacobi', 'two_level' or 'mg' (the multilevel
    V-cycle of solve/mg.py, tuned by the mg_* fields).  differentiable=True
    routes the transient's N-solve through the implicit-function adjoint
    (solve/implicit.py); it needs lag_operator off."""

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
    to ``rel * max|diag|`` (NewtonConfig.diag_floor_rel); the max is taken
    over every rank of a node-sharded mesh, so all ranks floor alike."""
    dmax = torch.max(torch.where(dirichlet, 0.0, torch.abs(a_diag)))
    if mesh.halo is not None:
        dmax = mesh.halo.max(dmax)
    return torch.where(dirichlet, 0.0, torch.clamp_min(rel * dmax - a_diag, 0.0))


def linear_operator(J_c, mesh, dirichlet, cfg: NewtonConfig):
    """(matvec, preconditioner) of A = -J from the element blocks J_c: the
    blocks folded into the mesh's format (or the matrix-free product), the
    degenerate-row diagonal floor (diag_floor_rel) fused into the matvec,
    and cfg.precond built from them.  mg smooths with that matvec, the
    regularized operator the Krylov solver gets: the cycle is SPD only
    with it.  The Newton iteration without the carry calls it with J, the
    adjoint (solve/implicit.py) with J's transposed blocks."""
    vals = None
    with span("newton.fold"):
        if res.has_values(mesh):
            vals = res.fold_operator_values(J_c, mesh)
            a_diag = res.operator_diag_from_values(vals, mesh)
        else:
            a_diag = -res.jacobian_diag(J_c, mesh)
        extra = diag_floor_extra(a_diag, dirichlet, mesh, cfg.diag_floor_rel)
        if vals is not None:
            matvec = res.operator_from_values(vals, mesh, dirichlet, extra)
        else:
            matvec = res.make_matvec(J_c, mesh, dirichlet, extra)
    with span("newton.precond"):
        minv = pc.make_preconditioner(
            cfg.precond, mesh, dirichlet, a_diag + extra, cfg.coarse_block,
            vals=vals, J_c=J_c, matvec=matvec, mg_omega=cfg.mg_omega,
            mg_smoother=cfg.mg_smoother, mg_cheb_deg=cfg.mg_cheb_deg,
            mg_cheb_frac=cfg.mg_cheb_frac, mg_cycle=cfg.mg_cycle,
            mg_smooth_p=cfg.mg_smooth_p)
    return matvec, minv


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
    if cfg.precond == "two_level" and mesh.halo is None and mesh.paxis is None:
        m = -(-mesh.n_nodes // block)
        A_inv = torch.zeros((m, m), dtype=dtype, device=dev)
    return (False, 0, vals, a_diag, A_inv, 0.0, 0)


def check_config(cfg: NewtonConfig):
    """Raise ValueError for an unknown preconditioner, and for
    differentiable=True with the operator carry on (the carry is state the
    adjoint cannot differentiate)."""
    if cfg.precond not in pc.PRECONDITIONERS:
        raise ValueError(f"precond must be one of {pc.PRECONDITIONERS}, "
                         f"got {cfg.precond!r}")
    if cfg.differentiable and cfg.lag_operator:
        raise ValueError("differentiable=True requires lag_operator=False "
                         "(the operator carry is stateful)")


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
    # a node-sharded rank reduces over its owned slots and every rank
    # (the same scalars on all ranks, so all take the same branches)
    halo = mesh.halo
    dot, norm = ((halo.dot, halo.norm) if halo is not None
                 else (None, krylov.norm))

    def resid(N):
        with span("newton.residual"):
            return torch.where(dirichlet, 0.0,
                               res.assemble_residual(N, pre, mesh, params))

    N0 = torch.where(dirichlet, dirichlet_value, N_init)
    Nr = N0 if N_ref is None else torch.where(dirichlet, dirichlet_value, N_ref)
    fi = torch.finfo(N0.dtype)
    tiny, eps = fi.tiny, fi.eps
    use_two_level = (cfg.precond == "two_level" and halo is None
                     and mesh.paxis is None)
    lag_on = bool(cfg.lag_operator)
    if lag_on and lag is None:
        lag = zero_lag(mesh, N0.dtype, cfg)
    # one batched assembly: the trusted-state residual, the guess residual
    # and the roundoff-sensitivity probe r(N + eps|N|) (the floor below
    # which no representable update can reduce the residual)
    sign = 1.0 - 2.0 * (torch.arange(N0.shape[0], device=N0.device) % 2).to(N0.dtype)
    with span("newton.residual"):
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
        with span("newton.jacobian"):
            J_c = res.element_jacobian(N, pre, mesh, params)
        with span("newton.fold"):
            vals = res.fold_operator_values(J_c, mesh)
            a_diag = res.operator_diag_from_values(vals, mesh)
        A_inv = None
        if use_two_level:
            with span("newton.precond"):
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
        if not lag_on:
            with span("newton.jacobian"):
                J_c = res.element_jacobian(N, pre, mesh, params)
            matvec, minv = linear_operator(J_c, mesh, dirichlet, cfg)
        else:
            # iteration 0 reuses the carried operator; later ones rebuild
            # it at the current iterate and refresh the carry
            if not reuse_op:
                s["op"] = build_op(N)
            _, _, vals, a_diag, A_inv, _, _ = s["op"]
            with span("newton.fold"):
                extra = diag_floor_extra(a_diag, dirichlet, mesh,
                                         cfg.diag_floor_rel)
                matvec = res.operator_from_values(vals, mesh, dirichlet,
                                                  extra)
                a_diag = a_diag + extra
            with span("newton.precond"):
                minv = (pc.two_level_from_inverse(A_inv, a_diag, dirichlet,
                                                  cfg.coarse_block,
                                                  mesh.n_nodes)
                        if use_two_level
                        else pc.make_jacobi(a_diag, dirichlet, tiny))
        with span("krylov"):
            dN, lin_info = lin_solve(
                matvec, s["r"], minv, rtol=cfg.lin_rtol, atol=0.1 * atol_eff,
                maxiter=cfg.lin_maxiter, dot=dot,
                norm=None if halo is None else norm,
                dots=None if halo is None else halo.dots)
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


def newton_solve_batched(N_init, pre, mesh, dirichlet, dirichlet_value,
                         params, cfg: NewtonConfig, N_ref=None):
    """:func:`newton_solve` for M members at once, without the operator
    carry: ``N_init``/``N_ref`` (M, n), every field of ``pre`` with a
    leading member axis (physics/residual.PRE_FIELDS).  Each member follows
    its own single solve (its floor probe, tolerances, line search, stall
    count and best iterate); one that has stopped keeps its iterate while
    the others go on.  The residual and the element Jacobian are the
    closed forms of ops/element_cuda, batched over the members (on the card
    one kernel launch for the Jacobian, two for each residual call; the
    single solve keeps forward AD, which its adjoint differentiates); the
    fold and diagonal are ``torch.func.vmap`` of the single-member
    functions; the matvec is the batched operator
    (residual.batched_operator), the preconditioner
    precond.make_preconditioner_batched, the Krylov solve the batched one.

    Returns (N (M, n), stats) with stats = dict(iters, rnorm0, rnorm,
    converged, cg_iters) as (M,) numpy arrays."""
    check_config(cfg)
    if cfg.lag_operator:
        raise ValueError("newton_solve_batched has no operator carry: "
                         "lag_operator must be off")
    if cfg.coarse_block is None:
        cfg = dataclasses.replace(cfg, coarse_block=64)
    lin_solve = krylov.get_solver(cfg.krylov, batched=True)
    elements = element_cuda.prepare(pre, mesh, params)

    def norm(x):
        return krylov.norm(x, dim=-1).double()

    def resid(N):
        with span("newton.residual"):
            return element_cuda.residual(elements, N, dirichlet)

    N0 = torch.where(dirichlet, dirichlet_value, N_init)
    Nr = N0 if N_ref is None else torch.where(dirichlet, dirichlet_value, N_ref)
    fi = torch.finfo(N0.dtype)
    tiny, eps = fi.tiny, fi.eps
    sign = 1.0 - 2.0 * (torch.arange(N0.shape[-1], device=N0.device) % 2).to(N0.dtype)
    with span("newton.residual"):
        cols = element_cuda.residual(
            elements, torch.stack([Nr, N0, Nr + eps * torch.abs(Nr) * sign],
                                  dim=-1), dirichlet)
    r_ref, r0 = cols[..., 0], cols[..., 1]
    floor_b = norm(cols[..., 2] - r_ref)
    rnorm_ref, rnorm0 = norm(r_ref), norm(r0)
    atol_eff = torch.clamp_min(cfg.floor_mult * floor_b, cfg.atol)
    skip = rnorm_ref <= atol_eff
    rscale = torch.clamp_min(rnorm_ref, tiny)

    def converged_fn(rnorm):
        return (rnorm < atol_eff) | (rnorm <= cfg.rtol * rscale)

    M = N0.shape[0]
    zero = torch.zeros(M, dtype=torch.int64, device=N0.device)
    N, r, rnorm = N0, r0, rnorm0
    N_best, rn_best = N0, rnorm0
    stall, k, cg_total = zero, zero, zero
    bad, done = ~torch.isfinite(rnorm0), skip

    def running_fn():
        return (~done & (k < cfg.max_iter) & ~bad
                & (stall < cfg.stall_patience))

    running = running_fn()
    while bool(running.any()):
        with span("newton.jacobian"):
            J_c = element_cuda.jacobian(elements, N)
        vals = None
        with span("newton.fold"):
            if res.has_values(mesh):
                vals = torch.func.vmap(
                    lambda J: res.fold_operator_values(J, mesh))(J_c)
                a_diag = torch.func.vmap(
                    lambda v: res.operator_diag_from_values(v, mesh))(vals)
            else:
                a_diag = -torch.func.vmap(
                    lambda J: res.jacobian_diag(J, mesh))(J_c)
            extra = torch.func.vmap(lambda a: diag_floor_extra(
                a, dirichlet, mesh, cfg.diag_floor_rel))(a_diag)
            matvec = res.batched_operator(vals, J_c, mesh, dirichlet, extra)
            a_diag = a_diag + extra
            matvecs = (res.member_operators(vals, J_c, mesh, dirichlet, extra)
                       if cfg.precond == "mg" and mesh.mg is not None
                       else None)
        with span("newton.precond"):
            minv = pc.make_preconditioner_batched(
                cfg.precond, mesh, dirichlet, a_diag, cfg.coarse_block,
                J_c=J_c, matvecs=matvecs, mg_omega=cfg.mg_omega,
                mg_smoother=cfg.mg_smoother, mg_cheb_deg=cfg.mg_cheb_deg,
                mg_cheb_frac=cfg.mg_cheb_frac, mg_cycle=cfg.mg_cycle,
                mg_smooth_p=cfg.mg_smooth_p)
        with span("krylov"):
            dN, lin_info = lin_solve(matvec, r, minv, rtol=cfg.lin_rtol,
                                     atol=0.1 * atol_eff,
                                     maxiter=cfg.lin_maxiter, active=running)
        # the step length per member: float64 for the tests (as the single
        # solve's Python floats), the iterate's type for the update
        a = torch.full((M,), float(cfg.relaxation), dtype=torch.float64,
                       device=N.device)
        N_new = N + a.to(N.dtype)[:, None] * dN
        r_new = resid(N_new)
        rn_new = norm(r_new)
        tries = zero
        # lazy backtracking, per member: extra residuals only where the full
        # step failed to reduce the residual enough
        need = (running & (rn_new > (1.0 - 1e-4 * a) * rnorm)
                & (tries < cfg.ls_backtracks))
        while bool(need.any()):
            a = torch.where(need, 0.5 * a, a)
            N_try = N + a.to(N.dtype)[:, None] * dN
            r_try = resid(N_try)
            nd = need[:, None]
            N_new = torch.where(nd, N_try, N_new)
            r_new = torch.where(nd, r_try, r_new)
            rn_new = torch.where(need, norm(r_try), rn_new)
            tries = tries + need
            need = (need & (rn_new > (1.0 - 1e-4 * a) * rnorm)
                    & (tries < cfg.ls_backtracks))
        inc_ok = (cfg.inc_rtol > 0.0) & (
            norm(dN) <= cfg.inc_rtol * norm(N_new))
        progress = rn_new < cfg.stall_factor * rn_best
        better = running & (rn_new < rn_best)
        N_best = torch.where(better[:, None], N_new, N_best)
        rn_best = torch.where(better, rn_new, rn_best)
        rv = running[:, None]
        N = torch.where(rv, N_new, N)
        r = torch.where(rv, r_new, r)
        rnorm = torch.where(running, rn_new, rnorm)
        stall = torch.where(running, torch.where(progress, 0, stall + 1),
                            stall)
        k = k + running
        cg_total = cg_total + torch.where(running, lin_info["iters"], 0)
        bad = torch.where(running, ~torch.isfinite(rn_new), bad)
        done = torch.where(running, converged_fn(rn_new) | inc_ok, done)
        running = running_fn()

    N_out = torch.where(skip[:, None], Nr,
                        torch.where(done[:, None], N, N_best))
    rn_out = torch.where(skip, rnorm_ref, torch.where(done, rnorm, rn_best))
    accepted = skip | done | (rn_out <= cfg.stall_rtol * rscale)
    host = {k_: v.cpu().numpy() for k_, v in dict(
        iters=k, rnorm0=rnorm0, rnorm=rn_out, converged=accepted & ~bad,
        cg_iters=cg_total).items()}
    return N_out, host
