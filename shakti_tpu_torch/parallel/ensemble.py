"""Batched ensembles: one timestep for M perturbed model states at once.

Port of shakti_tpu/parallel/ensemble.py, which vmaps the timestep.  Here the
member axis is written out: the per-step precompute and the explicit update
are ``torch.func.vmap`` of the single-member functions, and the Newton-Krylov
solve is solve/newton.newton_solve_batched, where each member iterates
until its own tests stop it (a member that has stopped keeps its iterate,
as under ``jax.vmap``).  On the card every block-ELL Krylov matvec of the
ensemble is one member-batched bell_spmv launch.  An ensemble serves, for
example, uncertainty quantification over the stochastic initial gap height
that the reference draws unseeded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shakti_tpu_torch.physics import residual as res
from shakti_tpu_torch.solve.newton import newton_solve_batched
from shakti_tpu_torch.solve.timestep import (State, explicit_update,
                                             forcing_terms, newton_guess,
                                             run_window)
from shakti_tpu_torch.utils.trace import span

_FIELDS = ("N", "b", "q", "melt", "N_prev")


def _map(fn, state: State) -> State:
    return State(**{k: None if getattr(state, k) is None
                    else fn(k, getattr(state, k)) for k in _FIELDS})


def stack_states(states) -> State:
    """Stack a list of States into one batched State (leading member axis;
    no operator carry)."""
    return _map(lambda k, _: torch.stack([getattr(s, k) for s in states]),
                states[0])


def member(state: State, m: int) -> State:
    """Member ``m`` (an index or an index tensor) of a batched State."""
    return _map(lambda _, v: v[m], state)


def perturbed_ensemble(state: State, n_members: int, *, b_scale: float = 5e-4,
                       seed: int = 0) -> State:
    """Ensemble of initial states with the gap height b perturbed by seeded
    normal draws (the reference's stochastic initial condition as a
    controlled ensemble axis): the JAX package's draws, in its order and
    cast to the state's type."""
    rng = np.random.default_rng(seed)
    members = []
    for _ in range(n_members):
        db = torch.as_tensor(rng.normal(scale=b_scale, size=tuple(state.b.shape)),
                             dtype=state.b.dtype, device=state.b.device)
        members.append(State(N=state.N, b=state.b + db, q=state.q,
                             melt=state.melt, N_prev=state.N_prev))
    return stack_states(members)


def make_ensemble_step_fn(mesh, static, params, cfg):
    """step(batched_state, forcing) -> (batched_state, diagnostics), the
    diagnostics (M,) numpy arrays; the forcing is shared by all members.

    Forces ``lag_operator=False``: a carried operator per member would cost
    M copies of the folded values (the JAX package forces it off for the
    same reason under vmap).  With cfg.adaptive_dt_levels, a step retries
    only the members that failed, as two half steps, and keeps the others'
    results."""
    cfg = dataclasses.replace(cfg, lag_operator=False)
    if cfg.differentiable:
        raise NotImplementedError("ensembles take differentiable=False")
    p = params
    sq = res.static_quad_fields(mesh, static, cfg.quad_degree,
                                mesh.nodes.dtype)

    def step(state: State, forcing):
        with span("step"):
            dt, dt_b, sq_t = forcing_terms(sq, forcing)
            pre = res.StepPre(*torch.func.vmap(
                lambda N, b, q, melt: res.pre_values(res.precompute_step(
                    mesh, N, b, q, melt, static, dt, p, cfg.quad_degree,
                    sq=sq_t)))(state.N, state.b, state.q, state.melt))
            N, stats = newton_solve_batched(
                newton_guess(state, cfg), pre, mesh, static.dirichlet,
                static.N_bdry, p, cfg, N_ref=state.N)
            q, melt, b = torch.func.vmap(
                lambda N_, b_, q_, m_: explicit_update(mesh, static, p, N_, b_,
                                                       q_, m_, dt_b))(
                N, state.b, state.q, state.melt)
            new_state = State(N=N, b=b, q=q, melt=melt, N_prev=state.N)
            diag = {"newton_iters": stats["iters"], "rnorm": stats["rnorm"],
                    "rnorm0": stats["rnorm0"], "converged": stats["converged"],
                    "cg_iters": stats["cg_iters"]}
            return new_state, diag

    out = step
    for lvl in range(cfg.adaptive_dt_levels):
        out = with_dt_halving_batched(out, lvl)
    return out


def with_dt_halving_batched(base, level: int = 0, accept_rtol: float = 1e-4):
    """solve/timestep.with_dt_halving for a batched step: the members whose
    step failed are redone, alone, as two half-dt sub-steps from their
    state; the others keep their first result (``lax.cond`` under
    ``jax.vmap`` selects the same)."""

    def halve(forcing):
        if isinstance(forcing, dict):
            return dict(forcing, dt=0.5 * forcing["dt"])
        return 0.5 * forcing

    def stepped(state, forcing):
        s1, d1 = base(state, forcing)
        failed = np.flatnonzero(~d1["converged"])
        if failed.size == 0:
            return s1, d1
        idx = torch.as_tensor(failed, device=state.N.device)
        half = halve(forcing)
        sa, da = base(member(state, idx), half)
        sb, db = base(sa, half)
        tiny = torch.finfo(state.N.dtype).tiny
        deep = db["rnorm"] <= accept_rtol * np.maximum(da["rnorm0"], tiny)
        retry = {"newton_iters": da["newton_iters"] + db["newton_iters"],
                 "rnorm": db["rnorm"], "rnorm0": da["rnorm0"],
                 "converged": db["converged"] & (da["converged"] | deep),
                 "cg_iters": da["cg_iters"] + db["cg_iters"]}
        diag = {k: v.copy() for k, v in d1.items()}
        for k, v in retry.items():
            diag[k][failed] = v
        return _map(lambda k, v: v.index_put((idx,), getattr(sb, k)),
                    s1), diag

    return stepped


def make_ensemble_runner(mesh, static, params, cfg):
    """(batched_state, forcing) -> (batched_state, diagnostics), each
    diagnostic a (steps, M) numpy array."""
    estep = make_ensemble_step_fn(mesh, static, params, cfg)
    return lambda state, forcing: run_window(estep, state, forcing)
