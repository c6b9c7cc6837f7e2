"""shakti_tpu_torch.solve (pcg, newton_solve) vs shakti_tpu on the same
inputs in float64; the Newton inputs come from shakti_tpu's freeze()
through shakti_tpu_torch.convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.physics import residual as jres
from shakti_tpu.solve import krylov as jkrylov
from shakti_tpu.solve.newton import newton_solve as jnewton
from shakti_tpu.solve.timestep import make_step_fn as jstep_fn
from shakti_tpu.solve.timestep import timestep_sizes as jdts
from shakti_tpu_torch.convert import problem_from_numpy, state_to_numpy
from shakti_tpu_torch.physics import residual as tres
from shakti_tpu_torch.solve import krylov as tkrylov
from shakti_tpu_torch.solve.newton import newton_solve as tnewton
from tests.golden_cases import lake_case
from tests.torch_parity import frozen_to_numpy, rel_err


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_pcg_matches_jax(precond):
    rng = np.random.default_rng(0)
    n = 80
    M = rng.normal(size=(n, n))
    A = M @ M.T + 0.5 * n * np.diag(1.0 + rng.random(n) * 50)
    b = rng.normal(size=n)
    d = 1.0 / np.diag(A) if precond == "jacobi" else None
    jx, ji = jkrylov.pcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                         None if d is None else jnp.asarray(d), rtol=1e-10)
    tA = torch.as_tensor(A)
    tx, ti = tkrylov.pcg(lambda v: tA @ v, torch.as_tensor(b),
                         None if d is None else torch.as_tensor(d), rtol=1e-10)
    assert ti["iters"] == int(ji["iters"]) > 5
    assert ti["converged"] and bool(ji["converged"])
    assert rel_err(tx.numpy(), np.asarray(jx)) <= 1e-9


@pytest.fixture(scope="module")
def lake_problem():
    """The lake golden case frozen by shakti_tpu in block-ELL, its state
    after one JAX step (a valid lag carry) and both step-1 inputs."""
    md, _, _ = lake_case()
    md.operator = "bell"
    mesh, static, state0, cfg = md.freeze()
    dts = jdts(md.timesteps, dtype=md.dtype)
    step = jax.jit(jstep_fn(mesh, static, md.params, cfg))
    state1, _ = step(state0, dts[0])
    newton = jax.jit(lambda g, pr, ref, lag: jnewton(
        g, pr, mesh, static.dirichlet, static.N_bdry, md.params, cfg,
        N_ref=ref, lag=lag))
    return dict(md=md, mesh=mesh, static=static, cfg=cfg, dt=dts[1],
                states={"cold": state0, "carried": state1}, newton=newton)


@pytest.mark.parametrize("start", ["cold", "carried"])
def test_newton_solve_matches_jax(lake_problem, start):
    """One Newton solve from the same precompute_step inputs: equal Newton
    counts, N at 1e-9, and CG counts within 1 per Krylov solve (dots and
    norms sum in another order, which can move each solve's stopping test
    by one iteration)."""
    p = lake_problem
    md, mesh, static, cfg = p["md"], p["mesh"], p["static"], p["cfg"]
    st = p["states"][start]
    pre = jres.precompute_step(mesh, st.N, st.b, st.q, st.melt, static, p["dt"],
                               md.params, cfg.quad_degree)
    guess = 2.0 * st.N - st.N_prev
    N_j, s_j = p["newton"](guess, pre, st.N, st.lag_op)

    tm, ts, tst, tcfg = problem_from_numpy(*frozen_to_numpy(mesh, static, st, cfg))
    assert tst.lag_op[0] == bool(st.lag_op[0])
    tpre = tres.precompute_step(tm, tst.N, tst.b, tst.q, tst.melt, ts,
                                torch.as_tensor(np.asarray(p["dt"])), md.params,
                                tcfg.quad_degree)
    N_t, s_t = tnewton(2.0 * tst.N - tst.N_prev, tpre, tm, ts.dirichlet,
                       ts.N_bdry, md.params, tcfg, N_ref=tst.N, lag=tst.lag_op)
    assert s_t["converged"] and bool(s_j["converged"])
    assert s_t["iters"] == int(s_j["iters"]) >= 1
    assert abs(s_t["cg_iters"] - int(s_j["cg_iters"])) <= s_t["iters"]
    assert rel_err(N_t.numpy(), np.asarray(N_j)) <= 1e-9
    # the returned carry matches JAX's slot for slot
    lag_j, lag_t = s_j["lag"], s_t["lag"]
    assert lag_t[0] == bool(lag_j[0]) and lag_t[1] == int(lag_j[1])
    assert rel_err(lag_t[2].numpy(), np.asarray(lag_j[2])) <= 1e-9


def test_state_roundtrip_through_numpy(lake_problem):
    st = lake_problem["states"]["carried"]
    m, s, cfg = lake_problem["mesh"], lake_problem["static"], lake_problem["cfg"]
    _, _, tst, _ = problem_from_numpy(*frozen_to_numpy(m, s, st, cfg))
    back = state_to_numpy(tst)
    for k in ("N", "b", "q", "melt", "N_prev"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(st, k)))
    for a, b in zip(back["lag_op"], st.lag_op):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert dataclasses.asdict(cfg).keys() >= {"lag_operator", "coarse_block"}
