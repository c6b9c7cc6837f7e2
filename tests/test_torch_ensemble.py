"""The batched ensemble of the port (shakti_tpu_torch/parallel/ensemble.py,
solve/newton.newton_solve_batched, the batched Krylov solvers and
preconditioners, the member-batched block-ELL matvec) against shakti_tpu's
vmapped ensemble, in float64 on the CPU:

- perturbed_ensemble draws JAX's initial states bit for bit;
- 3 members over 3 steps of the 8x8 slab (the default adaptive_dt_levels=1)
  equal JAX's make_ensemble_runner within 1e-10 of scale, with equal Newton
  counts per member and step;
- a member equals its own single run (tests/test_aux.py's check) in every
  operator format (bell, ell, bcsr, cells) and preconditioner (jacobi,
  two_level, mg with a hierarchy), within 1e-10 with equal Newton counts;
- a lag config is forced off; the batched dt-halving retries only the
  members that failed;
- the batched plain matvec equals the per-member plain matvec bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import setups.setup_slab as jslab
from shakti_tpu.parallel import ensemble as jens
from shakti_tpu.solve.timestep import timestep_sizes as jdts
from shakti_tpu_torch.convert import problem_from_numpy
from shakti_tpu_torch.fem.bell import bell_from_elements
from shakti_tpu_torch.ops import spmv_cuda as sp
from shakti_tpu_torch.parallel import ensemble as tens
from shakti_tpu_torch.setups import setup_slab as tslab
from shakti_tpu_torch.solve import timestep as tts
from tests.torch_parity import frozen_to_numpy, rel_err

B_SCALE, SEED = 2e-4, 1


@pytest.fixture(scope="module")
def jax_run():
    """JAX's 3-member, 3-step ensemble on the 8x8 slab (its default
    solver: two-level, adaptive_dt_levels=1) and the frozen problem."""
    md = jslab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    mesh, static, state, cfg = md.freeze()
    ens = jens.perturbed_ensemble(state, 3, b_scale=B_SCALE, seed=SEED)
    dts = jdts(md.timesteps, dtype=md.dtype)[:3]
    out, diags = jens.make_ensemble_runner(mesh, static, md.params, cfg)(
        ens, dts)
    return dict(md=md, problem=frozen_to_numpy(mesh, static, state, cfg),
                ens_b=np.asarray(ens.b),
                out={k: np.asarray(getattr(out, k))
                     for k in ("N", "b", "q", "melt")},
                diags={k: np.asarray(v) for k, v in diags.items()})


def test_perturbed_ensemble_is_jax_bitwise(jax_run):
    _, _, state, _ = problem_from_numpy(*jax_run["problem"])
    ens = tens.perturbed_ensemble(state, 3, b_scale=B_SCALE, seed=SEED)
    assert ens.b.shape == (3,) + tuple(state.b.shape)
    assert np.array_equal(ens.b.numpy(), jax_run["ens_b"])
    assert ens.lag_op is None and torch.equal(ens.N[2], state.N)


def test_ensemble_matches_jax_and_member_runs(jax_run):
    md = jax_run["md"]
    mesh, static, state, cfg = problem_from_numpy(*jax_run["problem"])
    assert cfg.adaptive_dt_levels == 1
    ens = tens.perturbed_ensemble(state, 3, b_scale=B_SCALE, seed=SEED)
    dts = tts.timestep_sizes(md.timesteps, torch.float64)[:3]
    out, diags = tens.make_ensemble_runner(mesh, static, md.params, cfg)(
        ens, dts)
    assert diags["newton_iters"].shape == (3, 3)
    assert diags["converged"].all()
    np.testing.assert_array_equal(diags["newton_iters"],
                                  jax_run["diags"]["newton_iters"])
    for k, ref in jax_run["out"].items():
        assert rel_err(getattr(out, k).numpy(), ref) <= 1e-10, k
    # member 1 alone (tests/test_aux.py)
    step = tts.make_step_fn(mesh, static, md.params, cfg)
    s1, d1 = tts.run_window(step, tens.member(ens, 1), dts)
    np.testing.assert_array_equal(d1["newton_iters"],
                                  diags["newton_iters"][:, 1])
    assert rel_err(out.N[1].numpy(), s1.N.numpy()) <= 1e-10


def test_ensemble_forces_lag_off():
    md = tslab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    md.device, md.dtype, md.operator = "cpu", torch.float64, "bell"
    md.solver = dataclasses.replace(md.solver, lag_operator=True,
                                    adaptive_dt_levels=0)
    mesh, static, state, cfg = md.freeze()
    assert state.lag_op is not None
    ens = tens.perturbed_ensemble(state, 2, b_scale=B_SCALE, seed=SEED)
    assert ens.lag_op is None
    out, diags = tens.make_ensemble_runner(mesh, static, md.params, cfg)(
        ens, tts.timestep_sizes(md.timesteps, torch.float64)[:2])
    assert diags["converged"].all() and out.lag_op is None


CASES = [("bell", "two_level"), ("ell", "two_level"), ("bcsr", "two_level"),
         ("cells", "two_level"), ("bell", "jacobi"), ("ell", "mg"),
         ("bell", "mg")]


@pytest.mark.parametrize("op,precond", CASES)
def test_member_equals_single_run(op, precond):
    """2 members over 2 steps: each equals its own single run (the batched
    Krylov solve, preconditioner and operator of every format; 'mg' with a
    hierarchy, its V-cycle per member)."""
    md = tslab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    md.b_init = np.full(md.x.size, 0.01)
    md.device, md.dtype, md.operator = "cpu", torch.float64, op
    md.operator_block = 16
    solver = dict(precond=precond, adaptive_dt_levels=0)
    if precond == "mg":
        solver.update(mg_agg=4, mg_coarse_cap=16)
    md.solver = dataclasses.replace(md.solver, **solver)
    mesh, static, state, cfg = md.freeze()
    assert (mesh.mg is not None) == (precond == "mg")
    ens = tens.perturbed_ensemble(state, 2, b_scale=5e-3, seed=3)
    dts = tts.timestep_sizes(md.timesteps, torch.float64)[:2]
    out, diags = tens.make_ensemble_runner(mesh, static, md.params, cfg)(
        ens, dts)
    assert diags["converged"].all()
    step = tts.make_step_fn(mesh, static, md.params,
                            dataclasses.replace(cfg, lag_operator=False))
    for m in range(2):
        s, d = tts.run_window(step, tens.member(ens, m), dts)
        np.testing.assert_array_equal(d["newton_iters"],
                                      diags["newton_iters"][:, m])
        for k in ("N", "b"):
            assert rel_err(getattr(out, k)[m].numpy(),
                           getattr(s, k).numpy()) <= 1e-10, (m, k)


def test_dt_halving_retries_only_failed_members():
    """A stub step that converges only for dt below a member's threshold:
    the members that fail are redone as two half steps, the others keep
    their first result."""
    limit = np.array([1000.0, 2000.0, 500.0])

    def base(state, forcing):
        M = state.N.shape[0]
        lim = limit[:M] if M == 3 else limit[[0, 2]]
        ok = float(forcing) < lim
        d = {"newton_iters": np.ones(M, int), "rnorm": np.full(M, 1.0),
             "rnorm0": np.full(M, 1.0), "converged": ok,
             "cg_iters": np.ones(M, int)}
        return dataclasses.replace(state, N=state.N + float(forcing)), d

    state = tts.State(N=torch.zeros(3, 2), b=torch.zeros(3, 2),
                      q=torch.zeros(3, 2, 2), melt=torch.zeros(3, 2))
    s, d = tens.with_dt_halving_batched(base)(state, 1500.0)
    assert s.N[:, 0].tolist() == [1500.0, 1500.0, 1500.0]
    assert d["newton_iters"].tolist() == [2, 1, 2]
    assert d["converged"].tolist() == [True, True, False]


def test_batched_plain_matvec_is_per_member_bitwise():
    md = tslab.initialize(nx=12, ny=12)
    md.device, md.dtype = "cpu", torch.float64
    mesh, static = md.freeze()[:2]
    rng = np.random.default_rng(0)
    M = 3
    vals = torch.stack([bell_from_elements(torch.as_tensor(
        rng.standard_normal((mesh.n_cells, 3, 3))), mesh) for _ in range(M)])
    x = torch.as_tensor(rng.standard_normal((M, mesh.n_nodes)))
    extra = torch.as_tensor(rng.random((M, mesh.n_nodes)))
    for d, e in ((None, None), (static.dirichlet, extra)):
        y = sp.bell_operator_batched_fn(vals, mesh, d, e)(x)
        for m in range(M):
            ym = sp.bell_operator_fn(vals[m], mesh, d,
                                     None if e is None else e[m])(x[m])
            assert torch.equal(y[m], ym)
    with pytest.raises(ValueError, match="extra"):
        sp.bell_operator_batched_fn(vals, mesh, None, extra[:2])
