"""The port's node-sharded path (shakti_tpu_torch/parallel/dist.py) on 2 and
4 gloo ranks on the CPU, in float64:

- 4 steps under Jacobi on test_dist.py's 12x12 slab against the JAX
  package's make_distributed_runner at P = 2 (the port's per-rank bell
  against JAX's ELL) and P = 4 (ELL in both): N and b within 1e-8, equal
  Newton counts, CG within one per Krylov solve;
- BiCGStab at P = 2 against the port's single-device BiCGStab: 1e-8,
  equal Newton counts;
- per-rank block-ELL and block-CSR at P = 4 against the port's
  single-device run without the operator carry (16x16, 3 steps, the
  global two-level): 1e-8;
- the global two-level against Jacobi (1e-7, no more CG) and against the
  single-device two-level (1e-8); the per-rank two-level against Jacobi;
- mg (the Chebyshev V-cycle, the W-cycle, smoothed-P transfers) against
  the single-device mg at 1e-8 (tests/test_mg.py);
- the steady march (20 PTC attempts on the 8x8 slab) against the
  single-device march: the same steps, accepted and rejected counts, N and
  b within 1e-8; the cycle certificate from its state likewise;
- on every case every rank ends with bitwise equal Newton and CG counts and
  residual norms;
- the float32 cold start (the bench model's first step, dt/10, with phase
  19 (b)'s settings: aggregates of 16, no operator carry): the JAX
  package's run on 4 simulated devices lies as far from its float64 run
  as its single-device float32 run does (~25 % of scale in N), in the
  same direction; the port's 4 ranks do the same, and lie within 8 % of
  scale of JAX's 4 devices (read 4.2 %; JAX's 4 devices lie 2.8 % from
  its single device, the port's 5.9 %: float32's own spread at a
  1-Newton step).  The ranks' error after the cold start is the
  reference's own.
"""

import dataclasses

import numpy as np
import pytest
import torch

import setups.setup_slab as jslab
from shakti_tpu.parallel.dist import gather_state as jgather
from shakti_tpu.parallel.dist import make_distributed_runner as jrunner
from shakti_tpu.parallel.shard import make_device_mesh
from shakti_tpu.solve.timestep import timestep_sizes as jdts
from shakti_tpu_torch.setups import setup_slab as tslab
from shakti_tpu_torch.solve import steady as tsteady
from shakti_tpu_torch.solve.timestep import make_step_fn, run_window, timestep_sizes
from tests.torch_parity import (assert_ranks_agree, case, finish_world,
                                rel_err, start_world)

MG = dict(precond="mg", mg_agg=4, mg_coarse_cap=16)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, run side by side while the JAX references compile."""
    hs = {P: start_world(f"dist{P}", P, tmp_path_factory.mktemp(f"dist{P}"))
          for P in (2, 4)}
    ref = {P: _jax_jacobi(P) for P in (2, 4)}
    ref["cold"] = _cold_start()
    return {P: finish_world(h) for P, h in hs.items()}, ref


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[0][2]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[0][4]


@pytest.fixture(scope="module")
def jax_jacobi(worlds):
    return worlds[1]


def _jax_jacobi(P):
    md = jslab.initialize(nx=12, ny=12, days=2.0, nt_per_day=4)
    md.solver = dataclasses.replace(md.solver, precond="jacobi")
    md.distributed = True
    if P == 4:
        md.operator = "ell"
    runner, st0, plan = jrunner(md, make_device_mesh(P))
    s, d = runner(st0, jdts(md.timesteps, dtype=md.dtype)[:4])
    g = jgather(plan, s)
    return {"N": np.asarray(g.N)[md.node_iperm],
            "b": np.asarray(g.b)[md.node_iperm],
            "newton": np.asarray(d["newton_iters"]),
            "cg": np.asarray(d["cg_iters"])}


def _cold_start():
    """N after the bench model's first step (the dt/10 cold start) in user
    order: JAX's float64 and float32 single-device runs and its float32 run
    on 4 devices, and the port's float32 single-device run, all with phase
    19 (b)'s settings."""
    import bench
    import jax.numpy as jnp

    from shakti_tpu.solve.timestep import make_step_fn as jstep
    from shakti_tpu.solve.timestep import run_window as jrun
    from shakti_tpu_torch.setups import setup_bench

    def jmd(dtype):
        md = bench.build_bench_model()
        md.dtype = dtype
        md.solver = dataclasses.replace(md.solver, coarse_block=16,
                                        lag_operator=False)
        return md

    out = {}
    for tag, dtype in (("f64", jnp.float64), ("f32", jnp.float32)):
        md = jmd(dtype)
        mesh, static, state, cfg = md.freeze()
        s, _ = jrun(jstep(mesh, static, md.params, cfg), state,
                    jdts(md.timesteps, dtype=dtype)[:1])
        N = np.asarray(s.N, np.float64)
        out[tag] = N if md.node_iperm is None else N[md.node_iperm]
    md = jmd(jnp.float32)
    md.distributed = True
    runner, st0, plan = jrunner(md, make_device_mesh(4))
    s, _ = runner(st0, jdts(md.timesteps, dtype=jnp.float32)[:1])
    out["dist"] = np.asarray(jgather(plan, s).N, np.float64)[md.node_iperm]
    md = setup_bench.initialize(days=2)
    md.device, md.dtype = "cpu", torch.float32
    md.solver = dataclasses.replace(md.solver, coarse_block=16,
                                    lag_operator=False)
    out["port"] = np.asarray(_single(1, md)["N"], np.float64)
    return out


def _single(steps, md):
    mesh, static, state, cfg = md.freeze()
    s, d = run_window(make_step_fn(mesh, static, md.params, cfg), state,
                      timestep_sizes(md.timesteps)[:steps])
    assert d["converged"].all()
    return {"N": md.to_user_order(s.N), "b": md.to_user_order(s.b),
            "cg": d["cg_iters"], "newton": d["newton_iters"]}


def _tmd(nx, days=2.0, smooth=False, **solver):
    md = tslab.initialize(nx=nx, ny=nx, days=days, nt_per_day=4)
    md.device, md.dtype = "cpu", torch.float64
    if smooth:
        md.b_init = np.full(md.x.size, 0.01)
        md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0)
    md.solver = dataclasses.replace(md.solver, **solver)
    return md


def _check_counts(ranks):
    assert_ranks_agree(ranks)
    assert ranks[0]["converged"].all()
    return ranks[0]


@pytest.mark.parametrize("P", [2, 4])
def test_jacobi_matches_jax(P, world2, world4, jax_jacobi):
    r = _check_counts(case({2: world2, 4: world4}[P], "jacobi"))
    ref = jax_jacobi[P]
    assert str(r["format"]) == ("bell" if P == 2 else "ell")
    np.testing.assert_array_equal(r["newton"], ref["newton"])
    assert (np.abs(r["cg"] - ref["cg"]) <= r["newton"]).all()
    np.testing.assert_allclose(r["N"], ref["N"], rtol=1e-8)
    np.testing.assert_allclose(r["b"], ref["b"], rtol=1e-8)


def _error(N, ref):
    """N's error against ``ref`` in units of max|ref|."""
    return (N - ref) / np.abs(ref).max()


def _alike(e1, e2):
    """(size ratio, cosine) of two error vectors."""
    n1, n2 = np.linalg.norm(e1), np.linalg.norm(e2)
    return n2 / n1, float(e1 @ e2) / (n1 * n2)


def test_float32_cold_start_on_the_ranks_as_jax(world4, jax_jacobi):
    cold = jax_jacobi["cold"]
    r = _check_counts(case(world4, "cold_f32"))
    ref = cold["f64"]
    e = {k: _error(v, ref) for k, v in (("jax1", cold["f32"]),
                                        ("jax4", cold["dist"]),
                                        ("port1", cold["port"]),
                                        ("port4", r["N"]))}
    for k, v in e.items():
        assert 0.2 < np.abs(v).max() < 0.3, (k, np.abs(v).max())
    # JAX's 4 devices against its single device: the same size and
    # direction, and so the port's 4 ranks against its single device
    for one, four in (("jax1", "jax4"), ("port1", "port4")):
        ratio, cos = _alike(e[one], e[four])
        assert abs(ratio - 1) < 0.1 and cos > 0.99, (one, four, ratio, cos)
    ratio, cos = _alike(e["jax4"], e["port4"])
    assert abs(ratio - 1) < 0.1 and cos > 0.99, (ratio, cos)
    assert np.abs(e["port4"] - e["jax4"]).max() < 0.08


def test_bicgstab_matches_single_device(world2):
    r = _check_counts(case(world2, "bicgstab"))
    ref = _single(3, _tmd(12, precond="jacobi", krylov="bicgstab",
                          lag_operator=False))
    np.testing.assert_array_equal(r["newton"], ref["newton"])
    np.testing.assert_allclose(r["N"], ref["N"], rtol=1e-8)
    np.testing.assert_allclose(r["b"], ref["b"], rtol=1e-8)


@pytest.mark.parametrize("fmt", ["bell", "bcsr"])
def test_rank_block_formats_match_single_device(fmt, world4):
    r = _check_counts(case(world4, fmt))
    assert str(r["format"]) == fmt and str(r["precond"]) == "two_level"
    ref = _single(3, _tmd(16, lag_operator=False))
    np.testing.assert_allclose(r["N"], ref["N"], rtol=1e-8)
    np.testing.assert_allclose(r["b"], ref["b"], rtol=1e-8)


def test_global_two_level(world4):
    tl = _check_counts(case(world4, "two_level"))
    jac = _check_counts(case(world4, "two_level_jacobi"))
    assert int(tl["L"]) >= 32
    np.testing.assert_allclose(tl["N"], jac["N"], rtol=1e-7)
    assert tl["cg"].sum() <= 1.05 * jac["cg"].sum()
    ref = _single(2, _tmd(16, days=0.5, smooth=True, precond="two_level"))
    np.testing.assert_allclose(tl["N"], ref["N"], rtol=1e-8)


def test_local_two_level(world4):
    loc = _check_counts(case(world4, "local_two_level"))
    jac = _check_counts(case(world4, "two_level_jacobi"))
    assert int(loc["block"]) == 8 and int(loc["L"]) >= 4 * 8
    np.testing.assert_allclose(loc["N"], jac["N"], rtol=1e-7)


@pytest.mark.parametrize("name,extra", [
    ("mg_v", {}), ("mg_w", dict(mg_cycle="w")),
    ("mg_sp", dict(mg_smooth_p=4.0 / 3.0))])
def test_mg_matches_single_device(name, extra, world4):
    r = _check_counts(case(world4, name))
    assert str(r["precond"]) == "mg"
    ref = _single(3, _tmd(16, days=1.0, smooth=True, **MG, **extra))
    np.testing.assert_array_equal(r["newton"], ref["newton"])
    np.testing.assert_allclose(r["N"], ref["N"], rtol=1e-8)
    np.testing.assert_allclose(r["b"], ref["b"], rtol=1e-8)


@pytest.fixture(scope="module")
def steady_single():
    md = _tmd(8)
    mesh, static, state, cfg = md.freeze()
    state = dataclasses.replace(state, lag_op=None)
    step, _ = tsteady.make_steady_step(mesh, static, md.params, cfg)
    mask = ~static.dirichlet
    s, info = tsteady.steady_solve(step, state, params=md.params,
                                   drift_mask=mask, tol=2e-2, max_steps=20,
                                   dt0=3600.0)
    mean, cinfo = tsteady.cycle_certify(step, s, params=md.params,
                                        dt=float(info["dt"]), tol=2e-2,
                                        window=3, drift_mask=mask)
    return s, info, mean, cinfo


def test_steady_matches_single_device(world2, steady_single):
    ranks = case(world2, "steady")
    keys = [k for k in ranks[0] if k.startswith(("info_", "cycle_"))]
    assert_ranks_agree(ranks, keys)
    r = ranks[0]
    s, info, mean, cinfo = steady_single
    for k in ("steps", "accepted", "rejected", "newton_total", "converged"):
        assert int(r[f"info_{k}"]) == int(info[k]), k
    assert int(r["info_steps"]) == 20
    for k in ("rate", "dt", "kappa", "t_pseudo"):
        assert float(r[f"info_{k}"]) == pytest.approx(float(info[k]),
                                                      rel=1e-6), k
    assert rel_err(r["N"], s.N) < 1e-8 and rel_err(r["b"], s.b) < 1e-8
    for k in ("steps", "accepted", "certified"):
        assert int(r[f"cycle_{k}"]) == int(cinfo[k]), k
    assert float(r["cycle_cycle_rate"]) == pytest.approx(
        float(cinfo["cycle_rate"]), rel=1e-5)
    assert rel_err(r["mean_N"], mean.N) < 1e-8
    assert rel_err(r["mean_b"], mean.b) < 1e-8
