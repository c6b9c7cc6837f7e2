"""The multilevel V-cycle preconditioner of the port (shakti_tpu_torch/solve/
mg.py and its wiring in precond, newton and freeze) against shakti_tpu's
solve/mg.py, in float64 on the CPU:

- the host hierarchy equals JAX's array by array (24x24 slab, agg 4, cap
  16: three ELL levels), and a mesh at or below the cap has none;
- the level operators and diagonals at rtol 1e-12, the dense coarse inverse
  at 1e-10, from the same element blocks;
- one apply within 1e-12 of scale of JAX's for every smoother, cycle and
  transfer (jacobi/cheb, v/w, smooth_p 0 and 4/3);
- four steps of the slab under 'mg' in every operator format: N within 1e-9
  of scale, equal Newton counts (CG may differ by one per solve: dots and
  norms sum in another order);
- freeze's rules (RCB under mg in every format, no operator carry, two_level
  below the cap) and mg's cut of CG iterations against Jacobi.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import setups.setup_slab as jslab
from shakti_tpu.physics import residual as jres
from shakti_tpu.solve import mg as jmg
from shakti_tpu.solve.newton import diag_floor_extra as jfloor
from shakti_tpu.solve.timestep import make_step_fn as jstep_fn
from shakti_tpu.solve.timestep import timestep_sizes as jdts
from shakti_tpu_torch.convert import problem_from_numpy
from shakti_tpu_torch.physics import residual as tres
from shakti_tpu_torch.setups import setup_slab as tslab
from shakti_tpu_torch.solve import mg as tmg
from shakti_tpu_torch.solve.newton import diag_floor_extra
from shakti_tpu_torch.solve.timestep import make_step_fn, run_window, timestep_sizes
from tests.torch_parity import frozen_to_numpy, rel_err

MG = dict(precond="mg", mg_agg=4, mg_coarse_cap=16)


def _jax_problem(nx=24, op="ell", **solver):
    md = jslab.initialize(nx=nx, ny=nx, days=1.0, nt_per_day=4)
    md.b_init = np.full(md.x.size, 0.01)
    md.operator = op
    md.operator_block = 16
    md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0, **solver)
    return md, md.freeze()


def _torch_md(nx, **solver):
    md = tslab.initialize(nx=nx, ny=nx, days=1.0, nt_per_day=4)
    md.b_init = np.full(md.x.size, 0.01)
    md.device, md.dtype = "cpu", torch.float64
    md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0, **solver)
    return md


@pytest.fixture(scope="module")
def slab24():
    """The 24x24 slab frozen by shakti_tpu under mg in ELL, the port's
    problem from it, and the step-0 element blocks of both."""
    md, (mesh, static, state, cfg) = _jax_problem(**MG)
    dt = jdts(md.timesteps, dtype=md.dtype)[0]
    pre = jres.precompute_step(mesh, state.N, state.b, state.q, state.melt,
                               static, dt, md.params, cfg.quad_degree)
    J = np.array(jres.element_jacobian(state.N, pre, mesh, md.params))
    tm, ts, tst, tcfg = problem_from_numpy(
        *frozen_to_numpy(mesh, static, state, cfg))
    return dict(md=md, mesh=mesh, static=static, state=state, cfg=cfg, J=J,
                tm=tm, ts=ts, tcfg=tcfg)


def test_hierarchy_equals_jax(slab24):
    mesh, tm = slab24["mesh"], slab24["tm"]
    ref = mesh.mg
    assert len(ref.cols) >= 2
    cells, n = np.asarray(mesh.cells), mesh.n_nodes
    # the port's own build, and the plan convert attached as freeze does
    for plan in (tmg.build_hierarchy(cells, n, agg=4, cap=16), tm.mg):
        assert plan.agg == ref.agg == 4 and plan.m_c == ref.m_c
        assert plan.sizes == [c.shape[0] for c in ref.cols] + [ref.m_c]
        for k in ("cols", "diag_slot", "next_map"):
            assert len(getattr(plan, k)) == len(getattr(ref, k)), k
        for got, want in [(plan.map9, ref.map9), (plan.agg_fine, ref.agg_fine)] \
                + list(zip(plan.cols, ref.cols)) \
                + list(zip(plan.diag_slot, ref.diag_slot)) \
                + list(zip(plan.next_map, ref.next_map)):
            # value for value; the index tables are int64 in the port
            want = np.asarray(want)
            assert got.numpy().dtype in (want.dtype, np.int64)
            np.testing.assert_array_equal(got.numpy(), want)
        assert plan.map9.dtype == plan.next_map[0].dtype == torch.int32
    # at or below the cap: no hierarchy in either package
    assert tmg.build_hierarchy(cells, n, agg=4, cap=n) is None
    assert jmg.build_hierarchy(cells, n, agg=4, cap=n) is None


def test_assemble_levels_matches_jax(slab24):
    p = slab24
    mesh, tm = p["mesh"], p["tm"]
    d = p["static"].dirichlet
    levels, A_inv = jmg.assemble_levels(jnp.asarray(p["J"]), mesh, d, mesh.mg)
    tlevels, tA_inv = tmg.assemble_levels(torch.as_tensor(p["J"]), tm,
                                          p["ts"].dirichlet, tm.mg)
    assert len(tlevels) == len(levels)
    for (V, dg), (tV, tdg) in zip(levels, tlevels):
        V, dg = np.asarray(V), np.asarray(dg)
        atol = 1e-12 * np.abs(V).max()
        np.testing.assert_allclose(tV.numpy(), V, rtol=1e-12, atol=atol)
        np.testing.assert_allclose(tdg.numpy(), dg, rtol=1e-12, atol=atol)
    A_inv = np.asarray(A_inv)
    assert rel_err(tA_inv.numpy(), A_inv) <= 1e-10


@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
@pytest.mark.parametrize("cycle", ["v", "w"])
@pytest.mark.parametrize("smooth_p", [0.0, 4.0 / 3.0])
def test_apply_matches_jax(slab24, smoother, cycle, smooth_p):
    """One apply of the cycle on a seeded residual, each package with its
    own regularized fine operator (the same values)."""
    p = slab24
    mesh, tm, cfg = p["mesh"], p["tm"], p["cfg"]
    jd, td = p["static"].dirichlet, p["ts"].dirichlet
    J = jnp.asarray(p["J"])
    kw = dict(omega=cfg.mg_omega, smoother=smoother, cheb_deg=cfg.mg_cheb_deg,
              cheb_frac=cfg.mg_cheb_frac, cycle=cycle, smooth_p=smooth_p)

    matvec0, a_diag = jres.make_operator(J, mesh, jd)
    extra = jfloor(a_diag, jd, mesh, cfg.diag_floor_rel)
    japply = jmg.make_multilevel(J, mesh, jd, a_diag + extra,
                                 lambda x: matvec0(x) + extra * x, **kw)

    tJ = torch.as_tensor(p["J"])
    vals = tres.fold_operator_values(tJ, tm)
    ta = tres.operator_diag_from_values(vals, tm)
    textra = diag_floor_extra(ta, td, tm, cfg.diag_floor_rel)
    tapply = tmg.make_multilevel(
        tJ, tm, td, ta + textra,
        tres.operator_from_values(vals, tm, td, textra), **kw)

    r = np.random.default_rng(5).normal(size=tm.n_nodes)
    want = np.asarray(japply(jnp.asarray(r)))
    got = tapply(torch.as_tensor(r)).numpy()
    assert rel_err(got, want) <= 1e-12
    np.testing.assert_array_equal(got[td.numpy()], r[td.numpy()])


@pytest.mark.parametrize("op", ["bell", "ell", "bcsr", "cells"])
def test_steps_match_jax(op, slab24):
    """Four steps of the 24x24 slab under mg (cheb, V) through the same
    frozen problem in each format (ELL's is the module's)."""
    if op == "ell":
        md, mesh, static, state, cfg = (slab24[k] for k in (
            "md", "mesh", "static", "state", "cfg"))
    else:
        md, (mesh, static, state, cfg) = _jax_problem(op=op, **MG)
    assert mesh.mg is not None and not cfg.lag_operator
    jstep = jax.jit(jstep_fn(mesh, static, md.params, cfg))
    dts = np.asarray(jdts(md.timesteps, dtype=md.dtype))[:4]
    tm, ts, tstate, tcfg = problem_from_numpy(
        *frozen_to_numpy(mesh, static, state, cfg))
    assert tm.mg.sizes == [c.shape[0] for c in mesh.mg.cols] + [mesh.mg.m_c]
    assert tcfg.precond == "mg" and tcfg.mg_smoother == "cheb"
    tstep = make_step_fn(tm, ts, md.params, tcfg)
    tdts = timestep_sizes(md.timesteps, torch.float64)[:4]
    for i in range(4):
        state, d = jstep(state, dts[i])
        tstate, td = tstep(tstate, tdts[i])
        assert td["converged"] and bool(d["converged"]), i
        assert td["newton_iters"] == int(d["newton_iters"]), i
        assert abs(td["cg_iters"] - int(d["cg_iters"])) <= td["newton_iters"], i
        err = rel_err(tstate.N.numpy(), np.asarray(state.N))
        assert err <= 1e-9, (i, err)


@pytest.mark.parametrize("op", ["bell", "ell", "bcsr", "cells"])
def test_freeze_rules(op):
    """Under mg every format is RCB-ordered, carries the hierarchy and no
    operator carry (even when one is asked for); a mesh at or below the cap
    has no hierarchy and solves as two_level."""
    md = _torch_md(24, lag_operator=True, **MG)
    md.operator = op
    mesh, _, state, cfg = md.freeze()
    assert md.node_iperm is not None
    assert not cfg.lag_operator and state.lag_op is None
    assert mesh.mg is not None and mesh.mg.sizes[-1] <= 16
    md = _torch_md(6, precond="mg")
    md.operator = op
    mesh, static, state, cfg = md.freeze()
    assert mesh.mg is None
    _, d = run_window(make_step_fn(mesh, static, md.params, cfg), state,
                      timestep_sizes(md.timesteps, md.dtype)[:2])
    assert d["converged"].all()


def test_mg_beats_jacobi_iteration_count():
    """tests/test_mg.py's claim on the port: on the 40x40 slab's hierarchy
    the V-cycle makes fewer than half of Jacobi's CG iterations."""
    counts = {}
    for pc, kw in (("jacobi", dict(precond="jacobi")), ("mg", MG)):
        md = _torch_md(40, **kw)
        md.operator = "bcsr"
        mesh, static, state, cfg = md.freeze()
        _, d = run_window(make_step_fn(mesh, static, md.params, cfg), state,
                          timestep_sizes(md.timesteps, md.dtype)[:2])
        assert d["converged"].all(), pc
        counts[pc] = int(d["cg_iters"].sum())
    assert counts["mg"] < 0.5 * counts["jacobi"], counts
