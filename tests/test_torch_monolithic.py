"""The port's monolithic coupled steady Newton (shakti_tpu_torch/solve/
monolithic.py) against shakti_tpu's, in float64 on the CPU.

One fixture: the JAX package's PTC state of the 16x16 slab
(tests/test_monolithic.py's case, ELL), carried into the port.  From it:

- the frozen fields, the exact fixed-point residual, the element blocks and
  the colored dense Jacobian equal JAX's to 1e-12 of scale, the coloring
  plan exactly, and the Jacobian equals torch.func.jacfwd of the residual;
- one dense Newton step (_dense_solve_A) and a polish with
  linear="bicgstab" against JAX's;
- steady_polish (tol 1e-6): JAX's Newton count, n_fixed, verdict and
  refreshes, N and b within 1e-8 of scale; dtau_seed=None likewise; the
  port's transient step does not move the polished state;
- polish.npz: a Newton-budget exit of either package resumed by the other
  continues as the writer would (the same keys); an unconverged march's
  stationarity statistics and time-mean state against JAX's.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import setups.setup_slab as jslab
from shakti_tpu.solve import monolithic as jm
from shakti_tpu_torch.convert import problem_from_numpy
from shakti_tpu_torch.params import DEFAULT_PARAMS as P
from shakti_tpu_torch.solve import monolithic as tm
from shakti_tpu_torch.solve.newton import zero_lag
from shakti_tpu_torch.solve.timestep import make_step_fn
from tests.torch_parity import frozen_to_numpy, rel_err

YEAR = 3.1536e7
CK_KEYS = {"N", "b", "q", "melt", "N_prev", "newton", "krylov", "seg",
           "refreshed", "stale", "best_rate", "dstate", "dtau_carry", "spent",
           "traj_b", "traj_N", "traj_t"}


@pytest.fixture(scope="module")
def slab():
    md = jslab.initialize(nx=16, ny=16)
    md.operator = "ell"
    out = md.solve_steady(tol=2e-2, max_steps=1600)
    mesh, static, _, cfg = md.freeze()
    st = dataclasses.replace(out["state"], lag_op=None)
    tmesh, tstatic, tst, tcfg = problem_from_numpy(
        *frozen_to_numpy(mesh, static, st, cfg))
    js, ji = jm.steady_polish(mesh, static, md.params, st, tol=1e-6)
    ts, ti = tm.steady_polish(tmesh, tstatic, P, tst, tol=1e-6)
    return dict(md=md, mesh=mesh, static=static, st=st, ptc=out,
                tmesh=tmesh, tstatic=tstatic, tst=tst, tcfg=tcfg,
                js=js, ji=ji, ts=ts, ti=ti)


def _entry(d):
    """Both packages' frozen fields and the entry unknown (N, log b)."""
    st, tst = d["st"], d["tst"]
    jfr = jax.jit(lambda s: jm._frozen_fields(d["mesh"], d["static"], s,
                                              d["md"].params, 4,
                                              jnp.float64))(st)
    tfr = tm._frozen_fields(d["tmesh"], d["tstatic"], tst, P, 4,
                            torch.float64)
    jfr["log_b"] = tfr["log_b"] = True
    dirich = np.asarray(d["static"].dirichlet)
    N0 = np.where(dirich, float(d["static"].N_bdry), np.asarray(st.N))
    u = np.stack([N0, np.log(np.maximum(np.asarray(st.b),
                                        float(d["static"].b_min)))], -1)
    return jfr, tfr, u, torch.as_tensor(u)


def _jres(d, jfr):
    return lambda v: jm._exact_residual(v, jfr, d["mesh"], d["static"],
                                        d["md"].params)


def _tres(d, tfr):
    return lambda v: tm._exact_residual(v, tfr, d["tmesh"], d["tstatic"], P)


def _close(got, ref, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    err = rel_err(got, np.asarray(ref))
    assert err <= tol, err


def test_frozen_fields_and_residual_match_jax(slab):
    jfr, tfr, u, tu = _entry(slab)
    for k in ("G_q", "inputs_q", "mdiff_q", "mdiff_old_n"):
        _close(tfr[k], jfr[k], 1e-12)
    jR = jax.jit(_jres(slab, jfr))(u)
    tR = _tres(slab, tfr)(tu)
    for f in range(2):
        _close(tR[:, f], jR[:, f], 1e-12)
    jq, jmelt, _ = jax.jit(lambda v: jm._nodal_fields(
        v, jfr, slab["mesh"], slab["static"], slab["md"].params))(u)
    tq, tmelt, _ = tm._nodal_fields(tu, tfr, slab["tmesh"], slab["tstatic"], P)
    _close(tq, jq, 1e-12)
    _close(tmelt, jmelt, 1e-12)
    # the element-assembled coupled residual, constrained rows zeroed
    dirich = np.array(slab["static"].dirichlet)
    fix_b = dirich | (np.arange(dirich.size) % 5 == 1)
    jA = jax.jit(lambda v: jm._assemble_residual(
        v, jfr, slab["mesh"], slab["md"].params,
        jm._Masks(dirichlet=jnp.asarray(dirich),
                  active=slab["mesh"].node_area > 0), jnp.asarray(fix_b)))(u)
    tA = tm._assemble_residual(
        tu, tfr, slab["tmesh"], P,
        tm._Masks(dirichlet=torch.as_tensor(dirich),
                  active=slab["tmesh"].node_area > 0), torch.as_tensor(fix_b))
    for f in range(2):
        _close(tA[:, f], jA[:, f], 1e-12)
    assert torch.all(tA[torch.as_tensor(fix_b), 1] == 0)


def test_element_jacobian6_matches_jax(slab):
    jfr, tfr, u, tu = _entry(slab)
    jJ = jax.jit(lambda v: jm._element_jacobian6(v, jfr, slab["mesh"],
                                                 slab["md"].params))(u)
    tJ = tm._element_jacobian6(tu, tfr, slab["tmesh"], P)
    assert tJ.shape == jJ.shape
    for f in range(2):
        for g in range(2):
            _close(tJ[:, :, f, :, g], jJ[:, :, f, :, g], 1e-12)


def test_colored_jacobian_matches_jax_and_jacfwd(slab):
    """The coloring plan exactly; the dense (n, 2, n, 2) Jacobian of one
    batched forward-mode pass against JAX's 2K tangents and against
    torch.func.jacfwd of the same residual (block by block, 1e-12 of each
    block's scale)."""
    jfr, tfr, u, tu = _entry(slab)
    jplan, tplan = jm._coloring_plan(slab["mesh"]), tm._coloring_plan(
        slab["tmesh"])
    assert tplan[4] == jplan[4] and 8 <= tplan[4] <= 64
    for a, b in zip(tplan[:4], jplan[:4]):
        np.testing.assert_array_equal(a, b)

    tres = _tres(slab, tfr)
    jA = np.asarray(jax.jit(lambda v: jm._colored_jacobian(
        _jres(slab, jfr), v, jplan, jnp.float64))(u))
    tA = tm._colored_jacobian(tres, tu, tplan, torch.float64)
    full = torch.func.jacfwd(tres)(tu)
    for f in range(2):
        for g in range(2):
            _close(tA[:, f, :, g], jA[:, f, :, g], 1e-12)
            _close(tA[:, f, :, g], full[:, f, :, g].numpy(), 1e-12)
    # the colored matrix holds exactly the 2-hop pattern
    assert int((tA.abs().sum(dim=(1, 3)) > 0).sum()) <= tplan[1].size


def test_dense_solve_step_matches_jax(slab):
    """One exact Newton step: the damped, row-scaled, constrained system of
    the entry state, with a bound-fixed b row set."""
    jfr, tfr, u, tu = _entry(slab)
    dirich = np.array(slab["static"].dirichlet)
    n = dirich.size
    fix_b = dirich | (np.arange(n) % 7 == 3)
    rb = 1.7e3
    extra = -np.asarray(slab["mesh"].node_area) / 3.0 / 3e5 * np.exp(u[:, 1])

    jres = _jres(slab, jfr)
    # the constrained rows of a polish's right-hand side are zero
    R = np.asarray(jax.jit(jres)(u)) * ~np.stack([dirich, fix_b], -1)
    jA = jax.jit(lambda v: jm._colored_jacobian(
        jres, v, jm._coloring_plan(slab["mesh"]), jnp.float64))(u)
    tA = tm._colored_jacobian(_tres(slab, tfr), tu,
                              tm._coloring_plan(slab["tmesh"]), torch.float64)
    jmask = jm._Masks(dirichlet=jnp.asarray(dirich),
                      active=slab["mesh"].node_area > 0)
    tmask = tm._Masks(dirichlet=torch.as_tensor(dirich),
                      active=slab["tmesh"].node_area > 0)
    jdu, _ = jax.jit(jm._dense_solve_A, static_argnums=5)(
        jA, jmask, jnp.asarray(fix_b), jnp.asarray(rb),
        jnp.asarray(R), jnp.float64, jnp.asarray(extra))
    tdu, info = tm._dense_solve_A(tA, tmask, torch.as_tensor(fix_b),
                                  torch.as_tensor(rb), torch.as_tensor(R),
                                  torch.float64,
                                  extra_diag_b=torch.as_tensor(extra))
    assert info["iters"] == 1
    for f in range(2):
        _close(tdu[:, f], jdu[:, f], 1e-9)
    assert torch.all(tdu[torch.as_tensor(dirich), 0] == 0)
    assert torch.all(tdu[torch.as_tensor(fix_b), 1] == 0)


def test_polish_bicgstab_matches_jax(slab):
    """The large-mesh branch, forced: element blocks, block-Jacobi BiCGStab,
    the same Armijo ladder; three Newton iterations from the PTC state.
    BiCGStab's iteration count on this system moves with the summation
    order of its dots (the same operator and right-hand side: 86 iterations
    in JAX, 70 here), so the Krylov totals agree to 25 %; the iterates to
    the Krylov tolerance."""
    kw = dict(tol=1e-6, linear="bicgstab", max_newton=3)
    js, ji = jm.polish(slab["mesh"], slab["static"], slab["md"].params,
                       slab["st"], **kw)
    ts, ti = tm.polish(slab["tmesh"], slab["tstatic"], P, slab["tst"], **kw)
    assert ti["newton"] == int(ji["newton"]) == 3
    assert 0.8 < ti["krylov_total"] / int(ji["krylov_total"]) < 1.25
    assert int(ti["backtracks"]) == int(ji["backtracks"])
    for k in ("N", "b"):
        _close(getattr(ts, k), getattr(js, k), 1e-8)
    assert float(ti["rate_b"]) == pytest.approx(float(ji["rate_b"]), rel=1e-6)


def test_steady_polish_matches_jax(slab):
    ji, ti = slab["ji"], slab["ti"]
    for k in ("newton", "krylov_total", "refreshes"):
        assert ti[k] == ji[k], k
    for k in ("n_fixed", "converged", "steps_done", "backtracks", "stalled"):
        assert ti[k] == np.asarray(ji[k]), k
    assert bool(ti["converged"]) and int(ti["n_fixed"]) > 0
    assert float(ti["rate_b"]) < 1e-6 and float(ti["resN_rel"]) < 1e-7
    assert float(ti["rate_b"]) < 1e-3 * slab["ptc"]["info"]["rate"]
    for k in ("rate_b", "resN_rel"):
        assert float(ti[k]) == pytest.approx(float(ji[k]), rel=1e-3), k
    for k in ("N", "b", "q", "melt"):
        _close(getattr(slab["ts"], k), getattr(slab["js"], k), 1e-8)
    b = slab["ts"].b.numpy()
    at_floor = np.sum(b <= float(slab["tstatic"].b_min) * (1 + 1e-9))
    assert at_floor + int(slab["tstatic"].dirichlet.sum()) >= int(
        ti["n_fixed"])


def test_pure_newton_mode_matches(slab):
    """dtau_seed=None (no pseudo-transient fallback): the same answer to
    rtol 1e-6, and JAX's count."""
    ts2, ti2 = tm.steady_polish(slab["tmesh"], slab["tstatic"], P,
                                slab["tst"], tol=1e-6, dtau_seed=None)
    _, ji2 = jm.steady_polish(slab["mesh"], slab["static"], slab["md"].params,
                              slab["st"], tol=1e-6, dtau_seed=None)
    assert bool(ti2["converged"]) and ti2["newton"] == ji2["newton"]
    np.testing.assert_allclose(ts2.N.numpy(), slab["ts"].N.numpy(), rtol=1e-6)


def test_polished_state_does_not_move_under_transient(slab):
    """The port's own transient step from the polished state: 10 hourly
    steps move the free gap by less than 1e-3 of a year's worth
    (tests/test_monolithic.py's oracle)."""
    mesh, static, cfg = slab["tmesh"], slab["tstatic"], slab["tcfg"]
    step = make_step_fn(mesh, static, P, cfg)
    s = slab["ts"]
    s = dataclasses.replace(s, lag_op=zero_lag(mesh, torch.float64, cfg)
                            if cfg.lag_operator else None)
    b0 = s.b.clone()
    free = (~static.dirichlet) & (b0 > float(static.b_min) * (1 + 1e-9))
    for _ in range(10):
        s, d = step(s, torch.as_tensor(3600.0, dtype=torch.float64))
        assert bool(d["converged"])
    relb = float(torch.linalg.vector_norm((s.b - b0) * free)
                 / torch.linalg.vector_norm(b0 * free))
    assert relb < 1e-3 * 10 * 3600.0 / YEAR + 1e-9


def _budget_exit(pkg, d, path):
    """Two one-iteration segments, then a Newton-budget exit: the file stays."""
    if pkg == "jax":
        jm.steady_polish(d["mesh"], d["static"], d["md"].params, d["st"],
                         tol=1e-6, max_newton=1, max_newton_total=2,
                         checkpoint=path)
    else:
        tm.steady_polish(d["tmesh"], d["tstatic"], P, d["tst"], tol=1e-6,
                         max_newton=1, max_newton_total=2, checkpoint=path)
    assert os.path.exists(path)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_polish_npz_resumes_across_packages(slab, tmp_path, writer):
    """A Newton-budget exit of ``writer`` resumed by both packages with a
    fresh budget: the port's continuation is the JAX package's, the file
    has the JAX package's keys, and a conclusive return removes it."""
    path = str(tmp_path / "polish.npz")
    _budget_exit(writer, slab, path)
    with np.load(path) as z:
        keys = set(z.files)
        assert int(z["newton"]) == 2 and int(z["seg"]) == 2
        assert z["traj_b"].shape == (2, slab["tst"].N.shape[0])
    assert {k for k in keys if not k.startswith("info_")} == CK_KEYS
    assert {"info_converged", "info_rate_b", "info_dtau"} <= keys
    jpath = str(tmp_path / "jax_copy.npz")
    shutil.copy(path, jpath)
    kw = dict(tol=1e-6, max_newton=1, max_newton_total=40)
    js, ji = jm.steady_polish(slab["mesh"], slab["static"], slab["md"].params,
                              slab["st"], checkpoint=jpath, **kw)
    ts, ti = tm.steady_polish(slab["tmesh"], slab["tstatic"], P, slab["tst"],
                              checkpoint=path, **kw)
    assert bool(ti["converged"]) and bool(ji["converged"])
    for k in ("newton", "refreshes"):
        assert ti[k] == ji[k] and ti[k] > 2, k
    for k in ("N", "b"):
        _close(getattr(ts, k), getattr(js, k), 1e-8)
    assert not os.path.exists(path) and not os.path.exists(jpath)


def test_unconverged_march_stationarity_matches_jax(slab, tmp_path):
    """An unreachable tol: six one-iteration segments of the damped march
    (dtau0 1e4 s), then the budget exit keeps the file; the wander rate,
    amplitudes, pseudo-time and the time-mean state against JAX's."""
    kw = dict(tol=1e-30, n_tol=1e-30, max_newton=1, max_newton_total=6,
              patience=100, dtau0=1e4)
    path = str(tmp_path / "polish.npz")
    _, ji = jm.steady_polish(slab["mesh"], slab["static"], slab["md"].params,
                             slab["st"], **kw)
    ts, ti = tm.steady_polish(slab["tmesh"], slab["tstatic"], P, slab["tst"],
                              checkpoint=path, **kw)
    assert not bool(ti["converged"]) and ti["refreshes"] == 6
    assert os.path.exists(path)
    for k in ("wander_rate", "wander_amp_b", "wander_amp_N", "t_march"):
        assert ti[k] == pytest.approx(float(ji[k]), rel=1e-6), k
    assert ti["t_march"] > 0
    for k in ("N", "b", "q", "melt"):
        _close(getattr(ti["mean_state"], k), getattr(ji["mean_state"], k),
               1e-8)
