"""The port's steady-state path (shakti_tpu_torch/solve/steady.py,
api/steady.py, solve/diagnostics.py and the CLI's --steady) against
shakti_tpu's, in float64 on the CPU:

- solve_steady on the 12x12 slab (ELL in both packages): the same PTC
  steps, accepted/rejected counts and verdict, N and b within 1e-8 of
  scale, Q_out/Q_src at 1e-9 relative;
- cycle_certify from that state against JAX's;
- a segmented march killed after its first segments and resumed ends bit
  for bit where the uninterrupted march ends, and a checkpoint of another
  mesh is refused;
- an exhausted budget raises ConvergenceError carrying the state, with
  the polish too when it reaches no fixed point; polish=True takes JAX's
  polish keywords and returns JAX's info keys and verdict;
- the CLI's --steady (and --steady --polish) writes steady.npz and
  steady_info.json with JAX's keys;
- the three diagnostics against JAX's on the lake golden case.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import setups.setup_slab as jslab
from shakti_tpu.api.run import ConvergenceError as JConvergenceError
from shakti_tpu.solve import diagnostics as jdiag
from shakti_tpu.solve import steady as jsteady
from shakti_tpu.solve.timestep import make_step_fn as jstep_fn
from shakti_tpu.solve.timestep import timestep_sizes as jdts
from shakti_tpu_torch.api import steady as tapi
from shakti_tpu_torch.api.run import ConvergenceError
from shakti_tpu_torch.convert import problem_from_numpy
from shakti_tpu_torch.setups import setup_slab as tslab
from shakti_tpu_torch.solve import diagnostics as tdiag
from shakti_tpu_torch.solve import steady as tsteady
from tests.golden_cases import lake_case
from tests.torch_parity import frozen_to_numpy, rel_err

TOL = 2e-2          # drift per year accepted as steady (tests/test_steady.py)


def _jmd(nx=12):
    md = jslab.initialize(nx=nx, ny=nx)
    md.operator = "ell"
    return md


def _tmd(nx=12):
    md = tslab.initialize(nx=nx, ny=nx)
    md.device, md.dtype, md.operator = "cpu", torch.float64, "ell"
    return md


@pytest.fixture(scope="module")
def steady12():
    jmd, tmd = _jmd(), _tmd()
    return dict(jmd=jmd, jout=jmd.solve_steady(tol=TOL, max_steps=1600),
                tmd=tmd, tout=tmd.solve_steady(tol=TOL, max_steps=1600))


def test_solve_steady_matches_jax(steady12):
    ji, ti = steady12["jout"]["info"], steady12["tout"]["info"]
    assert set(ti) == set(ji)
    for k in ("steps", "accepted", "rejected", "verdict", "converged",
              "newton_total"):
        assert ti[k] == ji[k], k
    assert ti["verdict"] == "steady" and ti["rate"] < TOL
    assert ti["rate_b_bdry"] > ti["rate"]
    for k in ("rate", "rate_N", "rate_b", "rate_b_bdry", "kappa", "dt",
              "t_pseudo"):
        assert ti[k] == pytest.approx(ji[k], rel=1e-8), k
    for k in ("N", "b", "qx", "qy"):
        assert rel_err(steady12["tout"][k], steady12["jout"][k]) <= 1e-8, k
    for k in ("Q_out", "Q_src"):
        assert steady12["tout"][k] == pytest.approx(steady12["jout"][k],
                                                    rel=1e-9), k
    assert steady12["tout"]["Q_out"] == pytest.approx(
        steady12["tout"]["Q_src"], rel=2e-2)


def test_cycle_certify_matches_jax(steady12):
    """From the certified state, a degenerate (fixed-point) cycle: both
    packages certify with the same counts and rates."""
    jmd, tmd = steady12["jmd"], steady12["tmd"]
    mesh, static, _, cfg = jmd.freeze()
    step, _ = jsteady.make_steady_step(mesh, static, jmd.params, cfg)
    dt = min(steady12["jout"]["info"]["dt"], 1e6)
    jmean, jinfo = jax.jit(lambda s: jsteady.cycle_certify(
        step, s, params=jmd.params, dt=dt, tol=TOL, window=10,
        drift_mask=~static.dirichlet))(
            dataclasses.replace(steady12["jout"]["state"], lag_op=None))
    tmesh, tstatic, _, tcfg = tmd.freeze()
    tstep, _ = tsteady.make_steady_step(tmesh, tstatic, tmd.params, tcfg)
    tmean, tinfo = tsteady.cycle_certify(
        tstep, dataclasses.replace(steady12["tout"]["state"], lag_op=None),
        params=tmd.params, dt=dt, tol=TOL, window=10,
        drift_mask=~tstatic.dirichlet)
    assert bool(tinfo["certified"]) and bool(jinfo["certified"])
    for k in ("steps", "accepted", "rejected", "newton_total"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    for k in ("cycle_rate", "amp_N", "amp_b"):
        assert float(tinfo[k]) == pytest.approx(float(jinfo[k]), rel=1e-6,
                                                abs=1e-12), k
    assert float(tinfo["t_window"]) == pytest.approx(float(jinfo["t_window"]),
                                                     rel=1e-12)
    for k in ("N", "b"):
        assert rel_err(getattr(tmean, k).numpy(),
                       np.asarray(getattr(jmean, k))) <= 1e-8, k


def test_checkpoint_kill_and_resume_is_bit_exact(tmp_path, monkeypatch):
    """A march killed after two segments (its budget exhausted) and resumed
    from ptc.npz ends bit for bit where the uninterrupted march ends, having
    marched only the remaining attempts; another mesh's file is refused."""
    kw = dict(tol=TOL, max_steps=48, strict=False)
    ref = _tmd().solve_steady(**kw)
    ck = str(tmp_path / "ck")
    out1 = _tmd().solve_steady(**dict(kw, max_steps=16), checkpoint=ck,
                               segment_steps=8)
    assert out1["info"]["verdict"] == "no" and out1["info"]["steps"] == 16
    with np.load(os.path.join(ck, tapi.PTC_FILE)) as z:
        assert int(z["k"]) == 16 and z["state.N"].dtype == np.float64
        assert z["k"].dtype == np.int32 and z["done"].dtype == np.bool_

    calls = []
    real = tapi.make_steady_step

    def counted(*a):
        step, cfg = real(*a)
        return (lambda s, dt: (calls.append(1), step(s, dt))[1]), cfg

    monkeypatch.setattr(tapi, "make_steady_step", counted)
    out2 = _tmd().solve_steady(**kw, checkpoint=ck, segment_steps=16)
    assert len(calls) == 32
    for k in ("steps", "accepted", "rejected", "newton_total", "cg_total"):
        assert out2["info"][k] == ref["info"][k], k
    for k in ("N", "b", "qx", "qy"):
        np.testing.assert_array_equal(out2[k], ref[k])
    assert os.path.exists(os.path.join(ck, tapi.PTC_FILE))  # verdict "no"

    # a conclusive verdict removes the file; another mesh's file is refused
    out3 = _tmd(8).solve_steady(tol=1e3, max_steps=8, checkpoint=ck + "8")
    assert out3["info"]["verdict"] == "steady"
    assert not os.path.exists(os.path.join(ck + "8", tapi.PTC_FILE))
    with pytest.raises(ValueError, match="fingerprint"):
        _tmd(8).solve_steady(**kw, checkpoint=ck)


def test_exhausted_budget_raises_with_state():
    md = _tmd()
    with pytest.raises(ConvergenceError) as ei:
        md.solve_steady(tol=1e-8, max_steps=3)
    err = ei.value
    assert err.info["steps"] == 3 and not err.info["converged"]
    assert err.info["verdict"] == "no"
    assert torch.isfinite(err.state.N).all()
    jmd = _jmd()
    with pytest.raises(JConvergenceError) as ej:
        jmd.solve_steady(tol=1e-8, max_steps=3)
    assert ej.value.info["steps"] == 3
    assert rel_err(err.state.N.numpy(), np.asarray(ej.value.state.N)) <= 1e-8


def test_polish_raises(monkeypatch):
    """A polish stopped by its Newton budget short of a fixed point, after a
    march that certified nothing, leaves the verdict "no": solve_steady then
    raises ConvergenceError carrying the state and the polish's info keys
    (the polish runs before the strict raise, as in JAX).  Its segments are
    cut to one Newton iteration, so that the budget of one ends it."""
    real = tapi.steady_polish
    monkeypatch.setattr(tapi, "steady_polish",
                        lambda *a, **k: real(*a, **dict(k, max_newton=1)))
    with pytest.raises(ConvergenceError) as e:
        _tmd(6).solve_steady(tol=1e-8, max_steps=3, polish=True,
                             polish_max_newton=1)
    info = e.value.info
    assert info["verdict"] == "no" and not info["converged"]
    assert info["steps"] == 3
    assert info["polish_newton"] == 1 and not info["polish_converged"]
    assert "wander_rate" not in info
    assert torch.isfinite(e.value.state.N).all()


def test_polish_matches_jax():
    """JAX's polish keywords are accepted, and the march (certified at tol
    0.1) followed by the polish gives JAX's verdict, info keys, counts and
    state on the 8x8 slab.  (From a march capped far from steady the polish
    runs a long backtracking march, along which roundoff grows by orders of
    magnitude per ten iterations: no parity case.)"""
    kw = dict(tol=0.1, max_steps=1600, polish=True, polish_max_newton=500,
              polish_patience=2, polish_max_wall_s=600.0)
    tout, jout = _tmd(8).solve_steady(**kw), _jmd(8).solve_steady(**kw)
    ti, ji = tout["info"], jout["info"]
    assert set(ti) == set(ji)
    assert {"polish_rate_b", "polish_resN", "polish_newton",
            "polish_converged"} <= set(ti)
    assert ti["verdict"] == ji["verdict"] == "polished"
    for k in ("steps", "polish_newton", "polish_converged", "newton_total"):
        assert ti[k] == ji[k], k
    assert ti["rate"] == ti["polish_rate_b"] < kw["tol"]
    for k in ("N", "b"):
        assert rel_err(tout[k], jout[k]) <= 1e-8, k


def _wrapper(path, pkg, rdir):
    if pkg == "torch":
        head = ("import torch\n\nfrom shakti_tpu_torch.setups import "
                "setup_slab as slab\n")
        tail = "    md.dtype, md.operator = torch.float64, 'ell'\n"
    else:
        head, tail = "import setups.setup_slab as slab\n", \
            "    md.operator = 'ell'\n"
    path.write_text(
        f"{head}\n\ndef initialize():\n"
        f"    md = slab.initialize(nx=8, ny=8, results_name={str(rdir)!r})\n"
        f"{tail}    return md\n")
    return str(path)


def test_cli_steady_writes_the_jax_files(tmp_path, capsys):
    from shakti_tpu.cli import main as jmain
    from shakti_tpu_torch.cli import main as tmain
    jdir, tdir = tmp_path / "jax_run", tmp_path / "torch_run"
    args = ["--steady", "--steady-tol", "0.1", "--quiet"]
    assert jmain([_wrapper(tmp_path / "wj.py", "jax", jdir), *args]) == 0
    jtext = capsys.readouterr().out
    assert tmain([_wrapper(tmp_path / "wt.py", "torch", tdir), "--device",
                  "cpu", *args]) == 0
    ttext = capsys.readouterr().out
    jd, td = f"{jdir}_steady", f"{tdir}_steady"
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd)) == [
        "steady.npz", "steady_info.json"]
    jz, tz = np.load(os.path.join(jd, "steady.npz")), \
        np.load(os.path.join(td, "steady.npz"))
    assert sorted(tz.files) == sorted(jz.files)
    for k in jz.files:
        assert rel_err(tz[k], jz[k]) <= 1e-8, k
    ji = json.load(open(os.path.join(jd, "steady_info.json")))
    ti = json.load(open(os.path.join(td, "steady_info.json")))
    assert set(ti) == set(ji) and ti["steps"] == ji["steps"]
    # the same summary lines (the wall time aside)
    strip = [ln.split(", wall")[0] for ln in ttext.splitlines()[:3]]
    assert strip == [ln.split(", wall")[0] for ln in jtext.splitlines()[:3]]
    # --polish: the polished verdict, JAX's files and keys
    jp, tp = tmp_path / "jax_polish", tmp_path / "torch_polish"
    args = [*args, "--polish"]
    assert jmain([_wrapper(tmp_path / "wjp.py", "jax", jp), *args]) == 0
    assert tmain([_wrapper(tmp_path / "wtp.py", "torch", tp), "--device",
                  "cpu", *args]) == 0
    capsys.readouterr()
    ji = json.load(open(os.path.join(f"{jp}_steady", "steady_info.json")))
    ti = json.load(open(os.path.join(f"{tp}_steady", "steady_info.json")))
    assert set(ti) == set(ji) and ti["verdict"] == ji["verdict"] == "polished"
    assert ti["polish_newton"] == ji["polish_newton"]
    jz, tz = np.load(os.path.join(f"{jp}_steady", "steady.npz")), \
        np.load(os.path.join(f"{tp}_steady", "steady.npz"))
    assert sorted(tz.files) == sorted(jz.files) == ["N", "b", "qx", "qy"]
    for k in jz.files:
        assert rel_err(tz[k], jz[k]) <= 1e-8, k


def test_diagnostics_match_jax():
    """boundary_discharge, water_production and certified_budget on the
    lake golden case after 4 JAX steps, from the same state."""
    md, _, _ = lake_case()
    md.operator = "ell"
    mesh, static, state, cfg = md.freeze()
    step = jax.jit(jstep_fn(mesh, static, md.params, cfg))
    for dt in np.asarray(jdts(md.timesteps, dtype=md.dtype))[:4]:
        state, _ = step(state, dt)
    tm, ts, tst, tcfg = problem_from_numpy(
        *frozen_to_numpy(mesh, static, state, cfg))
    p = md.params
    assert tdiag.boundary_discharge(tm, ts, tst, p) == pytest.approx(
        jdiag.boundary_discharge(mesh, static, state, p), rel=1e-12)
    assert tdiag.water_production(tm, ts, tst, p) == pytest.approx(
        jdiag.water_production(mesh, static, state, p), rel=1e-12)
    jq = jdiag.certified_budget(mesh, static, state, p, cfg)
    tq = tdiag.certified_budget(tm, ts, tst, p, tcfg)
    assert tq[2]["converged"] and jq[2]["converged"]
    assert tq[2]["iters"] == jq[2]["iters"]
    assert tq[0] == pytest.approx(jq[0], rel=1e-9)
    assert tq[1] == pytest.approx(jq[1], rel=1e-9)
