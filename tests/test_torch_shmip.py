"""The port's SHMIP setups (shakti_tpu_torch/setups/setup_shmip.py) against
setups/setup_shmip.py, in float64 on the CPU:

- every case of suites A-F builds the same arrays and settings, exactly
  (the valley suites E/F through the port's polygon_mesh), the suites'
  constants are equal, and an unknown case raises the same error;
- a few transient steps of A1, C3 (diurnal moulins) and D3 (degree-day
  runoff) on a 20x4 mesh match the JAX package's to 1e-8 of scale;
- solve_steady(polish=True) of A1 on that mesh (ELL in both packages): the
  same verdict, PTC steps and polish Newton count, N and b within 1e-8 of
  scale, JAX's info keys and mass budget; a polish killed after its first
  segment and resumed from its checkpoint directory ends bit for bit where
  the uninterrupted one does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import setups.setup_shmip as jsh
from shakti_tpu.solve import timestep as jts
from shakti_tpu_torch.api import steady as tapi
from shakti_tpu_torch.setups import setup_shmip as tsh
from shakti_tpu_torch.solve import monolithic as tmono
from shakti_tpu_torch.solve import timestep as tts
from tests.torch_parity import rel_err

CASES = sorted(set(jsh.CASES_A) | set(jsh.CASES_B) | set(jsh.CASES_C)
               | set(jsh.CASES_D) | set(jsh.CASES_E) | set(jsh.CASES_F))
ARRAYS = ("nodes", "cells", "x", "y", "z_b", "z_s", "G", "inputs", "b_init",
          "N_init", "q_init", "melt_init", "lake_bdry", "timesteps")
SETTINGS = ("setup_name", "results_name", "N_bdry", "b_min", "nt_save",
            "nt_check", "storage_on", "outflow_on", "seasonal_inputs",
            "degree_day", "bounds")
NARROW = dict(nx=20, ny=4, days=30, nt_per_day=24)
STEADY = dict(tol=1e-3, max_steps=60, strict=False, polish=True,
              polish_max_newton=6000, polish_patience=3,
              polish_max_wall_s=600)


def test_suite_constants_match_jax():
    for k in ("CASES_A", "CASES_B", "CASES_C", "CASES_D", "CASES_E",
              "CASES_F", "B_TOTAL_M3S", "DAY_S", "E_INPUT", "VALLEY_LEN",
              "PARA_BENCH", "VALLEY_B_CAP"):
        assert getattr(tsh, k) == getattr(jsh, k), k
    x = np.linspace(0.0, 100e3, 57)
    np.testing.assert_array_equal(tsh.surface(x), jsh.surface(x))
    np.testing.assert_array_equal(tsh.valley_outline(), jsh.valley_outline())
    np.testing.assert_array_equal(tsh.moulin_positions(20, 100e3, 20e3),
                                  jsh.moulin_positions(20, 100e3, 20e3))


@pytest.mark.parametrize("case", CASES)
def test_setup_matches_jax(case):
    kw = dict(nx=20, ny=4, days=2.0, nt_per_day=4, results_name="shmip_run",
              seed=3)
    j, t = jsh.initialize(case, **kw), tsh.initialize(case, **kw)
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)
    for k in SETTINGS:
        assert getattr(t, k) == getattr(j, k), k
    assert (t.b_cap is None) == (j.b_cap is None)
    if j.b_cap is not None:
        np.testing.assert_array_equal(t.b_cap, j.b_cap)
    np.testing.assert_array_equal(t.OutflowBoundary(t.nodes),
                                  j.OutflowBoundary(j.nodes))
    np.testing.assert_array_equal(t.dirichlet_nodes(), j.dirichlet_nodes())
    assert t.dirichlet_nodes().size > 0
    assert os.path.basename(t.setup_file) == "setup_shmip.py"


def test_unknown_case_raises_like_jax():
    with pytest.raises(ValueError) as jerr:
        jsh.initialize("Z9")
    with pytest.raises(ValueError, match="unknown SHMIP case") as terr:
        tsh.initialize("Z9")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["A1", "C3", "D3"])
def test_transient_steps_match_jax(case):
    """Seven steps (the first-step dt quirk included) with the case's own
    forcing: inputs scale (C) or degree-day melt (D)."""
    j, t = jsh.initialize(case, **NARROW), tsh.initialize(case, **NARROW)
    j.operator = t.operator = "ell"
    t.device, t.dtype = "cpu", torch.float64
    mesh, static, state, cfg = j.freeze()
    step = jts.make_step_fn(mesh, static, j.params, cfg)
    times = j.timesteps[:7]
    jf = jts.make_forcing(times, dtype=jnp.float64, seasonal=j.seasonal_inputs,
                          degree_day=j.degree_day)
    js, jd = jax.jit(lambda s, f: jts.run_window(step, s, f))(state, jf)
    tmesh, tstatic, tstate, tcfg = t.freeze()
    tstep = tts.make_step_fn(tmesh, tstatic, t.params, tcfg)
    tf = tts.make_forcing(times, dtype=torch.float64,
                          seasonal=t.seasonal_inputs, degree_day=t.degree_day)
    assert set(tf) == set(jf)
    ts, td = tts.run_window(tstep, tstate, tf)
    assert td["converged"].all() and np.asarray(jd["converged"]).all()
    np.testing.assert_array_equal(td["newton_iters"],
                                  np.asarray(jd["newton_iters"]))
    for k in ("N", "b", "q", "melt"):
        err = rel_err(getattr(ts, k).numpy(), np.asarray(getattr(js, k)))
        assert err <= 1e-8, (k, err)


@pytest.fixture(scope="module")
def a1_steady():
    j = jsh.initialize("A1", **NARROW)
    t = tsh.initialize("A1", **NARROW)
    j.operator = t.operator = "ell"
    t.device, t.dtype = "cpu", torch.float64
    return j.solve_steady(**STEADY), t.solve_steady(**STEADY)


def test_solve_steady_polish_matches_jax(a1_steady):
    jo, to = a1_steady
    ji, ti = jo["info"], to["info"]
    assert set(ti) == set(ji)
    for k in ("verdict", "steps", "accepted", "rejected", "newton_total",
              "polish_newton", "polish_converged", "converged"):
        assert ti[k] == ji[k], k
    assert ti["verdict"] == "polished" and ti["rate"] < STEADY["tol"]
    assert ti["rate"] == ti["polish_rate_b"]
    for k in ("polish_rate_b", "polish_resN"):
        assert ti[k] == pytest.approx(ji[k], rel=1e-3), k
    for k in ("N", "b", "qx", "qy"):
        assert rel_err(to[k], jo[k]) <= 1e-8, k
    for k in ("Q_out", "Q_src"):
        assert to[k] == pytest.approx(jo[k], rel=1e-9), k
    assert to["Q_out"] == pytest.approx(to["Q_src"], rel=1e-6)


def test_polish_killed_and_resumed_is_bit_exact(a1_steady, tmp_path,
                                                monkeypatch):
    """The checkpointed solve killed right after the polish's first segment
    (ptc.npz and polish.npz on disk), then resumed with the same directory:
    N, b and the counts equal the uninterrupted run's; both files go."""
    ck = str(tmp_path / "ck")
    real = tmono.polish
    calls = []

    def killed(*a, **kw):
        if calls:
            raise KeyboardInterrupt("killed after the first segment")
        calls.append(1)
        return real(*a, **kw)

    def md():
        t = tsh.initialize("A1", **NARROW)
        t.operator, t.device, t.dtype = "ell", "cpu", torch.float64
        return t

    monkeypatch.setattr(tmono, "polish", killed)
    with pytest.raises(KeyboardInterrupt):
        md().solve_steady(**STEADY, checkpoint=ck)
    assert sorted(os.listdir(ck)) == [tapi.POLISH_FILE, tapi.PTC_FILE]
    monkeypatch.setattr(tmono, "polish", real)
    out = md().solve_steady(**STEADY, checkpoint=ck)
    ref = a1_steady[1]
    for k in ("N", "b", "qx", "qy"):
        np.testing.assert_array_equal(out[k], ref[k])
    for k in ("steps", "polish_newton", "verdict"):
        assert out["info"][k] == ref["info"][k], k
    assert os.listdir(ck) == []
