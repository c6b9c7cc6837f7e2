"""shakti_tpu_torch.solve.timestep and the run layer's pieces vs shakti_tpu:
forcing, the semi-implicit and forced step variants, the dt-halving retry
logic and the save windows (float64)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.api.run import _save_windows as j_windows
from shakti_tpu.solve import timestep as jts
from shakti_tpu_torch.api.run import ConvergenceError
from shakti_tpu_torch.api.run import _save_windows as t_windows
from shakti_tpu_torch.convert import problem_from_numpy
from shakti_tpu_torch.solve import timestep as tts
from tests.golden_cases import lake_case
from tests.torch_parity import frozen_to_numpy, rel_err

SEASONAL = (0.8, 86400.0 * 3, 0.3)
DEGREE_DAY = dict(dT=4.0, t_mean=2.0, period=86400.0 * 5)


def test_make_forcing_matches_jax():
    t = np.linspace(0.0, 86400.0 * 4, 17)
    ref = jts.make_forcing(t, dtype=jnp.float64, seasonal=SEASONAL,
                           degree_day=DEGREE_DAY)
    got = tts.make_forcing(t, dtype=torch.float64, seasonal=SEASONAL,
                           degree_day=DEGREE_DAY)
    assert set(got) == set(ref) == {"dt", "inputs_scale", "melt_a", "melt_b"}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-14, atol=1e-300, err_msg=k)
    assert got["dt"][0].item() == pytest.approx(0.1 * (t[1] - t[0]))


@pytest.mark.parametrize("variant", ["semi_implicit", "forced"])
def test_step_variants_match_jax(variant):
    """One lake step (block-ELL on both sides) with the semi-implicit gap
    update, or with seasonal + degree-day forcing."""
    md, _, _ = lake_case()
    md.operator = "bell"
    md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0)
    mesh, static, state, cfg = md.freeze()
    b_update = "semi_implicit" if variant == "semi_implicit" else "explicit"
    if variant == "forced":
        jf = jts.make_forcing(md.timesteps, dtype=jnp.float64,
                              seasonal=SEASONAL, degree_day=DEGREE_DAY)
        jf1 = {k: v[1] for k, v in jf.items()}
    else:
        jf1 = jts.timestep_sizes(md.timesteps, dtype=jnp.float64)[1]
    jstep = jax.jit(jts.make_step_fn(mesh, static, md.params, cfg, b_update))
    js, jd = jstep(state, jf1)
    tm, tsf, tstate, tcfg = problem_from_numpy(
        *frozen_to_numpy(mesh, static, state, cfg))
    if variant == "forced":
        tf = tts.make_forcing(md.timesteps, dtype=torch.float64,
                              seasonal=SEASONAL, degree_day=DEGREE_DAY)
        tf1 = {k: v[1] for k, v in tf.items()}
    else:
        tf1 = tts.timestep_sizes(md.timesteps, torch.float64)[1]
    ts, td = tts.make_step_fn(tm, tsf, md.params, tcfg, b_update)(tstate, tf1)
    assert td["converged"] and bool(jd["converged"])
    assert td["newton_iters"] == int(jd["newton_iters"])
    for k in ("N", "b", "q", "melt"):
        assert rel_err(getattr(ts, k).numpy(), np.asarray(getattr(js, k))) <= 1e-9, k


def _fake_base(xp, full_ok, first_ok, second_ok, deep):
    """A step stand-in whose outcome depends only on (state, dt): the full
    step (dt 1) and the two half steps (from state 0 and state 0.5)."""
    def base(state, forcing):
        dt = forcing["dt"]
        x = state.N if xp is torch else state
        ok = xp.where(xp.asarray(dt > 0.75), full_ok,
                      xp.where(xp.asarray(x < 0.25), first_ok, second_ok))
        rnorm = xp.where(xp.asarray(x < 0.25), 0.5,
                         1e-6 if deep else 1e-2)
        diag = {"newton_iters": 2, "rnorm": rnorm, "rnorm0": 1.0 + x,
                "converged": ok, "cg_iters": 7}
        if xp is torch:
            diag = {k: (v.item() if torch.is_tensor(v) else v)
                    for k, v in diag.items()}
            return types.SimpleNamespace(N=state.N + dt), diag
        return state + dt, diag
    return base


@pytest.mark.parametrize("case", [
    (True, False, False, False),     # first try converges: no retry
    (False, True, True, False),      # both half steps converge
    (False, False, True, True),      # second half converges deep below
    (False, False, True, False),     # ... or not deep enough: failure
])
def test_dt_halving_matches_jax(case):
    jstate, jdiag = jts.with_dt_halving(_fake_base(jnp, *case))(
        jnp.asarray(0.0), {"dt": jnp.asarray(1.0)})
    tstate, tdiag = tts.with_dt_halving(_fake_base(torch, *case))(
        types.SimpleNamespace(N=torch.tensor(0.0, dtype=torch.float64)),
        {"dt": torch.tensor(1.0, dtype=torch.float64)})
    assert tstate.N.item() == float(jstate)
    for k in jdiag:
        assert tdiag[k] == pytest.approx(float(jdiag[k])), k


@pytest.mark.parametrize("nt,nt_save,start", [(48, 24, 0), (20, 4, 0),
                                              (13, 5, 0), (13, 5, 7),
                                              (7, 1, 0), (5, 10, 0)])
def test_save_windows_match_jax(nt, nt_save, start):
    assert list(t_windows(nt, nt_save, start)) == list(j_windows(nt, nt_save, start))


def test_nonconverged_step_raises(tmp_path):
    from shakti_tpu_torch.setups import setup_slab
    md = setup_slab.initialize(nx=6, ny=6, days=1.0, nt_per_day=4,
                               results_name=str(tmp_path / "r"))
    md.device, md.dtype = "cpu", torch.float64
    md.solver = dataclasses.replace(md.solver, max_iter=1, stall_rtol=1e-30,
                                    adaptive_dt_levels=0)
    with pytest.raises(ConvergenceError, match="time step 0"):
        md.solve(progress=False)
    assert (tmp_path / "r" / "N.npy").exists()
