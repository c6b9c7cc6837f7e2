"""Suite S for A2-A6, the artesian study X and the oracle legs O, OT and OV
of scripts/torch_shmip_validate.py (with scripts/torch_valley_stationarity.py)
against the JAX package's scripts/shmip_validate.py (and
valley_stationarity.py), in float64 on the CPU, at cuts:

- S for A2 and A6 on 20 x 4, both packages in block-ELL, solve_steady
  capped at 3 PTC steps and a polish of 2 Newton iterations (one segment,
  so the stationarity verdict never divides by zero): equal verdict, PTC,
  Newton and polish counts, relN_win and the other values within 1e-8;
- a suite S case killed in its march and again in its polish, then
  resumed from its checkpoint directory: its row bitwise the unbroken
  one's;
- X: the port's per-window rows (artesian_probe, artesian_summary) on the
  JAX run's own window states within 1e-10 of suite_artesian's, on D5 at
  12 x 4 with the JAX script's 1-year spin; D5's hooked run leaves its
  samples and its state as the unhooked one, and windows leave the state
  bitwise as one window;
- O_ladder at nx = 24 bitwise; OT, OV and the stationarity leg from the
  same rows with every FV march cut to a few steps (oracle/shmip_fv2d.py
  is shared, unchanged): the oracle fields bitwise, fw_*/rel_* within
  1e-12.

The JAX side of S and X runs once, in a child process beside the port's
runs (tests/torch_examples_ref.py --so-tests); the oracle legs run the
JAX script's functions here (no JAX computation is in them).  Every
_save_cache is replaced: neither package's cache or markdown changes."""

import functools
import math
import os
import sys

import numpy as np
import pytest
import torch

from tests import torch_examples_ref as R
from tests import torch_parity  # noqa: F401  (pins torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
# each cut FV march: this long, at most this many samples
CUT_S, CUT_SAMPLES = 900.0, 3


@pytest.fixture(scope="module")
def t():
    """scripts/torch_shmip_validate.py."""
    saved_path = list(sys.path)
    sys.path.insert(0, SCRIPTS)
    try:
        import torch_shmip_validate
        yield torch_shmip_validate
    finally:
        sys.path[:] = saved_path


@pytest.fixture(scope="module")
def j():
    """scripts/shmip_validate.py, loaded by path."""
    return R.by_path(os.path.join("scripts", "shmip_validate.py"),
                     "jax_shmip_validate")


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """The JAX side of S and X in a child process, started with the file's
    first test; the tests that read it come last."""
    child = R.Child("--so-tests", tmp_path_factory.mktemp("jax_so"))
    yield child
    child.close()


@pytest.fixture
def quiet(t, j, monkeypatch):
    """No cache or markdown written by either package."""
    monkeypatch.setattr(t, "_save_cache", lambda out: None)
    monkeypatch.setattr(j, "_save_cache", lambda out: None)


def _same(a, b, rel=0.0):
    """a and b equal (NaN equal to NaN), floats within ``rel``."""
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    if isinstance(b, float) and rel:
        return abs(a - b) <= rel * max(abs(b), 1e-300)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y, rel)
                                        for x, y in zip(a, b))
    if isinstance(b, dict):
        return set(a) == set(b) and all(_same(a[k], b[k], rel) for k in b)
    return a == b


# ------------------------------------------------------------------ suite S

def _port_s(t, monkeypatch, cap=R.SO_S_CAP, polish_newton=R.SO_POLISH_NEWTON):
    from shakti_tpu_torch.api import steady
    monkeypatch.setattr(t.shmip, "initialize", R.capped_steady(
        t.shmip, R.SO_S_INIT, cap))
    monkeypatch.setattr(steady, "steady_polish", functools.partial(
        steady.steady_polish, max_newton=polish_newton))


class Killed(Exception):
    pass


def test_suite_s_resumes_bitwise(t, quiet, monkeypatch, tmp_path):
    from shakti_tpu_torch.api import steady
    from shakti_tpu_torch.solve import monolithic
    cap = dict(max_steps=6, cycle_window=0, polish_max_newton=6,
               segment_steps=2)
    _port_s(t, monkeypatch, cap=cap)
    rows = {}
    out = {}
    t.suite_S(out, False, force=True, cases=("A2",), device="cpu",
              ck=str(tmp_path / "whole"))
    rows["whole"] = out["S_A2"]
    assert rows["whole"]["polish_newton"] == 6

    def kill_at(mod, name, n):
        real, calls = getattr(mod, name), [0]

        def fn(*a, **k):
            calls[0] += 1
            if calls[0] == n:
                raise Killed(name)
            return real(*a, **k)
        monkeypatch.setattr(mod, name, fn)
        return real, calls
    ck = str(tmp_path / "broken")
    out = {}
    real_save, _ = kill_at(steady, "_save_carry", 2)
    with pytest.raises(Killed):
        t.suite_S(out, False, force=True, cases=("A2",), device="cpu", ck=ck)
    assert t._s_progress(os.path.join(ck, "S_A2")) == [2, 0]
    monkeypatch.setattr(steady, "_save_carry", real_save)
    real_polish, calls = kill_at(monolithic, "polish", 2)
    with pytest.raises(Killed):
        t.suite_S(out, False, force=True, cases=("A2",), device="cpu", ck=ck)
    assert t._s_progress(os.path.join(ck, "S_A2")) == [6, 2]
    monkeypatch.setattr(monolithic, "polish", real_polish)
    t.suite_S(out, False, force=True, cases=("A2",), device="cpu", ck=ck)
    rows["resumed"] = out["S_A2"]
    for k, v in rows["whole"].items():
        if k not in ("wall_s", "segments", "checks"):
            assert _same(rows["resumed"][k], v), k
    assert [g["from"] for g in rows["resumed"]["segments"]] == [[6, 2]]


# ------------------------------------------------------------------------ X

def test_d5_windows_and_probe_leave_the_run_as_it_was(t):
    from shakti_tpu_torch.solve.timestep import make_forcing, run_window
    kw = dict(spin_years=0, nt_per_day=4, sample_days=2, device="cpu",
              days=4, **R.SO_X_INIT)
    rows = []
    md, st, samples, conv, qo, qs = t.run_seasonal_case("D5", artesian=rows,
                                                        **kw)
    _, st0, samples0, conv0, qo0, qs0 = t.run_seasonal_case("D5", **kw)
    assert samples.tolist() == samples0.tolist() and conv == conv0
    assert torch.equal(st.N, st0.N) and torch.equal(st.b, st0.b)
    win = (md.x > t.WINDOW[0]) & (md.x < t.WINDOW[1])
    assert rows[-1] == t.artesian_probe(md, win)(md.to_user_order(st.N), 4)
    assert [r["day"] for r in rows] == [2, 4]
    # one window of 16 steps against windows of 5
    md, mesh, static, state, cfg, step, cp = t._setup(
        "D5", "cpu", None, None, days=4, nt_per_day=4, **R.SO_X_INIT)
    forcing = make_forcing(md.timesteps, dtype=md.dtype,
                           device=static.dirichlet.device,
                           degree_day=md.degree_day)
    whole, _ = run_window(step, state, forcing)
    split = t.march(step, state, forcing, 0, md.timesteps.size, 5, cp,
                    {"conv": True})
    for f in ("N", "b", "q", "melt", "N_prev"):
        assert torch.equal(getattr(whole, f), getattr(split, f)), f


# ------------------------------------------------------------- oracle legs

@pytest.fixture
def cut_fv(monkeypatch):
    """Every FV march cut to CUT_S seconds and at most CUT_SAMPLES samples
    spread over it; the ladder at nx = 24."""
    import oracle.shmip_fv2d as fv2d
    march, ladder = fv2d.march, fv2d.solve_ladder

    def cut_march(case, **kw):
        kw["years"] = CUT_S / 3.1536e7
        if kw.get("sample_times") is not None:
            n = min(len(kw["sample_times"]), CUT_SAMPLES)
            kw["sample_times"] = CUT_S * np.arange(1, n + 1) / n
        return march(case, **kw)
    monkeypatch.setattr(fv2d, "march", cut_march)
    monkeypatch.setattr(fv2d, "solve_ladder",
                        lambda nx=200, **k: ladder(nx=24, **k))


FW = ("fw_", "rel_")


def _oracle_rows_equal(got, ref):
    """The JAX row's keys in the port's, the oracle fields bitwise and the
    fw_*/rel_* fields within 1e-12."""
    for k, v in ref.items():
        if k == "wall_s":
            continue
        assert _same(got[k], v, rel=1e-12 if k.startswith(FW) else 0.0), k


def test_o_ladder_matches_jax(t, j, quiet, cut_fv):
    skip = {f"O_{leg}_{c}": {} for leg in ("stab", "march")
            for c in ("A3", "A5")}
    got, ref = dict(skip), dict(skip)
    t.suite_O(got, True)
    j.suite_O(ref, True)
    assert got["O_ladder"]["rows"] == ref["O_ladder"]["rows"]
    assert got["O_ladder"]["nx"] == ref["O_ladder"]["nx"]


def _fw_rows(cases, keys, seed):
    rng = np.random.default_rng(seed)
    rows = {}
    for c in cases:
        rows[c] = {k: float(v) for k, v in zip(keys, rng.uniform(
            -0.5, 2.0, len(keys)))}
        rows[c]["complete"] = True
    return rows


def test_ot_legs_match_jax(t, j, quiet, cut_fv):
    rows = _fw_rows(("D1", "D3", "D5"), ("N_winter_MPa", "N_summer_min_MPa",
                                         "N_amp_MPa"), 0)
    rows.update(_fw_rows(("C2", "C4"), ("N_mean_cycle", "N_amp_MPa"), 1))
    got, ref = dict(rows), dict(rows)
    t.suite_OT(got, True, rerun=True)
    j.suite_OT(ref, True)
    for c in ("C2", "C4", "D1", "D3", "D5"):
        _oracle_rows_equal(got["OT_" + c], ref["OT_" + c])


def test_ov_legs_and_stationarity_match_jax(t, j, quiet, cut_fv, tmp_path,
                                            monkeypatch):
    rows = _fw_rows(("E1", "E2", "E3", "E4", "E5"),
                    ("N_mean_MPa", "N_trough_MPa", "b_trough_mm"), 2)
    got, ref = dict(rows), dict(rows)
    t.suite_OV(got, True, rerun=True)
    j.suite_OV(ref, True)
    for k in [f"OV_E{i}" for i in range(1, 6)] + ["OV_trend", "OV_cap"]:
        _oracle_rows_equal(got[k], ref[k])

    # the stationarity leg from the same E1 state on a 12 x 6 valley grid
    md = t.shmip.initialize("E1", resolution=300.0, days=1, nt_per_day=1)
    xy = np.stack([md.x, md.y], axis=1)
    rng = np.random.default_rng(3)
    N = 1e6 * (1.0 + 0.1 * rng.standard_normal(md.x.size))
    b = 4e-3 * (1.0 + 0.2 * rng.random(md.x.size))
    jvs = R.by_path(os.path.join("scripts", "valley_stationarity.py"),
                    "jax_valley_stationarity")
    monkeypatch.setattr(jvs, "fem_e1_state", lambda: (xy, N, b))
    monkeypatch.setattr(jvs, "OUT", str(tmp_path / "jax.json"))
    sys.path.insert(0, SCRIPTS)
    try:
        import torch_valley_stationarity as tvs
    finally:
        sys.path.remove(SCRIPTS)
    jvs.main(12, 6, 0.5)
    import json
    with open(jvs.OUT) as f:
        want = json.load(f)
    have = tvs.stationarity(xy, N, b, 12, 6, 0.5, verbose=0)
    assert set(have) == set(want)
    _oracle_rows_equal(have, want)


# ------------------------------------------- against the JAX child's runs

@pytest.mark.parametrize("case", ["A2", "A6"])
def test_suite_s_matches_jax(t, jax_runs, quiet, monkeypatch, case):
    _port_s(t, monkeypatch)
    out = {}
    t.suite_S(out, False, force=True, cases=(case,), device="cpu")
    got, ref = out["S_" + case], jax_runs("S_" + case)
    for k in ("verdict", "ptc_steps", "newton", "polish_newton",
              "converged"):
        assert got[k] == ref[k], k
    assert got["complete"] and not got["polish_wall_capped"]
    assert set(ref) <= set(got)
    for k, v in ref.items():
        if k != "wall_s":
            assert _same(got[k], v, rel=1e-8), k


def test_artesian_rows_match_jax(t, jax_runs):
    ref = jax_runs("artesian_D5")
    md = t.shmip.initialize("D5", days=730, nt_per_day=4, **R.SO_X_INIT)
    win = (md.x > t.WINDOW[0]) & (md.x < t.WINDOW[1])
    probe = t.artesian_probe(md, win)
    # the JAX run's windows: the spin, then the final year's 10-day ones
    assert len(ref["N"]) == len(ref["rows"]) + 1
    rows = [probe(np.asarray(N), 10 * (i + 1))
            for i, N in enumerate(ref["N"][1:])]
    got = t.artesian_summary(rows, ref["converged"], ref["spin_years"])
    assert any(r["x_neg_km"] for r in rows)
    assert set(got) == set(ref) - {"N", "wall_s"}
    for k, v in ref.items():
        if k not in ("N", "wall_s"):
            assert _same(got[k], v, rel=1e-10), k
