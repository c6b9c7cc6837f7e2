"""SHMIP suites B-F on the port (scripts/torch_shmip_validate.py) against
the JAX package's runners (scripts/shmip_validate.py), in float64 on the
CPU, at cuts: each runner's outputs within 1e-8 relative; a case stopped
after its first window and resumed bitwise equal to an unbroken one; the
suites' rows, derived values and checks over a synthetic cache.  No JAX
script's main() runs: each rewrites a committed artifact.

The JAX runners run once, at tests/torch_examples_ref.py's BF_TEST_CUTS,
in a child process beside the port's runs (their compilations are most of
this file's time).  They take their lengths from setup_shmip.initialize;
the cuts that their arguments cannot express (a seasonal case shorter
than a year) come from wrapping initialize in both packages alike."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tests import torch_examples_ref as R
from tests import torch_parity  # noqa: F401  (pins torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


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
def jax_runs(tmp_path_factory):
    """The JAX runners at R.BF_TEST_CUTS in one child process, started
    with the first test so that it runs beside the port's runners."""
    child = R.Child("--bf-tests", tmp_path_factory.mktemp("jax_bf"))
    yield child
    child.close()


def _cut(mod, monkeypatch, **over):
    """Wrap mod.shmip.initialize so that ``over`` replaces its keywords."""
    real = mod.shmip.initialize

    def init(case, **kw):
        kw.update(over)
        return real(case, **kw)
    monkeypatch.setattr(mod.shmip, "initialize", init)


def _close(a, b, rel=1e-8):
    """Within ``rel`` of the largest |b| (N crosses zero in places)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * np.abs(b).max()


def test_b_and_c_runners_match_jax(t, jax_runs):
    c = R.BF_TEST_CUTS
    tmd, ts, tqo, tqs, tconv = t.run_b_case("B5", device="cpu", **c["B5"])
    _, tm = t.run_c_case("C4", ts, device="cpu", **c["C4"])
    j = jax_runs("B5")
    assert j["converged"] and tconv
    assert tqo == pytest.approx(j["Q_out"], rel=1e-8)
    assert tqs == pytest.approx(j["Q_src"], rel=1e-8)
    _close(tmd.to_user_order(ts.N), j["N"])
    _close(t.ymean_profile(tmd, tmd.to_user_order(ts.N))[1], j["ymean"])
    jm = jax_runs("C4")
    assert set(tm) == set(jm) and tm["converged"] and jm["converged"]
    for k in ("N_mean_cycle", "N_amp_MPa"):
        assert tm[k] == pytest.approx(jm[k], rel=1e-8), k


@pytest.mark.parametrize("case", ["D5", "F5"])
def test_seasonal_runner_matches_jax(t, jax_runs, monkeypatch, case):
    kw = dict(R.BF_TEST_CUTS[case])
    _cut(t, monkeypatch, **kw.pop("init"))
    md, state, ts, tc, tqo, tqs = t.run_seasonal_case(
        case, spin_years=0, device="cpu", **kw)
    j = jax_runs(case)
    assert j["converged"] and tc and ts.size > 1
    _close(ts, j["samples"])
    assert tqo == pytest.approx(j["Q_out"], rel=1e-8)
    assert tqs == pytest.approx(j["Q_src"], rel=1e-8)


def test_e_runner_matches_jax(t, jax_runs):
    md, state, tr, tc, tqo, tqs = t.run_e_case("E1", device="cpu",
                                               **R.BF_TEST_CUTS["E1"])
    j = jax_runs("E1")
    assert j["converged"] and tc
    _close(md.to_user_order(state.N), j["N"])
    assert tr == pytest.approx(j["steady_rel"], rel=1e-8)
    assert tqo == pytest.approx(j["Q_out"], rel=1e-8)
    assert tqs == pytest.approx(j["Q_src"], rel=1e-8)


# -------------------------------------------------------------------- resume

@pytest.mark.parametrize("runner", ["seasonal", "e"])
def test_resumed_case_is_bitwise_unbroken(t, monkeypatch, tmp_path,
                                          runner):
    """Stopped at its first save (max_wall 0), then started again with the
    same checkpoint directory: the samples, the final state and the budget
    bitwise equal to an unbroken run's."""
    if runner == "seasonal":
        _cut(t, monkeypatch, days=12)

        def run(**ck):
            md, st, samples, conv, qo, qs = t.run_seasonal_case(
                "D3", spin_years=0, nx=12, ny=4, nt_per_day=1,
                sample_days=4, device="cpu", **ck)
            return md, st, (samples, conv, qo, qs)
    else:
        def run(**ck):
            md, st, rel, conv, qo, qs = t.run_e_case(
                "E2", years=1 / 365, nt_per_day=8, resolution=300.0,
                device="cpu", save_days=0.5, **ck)
            return md, st, (rel, conv, qo, qs)
    _, s0, r0 = run()
    ck = str(tmp_path / "ck")
    with pytest.raises(t.Stopped) as stop:
        run(ck=ck, max_wall=0.0)
    first = stop.value.args[0]
    md, s1, r1 = run(ck=ck)
    assert 0 < first < md.timesteps.size
    assert t.SEGMENT["from"] == first
    for a, b in zip(r1, r0):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k in ("N", "b", "q", "melt", "N_prev"):
        assert torch.equal(getattr(s1, k), getattr(s0, k)), k
    assert s1.lag_op[1:2] == s0.lag_op[1:2]
    assert torch.equal(s1.lag_op[2], s0.lag_op[2])


# ----------------------------------------------------------- suites and rows

def _synthetic(t, jax_rows):
    """Complete port rows equal to JAX's, with the keys the port adds."""
    out = {}
    for c, r in jax_rows.items():
        if c[0] in "BCDEF" and c[1:].isdigit():
            out[c] = dict(r, complete=True, steps=10, resumed_from=0,
                          ms_per_step=1.0, launches={"bell_spmv": 7},
                          card="card", checks={})
            key, full = t.BF_FULL[c[0]]
            out[c][key] = full
    return out


def test_suite_rows_checked_against_cache(t, monkeypatch, tmp_path):
    with open(t.JAX_CACHE) as f:
        jax_rows = json.load(f)
    out = _synthetic(t, jax_rows)
    prof = np.linspace(2e5, 6e5, 61)
    xs = np.linspace(0.0, 100e3, 61)
    for c in t.CASE_ORDER["B"]:
        out[c]["ymean_N"] = (prof * (1 + jax_rows[c]["relN_vs_A5"])).tolist()
    a5 = str(tmp_path / "a5.npz")
    np.savez(a5, xs=xs, prof=prof, years=12)
    monkeypatch.setattr(t, "A5_FINAL", a5)
    t.derive(out)
    for c in t.CASE_ORDER["B"]:
        assert out[c]["relN_vs_A5"] == pytest.approx(
            jax_rows[c]["relN_vs_A5"], rel=1e-12)
    for s in "CDF":
        assert out[f"{s}_amplitude_monotonic"] == jax_rows[
            f"{s}_amplitude_monotonic"]
        assert out[f"{s}_amplitude_monotonic_as_jax"]
    for s in "BCDEF":
        for c in t.CASE_ORDER[s]:
            ch = out[c]["checks"]
            assert all(v for k, v in ch.items() if not k.endswith("_digits"))
            assert set(t.BF_KEYS[s]) <= set(ch), c
    # a headline value off by 2e-3, an imbalance off in its second digit,
    # a case not run to its end
    out["D3"]["N_amp_MPa"] *= 1.002
    out["B2"]["imbalance"] *= 1.2
    out["F4"] = {"complete": False, "steps_done": 720, "steps": 17520,
                 "resumed_from": 0, "wall_s": 1.0, "card": "card"}
    t.derive(out)
    assert not out["D3"]["checks"]["N_amp_MPa"]
    assert out["D3"]["checks"]["N_amp_MPa_digits"] == 3
    assert not out["B2"]["checks"]["imbalance"]
    assert "F_amplitude_monotonic" not in out
    md = "\n".join(t.build_md(out))
    assert "| F4 | **not run to the end**: 720 of 17520 steps |" in md
    for s in "BCDEF":
        assert f"## Suite {s} (" in md


def test_cached_case_is_skipped(t, monkeypatch):
    monkeypatch.setattr(t, "_save_cache", lambda out: None)
    ran = []
    out = {"B1": {"complete": True}, "B2": {"complete": False}}
    for c in ("B1", "B2"):
        t._run(out, c, 10, "cpu", lambda t0, c=c: ran.append(c) or {"x": 1},
               False)
    assert ran == ["B2"] and out["B2"] == {"x": 1}
    t._run(out, "B1", 10, "cpu", lambda t0: ran.append("B1") or {}, True)
    assert ran == ["B2", "B1"]
