"""The port's validation drivers (scripts/torch_cooke2_report.py,
torch_cooke2_steady.py, torch_shmip_validate.py) against the JAX package's
(scripts/cooke2_report.py, cooke2_steady.py, shmip_validate.py), in float64
on the CPU.  No JAX script's main() runs: each rewrites a committed
artifact.

- report: a results directory of seeded arrays at Cook_E2's 12,270 nodes
  (t, N, b, qx, qy, a log.csv in the port's columns) and a float64 twin
  half written (its later rows zero): analyze, solver_stats and
  drift_series give equal dicts and arrays in both packages; the report
  writes only where it is told to, and its segment records sum;
- SHMIP: run_case of A1 on a 12 x 4 mesh for one year at one step a day:
  the yearly row and the y-mean profile within 1e-8 relative, Q_out and
  Q_src within 1e-10; suite
  S's row builder on A1 (20 x 4, ELL in both) over a capped solve_steady
  (20 PTC steps, strict=False): the same keys, the values within 1e-8;
- steady: the twin's compute on the synthetic 50 x 50 catchment capped at
  two PTC steps against the same capped md.solve_steady call of the JAX
  package: the far-field and budget values within 1e-8.

The JAX scripts are imported in a fixture that restores os.environ after
(cooke2_report sets SHAKTI_MESH_DIR at import)."""

import csv
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from tests import torch_parity  # noqa: F401  (pins torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
N_NODES, ROWS = 12270, 24
NARROW = dict(nx=20, ny=4)


def _load(name, alias):
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mods():
    saved_env, saved_path = dict(os.environ), list(sys.path)
    sys.path.insert(0, SCRIPTS)
    try:
        import torch_cooke2_report
        import torch_cooke2_steady
        import torch_shmip_validate
        yield {"jreport": _load("cooke2_report", "jax_cooke2_report"),
               "jshmip": _load("shmip_validate", "jax_shmip_validate"),
               "treport": torch_cooke2_report,
               "tsteady": torch_cooke2_steady,
               "tshmip": torch_shmip_validate}
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        sys.path[:] = saved_path


# -------------------------------------------------------------------- report

def _write_run(rdir, rng, rows, filled=None, scale=0.0):
    os.makedirs(rdir)
    t = np.linspace(0.0, rows * 86400.0, rows)
    N = 3.7e5 * (1 + 0.05 * rng.standard_normal((rows, N_NODES)))
    b = 2e-3 * (1 + 0.1 * rng.random((rows, N_NODES)))
    qx, qy = 1e-3 * rng.standard_normal((2, rows, N_NODES))
    arrays = dict(t=t, N=N * (1 + scale), b=b * (1 + scale), qx=qx, qy=qy)
    for k, v in arrays.items():
        if filled is not None and k != "t":
            v[filled:] = 0.0
        np.save(os.path.join(rdir, f"{k}.npy"), v)
    with open(os.path.join(rdir, "log.csv"), "w") as f:
        w = csv.writer(f)
        w.writerow(["step", "t", "newton_mean", "newton_max", "cg_mean",
                    "rnorm_max", "N_min"])
        for i in range(rows if filled is None else filled):
            w.writerow([24 * (i + 1) - 1, t[i], 1.0 + (i % 3) / 24, 2,
                        2.5 + rng.random() * 3, 1e-9, 1e5])


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cooke2_runs")
    rng = np.random.default_rng(7)
    rdir, rdir64 = str(base / "f32"), str(base / "f64")
    _write_run(rdir, rng, ROWS)
    _write_run(rdir64, np.random.default_rng(7), ROWS, filled=ROWS // 2,
               scale=1e-5)
    return rdir, rdir64


@pytest.fixture(scope="module")
def cooke2_mds(mods):
    # the JAX script set SHAKTI_MESH_DIR at import: both on the catchment
    jmd = mods["jreport"].c2.initialize(days=3650, results_name=None)
    tmd = mods["treport"].cooke2_model()
    assert jmd.x.size == tmd.x.size == N_NODES
    return jmd, tmd


def test_report_battery_equals_jax(mods, run_dirs, cooke2_mds):
    jr, tr = mods["jreport"], mods["treport"]
    rdir, rdir64 = run_dirs
    jmd, tmd = cooke2_mds
    np.testing.assert_array_equal(tr.far_mask(tmd), jr.far_mask(jmd))
    jres, jout = jr.analyze(rdir, jmd)
    tres, tout = tr.analyze(rdir, tmd)
    assert tout == jout
    assert tr.solver_stats(rdir) == jr.solver_stats(rdir)
    jres64, jout64 = jr.analyze(rdir64, jmd)
    tres64, tout64 = tr.analyze(rdir64, tmd)
    assert set(tout64) == set(jout64)
    for k in tout64:       # the zero rows make some NaN in both
        assert (tout64[k] == jout64[k]
                or (math.isnan(tout64[k]) and math.isnan(jout64[k]))), k
    jd, td = jr.drift_series(jres, jres64), tr.drift_series(tres, tres64)
    assert td[2] == jd[2] == ROWS // 2
    np.testing.assert_array_equal(td[0], jd[0])
    np.testing.assert_array_equal(td[1], jd[1])


def test_report_writes_only_its_outputs(mods, run_dirs, tmp_path,
                                        monkeypatch):
    """main() on the two directories writes the JSON and the markdown where
    OUT_JSON / OUT_MD point and nothing else: the committed artifacts and
    the run directories stay as they were."""
    tr = mods["treport"]
    rdir, rdir64 = run_dirs
    watched = [os.path.join(ROOT, f) for f in (
        "COOKE2_RUN.md", "COOKE2_RUN_TORCH.md", "scripts/cooke2_results.json",
        "scripts/torch_cooke2_results.json")]
    before = {p: os.stat(p).st_mtime_ns if os.path.exists(p) else None
              for p in watched}
    runs = {d: sorted(os.listdir(d)) for d in run_dirs}
    # a segment stopped at its last checkpoint (step 1200), then one
    # resumed there to the end: api/run.py's run_meta.json is the last one's
    for start, steps, wall in ((0, 1200, 30.0), (1200, 1500, 45.0)):
        seg = {"wall_s": wall, "steps": steps, "resumed_from": start,
               "completed": start > 0, "card": "H",
               "launches": {"bell_spmv": steps},
               "plain_calls": {"bell_operator_plain": 0}}
        for name in (f"run_meta.{start}.json", "run_meta.json"):
            with open(os.path.join(rdir, name), "w") as f:
                json.dump(seg, f)
    monkeypatch.setattr(tr, "OUT_JSON", str(tmp_path / "r.json"))
    monkeypatch.setattr(tr, "OUT_MD", str(tmp_path / "r.md"))
    out = tr.main(rdir, rdir64)
    assert sorted(os.listdir(tmp_path)) == ["r.json", "r.md"]
    assert before == {p: os.stat(p).st_mtime_ns if os.path.exists(p)
                      else None for p in watched}
    for d in run_dirs:
        extra = {"run_meta.json", "run_meta.0.json", "run_meta.1200.json"}
        assert set(os.listdir(d)) - extra == set(runs[d]) - extra
    rec = out["run"]
    assert (rec["segments"], rec["steps"], rec["wall_s"]) == (2, 2700, 75.0)
    assert rec["launches"] == {"bell_spmv": 2700} and rec["completed"]
    assert out["drift"]["rows_compared"] == ROWS // 2
    assert "f64" not in out and set(out["vs_jax_f32"]) == {
        k for k, _, _ in tr.TOLERANCES}
    with open(tmp_path / "r.json") as f:
        assert json.load(f)["f32"] == out["f32"]


# --------------------------------------------------------------------- SHMIP

def test_run_case_matches_jax(mods):
    kw = dict(nx=12, ny=4, nt_per_day=1)
    jmd, js, _, jy, jqo, jqs = mods["jshmip"].run_case("A1", 1, **kw)
    tmd, ts, _, ty, tqo, tqs = mods["tshmip"].run_case("A1", 1, device="cpu",
                                                       **kw)
    assert len(ty) == len(jy) == 1
    for t, j in zip(ty, jy):
        assert set(t) == set(j) and t["year"] == j["year"]
        assert t["converged"] and j["converged"]
        for k in ("relN_win", "relb_win", "yspread_50km"):
            assert t[k] == pytest.approx(j[k], rel=1e-8), k
    assert tqo == pytest.approx(jqo, rel=1e-10)
    assert tqs == pytest.approx(jqs, rel=1e-10)
    jx, jp = mods["jshmip"].ymean_profile(jmd, np.asarray(js.N))
    tx, tp = mods["tshmip"].ymean_profile(tmd, tmd.to_user_order(ts.N))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_allclose(tp, jp, rtol=1e-8)


def _capped(real_init, pkg):
    """setup_shmip.initialize at 20 x 4 in ELL, its solve_steady capped at
    20 PTC steps without the polish or the cycle certificate."""
    def init(case, **kw):
        kw.update(NARROW)
        md = real_init(case, **kw)
        md.operator = "ell"
        if pkg == "torch":
            md.device = "cpu"
        solve = md.solve_steady

        def capped(**skw):
            skw.update(max_steps=20, polish=False, cycle_window=0)
            return solve(**skw)
        md.solve_steady = capped
        return md
    return init


def test_suite_s_row_matches_jax(mods, monkeypatch):
    rows = {}
    for pkg, mod in (("jax", mods["jshmip"]), ("torch", mods["tshmip"])):
        monkeypatch.setattr(mod.shmip, "initialize",
                            _capped(mod.shmip.initialize, pkg))
        monkeypatch.setattr(mod, "_save_cache", lambda out: None)
        out = {}
        kw = {"device": "cpu"} if pkg == "torch" else {}
        mod.suite_S(out, True, force=True, cases=("A1",), **kw)
        rows[pkg] = out["S_A1"]
    t, j = rows["torch"], rows["jax"]
    assert set(t) - {"launches", "card", "checks", "complete", "budget",
                     "segments", "polish_wall_capped"} == set(j)
    assert t["verdict"] == j["verdict"] and t["ptc_steps"] == j["ptc_steps"]
    for k, v in j.items():
        if k == "wall_s":
            continue
        if isinstance(v, float) and math.isnan(v):
            assert math.isnan(t[k]), k
        elif isinstance(v, float):
            assert t[k] == pytest.approx(v, rel=1e-8), k
        else:
            assert t[k] == v, k


# -------------------------------------------------------------------- steady

def test_steady_compute_matches_jax(mods, monkeypatch):
    import setups.setup_cooke2 as jc2
    from shakti_tpu_torch.setups import setup_cooke2 as tc2
    monkeypatch.delenv("SHAKTI_MESH_DIR", raising=False)
    jmd = jc2.initialize(results_name=None)
    tmd = tc2.initialize(results_name=None)
    tmd.device, tmd.dtype = "cpu", torch.float64
    assert jmd.x.size == tmd.x.size == 51 * 51
    got = mods["tsteady"].compute(tmd, 1e-3, 2, strict=False)
    res = jmd.solve_steady(tol=1e-3, max_steps=2, strict=False)
    far = mods["jreport"].far_mask(jmd)
    lake = jmd.lake_bdry.astype(bool)
    N = np.asarray(res["N"])
    ref = {"far_field_mean_N_MPa": float(N[far].mean()) / 1e6,
           "far_field_ratio": float(N[far].mean()) / jmd.N_bdry,
           "lake_mean_N_MPa": float(N[lake].mean()) / 1e6,
           "mean_gap_mm": float(np.asarray(res["b"]).mean()) * 1e3,
           "Q_out_m3s": float(res["Q_out"]), "Q_src_m3s": float(res["Q_src"])}
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, rel=1e-8), k
    info = res["info"]
    for k in ("converged", "steps", "accepted", "rejected", "newton_total"):
        assert got["solver"][k] == info[k], k
    assert got["solver"]["steps"] == 2 and got["solver"]["verdict"] == "no"
