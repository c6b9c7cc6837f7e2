"""SHMIP validation on the port: the twin of scripts/shmip_validate.py's sheet
suites A and S (S for A1), importing only shakti_tpu_torch and the
scipy-only oracle.

Suite A (A1, A3, A5: distributed input): long float64 transients at
60 x 12 and 4 steps a day, judged each year against the independent 1D
steady oracle (oracle/shmip_oracle.py) over x in [30, 90] km, with the
global mass budget (solve/diagnostics.py) at the end.  Suite S (A1): the
same case solved directly by solve_steady with the polish, JAX's exact
call and budget, judged against the same oracle.

Results are cached per suite in scripts/torch_shmip_results.json (merged by
the keys a run wrote, so runs covering other suites or cases are kept) and
rendered as SHMIP_TORCH.md, each value beside the JAX package's in
scripts/shmip_results.json:

    python scripts/torch_shmip_validate.py [--quick] [--suites AS]
        [--cases A1,A3] [--force] [--device cuda|cpu]

(``--cases`` also selects suite A's cases here.)

Suites B-F, S for A2-A6 and the oracle legs are not ported here.
"""

import fcntl
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from oracle.shmip_oracle import steady_profile  # noqa: E402
from shakti_tpu_torch.ops import spmv_cuda  # noqa: E402
from shakti_tpu_torch.setups import setup_shmip as shmip  # noqa: E402
from shakti_tpu_torch.solve import diagnostics as diag  # noqa: E402
from shakti_tpu_torch.solve.timestep import (make_step_fn,  # noqa: E402
                                             run_window, timestep_sizes)

WINDOW = (30e3, 90e3)
CACHE = os.path.join(ROOT, "scripts", "torch_shmip_results.json")
MD_OUT = os.path.join(ROOT, "SHMIP_TORCH.md")
JAX_CACHE = os.path.join(ROOT, "scripts", "shmip_results.json")
DEVICE = "cuda"
# what the rows are held to against the JAX package's
A_RELN_RTOL, A_IMBALANCE = 0.01, 2e-4
S_PTC_RTOL, S_POLISH_NEWTON, S_RELN_ATOL, S_IMBALANCE = 0.02, 2, 1e-6, 1e-6


def run_case(case, years, nx=60, ny=12, nt_per_day=4, device=None,
             on_year=None):
    """``years`` of case ``case`` in float64: a row per year (relN_win,
    relb_win against the oracle, the y-spread at 50 km, every step
    converged) and the final mass budget.  ``on_year(rows)`` is called
    after each year with the rows so far."""
    md = shmip.initialize(case, nx=nx, ny=ny, days=365 * years,
                          nt_per_day=nt_per_day)
    md.device, md.dtype = device or DEVICE, torch.float64
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype,
                         device=static.dirichlet.device)
    p = steady_profile(case)
    x = md.x
    No = np.interp(x, p["x"], p["N"])
    bo = np.interp(x, p["x"], p["b"])
    win = (x > WINDOW[0]) & (x < WINDOW[1])
    yearly = []
    W = 365 * nt_per_day
    i = 0
    while i + W <= dts.shape[0]:
        state, dstep = run_window(step, state, dts[i:i + W])
        i += W
        N2, b2 = md.to_user_order(state.N), md.to_user_order(state.b)
        band = np.abs(x - 50e3) < 2e3
        yearly.append({
            "year": i // W,
            "relN_win": float(np.linalg.norm(N2[win] - No[win])
                              / np.linalg.norm(No[win])),
            "relb_win": float(np.linalg.norm(b2[win] - bo[win])
                              / np.linalg.norm(bo[win])),
            "yspread_50km": float((N2[band].max() - N2[band].min())
                                  / N2[band].mean()),
            "converged": bool(np.asarray(dstep["converged"]).all()),
        })
        if on_year is not None:
            on_year(yearly)
    Q_out = diag.boundary_discharge(mesh, static, state, md.params)
    Q_src = diag.water_production(mesh, static, state, md.params)
    return md, state, p, yearly, Q_out, Q_src


def ymean_profile(md, N):
    """y-averaged N per structured-mesh x-column."""
    xs = np.unique(np.round(md.x, 6))
    prof = np.array([N[np.isclose(md.x, xv)].mean() for xv in xs])
    return xs, prof


def _card(device):
    if not str(device).startswith("cuda"):
        return None
    from torch_cooke2_report import card
    return card()


def _jax_cache():
    if not os.path.exists(JAX_CACHE):
        return {}
    with open(JAX_CACHE) as f:
        return json.load(f)


# ---------------------------------------------------------------- suites

def suite_A(out, quick, device=None, cases=None):
    """A1, A3 and A5 (``cases``: a subset) for their years, each case's
    rows saved after every year (``"complete": False`` until its last)."""
    plans = [("A1", 3 if quick else 10), ("A3", 2 if quick else 10),
             ("A5", 2 if quick else 12)]
    A5 = None
    jax = _jax_cache()
    for case, years in plans:
        if cases is not None and case not in cases:
            continue
        t0 = time.time()
        spmv_cuda.reset_launches()

        def partial(rows, case=case, years=years, t0=t0):
            out[case] = {"input_ms": shmip.CASES_A[case], "years": years,
                         "yearly": list(rows), "complete": False,
                         "wall_s": round(time.time() - t0, 1),
                         "card": _card(device or DEVICE)}
            _save_cache(out)
        md, state, p, yearly, Q_out, Q_src = run_case(
            case, years, device=device, on_year=partial)
        if case == "A5":
            A5 = (md, state)
        imb = abs(Q_out - Q_src) / max(abs(Q_src), 1e-30)
        row = {"input_ms": shmip.CASES_A[case], "years": years,
               "yearly": yearly, "Q_out": Q_out, "Q_src": Q_src,
               "Q_oracle": float(-p["q_margin"] * 20e3),
               "imbalance": imb, "complete": True,
               "wall_s": round(time.time() - t0, 1),
               "launches": dict(spmv_cuda.launches),
               "card": _card(device or DEVICE)}
        row["checks"] = a_checks(row, jax.get(case))
        out[case] = row
        _save_cache(out)
        print(f"{case}: {json.dumps(out[case]['yearly'][-1])}", flush=True)
    return A5


def a_checks(row, ref):
    """Every step converged, imbalance <= A_IMBALANCE and (against the JAX
    package's row of the same years) the last year's relN_win within
    A_RELN_RTOL relative."""
    c = {"converged": all(y["converged"] for y in row["yearly"]),
         "imbalance": bool(row["imbalance"] <= A_IMBALANCE)}
    if ref and ref.get("years") == row["years"]:
        a, b = row["yearly"][-1]["relN_win"], ref["yearly"][-1]["relN_win"]
        c["relN_win"] = bool(abs(a - b) <= A_RELN_RTOL * abs(b))
    return c


class _Cache(dict):
    """Results cache that records which keys this process wrote, so a save
    merges onto the file's state instead of overwriting other runs'
    cases."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._dirty = set()

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._dirty.add(key)


def _save_cache(out):
    """Write the cache and SHMIP_TORCH.md now: the keys this process wrote
    over the file's, every other key taken from the file, under a lock (runs
    of other cases may save at the same time)."""
    with open(CACHE + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _merge_and_write(out)


def _merge_and_write(out):
    dirty = getattr(out, "_dirty", None)
    if dirty is not None and os.path.exists(CACHE):
        try:
            with open(CACHE) as f:
                disk = json.load(f)
        except (OSError, ValueError):
            disk = {}
        merged = dict(disk)
        merged.update({k: out[k] for k in dirty if k in out})
        for k in list(out.keys()):
            if k not in merged:
                dict.__delitem__(out, k)
        for k, v in merged.items():
            if k not in dirty:
                dict.__setitem__(out, k, v)
    with open(CACHE, "w") as f:
        json.dump(dict(out), f, indent=1)
    with open(MD_OUT, "w") as f:
        f.write("\n".join(build_md(out)) + "\n")


# Per-case polish budgets: (max_newton_total, patience, max_wall_s), the
# JAX script's for A1
S_POLISH_BUDGET = {"A1": (6000, 3, 1800.0)}
S_ORDER = ("A1",)


def s_row(md, res, case, tol, max_steps, quick, t0):
    """Suite S's row of one case from its solve_steady result."""
    p = steady_profile(case)
    x = md.x
    No = np.interp(x, p["x"], p["N"])
    bo = np.interp(x, p["x"], p["b"])
    win = (x > WINDOW[0]) & (x < WINDOW[1])
    info = res["info"]
    Q_out, Q_src = float(res["Q_out"]), float(res["Q_src"])
    return {"converged": bool(info["converged"]),
            "verdict": info.get("verdict",
                                "steady" if info["converged"] else "no"),
            "polish_newton": info.get("polish_newton"),
            "polish_resN": info.get("polish_resN", float("nan")),
            "wander_rate": info.get("wander_rate", float("nan")),
            "wander_amp_N": info.get("wander_amp_N", float("nan")),
            "wander_amp_b": info.get("wander_amp_b", float("nan")),
            "t_march_yr": info.get("t_march_yr", float("nan")),
            "cycle_rate": info.get("cycle_rate", float("nan")),
            "cycle_amp_N": info.get("cycle_amp_N", float("nan")),
            "cycle_amp_b": info.get("cycle_amp_b", float("nan")),
            "tol": tol, "max_steps": max_steps, "quick": bool(quick),
            "ptc_steps": info["steps"], "newton": info["newton_total"],
            "drift_per_yr": info["rate"],
            "drift_bdry_per_yr": info["rate_b_bdry"],
            "relN_win": float(np.linalg.norm(res["N"][win] - No[win])
                              / np.linalg.norm(No[win])),
            "relb_win": float(np.linalg.norm(res["b"][win] - bo[win])
                              / np.linalg.norm(bo[win])),
            "Q_out": Q_out, "Q_src": Q_src,
            "imbalance": abs(Q_out - Q_src) / max(abs(Q_src), 1e-30),
            "wall_s": round(time.time() - t0, 1)}


def s_checks(row, ref):
    """Verdict polished, imbalance <= S_IMBALANCE and, against the JAX
    package's row: PTC steps within S_PTC_RTOL, polish Newton within
    S_POLISH_NEWTON, relN_win within S_RELN_ATOL."""
    c = {"polished": row["verdict"] == "polished",
         "imbalance": bool(row["imbalance"] <= S_IMBALANCE)}
    if ref:
        c["ptc_steps"] = bool(abs(row["ptc_steps"] - ref["ptc_steps"])
                              <= S_PTC_RTOL * ref["ptc_steps"])
        c["polish_newton"] = (row["polish_newton"] is not None
                              and abs(row["polish_newton"]
                                      - ref["polish_newton"])
                              <= S_POLISH_NEWTON)
        c["relN_win"] = bool(abs(row["relN_win"] - ref["relN_win"])
                             <= S_RELN_ATOL)
    return c


def suite_S(out, quick, force=False, cases=None, budget_override=None,
            device=None):
    """Suite S for A1: solve_steady(polish=True) with the JAX script's call
    and budget, judged against the 1D oracle as suite A is.  A cached case
    is skipped unless ``force``."""
    print("== suite S: direct steady solve of A1 ==", flush=True)
    tol = 1e-2 if quick else 1e-3
    max_steps = 6000 if quick else 30000
    jax = _jax_cache()
    for case in S_ORDER:
        if cases is not None and case not in cases:
            continue
        if "S_" + case in out and not force:
            print(f"S_{case}: cached, skipping (--force re-runs)",
                  flush=True)
            continue
        t0 = time.time()
        md = shmip.initialize(case, nx=60, ny=12, days=30, nt_per_day=24)
        md.device, md.dtype = device or DEVICE, torch.float64
        budget = budget_override or S_POLISH_BUDGET[case]
        spmv_cuda.reset_launches()
        res = md.solve_steady(tol=tol, max_steps=max_steps, strict=False,
                              polish=True,
                              polish_max_newton=(6000 if quick
                                                 else budget[0]),
                              polish_patience=3 if quick else budget[1],
                              polish_max_wall_s=(900.0 if quick
                                                 else budget[2]),
                              cycle_window=150 if quick else 400)
        m = s_row(md, res, case, tol, max_steps, quick, t0)
        m["launches"] = dict(spmv_cuda.launches)
        m["card"] = _card(device or DEVICE)
        m["checks"] = s_checks(m, jax.get("S_" + case))
        out["S_" + case] = m
        _save_cache(out)
        print(f"S_{case}: {json.dumps(m)}", flush=True)


# ------------------------------------------------------------- SHMIP_TORCH.md

def _g(v, fmt=".4g"):
    return "—" if v is None else format(v, fmt)


def build_md(out):
    jax = _jax_cache()
    lines = [
        "# SHMIP_TORCH — SHMIP suites A and S (A1) on the port",
        "",
        "Written by `python scripts/torch_shmip_validate.py` from",
        "scripts/torch_shmip_results.json: float64, 60 x 12 (793 nodes),",
        "judged against the independent 1D steady oracle",
        "(oracle/shmip_oracle.py) over x in [30, 90] km.  Each value stands",
        "beside the JAX package's (scripts/shmip_results.json, SHMIP.md),",
        "run on another machine: wall times are not compared.",
    ]
    for case in ("A1", "A3", "A5"):
        r = out.get(case)
        if not r:
            continue
        j = jax.get(case, {})
        jy = {y["year"]: y for y in j.get("yearly", [])}
        lines += [
            "", f"## {case} ({r['years']} years, input {r['input_ms']:g} m/s"
            f"{', on ' + r['card'] if r.get('card') else ''})", "",
            "| year | relN_win port | JAX | relb_win port | JAX |"
            " yspread_50km port | JAX | converged |",
            "|---|---|---|---|---|---|---|---|"]
        for y in r["yearly"]:
            jj = jy.get(y["year"], {})
            lines.append(
                f"| {y['year']} | {y['relN_win']:.4e} |"
                f" {_g(jj.get('relN_win'), '.4e')} | {y['relb_win']:.4e} |"
                f" {_g(jj.get('relb_win'), '.4e')} |"
                f" {y['yspread_50km']:.4e} |"
                f" {_g(jj.get('yspread_50km'), '.4e')} |"
                f" {'yes' if y['converged'] else '**no**'} |")
        if not r.get("complete", True):
            lines += ["", f"**Stopped after {len(r['yearly'])} of"
                      f" {r['years']} years** ({r['wall_s']} s): no budget."]
            continue
        lines += [
            "",
            "| | port | JAX |", "|---|---|---|",
            f"| Q_out [m³/s] | {r['Q_out']:.6g} | {_g(j.get('Q_out'), '.6g')} |",
            f"| Q_src [m³/s] | {r['Q_src']:.6g} | {_g(j.get('Q_src'), '.6g')} |",
            f"| imbalance | {r['imbalance']:.3e} |"
            f" {_g(j.get('imbalance'), '.3e')} |",
            f"| wall [s] | {r['wall_s']} | {_g(j.get('wall_s'))} (CPU) |",
            "",
            f"Checks: {json.dumps(r.get('checks', {}))}; kernel launches"
            f" {json.dumps(r.get('launches', {}))}."]
    r = out.get("S_A1")
    if r:
        j = jax.get("S_A1", {})
        lines += [
            "", "## S_A1 (solve_steady with the polish)"
            f"{', on ' + r['card'] if r.get('card') else ''}", "",
            "| | port | JAX |", "|---|---|---|",
            f"| verdict | {r['verdict']} | {j.get('verdict', '—')} |",
            f"| PTC steps | {r['ptc_steps']} | {_g(j.get('ptc_steps'))} |",
            f"| Newton (march) | {r['newton']} | {_g(j.get('newton'))} |",
            f"| polish Newton | {r['polish_newton']} |"
            f" {_g(j.get('polish_newton'))} |",
            f"| relN_win | {r['relN_win']:.6e} |"
            f" {_g(j.get('relN_win'), '.6e')} |",
            f"| imbalance | {r['imbalance']:.3e} |"
            f" {_g(j.get('imbalance'), '.3e')} |",
            f"| wall [s] | {r['wall_s']} | {_g(j.get('wall_s'))} (CPU) |",
            "",
            f"Checks: {json.dumps(r.get('checks', {}))}; kernel launches"
            f" {json.dumps(r.get('launches', {}))}."]
    return lines


def main(quick=False, suites="AS", force=False, cases=None,
         budget_override=None, device=None):
    out = _Cache()
    if os.path.exists(CACHE):
        with open(CACHE) as f:
            out.update(json.load(f))
        out._dirty.clear()
    if "A" in suites:
        suite_A(out, quick, device, cases)
    if "S" in suites:
        suite_S(out, quick, force=force, cases=cases,
                budget_override=budget_override, device=device)
    _save_cache(out)
    print("wrote SHMIP_TORCH.md + scripts/torch_shmip_results.json")


if __name__ == "__main__":
    quick = "--quick" in sys.argv
    force = "--force" in sys.argv
    suites, device = "AS", None
    cases = budget_override = None
    for i, a in enumerate(sys.argv):
        if a in ("--suites", "--cases", "--budget", "--device"):
            a = f"{a}={sys.argv[i + 1]}"
        if a.startswith("--suites="):
            suites = a.split("=", 1)[1]
        elif a.startswith("--cases="):
            cases = tuple(a.split("=", 1)[1].split(","))
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--budget="):
            budget_override = tuple(
                float(x) for x in a.split("=", 1)[1].split(","))
    if set(suites) - set("AS"):
        raise SystemExit("this twin runs suites A and S only")
    if budget_override is not None:
        budget_override = (int(budget_override[0]), int(budget_override[1]),
                           float(budget_override[2]))
    main(quick=quick, suites=suites, force=force, cases=cases,
         budget_override=budget_override, device=device)
