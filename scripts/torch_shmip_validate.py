"""SHMIP validation on the port: the twin of scripts/shmip_validate.py, every
suite of it (A to F, S, the oracle legs O, OT and OV, and the artesian study
X), importing only shakti_tpu_torch and the scipy-only oracle.

Suite A (A1, A3, A5: distributed input): long float64 transients at
60 x 12 and 4 steps a day, judged each year against the independent 1D
steady oracle (oracle/shmip_oracle.py) over x in [30, 90] km, with the
global mass budget (solve/diagnostics.py) at the end.  Suite S: the
six suite-A cases solved directly by solve_steady with the polish, the JAX
script's call and per-case budgets (S_POLISH_BUDGET; ``--budget
newton,patience,wall`` replaces them), judged against the same oracle;
with ``--checkpoint DIR`` the march and the polish save their state under
DIR/S_<case>/ (ptc.npz, polish.npz) and a case started again resumes there.

Suites B to F follow the JAX script's runners, case for case: B (moulins,
5 years, its y-mean N profile against A5's final state), C (diurnal
forcing for 10 days from B5's final state), D (degree-day seasons on the
suite-A topography, 3 years' spin and a sampled year), E (the 1,316-node
valley at 75 m, a year of hourly steps, the certified budget) and F (the
degree-day seasons on the valley, a year's spin and a sampled year,
hourly).  Every case runs in its own process if wanted (``--cases``): A5
stores its final state (results/shmip_A5_final.npz) and B5 its final
marching state (results/shmip_B5_final/) for B's comparison and for C.
With ``--checkpoint DIR`` a case saves its state after each window (a year,
30 days or a sampling window) under DIR/<case>/ and a case started again
resumes there, bitwise as if unbroken; ``--max-wall S`` stops a case at
the first save after S seconds (its row then says ``"complete": false``
and the process exits 3; suite S stops at once and resumes from its last
segment).  Suite E stores E1's final state (results/shmip_E1_final.npz) for
the stationarity leg.  X (the artesian study of D5) is computed from D5's
own run: its rows are the final year's 10-day sampling windows.

The oracle legs (oracle/shmip_fv2d.py, scipy only; no card): O, the FV
column Newton against the 1D oracle and the FV marches of A3/A5; OT, the FV
march under suites C's and D's forcing against the port's C2/C4 and D1/D3/D5
rows; OV, the FV valley against the port's E rows, with the stationarity leg
(scripts/torch_valley_stationarity.py, from the port's E1 state).  The FV
oracle's own fields depend on no FEM: where the JAX package's row holds them
for the same oracle inputs they are taken from scripts/shmip_results.json
(the row says ``oracle_from``) and only the ``fw_*``/``rel_*`` fields are
computed from the port's rows; ``--oracle-rerun`` recomputes them.

Results are cached per suite in scripts/torch_shmip_results.json (merged by
the keys a run wrote, so runs covering other suites or cases are kept) and
rendered as SHMIP_TORCH.md, each value beside the JAX package's in
scripts/shmip_results.json:

    python scripts/torch_shmip_validate.py [--quick] [--suites ABCDEFSOX]
        [--cases A1,B3] [--force] [--device cuda|cpu]
        [--checkpoint DIR] [--max-wall S] [--budget N,P,W]
        [--oracle-rerun]

(``--cases`` selects the cases of every suite here.)  The letters are the
JAX script's, in its order and with its dependencies: O runs the three
oracle legs here (T alone runs OT, V alone OV), OT needs the C/D rows, OV
the E rows, X the D5 run.
"""

import dataclasses
import fcntl
import json
import os
import shutil
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
from shakti_tpu_torch.api.steady import POLISH_FILE, PTC_FILE  # noqa: E402
from shakti_tpu_torch.io.checkpoint import load_state, save_state  # noqa: E402
from shakti_tpu_torch.ops import spmv_cuda  # noqa: E402
from shakti_tpu_torch.setups import setup_shmip as shmip  # noqa: E402
from shakti_tpu_torch.solve import diagnostics as diag  # noqa: E402
from shakti_tpu_torch.solve.timestep import (make_forcing,  # noqa: E402
                                             make_step_fn, run_window,
                                             timestep_sizes)

WINDOW = (30e3, 90e3)
CACHE = os.path.join(ROOT, "scripts", "torch_shmip_results.json")
MD_OUT = os.path.join(ROOT, "SHMIP_TORCH.md")
JAX_CACHE = os.path.join(ROOT, "scripts", "shmip_results.json")
A5_FINAL = os.path.join(ROOT, "results", "shmip_A5_final.npz")
B5_FINAL = os.path.join(ROOT, "results", "shmip_B5_final")
E1_FINAL = os.path.join(ROOT, "results", "shmip_E1_final.npz")
STATIONARITY = os.path.join(ROOT, "scripts", "torch_valley_stationarity.json")
DEVICE = "cuda"
# what the rows are held to against the JAX package's
A_RELN_RTOL, A_IMBALANCE = 0.01, 2e-4
# B-F: the headline numbers within BF_RTOL relative, the imbalances to two
# digits (or below BF_TINY where JAX's are at roundoff, suite E); B's
# window mean N is not among them: JAX's rows hold it rounded to 3 digits
BF_RTOL, BF_TINY = 1e-3, 1e-10
BF_KEYS = {"B": ("relN_vs_A5",), "C": ("N_amp_MPa",),
           "D": ("N_amp_MPa",), "E": ("N_mean_MPa", "N_trough_MPa"),
           "F": ("N_amp_MPa",)}
# the full length of each suite's cases (JAX's rows are all full)
BF_FULL = {"B": ("years", 5), "C": ("days", 10), "D": ("spin_years", 3),
           "E": ("years", 1.0), "F": ("spin_years", 1)}
CASE_ORDER = {"A": ("A1", "A3", "A5"),
              "B": ("B1", "B2", "B3", "B4", "B5"),
              "C": ("C1", "C2", "C3", "C4"),
              "D": ("D1", "D2", "D3", "D4", "D5"),
              "E": ("E1", "E2", "E3", "E4", "E5"),
              "F": ("F1", "F2", "F3", "F4", "F5")}


class Stopped(Exception):
    """A case stopped at its wall limit, its state saved."""


class CaseCheckpoint:
    """A case's marching state after each window: DIR/<step>/ holds
    checkpoint.npz (io/checkpoint.py, the operator carry included, so a
    resume replays bit for bit) and progress.json (the rows so far), and
    DIR/LATEST names the newest.  A save after ``max_wall`` seconds from
    the construction raises Stopped.  ``root=None`` saves nothing."""

    def __init__(self, root, mesh, dtype, device, max_wall=None):
        self.root, self.mesh = root, mesh
        self.dtype, self.device = dtype, device
        self.max_wall, self.t0 = max_wall, time.time()

    def load(self, state, progress):
        """(state, step, progress) of the newest save, or the arguments
        and step 0 when there is none."""
        latest = None if self.root is None else os.path.join(self.root,
                                                             "LATEST")
        if latest is None or not os.path.exists(latest):
            return state, 0, progress
        with open(latest) as f:
            d = os.path.join(self.root, f.read().strip())
        st, i, _ = load_state(d, dtype=self.dtype, device=self.device,
                              mesh=self.mesh)
        with open(os.path.join(d, "progress.json")) as f:
            prog = json.load(f)
        SEGMENT["from"] = i
        if prog["step"] != i:
            raise ValueError(f"{d}: progress at step {prog['step']}, "
                             f"state at {i}")
        return st, i, prog

    def save(self, state, i, progress):
        if self.root is not None:
            name = f"{i:08d}"
            d = os.path.join(self.root, name)
            os.makedirs(d, exist_ok=True)
            save_state(d, state, i, 0, mesh=self.mesh)
            with open(os.path.join(d, "progress.json"), "w") as f:
                json.dump(dict(progress, step=i), f)
            tmp = os.path.join(self.root, "LATEST.tmp")
            with open(tmp, "w") as f:
                f.write(name)
            old = [e for e in os.listdir(self.root)
                   if e.isdigit() and e != name]
            os.replace(tmp, os.path.join(self.root, "LATEST"))
            for e in old:
                shutil.rmtree(os.path.join(self.root, e))
        if self.max_wall is not None and time.time() - self.t0 > self.max_wall:
            raise Stopped(i)


def _window(forcing, i, j):
    if isinstance(forcing, dict):
        return {k: v[i:j] for k, v in forcing.items()}
    return forcing[i:j]


def march(step, state, forcing, i, stop, window, ck, prog, after=None):
    """Steps ``i`` to ``stop`` of ``forcing`` in windows of ``window``
    steps.  After each: ``prog["conv"]`` and'ed with the window's
    convergence, ``after(state)`` (if given) called, the state saved to
    ``ck``.  Returns the state at ``stop``."""
    while i < stop:
        j = min(i + window, stop)
        state, d = run_window(step, state, _window(forcing, i, j))
        prog["conv"] = prog["conv"] and bool(
            np.asarray(d["converged"]).all())
        i = j
        if after is not None:
            after(state)
        ck.save(state, i, prog)
    return state


def _setup(case, device, ck, max_wall, **kw):
    """shmip.initialize(case, **kw) in float64 on ``device``, frozen, its
    step and its CaseCheckpoint under ``ck``/<case>."""
    md = shmip.initialize(case, **kw)
    md.device, md.dtype = device or DEVICE, torch.float64
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    cp = CaseCheckpoint(None if ck is None else os.path.join(ck, case),
                        mesh, md.dtype, static.dirichlet.device, max_wall)
    return md, mesh, static, state, cfg, step, cp
S_PTC_RTOL, S_POLISH_NEWTON, S_RELN_ATOL, S_IMBALANCE = 0.02, 2, 1e-6, 1e-6


def run_case(case, years, nx=60, ny=12, nt_per_day=4, device=None,
             on_year=None, ck=None, max_wall=None):
    """``years`` of case ``case`` in float64: a row per year (relN_win,
    relb_win against the oracle, the y-spread at 50 km, every step
    converged) and the final mass budget.  ``on_year(rows)`` is called
    after each year with the rows so far.  ``ck``, ``max_wall``: see
    CaseCheckpoint (a save each year)."""
    md, mesh, static, state, cfg, step, cp = _setup(
        case, device, ck, max_wall, nx=nx, ny=ny, days=365 * years,
        nt_per_day=nt_per_day)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype,
                         device=static.dirichlet.device)
    p = steady_profile(case)
    x = md.x
    No = np.interp(x, p["x"], p["N"])
    bo = np.interp(x, p["x"], p["b"])
    win = (x > WINDOW[0]) & (x < WINDOW[1])
    W = 365 * nt_per_day
    state, i, prog = cp.load(state, {"yearly": []})
    yearly = prog["yearly"]
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
        cp.save(state, i, prog)
    Q_out = diag.boundary_discharge(mesh, static, state, md.params)
    Q_src = diag.water_production(mesh, static, state, md.params)
    return md, state, p, yearly, Q_out, Q_src


def ymean_profile(md, N):
    """y-averaged N per structured-mesh x-column."""
    xs = np.unique(np.round(md.x, 6))
    prof = np.array([N[np.isclose(md.x, xv)].mean() for xv in xs])
    return xs, prof


def run_b_case(case, years, nx=60, ny=12, nt_per_day=4, device=None,
               ck=None, max_wall=None):
    """Suite B: moulin input (A1 background and equal-rate moulins summing
    to the A5-equivalent 90 m^3/s) for ``years``, saved each 30 days.
    Returns (md, state, Q_out, Q_src, conv)."""
    md, mesh, static, state, cfg, step, cp = _setup(
        case, device, ck, max_wall, nx=nx, ny=ny, days=365 * years,
        nt_per_day=nt_per_day)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype,
                         device=static.dirichlet.device)
    state, i, prog = cp.load(state, {"conv": True})
    state = march(step, state, dts, i, dts.shape[0], 30 * nt_per_day, cp,
                  prog)
    Q_out = diag.boundary_discharge(mesh, static, state, md.params)
    Q_src = diag.water_production(mesh, static, state, md.params)
    return md, state, Q_out, Q_src, prog["conv"]


def run_c_case(case, state_b5, days=10, nt_per_day=48, device=None):
    """Suite C: diurnal forcing from the spun-up B5 state (solver order;
    the same mesh and numbering), settled, then the window-mean N after
    each step of the final two days.  Returns (md, metrics)."""
    md, mesh, static, state0, cfg, step, cp = _setup(
        case, device, None, None, nx=60, ny=12, days=days,
        nt_per_day=nt_per_day)
    dev = static.dirichlet.device

    def cvt(a):
        return torch.as_tensor(a, dtype=md.dtype, device=dev)

    state = dataclasses.replace(state0, N=cvt(state_b5.N), b=cvt(state_b5.b),
                                q=cvt(state_b5.q), melt=cvt(state_b5.melt),
                                N_prev=cvt(state_b5.N))
    forcing = make_forcing(md.timesteps, dtype=md.dtype, device=dev,
                           seasonal=md.seasonal_inputs)
    win = (md.x > WINDOW[0]) & (md.x < WINDOW[1])
    nt = md.timesteps.size
    i0 = nt - 2 * nt_per_day          # settle, then sample the final 2 days
    prog = {"conv": True}
    state = march(step, state, forcing, 0, i0, max(i0, 1), cp, prog)
    sub = []
    march(step, state, forcing, i0, nt, 1, cp, prog,
          after=lambda st: sub.append(
              float(md.to_user_order(st.N)[win].mean())))
    sub = np.array(sub)
    # absolute amplitude: the cycle-mean N under strong diurnal forcing
    # sits near zero, so a mean-relative amplitude is ill-conditioned
    return md, {
        "Ra": shmip.CASES_C[case],
        "N_mean_cycle": float(sub.mean()),
        "N_amp_MPa": float((sub.max() - sub.min()) / 1e6),
        "converged": prog["conv"],
    }


def run_seasonal_case(case, spin_years, nt_per_day=4, sample_days=10,
                      device=None, ck=None, max_wall=None, days=None,
                      artesian=None, **init_kw):
    """Suites D/F: degree-day seasonal forcing.  Spin ``spin_years`` (saved
    each 30 days), then the window-mean N (F: the glacier mean) after each
    ``sample_days`` window of the final year, saved each window.  ``days``
    (default 365 (spin_years + 1)) cuts the run.  ``artesian``: a list that
    receives the artesian study's row (artesian_probe) of every sampling
    window.  Returns (md, state, samples, conv, Q_out, Q_src)."""
    years = spin_years + 1
    md, mesh, static, state, cfg, step, cp = _setup(
        case, device, ck, max_wall,
        days=365 * years if days is None else days, nt_per_day=nt_per_day,
        **init_kw)
    forcing = make_forcing(md.timesteps, dtype=md.dtype,
                           device=static.dirichlet.device,
                           degree_day=md.degree_day)
    nt = md.timesteps.size
    W = 365 * nt_per_day
    i0 = spin_years * W
    if case.startswith("F"):
        win = np.ones(md.x.size, dtype=bool)      # glacier mean
    else:
        win = (md.x > WINDOW[0]) & (md.x < WINDOW[1])
    state, i, prog = cp.load(state, {"conv": True, "samples": []})
    probe = None if artesian is None else artesian_probe(md, win)

    def sample(st):
        N = md.to_user_order(st.N)
        prog["samples"].append(float(N[win].mean()))
        if probe is not None:
            prog.setdefault("artesian", []).append(
                probe(N, sample_days * len(prog["samples"])))
    state = march(step, state, forcing, i, i0, 30 * nt_per_day, cp, prog)
    state = march(step, state, forcing, max(i, i0), nt,
                  sample_days * nt_per_day, cp, prog, after=sample)
    if artesian is not None:
        artesian[:] = prog.get("artesian", [])
    Q_out = diag.boundary_discharge(mesh, static, state, md.params)
    Q_src = diag.water_production(mesh, static, state, md.params)
    return (md, state, np.array(prog["samples"]), prog["conv"], Q_out,
            Q_src)


def artesian_probe(md, win):
    """The artesian study's row of a user-order N on ``md`` (the JAX
    script's suite_artesian): the negative-node fraction, the window-mean,
    the minimum N, its ratio to the local overburden and the along-flow
    extent of N < 0, as a function (N, day) -> row."""
    p_i = md.params.rho_i * md.params.g * np.maximum(md.z_s - md.z_b, 1.0)

    def row(N, day):
        neg = N < 0.0
        return {"day": int(day),
                "frac_neg": float(neg.mean()),
                "winmean_MPa": float(N[win].mean() / 1e6),
                "N_min_MPa": float(N.min() / 1e6),
                "min_over_pi": float((N / p_i).min()),
                "x_neg_km": ([float(md.x[neg].min() / 1e3),
                              float(md.x[neg].max() / 1e3)]
                             if neg.any() else None)}
    return row


def artesian_summary(rows, conv, spin, sample_days=10):
    """suite_artesian's headline numbers over its window rows."""
    frac = np.array([r["frac_neg"] for r in rows])
    wm = np.array([r["winmean_MPa"] for r in rows])
    imin = int(np.argmin([r["N_min_MPa"] for r in rows]))
    return {"case": "D5", "spin_years": spin, "converged": bool(conv),
            "samples_days": sample_days,
            "days_any_neg": int((frac > 0).sum()) * sample_days,
            "days_winmean_neg": int((wm < 0).sum()) * sample_days,
            "frac_neg_max": float(frac.max()),
            "N_min_MPa": rows[imin]["N_min_MPa"],
            "min_over_pi": float(min(r["min_over_pi"] for r in rows)),
            "worst_day": rows[imin]["day"],
            "x_neg_km_at_worst": rows[imin]["x_neg_km"],
            "rows": rows}


def run_e_case(case, years=1.0, nt_per_day=24, resolution=75.0, device=None,
               ck=None, max_wall=None, save_days=30):
    """Suite E: the valley glacier under steady input, hourly steps (saved
    each ``save_days``), steadiness as the relative change of N over the
    final 30 days, and the certified budget (diag.certified_budget: the
    capped terminus rows turn per-step gap flicker into O(100 m^3/s) of
    reaction noise otherwise).  Returns (md, state, steady_rel, conv, Q_out,
    Q_src)."""
    md, mesh, static, state, cfg, step, cp = _setup(
        case, device, ck, max_wall, days=365 * years,
        nt_per_day=nt_per_day, resolution=resolution)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype,
                         device=static.dirichlet.device)
    nt = dts.shape[0]
    i0 = max(nt - 30 * nt_per_day, 0)
    W = max(1, int(save_days * nt_per_day))
    state, i, prog = cp.load(state, {"conv": True})
    state = march(step, state, dts, i, i0, W, cp, prog)
    if "N_before" not in prog:
        prog["N_before"] = md.to_user_order(state.N).tolist()
    state = march(step, state, dts, max(i, i0), nt, W, cp, prog)
    N_before = np.asarray(prog["N_before"])
    N_after = md.to_user_order(state.N)
    steady_rel = float(np.linalg.norm(N_after - N_before)
                       / np.linalg.norm(N_after))
    Q_out, Q_src, info = diag.certified_budget(mesh, static, state,
                                               md.params, cfg)
    return md, state, steady_rel, prog["conv"] and info["converged"], \
        Q_out, Q_src


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

def suite_A(out, quick, device=None, cases=None, ck=None, max_wall=None):
    """A1, A3 and A5 (``cases``: a subset) for their years, each case's
    rows saved after every year (``"complete": False`` until its last).
    A5's final y-mean N profile goes to A5_FINAL for suite B."""
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
        try:
            md, state, p, yearly, Q_out, Q_src = run_case(
                case, years, device=device, on_year=partial, ck=ck,
                max_wall=max_wall)
        except Stopped:
            continue
        if case == "A5":
            A5 = (md, state)
            xs, prof = ymean_profile(md, md.to_user_order(state.N))
            os.makedirs(os.path.dirname(A5_FINAL), exist_ok=True)
            np.savez(A5_FINAL, xs=xs, prof=prof, years=years)
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


# ------------------------------------------------------------ suites B-F

SEGMENT = {}    # the running case's resume point: CaseCheckpoint.load


def _done(out, case, force):
    r = out.get(case)
    if r and r.get("complete", True) and not force:
        print(f"{case}: cached, skipping (--force re-runs)", flush=True)
        return True
    return False


def _row(case, device, t0, steps, **kw):
    """A case's row: ``kw`` plus the wall time, ms per step of this
    process's steps, the launches and the card."""
    start = SEGMENT.get("from", 0)
    wall = time.time() - t0
    return dict(kw, complete=True, steps=steps, resumed_from=start,
                wall_s=round(wall, 1),
                ms_per_step=1e3 * wall / max(steps - start, 1),
                launches=dict(spmv_cuda.launches),
                card=_card(device or DEVICE))


def _stopped(out, case, stop, steps, device, t0):
    out[case] = {"complete": False, "steps_done": stop.args[0],
                 "steps": steps, "resumed_from": SEGMENT.get("from", 0),
                 "wall_s": round(time.time() - t0, 1),
                 "card": _card(device or DEVICE)}
    _save_cache(out)
    print(f"{case}: stopped at step {stop.args[0]} of {steps}", flush=True)


def _imbalance(Q_out, Q_src):
    return abs(Q_out - Q_src) / max(abs(Q_src), 1e-30)


def _run(out, case, steps, device, fn, force):
    """``fn()`` -> row for ``case`` unless cached; a Stopped case leaves an
    incomplete row.  Returns whether the case ran to its end."""
    if _done(out, case, force):
        return False
    t0 = time.time()
    spmv_cuda.reset_launches()
    SEGMENT.clear()
    try:
        row = fn(t0)
    except Stopped as e:
        _stopped(out, case, e, steps, device, t0)
        return False
    out[case] = row
    _save_cache(out)
    print(f"{case}: {json.dumps(row)}", flush=True)
    return True


def suite_B(out, quick, device=None, cases=None, ck=None, max_wall=None,
            force=False):
    """B1-B5 for 5 years (2 quick), each row with its y-mean N profile;
    relN_vs_A5 against A5_FINAL is derived at each save.  B5's final
    state goes to B5_FINAL for suite C."""
    years = 2 if quick else 5
    for case in CASE_ORDER["B"]:
        if cases is not None and case not in cases:
            continue

        def one(t0, case=case):
            md, state, Q_out, Q_src, conv = run_b_case(
                case, years, device=device, ck=ck, max_wall=max_wall)
            if case == "B5":
                os.makedirs(B5_FINAL, exist_ok=True)
                save_state(B5_FINAL, state, md.timesteps.size, 0,
                           include_lag=False)
            N = md.to_user_order(state.N)
            win = (md.x > WINDOW[0]) & (md.x < WINDOW[1])
            xs, prof = ymean_profile(md, N)
            return _row(case, device, t0, md.timesteps.size,
                        moulins=shmip.CASES_B[case], years=years,
                        winN_MPa=float(N[win].mean() / 1e6),
                        ymean_N=prof.tolist(), Q_out=Q_out, Q_src=Q_src,
                        imbalance=_imbalance(Q_out, Q_src), converged=conv)
        _run(out, case, 365 * years * 4, device, one, force)


def load_b5(device=None):
    """B5's final marching state (suite C's start), from B5_FINAL."""
    got = load_state(B5_FINAL, dtype=torch.float64,
                     device=device or DEVICE, include_lag=False)
    if got is None:
        raise SystemExit(f"suite C needs B5's final state in {B5_FINAL}: "
                         "run suite B's B5 first")
    return got[0]


def suite_C(out, quick, B5_state=None, device=None, cases=None,
            force=False):
    """C1-C4, 10 days (6 quick) at 48 steps a day from B5's final state."""
    days = 6 if quick else 10
    for case in CASE_ORDER["C"]:
        if cases is not None and case not in cases:
            continue

        def one(t0, case=case):
            b5 = B5_state if B5_state is not None else load_b5(device)
            md, m = run_c_case(case, b5, days=days, device=device)
            return _row(case, device, t0, md.timesteps.size, days=days, **m)
        _run(out, case, days * 48, device, one, force)


def suite_D(out, quick, device=None, cases=None, ck=None, max_wall=None,
            force=False):
    """D1-D5: 3 years' spin (1 quick), then the final year sampled every
    10 days.  D5's run also gives the artesian study X (``artesian_D5``):
    its sampling windows are suite_artesian's."""
    spin = 1 if quick else 3
    for case in CASE_ORDER["D"]:
        if cases is not None and case not in cases:
            continue

        def one(t0, case=case):
            rows = [] if case == "D5" else None
            md, state, samples, conv, Q_out, Q_src = run_seasonal_case(
                case, spin_years=spin, device=device, ck=ck,
                max_wall=max_wall, artesian=rows)
            if rows is not None:
                out["artesian_D5"] = dict(
                    artesian_summary(rows, conv, spin), complete=True,
                    from_run="D5", wall_s=round(time.time() - t0, 1))
                print(f"artesian_D5: {json.dumps(out['artesian_D5'])}",
                      flush=True)
            return _row(case, device, t0, md.timesteps.size,
                        dT=shmip.CASES_D[case], spin_years=spin,
                        N_winter_MPa=float(samples.max() / 1e6),
                        N_summer_min_MPa=float(samples.min() / 1e6),
                        N_amp_MPa=float((samples.max() - samples.min())
                                        / 1e6),
                        Q_out=Q_out, Q_src=Q_src,
                        imbalance=_imbalance(Q_out, Q_src), converged=conv)
        _run(out, case, 365 * (spin + 1) * 4, device, one, force)


def suite_E(out, quick, device=None, cases=None, ck=None, max_wall=None,
            force=False):
    """E1-E5: a year (half quick) of hourly steps on the valley.  E1's final
    state (user order) goes to E1_FINAL for the stationarity leg."""
    years = 0.5 if quick else 1.0
    for case in CASE_ORDER["E"]:
        if cases is not None and case not in cases:
            continue

        def one(t0, case=case):
            md, state, steady_rel, conv, Q_out, Q_src = run_e_case(
                case, years=years, device=device, ck=ck, max_wall=max_wall)
            N = md.to_user_order(state.N)
            if case == "E1":
                os.makedirs(os.path.dirname(E1_FINAL), exist_ok=True)
                np.savez(E1_FINAL, xy=np.stack([md.x, md.y], axis=1), N=N,
                         b=md.to_user_order(state.b), years=years)
            trough = (md.x > 2e3) & (md.x < 4e3)
            return _row(case, device, t0, md.timesteps.size,
                        para=shmip.CASES_E[case], years=years,
                        n_nodes=int(md.x.size),
                        N_mean_MPa=float(N.mean() / 1e6),
                        N_trough_MPa=float(N[trough].mean() / 1e6),
                        b_trough_mm=float(
                            md.to_user_order(state.b)[trough].mean() * 1e3),
                        steady_rel_30d=steady_rel, Q_out=Q_out, Q_src=Q_src,
                        imbalance=_imbalance(Q_out, Q_src), converged=conv)
        _run(out, case, int(365 * years * 24), device, one, force)


def suite_F(out, quick, device=None, cases=None, ck=None, max_wall=None,
            force=False):
    """F1-F5: a year's spin (none quick), then the final year's glacier-mean
    N sampled every 10 days, hourly steps on the valley."""
    spin = 0 if quick else 1
    for case in CASE_ORDER["F"]:
        if cases is not None and case not in cases:
            continue

        def one(t0, case=case):
            md, state, samples, conv, Q_out, Q_src = run_seasonal_case(
                case, spin_years=spin, nt_per_day=24, device=device, ck=ck,
                max_wall=max_wall)
            return _row(case, device, t0, md.timesteps.size,
                        dT=shmip.CASES_F[case], spin_years=spin,
                        N_winter_MPa=float(samples.max() / 1e6),
                        N_summer_min_MPa=float(samples.min() / 1e6),
                        N_amp_MPa=float((samples.max() - samples.min())
                                        / 1e6),
                        converged=conv)
        _run(out, case, 365 * (spin + 1) * 24, device, one, force)


def suite_X(out, quick, force=False, device=None, ck=None, max_wall=None):
    """The artesian study of D5 (the JAX script's suite_artesian): taken
    from D5's own run (suite_D writes ``artesian_D5`` beside D5's row), so
    D5 runs again only when that row is missing or ``force``."""
    r = out.get("artesian_D5")
    if r and r.get("complete") and not force:
        return
    suite_D(out, quick, device=device, cases=("D5",), ck=ck,
            max_wall=max_wall, force=True)


def derive(out):
    """What rows of several cases give, recomputed at every save: B's
    relN_vs_A5 (against A5_FINAL, when there), the monotonic flags of C,
    D and F (when all their cases ran to the end), and every B-F row's
    checks against the JAX package's."""
    jax = _jax_cache()
    a5 = None
    if os.path.exists(A5_FINAL):
        with np.load(A5_FINAL) as z:
            a5 = z["xs"], z["prof"]
    for case in CASE_ORDER["B"]:
        r = out.get(case)
        if r and r.get("complete") and a5 is not None:
            xs, prof_a5 = a5
            w = (xs > WINDOW[0]) & (xs < WINDOW[1])
            prof = np.asarray(r["ymean_N"])
            r["relN_vs_A5"] = float(np.linalg.norm(prof[w] - prof_a5[w])
                                    / np.linalg.norm(prof_a5[w]))
    for suite in "CDF":
        rows = [out.get(c) for c in CASE_ORDER[suite]]
        flag = f"{suite}_amplitude_monotonic"
        if all(r and r.get("complete") for r in rows):
            amps = [r["N_amp_MPa"] for r in rows]
            out[flag] = bool(np.all(np.diff(amps) > 0))
        else:
            out.pop(flag, None)
            out.pop(flag + "_as_jax", None)
    for suite in "BCDEF":
        for case in CASE_ORDER[suite]:
            r = out.get(case)
            if r and r.get("complete"):
                r["checks"] = bf_checks(suite, r, jax.get(case))
        flag = f"{suite}_amplitude_monotonic"
        if flag in out and flag in jax:
            out[flag + "_as_jax"] = out[flag] == jax[flag]
    x = out.get("artesian_D5")
    if x and x.get("complete") and jax.get("artesian_D5"):
        x["checks"] = x_checks(x, jax["artesian_D5"])
    # the oracle legs' fw_*/rel_* fields from the port's rows as they stand
    for prefix, cases, compare in (("OT_", ("C2", "C4"), ot_c_compare),
                                   ("OT_", ("D1", "D3", "D5"), ot_d_compare),
                                   ("OV_", CASE_ORDER["E"], ov_compare)):
        for c in cases:
            r, fw = out.get(prefix + c), out.get(c)
            if r and fw and fw.get("complete"):
                r.update(compare(r, fw))


# X against the JAX package's artesian_D5: the headline numbers within
# X_RTOL relative, the day counts and the worst day equal
X_RTOL = 1e-3


def x_checks(row, ref):
    c = {k: bool(abs(row[k] - ref[k]) <= X_RTOL * abs(ref[k]))
         for k in ("frac_neg_max", "N_min_MPa", "min_over_pi")}
    c.update({k: row[k] == ref[k] for k in ("worst_day", "days_any_neg",
                                             "days_winmean_neg")})
    c["converged"] = bool(row["converged"])
    return c


def bf_checks(suite, row, ref):
    """Converged; at the full length (BF_FULL, the length of every row of
    scripts/shmip_results.json), against the JAX package's row: each
    of BF_KEYS[suite] within BF_RTOL relative (``*_digits``: the
    significant digits they share), the imbalance to two digits or below
    BF_TINY where JAX's is below it."""
    c = {"converged": bool(row["converged"])}
    key, full = BF_FULL[suite]
    if not ref or row.get(key) != full:
        return c
    for k in BF_KEYS[suite]:
        a, b = row.get(k), ref.get(k)
        if a is None or b is None:
            continue
        c[k] = bool(abs(a - b) <= BF_RTOL * abs(b))
        c[k + "_digits"] = shared_digits(a, b)
    if "imbalance" in row and "imbalance" in ref:
        a, b = row["imbalance"], ref["imbalance"]
        c["imbalance"] = bool(a < BF_TINY if b < BF_TINY
                              else f"{a:.1e}" == f"{b:.1e}")
    return c


def shared_digits(a, b):
    """The number of leading significant digits a and b print alike."""
    for d in range(15, 0, -1):
        if f"{a:.{d - 1}e}" == f"{b:.{d - 1}e}":
            return d
    return 0


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
    derive(out)
    with open(CACHE, "w") as f:
        json.dump(dict(out), f, indent=1)
    with open(MD_OUT, "w") as f:
        f.write("\n".join(build_md(out)) + "\n")


# Per-case polish budgets: (max_newton_total, patience, max_wall_s), the
# JAX script's (shmip_validate.py S_POLISH_BUDGET), and its run order
S_POLISH_BUDGET = {
    "A1": (6000, 3, 1800.0), "A2": (6000, 3, 1800.0),
    "A3": (40000, 30, 7200.0), "A4": (40000, 30, 7200.0),
    "A5": (40000, 30, 7200.0), "A6": (16000, 10, 3600.0)}
S_ORDER = ("A1", "A2", "A3", "A6", "A4", "A5")
# A2-A6, stated before their first run: polish_resN at most S_RESN, and
# relN_win/relb_win against the JAX package's within S_A2_ATOL absolute (A2,
# a uniform sheet) or S_CHANNEL_RTOL relative (A3-A6, channelized: their
# equilibria depend on the march's path, and the port marches in block-ELL
# where the JAX package's rows were marched in scalar ELL)
S_RESN, S_A2_ATOL, S_CHANNEL_RTOL = 1e-9, 1e-4, 0.10


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


def s_checks(row, ref, case="A1"):
    """Verdict polished, imbalance <= S_IMBALANCE and, against the JAX
    package's row: for A1 PTC steps within S_PTC_RTOL, polish Newton within
    S_POLISH_NEWTON, relN_win within S_RELN_ATOL; for A2-A6 polish_resN <=
    S_RESN and relN_win, relb_win within S_A2_ATOL (A2) or S_CHANNEL_RTOL
    relative (A3-A6).  The polish counts of A2-A6 are reported, not
    checked: the two packages march in different operator formats."""
    c = {"polished": row["verdict"] == "polished",
         "imbalance": bool(row["imbalance"] <= S_IMBALANCE)}
    if case != "A1":
        c["polish_resN"] = bool(row["polish_resN"] <= S_RESN)
        if ref:
            for k in ("relN_win", "relb_win"):
                tol = (S_A2_ATOL if case == "A2"
                       else S_CHANNEL_RTOL * abs(ref[k]))
                c[k] = bool(abs(row[k] - ref[k]) <= tol)
        return c
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


def _s_progress(ckd):
    """(PTC steps, polish Newton iterations) saved under ``ckd``."""
    got = [0, 0]
    for i, (name, key) in enumerate(((PTC_FILE, "k"),
                                     (POLISH_FILE, "newton"))):
        path = None if ckd is None else os.path.join(ckd, name)
        if path and os.path.exists(path):
            with np.load(path) as z:
                got[i] = int(z[key])
    return got


def suite_S(out, quick, force=False, cases=None, budget_override=None,
            device=None, ck=None, max_wall=None):
    """Suite S for A1-A6: solve_steady(polish=True) with the JAX script's
    call and per-case budget, judged against the 1D oracle as suite A is.
    A complete cached case is skipped unless ``force``.  ``ck``: the march
    and the polish save their state under ck/S_<case>/ and resume there;
    ``max_wall`` stops the case (row ``"complete": False`` with its
    progress).  Each row records whether the polish's own wall-clock cap
    stopped it (``polish_wall_capped``)."""
    print("== suite S: direct steady solves of A1-A6 ==", flush=True)
    from torch_cooke2_report import WallLimit, wall_limit
    tol = 1e-2 if quick else 1e-3
    max_steps = 6000 if quick else 30000
    jax = _jax_cache()
    for case in S_ORDER:
        key = "S_" + case
        if cases is not None and case not in cases:
            continue
        if out.get(key, {}).get("complete", True) and key in out \
                and not force:
            print(f"{key}: cached, skipping (--force re-runs)", flush=True)
            continue
        t0 = time.time()
        md = shmip.initialize(case, nx=60, ny=12, days=30, nt_per_day=24)
        md.device, md.dtype = device or DEVICE, torch.float64
        budget = budget_override or S_POLISH_BUDGET[case]
        if quick:
            budget = (6000, 3, 900.0)
        ckd = None if ck is None else os.path.join(ck, key)
        start = _s_progress(ckd)
        spmv_cuda.reset_launches()
        stopped = False
        try:
            with wall_limit(max_wall):
                res = md.solve_steady(
                    tol=tol, max_steps=max_steps, strict=False, polish=True,
                    polish_max_newton=budget[0], polish_patience=budget[1],
                    polish_max_wall_s=budget[2],
                    cycle_window=150 if quick else 400, checkpoint=ckd)
        except WallLimit:
            stopped = True
        seg = {"from": start,
               "to": _s_progress(ckd) if stopped else [
                   res["info"]["steps"], res["info"].get("polish_newton", 0)],
               "wall_s": round(time.time() - t0, 1),
               "launches": dict(spmv_cuda.launches),
               "card": _card(device or DEVICE)}
        segs = list(out.get(key, {}).get("segments", [])) \
            if not out.get(key, {}).get("complete", True) else []
        segs.append(seg)
        if stopped:
            out[key] = {"complete": False, "ptc_steps_done": seg["to"][0],
                        "polish_newton_done": seg["to"][1],
                        "max_steps": max_steps, "budget": list(budget),
                        "segments": segs, "card": seg["card"]}
            _save_cache(out)
            print(f"{key}: stopped at PTC step {seg['to'][0]}, polish "
                  f"Newton {seg['to'][1]}", flush=True)
            continue
        m = s_row(md, res, case, tol, max_steps, quick, t0)
        info = res["info"]
        # the polish keeps its file on a wall-clock or Newton-budget exit
        m["polish_wall_capped"] = bool(
            ckd is not None and not info.get("polish_converged", False)
            and os.path.exists(os.path.join(ckd, POLISH_FILE))
            and info.get("polish_newton", 0) < budget[0])
        m.update(complete=True, budget=list(budget), segments=segs,
                 launches=dict(spmv_cuda.launches),
                 card=_card(device or DEVICE))
        if len(segs) > 1:
            m["wall_s"] = round(sum(g["wall_s"] for g in segs), 1)
        m["checks"] = s_checks(m, jax.get(key), case)
        out[key] = m
        _save_cache(out)
        print(f"{key}: {json.dumps(m)}", flush=True)


# ------------------------------------------------------------ oracle legs
# The FV oracle (oracle/shmip_fv2d.py) shares no code with either package:
# its own fields are the same scipy code on the same inputs as the JAX
# package's rows.  A leg whose JAX row holds them for equal oracle inputs
# takes them from there and says so (``oracle_from``); only its fw_*/rel_*
# fields, which read the port's rows, are computed.


def _oracle_cached(key, jax, want, rerun):
    """JAX's row ``key`` if it was computed from the oracle inputs
    ``want`` (a dict), else None (and always None with ``rerun``)."""
    r = jax.get(key)
    if rerun or not r or any(r.get(k) != v for k, v in want.items()):
        return None
    return r


def _want(cases, case):
    return cases is None or case in cases


def _fv():
    import oracle.shmip_fv2d as fv2d
    return fv2d


def suite_O(out, quick, force=False, cases=None):
    """The oracle triangle: the FV column Newton against the 1D oracle for
    A1-A6 (``O_ladder``), and the FV 2D marches of A3 and A5 (``O_stab_*``
    from the uniform branch with 10 % gap noise, ``O_march_*`` from the
    FEM transient's cold-noise start).  No FEM enters these rows; they are
    the JAX script's suite_O on the same inputs.  ``cases`` limits the
    march legs (A3, A5)."""
    print("== suite O: oracle triangle (1D shooting / 2D FV / FEM) ==",
          flush=True)
    fv2d = _fv()
    nx = 100 if quick else 200
    if "O_ladder" not in out or force:
        t0 = time.time()
        out["O_ladder"] = {"nx": nx, "rows": o_ladder_rows(fv2d, nx),
                           "wall_s": round(time.time() - t0, 1)}
        _save_cache(out)
    for case, years in (("A3", 3.0), ("A5", 3.0)):
        need = [k for k in ("O_stab_" + case, "O_march_" + case)
                if _want(cases, case) and (k not in out or force)]
        if not need:
            continue
        u = fv2d.steady_column_newton(case, nx=60)
        assert u["converged"], (case, "uniform baseline did not converge")
        for k in need:
            t0 = time.time()
            if k.startswith("O_stab_"):
                m = fv2d.march(case, nx=60, ny=12,
                               years=1.0 if quick else 2.0, noise=0.10,
                               b_init=u["b"], N_init=u["N"], seed=0)
            else:
                m = fv2d.march(case, nx=60, ny=12,
                               years=2.0 if quick else years, seed=0)
            out[k] = dict(o_march_metrics(m, u),
                          wall_s=round(time.time() - t0, 1))
            _save_cache(out)
            print(f"{k}: {json.dumps(out[k])}", flush=True)


def o_ladder_rows(fv2d, nx):
    """O_ladder's rows: the FV column Newton ladder at ``nx`` against the
    1D oracle over the window."""
    rows = {}
    for case, r in fv2d.solve_ladder(nx=nx).items():
        p = steady_profile(case)
        win = (r["x"] > WINDOW[0]) & (r["x"] < WINDOW[1])
        No = np.interp(r["x"], p["x"], p["N"])
        bo = np.interp(r["x"], p["x"], p["b"])
        rows[case] = {
            "converged": bool(r["converged"]), "newton": int(r["newton"]),
            "relN_fv_1d": float(np.linalg.norm(r["N"][win] - No[win])
                                / np.linalg.norm(No[win])),
            "relb_fv_1d": float(np.linalg.norm(r["b"][win] - bo[win])
                                / np.linalg.norm(bo[win]))}
        print(f"O_{case}: {json.dumps(rows[case])}", flush=True)
    return rows


def o_march_metrics(m, u):
    """An FV march's window deviation from the uniform branch ``u``."""
    win = (m["x"] > WINDOW[0]) & (m["x"] < WINDOW[1])
    Nu = np.interp(m["x"], u["x"], u["N"])
    bu = np.interp(m["x"], u["x"], u["b"])
    return {"years": m["t_years"], "steps": m["steps"],
            "yspread_N": float(m["yspread_N"]),
            "frac_b_floor": float(m["frac_b_floor"]),
            "relN_march_uniform": float(np.linalg.norm(m["N"][win] - Nu[win])
                                        / np.linalg.norm(Nu[win])),
            "relb_march_uniform": float(np.linalg.norm(m["b"][win] - bu[win])
                                        / np.linalg.norm(bu[win]))}


# make_forcing's degree-day period, a day of it, and fv2d.march's year
T_YR, YEAR_FV = 3.154e7, 3.1536e7
DAY_FW = T_YR / 365.0


def ot_d_oracle(fv2d, case, nx, ny, spin=3):
    """The FV march of suite D's ``case`` on an nx x ny grid: ``spin``
    forced years, then the final year's window-mean N every 10 days (the
    JAX script's suite_OT D leg).  Returns its oracle fields."""
    ddf, lapse = 0.01 / 86400.0, 0.0075
    base, dT = shmip.CASES_A["A1"], shmip.CASES_D[case]
    zs2 = np.broadcast_to(
        fv2d.surface((np.arange(nx) + 0.5) * (fv2d.LX / nx))[None, :],
        (ny, nx))

    def inp(t):
        temp = -5.0 - 16.0 * np.cos(2.0 * np.pi * t / T_YR) + dT
        return base + np.maximum(0.0, ddf * temp - ddf * lapse * zs2)
    days = np.r_[10.0 * (np.arange(36) + 1), 365.0]
    m = fv2d.march(case, nx=nx, ny=ny,
                   years=(spin + 1) * T_YR / YEAR_FV + 0.01,
                   dt_max=DAY_FW / 2.0, seed=0, input_rate=inp,
                   sample_times=spin * T_YR + DAY_FW * days,
                   rel_pctile=98.0, verbose=500)
    s, smin = m["samples"], m["samples_min"]
    return {"dT": dT, "grid": [nx, ny], "spin_years": spin,
            "steps": m["steps"], "N_winter_MPa": float(s.max() / 1e6),
            "N_summer_min_MPa": float(s.min() / 1e6),
            "N_amp_MPa": float((s.max() - s.min()) / 1e6),
            "N_cellmin_MPa": float(smin.min() / 1e6)}


def ot_d_compare(fv, fw):
    """OT_D's fw_*/rel_* fields: the FV row ``fv`` against the port's D
    row ``fw``."""
    return {"fw_N_winter_MPa": fw["N_winter_MPa"],
            "fw_N_summer_min_MPa": fw["N_summer_min_MPa"],
            "fw_N_amp_MPa": fw["N_amp_MPa"],
            "rel_amp_err": abs(fv["N_amp_MPa"] - fw["N_amp_MPa"])
            / max(abs(fw["N_amp_MPa"]), 1e-12),
            "rel_winter_err": abs(fv["N_winter_MPa"] - fw["N_winter_MPa"])
            / max(abs(fw["N_winter_MPa"]), 1e-12),
            "summer_sign_agrees": bool((fv["N_summer_min_MPa"] < 0)
                                       == (fw["N_summer_min_MPa"] < 0))}


def ot_c_field(fv2d, nx=60, ny=12):
    """Suite C's B5 moulin input on the FV grid (A1 background plus each
    moulin's rate in its cell)."""
    dxc, dyc = fv2d.LX / nx, fv2d.LY / ny
    field = np.full((ny, nx), shmip.CASES_A["A1"])
    rate = shmip.B_TOTAL_M3S / shmip.CASES_B["B5"]
    for (mx, my) in shmip.moulin_positions(shmip.CASES_B["B5"],
                                           fv2d.LX, fv2d.LY):
        field[min(int(my / dyc), ny - 1),
              min(int(mx / dxc), nx - 1)] += rate / (dxc * dyc)
    return field


def ot_c_oracle(fv2d, case, field, spin_state, c_days, nx=60, ny=12):
    """The FV march of suite C's ``case`` from ``spin_state`` (b2d, N2d)
    for ``c_days``, the window-mean N every 30 min of the final two days.
    Returns its oracle fields."""
    Ra = shmip.CASES_C[case]

    def inp_c(t):
        return field * max(0.0, 1.0 + Ra * np.sin(
            2.0 * np.pi * t / shmip.DAY_S))
    samp = (c_days - 2) * 86400.0 + 1800.0 * (np.arange(96) + 1)
    m = fv2d.march(case, nx=nx, ny=ny,
                   years=c_days * 86400.0 / YEAR_FV + 1e-4, dt0=900.0,
                   dt_max=1800.0, noise=0.0, b_init=spin_state[0],
                   N_init=spin_state[1], seed=0, input_rate=inp_c,
                   sample_times=samp, rel_pctile=98.0, verbose=500)
    s = m["samples"]
    return {"Ra": Ra, "grid": [nx, ny], "steps": m["steps"],
            "N_mean_cycle": float(s.mean()),
            "N_amp_MPa": float((s.max() - s.min()) / 1e6)}


def ot_c_compare(fv, fw):
    return {"fw_N_mean_cycle": fw["N_mean_cycle"],
            "fw_N_amp_MPa": fw["N_amp_MPa"],
            "rel_amp_err": abs(fv["N_amp_MPa"] - fw["N_amp_MPa"])
            / max(abs(fw["N_amp_MPa"]), 1e-12)}


def suite_OT(out, quick, force=False, cases=None, rerun=False):
    """The FV march under suite D's seasonal forcing (D1, D3, D5) and
    suite C's diurnal scaling of B5's moulins (C2, C4), against the port's
    complete rows of those cases.  The D legs' FV fields come from the
    JAX package's row where its inputs are equal (ORACLE_INPUTS), unless
    ``rerun``; the C legs (minutes) always run."""
    fv2d = _fv()
    jax = _jax_cache()
    for case in ("D1", "D3", "D5"):
        key = "OT_" + case
        if not _want(cases, case) or (key in out and not force) \
                or not out.get(case, {}).get("complete"):
            continue
        nx, ny = (60, 12) if quick else (100, 20)
        t0 = time.time()
        want = {"dT": shmip.CASES_D[case], "grid": [nx, ny],
                "spin_years": 3}
        got = _oracle_cached(key, jax, want, rerun)
        if got is not None:
            fv = {k: got[k] for k in ("dT", "grid", "spin_years", "steps",
                                      "N_winter_MPa", "N_summer_min_MPa",
                                      "N_amp_MPa", "N_cellmin_MPa")}
            fv["oracle_from"] = "scripts/shmip_results.json " + key
        else:
            fv = ot_d_oracle(fv2d, case, nx, ny)
        out[key] = dict(fv, **ot_d_compare(fv, out[case]),
                        wall_s=round(time.time() - t0, 1))
        _save_cache(out)
        print(f"{key}: {json.dumps(out[key])}", flush=True)
    spin_state = None
    field = ot_c_field(fv2d)
    for case in ("C2", "C4"):
        key = "OT_" + case
        if not _want(cases, case) or (key in out and not force) \
                or not out.get(case, {}).get("complete"):
            continue
        spin_years, c_days = (2.0, 6) if quick else (3.0, 10)
        if spin_state is None:
            t0 = time.time()
            sp = fv2d.march(case, nx=60, ny=12, years=spin_years,
                            dt_max=2 * 86400.0, seed=0,
                            input_rate=lambda t: field, rel_pctile=98.0,
                            verbose=500)
            spin_state = (sp["b2d"], sp["N2d"])
            print(f"OT_C spin: {sp['steps']} steps "
                  f"{round(time.time() - t0, 1)} s", flush=True)
        t0 = time.time()
        fv = ot_c_oracle(fv2d, case, field, spin_state, c_days)
        out[key] = dict(fv, **ot_c_compare(fv, out[case]),
                        spin_years=spin_years, days=c_days,
                        wall_s=round(time.time() - t0, 1))
        _save_cache(out)
        print(f"{key}: {json.dumps(out[key])}", flush=True)


OV_SKIP = ("N2d", "b2d", "mask", "thick", "xc")


def ov_compare(fv, fw):
    """OV_E's fw_*/rel_* fields: the FV valley row against the port's E
    row."""
    return {"fw_N_mean_MPa": fw["N_mean_MPa"],
            "fw_N_trough_MPa": fw["N_trough_MPa"],
            "fw_b_trough_mm": fw["b_trough_mm"],
            "rel_trough_err": abs(fv["N_trough_MPa"] - fw["N_trough_MPa"])
            / max(abs(fw["N_trough_MPa"]), 1e-12),
            "rel_mean_err": abs(fv["N_mean_MPa"] - fw["N_mean_MPa"])
            / max(abs(fw["N_mean_MPa"]), 1e-12)}


def suite_OV(out, quick, force=False, cases=None, rerun=False):
    """The FV valley (oracle/shmip_fv2d.valley_steady, a warm-started
    ladder E1 -> E5) against the port's complete E rows, the trend over
    all five, the stationarity leg (scripts/torch_valley_stationarity.json,
    folded in) and the cap sensitivity of E5 (``OV_cap``, FV alone; with
    E5 among ``cases``).  Each case computed here warm-starts the next,
    as in the JAX script; E1's FV fields (a cold start) come from the JAX
    package's row where its grid is equal, unless ``rerun``, and then the
    next case starts cold, as the JAX script's does after a cached E1."""
    fv2d = _fv()
    jax = _jax_cache()
    nx, ny = (48, 12) if quick else (60, 16)
    years = 3.0
    ecases = CASE_ORDER["E"]
    x0 = None       # the FV state of the last case computed here
    for case in ecases:
        key = "OV_" + case
        if not _want(cases, case) or (key in out and not force) \
                or not out.get(case, {}).get("complete"):
            continue
        t0 = time.time()
        # only the first case starts cold in both packages
        got = _oracle_cached(key, jax, {"para": shmip.CASES_E[case],
                                        "grid_nx_ny": [nx, ny]},
                             rerun) if x0 is None and case == "E1" else None
        if got is not None:
            fv = {k: v for k, v in got.items()
                  if not k.startswith(("fw_", "rel_")) and k != "wall_s"}
            fv["oracle_from"] = "scripts/shmip_results.json " + key
        else:
            r = fv2d.valley_steady(shmip.CASES_E[case], nx=nx, ny=ny,
                                   years=years, x0=x0)
            x0 = (r["N2d"], r["b2d"])
            fv = {k: v for k, v in r.items() if k not in OV_SKIP}
        out[key] = dict(fv, **ov_compare(fv, out[case]),
                        wall_s=round(time.time() - t0, 1))
        _save_cache(out)
        print(f"{key}: {json.dumps(out[key])}", flush=True)
    if all("OV_" + c in out for c in ecases):
        tr = [out["OV_" + c]["N_trough_MPa"] for c in ecases]
        fw_tr = [out["OV_" + c]["fw_N_trough_MPa"] for c in ecases]
        out["OV_trend"] = {
            "oracle_trough_MPa": tr, "fw_trough_MPa": fw_tr,
            "oracle_monotonic": bool(np.all(np.diff(tr) > 0)),
            "fw_monotonic": bool(np.all(np.diff(fw_tr) > 0))}
        _save_cache(out)
        print(f"OV_trend: {json.dumps(out['OV_trend'])}", flush=True)
    if os.path.exists(STATIONARITY) and ("OV_stationarity" not in out
                                         or force):
        with open(STATIONARITY) as f:
            out["OV_stationarity"] = json.load(f)
        _save_cache(out)
    if _want(cases, "E5") and ("OV_cap" not in out or force):
        t0 = time.time()
        r1 = fv2d.valley_steady(shmip.CASES_E["E5"], nx=nx, ny=ny,
                                years=years, b_cap=0.5, x0=x0)
        r2 = fv2d.valley_steady(shmip.CASES_E["E5"], nx=nx, ny=ny,
                                years=years, b_cap=2.0, x0=x0)
        interior = r1["mask"] & (r1["thick"] >= 50.0)
        dN = (np.linalg.norm(r1["N2d"][interior] - r2["N2d"][interior])
              / np.linalg.norm(r1["N2d"][interior]))
        out["OV_cap"] = {
            "case": "E5", "caps_m": [0.5, 2.0],
            "relN_interior": float(dN),
            "frac_cap_05": r1["frac_cap"], "frac_cap_20": r2["frac_cap"],
            "N_trough_MPa_05": r1["N_trough_MPa"],
            "N_trough_MPa_20": r2["N_trough_MPa"],
            "wall_s": round(time.time() - t0, 1)}
        _save_cache(out)
        print(f"OV_cap: {json.dumps(out['OV_cap'])}", flush=True)


# ------------------------------------------------------------- SHMIP_TORCH.md

def _g(v, fmt=".4g"):
    return "—" if v is None else format(v, fmt)


def build_md(out):
    jax = _jax_cache()
    lines = [
        "# SHMIP_TORCH — SHMIP suites A to F, S, the oracle legs and X on "
        "the port",
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
    return lines + s_md(out, jax) + bf_md(out, jax) + oracle_md(out, jax)


def s_md(out, jax):
    """SHMIP_TORCH.md's suite S table: A1-A6 beside JAX's rows."""
    rows = [(c, out.get("S_" + c), jax.get("S_" + c, {})) for c in
            ("A1", "A2", "A3", "A4", "A5", "A6") if "S_" + c in out]
    if not rows:
        return []
    cards = sorted({r["card"] for _, r, _ in rows if r.get("card")})
    lines = [
        "", "## Suite S (solve_steady with the polish, the JAX script's "
        "call and budgets" + (f"; on {', '.join(cards)}" if cards else "")
        + ")", "",
        "The port marches in block-ELL; the JAX package's rows were marched "
        "on the CPU in scalar ELL, so the PTC and polish counts are set "
        "side by side, not checked (A1 keeps its PR 11 checks).", "",
        "| case | verdict port | JAX | PTC steps port | JAX | polish Newton "
        "port | JAX | polish wall-capped | polish_resN port | relN_win port "
        "| JAX | relb_win port | JAX | imbalance port | JAX | wall [s] |",
        "|" + "---|" * 16]
    for c, r, j in rows:
        if not r.get("complete", True):
            lines.append(
                f"| {c} | **not run to the end**: PTC step "
                f"{r['ptc_steps_done']} of {r['max_steps']}, polish Newton "
                f"{r['polish_newton_done']} |" + " |" * 14)
            continue
        lines.append(
            f"| {c} | {r['verdict']} | {j.get('verdict', '—')} |"
            f" {r['ptc_steps']} | {_g(j.get('ptc_steps'))} |"
            f" {r['polish_newton']} | {_g(j.get('polish_newton'))} |"
            f" {'yes' if r.get('polish_wall_capped') else 'no'} |"
            f" {r['polish_resN']:.2e} |"
            f" {r['relN_win']:.6e} | {_g(j.get('relN_win'), '.6e')} |"
            f" {r['relb_win']:.6e} | {_g(j.get('relb_win'), '.6e')} |"
            f" {r['imbalance']:.2e} | {_g(j.get('imbalance'), '.2e')} |"
            f" {r['wall_s']} |")
    checked = [f"S_{c} {json.dumps(r['checks'])}" for c, r, _ in rows
               if r.get("checks")]
    if checked:
        lines += ["", "Checks: " + "; ".join(checked) + "."]
    return lines


def _vs(r, j, keys, fmt=".4g"):
    """Cells of ``keys``: the port's value and JAX's, side by side."""
    cells = []
    for k in keys:
        cells += [_g(r.get(k), fmt), _g(j.get(k), fmt)]
    return cells


def oracle_md(out, jax):
    """SHMIP_TORCH.md's tables of the oracle legs and the artesian study,
    the port beside JAX.  The FV oracle's own fields are scipy on the same
    inputs in both (``oracle_from``: taken from JAX's row); the fw_* and
    rel_* fields read each package's own rows."""
    lines = []
    if "O_ladder" in out:
        r, j = out["O_ladder"], jax.get("O_ladder", {})
        lines += ["", f"## Suite O: the FV column Newton against the 1D "
                  f"oracle (nx = {r['nx']})", "",
                  "| case | FV Newton port | JAX | relN (FV vs 1D) port | JAX"
                  " | relb (FV vs 1D) port | JAX |", "|" + "---|" * 7]
        for c, row in r["rows"].items():
            jr = j.get("rows", {}).get(c, {})
            lines.append("| " + " | ".join(
                [c, str(row["newton"]), _g(jr.get("newton"))]
                + _vs(row, jr, ("relN_fv_1d", "relb_fv_1d"), ".6e")) + " |")
    marches = [k for c in ("A3", "A5") for k in ("O_stab_" + c,
                                                 "O_march_" + c) if k in out]
    if marches:
        lines += ["", "| leg | years | relN vs uniform | relb vs uniform |"
                  " y-spread N [MPa] |", "|---|---|---|---|---|"]
        for k in marches:
            m = out[k]
            lines.append(f"| {k} | {m['years']:.2f} |"
                         f" {m['relN_march_uniform']:.3e} |"
                         f" {m['relb_march_uniform']:.3e} |"
                         f" {m['yspread_N'] / 1e6:.3f} |")
    ot = [c for c in ("C2", "C4", "D1", "D3", "D5") if "OT_" + c in out]
    if ot:
        lines += ["", "## Suite OT: the FV march under suites C's and D's "
                  "forcing against the port's rows", "",
                  "| case | FV amp [MPa] port | JAX | FEM amp port (fw) | JAX"
                  " | rel_amp_err port | JAX | summer sign agrees | FV "
                  "fields |", "|" + "---|" * 9]
        for c in ot:
            r, j = out["OT_" + c], jax.get("OT_" + c, {})
            sign = r.get("summer_sign_agrees")
            lines.append("| " + " | ".join(
                [c] + _vs(r, j, ("N_amp_MPa", "fw_N_amp_MPa", "rel_amp_err"))
                + ["—" if sign is None else "yes" if sign else "**no**",
                   r.get("oracle_from", "run here")]) + " |")
    ov = [c for c in ("E1", "E2", "E3", "E4", "E5") if "OV_" + c in out]
    if ov:
        lines += ["", "## Suite OV: the FV valley against the port's E rows",
                  "", "| case | FV N_trough [MPa] port | JAX | FEM N_trough "
                  "port (fw) | JAX | rel_trough_err port | JAX | FV "
                  "frac_cap | FV fields |", "|" + "---|" * 9]
        for c in ov:
            r, j = out["OV_" + c], jax.get("OV_" + c, {})
            lines.append("| " + " | ".join(
                [c] + _vs(r, j, ("N_trough_MPa", "fw_N_trough_MPa",
                                 "rel_trough_err"))
                + [_g(r.get("frac_cap"), ".3f"),
                   r.get("oracle_from", "run here")]) + " |")
        for k in ("OV_trend", "OV_cap"):
            if k in out:
                lines += ["", f"{k}: {json.dumps(out[k])}"]
    st = out.get("OV_stationarity")
    if st:
        j = jax.get("OV_stationarity", {})
        lines += ["", "## The stationarity leg (scripts/"
                  "torch_valley_stationarity.py, from "
                  f"{st.get('fem_state', 'the port E1 state')})", "",
                  "| | port | JAX (from JAX's E1) |", "|---|---|---|"]
        for k in ("grid_nx_ny", "years_marched", "steps", "fem_b_trough_mm",
                  "fv_b_trough_mm_end", "fem_N_trough_MPa",
                  "fv_N_trough_MPa_end", "relN_interior", "relb_interior",
                  "frac_cap_start", "frac_cap_end", "rate_b_yr_end"):
            a, b = st.get(k), j.get(k)
            f = (lambda x: x if isinstance(x, (list, int)) or x is None
                 else f"{x:.6g}")
            lines.append(f"| {k} | {f(a)} | {f(b)} |")
    a = out.get("artesian_D5")
    if a:
        j = jax.get("artesian_D5", {})
        lines += ["", "## X: the artesian study of D5, from D5's own run",
                  "", "| | port | JAX |", "|---|---|---|"]
        for k in ("spin_years", "converged", "days_any_neg",
                  "days_winmean_neg", "frac_neg_max", "N_min_MPa",
                  "min_over_pi", "worst_day", "x_neg_km_at_worst"):
            lines.append(f"| {k} | {a.get(k)} | {j.get(k)} |")
        if "checks" in a:
            lines += ["", f"Checks: {json.dumps(a['checks'])}."]
    return lines




# each suite's table: (title, [(header, key, format, with JAX's)])
BF_TABLES = {
    "B": ("moulins, 5 years, 60 x 12; relN(B, A5): the y-mean N profile "
          "over x in [30, 90] km against A5's final one",
          [("moulins", "moulins", "d", False),
           ("window mean N [MPa]", "winN_MPa", ".4f", True),
           ("relN(B, A5)", "relN_vs_A5", ".6e", True),
           ("Q_out [m³/s]", "Q_out", ".6g", True),
           ("imbalance", "imbalance", ".2e", True)]),
    "C": ("diurnal forcing for 10 days at 48 steps a day from B5's final "
          "state; the window-mean N over the final two days",
          [("Ra", "Ra", "g", False),
           ("cycle-mean N [MPa]", "N_mean_cycle", ".6e", True),
           ("N amplitude [MPa]", "N_amp_MPa", ".6f", True)]),
    "D": ("degree-day seasons on the suite-A topography, 3 years' spin, "
          "the final year's window-mean N every 10 days",
          [("dT [K]", "dT", "+.0f", False),
           ("winter max N [MPa]", "N_winter_MPa", ".6f", True),
           ("summer min N [MPa]", "N_summer_min_MPa", ".6f", True),
           ("N amplitude [MPa]", "N_amp_MPa", ".6f", True),
           ("imbalance", "imbalance", ".2e", True)]),
    "E": ("the 1,316-node valley at 75 m, a year of hourly steps, the "
          "certified budget",
          [("para", "para", "+.2f", False),
           ("mean N [MPa]", "N_mean_MPa", ".6f", True),
           ("trough N [MPa]", "N_trough_MPa", ".6f", True),
           ("steady rel (30 d)", "steady_rel_30d", ".3e", True),
           ("imbalance", "imbalance", ".2e", True)]),
    "F": ("degree-day seasons on the valley, a year's spin, the final "
          "year's glacier-mean N every 10 days, hourly steps",
          [("dT [K]", "dT", "+.0f", False),
           ("winter max N [MPa]", "N_winter_MPa", ".6f", True),
           ("summer min N [MPa]", "N_summer_min_MPa", ".6f", True),
           ("N amplitude [MPa]", "N_amp_MPa", ".6f", True)]),
}


BF_NOTES = {
    "F": "At 2-hour steps from the cold start (the valley at 300 m, no "
         "spin) F5 stops unconverged at its fifth step in block-ELL, in the "
         "JAX package as in the port, and converges in scalar ELL in both: "
         "the block-ELL operator carry's doing, shared with the reference "
         "(ROADMAP §3, tests/test_torch_f5_bell.py).  The suite's hourly "
         "steps are not affected."}


def bf_md(out, jax):
    """SHMIP_TORCH.md's tables of suites B-F, port beside JAX."""
    lines = []
    for suite, (title, cols) in BF_TABLES.items():
        if not any(c in out for c in CASE_ORDER[suite]):
            continue
        rows = [(c, out.get(c, {"complete": False, "steps_done": 0,
                                "steps": None}))
                for c in CASE_ORDER[suite]]
        cards = sorted({r["card"] for _, r in rows if r.get("card")})
        head = ["case"]
        for h, _, _, j in cols:
            head += [f"{h} port", "JAX"] if j else [h]
        head += ["converged", "ms/step", "wall [s] (last segment)"]
        lines += ["", f"## Suite {suite} ({title}"
                  + (f"; on {', '.join(cards)}" if cards else "") + ")", "",
                  "| " + " | ".join(head) + " |",
                  "|" + "---|" * len(head)]
        for c, r in rows:
            if not r.get("complete"):
                done = (f"{r['steps_done']} of {r['steps']} steps"
                        if r["steps"] else "not started")
                lines.append(f"| {c} | **not run to the end**: {done} |"
                             + " |" * (len(head) - 2))
                continue
            j = jax.get(c, {})
            cells = [c]
            for _, k, f, withj in cols:
                cells.append(_g(r.get(k), f))
                if withj:
                    cells.append(_g(j.get(k), f))
            cells += ["yes" if r["converged"] else "**no**",
                      _g(r.get("ms_per_step"), ".1f"), str(r["wall_s"])]
            lines.append("| " + " | ".join(cells) + " |")
        flag = f"{suite}_amplitude_monotonic"
        if flag in out:
            lines += ["", f"Amplitude monotonic: port **{out[flag]}**, "
                      f"JAX **{jax.get(flag)}**."]
        if suite in BF_NOTES:
            lines += ["", BF_NOTES[suite]]
        checked = [f"{c} {json.dumps(r['checks'])}" for c, r in rows
                   if r.get("checks")]
        if checked:
            lines += ["", "Checks: " + "; ".join(checked) + "."]
        launches = [r["launches"].get("bell_spmv", 0) for _, r in rows
                    if r.get("launches")]
        if launches:
            lines.append(f"bell_spmv launches: {sum(launches)} over "
                         f"{len(launches)} cases' last segments.")
    return lines


def main(quick=False, suites="AS", force=False, cases=None,
         budget_override=None, device=None, ck=None, max_wall=None,
         oracle_rerun=False):
    """Runs ``suites`` (a string of ABCDEFSOTVX, in the JAX script's order;
    O runs the oracle legs O, OT and OV) and writes the cache and
    SHMIP_TORCH.md.  Returns 3 when a case stopped at ``max_wall``, else
    0."""
    out = _Cache()
    if os.path.exists(CACHE):
        with open(CACHE) as f:
            out.update(json.load(f))
        out._dirty.clear()
    kw = dict(device=device, cases=cases, ck=ck, max_wall=max_wall)
    if "A" in suites:
        suite_A(out, quick, **kw)
    for suite, fn in (("B", suite_B), ("D", suite_D), ("E", suite_E),
                      ("F", suite_F)):
        if suite in suites:
            fn(out, quick, force=force, **kw)
    if "C" in suites:
        suite_C(out, quick, device=device, cases=cases, force=force)
    if "S" in suites:
        suite_S(out, quick, force=force, cases=cases,
                budget_override=budget_override, device=device, ck=ck,
                max_wall=max_wall)
    if "O" in suites:
        suite_O(out, quick, force=force, cases=cases)
    if "O" in suites or "T" in suites:
        suite_OT(out, quick, force=force, cases=cases, rerun=oracle_rerun)
    if "O" in suites or "V" in suites:
        suite_OV(out, quick, force=force, cases=cases, rerun=oracle_rerun)
    if "X" in suites:
        suite_X(out, quick, force=force, device=device, ck=ck,
                max_wall=max_wall)
    _save_cache(out)
    print("wrote SHMIP_TORCH.md + scripts/torch_shmip_results.json")
    ran = [c for s_ in suites if s_ in CASE_ORDER for c in CASE_ORDER[s_]
           if cases is None or c in cases]
    ran += ["S_" + c for c in S_ORDER
            if "S" in suites and (cases is None or c in cases)]
    if "X" in suites:
        ran.append("D5")
    return 3 if any(not out.get(c, {}).get("complete", True)
                    for c in ran) else 0


if __name__ == "__main__":
    quick = "--quick" in sys.argv
    force = "--force" in sys.argv
    oracle_rerun = "--oracle-rerun" in sys.argv
    suites, device, ck, max_wall = "AS", None, None, None
    cases = budget_override = None
    for i, a in enumerate(sys.argv):
        if a in ("--suites", "--cases", "--budget", "--device",
                 "--checkpoint", "--max-wall"):
            a = f"{a}={sys.argv[i + 1]}"
        if a.startswith("--suites="):
            suites = a.split("=", 1)[1]
        elif a.startswith("--cases="):
            cases = tuple(a.split("=", 1)[1].split(","))
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--checkpoint="):
            ck = a.split("=", 1)[1]
        elif a.startswith("--max-wall="):
            max_wall = float(a.split("=", 1)[1])
        elif a.startswith("--budget="):
            budget_override = tuple(
                float(x) for x in a.split("=", 1)[1].split(","))
    if set(suites) - set("ABCDEFSOTVX"):
        raise SystemExit("suites are letters of ABCDEFSOTVX")
    if budget_override is not None:
        budget_override = (int(budget_override[0]), int(budget_override[1]),
                           float(budget_override[2]))
    sys.exit(main(quick=quick, suites=suites, force=force, cases=cases,
                  budget_override=budget_override, device=device, ck=ck,
                  max_wall=max_wall, oracle_rerun=oracle_rerun))
