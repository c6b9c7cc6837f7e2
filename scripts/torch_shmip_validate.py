"""SHMIP validation on the port: the twin of scripts/shmip_validate.py's sheet
suites A to F and S (S for A1), importing only shakti_tpu_torch and the
scipy-only oracle.

Suite A (A1, A3, A5: distributed input): long float64 transients at
60 x 12 and 4 steps a day, judged each year against the independent 1D
steady oracle (oracle/shmip_oracle.py) over x in [30, 90] km, with the
global mass budget (solve/diagnostics.py) at the end.  Suite S (A1): the
same case solved directly by solve_steady with the polish, JAX's exact
call and budget, judged against the same oracle.

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
and the process exits 3).

Results are cached per suite in scripts/torch_shmip_results.json (merged by
the keys a run wrote, so runs covering other suites or cases are kept) and
rendered as SHMIP_TORCH.md, each value beside the JAX package's in
scripts/shmip_results.json:

    python scripts/torch_shmip_validate.py [--quick] [--suites ABCDEFS]
        [--cases A1,B3] [--force] [--device cuda|cpu]
        [--checkpoint DIR] [--max-wall S]

(``--cases`` selects the cases of every suite here.)

S for A2-A6 and the oracle legs are not ported here.
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
                      **init_kw):
    """Suites D/F: degree-day seasonal forcing.  Spin ``spin_years`` (saved
    each 30 days), then the window-mean N (F: the glacier mean) after each
    ``sample_days`` window of the final year, saved each window.  ``days``
    (default 365 (spin_years + 1)) cuts the run.  Returns (md, state,
    samples, conv, Q_out, Q_src)."""
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
    state = march(step, state, forcing, i, i0, 30 * nt_per_day, cp, prog)
    state = march(step, state, forcing, max(i, i0), nt,
                  sample_days * nt_per_day, cp, prog,
                  after=lambda st: prog["samples"].append(
                      float(md.to_user_order(st.N)[win].mean())))
    Q_out = diag.boundary_discharge(mesh, static, state, md.params)
    Q_src = diag.water_production(mesh, static, state, md.params)
    return (md, state, np.array(prog["samples"]), prog["conv"], Q_out,
            Q_src)


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
    10 days."""
    spin = 1 if quick else 3
    for case in CASE_ORDER["D"]:
        if cases is not None and case not in cases:
            continue

        def one(t0, case=case):
            md, state, samples, conv, Q_out, Q_src = run_seasonal_case(
                case, spin_years=spin, device=device, ck=ck,
                max_wall=max_wall)
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
    """E1-E5: a year (half quick) of hourly steps on the valley."""
    years = 0.5 if quick else 1.0
    for case in CASE_ORDER["E"]:
        if cases is not None and case not in cases:
            continue

        def one(t0, case=case):
            md, state, steady_rel, conv, Q_out, Q_src = run_e_case(
                case, years=years, device=device, ck=ck, max_wall=max_wall)
            N = md.to_user_order(state.N)
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
        "# SHMIP_TORCH — SHMIP suites A to F and S (A1) on the port",
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
    return lines + bf_md(out, jax)


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
         budget_override=None, device=None, ck=None, max_wall=None):
    """Runs ``suites`` (a string of ABCDEFS) and writes the cache and
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
                budget_override=budget_override, device=device)
    _save_cache(out)
    print("wrote SHMIP_TORCH.md + scripts/torch_shmip_results.json")
    ran = [c for s_ in suites if s_ in CASE_ORDER for c in CASE_ORDER[s_]
           if cases is None or c in cases]
    return 3 if any(not out.get(c, {}).get("complete", True)
                    for c in ran) else 0


if __name__ == "__main__":
    quick = "--quick" in sys.argv
    force = "--force" in sys.argv
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
    if set(suites) - set("ABCDEFS"):
        raise SystemExit("this twin runs suites A-F and S only")
    if budget_override is not None:
        budget_override = (int(budget_override[0]), int(budget_override[1]),
                           float(budget_override[2]))
    sys.exit(main(quick=quick, suites=suites, force=force, cases=cases,
                  budget_override=budget_override, device=device, ck=ck,
                  max_wall=max_wall))
