"""The Cook_E2 production run's validation report, on the port: the twin of
scripts/cooke2_report.py, importing only shakti_tpu_torch.

The run is the reference's production problem, 10 years of hourly steps
(87,600) on the Cook_E2 catchment with daily saves and a checkpoint every
50 days, through the port's CLI:

    SHAKTI_MESH_DIR=assets/cooke2_synth python -m shakti_tpu_torch setup_cooke2

``--run`` drives that CLI in this process, one segment at a time, and keeps
what a segment measured: api/run.py rewrites run_meta.json on every resume
with that segment's steps and wall time only, so each segment's copy is
kept as run_meta.<resumed_from>.json, with the card, the peak device
memory, the bell_spmv launches and the calls of the plain operators.  A
segment stopped at ``--max-wall`` seconds records the steps up to its last
checkpoint (the rest is redone by the next segment, which resumes there):

    python scripts/torch_cooke2_report.py --run [--setup FILE] [--max-wall S]
                                          [--device cuda|cpu]

``--setup`` names the setup (default setup_cooke2; a .py path is loaded as
the CLI loads it, e.g. one that sets ``md.dtype = torch.float64`` and its
own results_name for the float64 twin).  ``--profile`` runs a finished
run's last day again from its final checkpoint, timed and under
torch.profiler (profile.json: the card's busy share, launches and host
syncs per step); give it the card alone:

    python scripts/torch_cooke2_report.py --profile [--setup FILE]

The report reads the results directory and, optionally, its float64 twin
(rows a twin has not written yet are zero and are skipped), and writes
scripts/torch_cooke2_results.json and COOKE2_RUN_TORCH.md: the battery of
scripts/cooke2_report.py (far-field mean N / N_bdry, lake mean N, lake level
and linear filling rate, mean gap, peak off-lake flux), the log.csv solver
statistics, the f32-against-f64 drift, how the run was done, and each value
beside the JAX package's in scripts/cooke2_results.json:

    python scripts/torch_cooke2_report.py [results_dir] [f64_results_dir]
"""

import contextlib
import csv
import glob
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from shakti_tpu_torch import post  # noqa: E402

YEAR = 3.154e7
MESH_DIR = os.path.join(ROOT, "assets", "cooke2_synth")
OUT_JSON = os.path.join(ROOT, "scripts", "torch_cooke2_results.json")
OUT_MD = os.path.join(ROOT, "COOKE2_RUN_TORCH.md")
JAX_JSON = os.path.join(ROOT, "scripts", "cooke2_results.json")
# the JAX package's f32 run against this one: (key, tolerance, relative?)
TOLERANCES = (("far_field_ratio", 1e-3, False),
              ("lake_level_final_m", 0.01, True),
              ("filling_rate_m_per_yr", 0.01, True),
              ("mean_gap_final_mm", 0.01, True),
              ("max_offlake_flux_final_m2s", 0.02, True))
DRIFT_LIMITS = {"relN_final": 1e-4, "relN_max_post_transient": 1e-3}


def cooke2_model(days=3650):
    """setup_cooke2.initialize(days, results_name=None) on the committed
    catchment unless SHAKTI_MESH_DIR names another (the environment is
    restored after)."""
    from shakti_tpu_torch.setups import setup_cooke2
    saved = os.environ.get("SHAKTI_MESH_DIR")
    os.environ.setdefault("SHAKTI_MESH_DIR", MESH_DIR)
    try:
        return setup_cooke2.initialize(days=days, results_name=None)
    finally:
        if saved is None:
            os.environ.pop("SHAKTI_MESH_DIR")


def far_mask(md):
    """Far-field nodes: off-lake, off-Dirichlet, >25 km from the lake."""
    lake = md.lake_bdry.astype(bool)
    m = ~lake
    m[md.dirichlet_nodes()] = False
    cx, cy = md.x[lake].mean(), md.y[lake].mean()
    m &= np.hypot(md.x - cx, md.y - cy) > 25e3
    return m


def _log_columns(rdir):
    with open(os.path.join(rdir, "log.csv")) as f:
        rows = list(csv.reader(f))[1:]
    return (np.array([float(r[2]) for r in rows]),
            np.array([float(r[4]) for r in rows]))


def solver_stats(rdir):
    nm, cg = _log_columns(rdir)
    return {
        "newton_per_step_mean": round(float(nm.mean()), 3),
        "cg_per_step_mean": round(float(cg.mean()), 2),
        "cg_p50": round(float(np.percentile(cg, 50)), 1),
        "cg_p95": round(float(np.percentile(cg, 95)), 1),
        "cg_max": round(float(cg.max()), 1),
    }


def newton_stats(rdir):
    """The Newton column as solver_stats gives the CG one (each log.csv row
    is one save window's mean per step)."""
    nm, _ = _log_columns(rdir)
    return {"newton_p50": round(float(np.percentile(nm, 50)), 3),
            "newton_p95": round(float(np.percentile(nm, 95)), 3),
            "newton_max": round(float(nm.max()), 3)}


def battery(res, md):
    """The validation battery of a loaded results directory."""
    lake = md.lake_bdry.astype(bool)
    far = far_mask(md)
    t, N, b = res["t"], res["N"], res["b"]
    lvl = post.lake_level(N, lake)
    return {
        "n_rows": int(N.shape[0]),
        "far_field_mean_N_MPa": round(float(N[-1, far].mean()) / 1e6, 4),
        "far_field_ratio": round(post.far_field_ratio(N, far, md.N_bdry), 4),
        "lake_mean_N_final_MPa": round(float(post.lake_mean(N, lake)[-1]) / 1e6, 4),
        "lake_level_final_m": round(float(lvl[-1]), 3),
        "filling_rate_m_per_yr": round(
            post.filling_rate(t, N, lake) * YEAR, 4),
        "mean_gap_final_mm": round(float(post.mean_gap(b)[-1]) * 1e3, 3),
        "max_offlake_flux_final_m2s": round(
            float(post.max_flux(res["qx"], res["qy"], lake)[-1]), 5),
    }


def analyze(rdir, md):
    res = post.load_results(rdir)
    return res, battery(res, md)


def drift_series(res32, res64):
    """Relative L2 drift of N (and b) per saved row."""
    N32, N64 = res32["N"], res64["N"]
    # a still-running twin has zero-filled rows beyond its progress
    filled = np.flatnonzero(np.abs(N64).max(axis=1) > 0)
    m = min(N32.shape[0], int(filled[-1]) + 1 if filled.size else 0)
    dN = np.linalg.norm(N32[:m] - N64[:m], axis=1) \
        / np.linalg.norm(N64[:m], axis=1)
    b32, b64 = res32["b"], res64["b"]
    db = np.linalg.norm(b32[:m] - b64[:m], axis=1) \
        / np.linalg.norm(b64[:m], axis=1)
    return dN, db, m


def filled_rows(res):
    """``res`` cut to its written rows (an unfinished run's later rows are
    zero) and their count."""
    filled = np.flatnonzero(np.abs(res["N"]).max(axis=1) > 0)
    m = int(filled[-1]) + 1 if filled.size else 0
    return {k: (v[:m] if k in ("t", "N", "b", "qx", "qy") else v)
            for k, v in res.items()}, m


# ------------------------------------------------------------------ the run

def card():
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


class WallLimit(Exception):
    """Raised by :func:`wall_limit` when its time is up."""


@contextlib.contextmanager
def wall_limit(seconds):
    """Raise WallLimit inside the block after ``seconds`` (SIGALRM, so in
    the main thread; None: no limit)."""
    def stop(signum, frame):
        raise WallLimit()
    if seconds:
        signal.signal(signal.SIGALRM, stop)
        signal.alarm(int(seconds))
    try:
        yield
    finally:
        signal.alarm(0)


class CountPlain:
    """Counts the calls of the plain operators of ops/spmv_cuda while
    active (a run on the card makes none)."""

    NAMES = ("bell_operator_plain", "ell_operator_plain",
             "bell_operator_batched_plain")

    def __enter__(self):
        from shakti_tpu_torch.ops import spmv_cuda
        self.mod, self.calls = spmv_cuda, dict.fromkeys(self.NAMES, 0)
        self.real = {k: getattr(spmv_cuda, k) for k in self.NAMES}

        def counted(name, fn):
            def wrapped(*a, **k):
                self.calls[name] += 1
                return fn(*a, **k)
            return wrapped
        for k, fn in self.real.items():
            setattr(spmv_cuda, k, counted(k, fn))
        return self.calls

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.mod, k, fn)


def _next_step(rdir):
    path = os.path.join(rdir, "checkpoint.npz")
    if not os.path.exists(path):
        return 0
    with np.load(path) as z:
        return int(z["next_step"])


def run_segment(setup="setup_cooke2", device="cuda", max_wall=None):
    """One segment of the production run through the CLI (``--resume`` when
    the results directory holds a checkpoint); writes and returns the
    segment's record, run_meta.<resumed_from>.json.  ``max_wall``: seconds
    after which the segment stops (its record then counts the steps up to
    the last checkpoint)."""
    import torch

    from shakti_tpu_torch import cli
    from shakti_tpu_torch.ops import spmv_cuda
    os.environ.setdefault("SHAKTI_MESH_DIR", MESH_DIR)
    md = cli.load_setup(setup).initialize()
    md.device = device
    rdir, nt = md.results_name, int(np.size(md.timesteps))
    start = _next_step(rdir) if rdir and os.path.isdir(rdir) else 0
    if start == 0 and rdir and os.path.isdir(rdir):
        raise SystemExit(f"{rdir} exists and holds no checkpoint: nothing to "
                         "resume (delete it to start afresh)")
    if start >= nt:
        raise SystemExit(f"{rdir}: the run is complete ({start} of {nt} steps)")
    argv = [setup, "--device", device, "--quiet"] + (["--resume"] if start
                                                      else [])
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()

    spmv_cuda.reset_launches()
    t0 = time.time()
    completed = True
    try:
        with wall_limit(max_wall), CountPlain() as plain:
            cli.main(argv)
    except WallLimit:
        completed = False
    wall = time.time() - t0
    meta_p = os.path.join(rdir, "run_meta.json")
    if completed:
        with open(meta_p) as f:
            meta = json.load(f)
    else:
        steps = _next_step(rdir) - start
        meta = {"wall_s": round(wall, 3), "steps": steps,
                "ms_per_step": round(1e3 * wall / max(steps, 1), 3),
                "platform": "cuda" if on_card else "cpu",
                "dtype": str(md.dtype).removeprefix("torch."),
                "n_nodes": int(md.x.size), "resumed_from": start}
    meta.update(
        completed=completed, setup=setup, card=card() if on_card else None,
        peak_mem_GB=(torch.cuda.max_memory_allocated() / 1e9 if on_card
                     else None),
        launches=dict(spmv_cuda.launches), plain_calls=dict(plain))
    with open(os.path.join(rdir, f"run_meta.{start}.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def profile_run(setup="setup_cooke2", device="cuda"):
    """profile_day of a finished run of ``setup``, written to its
    profile.json."""
    from shakti_tpu_torch import cli
    os.environ.setdefault("SHAKTI_MESH_DIR", MESH_DIR)
    md = cli.load_setup(setup).initialize()
    md.device = device
    prof = profile_day(md, md.results_name)
    with open(os.path.join(md.results_name, "profile.json"), "w") as f:
        json.dump(prof, f, indent=1)
    return prof


def profile_day(md, rdir):
    """The run's last day again from its final checkpoint, once to warm up,
    then timed, then under torch.profiler: the card's busy share, device
    ms, launches and host syncs per step (a share of 0 means the profiler
    recorded no kernel)."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shakti_tpu_torch.io import checkpoint as ckpt
    from shakti_tpu_torch.solve.timestep import (make_forcing, make_step_fn,
                                                 run_window)
    mesh, static, state0, cfg = md.freeze()
    dev = static.dirichlet.device
    loaded = ckpt.load_state(rdir, dtype=md.dtype, device=dev, mesh=mesh)
    if loaded is None:
        raise SystemExit(f"{rdir}: no checkpoint to profile from")
    state = loaded[0]
    if cfg.lag_operator and state.lag_op is None:
        state = dataclasses.replace(state, lag_op=state0.lag_op)
    day = {k: v[-md.nt_save:] for k, v in make_forcing(
        md.timesteps, dtype=md.dtype, device=dev).items()}
    step = make_step_fn(mesh, static, md.params, cfg)
    steps = md.nt_save
    run_window(step, state, day)        # warm-up: the process's first launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, d = run_window(step, state, day)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_window(step, state, day)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_s = sum(e.self_device_time_total for e in ka
                if e.device_type == DeviceType.CUDA) / 1e6
    count = {e.key: e.count for e in ka}
    return {"steps": steps, "ms_per_step": ms,
            "profiled_ms_per_step": 1e3 * wall / steps, "busy": dev_s / wall,
            "device_ms_per_step": 1e3 * dev_s / steps,
            "launches_per_step": count.get("cudaLaunchKernel", 0) / steps,
            "syncs_per_step": count.get("aten::_local_scalar_dense", 0) / steps,
            "newton_mean": float(d["newton_iters"].mean()),
            "cg_mean": float(d["cg_iters"].mean()),
            "card": card()}


def run_record(rdir):
    """Every segment's record (run_meta.<resumed_from>.json) and their sums;
    run_meta.json counts too where no copy starts where it does (a run
    made by the bare CLI)."""
    segs = []
    for p in glob.glob(os.path.join(rdir, "run_meta.*.json")):
        with open(p) as f:
            segs.append(json.load(f))
    meta_p = os.path.join(rdir, "run_meta.json")
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            last = json.load(f)
        if not any(s.get("resumed_from") == last.get("resumed_from")
                   for s in segs):
            segs.append(last)
    segs.sort(key=lambda s: s.get("resumed_from", 0))
    if not segs:
        return {}
    steps = sum(s["steps"] for s in segs)
    wall = sum(s["wall_s"] for s in segs)

    def total(key):
        out = {}
        for s in segs:
            for k, v in (s.get(key) or {}).items():
                out[k] = out.get(k, 0) + v
        return out
    rec = {"segments": len(segs), "steps": steps, "wall_s": round(wall, 3),
           "ms_per_step": round(1e3 * wall / max(steps, 1), 3),
           "completed": bool(segs[-1].get("completed", True)),
           "dtype": segs[-1].get("dtype"),
           "cards": sorted({s["card"] for s in segs if s.get("card")}),
           "peak_mem_GB": max((s.get("peak_mem_GB") or 0.0) for s in segs),
           "launches": total("launches"), "plain_calls": total("plain_calls"),
           "per_segment": [{k: s.get(k) for k in
                            ("resumed_from", "steps", "wall_s",
                             "ms_per_step", "completed")} for s in segs]}
    prof = os.path.join(rdir, "profile.json")
    if os.path.exists(prof):
        with open(prof) as f:
            rec["profile"] = json.load(f)
    return rec


# --------------------------------------------------------------- the report

def versus(ours, theirs):
    """Each battery value beside the JAX package's, with the tolerance of
    TOLERANCES and whether it holds."""
    out = {}
    for k, tol, rel in TOLERANCES:
        if k not in ours or k not in theirs:
            continue
        diff = abs(ours[k] - theirs[k]) / (abs(theirs[k]) if rel else 1.0)
        out[k] = {"port": ours[k], "jax": theirs[k], "diff": diff,
                  "tol": tol, "relative": rel, "within": bool(diff <= tol)}
    return out


def _table(cmp):
    rows = ["| quantity | port | JAX package | diff | tolerance | within |",
            "|---|---|---|---|---|---|"]
    for k, v in cmp.items():
        rows.append(f"| {k} | {v['port']} | {v['jax']} | {v['diff']:.3g}"
                    f"{' rel' if v['relative'] else ''} | {v['tol']:g} |"
                    f" {'yes' if v['within'] else '**no**'} |")
    return rows


def _run_lines(name, rec, s, nst):
    if not rec:
        return [f"- {name}: no run_meta.json"]
    lines = [
        f"- {name}: {rec['steps']:,} steps in {rec['segments']} segment(s),"
        f" {rec['wall_s']} s = **{rec['ms_per_step']} ms/step** all-inclusive"
        f" (api/run.solve's clock, summed over the segments), on"
        f" {', '.join(rec['cards']) or 'the CPU'}"
        + ("" if rec["completed"] else " — **stopped before the end**"),
        f"  - solver: Newton per step mean {s['newton_per_step_mean']}"
        f" (p50 {nst['newton_p50']}, p95 {nst['newton_p95']}, max"
        f" {nst['newton_max']}), CG per step mean {s['cg_per_step_mean']}"
        f" (p50 {s['cg_p50']}, p95 {s['cg_p95']}, max {s['cg_max']}),"
        " per daily log.csv row",
        f"  - kernels: {json.dumps(rec['launches'])}; plain operator calls"
        f" {json.dumps(rec['plain_calls'])}; peak device memory"
        f" {rec['peak_mem_GB']:.3f} GB"]
    p = rec.get("profile")
    if p:
        lines.append(
            f"  - the last day again, profiled: {p['ms_per_step']:.3f}"
            f" ms/step ({p['profiled_ms_per_step']:.3f} under the profiler),"
            f" device busy {100 * p['busy']:.1f} %"
            f" ({p['device_ms_per_step']:.3f} ms/step),"
            f" {p['launches_per_step']:.1f} launches and"
            f" {p['syncs_per_step']:.1f} host syncs per step")
    return lines


def main(rdir="results/Cook_E2_370kpa", rdir64="results/Cook_E2_370kpa_f64"):
    md = cooke2_model()
    res32, a32 = analyze(rdir, md)
    rows = a32["n_rows"]
    res32, m32 = filled_rows(res32)
    if m32 == 0:
        raise SystemExit(f"{rdir}: no saved row written yet")
    if m32 < rows:
        a32 = dict(battery(res32, md), rows_planned=rows)
    s32, n32 = solver_stats(rdir), newton_stats(rdir)
    rec32 = run_record(rdir)
    jax = {}
    if os.path.exists(JAX_JSON):
        with open(JAX_JSON) as f:
            jax = json.load(f)

    out = {"f32": a32, "solver": s32, "newton": n32, "run": rec32,
           "vs_jax_f32": versus(a32, jax.get("tpu", {}))}
    has_64 = os.path.isdir(rdir64) and os.path.exists(
        os.path.join(rdir64, "N.npy"))
    if has_64:
        try:
            res64, a64 = analyze(rdir64, md)
        except (ValueError, OSError) as e:   # twin mid-write / incomplete
            print(f"# skipping f64 twin ({e})", file=sys.stderr)
            has_64 = False
    if has_64:
        dN, db, m = drift_series(res32, res64)
        if m == 0:
            print("# skipping f64 twin (no filled rows yet)", file=sys.stderr)
            has_64 = False
    if has_64:
        s = min(5, m)           # after the cold start's first days
        out["drift"] = {
            "rows_compared": int(m),
            "relN_final": float(dN[m - 1]),
            "relN_max_full": float(dN.max()),
            "relN_max_post_transient": float(dN[s:].max()),
            "relb_final": float(db[m - 1]),
            "relb_max_post_transient": float(db[s:].max()),
        }
        out["drift_within"] = {k: bool(out["drift"][k] <= v)
                               for k, v in DRIFT_LIMITS.items()}
        out["solver_f64"] = solver_stats(rdir64)
        out["newton_f64"] = newton_stats(rdir64)
        out["run_f64"] = run_record(rdir64)
        if m == a64["n_rows"] == rows:
            out["f64"] = a64
            out["vs_jax_f64"] = versus(a64, jax.get("f64", {}))

    lines = [
        "# COOKE2_RUN_TORCH — the Cook_E2 production run on the port",
        "",
        "The reference's production problem, 10 years of hourly steps",
        "(87,600) on the committed Cook_E2-equivalent catchment",
        "(assets/cooke2_synth: 12,270 nodes, synthetic bed, surface and",
        "geothermal flux, the committed lake outline), through the port's",
        "CLI (`python -m shakti_tpu_torch setup_cooke2`) in float32, and a",
        "float64 twin of the same trajectory. Written by",
        "`python scripts/torch_cooke2_report.py` (see its docstring for the",
        "run); the JAX package's run of the same experiment is",
        "COOKE2_RUN.md, another machine: its times are not compared here.",
        "",
        "## Run",
        "",
    ]
    lines += _run_lines("float32", rec32, s32, n32)
    if "run_f64" in out:
        lines += _run_lines("float64", out["run_f64"], out["solver_f64"],
                            out["newton_f64"])
    lines += [
        "",
        "## Battery (scripts/cooke2_report.py's), against the JAX package's",
        "",
        f"float32, {a32['n_rows']} daily rows: far-field mean N"
        f" {a32['far_field_mean_N_MPa']} MPa, lake mean N"
        f" {a32['lake_mean_N_final_MPa']} MPa.",
        "",
    ] + _table(out["vs_jax_f32"])
    if "vs_jax_f64" in out:
        lines += ["", f"float64: far-field mean N {out['f64']['far_field_mean_N_MPa']}"
                  f" MPa, lake mean N {out['f64']['lake_mean_N_final_MPa']} MPa.",
                  ""] + _table(out["vs_jax_f64"])
    if "drift" in out:
        d = out["drift"]
        lines += [
            "",
            "## float32 against float64",
            "",
            f"Relative L2 difference over {d['rows_compared']} daily rows"
            f" ({d['rows_compared'] / 365:.2f} years):",
            "",
            "| | final | max (days 5+) | max (all) |",
            "|---|---|---|---|",
            f"| N | {d['relN_final']:.3e} | {d['relN_max_post_transient']:.3e}"
            f" | {d['relN_max_full']:.3e} |",
            f"| b | {d['relb_final']:.3e} | {d['relb_max_post_transient']:.3e}"
            " | |",
            "",
            f"Limits: N final ≤ {DRIFT_LIMITS['relN_final']:g}, N max after"
            f" day 5 ≤ {DRIFT_LIMITS['relN_max_post_transient']:g}:"
            f" {json.dumps(out['drift_within'])}.",
        ]
    with open(OUT_MD, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(OUT_JSON, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return out


def cli_main(argv):
    if argv[:1] in (["--run"], ["--profile"]):
        import argparse
        ap = argparse.ArgumentParser(prog="torch_cooke2_report.py " + argv[0])
        ap.add_argument("--setup", default="setup_cooke2")
        ap.add_argument("--device", default="cuda")
        ap.add_argument("--max-wall", type=float, default=None)
        a = ap.parse_args(argv[1:])
        out = (run_segment(a.setup, a.device, a.max_wall)
               if argv[0] == "--run" else profile_run(a.setup, a.device))
        print(json.dumps(out))
        return 0
    main(*argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli_main(sys.argv[1:]))
