"""The direct steady state of the Cook_E2 production case on the port, in
float64: the twin of scripts/cooke2_steady.py, importing only
shakti_tpu_torch.

The same call, ``md.solve_steady(tol=1e-3, max_steps=20000)``, on the card,
in segments checkpointed to ``--checkpoint`` (ptc.npz) so that the march can
span several runs; ``strict=False``, so a march that has not certified
still reports where it stands.  ``--max-wall`` seconds stops a run at that
point: it then reports the state of its last checkpoint (the march's
steps, drift rate and the far-field numbers there, verdict "no").  The
far-field metrics of the equilibrium should match the 10-year transient's
(scripts/torch_cooke2_results.json, the JAX package's beside it); the lake
is expected to differ (at steady state it has finished filling).

    python scripts/torch_cooke2_steady.py [--tol 1e-3] [--max-steps 20000]
        [--checkpoint DIR] [--max-wall S] [--device cuda|cpu]

Writes scripts/torch_cooke2_steady.json; ``--compare`` adds the
transient's year-10 far field to it once the report has been written.
"""

import argparse
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

import torch_cooke2_report as report  # noqa: E402

OUT = os.path.join(ROOT, "scripts", "torch_cooke2_steady.json")
REF = os.path.join(ROOT, "scripts", "torch_cooke2_results.json")
JAX_REF = os.path.join(ROOT, "scripts", "cooke2_results.json")
INFO_KEYS = ("converged", "steps", "accepted", "rejected", "rate",
             "newton_total", "cg_total", "t_pseudo", "wall_s")


def compute(md, tol=1e-3, max_steps=20000, **kw):
    """``md.solve_steady(tol, max_steps, **kw)`` and what the JAX script
    reports of it (unrounded): the solver info keys, the far-field mean N
    and ratio, the lake's mean N, the mean gap and the mass budget."""
    lake = md.lake_bdry.astype(bool)
    far = report.far_mask(md)
    res = md.solve_steady(tol=tol, max_steps=max_steps, **kw)
    info = res["info"]
    N, b = np.asarray(res["N"]), np.asarray(res["b"])
    return {
        "solver": {k: info[k] for k in INFO_KEYS + ("verdict",)},
        "tol_per_yr": tol,
        "dtype": str(md.dtype).removeprefix("torch."),
        "far_field_mean_N_MPa": float(N[far].mean()) / 1e6,
        "far_field_ratio": float(N[far].mean()) / md.N_bdry,
        "lake_mean_N_MPa": float(N[lake].mean()) / 1e6,
        "mean_gap_mm": float(b.mean()) * 1e3,
        "Q_out_m3s": float(res["Q_out"]),
        "Q_src_m3s": float(res["Q_src"]),
    }


def _steps_done(ck):
    path = os.path.join(ck, "ptc.npz")
    if not os.path.exists(path):
        return 0
    with np.load(path) as z:
        return int(z["k"])


def main(tol=1e-3, max_steps=20000, checkpoint=None, max_wall=None,
         device="cuda"):
    md = report.cooke2_model()
    md.device, md.dtype = device, torch.float64
    checkpoint = checkpoint or os.path.join(ROOT, "results",
                                            "Cook_E2_steady_ck")
    on_card = device.startswith("cuda")
    from shakti_tpu_torch.ops import spmv_cuda
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()

    k0 = _steps_done(checkpoint)
    spmv_cuda.reset_launches()
    t0 = time.time()
    stopped = False
    try:
        with report.wall_limit(max_wall), report.CountPlain() as plain:
            out = compute(md, tol, max_steps, strict=False,
                          checkpoint=checkpoint)
    except report.WallLimit:
        stopped = True
    wall = time.time() - t0
    launches = dict(spmv_cuda.launches)
    if stopped:
        # the state of the last checkpoint, as strict=False returns it
        out = compute(md, tol, _steps_done(checkpoint), strict=False,
                      checkpoint=checkpoint)
    seg_p = os.path.join(checkpoint, "segments.json")
    segs = []
    if os.path.exists(seg_p):
        with open(seg_p) as f:
            segs = json.load(f)
    segs.append({"from_step": k0, "to_step": out["solver"]["steps"],
                 "wall_s": round(wall, 3), "stopped_at_max_wall": stopped,
                 "launches": launches, "plain_calls": dict(plain),
                 "card": report.card() if on_card else None,
                 "peak_mem_GB": (torch.cuda.max_memory_allocated() / 1e9
                                 if on_card else None)})
    os.makedirs(checkpoint, exist_ok=True)
    with open(seg_p, "w") as f:
        json.dump(segs, f, indent=1)

    for k in ("far_field_mean_N_MPa", "far_field_ratio", "lake_mean_N_MPa",
              "Q_out_m3s", "Q_src_m3s"):
        out[k] = round(out[k], 4)
    out["mean_gap_mm"] = round(out["mean_gap_mm"], 3)
    out["certified"] = out["solver"]["verdict"] != "no"
    out["max_steps"] = max_steps
    out["segments"] = segs
    out["total_wall_s"] = round(sum(s["wall_s"] for s in segs), 1)
    out["ms_per_ptc_step"] = round(
        1e3 * out["total_wall_s"] / max(out["solver"]["steps"], 1), 1)
    return write(compare(out))


def compare(out):
    """``out`` with the transient's year-10 far field beside it: the port's
    (scripts/torch_cooke2_results.json, its float64 run where complete,
    else its float32 run) and the JAX package's float64 run."""
    if os.path.exists(REF):
        with open(REF) as f:
            ref = json.load(f)
        year10 = ref.get("f64") or ref.get("f32")
        if year10:
            out["transient_year10_dtype"] = "float64" if "f64" in ref \
                else "float32"
            out["transient_year10_far_field_ratio"] = year10["far_field_ratio"]
            out["transient_year10_far_field_mean_N_MPa"] = \
                year10["far_field_mean_N_MPa"]
            out["far_field_ratio_diff"] = round(
                abs(out["far_field_ratio"] - year10["far_field_ratio"]), 4)
    if os.path.exists(JAX_REF):
        with open(JAX_REF) as f:
            out["jax_transient_year10_far_field_ratio"] = \
                json.load(f)["f64"]["far_field_ratio"]
    return out


def write(out):
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--max-steps", type=int, default=20000)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--max-wall", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", action="store_true",
                    help="only add the transient's year-10 far field to the "
                         "existing scripts/torch_cooke2_steady.json")
    a = ap.parse_args()
    if a.compare:
        with open(OUT) as f:
            write(compare(json.load(f)))
    else:
        main(a.tol, a.max_steps, a.checkpoint, a.max_wall, a.device)
