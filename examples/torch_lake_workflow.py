"""End-to-end workflow on the port: mesh -> run -> post-process ->
figures.  The twin of examples/lake_workflow.py, importing only
shakti_tpu_torch.

The library-script equivalent of the reference's notebook pipeline
(create_mesh.ipynb -> example.ipynb -> solution-plots.ipynb): build a
synthetic lake catchment, run a short transient through the run layer
into a results directory, then derive the solution-plots quantities (lake
level, filling rate, far-field check) and render map frames.  Frames need
matplotlib; without it the twin says so and prints everything else.

    python examples/torch_lake_workflow.py [outdir] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shakti_tpu_torch import post  # noqa: E402
from shakti_tpu_torch.api.run import solve  # noqa: E402
from shakti_tpu_torch.setups import setup_lake  # noqa: E402


def main(outdir="results/example_lake", nx=24, ny=24, days=30.0,
         nt_per_day=4, device="cuda", dtype=None):
    """Returns the record: steps, wall time, the post-processed numbers
    and the number of frames rendered (None without matplotlib).
    ``dtype`` (default the setup's, float32) plays the part of JAX's
    jax_enable_x64, which the JAX example leaves off."""
    # ---- run (reference example.ipynb) ----
    md = setup_lake.initialize(nx=nx, ny=ny, days=days,
                               nt_per_day=nt_per_day, results_name=outdir)
    md.device = device
    md.dtype = dtype or md.dtype
    md.seasonal_inputs = (0.8, 3.154e7, 0.0)     # mild annual melt cycle
    out = solve(md)
    print(f"\nran {out['steps']} steps in {out['wall_time']:.1f} s")

    # ---- post-processing (reference solution-plots.ipynb) ----
    res = post.load_results(outdir)
    lake_mask = md.lake_bdry > 0.5
    lvl = post.lake_level(res["N"], lake_mask)
    rate = post.filling_rate(res["t"], res["N"], lake_mask)
    gap = post.mean_gap(res["b"])
    qmax = post.max_flux(res["qx"], res["qy"], exclude_mask=lake_mask)
    far = (md.x > 0.8 * md.x.max())
    ratio = post.far_field_ratio(res["N"], far, md.N_bdry)
    print(f"lake level change: {lvl[-1] * 1e3:+.2f} mm "
          f"({rate * 3.154e7:+.3f} m/yr)")
    print(f"mean gap: {gap[-1] * 1e3:.3f} mm; peak off-lake |q|: "
          f"{qmax[-1]:.3g} m^2/s")
    print(f"far-field N / N_bdry: {ratio:.3f}")
    rec = {"steps": int(out["steps"]), "wall_s": float(out["wall_time"]),
           "level_change_mm": float(lvl[-1] * 1e3),
           "filling_rate_m_per_yr": float(rate * 3.154e7),
           "mean_gap_mm": float(gap[-1] * 1e3),
           "peak_flux_m2s": float(qmax[-1]), "far_field_ratio": float(ratio),
           "frames": None}

    # ---- figures ----
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("frames not rendered: matplotlib is not installed")
        return rec
    frames_dir = os.path.join(outdir, "frames")
    post.render_frames(res, frames_dir, lake_outline=md.outline,
                       every=max(1, res["t"].size // 4))
    rec["frames"] = len(os.listdir(frames_dir))
    print(f"rendered {rec['frames']} frames into {frames_dir}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default="results/example_lake")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.outdir, device=a.device)
