"""Ensemble uncertainty quantification over the stochastic gap-height IC,
on the port: the twin of examples/ensemble_uq.py, importing only
shakti_tpu_torch.

The reference seeds channelization with an unseeded random initial gap
height (reference setups/setup_cooke2.py:66): every run samples one draw
and reports a single trajectory.  Here the draw becomes a controlled
ensemble axis (parallel/ensemble.py): M perturbed members step together,
each Newton iteration batched over the members, and on the card every
matvec is one member-batched bell_spmv launch for all M operators.

This demo integrates a slab transient under M perturbed b-ICs and prints
the ensemble spread of the effective pressure: the uncertainty the
reference's single unseeded draw hides.

    python examples/torch_ensemble_uq.py [members] [days] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shakti_tpu_torch.parallel.ensemble import (  # noqa: E402
    make_ensemble_runner, perturbed_ensemble)
from shakti_tpu_torch.setups import setup_slab as slab  # noqa: E402
from shakti_tpu_torch.solve.timestep import timestep_sizes  # noqa: E402


def main(members: int = 8, days: float = 5.0, nx: int = 24, ny: int = 24,
         device: str = "cuda", dtype=None):
    """Returns the record: a row per day (mean N, the spread of the member
    means, the largest member spread) and the final members' means.
    ``dtype`` (default the setup's, float32) plays the part of JAX's
    jax_enable_x64, which the JAX example leaves off."""
    md = slab.initialize(nx=nx, ny=ny, days=days, nt_per_day=8)
    md.device = device
    md.dtype = dtype or md.dtype
    mesh, static, state, cfg = md.freeze()
    ens = perturbed_ensemble(state, members, b_scale=5e-4, seed=0)
    runner = make_ensemble_runner(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype,
                         device=static.dirichlet.device)

    win = int(md.nt_save)
    lo = static.dirichlet.cpu().numpy()    # outlet nodes (Dirichlet rows)
    print(f"# {members} members x {dts.shape[0]} steps, "
          f"{mesh.n_nodes} nodes, device={dts.device}")
    rows = []
    for j in range(dts.shape[0] // win):
        ens, diag = runner(ens, dts[j * win:(j + 1) * win])
        assert bool(np.asarray(diag["converged"]).all())
        N = ens.N.cpu().numpy() / 1e6                    # (M, n) MPa
        inner = N[:, ~lo]
        day = (j + 1) * win / 8
        rows.append({"day": day, "mean_N_MPa": float(inner.mean()),
                     "spread_MPa": float(inner.mean(axis=1).std()),
                     "max_member_spread_MPa": float(
                         (inner.max(0) - inner.min(0)).max())})
        print(f"day {day:5.2f}  mean N {inner.mean():8.5f} MPa  "
              f"ensemble spread (std of member means) "
              f"{inner.mean(axis=1).std():.2e} MPa  "
              f"max member spread {(inner.max(0) - inner.min(0)).max():.2e}")

    # headline: the IC uncertainty the single-draw reference run hides
    final = ens.N.cpu().numpy()[:, ~lo].mean(axis=1) / 1e6
    print(f"final mean-N across members: {final.mean():.6f} MPa "
          f"+/- {final.std():.2e} (M={members})")
    return {"rows": rows, "final_mean_MPa": float(final.mean()),
            "final_std_MPa": float(final.std())}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("members", nargs="?", type=int, default=8)
    ap.add_argument("days", nargs="?", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.members, a.days, device=a.device)
