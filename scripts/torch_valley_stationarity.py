"""The valley oracle's stationarity leg (suite OV) on the port: the twin of
scripts/valley_stationarity.py, importing only shakti_tpu_torch's SHMIP
setup and the scipy-only oracle.

The port's converged E1 state (results/shmip_E1_final.npz, user order,
written by ``torch_shmip_validate.py --suites E --cases E1``) is
interpolated onto the FV valley grid (oracle/shmip_fv2d.valley_grid) and
the FV dynamics march from it for ``years``.  If the port's state is
(near-)stationary under the independent discretization, suite E rests on
two implementations; if the FV march leaves it, the two disagree about
the valley sheet branch.  No card is used: the march is scipy.

    python scripts/torch_valley_stationarity.py [NX NY] [--years Y]
        [--state NPZ]

Writes scripts/torch_valley_stationarity.json (folded into the port's
SHMIP cache by ``torch_shmip_validate.py --suites V``).
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import oracle.shmip_fv2d as fv2d  # noqa: E402
from shakti_tpu_torch.setups import setup_shmip as shmip  # noqa: E402

OUT = os.path.join(HERE, "torch_valley_stationarity.json")
E1_FINAL = os.path.join(ROOT, "results", "shmip_E1_final.npz")
T_YR = 3.1536e7


def load_state(path=E1_FINAL):
    """(xy, N, b) of a saved E1 state, user order."""
    with np.load(path) as z:
        return z["xy"], z["N"], z["b"]


def stationarity(xy, N_fem, b_fem, nx=48, ny=12, years=0.5, verbose=200):
    """The FV march from the FEM state (xy, N, b) on the nx x ny valley
    grid for ``years``: the JAX script's fields, from the trough's and
    the interior's start and end."""
    from scipy.interpolate import griddata

    g = fv2d.valley_grid(shmip.CASES_E["E1"], nx, ny)
    cap = np.maximum(np.minimum(g.thick, 0.5), 1e-3)
    X, Y = np.meshgrid(g.x, g.y)
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def interp(f):
        v = griddata(xy, f, pts, method="linear")
        vn = griddata(xy, f, pts, method="nearest")
        v = np.where(np.isfinite(v), v, vn)
        return v.reshape(ny, nx)

    N0 = np.where(g.mask, interp(N_fem), 0.0)
    b0 = np.where(g.mask, np.clip(interp(b_fem), fv2d.B_FLOOR, cap), 1e-4)
    act = g.mask
    trough = act & (g.x >= 2e3)[None, :] & (g.x <= 4e3)[None, :]
    interior = act & (g.thick >= 50.0)
    samp = T_YR * years * (np.arange(1, 19) / 18.0)
    t0 = time.time()
    m = fv2d.march("E1(stationarity)", years=years, dt0=900.0,
                   dt_max=6 * 3600.0, noise=0.0, seed=0,
                   b_init=b0, N_init=N0, max_rel=0.1,
                   input_rate=lambda t: shmip.E_INPUT, grid=g, b_cap=cap,
                   sample_times=samp, sample_mask=trough,
                   rel_pctile=98.0, verbose=verbose)
    N1, b1 = m["N2d"], m["b2d"]
    return {
        "grid_nx_ny": [nx, ny], "years_marched": m["t_years"],
        "steps": m["steps"], "wall_s": round(time.time() - t0, 1),
        "fem_b_trough_mm": float(b0[trough].mean() * 1e3),
        "fv_b_trough_mm_end": float(b1[trough].mean() * 1e3),
        "fem_N_trough_MPa": float(N0[trough].mean() / 1e6),
        "fv_N_trough_MPa_end": float(N1[trough].mean() / 1e6),
        "relN_interior": float(np.linalg.norm(N1[interior] - N0[interior])
                               / np.linalg.norm(N0[interior])),
        "relb_interior": float(np.linalg.norm(b1[interior] - b0[interior])
                               / np.linalg.norm(b0[interior])),
        "frac_cap_start": float((b0[act] >= cap[act] - 1e-12).mean()),
        "frac_cap_end": float((b1[act] >= cap[act] - 1e-12).mean()),
        "rate_b_yr_end": m["rate_b_yr"],
        "trough_N_samples_MPa": (np.asarray(m["samples"]) / 1e6).tolist(),
    }


def main(nx=48, ny=12, years=0.5, state=E1_FINAL, out=OUT):
    """The leg from the E1 state in ``state``, written to ``out``."""
    if not os.path.exists(state):
        raise SystemExit(f"no E1 state at {state}: run "
                         "`torch_shmip_validate.py --suites E --cases E1`")
    xy, N, b = load_state(state)
    print(f"# port E1 state: b mean {b.mean() * 1e3:.2f} mm", flush=True)
    res = dict(stationarity(xy, N, b, nx, ny, years),
               fem_state="the port's E1 (" + os.path.relpath(state, ROOT)
               + ")")
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    argv = sys.argv[1:]
    kw = {}
    for flag, key, cast in (("--years", "years", float),
                            ("--state", "state", str)):
        if flag in argv:
            i = argv.index(flag)
            kw[key] = cast(argv[i + 1])
            del argv[i:i + 2]
    main(*(int(a) for a in argv[:2]), **kw)
