"""Post-processing: results loading, dof permutation, physical reductions,
and plot/movie rendering (the port's copy of shakti_tpu/post.py).

Library-form replacement for the reference's notebook-only layer
(reference notebooks/solution-plots.ipynb + source/dof_helpers.py):

  * :func:`load_results` reads a results directory (the same .npy protocol
    the reference writes);
  * :func:`dofs_to_serial` is the coordinate-matching permutation of
    reference dof_helpers.py:5-13 (needed there because parallel runs gather
    dofs in rank order; our runs already save in user node order, but the
    utility is kept for cross-checking against reference outputs);
  * reductions reproduce solution-plots.ipynb cells 7/10/12/13: lake-mean
    effective pressure, lake level, filling-rate regression, mean gap
    height, off-lake peak flux, far-field validation ratio;
  * :func:`render_frames` draws the 6-panel maps (matplotlib optional).
"""

from __future__ import annotations

import os

import numpy as np

from shakti_tpu_torch.params import DEFAULT_PARAMS, PhysicalParams


def load_results(results_dir: str) -> dict:
    out = {}
    for k in ("t", "nodes_x", "nodes_y", "N", "b", "qx", "qy"):
        path = os.path.join(results_dir, f"{k}.npy")
        if os.path.exists(path):
            out[k] = np.load(path)
    return out


def dofs_to_serial(nodes_parallel: np.ndarray, nodes_serial: np.ndarray,
                   tol: float = 1e-2) -> np.ndarray:
    """Permutation mapping a parallel-ordered nodal vector onto the serial
    mesh ordering by coordinate matching (reference dof_helpers.py:5-13,
    vectorized: the reference's per-mismatch python loop is O(n^2) in the
    worst case; this sorts once)."""
    def keys(nodes):
        return np.round(nodes / tol).astype(np.int64)

    kp, ks = keys(nodes_parallel), keys(nodes_serial)
    # lexicographic sort of both; match rows
    def lexorder(k):
        return np.lexsort((k[:, 1], k[:, 0]))

    op, os_ = lexorder(kp), lexorder(ks)
    if not np.array_equal(kp[op], ks[os_]):
        raise ValueError("node sets do not match within tolerance")
    map_dofs = np.empty(nodes_parallel.shape[0], dtype=np.int64)
    map_dofs[os_] = op
    return map_dofs


# ---------------------------------------------------------------- reductions

def lake_mean(field_hist: np.ndarray, lake_mask: np.ndarray) -> np.ndarray:
    """Time series of the lake-average of a nodal history (n_t, n)."""
    m = np.asarray(lake_mask, dtype=bool)
    return field_hist[:, m].mean(axis=1)


def lake_level(N_hist: np.ndarray, lake_mask: np.ndarray,
               params: PhysicalParams = DEFAULT_PARAMS) -> np.ndarray:
    """Lake water-level change [m]: -(mean N - mean N at t0)/(rho_w g)
    (reference solution-plots.ipynb cell 12)."""
    Nbar = lake_mean(N_hist, lake_mask)
    return -(Nbar - Nbar[0]) / (params.rho_w * params.g)


def filling_rate(t: np.ndarray, N_hist: np.ndarray, lake_mask: np.ndarray,
                 params: PhysicalParams = DEFAULT_PARAMS) -> float:
    """Linear-regression lake-level rate [m/s] (cell 12's linregress)."""
    lvl = lake_level(N_hist, lake_mask, params)
    A = np.vstack([t, np.ones_like(t)]).T
    slope, _ = np.linalg.lstsq(A, lvl, rcond=None)[0]
    return float(slope)


def mean_gap(b_hist: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
    m = slice(None) if mask is None else np.asarray(mask, dtype=bool)
    return b_hist[:, m].mean(axis=1)


def max_flux(qx_hist: np.ndarray, qy_hist: np.ndarray,
             exclude_mask: np.ndarray | None = None) -> np.ndarray:
    """Max |q| per save, optionally excluding e.g. lake nodes
    (cell 12's off-lake peak discharge)."""
    qmag = np.hypot(qx_hist, qy_hist)
    if exclude_mask is not None:
        qmag = qmag[:, ~np.asarray(exclude_mask, dtype=bool)]
    return qmag.max(axis=1)


def far_field_ratio(N_hist: np.ndarray, far_mask: np.ndarray,
                    N_bdry: float) -> float:
    """Validation: steady far-field mean N / boundary value — the
    reference's quantitative sanity check (solution-plots.ipynb cell 13:
    0.36 MPa vs 0.37 MPa)."""
    return float(N_hist[-1, np.asarray(far_mask, dtype=bool)].mean() / N_bdry)


# ------------------------------------------------------------------- plotting

def render_frames(results: dict, out_dir: str, lake_outline=None,
                  every: int = 1, params: PhysicalParams = DEFAULT_PARAMS,
                  lake_mask=None, storage_on: bool = False,
                  outflow_mask=None, cells=None) -> dict:
    """Render per-save 6-panel movie frames as PNGs — the library
    equivalent of solution-plots.ipynb cell 12 (reference, composition
    matched panel for panel):

      top row   — maps: N [MPa] (linear, Purples), b [m] (log, Greens),
                  |q| [m^2/s] (log, Blues) with outflow dofs marked;
      bottom    — three stacked time series drawn up to the frame's time:
                  lake level -(N̄-N̄_0)/(ρ_w g) when ``storage_on`` and a
                  ``lake_mask`` is given (with the reference's
                  second-half linregress + cm/yr annotation), else mean
                  N; then mean gap b̄ with its mm/yr regression; then
                  max |q|.

    ``cells`` (optional (c, 3) connectivity) draws the true mesh
    triangulation instead of a Delaunay rebuild.  Requires matplotlib.
    Returns {"frames": n_written, "panels": 6}.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.colors as mcolors
    import matplotlib.pyplot as plt
    import matplotlib.ticker as mticker
    import matplotlib.tri as mtri

    os.makedirs(out_dir, exist_ok=True)
    x, y, t = results["nodes_x"], results["nodes_y"], results["t"]
    tri = (mtri.Triangulation(x / 1e3, y / 1e3, np.asarray(cells))
           if cells is not None else mtri.Triangulation(x / 1e3, y / 1e3))
    t_yr = t / 3.154e7
    qmag = np.hypot(results["qx"], results["qy"])
    q_max_ts = qmag.max(axis=1)
    b_mean_ts = results["b"].mean(axis=1)
    jm = t.size
    half = slice(jm // 2, jm)
    use_lake = storage_on and lake_mask is not None
    if use_lake:
        ts1 = lake_level(results["N"], lake_mask, params)
        lab1, col1 = (r"$(\overline{N}_0-\overline{N})/\rho_w g$ [m]",
                      "mediumpurple")
        rate1, note1 = _regress(t_yr[half], ts1[half]), "cm/yr"
    else:
        ts1 = results["N"].mean(axis=1) / 1e6
        lab1, col1 = r"$\overline{N}$ [MPa]", "mediumpurple"
        rate1, note1 = None, ""
    rate_b = _regress(t_yr[half], b_mean_ts[half])

    tiny = 1e-12
    n_written = 0
    for j in range(0, jm, every):
        fig = plt.figure(figsize=(13, 10))
        gs = fig.add_gridspec(4, 3, height_ratios=[2.2, 0.6, 0.6, 0.6],
                              hspace=0.45)
        maps = [
            (results["N"][j] / 1e6, "N [MPa]", "Purples", None),
            (np.maximum(results["b"][j], tiny), "b [m]", "Greens",
             mcolors.LogNorm(vmin=1e-3, vmax=1.0)),
            (np.maximum(qmag[j], tiny), r"$|\mathbf{q}|$ [m$^2$/s]",
             "Blues", mcolors.LogNorm(vmin=1e-6, vmax=1e-4)),
        ]
        for k, (field, label, cmap, norm) in enumerate(maps):
            ax = fig.add_subplot(gs[0, k])
            if norm is None:
                tc = ax.tricontourf(tri, field, levels=21, cmap=cmap,
                                    extend="both")
            else:
                lv = np.logspace(np.log10(norm.vmin), np.log10(norm.vmax),
                                 40)
                tc = ax.tricontourf(tri, np.clip(field, norm.vmin,
                                                 norm.vmax),
                                    levels=lv, cmap=cmap, norm=norm,
                                    extend="both")
            cb = fig.colorbar(tc, ax=ax, label=label,
                              orientation="horizontal", location="top",
                              fraction=0.08, pad=0.04)
            if norm is None:        # bound tick count: 21 contour levels
                cb.ax.xaxis.set_major_locator(   # overlap on narrow panels
                    mticker.MaxNLocator(5))
            if lake_outline is not None:
                ax.plot(lake_outline[:, 0] / 1e3, lake_outline[:, 1] / 1e3,
                        "b-", lw=1.5)
            if outflow_mask is not None and k in (0, 2):
                ax.plot(x[outflow_mask] / 1e3, y[outflow_mask] / 1e3, "o",
                        ms=2.5, color="deeppink", zorder=100)
            ax.set_aspect("equal", "box")
            ax.set_xlabel("x [km]")
            if k == 0:
                ax.set_ylabel("y [km]")
        series = [
            (ts1, lab1, col1, rate1, note1, 1e2),
            (b_mean_ts, r"$\overline{b}$ [m]", "forestgreen",
             rate_b, "mm/yr", 1e3),
            (q_max_ts, r"$|\mathbf{q}|_{max}$ [m$^2$/s]", "royalblue",
             None, "", 1.0),
        ]
        for k, (ts, label, color, rate, unit, rscale) in enumerate(series):
            ax = fig.add_subplot(gs[k + 1, :])
            ax.plot(t_yr[1:j + 1], ts[1:j + 1], color=color, lw=2.5)
            if rate is not None and j > jm // 2:
                sl, ic = rate
                tt = t_yr[half][: j - jm // 2]
                ax.plot(tt, sl * tt + ic, "k--", lw=1.2)
                if j > 3 * jm // 4:
                    ax.annotate(f"{sl * rscale:+.2f} {unit}",
                                xy=(t_yr[jm // 2], ts[half].mean()),
                                color=color, fontsize=11)
            ax.set_xlim(0, t_yr[-1] if t_yr[-1] > 0 else 1.0)
            ax.set_ylabel(label, color=color, fontsize=10)
            ax.tick_params(axis="y", colors=color)
            ax.grid(axis="x")
            if k < 2:
                ax.set_xticklabels([])
        ax.set_xlabel("t [yr]")
        fig.suptitle(
            f"t = {t_yr[j]:.2f} yr "
            + ("[LAKE STORAGE]" if storage_on else "[NO STORAGE]"),
            y=0.995, fontsize=14,
            bbox=dict(boxstyle="round", facecolor="w"))
        fig.savefig(os.path.join(out_dir, f"frame_{j:05d}.png"), dpi=110,
                    bbox_inches="tight")
        plt.close(fig)
        n_written += 1
    return {"frames": n_written, "panels": 6}


def _regress(t, y):
    """(slope, intercept) least squares — the reference's linregress."""
    A = np.vstack([t, np.ones_like(t)]).T
    sl, ic = np.linalg.lstsq(A, y, rcond=None)[0]
    return float(sl), float(ic)
