"""Cook_E2 subglacial-lake experiment on the port: setups/setup_cooke2.py
rebuilt on shakti_tpu_torch's ModelSetup.

The reference's production case: the lake-catchment mesh, the lake mask
from its outline, bed, surface and geothermal flux interpolated onto the
nodes, the outflow boundary at the minimum of the background hydraulic
potential, 10 years at 24 steps a day with daily saves and a checkpoint
every 50 days.

Environment:

  SHAKTI_MESH_DIR          directory with Cook_E2_mesh.msh (and lake.npy,
                           the outline in mesh coordinates); else a
                           synthetic 50 x 50 catchment
  SHAKTI_REFERENCE_BINIT   "1": the reference's exact cold start
                           b = 0.001 + N(0, 0.005), unclamped, with
                           SHAKTI_BOOTSTRAP_STEPS (default 24) float64
                           bootstrap steps (api/run._bootstrap_f64)
  SHAKTI_BEDMACHINE, SHAKTI_ATL14, SHAKTI_AQ1, SHAKTI_LAKE_INVENTORY
                           the netCDF/HDF5 datasets: their readers are not
                           ported yet, so a path to an existing file raises
                           (unset: the synthetic fields of the JAX setup)
"""

import os

import numpy as np

from shakti_tpu_torch.api.model import ModelSetup
from shakti_tpu_torch.mesh.generate import rectangle_mesh
from shakti_tpu_torch.mesh.msh_io import read_msh
from shakti_tpu_torch.params import DEFAULT_PARAMS as P

DATASETS = ("SHAKTI_BEDMACHINE", "SHAKTI_ATL14", "SHAKTI_AQ1",
            "SHAKTI_LAKE_INVENTORY")


def _synthetic_grids(bounds, lake_xy):
    """Cook_E2-scale synthetic bed/surface/GHF grids sized to the mesh's
    bounding box (setups/setup_cooke2.py:_synthetic_grids)."""
    x0, x1, y0, y1 = bounds
    mx, my = x1 - x0, y1 - y0
    gx = np.linspace(x0 - 0.1 * mx, x1 + 0.1 * mx, 500)
    gy = np.linspace(y0 - 0.1 * my, y1 + 0.1 * my, 500)
    X, Y = np.meshgrid(gx, gy)
    r2 = ((X - lake_xy[0]) ** 2 + (Y - lake_xy[1]) ** 2) / (15e3) ** 2
    bed = -400.0 + 0.004 * (X - x0) + 0.002 * (Y - y0) - 60.0 * np.exp(-r2)
    surf = bed + 1500.0 - 0.006 * (X - x0)
    ghf = np.full_like(bed, 0.055) + 0.01 * np.sin(X / 3e4) * np.cos(Y / 4e4)
    return (gx, gy, bed), (gx, gy, surf), (gx, gy, ghf)


def initialize(days=10 * 365, nt_per_day=24, results_name="auto", seed=0):
    for env in DATASETS:
        path = os.environ.get(env)
        if path and os.path.exists(path):
            raise NotImplementedError(
                f"{env}={path}: the netCDF/HDF5 dataset readers (data/netcdf.py,"
                " data/lakes.py) are not ported yet (ROADMAP, still to port, "
                "item 9); unset it for the synthetic fields")
    lake_name = "Cook_E2"
    mesh_dir = os.environ.get("SHAKTI_MESH_DIR")
    msh_path = os.path.join(mesh_dir, f"{lake_name}_mesh.msh") if mesh_dir else None
    if msh_path and os.path.exists(msh_path):
        nodes, cells = read_msh(msh_path)
    else:
        nodes, cells = rectangle_mesh(50, 50, 100e3, 100e3, jitter=0.25, seed=seed)

    md = ModelSetup(nodes, cells)
    md.setup_name = "setup_cooke2"
    md.setup_file = os.path.abspath(__file__)
    md.lake_name = lake_name
    md.N_bdry = 3.7e5
    if results_name == "auto":
        results_name = f"results/{lake_name}_{int(md.N_bdry / 1e3):d}kpa"
    md.results_name = results_name

    outline = None
    if msh_path and os.path.exists(msh_path):
        lk = os.path.join(os.path.dirname(msh_path), "lake.npy")
        if os.path.exists(lk):
            outline = np.load(lk)
    if outline is None:
        cx = 0.5 * (md.x.min() + md.x.max())
        cy = 0.5 * (md.y.min() + md.y.max())
        th = np.linspace(0, 2 * np.pi, 181)
        outline = np.column_stack([cx + 11e3 * np.cos(th),
                                   cy + 9e3 * np.sin(th)])
    md.set_lake_bdry(outline)
    if not md.lake_bdry.any():
        import warnings
        warnings.warn("setup_cooke2: lake outline contains no mesh nodes — "
                      "the storage term will be identically zero",
                      RuntimeWarning)
    lake_c = (outline[np.isfinite(outline[:, 0]), 0].mean(),
              outline[np.isfinite(outline[:, 1]), 1].mean())

    mesh_bounds = (md.x.min(), md.x.max(), md.y.min(), md.y.max())
    bed_g, surf_g, ghf_g = _synthetic_grids(mesh_bounds, lake_c)
    bed_interp = md.interp_data("z_b", *bed_g)
    surf_interp = md.interp_data("z_s", *surf_g)
    md.interp_data("G", *ghf_g)

    # initial conditions: the JAX setup's seeded draws (a tenth of the
    # reference's noise, clamped), or the reference's exact unclamped draw
    # with a float64 bootstrap
    rng = np.random.default_rng(seed)
    if os.environ.get("SHAKTI_REFERENCE_BINIT") == "1":
        md.b_init = 0.001 + rng.normal(scale=0.005, size=md.x.size)
        md.bootstrap_steps = int(os.environ.get("SHAKTI_BOOTSTRAP_STEPS", "24"))
    else:
        md.b_init = np.maximum(
            0.001 + rng.normal(scale=5e-4, size=md.x.size), 1e-5)
    md.N_init = np.full(md.x.size, md.N_bdry)

    def potential(x, y):
        return P.rho_i * P.g * surf_interp(x, y) \
            + (P.rho_w - P.rho_i) * P.g * bed_interp(x, y)

    pot = potential(md.x, md.y)
    P_min, P_std = float(pot.min()), float(pot.std())
    md.OutflowBoundary = \
        lambda p: np.abs(potential(p[:, 0], p[:, 1]) - P_min) < 0.5 * P_std
    md.outflow_on = True
    md.storage_on = True
    md.inputs = np.zeros(md.x.size)

    t_final = (days / 365) * 3.154e7
    md.timesteps = np.linspace(0, t_final, int(days * nt_per_day))
    md.nt_save = nt_per_day
    md.nt_check = 50 * md.nt_save
    return md
