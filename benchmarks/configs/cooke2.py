"""cooke2: the reference's Cook_E2 experiment (setups/setup_cooke2.py).

``fields`` makes the configuration's inputs here, from the mesh and lake
outline in the repository's assets and the numbers in cooke2.json beside
this file; ``build`` hands them to the port's ModelSetup, and the harness
hands the same to the plain reference.  The initial gap height is the
setup's, perturbed per member by a draw from the run's seed, as
parallel/ensemble.perturbed_ensemble perturbs it.
"""

from pathlib import Path

import numpy as np

from benchmarks.harness import assets
from benchmarks.reference.shakti_ref import PARAMS

ROOT = Path(__file__).resolve().parents[2]


def fields(s: dict) -> dict:
    """The mesh, the static fields at its nodes, the outflow predicate and
    the boundary value, as the port and the reference take them."""
    nodes, cells = assets.read_msh(ROOT / s["mesh_file"])
    outline = np.load(ROOT / s["lake_outline_file"])
    x, y = nodes[:, 0], nodes[:, 1]
    x0, y0 = x.min(), y.min()
    cx, cy = np.nanmean(outline, 0)
    f = s["fields"]

    def bed(px, py):
        r2 = ((px - cx) ** 2 + (py - cy) ** 2) / f["lake_dip_radius_m"] ** 2
        return (f["bed_offset_m"] + f["bed_slope_x"] * (px - x0)
                + f["bed_slope_y"] * (py - y0) - f["lake_dip_m"] * np.exp(-r2))

    def surface(px, py):
        return bed(px, py) + f["thickness_m"] + f["surface_slope_x"] * (px - x0)

    def potential(px, py):
        g, ri, rw = PARAMS["g"], PARAMS["rho_i"], PARAMS["rho_w"]
        return ri * g * surface(px, py) + (rw - ri) * g * bed(px, py)

    pot = potential(x, y)
    p_min, p_std = pot.min(), pot.std()
    lake = assets.points_in_polygon(nodes, outline).astype(np.float64)
    n = x.size
    return dict(
        nodes=nodes, cells=cells, z_b=bed(x, y), z_s=surface(x, y),
        G=f["G_mean_W_m2"] + f["G_amplitude_W_m2"]
        * np.sin(x / f["G_x_scale_m"]) * np.cos(y / f["G_y_scale_m"]),
        inputs=np.full(n, s["inputs_m_s"]),
        storage=lake if s["storage_on"] else np.zeros(n),
        outflow=lambda p: np.abs(potential(p[:, 0], p[:, 1]) - p_min)
        < f["outflow_within_std"] * p_std,
        N_bdry=s["N_bdry_Pa"], b_min=s["b_min_m"], b_max=None)


def build(fv: dict, s: dict, device):
    """The port's ModelSetup of the fields ``fv``."""
    from shakti_tpu_torch.api.model import ModelSetup
    md = ModelSetup(fv["nodes"], fv["cells"], device=device)
    md.operator = s["operator"]
    md.z_b, md.z_s, md.G, md.inputs = fv["z_b"], fv["z_s"], fv["G"], \
        fv["inputs"]
    md.lake_bdry, md.storage_on = fv["storage"], s["storage_on"]
    md.OutflowBoundary, md.outflow_on = fv["outflow"], True
    md.N_bdry, md.b_min, md.b_cap = fv["N_bdry"], fv["b_min"], fv["b_max"]
    n = fv["nodes"].shape[0]
    md.N_init = np.full(n, md.N_bdry)
    md.b_init = np.full(n, s["b_init"]["mean_m"])
    return md


def initial(fv: dict, s: dict, traffic: dict, rng) -> dict:
    """N = N_bdry, q = 0, melt = 0 and, per member, the setup's initial
    gap b0 = max(mean + N(0, sd), floor), drawn with the setup's own seed,
    plus a normal draw of scale ``traffic['b_scale']`` from ``rng``, the
    run's seed (unclamped, as parallel/ensemble.perturbed_ensemble)."""
    M, n = int(traffic["members"]), fv["nodes"].shape[0]
    bi = s["b_init"]
    b0 = np.maximum(bi["mean_m"] + np.random.default_rng(bi["seed"]).normal(
        scale=bi["sd_m"], size=n), bi["floor_m"])
    b = b0 + rng.normal(scale=traffic["b_scale"], size=(M, n))
    return dict(N=np.full((M, n), fv["N_bdry"]), b=b, q=np.zeros((M, n, 2)),
                melt=np.zeros((M, n)))
