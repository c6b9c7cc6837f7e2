"""The benchmark model on the port: bench.py:build_bench_model rebuilt on
shakti_tpu_torch's ModelSetup.

The reference's production Cook_E2 problem shape (12,268 nodes, hourly
steps): the committed Cook_E2-equivalent catchment mesh
(assets/cooke2_synth/Cook_E2_mesh.msh, 12,270 nodes / 23,990 triangles at
2 km), a gentle bed slope under ~1 km of ice, a lake with the storage term,
outflow Dirichlet at the low-potential edge, daily saves, float32, and the
lagged operator on with no dt-halving retry (bench.py's solver config).
"""

import os

import numpy as np

from shakti_tpu_torch.api.model import ModelSetup
from shakti_tpu_torch.mesh.msh_io import read_msh
from shakti_tpu_torch.solve.newton import NewtonConfig

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets", "cooke2_synth")


def initialize(days=80, results_name=None):
    nodes, cells = read_msh(os.path.join(ASSETS, "Cook_E2_mesh.msh"))
    lake_outline = np.load(os.path.join(ASSETS, "lake.npy"))
    lx = nodes[:, 0].max() - nodes[:, 0].min()
    md = ModelSetup(nodes, cells)
    md.setup_name = "setup_bench"
    md.setup_file = os.path.abspath(__file__)
    md.results_name = results_name

    x0 = md.x.min()
    md.z_b = 0.005 * (md.x - x0) - 100.0
    md.z_s = md.z_b + 1000.0 + 0.002 * (md.x - x0 - lx / 2)
    md.G = np.full(md.x.size, 0.06)
    md.N_bdry = 3.7e5                      # reference setup_cooke2.py:29
    md.OutflowBoundary = lambda p: p[:, 0] < x0 + 0.02 * lx
    md.set_lake_bdry(lake_outline)
    md.storage_on = True
    rng = np.random.default_rng(0)
    md.b_init = np.maximum(0.001 + rng.normal(scale=0.0005, size=md.x.size), 1e-5)
    md.N_init = np.full(md.x.size, md.N_bdry)
    md.timesteps = np.linspace(0, 3.154e7 / 365 * days, days * 24)
    md.nt_save = 24
    md.solver = NewtonConfig(lag_operator=True)
    return md
