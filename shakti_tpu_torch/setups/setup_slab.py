"""Tilted-slab experiment on the port: the twin of setups/setup_slab.py
(same arguments, same arrays), built on shakti_tpu_torch's ModelSetup.

A uniformly sloping bed under uniform-thickness ice, outflow Dirichlet on
the downstream edge, a single moulin at the domain centre.
"""

import os

import numpy as np

from shakti_tpu_torch.api.model import ModelSetup
from shakti_tpu_torch.mesh.generate import rectangle_mesh


def initialize(nx=60, ny=60, lx=10e3, ly=10e3, *,
               bed_slope=0.02, thickness=500.0, moulin_Q=2.0,
               days=30.0, nt_per_day=24, results_name=None, seed=0):
    nodes, cells = rectangle_mesh(nx, ny, lx, ly)
    md = ModelSetup(nodes, cells)

    md.setup_name = "setup_slab"
    md.setup_file = os.path.abspath(__file__)
    md.lake_name = None
    md.results_name = results_name

    # geometry: bed rising in +x, uniform ice thickness
    md.z_b = bed_slope * md.x
    md.z_s = md.z_b + thickness
    md.G = np.full(md.x.size, 0.05)          # 50 mW/m^2 geothermal flux

    # head decreases toward x = 0 -> outflow on the x = 0 edge
    md.N_bdry = 1.0e5
    md.OutflowBoundary = lambda p: p[:, 0] < 1e-6 * lx + 1e-9
    md.outflow_on = True
    md.storage_on = False                    # no lake in the slab case

    if moulin_Q:
        md.add_moulin((lx / 2, ly / 2), moulin_Q)

    rng = np.random.default_rng(seed)
    md.b_init = 0.001 + rng.normal(scale=0.0005, size=md.x.size)
    md.N_init = np.full(md.x.size, md.N_bdry)

    t_final = (days / 365.0) * 3.154e7
    md.timesteps = np.linspace(0, t_final, int(days * nt_per_day))
    md.nt_save = nt_per_day
    md.nt_check = 50 * md.nt_save
    return md
