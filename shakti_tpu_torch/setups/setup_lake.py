"""Synthetic subglacial-lake filling/draining experiment on the port: the
twin of setups/setup_lake.py (same arguments, same arrays), built on
shakti_tpu_torch's ModelSetup and constitutive functions.

A closed bed depression under sloping ice traps water; a distributed
recharge fills it and the outflow Dirichlet boundary drains the catchment.
"""

import os

import numpy as np
import torch

from shakti_tpu_torch.api.model import ModelSetup
from shakti_tpu_torch.mesh.generate import rectangle_mesh
from shakti_tpu_torch.params import DEFAULT_PARAMS as P
from shakti_tpu_torch.physics.constitutive import background_potential


def initialize(nx=48, ny=48, lx=40e3, ly=40e3, *, days=180.0, nt_per_day=12,
               lake_radius=6e3, recharge=3.17e-9,  # ~0.1 m/yr distributed
               results_name=None, seed=0):
    nodes, cells = rectangle_mesh(nx, ny, lx, ly, jitter=0.2, seed=seed)
    md = ModelSetup(nodes, cells)
    md.setup_name = "setup_lake"
    md.setup_file = os.path.abspath(__file__)
    md.lake_name = "synthetic_lake"
    md.results_name = results_name

    cx, cy = 0.55 * lx, 0.5 * ly
    r2 = ((md.x - cx) ** 2 + (md.y - cy) ** 2) / lake_radius ** 2
    md.z_b = 0.003 * md.x - 80.0 * np.exp(-r2)       # depression under the lake
    md.z_s = md.z_b * 0.0 + 1200.0 + 0.004 * md.x    # ~1.2 km of ice
    md.G = np.full(md.x.size, 0.06)

    th = np.linspace(0, 2 * np.pi, 121)
    md.set_lake_bdry(np.column_stack([cx + lake_radius * np.cos(th),
                                      cy + lake_radius * np.sin(th)]))
    md.storage_on = True

    # outflow where the background potential is lowest (x = 0 side here)
    pot = background_potential(torch.as_tensor(md.z_b),
                               torch.as_tensor(md.z_s), P).numpy()
    P_min, P_std = float(pot.min()), float(pot.std())

    def potential_at(p):
        # analytic re-evaluation at arbitrary boundary points
        r2p = ((p[:, 0] - cx) ** 2 + (p[:, 1] - cy) ** 2) / lake_radius ** 2
        zb = 0.003 * p[:, 0] - 80.0 * np.exp(-r2p)
        zs = 1200.0 + 0.004 * p[:, 0]
        return P.rho_w * P.g * (zb + (P.rho_i / P.rho_w) * (zs - zb))

    md.OutflowBoundary = lambda p: np.abs(potential_at(p) - P_min) < 0.5 * P_std
    md.outflow_on = True
    md.N_bdry = 2.0e5

    md.inputs = np.full(md.x.size, recharge)

    rng = np.random.default_rng(seed)
    md.b_init = 0.001 + rng.normal(scale=0.0005, size=md.x.size)
    md.N_init = np.full(md.x.size, md.N_bdry)

    t_final = (days / 365) * 3.154e7
    md.timesteps = np.linspace(0, t_final, int(days * nt_per_day))
    md.nt_save = nt_per_day
    md.nt_check = 30 * md.nt_save
    return md
