"""Inversion of a spatially distributed meltwater-input FIELD on the port:
the twin of examples/invert_melt_field.py, importing only
shakti_tpu_torch.

Where examples/torch_calibrate_melt.py recovers one scalar, this recovers
a whole nodal field: the unknown spatial pattern of basal recharge is
inferred from effective-pressure observations by Adam (torch.optim.Adam)
on the exact adjoint gradient of a regularized least-squares misfit.
Every implicit Newton solve of the transient is differentiated through
the implicit-function theorem (solve/implicit.py); the control has one
degree of freedom per mesh node, the regime where only adjoint gradients
are affordable.

Twin experiment: a hidden recharge field r*(x) = r0 * exp(theta*(x)) with
a Gaussian bump drives the slab transient to produce observations N_obs;
starting from the uniform field (theta = 0), Adam on

    L(theta) = mean(((N_T(theta) - N_obs) / 1e4)^2)
             + alpha * mean(area * |grad theta|^2)        (smoothness)

recovers the bump.  The exp parameterization keeps the field positive;
the Tikhonov term supplies smoothness where the data are weakly
informative (near the outflow boundary the pressure is pinned by the
Dirichlet condition).  torch.optim.Adam has optax.adam's defaults (betas
0.9 / 0.999, eps 1e-8 outside the square root); its bias correction is
written in another order, which moves theta by roundoff only.

    python examples/torch_invert_melt_field.py [--device cpu]
"""

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shakti_tpu_torch.fem import ops  # noqa: E402
from shakti_tpu_torch.setups import setup_slab as slab  # noqa: E402
from shakti_tpu_torch.solve.timestep import (make_runner,  # noqa: E402
                                             timestep_sizes)

R0 = 1e-7          # background recharge [m/s]
ALPHA = 1e-3       # smoothness weight
LX = LY = 10e3


def build(nx=20, ny=20, days=0.5, nt_per_day=24, device="cuda"):
    md = slab.initialize(nx=nx, ny=ny, lx=LX, ly=LY, moulin_Q=0.0,
                         days=days, nt_per_day=nt_per_day)
    md.device, md.dtype = device, torch.float64
    md.b_init = np.full(md.x.size, 0.01)
    md.inputs = np.zeros(md.x.size)          # control supplies all recharge
    md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0,
                                    lag_operator=False, differentiable=True)
    mesh, static, state, cfg = md.freeze()
    runner = make_runner(md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype,
                         device=static.dirichlet.device)
    return md, mesh, static, state, runner, dts


def true_theta(md):
    """Hidden log-recharge pattern: a smooth bump upslope of the center
    (user order)."""
    cx, cy, sig = 0.62 * LX, 0.5 * LY, 0.12 * LX
    r2 = (md.x - cx) ** 2 + (md.y - cy) ** 2
    return np.log1p(2.0 * np.exp(-r2 / (2.0 * sig ** 2)))


def solver_order(md, a):
    """A user-order nodal array in freeze's node order."""
    return a if md.node_iperm is None else a[np.argsort(md.node_iperm)]


def main(nx=20, ny=20, days=0.5, nt_per_day=24, iters=240, lr=0.3,
         device="cuda"):
    """The Adam inversion; returns its record: the initial and final
    relative field errors, the printed rows and theta (user order)."""
    md, mesh, static, state, runner, dts = build(nx, ny, days, nt_per_day,
                                                 device)
    dev = dts.device
    theta_star = torch.as_tensor(solver_order(md, true_theta(md)),
                                 dtype=md.dtype, device=dev)

    def final_N(theta):
        st = dataclasses.replace(static, inputs=R0 * torch.exp(theta))
        out, _ = runner(mesh, st, state, dts)
        return out.N

    with torch.no_grad():
        N_obs = final_N(theta_star)

    def loss(theta):
        dN = (final_N(theta) - N_obs) / 1e4
        g = ops.cell_grad(mesh, theta)                       # (c, 2)
        smooth = torch.mean(mesh.area * torch.sum(g * g, dim=-1))
        return torch.mean(dN * dN) + ALPHA * smooth

    theta = torch.zeros_like(theta_star, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=lr)

    def rel_err():
        return float(torch.linalg.norm(theta.detach() - theta_star)
                     / torch.linalg.norm(theta_star))

    err0 = rel_err()
    rows = []
    print(f"# {theta.numel()}-dof field inversion, initial rel error "
          f"{err0:.3f}")
    for it in range(iters):
        opt.zero_grad()
        val = loss(theta)
        val.backward()
        opt.step()
        if it % 40 == 0 or it == iters - 1:
            err = rel_err()
            rows.append({"iter": it, "loss": float(val.detach()),
                         "err": err})
            print(f"iter {it:4d}  loss = {float(val.detach()):.3e}  "
                  f"field rel error = {err:.3f}", flush=True)
    err = rel_err()
    print(f"# recovered {theta.numel()}-dof field: relative L2 error "
          f"{err:.3f} (from {err0:.3f} at the uniform start)")
    return {"err0": err0, "err": err, "rows": rows,
            "theta": md.to_user_order(theta.detach())}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    rec = main(device=ap.parse_args().device)
    assert rec["err"] < 0.30 * rec["err0"], \
        "inversion failed to reduce the field error"
    print("field inversion OK")
