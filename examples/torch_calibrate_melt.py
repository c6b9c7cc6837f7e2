"""Gradient-based calibration of meltwater forcing on the port: the twin of
examples/calibrate_melt.py, importing only shakti_tpu_torch.

Inverts the surface-melt forcing amplitude from 'observed' effective
pressures by descending the exact adjoint gradient through a multi-step
transient: every implicit Newton solve of the window is differentiated
through the implicit-function theorem (solve/implicit.py: one adjoint CG
per step on the backward pass).

Twin experiment: run the slab transient at a hidden true forcing scale s*
to produce observations, then recover s* from a wrong initial guess by
secant iteration on the adjoint gradient of  L(s) = ||N_T(s) - N_obs||^2.
Each step runs under torch.utils.checkpoint: the backward recomputes the
step from its input state instead of keeping its Newton byproducts, so
memory holds one state per step.

    python examples/torch_calibrate_melt.py [--device cpu]
"""

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shakti_tpu_torch.setups import setup_slab as slab  # noqa: E402
from shakti_tpu_torch.solve.timestep import (make_step_fn,  # noqa: E402
                                             run_window, timestep_sizes)


def checkpointed(step):
    """``step`` with each call under torch.utils.checkpoint (non-reentrant):
    the backward runs it again from the same state, to its end (no early
    stop).  ``calls`` lists the (Newton, CG) counts of every run, the
    recomputations included: the implicit solve's host decisions must come
    out the same."""
    calls = []

    def run(state, forcing):
        new, diag = step(state, forcing)
        calls.append((int(diag["newton_iters"]), int(diag["cg_iters"])))
        return new, diag

    def wrapped(state, forcing):
        with set_checkpoint_early_stop(False):
            return checkpoint(run, state, forcing, use_reentrant=False)

    wrapped.calls = calls
    return wrapped


def build(nx=16, ny=16, days=1.0, nt_per_day=16, device="cuda",
          remat=True):
    md = slab.initialize(nx=nx, ny=ny, days=days, nt_per_day=nt_per_day)
    md.device, md.dtype = device, torch.float64
    md.b_init = np.full(md.x.size, 0.01)
    md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0,
                                    lag_operator=False, differentiable=True)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    if remat:
        step = checkpointed(step)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype,
                         device=static.dirichlet.device)
    return md, state, step, dts


def final_N(step, state, dts, scale):
    forcing = {"dt": dts, "inputs_scale": scale.expand(dts.shape[0])}
    out, _ = run_window(step, state, forcing)
    return out.N


def value_and_grad(step, state, dts, N_obs, s):
    """L(s) and dL/ds through the window (the adjoint backward)."""
    st = torch.tensor(s, dtype=dts.dtype, device=dts.device,
                      requires_grad=True)
    dN = (final_N(step, state, dts, st) - N_obs) / 1e5
    loss = torch.mean(dN * dN)
    loss.backward()
    return float(loss.detach()), float(st.grad)


def main(nx=16, ny=16, days=1.0, nt_per_day=16, iters=15, device="cuda",
         remat=True):
    """The secant calibration; returns its record: the iterates, the
    recovered scale and its relative error."""
    md, state, step, dts = build(nx, ny, days, nt_per_day, device, remat)
    s_true = 1.7
    with torch.no_grad():
        N_obs = final_N(step, state, dts, torch.tensor(
            s_true, dtype=md.dtype, device=dts.device))

    # 1-D smooth least squares: secant iteration on the adjoint gradient
    # (optimality condition g(s) = 0) converges superlinearly
    s_prev, g_prev = 1.0, value_and_grad(step, state, dts, N_obs, 1.0)[1]
    s = 1.2
    rows = []
    print(f"# true scale {s_true}, initial guess {s_prev}")
    for it in range(iters):
        loss, g = value_and_grad(step, state, dts, N_obs, s)
        rows.append({"iter": it, "s": s, "loss": loss, "grad": g})
        print(f"iter {it:3d}  s = {s:.8f}  loss = {loss:.3e}  "
              f"grad = {g:+.3e}", flush=True)
        if g == g_prev or abs(g) < 1e-14:
            break
        s_next = s - g * (s - s_prev) / (g - g_prev)
        s_prev, g_prev, s = s, g, s_next
    err = abs(s - s_true) / s_true
    print(f"# recovered s = {s:.8f} (relative error {err:.2e})")
    return {"s": s, "rel_err": err, "g_start": rows[0]["grad"] if rows
            else None, "rows": rows}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    rec = main(device=ap.parse_args().device)
    assert rec["rel_err"] < 1e-3, \
        "calibration failed to recover the true forcing"
    print("calibration OK")
