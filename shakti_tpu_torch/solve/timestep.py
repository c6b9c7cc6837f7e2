"""The SHAKTI timestep and the time-integration loop on torch tensors.

Port of shakti_tpu/solve/timestep.py.  One step:

    1. Newton-solve for N (b, q, melt frozen; N_n = state.N),
    2. q    <- water-flux law at nodes (Re from the OLD q),
    3. melt <- melt rate at nodes (NEW q, OLD b and melt in the
               regularization),
    4. b    <- forward-Euler (or semi-implicit) gap evolution with NEW q and
               NEW melt in the regularization, OLD b elsewhere,
    5. clamp b to [b_min, b_max].

Cell-discontinuous quantities reach the nodes by area-weighted averaging
(fem/ops.py).  ``lax.scan`` / ``lax.cond`` become a Python loop and an ``if``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from shakti_tpu_torch.fem import ops
from shakti_tpu_torch.fem.ops import fixed_sum
from shakti_tpu_torch.params import PhysicalParams
from shakti_tpu_torch.physics import constitutive as law
from shakti_tpu_torch.physics import residual as res
from shakti_tpu_torch.solve.newton import NewtonConfig, check_config, newton_solve


@dataclasses.dataclass(frozen=True)
class State:
    """Time-marching state (all nodal).  N doubles as N_n at step entry."""

    N: Any      # (n,) effective pressure [Pa]
    b: Any      # (n,) hydraulic gap height [m]
    q: Any      # (n, 2) water flux [m^2/s]
    melt: Any   # (n,) lagged melt rate [kg/(m^2 s)]
    N_prev: Any = None  # (n,) N one step earlier (guess extrapolation)
    # carried operator (ok, age, vals, a_diag, A_inv, floor, floor_age) when
    # cfg.lag_operator (seeded by api/model.freeze or solve.newton.zero_lag)
    lag_op: Any = None


@dataclasses.dataclass(frozen=True)
class StaticFields:
    """Time-independent nodal forcing + boundary data."""

    z_b: Any        # (n,) bed elevation [m]
    z_s: Any        # (n,) surface elevation [m]
    G: Any          # (n,) geothermal heat flux [W/m^2]
    inputs: Any     # (n,) moulin/distributed input [m/s]
    storage: Any    # (n,) lake indicator (0 when storage_on=False)
    gb0: Any        # (c, 2) background head gradient per cell
    dirichlet: Any  # (n,) bool outflow-Dirichlet mask
    N_bdry: Any     # 0-d Dirichlet value [Pa]
    b_min: Any      # 0-d gap-height floor [m]
    b_max: Any = None  # optional (n,) gap-height cap


def make_static_fields(mesh, z_b, z_s, G, inputs, storage, dirichlet_mask,
                       N_bdry, b_min, params: PhysicalParams,
                       b_max=None) -> StaticFields:
    dtype, dev = mesh.nodes.dtype, mesh.nodes.device

    def as_f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=dev)

    gb0 = law.background_head_gradient(
        ops.cell_grad(mesh, as_f(z_b)), ops.cell_grad(mesh, as_f(z_s)), params)
    return StaticFields(
        z_b=as_f(z_b), z_s=as_f(z_s), G=as_f(G), inputs=as_f(inputs),
        storage=as_f(storage), gb0=gb0,
        dirichlet=torch.as_tensor(np.asarray(dirichlet_mask, bool), device=dev),
        N_bdry=as_f(N_bdry), b_min=as_f(b_min),
        b_max=None if b_max is None else as_f(b_max))


def make_step_fn(mesh, static: StaticFields, params: PhysicalParams,
                 cfg: NewtonConfig, b_update: str = "explicit"):
    """Returns step(state, forcing) -> (state, diagnostics).

    ``forcing`` is a 0-d dt tensor or a dict with 'dt' and optional
    'inputs_scale' (seasonal) / 'melt_a' + 'melt_b' (degree-day) / 'dt_b'
    (per-node gap-update step).  ``b_update``: "explicit" (forward Euler,
    the reference scheme) or "semi_implicit" (backward-Euler closure)."""
    if b_update not in ("explicit", "semi_implicit"):
        raise ValueError(f"b_update must be 'explicit' or 'semi_implicit', "
                         f"got {b_update!r}")
    check_config(cfg)
    p = params
    sq = res.static_quad_fields(mesh, static, cfg.quad_degree, mesh.nodes.dtype)

    def step(state: State, forcing):
        if isinstance(forcing, dict):
            dt = forcing["dt"]
            scale = forcing.get("inputs_scale")
            melt_a = forcing.get("melt_a")
            dt_b = forcing.get("dt_b")
        else:
            dt, scale, melt_a, dt_b = forcing, None, None, None
        dt_b = dt if dt_b is None else dt_b
        inputs_q = sq["inputs_q"]
        if scale is not None:
            inputs_q = inputs_q * scale
        if melt_a is not None:
            # degree-day surface melt routed to the bed (SHMIP D/F forcing)
            inputs_q = inputs_q + torch.clamp_min(
                melt_a - forcing["melt_b"] * sq["zs_q"], 0.0)
        sq_t = dict(sq, inputs_q=inputs_q) if inputs_q is not sq["inputs_q"] \
            else sq
        # ---- 1. implicit solve for N ----
        pre = res.precompute_step(mesh, state.N, state.b, state.q, state.melt,
                                  static, dt, p, cfg.quad_degree, sq=sq_t)
        if cfg.extrapolate_guess and state.N_prev is not None:
            guess = 2.0 * state.N - state.N_prev
        else:
            guess = state.N
        N, stats = newton_solve(guess, pre, mesh, static.dirichlet,
                                static.N_bdry, p, cfg, N_ref=state.N,
                                lag=state.lag_op if cfg.lag_operator else None)
        if cfg.lag_operator:
            ok, age, vals, a_diag, A_inv, floor, fage = stats.pop("lag")
            lag_out = (ok, age + 1, vals, a_diag, A_inv, floor, fage + 1)
        else:
            lag_out = state.lag_op

        # ---- fused corner gather of [N, b, melt] + cellwise gradients ----
        sc = ops.gather_cells(mesh, torch.stack([N, state.b, state.melt], 1))
        g = fixed_sum(ops.center(sc)[:, :, :, None]
                      * mesh.grads[:, :, None, :], 1)            # (c, 3, 2)
        grad_h_c = static.gb0 - g[:, 0] / (p.rho_w * p.g)
        grad_b_c, grad_m_c = g[:, 1], g[:, 2]
        b_cell, melt_cell = sc[:, :, 1], sc[:, :, 2]
        mdiff_old_ci = law.melt_regularization(
            b_cell, melt_cell, grad_b_c[:, None, :], grad_m_c[:, None, :])

        # ---- fused cell->node averaging: [grad_h (2), mdiff_old (1)] ----
        pack = torch.cat([grad_h_c[:, None, :].expand(-1, 3, -1),
                          mdiff_old_ci[:, :, None]], dim=-1)     # (c, 3, 3)
        avg = ops.cellnodal_to_node_avg(mesh, pack)
        grad_h_n, mdiff_old_n = avg[:, :2], avg[:, 2]

        # ---- 2. q update: Re from OLD q ----
        q = law.water_flux(state.b, grad_h_n, law.reynolds(state.q, p), p)
        # ---- 3. melt update: NEW q, OLD b, OLD melt in the regularization
        m0 = law.melt_opening(q, grad_h_n, static.G, p)
        melt = m0 + mdiff_old_n
        # ---- 4. b update with NEW q and NEW melt in the regularization ----
        melt_cell_new = ops.gather_cells(mesh, melt)
        grad_m_new = fixed_sum(ops.center(melt_cell_new)[:, :, None]
                               * mesh.grads, 1)
        mdiff_new_ci = law.melt_regularization(
            b_cell, melt_cell_new, grad_b_c[:, None, :], grad_m_new[:, None, :])
        melt_for_b = m0 + ops.cellnodal_to_node_avg(mesh, mdiff_new_ci)
        if b_update == "semi_implicit":
            # only the decay part of the closure rate goes implicit
            crate = law.closure_rate(N, p)
            b = ((state.b + dt_b * (melt_for_b / p.rho_i
                                    - torch.clamp_max(crate, 0.0) * state.b))
                 / (1.0 + dt_b * torch.clamp_min(crate, 0.0)))
        else:
            b = state.b + dt_b * (melt_for_b / p.rho_i
                                  - law.closure(state.b, N, p))
        # ---- 5. clamp ----
        b = torch.maximum(b, static.b_min)
        if static.b_max is not None:
            b = torch.minimum(b, static.b_max)

        new_state = State(N=N, b=b, q=q, melt=melt, N_prev=state.N,
                          lag_op=lag_out)
        diag = {"newton_iters": stats["iters"], "rnorm": stats["rnorm"],
                "rnorm0": stats["rnorm0"], "converged": stats["converged"],
                "cg_iters": stats["cg_iters"]}
        return new_state, diag

    out = step
    for lvl in range(cfg.adaptive_dt_levels):
        out = with_dt_halving(out, lvl)
    return out


def with_dt_halving(base, level: int = 0, accept_rtol: float = 1e-4):
    """One dt-halving retry level: a failed step is redone as two half-dt
    sub-steps from the same state.  Accepted when both sub-steps converge,
    or the second converges with its residual deeply below the first's
    initial scale (``accept_rtol``)."""

    def halve(forcing):
        if isinstance(forcing, dict):
            return dict(forcing, dt=0.5 * forcing["dt"])
        return 0.5 * forcing

    def stepped(state, forcing):
        s1, d1 = base(state, forcing)
        if d1["converged"]:
            return s1, d1
        half = halve(forcing)
        sa, da = base(state, half)
        sb, db = base(sa, half)
        tiny = torch.finfo(state.N.dtype).tiny
        deep = db["rnorm"] <= accept_rtol * max(da["rnorm0"], tiny)
        diag = {"newton_iters": da["newton_iters"] + db["newton_iters"],
                "rnorm": db["rnorm"], "rnorm0": da["rnorm0"],
                "converged": db["converged"] and (da["converged"] or deep),
                "cg_iters": da["cg_iters"] + db["cg_iters"]}
        return sb, diag

    return stepped


def run_window(step_fn, state: State, forcing):
    """Run len(forcing) steps; returns (state, diagnostics stacked as numpy
    arrays).  ``forcing``: a 1-D dt tensor or a dict of per-step tensors."""
    if isinstance(forcing, dict):
        n = forcing["dt"].shape[0]
        per_step = [{k: v[i] for k, v in forcing.items()} for i in range(n)]
    else:
        per_step = list(forcing)
    diags = []
    for f in per_step:
        state, d = step_fn(state, f)
        diags.append(d)
    keys = ("newton_iters", "rnorm", "rnorm0", "converged", "cg_iters")
    return state, {k: np.asarray([d[k] for d in diags]) for k in keys}


def timestep_sizes(timesteps, dtype=torch.float64, device="cpu"):
    """Per-step dt reproducing the reference's first-step quirk:
    dt_0 = 0.1 |t_1 - t_0|, then dt_i = |t_i - t_{i-1}|."""
    t = np.asarray(timesteps, dtype=np.float64)
    dts = np.empty(t.shape[0])
    dts[0] = 0.1 * abs(t[1] - t[0])
    dts[1:] = np.abs(np.diff(t))
    return torch.as_tensor(dts, dtype=dtype, device=device)


def make_forcing(timesteps, dtype=torch.float64, device="cpu", seasonal=None,
                 degree_day=None):
    """Per-step forcing dict for run_window.

    ``seasonal`` = (amplitude, period_s, phase): inputs * max(0, 1 + A
    sin(2 pi t/T + phase)).  ``degree_day`` = dict(dT, ddf, lapse, t_mean,
    t_amp, period): + max(0, DDF (t_mean + t_amp cos(2 pi t/T) + dT - lapse
    z_s)), the SHMIP suite-D/F runoff model with its published defaults."""
    f = {"dt": timestep_sizes(timesteps, dtype, device)}
    t64 = np.asarray(timesteps, dtype=np.float64)
    if seasonal is not None:
        amp, period, phase = seasonal
        t = torch.as_tensor(t64, dtype=dtype, device=device)
        f["inputs_scale"] = torch.clamp_min(
            1.0 + amp * torch.sin(2.0 * math.pi * t / period + phase), 0.0)
    if degree_day is not None:
        dd = dict(degree_day)
        ddf = dd.get("ddf", 0.01 / 86400.0)
        lapse = dd.get("lapse", 0.0075)
        period = dd.get("period", 3.154e7)
        temp = (dd.get("t_mean", -5.0)
                + dd.get("t_amp", -16.0) * np.cos(2.0 * np.pi * t64 / period)
                + dd.get("dT", 0.0))
        f["melt_a"] = torch.as_tensor(ddf * temp, dtype=dtype, device=device)
        f["melt_b"] = torch.full(t64.shape, ddf * lapse, dtype=dtype,
                                 device=device)
    return f
