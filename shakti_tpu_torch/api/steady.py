"""User-level steady-state entry point: ``solve_steady(md)``.

Port of shakti_tpu/api/steady.py.  Freezes the model,
marches the pseudo-transient continuation (solve/steady.py) to the
requested drift tolerance and returns the steady state in the caller's node
order with its mass budget::

    md = setup_slab.initialize(nx=16, ny=16)
    out = md.solve_steady(tol=1e-2)           # < 1% drift per year
    N_steady, b_steady = out["N"], out["b"]

The transient path is untouched (the semi-implicit gap update exists only
here).  ``polish=True`` hands the march's state to the monolithic coupled
Newton (solve/monolithic.py).  With ``md.distributed`` and a
torch.distributed world of more than one rank the march (and the cycle
certificate) runs node-sharded on every rank (parallel/dist.py) and the
state is gathered on every rank; the polish and the segmented checkpoint
stay single-device, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from shakti_tpu_torch.io.checkpoint import mesh_fingerprint
from shakti_tpu_torch.parallel import dist as pdist
from shakti_tpu_torch.solve import diagnostics as diag
from shakti_tpu_torch.solve.steady import (STATE_KEYS, YEAR, cycle_certify,
                                           make_steady_step, steady_carry_init,
                                           steady_info_from_carry, steady_solve)
from shakti_tpu_torch.solve.monolithic import steady_polish
from shakti_tpu_torch.utils.multihost import world

PTC_FILE = "ptc.npz"
POLISH_FILE = "polish.npz"


def _save_carry(path, carry, fingerprint):
    """Write the PTC carry atomically, each entry under its key with its
    dtype (the state's fields as ``state.<field>``)."""
    arrays = {f"state.{k}": getattr(carry["state"], k) for k in STATE_KEYS}
    arrays.update({k: v for k, v in carry.items() if k != "state"})
    tmp = path + ".tmp.npz"
    np.savez(tmp, mesh_crc=np.uint32(fingerprint),
             **{k: v.detach().cpu().numpy() for k, v in arrays.items()})
    os.replace(tmp, path)


def _load_carry(path, like, fingerprint):
    """The carry saved by :func:`_save_carry`, on the device of ``like`` (a
    fresh carry: its keys, dtypes and state)."""
    with np.load(path) as z:
        if int(z["mesh_crc"]) != fingerprint:
            raise ValueError(f"{path}: checkpoint belongs to a different mesh "
                             "(fingerprint mismatch)")
        dev = like["dt"].device

        def t(k, ref):
            a = z[k]
            if a.dtype != ref.detach().cpu().numpy().dtype:
                raise ValueError(f"{path}: {k} is {a.dtype}, the march's "
                                 f"{ref.dtype}")
            return torch.as_tensor(a, device=dev)

        carry = {k: t(k, v) for k, v in like.items() if k != "state"}
        carry["state"] = dataclasses.replace(like["state"], **{
            k: t(f"state.{k}", getattr(like["state"], k)) for k in STATE_KEYS})
    return carry


def _ptc_segmented(md, step, state0, mask, ck_dir, segment_steps, kw):
    """The PTC march in segments of ``segment_steps`` attempts, its carry
    saved to ``<ck_dir>/ptc.npz`` after each: a killed-and-resumed march
    replays the uninterrupted one bit for bit, since the carry round-trips
    exactly and the loop re-enters it."""
    os.makedirs(ck_dir, exist_ok=True)
    path = os.path.join(ck_dir, PTC_FILE)
    fp = mesh_fingerprint(md.nodes)
    kw = dict(kw)
    max_steps, dt0 = kw.pop("max_steps"), kw.pop("dt0")
    seg = max(int(segment_steps), 1)
    carry = steady_carry_init(state0, dt0=dt0, max_steps=max_steps)
    if os.path.exists(path):
        carry = _load_carry(path, carry, fp)
    while not bool(carry["done"]) and int(carry["k"]) < max_steps:
        carry = dict(carry, k_end=torch.as_tensor(
            min(int(carry["k"]) + seg, max_steps), dtype=torch.int32,
            device=carry["k"].device))
        _, _, carry = steady_solve(step, state0, params=md.params,
                                   drift_mask=mask, dt0=dt0,
                                   max_steps=max_steps, carry_in=carry,
                                   return_carry=True, **kw)
        _save_carry(path, carry, fp)
    return carry["state"], steady_info_from_carry(carry)


def _host(v):
    """A 0-d tensor as a Python float or int."""
    return float(v) if v.is_floating_point() else int(v)


def solve_steady(md, *, tol=1e-2, t_ref=YEAR, dt0=None, dt_max=1e9,
                 max_steps=2000, max_rel_change=0.5, stab_safety=2.0,
                 budget=True, strict=True, cycle_window=0, polish=False,
                 polish_max_newton=3000, polish_patience=3,
                 polish_max_wall_s=float("inf"), checkpoint=None,
                 segment_steps=256):
    """Solve the model to steady state (drift < ``tol`` per ``t_ref``) on
    md.device.

    Returns a dict: the steady nodal fields ``N``/``b``/``qx``/``qy`` in the
    caller's node order, the solver-order ``state``, ``info`` (host scalars:
    converged, steps, accepted, rejected, rate, rate_N, rate_b, rate_b_bdry,
    kappa, dt, t_pseudo, newton_total, cg_total, verdict, wall_s; the drift
    rates cover the non-Dirichlet nodes, ``rate_b_bdry`` the N-pinned
    boundary's gap) and, with ``budget``, the conservation certificate
    ``Q_out``/``Q_src`` (solve/diagnostics.py: boundary discharge against
    interior production; they agree at a true steady state).

    Raises ``api.run.ConvergenceError`` (with ``.state`` and ``.info``) when
    ``max_steps`` attempts did not reach ``tol`` and nothing was certified;
    ``strict=False`` returns the plateau with ``info["converged"] = False``
    instead.  ``cycle_window > 0``: an unconverged march continues into
    solve/steady.cycle_certify, and a certified cycle returns the
    cycle-mean fields with verdict ``"cycle"`` (no raise).

    ``polish=True`` hands the march's state (plateau or certified) to
    solve/monolithic.steady_polish, which solves the transient's own
    fixed-point equations directly: on success the verdict is
    ``"polished"``, the fields are the equation-level equilibrium and
    ``info["rate"]`` its drift rate (``polish_*`` keys: rate_b, resN,
    newton, converged).  When no fixed point is reached but the march
    sampled enough pseudo-time, a stationary attractor centroid gives the
    verdict ``"stationary"`` with the time-mean fields (``wander_rate``,
    ``wander_amp_b``/``_N``, ``t_march_yr``); otherwise the cycle/plateau
    logic proceeds.  ``polish_max_newton``, ``polish_patience`` and
    ``polish_max_wall_s`` bound that march (total Newton iterations,
    consecutive non-improving segments, host wall seconds).  ``verdict`` is
    ``"polished"``, ``"steady"``, ``"stationary"``, ``"cycle"`` or ``"no"``.

    ``checkpoint``: a directory; the march then runs in segments of
    ``segment_steps`` attempts, saving its carry to ``<dir>/ptc.npz`` after
    each (this package's file: keyed by carry entry, not the JAX package's
    leaf order), and a call with the same directory resumes.  The file is
    removed on a conclusive verdict; the polish checkpoints each of its
    segments to ``<dir>/polish.npz`` (the JAX package's file and keys),
    removed likewise."""
    md.validate(require_timesteps=False)
    if dt0 is None:
        dt0 = 3600.0
        if md.timesteps is not None and np.size(md.timesteps) >= 2:
            ts = np.asarray(md.timesteps, dtype=np.float64)
            dt0 = float(np.abs(np.diff(ts)).mean())
    kw = dict(dt0=dt0, dt_max=dt_max, tol=tol, t_ref=t_ref,
              max_steps=max_steps, max_rel_change=max_rel_change,
              stab_safety=stab_safety)

    dist_on = bool(md.distributed) and world()[0] > 1
    if dist_on:
        runner, state0, plan = pdist.make_distributed_steady_runner(
            md, cycle_window=cycle_window, **kw)
        t0 = time.time()
        state_l, dinfo = runner(state0)
        state = pdist.gather_state(plan, state_l)
        # the budget and the outputs on the gathered state, single-device
        mesh, static, _, cfg = md.freeze()
    else:
        mesh, static, state0, cfg = md.freeze()
        state0 = dataclasses.replace(state0, lag_op=None)
        step, cfg = make_steady_step(mesh, static, md.params, cfg)
        # Dirichlet nodes are excluded from the drift certificate (no
        # reachable gap equilibrium where N is pinned near zero); their gap
        # drift is reported as rate_b_bdry
        mask = ~static.dirichlet
        t0 = time.time()
        if checkpoint:
            state, dinfo = _ptc_segmented(md, step, state0, mask, checkpoint,
                                          segment_steps, kw)
        else:
            state, dinfo = steady_solve(step, state0, params=md.params,
                                        drift_mask=mask, **kw)
    info = {k: _host(v) for k, v in dinfo.items()}
    info["converged"] = bool(dinfo["converged"])

    polished = stationary = False
    if polish and not dist_on:
        p_state, pinfo = steady_polish(
            mesh, static, md.params, state, tol=tol, t_ref=t_ref,
            armijo_cuts=13, max_newton_total=polish_max_newton,
            patience=polish_patience, max_wall_s=polish_max_wall_s,
            checkpoint=(os.path.join(checkpoint, POLISH_FILE)
                        if checkpoint else None))
        info["polish_rate_b"] = float(pinfo["rate_b"])
        info["polish_resN"] = float(pinfo["resN_rel"])
        info["polish_newton"] = int(pinfo["newton"])
        info["polish_converged"] = bool(pinfo["converged"])
        if info["polish_converged"]:
            polished = True
            state = p_state
            info["converged"] = True
            info["rate"] = info["polish_rate_b"]
        elif "wander_rate" in pinfo:
            # no fixed point, but the implicit march sampled enough
            # pseudo-time to judge the attractor: a stationary centroid
            # certifies the regime, and the time mean is the output
            info["wander_rate"] = float(pinfo["wander_rate"])
            info["wander_amp_b"] = float(pinfo["wander_amp_b"])
            info["wander_amp_N"] = float(pinfo["wander_amp_N"])
            info["t_march_yr"] = float(pinfo["t_march"]) / YEAR
            if info["wander_rate"] < tol:
                stationary = True
                state = pinfo["mean_state"]

    certified_cycle = False
    if not info["converged"] and not stationary and cycle_window:
        if dist_on:
            mean_l, cinfo = plan["cycle_run"](state_l, dinfo["dt"])
            mean_state = pdist.gather_state(plan, mean_l)
        else:
            mean_state, cinfo = cycle_certify(
                step, state, params=md.params, dt=dinfo["dt"], tol=tol,
                t_ref=t_ref, window=cycle_window,
                max_rel_change=max_rel_change, drift_mask=mask)
        certified_cycle = bool(cinfo["certified"])
        info["cycle_rate"] = float(cinfo["cycle_rate"])
        info["cycle_amp_N"] = float(cinfo["amp_N"])
        info["cycle_amp_b"] = float(cinfo["amp_b"])
        info["cycle_steps"] = int(cinfo["steps"])
        info["cycle_window"] = int(cycle_window)
        info["newton_total"] += int(cinfo["newton_total"])
        info["cg_total"] += int(cinfo["cg_total"])
        if certified_cycle:
            state = mean_state
    info["verdict"] = ("polished" if polished
                       else "steady" if info["converged"]
                       else "stationary" if stationary
                       else "cycle" if certified_cycle else "no")
    info["wall_s"] = round(time.time() - t0, 3)

    if info["verdict"] == "no" and strict:
        from shakti_tpu_torch.api.run import ConvergenceError
        cyc_note = (f", cycle rate {info['cycle_rate']:.3e}"
                    if "cycle_rate" in info else "")
        err = ConvergenceError(
            f"steady solve did not reach tol={tol:g} per {t_ref:g} s in "
            f"{max_steps} PTC steps (final drift rate {info['rate']:.3e}, "
            f"{info['rejected']} rejected{cyc_note}); loosen tol, raise "
            "max_steps, lower stab_safety, or raise cycle_window")
        err.state, err.info = state, info
        raise err

    if checkpoint and info["verdict"] != "no":
        # a conclusive return drops the file; a "no" keeps it, so that a
        # rerun with a larger max_steps resumes the exhausted march
        path = os.path.join(checkpoint, PTC_FILE)
        if os.path.exists(path):
            os.remove(path)

    out = {"state": state, "info": info}
    out["N"] = md.to_user_order(state.N)
    out["b"] = md.to_user_order(state.b)
    q = md.to_user_order(state.q)
    out["qx"], out["qy"] = q[:, 0], q[:, 1]
    if budget:
        out["Q_out"] = diag.boundary_discharge(mesh, static, state, md.params,
                                               cfg.quad_degree)
        out["Q_src"] = diag.water_production(mesh, static, state, md.params,
                                             cfg.quad_degree)
    return out
