"""One rank of the port's distributed tests: NOT a test module.

    python torch_dist_worker.py <suite> <rank> <world> <init> <out_dir>

Joins a gloo group of ``world`` CPU processes (``init``: a file for
``init_method=file://``, or ``env`` for utils/multihost.init_multihost
from torchrun's variables, which the caller sets), runs every case of
``suite`` on this rank and writes each case's results to
``<out_dir>/<case>_r<rank>.npz``; a case that raises writes its traceback to
``<out_dir>/<case>_r<rank>.err`` and the worker exits non-zero after the
last case.  Imports torch and the port only (the test files import both
packages and compare).  One thread per rank, in the manner of
tests/_mp_worker.py.
"""

import dataclasses
import datetime
import faulthandler
import os
import signal
import sys
import traceback
import warnings

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from shakti_tpu_torch.parallel import dist as pdist  # noqa: E402
from shakti_tpu_torch.parallel import halo as H  # noqa: E402
from shakti_tpu_torch.setups import setup_slab  # noqa: E402
from shakti_tpu_torch.solve.timestep import timestep_sizes  # noqa: E402

F64 = torch.float64


def slab(nx, ny=None, days=2.0, nt_per_day=4, **kw):
    md = setup_slab.initialize(nx=nx, ny=ny or nx, days=days,
                               nt_per_day=nt_per_day, **kw)
    md.device, md.dtype = "cpu", F64
    return md


def counts(d):
    """The diagnostics every rank must agree on, bit for bit."""
    return {"newton": np.asarray(d["newton_iters"]),
            "cg": np.asarray(d["cg_iters"]),
            "rnorm": np.asarray(d["rnorm"], np.float64),
            "converged": np.asarray(d["converged"])}


def user(md, t):
    return md.to_user_order(t)


def run_dist(md, steps, group=None, **kw):
    """md through make_distributed_runner for ``steps`` steps: the gathered
    state in user order, the diagnostics and the plan."""
    md.distributed = True
    runner, st0, plan = pdist.make_distributed_runner(md, group, **kw)
    s, d = runner(st0, timestep_sizes(md.timesteps)[:steps])
    g = pdist.gather_state(plan, s)
    out = {"N": user(md, g.N), "b": user(md, g.b), "q": user(md, g.q),
           "L": plan["L"], "omax": plan["omax"], "format": plan["format"],
           "precond": plan["cfg"].precond}
    out.update(counts(d))
    return out


# ----------------------------------------------------------------- suites
def case_halo(rank, P):
    """push / accumulate / accumulate_split on the 9x7 slab, against the
    numpy oracle in the test."""
    md = slab(9, 7)
    n = md.x.size
    plan = H.build_halo(n, md.cells, P)
    rng = np.random.default_rng(1)
    f = rng.normal(size=n)
    f2 = rng.normal(size=(n, 2))
    x = torch.as_tensor(H.localize_rank(plan, f, rank))
    x2 = torch.as_tensor(H.localize_rank(plan, f2, rank))
    h = H.Halo(plan, rank, F64, "cpu")
    om = plan["omax"]
    return {"acc": h.accumulate(x), "acc2": h.accumulate(x2),
            "split": h.accumulate_split(x[:om], x[om:]),
            "push": h.push(x),
            "dot": h.dot(x, x), "norm": h.norm(x), "max": h.max(x.max()),
            "allsum": h.allsum(x[:3])}


def case_shard(rank, P):
    """The cell-sharded step (parallel/shard.py) for 4 steps, f64, in the
    JAX package's node order (the matrix-free operator: no renumbering)."""
    from shakti_tpu_torch.parallel.shard import make_parallel_runner
    md = slab(10, days=1.0)
    md.operator = "cells"
    mesh, static, state, cfg = md.freeze()
    runner = make_parallel_runner(mesh, static, md.params, cfg)
    s, d = runner(state, timestep_sizes(md.timesteps)[:4])
    out = {"N": s.N, "b": s.b, "q": s.q}
    out.update(counts(d))
    return out


def case_toy(rank, P):
    """The 8 x 8 toy of __graft_entry__.dryrun_multichip for 2 steps: at
    P = 8 the last rank owns no cell (its nodes' cells live on lower ranks)
    and keeps one padding cell."""
    md = slab(8)
    md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0,
                                    lag_operator=False)
    out = run_dist(md, 2)
    out["cells"] = pdist.build_distributed(md)[0].n_cells
    return out


def case_jacobi(rank, P):
    """test_dist.py's slab (12x12) for 4 steps under Jacobi; at P = 4 in the
    JAX package's CPU format (ELL), at P = 2 in the port's auto (bell)."""
    md = slab(12)
    md.solver = dataclasses.replace(md.solver, precond="jacobi")
    if P == 4:
        md.operator = "ell"
    return run_dist(md, 4)


def cold_f32_md():
    """The bench model in float32 with phase 19 (b)'s settings (chip_smoke.py:
    the global two-level on aggregates of 16, no operator carry), for its
    first step: the cold start's dt/10."""
    from shakti_tpu_torch.setups import setup_bench
    md = setup_bench.initialize(days=2)
    md.device, md.dtype = "cpu", torch.float32
    md.solver = dataclasses.replace(md.solver, coarse_block=16,
                                    lag_operator=False)
    return md


def case_cold_f32(rank, P):
    """cold_f32_md's first step on the ranks."""
    return run_dist(cold_f32_md(), 1)


def case_bicgstab(rank, P):
    """BiCGStab on the ranks (its fused t.t / t.s reduction), 12x12, 3
    steps, Jacobi."""
    md = slab(12)
    md.solver = dataclasses.replace(md.solver, precond="jacobi",
                                    krylov="bicgstab")
    return run_dist(md, 3)


def _formats(fmt):
    def case(rank, P):
        md = slab(16)
        md.operator = fmt
        return run_dist(md, 3)
    return case


def _smooth(nx=16, days=0.5, **solver):
    md = slab(nx, days=days)
    md.b_init = np.full(md.x.size, 0.01)
    md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0, **solver)
    return md


def case_two_level(rank, P):
    return run_dist(_smooth(precond="two_level"), 2)


def case_two_level_jacobi(rank, P):
    return run_dist(_smooth(precond="jacobi"), 2)


def case_local_two_level(rank, P):
    """The per-rank two-level (precond.make_local_two_level): a rank's mesh
    without global aggregates and with 8-node local aggregates."""
    from shakti_tpu_torch.solve.timestep import make_step_fn, run_window
    md = _smooth(precond="two_level", coarse_block=8)
    md.distributed = True
    mesh, static, st0, cfg, plan = pdist.build_distributed(md)
    mesh = dataclasses.replace(mesh, coarse_agg=None)
    s, d = run_window(make_step_fn(mesh, static, md.params, cfg), st0,
                      timestep_sizes(md.timesteps)[:2])
    g = pdist.gather_state(plan, s)
    out = {"N": user(md, g.N), "L": plan["L"], "block": cfg.coarse_block}
    out.update(counts(d))
    return out


MG = dict(precond="mg", mg_agg=4, mg_coarse_cap=16)


def _mg(**extra):
    def case(rank, P):
        md = _smooth(days=1.0, **MG, **extra)
        return run_dist(md, 3)
    return case


def case_steady(rank, P):
    """The steady march (20 PTC attempts on the 8x8 slab) and the cycle
    certificate (window 3) from its state."""
    md = slab(8)
    md.distributed = True
    runner, st0, plan = pdist.make_distributed_steady_runner(
        md, cycle_window=3, tol=2e-2, max_steps=20, dt0=3600.0)
    s, info = runner(st0)
    mean, cinfo = plan["cycle_run"](s, float(info["dt"]))
    g = pdist.gather_state(plan, s)
    gm = pdist.gather_state(plan, mean)
    out = {"N": g.N, "b": g.b, "mean_N": gm.N, "mean_b": gm.b}
    out.update({f"info_{k}": v for k, v in info.items()})
    out.update({f"cycle_{k}": v for k, v in cinfo.items()})
    return out


def _solve_md(out_dir, name, nx=10, days=2.0, nt_per_day=4, **kw):
    md = slab(nx, days=days, nt_per_day=nt_per_day,
              results_name=os.path.join(out_dir, name), **kw)
    md.distributed = True
    return md


def _solve_out(md, res, rank):
    out = {"steps": res["steps"], "N": res["state"].N, "b": res["state"].b,
           "newton_total": res["newton_iters_total"],
           "cg_total": res["cg_iters_total"],
           "history_none": res["history"] is None}
    if rank == 0:
        out.update({f"hist_{k}": np.array(v) for k, v in res["history"].items()})
    return out


def case_solve(rank, P, out_dir):
    """The run protocol through api/run.solve, rank 0 writing."""
    md = _solve_md(out_dir, "res_solve")
    return _solve_out(md, md.solve(progress=False), rank)


def case_group(rank, P, out_dir):
    """SHAKTI_RUN_GROUP=1: per-window pulls, bitwise equal to grouped."""
    os.environ["SHAKTI_RUN_GROUP"] = "1"
    try:
        md = _solve_md(out_dir, "res_group")
        return _solve_out(md, md.solve(progress=False), rank)
    finally:
        del os.environ["SHAKTI_RUN_GROUP"]


def case_written(rank, P, out_dir):
    """api/run.solve returns on every rank only once rank 0 has written its
    files: rank 0's checkpoint writes are held back a second, and every
    rank then reads the final checkpoint."""
    import time

    from shakti_tpu_torch.io import checkpoint as ckpt
    real = ckpt.save_state

    def slow(*a, **k):
        time.sleep(1.0)
        return real(*a, **k)

    ckpt.save_state = slow
    try:
        _solve_md(out_dir, "res_written").solve(progress=False)
    finally:
        ckpt.save_state = real
    with np.load(os.path.join(out_dir, "res_written", "checkpoint.npz")) as z:
        return {"next_step": z["next_step"]}


def case_resume(rank, P, out_dir):
    """6 of 8 steps, then --resume to the end."""
    md = _solve_md(out_dir, "res_resume")
    full = md.timesteps
    md.timesteps = full[:6]
    md.solve(progress=False)
    md = _solve_md(out_dir, "res_resume")
    md.timesteps = full
    res = md.solve(resume=True, progress=False)
    return _solve_out(md, res, rank)


def case_seasonal(rank, P, out_dir):
    md = _solve_md(out_dir, "res_seasonal")
    md.seasonal_inputs = (0.8, 86400.0, 0.3)
    return _solve_out(md, md.solve(progress=False), rank)


def case_jax_resume(rank, P, out_dir):
    """Resume from the checkpoint of the JAX package's distributed solve
    (written by the test into <out_dir>/res_jax before the ranks start)."""
    md = _solve_md(out_dir, "res_jax")
    return _solve_out(md, md.solve(resume=True, progress=False), rank)


def case_cli(rank, P, out_dir):
    """cli.main with --dist: a fresh directory, then the same directory
    again, which every rank must refuse."""
    from shakti_tpu_torch import cli
    setup = os.path.join(out_dir, "cli_setup.py")
    argv = [setup, "--dist", "--device", "cpu", "--quiet"]
    rc = cli.main(argv)
    try:
        cli.main(argv)
        refused = ""
    except FileExistsError as e:
        refused = str(e)
    return {"rc": rc, "refused": np.array(refused)}


def case_modules(rank, P):
    """One step of the 8x8 slab on the ranks, then the modules a rank has
    loaded that the port must not load."""
    run_dist(slab(8), 1)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "shakti_tpu"))
    return {"bad": np.array(bad, dtype=str)}


# ------------------------------------------- the distributed adjoint suites
# tests/test_adjoint.py's _md: tight solves, so that the IFT premise
# F(N*) = 0 holds to roundoff and finite differences are clean
ADJ = dict(adaptive_dt_levels=0, lag_operator=False, rtol=1e-12, atol=1e-13,
           lin_rtol=1e-12, differentiable=True)


def adj_md(steps=5, nx=12, **solver):
    """The nx x nx slab (12) for ``steps`` hourly steps with a 0.01 m gap,
    f64."""
    md = slab(nx, days=steps / 24.0, nt_per_day=24)
    md.b_init = np.full(md.x.size, 0.01)
    md.solver = dataclasses.replace(md.solver, **dict(ADJ, **solver))
    md.distributed = True
    return md


def part_mean(plan, N, n):
    """This rank's owned-row share of mean(N)."""
    return (N * plan["mesh"].halo.owned_mask).sum() / n


def with_scale(dts, s):
    return {"dt": dts, "inputs_scale": s.expand(dts.shape[0])}


def case_dot(rank, P):
    """Dot-product tests of the exchanges' transposes on the 12x12 slab:
    per rank <op(x), y> and <x, op^T(y)> (op^T by autograd, the Functions'
    backward), summed over the ranks by the test; and the recorded
    forward bitwise equal to the unrecorded one."""
    from shakti_tpu_torch.parallel.dist import build_distributed, localize
    md = slab(12)
    md.distributed = True
    mesh, _, _, _, plan = build_distributed(md)
    h, L, om, n = mesh.halo, plan["L"], plan["omax"], md.x.size
    rng = np.random.default_rng(100 + rank)
    out = {}

    def check(name, op, shape):
        x = torch.as_tensor(rng.normal(size=shape))
        y = torch.as_tensor(rng.normal(size=shape))
        xg = x.clone().requires_grad_(True)
        yx = op(xg)
        (gx,) = torch.autograd.grad(yx, xg, y)
        out[f"{name}_fwd"] = (op(x) * y).sum()
        out[f"{name}_adj"] = (x * gx).sum()
        out[f"{name}_same"] = torch.equal(yx.detach(), op(x))

    check("push", h.push, (L,))
    check("push2", h.push, (L, 2))
    check("accumulate", h.accumulate, (L,))
    check("accumulate3", h.accumulate, (L, 3))
    x = torch.as_tensor(rng.normal(size=L))
    y = torch.as_tensor(rng.normal(size=L))
    lo = x[:om].clone().requires_grad_(True)
    hi = x[om:].clone().requires_grad_(True)
    ys = h.accumulate_split(lo, hi)
    glo, ghi = torch.autograd.grad(ys, (lo, hi), y)
    out["split_fwd"] = (h.accumulate_split(x[:om], x[om:]) * y).sum()
    out["split_adj"] = (x[:om] * glo).sum() + (x[om:] * ghi).sum()
    out["split_same"] = torch.equal(ys.detach(), h.accumulate(x))
    # localize: a global f, the same on every rank; the test sums the
    # ranks' gradients, as the SPMD contract sums a replicated input's
    f = torch.as_tensor(np.random.default_rng(7).normal(size=n))
    y = torch.as_tensor(rng.normal(size=L))
    fg = f.clone().requires_grad_(True)
    loc = localize(plan, fg)
    (g,) = torch.autograd.grad(loc, fg, y)
    out.update(localize_fwd=(loc.detach() * y).sum(), localize_grad=g, f=f,
               localize_same=torch.equal(
                   loc.detach(), torch.as_tensor(H.localize_rank(
                       plan, f.numpy(), rank))))
    return out


def case_grad_scale(rank, P):
    """d mean(N)/d inputs_scale through 5 steps (tests/test_adjoint.py:116):
    the rank's gradient of its partial loss and the rank sum; a central
    difference of the distributed forward; at P = 2 also the forward with
    differentiable=True (graph recorded) against False."""
    md = adj_md()
    n = md.x.size
    dts = timestep_sizes(md.timesteps)
    runner, st0, plan = pdist.make_distributed_runner(md)
    halo = plan["mesh"].halo
    s = torch.tensor(1.0, dtype=F64, requires_grad=True)
    out, d = runner(st0, with_scale(dts, s))
    part = part_mean(plan, out.N, n)
    part.backward()

    def loss(v):
        with torch.no_grad():
            o, _ = runner(st0, with_scale(dts, torch.tensor(v, dtype=F64)))
            return halo.allsum(part_mean(plan, o.N, n))

    h = 1e-5
    res = {"loss": halo.allsum(part.detach()), "g_rank": s.grad,
           "g": halo.allsum(s.grad), "fd": (loss(1 + h) - loss(1 - h)) / (2 * h),
           "precond": plan["cfg"].precond, "format": plan["format"]}
    res.update(counts(d))
    if P == 2:
        r0, st00, _ = pdist.make_distributed_runner(
            adj_md(differentiable=False))
        plain, _ = r0(st00, with_scale(dts, torch.tensor(1.0, dtype=F64)))
        res.update(same_N=torch.equal(out.N, plain.N),
                   same_b=torch.equal(out.b, plain.b))
    return res


def case_grad_toy(rank, P):
    """d mean(N)/d inputs_scale through 5 hourly steps on the 8 x 8 slab:
    at P = 8 the last rank owns no cell and keeps one zero-weight padding
    cell.  The rank's gradient of its partial loss, the rank sum, the
    rank's cells."""
    md = adj_md(nx=8)
    dts = timestep_sizes(md.timesteps)
    runner, st0, plan = pdist.make_distributed_runner(md)
    s = torch.tensor(1.0, dtype=F64, requires_grad=True)
    out, d = runner(st0, with_scale(dts, s))
    part = part_mean(plan, out.N, md.x.size)
    part.backward()
    halo = plan["mesh"].halo
    res = {"loss": halo.allsum(part.detach()), "g_rank": s.grad,
           "g": halo.allsum(s.grad), "cells": plan["mesh"].n_cells}
    res.update(counts(d))
    return res


def case_field(rank, P):
    """The (n,) gradient with respect to the inputs field through
    make_distributed_runner(control="inputs") and localize
    (tests/test_adjoint.py:192), in user order, and a seeded directional
    central difference."""
    md = adj_md()
    n = md.x.size
    dts = timestep_sizes(md.timesteps)
    runner, st0, plan = pdist.make_distributed_runner(md, control="inputs")
    halo = plan["mesh"].halo
    _, static, _, _ = md.freeze("cpu", distributed=True)
    base = static.inputs + 1e-7
    f = base.clone().requires_grad_(True)
    out, _ = runner(pdist.localize(plan, f), st0, dts)
    (part_mean(plan, out.N, n) / 1e5).backward()
    g = halo.allsum(f.grad)
    v = torch.as_tensor(np.random.default_rng(11).normal(size=n))
    v = v / torch.linalg.vector_norm(v)

    def loss(field):
        with torch.no_grad():
            o, _ = runner(pdist.localize(plan, field), st0, dts)
            return halo.allsum(part_mean(plan, o.N, n) / 1e5)

    h = 1e-6 * float(torch.linalg.vector_norm(base))
    return {"g": user(md, g), "g_rank": user(md, f.grad),
            "loss": loss(base), "gdir": torch.dot(g, v),
            "fd": (loss(base + h * v) - loss(base - h * v)) / (2 * h)}


def case_controls(rank, P):
    """control="G" and "storage": one backward each (2 steps), and an
    unknown control refused."""
    md = adj_md(steps=2)
    dts = timestep_sizes(md.timesteps)[:2]
    _, static, _, _ = md.freeze("cpu", distributed=True)
    res = {}
    for ctl in ("G", "storage"):
        runner, st0, plan = pdist.make_distributed_runner(adj_md(steps=2),
                                                          control=ctl)
        f = (getattr(static, ctl) + 1e-3).requires_grad_(True)
        out, _ = runner(pdist.localize(plan, f), st0, dts)
        part_mean(plan, out.N + out.b, md.x.size).backward()
        res[f"g_{ctl}"] = plan["mesh"].halo.allsum(f.grad)
    try:
        pdist.make_distributed_runner(adj_md(steps=2), control="z_b")
        res["refused"] = ""
    except ValueError as e:
        res["refused"] = str(e)
    return res


def case_mg(rank, P):
    """case_grad_scale's gradient with mg on the ranks' halo."""
    md = adj_md(**MG)
    dts = timestep_sizes(md.timesteps)
    runner, st0, plan = pdist.make_distributed_runner(md)
    s = torch.tensor(1.0, dtype=F64, requires_grad=True)
    out, _ = runner(st0, with_scale(dts, s))
    part_mean(plan, out.N, md.x.size).backward()
    return {"g": plan["mesh"].halo.allsum(s.grad),
            "precond": plan["cfg"].precond}


def case_strict(rank, P):
    """lin_maxiter=1 (tests/test_adjoint.py's strict case): with and
    without SHAKTI_ADJOINT_STRICT=1, the gradient with respect to the
    initial gap and the adjoint warnings each rank saw."""
    res = {}
    for tag in ("loose", "strict"):
        if tag == "strict":
            os.environ["SHAKTI_ADJOINT_STRICT"] = "1"
        try:
            md = adj_md(steps=2, lin_maxiter=1, max_iter=60)
            runner, st0, plan = pdist.make_distributed_runner(md)
            b0 = st0.b.clone().requires_grad_(True)
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                out, d = runner(dataclasses.replace(st0, b=b0),
                                timestep_sizes(md.timesteps)[:1])
                part_mean(plan, out.N, md.x.size).backward()
        finally:
            os.environ.pop("SHAKTI_ADJOINT_STRICT", None)
        res[f"{tag}_g"] = b0.grad
        res[f"{tag}_owned"] = plan["mesh"].halo.owned_mask > 0
        res[f"{tag}_converged"] = bool(d["converged"].all())
        res[f"{tag}_warnings"] = sum("adjoint Krylov solve unconverged"
                                     in str(w.message) for w in seen)
    return res


def case_raise(rank, P):
    """Every reduction over the ranks given a tensor that requires grad
    under grad mode raises (on every rank, before its collective); detached
    or under no_grad it runs."""
    md = slab(8)
    plan = H.build_halo(md.x.size, md.cells, P)
    h = H.Halo(plan, rank, F64, "cpu")
    x = torch.ones(plan["L"], dtype=F64, requires_grad=True)
    calls = {"allsum": lambda v: h.allsum(v), "dot": lambda v: h.dot(v, v),
             "dots": lambda v: h.dots([(v, v)]), "norm": h.norm,
             "max": lambda v: h.max(v.max()), "min": lambda v: h.min(v.min()),
             "gather": h.gather,
             "all_to_all": lambda v: h.all_to_all(v[:0], [0] * P, [0] * P)}
    res = {}
    for name, fn in calls.items():
        try:
            fn(x)
            res[f"raised_{name}"] = ""
        except RuntimeError as e:
            res[f"raised_{name}"] = str(e)
    with torch.no_grad():
        res["no_grad_dot"] = h.dot(x, x)
    res["detached_dot"] = h.dot(x.detach(), x.detach())
    return res


SUITES = {
    "parallel": [case_halo, case_shard, _mg()],
    "dist2": [case_jacobi, case_bicgstab, case_steady],
    "dist4": [case_jacobi, _formats("bell"), _formats("bcsr"),
              case_two_level, case_two_level_jacobi, case_local_two_level,
              _mg(), _mg(mg_cycle="w"), _mg(mg_smooth_p=4.0 / 3.0),
              case_cold_f32],
    "multihost": [case_solve, case_group, case_written, case_resume,
                  case_seasonal, case_jax_resume, case_cli],
    "imports": [case_modules],
    "toy8": [case_toy],
    "adjoint2": [case_dot, case_grad_scale, case_field, case_raise],
    "adjoint3": [case_dot, case_controls, case_strict],
    "adjoint4": [case_dot, case_grad_scale, case_mg],
    "adjoint8": [case_grad_toy],
}
# the names of the cases made by a factory
NAMES = {"parallel": ["halo", "shard", "mg_v"],
         "dist4": ["jacobi", "bell", "bcsr", "two_level", "two_level_jacobi",
                   "local_two_level", "mg_v", "mg_w", "mg_sp", "cold_f32"]}


def case_names(suite):
    return NAMES.get(suite) or [f.__name__[5:] for f in SUITES[suite]]


def _np(v):
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def main():
    # the test's finish_world asks a hung rank for its stack with SIGUSR1
    faulthandler.register(signal.SIGUSR1)
    suite, rank, world, init, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    if init == "env":
        from shakti_tpu_torch.utils.multihost import init_multihost
        assert init_multihost(device="cpu") == (world, rank, rank == 0)
    else:
        dist.init_process_group(
            "gloo", init_method=f"file://{init}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
    failed = False
    for fn, name in zip(SUITES[suite], case_names(suite)):
        try:
            args = (rank, world, out_dir) if suite == "multihost" else (
                rank, world)
            res = fn(*args)
            np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"),
                     **{k: _np(v) for k, v in res.items()})
        except Exception:
            failed = True
            with open(os.path.join(out_dir, f"{name}_r{rank}.err"), "w") as f:
                f.write(traceback.format_exc())
    dist.destroy_process_group()
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
