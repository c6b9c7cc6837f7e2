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
import os
import sys
import traceback

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


SUITES = {
    "parallel": [case_halo, case_shard, _mg()],
    "dist2": [case_jacobi, case_bicgstab, case_steady],
    "dist4": [case_jacobi, _formats("bell"), _formats("bcsr"),
              case_two_level, case_two_level_jacobi, case_local_two_level,
              _mg(), _mg(mg_cycle="w"), _mg(mg_smooth_p=4.0 / 3.0)],
    "multihost": [case_solve, case_group, case_resume, case_seasonal,
                  case_jax_resume, case_cli],
    "imports": [case_modules],
    "toy8": [case_toy],
}
# the names of the cases made by a factory
NAMES = {"parallel": ["halo", "shard", "mg_v"],
         "dist4": ["jacobi", "bell", "bcsr", "two_level", "two_level_jacobi",
                   "local_two_level", "mg_v", "mg_w", "mg_sp"]}


def case_names(suite):
    return NAMES.get(suite) or [f.__name__[5:] for f in SUITES[suite]]


def _np(v):
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def main():
    suite, rank, world, init, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    if init == "env":
        from shakti_tpu_torch.utils.multihost import init_multihost
        assert init_multihost("cpu") == (world, rank, rank == 0)
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
