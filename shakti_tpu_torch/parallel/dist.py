"""Node-sharded ranks: the scalable multi-device path on torch.distributed.

Port of shakti_tpu/parallel/dist.py.  Where the JAX package runs one program
over P devices under ``shard_map``, here P processes each run the unmodified
step function (solve/timestep.py) on their own [owned | ghosts | dump] view
of the mesh (parallel/halo.py): assembly completes through halo accumulates,
Newton, Krylov and PTC reductions through owned-slot dots summed over the
ranks, so every rank takes the same host decisions.

Each rank builds its own operator with the port's build_mesh over its own
cells and its L slots ("auto": block-ELL up to 200k slots, block-CSR beyond,
the TPU's rule on every device; ``md.operator`` overrides); the ranks'
operators need no common shape.  Every rank holds the whole model on the
host (the setup runs on every rank, like the reference's per-rank
initialize()) and keeps its share on its device.

Gradients (``NewtonConfig(differentiable=True)``): the SPMD contract.
Every rank builds the same autograd graph (the same code, the same host
decisions), whose halo exchanges are recorded with their transposes
(parallel/halo.py) and whose implicit solves take the distributed adjoint
(solve/implicit.py).  So:
  * each rank backpropagates its OWN owned-row partial loss, e.g.
    ``(N * plan["mesh"].halo.owned_mask).sum() / n`` for the mean of N,
    and every rank calls ``backward`` in lockstep, so that the collectives
    of the backward meet;
  * the gradient of an input every rank holds (a scalar such as a step's
    ``inputs_scale``, or the global (n,) field given to :func:`localize`)
    is the SUM of the ranks' gradients, taken with
    ``plan["mesh"].halo.allsum`` (rank order: the same bits on every
    rank).
This is the transpose the JAX package derives under ``shard_map``.  The
distributed field inversion: ``runner, st0, plan =
make_distributed_runner(md, control="inputs")``, then on every rank
``f = f_global.requires_grad_()``, ``state, _ = runner(localize(plan, f),
st0, forcing)``, the rank's partial loss, ``backward()``, and
``halo.allsum(f.grad)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from shakti_tpu_torch.fem.ops import gather_plan, plan_sum
from shakti_tpu_torch.mesh.mesh import build_mesh
from shakti_tpu_torch.parallel import halo as H
from shakti_tpu_torch.solve.mg import build_hierarchy, localize_hierarchy
from shakti_tpu_torch.solve.timestep import (State, StaticFields, make_step_fn,
                                             run_window)
from shakti_tpu_torch.utils.backend import resolve_device

# per-rank "auto" format: block-ELL up to this many local slots, block-CSR
# beyond (api/model.BELL_MAX_NODES)
BELL_MAX_SLOTS = 200_000


def rank_format(md, L: int):
    """(format, block edge) of a rank's operator with L slots."""
    op = md.operator
    if op not in ("bell", "ell", "bcsr", "cells"):
        op = "bell" if L <= BELL_MAX_SLOTS else "bcsr"
    if op == "bcsr":
        return op, 32 if L <= 6_000_000 else 16
    return op, 128


def _auto_block(size: int, cap: int = 1024) -> int:
    """The aggregate size, from 8 and doubled, that keeps ``size / block``
    dense coarse dofs at most ``cap``."""
    blk = 8
    while size // blk > cap:
        blk *= 2
    return blk


def build_distributed(md, group=None, device=None):
    """This rank's share of a model: (mesh, static, state0, cfg, plan).

    ``md`` is frozen on the host with the distributed layout (RCB node
    order, no global operator), the halo plan split its nodes between the
    ranks of ``group`` (default: the world), and this rank's mesh (with its
    :class:`halo.Halo`, its global coarse aggregates and, under mg, its
    share of the global hierarchy), static fields and initial state are
    built on ``device`` (default md.device).  ``plan`` is
    :func:`halo.build_halo`'s host plan plus: rank, coarse_m, mg_plan,
    format and block (this rank's operator), glob_ids and live_mask (L,)
    (the global node of each local slot, dead slots aliasing node 0 and
    masked: :func:`localize`'s map), and group (the owned-slot stitch of
    grouped save rows: omax, own_p, own_slot)."""
    # the USER's coarse_block, before freeze resolves the None sentinel
    user_blk = md.solver.coarse_block
    dev = resolve_device(md.device if device is None else device)
    P, rank = dist.get_world_size(group), dist.get_rank(group)
    mesh, static, state, cfg = md.freeze("cpu", distributed=True)
    n = mesh.n_nodes
    cells = mesh.cells.numpy()
    plan = H.build_halo(n, cells, P)
    L = plan["L"]
    # per-rank two-level aggregates (the 'auto' sentinel: a few hundred to
    # ~1k local coarse dofs) and the global ones (~1k global coarse dofs);
    # no operator carry on the distributed path
    blk = _auto_block(L) if user_blk is None else user_blk
    cfg = dataclasses.replace(cfg, coarse_block=blk, lag_operator=False)
    gblk = _auto_block(n)
    coarse_m = -(-n // gblk)
    agg_global = np.arange(n, dtype=np.int64) // gblk
    # the global mg hierarchy, chosen over the global two-level once the
    # mesh has intermediate levels (the JAX package's rule)
    mg_plan = None
    if cfg.precond in ("two_level", "mg"):
        cand = build_hierarchy(cells, n, agg=cfg.mg_agg, cap=cfg.mg_coarse_cap)
        if cand is not None and (cfg.precond == "mg" or len(cand.cols) > 0):
            mg_plan = cand
            cfg = dataclasses.replace(cfg, precond="mg")

    nc = int(plan["cell_valid"][rank].sum())
    fmt, B = rank_format(md, L)
    omax = int(plan["omax"])
    own_p = (np.searchsorted(plan["starts"], np.arange(n), side="right")
             - 1).astype(np.int64)
    # the global node of every local slot (dead slots alias node 0, masked):
    # the map :func:`localize` differentiates
    glob_ids = H.localize_rank(plan, np.arange(n, dtype=np.int64), rank)
    live = H.localize_rank(plan, np.ones(n, dtype=bool), rank)
    plan.update(rank=rank, coarse_m=coarse_m, mg_plan=mg_plan, format=fmt, block=B,
                glob_ids=glob_ids, live_mask=live,
                group={"omax": omax, "own_p": own_p,
                       "own_slot": np.arange(n) - plan["starts"][own_p]})

    def loc(t):
        a = t.numpy() if torch.is_tensor(t) else np.asarray(t)
        return H.localize_rank(plan, a, rank)

    dtype = md.dtype

    def f(t):
        return torch.as_tensor(loc(t), dtype=dtype, device=dev)

    # a rank whose nodes' cells all live on lower ranks keeps one padding
    # cell at slot 0 (zero weight, as the JAX package pads its shards), so
    # that its operator has the structure every rank's has
    pad = nc == 0
    cell_ids = plan["cell_ids"][rank, :max(nc, 1)]
    halo = H.Halo(plan, rank, dtype, dev, group)
    # the coordinates in float64 (the geometry of the rank's cells is then
    # the global mesh's, bit for bit)
    nodes64 = md.nodes[np.argsort(md.node_iperm)]
    lmesh = build_mesh(loc(nodes64), plan["local_cells"][rank, :max(nc, 1)],
                       dtype=dtype, device=dev, operator=fmt, bell_block=B,
                       node_area=loc(mesh.node_area),
                       cell_valid=np.zeros(1) if pad else None)
    lmesh = dataclasses.replace(
        lmesh, halo=halo, coarse_m=coarse_m,
        coarse_agg=torch.as_tensor(loc(agg_global), device=dev),
        mg=None if mg_plan is None else localize_hierarchy(
            mg_plan, cell_ids, loc(np.arange(n)), dev))
    lstatic = StaticFields(
        z_b=f(static.z_b), z_s=f(static.z_s), G=f(static.G),
        inputs=f(static.inputs), storage=f(static.storage),
        gb0=static.gb0[torch.as_tensor(cell_ids)].to(dev) * (not pad),
        dirichlet=torch.as_tensor(loc(static.dirichlet), device=dev),
        N_bdry=static.N_bdry.to(dev), b_min=static.b_min.to(dev),
        b_max=None if static.b_max is None else f(static.b_max))
    state0 = State(N=f(state.N), b=f(state.b), q=f(state.q),
                   melt=f(state.melt),
                   N_prev=f(state.N if state.N_prev is None else state.N_prev))
    return lmesh, lstatic, state0, cfg, plan


# the nodal static fields a runner can take as its first argument (those
# without freeze-time derived precomputes: z_b and z_s make gb0)
CONTROLS = ("G", "inputs", "storage")


def localize(plan, f_global):
    """This rank's (L,) slots of a global solver-order nodal field
    ``f_global`` (n,): ``f_global[glob_ids] * live_mask``, differentiable:
    the backward adds each live slot's cotangent into its global node over
    a host gather plan (fem/ops.gather_plan, a fixed-order sum), and the sum
    over the ranks completes it (the module docstring)."""
    dev = f_global.device
    ids = torch.as_tensor(plan["glob_ids"], device=dev)
    live = torch.as_tensor(plan["live_mask"], device=dev)

    def bwd(g):
        slots, idx = gather_plan(plan["glob_ids"][plan["live_mask"]])
        return (plan_sum(g[live], torch.as_tensor(slots, device=dev),
                         torch.as_tensor(idx, device=dev), f_global.shape[0]),)

    return H.linear(lambda f: f[ids] * live.to(f.dtype), bwd, f_global)


def make_distributed_runner(md, group=None, device=None, control=None):
    """(runner, state0, plan): runner(state, forcing) -> (state, diags), this
    rank's share of the transient (run_window over the rank's step); every
    rank calls it with the same forcing and gets the same diagnostics.
    ``plan`` (:func:`build_distributed`) also holds this rank's mesh,
    static fields, config and step ('mesh', 'static', 'cfg', 'step').

    ``control``: one of :data:`CONTROLS`, the nodal static field that the
    runner takes as an argument instead of the frozen one:
    runner(field_local, state, forcing), ``field_local`` this rank's (L,)
    slots (:func:`localize`).  The step is then built inside each call, so
    that with cfg.differentiable a gradient reaches the field (the field
    inversion of the module docstring)."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"control must be one of {set(CONTROLS)}, "
                         f"got '{control}'")
    mesh, static, state0, cfg, plan = build_distributed(md, group, device)
    step = make_step_fn(mesh, static, md.params, cfg)
    plan.update(mesh=mesh, static=static, cfg=cfg, step=step)
    if control is None:
        return (lambda state, forcing: run_window(step, state, forcing)), \
            state0, plan

    def runner(field_local, state, forcing):
        st = dataclasses.replace(static, **{control: field_local})
        return run_window(make_step_fn(mesh, st, md.params, cfg), state,
                          forcing)

    return runner, state0, plan


def make_distributed_steady_runner(md, group=None, device=None,
                                   cycle_window: int = 0, **steady_kw):
    """(runner, state0, plan): runner(state) -> (state, info), the
    pseudo-transient steady march (solve/steady.py) on this rank's share,
    with every norm, max and test over the ranks (identical decisions on
    every rank).  ``steady_kw`` goes to steady_solve (tol, dt0, max_steps,
    ...).  With ``cycle_window > 0``, ``plan["cycle_run"]``: (state, dt) ->
    (mean_state, info), solve.steady.cycle_certify on the same share."""
    from shakti_tpu_torch.solve.steady import (cycle_certify, make_steady_step,
                                               steady_solve)
    mesh, static, state0, cfg, plan = build_distributed(md, group, device)
    step, cfg = make_steady_step(mesh, static, md.params, cfg)
    # N-pinned nodes leave the drift certificate (api/steady.py)
    mask = ~static.dirichlet
    plan.update(mesh=mesh, static=static, cfg=cfg, step=step)

    def runner(state):
        return steady_solve(step, state, params=md.params, drift_mask=mask,
                            mesh=mesh, **steady_kw)

    if cycle_window:
        def cycle_run(state, dt):
            return cycle_certify(
                step, state, params=md.params, dt=dt,
                tol=steady_kw.get("tol", 1e-2),
                t_ref=steady_kw.get("t_ref", 3.1536e7), window=cycle_window,
                max_rel_change=steady_kw.get("max_rel_change", 0.5),
                drift_mask=mask, mesh=mesh)

        plan["cycle_run"] = cycle_run
    return runner, state0, plan


def gather_state(plan, state: State) -> State:
    """This rank's share -> the global solver-order State, on every rank
    (one gather per field: every rank must reach this call)."""
    from shakti_tpu_torch.utils.multihost import to_host
    P, L = plan["P"], plan["L"]

    def g(a):
        full = to_host(a).reshape((P, L) + tuple(a.shape[1:]))
        return torch.as_tensor(H.globalize_nodal(plan, full), device=a.device)

    return State(N=g(state.N), b=g(state.b), q=g(state.q), melt=g(state.melt),
                 N_prev=None if state.N_prev is None else g(state.N_prev))


def pack_owned(state: State, omax: int):
    """One rank's save row (4 omax,): N, b, qx, qy at its owned slots (the
    slots past its own count hold its ghosts' values, which the stitch
    skips)."""
    return torch.cat([state.N[:omax], state.b[:omax], state.q[:omax, 0],
                      state.q[:omax, 1]])


def stitch_rows(plan, rows: np.ndarray) -> np.ndarray:
    """(P, g, 4 omax) gathered owned rows -> (g, 4 n) global solver-order
    save rows (N, b, qx, qy)."""
    grp = plan["group"]
    omax, own_p, own_slot = grp["omax"], grp["own_p"], grp["own_slot"]
    return np.concatenate([rows[own_p, :, k * omax + own_slot].T
                           for k in range(4)], axis=1)
