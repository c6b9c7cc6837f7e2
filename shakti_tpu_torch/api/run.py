"""Transient run loop + results IO: the port of shakti_tpu/api/run.py
(single device).

Reproduces the reference's run protocol (reference solvers.py:57-238):
the results directory must not pre-exist unless resuming; t.npy,
nodes_x.npy and nodes_y.npy are written up front and the setup file is
copied in; nodal N/b/qx/qy history rows are saved after step i whenever
i % nt_save == 0, in the caller's node order, into memmap-backed .npy
files; a rolling checkpoint (without the carried operator) lands at the
first save past every nt_check steps and a final one (with it) at the end
(io/checkpoint.py); a step that fails to converge raises
:class:`ConvergenceError`.  Per-save solver diagnostics go to log.csv.

Steps run in windows that end exactly at save events.  Consecutive equal
save windows form groups (:func:`_group_windows`) whose save rows
accumulate on the device and reach the host in one pull.  The JAX
package's dispatch-ahead (host bookkeeping of one group while the device
runs the next) has no counterpart here: the host drives every step
(ROADMAP K8).  ``md.bootstrap_steps`` marches the first steps in float64 on
the run's own device (:func:`_bootstrap_f64`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time

import numpy as np
import torch

from shakti_tpu_torch.io import checkpoint as ckpt
from shakti_tpu_torch.solve.timestep import make_forcing, make_step_fn, run_window
from shakti_tpu_torch.utils.backend import resolve_device

KEYS = ("N", "b", "qx", "qy")


class ConvergenceError(RuntimeError):
    pass


def _save_windows(nt: int, nt_save: int, start: int):
    """Yield (start, length, save_after) covering steps [start, nt) with
    windows ending at save events (i % nt_save == 0 saves AFTER step i)."""
    i = start
    while i < nt:
        r = i % nt_save
        nxt = i if r == 0 else i + (nt_save - r)
        if nxt >= nt:
            yield i, nt - i, False
            return
        yield i, nxt - i + 1, True
        i = nxt + 1


def _ck_due(i0: int, last: int, nt_check: int) -> bool:
    """True when steps [i0, last] contain a rolling-checkpoint event (a
    multiple of nt_check, step 0 included): with nt_check not a multiple of
    nt_save the checkpoint lands at the save that ends that window."""
    return (last // nt_check) > ((i0 - 1) // nt_check)


def _group_windows(windows, nt_check: int, max_group: int):
    """Group consecutive equal-length save windows (at most ``max_group``)
    so that one device->host pull covers the group's save rows.  A window
    with a checkpoint event ends its group (the checkpoint needs the state
    at that window's end); irregular (first, partial, non-save) windows run
    as groups of one."""
    cur = []
    for w in windows:
        i0, wlen, do_save = w
        if cur and (not do_save or wlen != cur[0][1]):
            yield cur
            cur = []
        if not do_save:
            yield [w]
            continue
        cur.append(w)
        if _ck_due(i0, i0 + wlen - 1, nt_check) or len(cur) >= max_group:
            yield cur
            cur = []
    if cur:
        yield cur


def _pack(state):
    """One save row, (4 n,): N, b, qx, qy in solver order."""
    return torch.cat([state.N, state.b, state.q[:, 0], state.q[:, 1]])


def _diag_rows(dg) -> np.ndarray:
    """(4, wlen) float64: converged, newton iters, cg iters, rnorm."""
    return np.stack([np.asarray(dg[k], np.float64) for k in
                     ("converged", "newton_iters", "cg_iters", "rnorm")])


def _window_forcing(forcing, i0, wlen):
    return {k: v[i0:i0 + wlen] for k, v in forcing.items()}


def _bootstrap_f64(md, timesteps, nt_save, k_steps):
    """March the first ``k_steps`` (rounded up to a save boundary) in
    float64, whatever the run's marching dtype.

    Why: the reference's exact cold start (setup_cooke2.py,
    b = 0.001 + N(0, 0.005) unclamped) is solvable by its direct LU but not
    certifiable by an f32 Newton-Krylov; f64 powers through the violent
    first steps, after which f32 certifies the rest.  The JAX package
    marches this on the host CPU because the TPU lacks float64; the card
    has it, so the port freezes a float64 twin of the model on the run's
    own device (the f64 kernel entries) and marches it with the run's
    save-window protocol.

    Returns (state64, windows, boot_end): the windows' (i0, wlen, flat save
    row or None, (4, wlen) diagnostics) for the caller to replay into its
    histories, and the first step the main loop runs."""
    k = int(k_steps)
    nt = timesteps.size
    if k % nt_save:
        k += nt_save - (k % nt_save)
    k = min(k, nt - 1)
    old_dtype = md.dtype
    md.dtype = torch.float64
    try:
        mesh, static, state, cfg = md.freeze()
    finally:
        md.dtype = old_dtype
    step_fn = make_step_fn(mesh, static, md.params, cfg)
    forcing = make_forcing(timesteps, dtype=torch.float64,
                           device=mesh.nodes.device,
                           seasonal=md.seasonal_inputs,
                           degree_day=md.degree_day)
    wins = []
    for i0, wlen, do_save in _save_windows(k + 1, nt_save, 0):
        state, dg = run_window(step_fn, state, _window_forcing(forcing, i0, wlen))
        flat = _pack(state).cpu().numpy() if do_save else None
        wins.append((i0, wlen, flat, _diag_rows(dg)))
    return state, wins, k + 1


def solve(md, *, resume: bool = False, progress: bool = True):
    """Run the transient problem defined by a ModelSetup on md.device.

    ``resume``: continue from the results directory's checkpoint.npz (one
    written by either package), or start afresh when there is none.
    Returns dict(state, history, t, wall_time, newton_iters_total,
    cg_iters_total, steps, host_pulls).  Writes the reference-compatible
    results directory when ``md.results_name`` is set."""
    md.validate()
    dev = resolve_device(md.device)
    timesteps = np.asarray(md.timesteps, dtype=np.float64)
    nt = timesteps.size
    nt_save = int(md.nt_save) if md.nt_save else 1
    nt_check = int(md.nt_check) if md.nt_check else max(nt_save * 50, nt_save)
    n_saves = -(-nt // nt_save)
    n_nodes = md.nodes.shape[0]
    hist_dt = np.dtype(np.float64 if md.dtype == torch.float64 else np.float32)

    io_on = md.results_name is not None
    rdir = str(md.results_name) if io_on else None
    start_step, row, loaded = 0, 0, None
    mesh, static, state0, cfg = md.freeze(dev)
    if io_on:
        mesh_fp = ckpt.mesh_fingerprint(md.nodes)
        if resume:
            loaded = ckpt.load_state(rdir, dtype=md.dtype, device=dev,
                                     fingerprint=mesh_fp, mesh=mesh)
        if loaded is not None:
            _, start_step, row = loaded
        else:
            try:
                os.makedirs(rdir, exist_ok=False)
            except FileExistsError:
                raise FileExistsError(
                    f"Error: Directory '{rdir}' already exists.\n"
                    "Choose another name in setup file or delete this "
                    "directory.") from None
        np.save(os.path.join(rdir, "t.npy"),
                np.linspace(0, timesteps.max(), n_saves))
        np.save(os.path.join(rdir, "nodes_x.npy"), md.x)
        np.save(os.path.join(rdir, "nodes_y.npy"), md.y)
        if md.setup_file and os.path.exists(str(md.setup_file)):
            shutil.copy(str(md.setup_file),
                        os.path.join(rdir, os.path.basename(str(md.setup_file))))

    def open_hist(k):
        """A memmap-backed history: reopened in place on resume, or
        extended (through a .new file) when the run grew longer."""
        f = os.path.join(rdir, f"{k}.npy")
        if start_step > 0 and os.path.exists(f):
            old = np.lib.format.open_memmap(f, mode="r+")
            if old.shape == (n_saves, n_nodes) and old.dtype == hist_dt:
                return old
            mm = np.lib.format.open_memmap(f + ".new", mode="w+", dtype=hist_dt,
                                           shape=(n_saves, n_nodes))
            m = min(old.shape[0], n_saves)
            mm[:m] = old[:m]
            mm.flush()
            del mm, old
            os.replace(f + ".new", f)
            return np.lib.format.open_memmap(f, mode="r+")
        return np.lib.format.open_memmap(f, mode="w+", dtype=hist_dt,
                                         shape=(n_saves, n_nodes))

    if io_on:
        hist = {k: open_hist(k) for k in KEYS}
    else:
        hist = {k: np.zeros((n_saves, n_nodes), dtype=hist_dt) for k in KEYS}
    log_rows = []
    if io_on and start_step > 0 and os.path.exists(os.path.join(rdir, "log.csv")):
        # keep the pre-resume diagnostics (log.csv is rewritten whole)
        with open(os.path.join(rdir, "log.csv")) as f:
            log_rows = [tuple(ln.strip().split(",")) for ln in f.readlines()[1:]
                        if ln.strip() and int(ln.split(",")[0]) < start_step]

    def write_histories():
        if io_on:
            for k in KEYS:
                hist[k].flush()

    def write_log():
        with open(os.path.join(rdir, "log.csv"), "w") as f:
            f.write("step,t,newton_mean,newton_max,cg_mean,rnorm_max,N_min\n")
            for r in log_rows:
                f.write(",".join(str(v) for v in r) + "\n")

    if loaded is None:
        state = state0
    else:
        state = loaded[0]
        if cfg.lag_operator:
            lag, ref = state.lag_op, state0.lag_op
            same = lag is not None and all(
                (a is None) == (b is None)
                and (not torch.is_tensor(b) or tuple(a.shape) == tuple(b.shape))
                for a, b in zip(lag, ref))
            if not same:
                # written without the carry (a rolling checkpoint) or under
                # another operator format or coarse size: reseed, so the
                # first resumed step rebuilds instead of reusing
                lag = ref
            state = dataclasses.replace(state, lag_op=lag)
        elif state.lag_op is not None:
            state = dataclasses.replace(state, lag_op=None)
    forcing = make_forcing(timesteps, dtype=md.dtype, device=dev,
                           seasonal=md.seasonal_inputs,
                           degree_day=md.degree_day)
    step_fn = make_step_fn(mesh, static, md.params, cfg)

    # a group's save rows wait on the device: cap them at ~32 MB
    itemsize = hist_dt.itemsize
    max_group = max(1, min(64, int(32e6 / (itemsize * (4 * n_nodes
                                                       + 4 * nt_save)))))
    if os.environ.get("SHAKTI_RUN_GROUP"):      # A/B and test override
        max_group = max(1, int(os.environ["SHAKTI_RUN_GROUP"]))

    newton_total = cg_total = host_pulls = 0
    unp = md.node_iperm if md.node_iperm is not None else slice(None)

    def consume(i0, wlen, flat, dg, ck_state):
        """Host bookkeeping of one window from its pulled save row (or None)
        and its diagnostics.  ``ck_state`` is the state at the end of the
        window's group, for a rolling checkpoint; None writes none (the
        bootstrap replay has only its end state)."""
        nonlocal row, newton_total, cg_total
        conv, ni, ci, rn = dg[0] > 0.0, dg[1], dg[2], dg[3]
        if not conv.all():
            bad = i0 + int(np.argmin(conv))
            write_histories()
            raise ConvergenceError(
                f"Newton failed to converge at time step {bad} "
                f"(residual {float(rn[bad - i0]):.3e})")
        newton_total += int(ni.sum())
        cg_total += int(ci.sum())
        last = i0 + wlen - 1
        if flat is None:
            return last
        vals = [flat[k * n_nodes:(k + 1) * n_nodes] for k in range(4)]
        for k, v in zip(KEYS, vals):
            hist[k][row] = v[unp]
        log_rows.append((last, float(timesteps[last]), float(ni.mean()),
                         int(ni.max()), float(ci.mean()), float(rn.max()),
                         float(vals[0].min())))
        row += 1
        if io_on and ck_state is not None and _ck_due(i0, last, nt_check):
            write_histories()
            write_log()
            ckpt.save_state(rdir, ck_state, last + 1, row,
                            fingerprint=mesh_fp, include_lag=False)
        return last

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    boot_steps = int(md.bootstrap_steps or 0)
    if boot_steps > 0 and start_step == 0 and md.dtype != torch.float64:
        s64, bwins, boot_end = _bootstrap_f64(md, timesteps, nt_save, boot_steps)

        def cast(t):
            return t.to(md.dtype)

        state = dataclasses.replace(
            state, N=cast(s64.N), b=cast(s64.b), q=cast(s64.q),
            melt=cast(s64.melt),
            N_prev=None if state.N_prev is None else cast(s64.N_prev))
        for i0, wlen, flat, dg in bwins:
            consume(i0, wlen, None if flat is None else flat.astype(hist_dt),
                    dg, None)
        start_step = boot_end
        if io_on:
            # one checkpoint at the bootstrap boundary: the state after step
            # boot_end - 1 with next_step = boot_end
            write_histories()
            write_log()
            ckpt.save_state(rdir, state, boot_end, row, fingerprint=mesh_fp,
                            include_lag=False)
        if progress:
            print(f"f64 bootstrap: steps 0..{boot_end - 1} marched in float64 "
                  f"on {dev}, continuing in {hist_dt.name}")

    windows = list(_save_windows(nt, nt_save, start_step))
    for grp in _group_windows(windows, nt_check, max_group):
        rows, dgs = [], []
        for i0, wlen, do_save in grp:
            state, dg = run_window(step_fn, state,
                                   _window_forcing(forcing, i0, wlen))
            dgs.append(_diag_rows(dg))
            if do_save:
                rows.append(_pack(state))
            if not dg["converged"].all():
                break                   # consume below raises at this window
        pulled = None
        if rows:
            pulled = torch.stack(rows).cpu().numpy()           # one pull
            host_pulls += 1
        j = 0
        for (i0, wlen, do_save), dg in zip(grp, dgs):
            flat = None
            if do_save:
                flat, j = pulled[j], j + 1
            last = consume(i0, wlen, flat, dg, state)
        if progress:
            print(f"Time step {last + 1} of {nt} completed "
                  f"({(last + 1) / nt * 100:.1f}%)", end="\r", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    steps_run = nt - start_step
    if io_on:
        write_histories()
        write_log()
        ckpt.save_state(rdir, state, nt, row, fingerprint=mesh_fp, mesh=mesh)
        with open(os.path.join(rdir, "run_meta.json"), "w") as f:
            json.dump({
                "wall_s": round(wall, 3),
                "steps": steps_run,
                "ms_per_step": round(1e3 * wall / max(steps_run, 1), 3),
                "platform": dev.type,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "dtype": hist_dt.name,
                "n_nodes": int(n_nodes),
                "resumed_from": start_step,
            }, f, indent=1)

    return {
        "state": state,
        "history": hist,
        "t": np.linspace(0, timesteps.max(), n_saves),
        "wall_time": wall,
        "newton_iters_total": newton_total,
        "cg_iters_total": cg_total,
        "steps": steps_run,
        # device->host pulls of save rows (one per group)
        "host_pulls": host_pulls,
    }
