"""Transient run loop + results IO: the port of shakti_tpu/api/run.py
(single device).

Reproduces the reference's run protocol (reference solvers.py:57-238):
the results directory must not pre-exist; t.npy, nodes_x.npy, nodes_y.npy
are written up front and the setup file is copied in; nodal N/b/qx/qy
history rows are saved after step i whenever i % nt_save == 0, in the
caller's node order; a step that fails to converge raises
:class:`ConvergenceError`.  Per-save solver diagnostics go to log.csv.

Steps run in windows that end exactly at save events.  Checkpoint/resume,
window grouping and the float64 cold-start bootstrap are not ported yet
(ROADMAP).
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from shakti_tpu_torch.solve.timestep import make_forcing, make_step_fn, run_window


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


def solve(md, *, resume: bool = False, progress: bool = True):
    """Run the transient problem defined by a ModelSetup on md.device.

    Returns dict(state, history, t, wall_time, newton_iters_total,
    cg_iters_total, steps).  Writes the reference-compatible results
    directory when ``md.results_name`` is set."""
    if resume:
        raise NotImplementedError(
            "resume: checkpoint/resume is not ported yet (ROADMAP, still to "
            "port, item 2)")
    md.validate()
    if int(md.bootstrap_steps or 0) > 0 and md.dtype != torch.float64:
        raise NotImplementedError(
            "md.bootstrap_steps: the float64 cold-start bootstrap is not "
            "ported yet (ROADMAP, still to port, item 4)")
    timesteps = np.asarray(md.timesteps, dtype=np.float64)
    nt = timesteps.size
    nt_save = int(md.nt_save) if md.nt_save else 1
    n_saves = -(-nt // nt_save)
    n_nodes = md.nodes.shape[0]

    io_on = md.results_name is not None
    rdir = str(md.results_name) if io_on else None
    if io_on:
        try:
            os.makedirs(rdir, exist_ok=False)
        except FileExistsError:
            raise FileExistsError(
                f"Error: Directory '{rdir}' already exists.\n"
                "Choose another name in setup file or delete this directory."
            ) from None
        np.save(os.path.join(rdir, "t.npy"), np.linspace(0, timesteps.max(), n_saves))
        np.save(os.path.join(rdir, "nodes_x.npy"), md.x)
        np.save(os.path.join(rdir, "nodes_y.npy"), md.y)
        if md.setup_file and os.path.exists(str(md.setup_file)):
            shutil.copy(str(md.setup_file),
                        os.path.join(rdir, os.path.basename(str(md.setup_file))))

    mesh, static, state, cfg = md.freeze()
    dev = mesh.nodes.device
    forcing = make_forcing(timesteps, dtype=md.dtype, device=dev,
                           seasonal=md.seasonal_inputs,
                           degree_day=md.degree_day)
    step_fn = make_step_fn(mesh, static, md.params, cfg)

    hist_dt = np.float64 if md.dtype == torch.float64 else np.float32
    keys = ("N", "b", "qx", "qy")
    if io_on:
        # memmap-backed .npy histories: each row lands on disk once
        hist = {k: np.lib.format.open_memmap(
            os.path.join(rdir, f"{k}.npy"), mode="w+", dtype=hist_dt,
            shape=(n_saves, n_nodes)) for k in keys}
    else:
        hist = {k: np.zeros((n_saves, n_nodes), dtype=hist_dt) for k in keys}
    log_rows = []

    def write_histories():
        if io_on:
            for k in keys:
                hist[k].flush()

    def write_log():
        with open(os.path.join(rdir, "log.csv"), "w") as f:
            f.write("step,t,newton_mean,newton_max,cg_mean,rnorm_max,N_min\n")
            for r in log_rows:
                f.write(",".join(str(v) for v in r) + "\n")

    newton_total = cg_total = row = 0
    unp = md.node_iperm if md.node_iperm is not None else slice(None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    for i0, wlen, do_save in _save_windows(nt, nt_save, 0):
        f_win = {k: v[i0:i0 + wlen] for k, v in forcing.items()}
        state, dg = run_window(step_fn, state, f_win)
        conv, ni, ci, rn = dg["converged"], dg["newton_iters"], dg["cg_iters"], dg["rnorm"]
        if not conv.all():
            bad = i0 + int(np.argmin(conv))
            write_histories()
            raise ConvergenceError(
                f"Newton failed to converge at time step {bad} "
                f"(residual {float(rn[bad - i0]):.3e})")
        newton_total += int(ni.sum())
        cg_total += int(ci.sum())
        last = i0 + wlen - 1
        if do_save:
            flat = torch.cat([state.N, state.b, state.q[:, 0], state.q[:, 1]])
            flat = flat.cpu().numpy()
            for j, k in enumerate(keys):
                hist[k][row] = flat[j * n_nodes:(j + 1) * n_nodes][unp]
            log_rows.append((last, float(timesteps[last]), float(ni.mean()),
                             int(ni.max()), float(ci.mean()), float(rn.max()),
                             float(hist["N"][row].min())))
            row += 1
        if progress:
            print(f"Time step {last + 1} of {nt} completed "
                  f"({(last + 1) / nt * 100:.1f}%)", end="\r", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    if io_on:
        write_histories()
        write_log()
        with open(os.path.join(rdir, "run_meta.json"), "w") as f:
            json.dump({
                "wall_s": round(wall, 3),
                "steps": nt,
                "ms_per_step": round(1e3 * wall / max(nt, 1), 3),
                "platform": dev.type,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "dtype": str(np.dtype(hist_dt)),
                "n_nodes": int(n_nodes),
            }, f, indent=1)

    return {
        "state": state,
        "history": hist,
        "t": np.linspace(0, timesteps.max(), n_saves),
        "wall_time": wall,
        "newton_iters_total": newton_total,
        "cg_iters_total": cg_total,
        "steps": nt,
    }
