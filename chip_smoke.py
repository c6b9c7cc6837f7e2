"""Smoke test of the PyTorch/CUDA port (shakti_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU
    python3 chip_smoke.py --phases kernel,scale   # a subset, for debugging

Phases (any failure raises: exit code != 0 and no result line):
  1. the card: torch.cuda must be available; prints its name and
     nvidia-smi's name/power limit;
  2. build: compiles csrc/bell_spmv.cu and csrc/ell_spmv.cu with nvcc for
     sm_90a, one nvcc per source, started together;
  3. bell_spmv vs plain: the block-ELL operator kernel (the structural
     nonzeros of vals, with and without the fused Dirichlet/diagonal-floor
     epilogue) on the bench operator (Cook_E2 mesh, NB 96, KB 11, B 128,
     n 12,270, W 10; seeded element blocks folded as the main path folds
     them, the bench Dirichlet mask, a seeded increment), in float32 and
     float64, plus a small ragged case: bitwise equal to its mirror twin
     over the structural view, within float32 rtol 2e-6 / atol 1e-6 max|y|
     (float64 1e-12) of the dense plain twin, and bitwise repeatable.
     Times at the bench shape: the kernel's device time per launch from
     torch.profiler (median of 50; also with the L2 cache flushed), the
     time per call between CUDA events (host work included: the measure
     of "ms" since the first kernel), the dense plain twin's and one torch
     sparse CSR mv's (the library yardstick) both ways, the host's time per
     matvec fused (one launch) and composed as before the fusion (where,
     the product, where, mul, add), and the bound from the bytes the
     function needs at 3.35 TB/s;
  4. goldens on the card: the slab and lake golden cases in float64
     through the port, against tests/goldens/*.npz at
     tests/test_goldens.py's tolerance (1e-7 of scale), every step
     converged;
  5. main path at full size: the bench model (setups/setup_bench.py, a port
     of bench.py:build_bench_model) through api/run.solve for 2 simulated
     days (48 hourly steps, f32, lag on) into a temporary results dir; every
     step converged, all fields finite, history files present, the
     kernel launched by that run, the carried operator zero outside the
     structural view, and newton_mean / cg_mean within 5 % of the
     earlier dense kernel's;
  6. profile: one more simulated day, timed, then under torch.profiler
     (device busy share, launches and host syncs per step, device time by
     op, the kernel's launches and device time on the path), to show where
     a steady step's time goes;
  7. ell_spmv vs plain: the scalar-ELL/block-CSR operator kernel over the
     structural values (W, n) at the bench mesh in ELL and in BCSR (B 32),
     at phase 8's 1,002,001-node BCSR mesh and a ragged n = 169 case in
     both, float32 and float64, with and without the epilogue: bitwise
     equal to its plain version (its mirror: the same operations in the
     same order) and between two launches, within phase 3's tolerances of
     the dense plain product (fem/ell.to_dense, then the JAX-layout
     matvec); the structural fold scattered by to_dense equals the dense
     fold bit for bit; device time per launch (profiler, median of 50),
     the bytes bound (one value and one 4-byte column per structural
     nonzero, 4 bytes per row, the vectors) and a torch sparse CSR mv of
     the same entries;
  8. large mesh: scripts/scale_bench.py's configuration on the port
     (rectangle_mesh(1000, 1000, 2e6, 2e6, jitter 0.25): 1,002,001 nodes,
     2M triangles, f32, two-level, no lag), "auto" -> block-CSR B 32,
     coarse block 1024, 24 steps through api/run.solve with nt_save 12:
     every step converged, fields finite, ell_spmv launched and no plain
     version called, every fold the structural (W, n) (never the
     nnzb * B * B blocks); ms/step of the second window, counts, peak
     memory and the host time of freeze; then three more steps under
     torch.profiler (device busy share, launches and host syncs per step,
     device time by op);
  9. formats agree: the bench model in float64 for 4 hourly steps under
     bell, ell, bcsr (B 32) and cells: all converge, final N and b in user
     order within 1e-7 of scale of bell's; Newton and CG counts per format;
 10. resume: phase 5's uninterrupted run against 25 steps then --resume
     through cli.main to step 48: N, b, q and the four histories equal;
 11. bootstrap: setup_cooke2 (the committed mesh, SHAKTI_REFERENCE_BINIT=1)
     for 3 days: 24 float64 bootstrap steps marched on the card (every
     bootstrap tensor float64 on cuda), then float32; all 72 converge;
 12. BiCGStab: the bench model in float64 for 4 steps with
     krylov="bicgstab": converges, N within 1e-7 of scale of phase 9's cg.
The line before the last is a JSON object with the kernels' numbers; the
last line is {"ok": true, "device": {...}}.
"""

import argparse
import concurrent.futures
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def host_us(fn, reps=1000, warmup=20) -> float:
    """Host time of one fn() call in microseconds: perf_counter around
    ``reps`` calls issued back to back (the card runs behind them), before
    the final synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def median_ms(fn, reps=50, warmup=5) -> float:
    """Median time of one fn() call between two CUDA events over ``reps``
    calls: the host work inside fn (Python, allocation, the launch) counts
    too."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def queued_ms(fn, reps=50, between=None) -> float:
    """Device time of one fn() call without the profiler: ``reps`` calls
    queued behind a device-side sleep, so that the card runs them back to
    back, timed between two CUDA events (the gaps between kernels count).
    With ``between``: the time of between() + fn() less that of between()
    alone, queued the same way.  The sleep doubles until the host has
    queued every call before the card reaches the first event."""
    def run(body):
        cycles = 50_000_000
        for _ in range(6):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            a.record()
            for _ in range(reps):
                body()
            b.record()
            late = a.query()        # the card reached `a` before all were queued
            torch.cuda.synchronize()
            if not late:
                return a.elapsed_time(b) / reps
            cycles *= 2
        raise RuntimeError("queued_ms: the host could not queue the calls "
                           "ahead of the card")
    if between is None:
        return run(fn)
    return run(lambda: (between(), fn())) - run(between)


def device_ms(fn, match=None, reps=50, warmup=5, between=None) -> float:
    """Device time from torch.profiler (CUPTI).  With ``match``: the median
    over ``reps`` calls of the one kernel per call whose name contains it
    (``between`` runs untimed before each call).  Without: all device time
    of ``reps`` calls over ``reps`` (a call may launch several kernels).
    CUPTI drops records at random, at times a whole session's (seen on an
    H100 with torch 2.11): with ``match`` the records of up to eight
    sessions are pooled until they hold ``reps``; without, the session
    that kept the most records of three (up to eight while none kept any)
    is taken.  If the profiler still kept too few, the time comes from
    :func:`queued_ms` and the log says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if between is not None and match is None:
        raise ValueError("device_ms: `between` needs `match`")
    for _ in range(warmup):
        fn()
    pool, best = [], []
    for attempt in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if match is None:
            if len(evs) > len(best):
                best = [e.time_range.elapsed_us() for e in evs]
            if best and attempt >= 2:
                return sum(best) / reps / 1e3
            continue
        us = [e.time_range.elapsed_us() for e in evs if match in e.name]
        if len(us) != reps:
            log(f"  profiler kept {len(us)} of {reps} {match!r} records")
        pool += us
        if len(pool) >= reps:
            return float(np.median(pool)) / 1e3
    ms = queued_ms(fn, reps, between)
    log(f"  profiler kept {len(pool) or len(best)} records in eight sessions "
        f"of {reps} calls ({match!r}): {ms:.5f} ms from CUDA events around "
        f"{reps} calls queued behind a sleep")
    return ms


def check_close(name, got, ref, rtol, atol_rel):
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    atol = atol_rel * np.abs(ref).max()
    err = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)
    log(f"  {name}: max|kernel - plain| = {err:.3e} (max|y| "
        f"{np.abs(ref).max():.3e}, rtol {rtol:g}, atol {atol:.3e})")
    return err


def bitwise_equal(a, b) -> bool:
    itype = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(itype), b.view(itype))


TOLS = ((torch.float32, 2e-6, 1e-6), (torch.float64, 1e-12, 1e-12))
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, NVIDIA data sheet
FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # outside tensor cores


def operator_inputs(mesh, dirichlet, rng):
    """Seeded operator inputs as the main path makes them: element blocks
    folded by fem/bell.bell_from_elements, x, and a non-negative diagonal
    increment that is zero on Dirichlet rows."""
    dev = mesh.nodes.device
    J = rng.standard_normal((mesh.n_cells, 3, 3))
    x = rng.standard_normal(mesh.n_nodes)
    extra = rng.random(mesh.n_nodes) * ~dirichlet.cpu().numpy()
    return {k: torch.as_tensor(v, device=dev) for k, v in
            (("J", J), ("x", x), ("extra", extra))}


def wrappers(kernel):
    """(operator_fn, dense plain product, mirror) of kernel 'bell_spmv' or
    'ell_spmv' (ops/spmv_cuda.py); ell_spmv's mirror is its plain
    version."""
    from shakti_tpu_torch.ops import spmv_cuda as sp
    if kernel == "bell_spmv":
        return (sp.bell_operator_fn, sp.bell_operator_plain,
                sp.bell_operator_structural)
    return sp.ell_operator_fn, sp.ell_operator_dense, sp.ell_operator_plain


def check_operator(tag, vals, mesh, x, dirichlet, extra, rtol, atol_rel,
                   kernel="bell_spmv"):
    """The kernel against its mirror twin (bitwise), the plain twin
    (tolerance) and itself (bitwise); returns the error against the plain
    twin."""
    operator_fn, plain, mirror = wrappers(kernel)
    op = operator_fn(vals, mesh, dirichlet, extra)
    y = op(x)
    ym = mirror(vals, mesh, x, dirichlet, extra)
    dense = plain(vals, mesh, x, dirichlet, extra)
    torch.cuda.synchronize()
    if not bitwise_equal(y, ym):
        bad = int((y != ym).sum())
        raise RuntimeError(f"{kernel} {tag}: differs from its mirror twin in "
                           f"{bad} rows (max {float((y - ym).abs().max())})")
    err = check_close(tag, y, dense, rtol, atol_rel)
    if not bitwise_equal(op(x), y):
        raise RuntimeError(f"{kernel} {tag}: two launches differ")
    return err


def bound(nnz, n, dtype, epilogue: bool, index_bytes: int, row_bytes: int):
    """(ms, 'bytes' or 'operations'): the least time of one operator matvec
    on this card's published peaks, from what this run's operator needs:
    each structural nonzero's value and ``index_bytes`` of indices,
    ``row_bytes`` per row, x and y once, plus the mask and extra with the
    epilogue; 2 flops a nonzero (3 per row more with the epilogue)."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = nnz * (es + index_bytes) + row_bytes * n + 2 * n * es
    if epilogue:
        nbytes += n + n * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (2 * nnz + (3 * n if epilogue else 0)) / FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bell_bound(mesh, dtype, epilogue: bool):
    """bell_spmv: one int32 position per nonzero, one int32 length a row."""
    nnz = int((mesh.bell_nz_pos >= 0).sum())
    return bound(nnz, mesh.n_nodes, dtype, epilogue, 4, 4)


def ell_bound(mesh, dtype, epilogue: bool, index_bytes=4, row_bytes=4):
    """ell_spmv: what any sparse format must read, one int32 column per
    structural nonzero and 4 bytes per row (a length or an offset).  With
    (8, 0): the bound as it was counted for the earlier kernel, a position
    and a column per nonzero."""
    nnz = int((mesh.nz_pos >= 0).sum())
    return bound(nnz, mesh.n_nodes, dtype, epilogue, index_bytes, row_bytes)


def csr_of(vals, pos, col, n):
    """The same structural entries of the same vals as a torch sparse CSR
    matrix (int32 indices, columns ascending in each row): the library
    yardstick, never used by the port.  ``pos``/``col``: a (W, n) view."""
    pos, col = pos.long(), col.long()
    valid = pos >= 0
    rows = torch.arange(n, device=pos.device).expand_as(pos)[valid]
    cols, p = col[valid], pos[valid]
    order = torch.argsort(rows * n + cols)
    rows, cols, p = rows[order], cols[order], p[order]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=pos.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow.int(), cols.int(), vals.reshape(-1)[p],
                                   (n, n), check_invariants=True)


def library_times(r, tag, vals, pos, col, n, x, ref, dtype, atol_rel,
                  flush=None):
    """One torch sparse CSR mv of the same entries: checked against the
    kernel's product ``ref`` and timed (device and events) into ``r``; with
    ``flush`` (a call that empties the L2) also with a cold L2
    (:func:`queued_ms`)."""
    try:
        A = csr_of(vals, pos, col, n)
        check_close(f"{tag} library CSR vs kernel", torch.mv(A, x), ref,
                    1e-5 if dtype == torch.float32 else 1e-12, atol_rel)
        r["library_device_ms"] = device_ms(lambda: torch.mv(A, x))
        r["library_ms"] = median_ms(lambda: torch.mv(A, x))
        if flush is not None:
            r["library_queued_ms_cold_l2"] = queued_ms(
                lambda: torch.mv(A, x), between=flush)
        del A
    except RuntimeError as e:
        log(f"  library sparse CSR mv refused in {tag}: {e}")
        r["library_device_ms"] = r["library_ms"] = None
        if flush is not None:
            r["library_queued_ms_cold_l2"] = None


def phase_kernel(dev, mesh, dirichlet):
    from shakti_tpu_torch.fem.bell import bell_from_elements
    from shakti_tpu_torch.ops.spmv_cuda import (bell_operator_fn,
                                                bell_operator_plain,
                                                view_columns)
    inp = operator_inputs(mesh, dirichlet, np.random.default_rng(0))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)  # > L2
    out = {}
    for dtype, rtol, atol_rel in TOLS:
        tag = str(dtype).removeprefix("torch.")
        vals = bell_from_elements(inp["J"].to(dtype), mesh)
        x, extra = inp["x"].to(dtype), inp["extra"].to(dtype)
        err = {}
        for epi, (d, e) in (("product", (None, None)),
                            ("epilogue", (dirichlet, extra))):
            err[epi] = check_operator(f"bench shape {tag} {epi}", vals, mesh,
                                      x, d, e, rtol, atol_rel)
        op = bell_operator_fn(vals, mesh, dirichlet, extra)
        prod = bell_operator_fn(vals, mesh)
        r = dict(max_abs_err=err["epilogue"], max_abs_err_product=err["product"])
        r["device_ms"] = device_ms(lambda: op(x), "bell_spmv")
        r["device_ms_product"] = device_ms(lambda: prod(x), "bell_spmv")
        r["device_ms_cold_l2"] = device_ms(lambda: op(x), "bell_spmv",
                                           between=flush.zero_)
        r["ms"] = median_ms(lambda: op(x))
        r["plain_device_ms"] = device_ms(
            lambda: bell_operator_plain(vals, mesh, x, dirichlet, extra))
        r["plain_ms"] = median_ms(
            lambda: bell_operator_plain(vals, mesh, x, dirichlet, extra))
        r["host_us"] = host_us(lambda: op(x))
        # the matvec as it was before the fusion: where, product, where, mul, add
        r["host_us_composed"] = host_us(lambda: torch.where(
            dirichlet, x, prod(torch.where(dirichlet, 0.0, x))) + extra * x)
        r["bound_ms"], r["bound_by"] = bell_bound(mesh, dtype, True)
        r["bound_ms_product"], _ = bell_bound(mesh, dtype, False)
        library_times(r, f"bench shape {tag}", vals, mesh.bell_nz_pos,
                      view_columns(mesh.bell_nz_pos, mesh.bell_nbr, mesh.bell_B),
                      mesh.n_nodes, x, prod(x), dtype, atol_rel)
        log(f"  bench shape {tag}: kernel device {r['device_ms']:.5f} ms/launch"
            f" (product only {r['device_ms_product']:.5f}, L2 flushed "
            f"{r['device_ms_cold_l2']:.5f}; median of 50, profiler), "
            f"{r['ms']:.5f} ms/call between CUDA events (host work "
            f"included); dense plain twin {r['plain_device_ms']:.5f} ms "
            f"device/call ({r['plain_ms']:.5f} events); library CSR mv "
            f"{r['library_device_ms']} ms device/call ({r['library_ms']} "
            f"events); bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"(product {r['bound_ms_product']:.5f})")
        log(f"  bench shape {tag}: host time per matvec {r['host_us']:.2f} us"
            f" fused, {r['host_us_composed']:.2f} us composed (where, "
            f"product, where, mul, add)")
        out[tag] = r
        del vals, op, prod
    del flush
    # a small ragged case: 169 nodes in two 128-blocks (12 x 12 slab mesh)
    from shakti_tpu_torch.setups import setup_slab
    md = setup_slab.initialize(nx=12, ny=12)
    md.dtype = torch.float64
    m, st, _, _ = md.freeze(dev)
    inp = operator_inputs(m, st.dirichlet, np.random.default_rng(1))
    for dtype, rtol, atol_rel in TOLS:
        tag = f"ragged n={m.n_nodes} {str(dtype).removeprefix('torch.')}"
        vals = bell_from_elements(inp["J"].to(dtype), m)
        x, extra = inp["x"].to(dtype), inp["extra"].to(dtype)
        check_operator(f"{tag} product", vals, m, x, None, None, rtol, atol_rel)
        check_operator(f"{tag} epilogue", vals, m, x, st.dirichlet, extra,
                       rtol, atol_rel)
    return out


def phase_goldens(dev):
    from shakti_tpu_torch.solve.timestep import (make_step_fn, run_window,
                                                 timestep_sizes)
    # by path: an installed top-level package named "tests" would shadow the
    # repository's tests/ directory (it has no __init__.py)
    spec = importlib.util.spec_from_file_location(
        "torch_golden_cases", os.path.join(HERE, "tests", "torch_golden_cases.py"))
    gc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gc)
    for case in gc.ALL_CASES:
        md, n, fname = case()
        md.dtype, md.device = torch.float64, dev
        mesh, static, state, cfg = md.freeze()
        step = make_step_fn(mesh, static, md.params, cfg)
        t0 = time.perf_counter()
        state, diags = run_window(step, state, timestep_sizes(
            md.timesteps, md.dtype, dev)[:n])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not diags["converged"].all():
            raise RuntimeError(f"{fname}: steps did not converge: "
                               f"{diags['converged']}")
        errs = gc.golden_errors(md, state, fname)
        log(f"  {fname}: {n} steps in {wall:.2f} s, newton "
            f"{diags['newton_iters'].tolist()}, max err/scale "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if max(errs.values()) > gc.GOLDEN_ATOL:
            raise RuntimeError(f"{fname}: golden drift {errs} > {gc.GOLDEN_ATOL}")


# the bench main path's solver counts with the earlier dense-stream kernel
# (48 f32 steps on an H100); a kernel that sums the same terms in another
# order may move them by roundoff, not by more than a few per cent
DENSE_NEWTON_MEAN, DENSE_CG_MEAN = 1.0625, 14.625


def phase_main(dev, tmp):
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.setups import setup_bench
    rdir = os.path.join(tmp, "bench_run")
    md = setup_bench.initialize(days=2, results_name=rdir)
    md.device = dev
    spmv_cuda.reset_launches()
    out = md.solve(progress=False)
    launches = spmv_cuda.launches["bell_spmv"]
    steps = out["steps"]
    if steps != 48:
        raise RuntimeError(f"expected 48 steps, ran {steps}")
    st = out["state"]
    for k in ("N", "b", "q", "melt"):
        if not torch.isfinite(getattr(st, k)).all():
            raise RuntimeError(f"non-finite {k} after the main path")
    n = md.nodes.shape[0]
    for k in ("N", "b", "qx", "qy"):
        h = np.load(os.path.join(rdir, f"{k}.npy"))
        if h.shape != (2, n) or not np.isfinite(h).all():
            raise RuntimeError(f"history {k}.npy: shape {h.shape}")
    for f in ("t.npy", "nodes_x.npy", "nodes_y.npy", "log.csv",
              "setup_bench.py"):
        if not os.path.exists(os.path.join(rdir, f)):
            raise RuntimeError(f"results file {f} missing")
    if launches <= 0:
        raise RuntimeError("the main path never launched the bell_spmv kernel")
    # the kernel reads vals only at the structural view: the carried operator
    # must be zero everywhere else
    vals = st.lag_op[2].reshape(-1)
    pos = md.freeze()[0].bell_nz_pos
    outside = vals.clone()
    outside[pos[pos >= 0].long()] = 0
    if int(torch.count_nonzero(outside)) or not int(torch.count_nonzero(vals)):
        raise RuntimeError(f"carried operator: {int(torch.count_nonzero(outside))}"
                           " nonzeros outside the structural view")
    res = dict(
        nodes=n, steps=steps, launches=launches,
        ms_per_step=1e3 * out["wall_time"] / steps,
        newton_mean=out["newton_iters_total"] / steps,
        cg_mean=out["cg_iters_total"] / steps,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log("  main path: " + json.dumps(res))
    for k, ref in (("newton_mean", DENSE_NEWTON_MEAN),
                   ("cg_mean", DENSE_CG_MEAN)):
        if abs(res[k] - ref) > 0.05 * ref:
            raise RuntimeError(f"{k} {res[k]} is not within 5 % of the dense "
                               f"kernel's {ref}")
    return res, md, st, rdir


def profile_steps(dev, step, state, forcing, kernel):
    """Where a steady step's time goes: the window ``forcing`` from
    ``state`` once unprofiled (timed), then again under torch.profiler:
    device busy share, launches and host syncs per step, ``kernel``'s
    launches and mean device time, device time by op.  Measurement only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shakti_tpu_torch.solve.timestep import run_window
    steps = int(forcing["dt"].shape[0])
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, d = run_window(step, state, forcing)
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0) / steps
    log(f"  {steps} steady steps: {ms:.3f} ms/step, newton_mean "
        f"{d['newton_iters'].mean():.4f}, cg_mean {d['cg_iters'].mean():.4f}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_window(step, state, forcing)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_ops = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in dev_ops) / 1e6
    count = {e.key: e.count for e in ka}
    log(f"  profiled: {1e3 * wall / steps:.3f} ms/step, device busy "
        f"{100 * dev_s / wall:.1f} % ({1e3 * dev_s / steps:.3f} ms/step), "
        f"{count.get('cudaLaunchKernel', 0) / steps:.1f} launches/step, "
        f"{count.get('aten::_local_scalar_dense', 0) / steps:.1f} syncs/step")
    share = {e.key.removeprefix("aten::"): e.self_device_time_total
             for e in ka if e.device_type == DeviceType.CPU
             and e.key.startswith("aten::") and e.self_device_time_total}
    spmv = [e for e in dev_ops if kernel in e.key]
    share[kernel] = sum(e.self_device_time_total for e in spmv)
    n_spmv = sum(e.count for e in spmv)
    log(f"  {kernel} on the path: {n_spmv / steps:.2f} launches/step, "
        f"{share[kernel] / 1e3 / max(n_spmv, 1):.5f} ms/launch (mean)")
    log("  kernels per step by name: " + "; ".join(
        f"{e.key[:48]} {e.count / steps:.2f}"
        for e in sorted(dev_ops, key=lambda e: -e.count)[:12]))
    top = sorted(share.items(), key=lambda kv: -kv[1])[:12]
    log("  device time by op: " + ", ".join(
        f"{k} {100 * v / 1e6 / max(dev_s, 1e-12):.1f} %" for k, v in top))


def phase_profile(dev, md, state):
    """Phase 6: one more simulated day from the main path's final state."""
    from shakti_tpu_torch.solve.timestep import make_forcing, make_step_fn
    mesh, static, _, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    day = {k: v[24:48] for k, v in make_forcing(
        md.timesteps, dtype=md.dtype, device=dev).items()}
    profile_steps(dev, step, state, day, "bell_spmv")


def element_plan(mesh, dev):
    """The dense fold's plan from the mesh's element -> position maps alone
    (fem/ops.gather_plan over the JAX-layout fields, not the renumbered
    plan fold_structural and to_dense share): (slots, idx, size) for
    fem/ops.plan_sum."""
    from shakti_tpu_torch.fem.bcsr import fold_keys
    from shakti_tpu_torch.fem.ell import dense_shape
    from shakti_tpu_torch.fem.ops import gather_plan
    if mesh.bcsr_brow is not None:
        keys = fold_keys(mesh.bcsr_blk.cpu().numpy(),
                         mesh.bcsr_off.cpu().numpy(), mesh.bcsr_B)
    else:
        keys = mesh.ell_map.cpu().numpy()
    slots, idx = gather_plan(keys)
    return (torch.as_tensor(slots, device=dev), torch.as_tensor(idx, device=dev),
            int(np.prod(dense_shape(mesh))))


def phase_ell_kernel(dev, cases):
    """ell_spmv against its plain version (bitwise) and the dense plain
    product on each (tag, mesh, dirichlet) of ``cases``, f32 and f64, with
    and without the epilogue; timed at each case whose tag does not start
    with 'ragged'.  Returns {tag: {dtype: numbers}}."""
    from shakti_tpu_torch.fem.ell import dense_shape, to_dense
    from shakti_tpu_torch.fem.ops import plan_sum
    from shakti_tpu_torch.ops.spmv_cuda import (ell_operator_fn,
                                                ell_operator_plain)
    from shakti_tpu_torch.physics.residual import fold_operator_values
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)  # > L2
    out = {}
    for i, (tag, mesh, dirichlet) in enumerate(cases):
        W, n = mesh.nz_col.shape
        valid = mesh.nz_pos >= 0
        nnz = int(valid.sum())
        log(f"  {tag}: n={n} W={W} nonzeros={nnz} slots={W * n}")
        # each structural entry's flat slot in svals (-1 on padding): the
        # positions csr_of reads the library's values from
        slot = torch.where(valid, torch.arange(
            W * n, device=dev).reshape(W, n), -1)
        inp = operator_inputs(mesh, dirichlet, np.random.default_rng(10 + i))
        plan = element_plan(mesh, dev)
        out[tag] = {}
        for dtype, rtol, atol_rel in TOLS:
            dt = str(dtype).removeprefix("torch.")
            vals = fold_operator_values(inp["J"].to(dtype), mesh)
            if tuple(vals.shape) != (W, n) or int(torch.count_nonzero(
                    vals[~valid])):
                raise RuntimeError(f"{tag} {dt}: the fold is not the "
                                   f"structural (W, n): {tuple(vals.shape)}")
            dense_fold = plan_sum(-inp["J"].to(dtype), *plan).reshape(
                dense_shape(mesh))
            if not bitwise_equal(to_dense(vals, mesh), dense_fold):
                raise RuntimeError(f"{tag} {dt}: to_dense(structural fold) "
                                   "differs from the dense fold")
            del dense_fold
            x, extra = inp["x"].to(dtype), inp["extra"].to(dtype)
            err = {epi: check_operator(f"{tag} {dt} {epi}", vals, mesh, x, d, e,
                                       rtol, atol_rel, kernel="ell_spmv")
                   for epi, (d, e) in (("product", (None, None)),
                                       ("epilogue", (dirichlet, extra)))}
            r = dict(max_abs_err=err["epilogue"],
                     max_abs_err_product=err["product"], W=W, nnz=nnz,
                     n=mesh.n_nodes)
            if not tag.startswith("ragged"):
                op = ell_operator_fn(vals, mesh, dirichlet, extra)
                prod = ell_operator_fn(vals, mesh)
                r["device_ms"] = device_ms(lambda: op(x), "ell_spmv")
                r["device_ms_product"] = device_ms(lambda: prod(x), "ell_spmv")
                # a cold L2, as on the path (other kernels run between two
                # matvecs): the product alone, as the library call computes
                r["device_ms_cold_l2"] = device_ms(lambda: op(x), "ell_spmv",
                                                   between=flush.zero_)
                r["queued_ms_product_cold_l2"] = queued_ms(
                    lambda: prod(x), between=flush.zero_)
                r["ms"] = median_ms(lambda: op(x))
                r["plain_device_ms"] = device_ms(
                    lambda: ell_operator_plain(vals, mesh, x, dirichlet, extra))
                r["plain_ms"] = median_ms(
                    lambda: ell_operator_plain(vals, mesh, x, dirichlet, extra))
                r["host_us"] = host_us(lambda: op(x))
                r["bound_ms"], r["bound_by"] = ell_bound(mesh, dtype, True)
                r["bound_ms_two_indices"], _ = ell_bound(mesh, dtype, True, 8, 0)
                library_times(r, f"{tag} {dt}", vals, slot, mesh.nz_col,
                              mesh.n_nodes, x, prod(x), dtype, atol_rel,
                              flush=flush.zero_)
                log(f"  {tag} {dt}: L2 flushed before each call: kernel device "
                    f"{r['device_ms_cold_l2']:.5f} ms/launch (profiler); between"
                    f" events less the flush, product "
                    f"{r['queued_ms_product_cold_l2']:.5f} ms against library "
                    f"CSR mv {r['library_queued_ms_cold_l2']} ms")
                log(f"  {tag} {dt}: kernel device {r['device_ms']:.5f} ms/launch"
                    f" (product {r['device_ms_product']:.5f}), {r['ms']:.5f} "
                    f"ms/call events; plain version {r['plain_device_ms']:.5f} "
                    f"ms device ({r['plain_ms']:.5f} events); library CSR mv "
                    f"{r['library_device_ms']} ms device ({r['library_ms']} "
                    f"events); bound {r['bound_ms']:.5f} ms by {r['bound_by']}"
                    f" (counted with two indices per nonzero, as for the "
                    f"earlier kernel: {r['bound_ms_two_indices']:.5f})")
                del op, prod
            out[tag][dt] = r
            del vals
        del plan
    return out


def scale_model(nx=1000):
    """scripts/scale_bench.py's configuration on the port's ModelSetup:
    1,002,001 nodes and 2M triangles at 2 km (nx = 1000); f32, two-level,
    no lag carry, 48 hourly times of which phase 8 runs the first 24, saves
    every 12."""
    from shakti_tpu_torch.api.model import ModelSetup
    from shakti_tpu_torch.mesh.generate import rectangle_mesh
    from shakti_tpu_torch.solve.newton import NewtonConfig
    h = 2000.0
    nodes, cells = rectangle_mesh(nx, nx, nx * h, nx * h, jitter=0.25, seed=0)
    md = ModelSetup(nodes, cells)
    md.solver = NewtonConfig(lag_operator=False, precond="two_level")
    md.z_b = 0.002 * md.x - 100.0
    md.z_s = md.z_b + 1200.0 + 0.001 * (md.x - nx * h / 2)
    md.G = np.full(md.x.size, 0.06)
    md.N_bdry = 3.7e5
    md.OutflowBoundary = lambda p: p[:, 0] < 1e-6
    rng = np.random.default_rng(0)
    md.b_init = np.maximum(0.001 + rng.normal(scale=5e-4, size=md.x.size), 1e-5)
    md.N_init = np.full(md.x.size, md.N_bdry)
    md.storage_on = False
    md.timesteps = np.linspace(0, 48 * 3600.0, 48)[:24]
    md.nt_save = 12
    return md


def phase_scale(dev, md, frozen):
    """Phase 8: the 1M-node model through api/run.solve (its freeze is
    ``frozen``, made once for phases 7 and 8).  Times each window between
    synchronizations; returns the numbers and the ell_spmv launches."""
    from shakti_tpu_torch.api import run as trun
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.physics import residual
    mesh, _, _, cfg = frozen
    if (mesh.n_nodes, mesh.bcsr_B, cfg.coarse_block, cfg.lag_operator) != (
            1_002_001, 32, 1024, False):
        raise RuntimeError(f"auto at 1M nodes: B {mesh.bcsr_B}, coarse "
                           f"{cfg.coarse_block}, lag {cfg.lag_operator}")
    windows, plain_calls = [], {"ell": 0, "bell": 0}
    fold_shapes = set()
    real_window = trun.run_window
    real_plain = spmv_cuda.ell_operator_plain, spmv_cuda.bell_operator_plain
    real_fold = residual.fold_operator_values

    def spied_fold(J_c, m):
        vals = real_fold(J_c, m)
        fold_shapes.add(tuple(vals.shape))
        return vals

    def timed_window(step_fn, state, forcing):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, d = real_window(step_fn, state, forcing)
        torch.cuda.synchronize(dev)
        windows.append((time.perf_counter() - t0, d))
        return state, d

    def counted(name, fn):
        def wrapped(*a, **k):
            plain_calls[name] += 1
            return fn(*a, **k)
        return wrapped

    trun.run_window = timed_window
    spmv_cuda.ell_operator_plain = counted("ell", real_plain[0])
    spmv_cuda.bell_operator_plain = counted("bell", real_plain[1])
    residual.fold_operator_values = spied_fold
    md.device = dev
    md.freeze = lambda device=None: frozen
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        spmv_cuda.reset_launches()
        out = md.solve(progress=False)
        launches = dict(spmv_cuda.launches)
    finally:
        trun.run_window = real_window
        spmv_cuda.ell_operator_plain, spmv_cuda.bell_operator_plain = real_plain
        residual.fold_operator_values = real_fold
        del md.freeze
    st = out["state"]
    for k in ("N", "b", "q", "melt"):
        if not torch.isfinite(getattr(st, k)).all():
            raise RuntimeError(f"non-finite {k} after the 1M-node run")
    if out["steps"] != 24 or launches["ell_spmv"] <= 0 or any(plain_calls.values()):
        raise RuntimeError(f"1M-node run: {out['steps']} steps, launches "
                           f"{launches}, plain version calls {plain_calls}")
    # the operator is never the nnzb * B * B blocks: every fold of the run
    # gave the structural (W, n)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if fold_shapes != {tuple(mesh.nz_col.shape)}:
        raise RuntimeError(f"1M-node run: folds of shapes {fold_shapes}; the "
                           f"structural one is {tuple(mesh.nz_col.shape)}")
    wall, d = windows[1]
    res = dict(nodes=mesh.n_nodes, steps=out["steps"], launches=launches["ell_spmv"],
               ms_per_step_window2=1e3 * wall / d["newton_iters"].size,
               window2_steps=int(d["newton_iters"].size),
               newton_mean=out["newton_iters_total"] / out["steps"],
               cg_mean=out["cg_iters_total"] / out["steps"],
               newton_window2=d["newton_iters"].tolist(),
               cg_window2=d["cg_iters"].tolist(),
               ms_per_step_all=1e3 * out["wall_time"] / out["steps"],
               peak_mem_gb=peak_gb)
    log("  1M-node run: " + json.dumps(res))
    # where a steady step goes at this size: the run's last three steps
    # again, from its final state
    from shakti_tpu_torch.solve.timestep import make_forcing, make_step_fn
    step = make_step_fn(mesh, frozen[1], md.params, cfg)
    last = {k: v[-3:] for k, v in make_forcing(
        md.timesteps, dtype=md.dtype, device=dev).items()}
    profile_steps(dev, step, st, last, "ell_spmv")
    return res


def bench_f64(dev, op="auto", **solver):
    """The bench model in float64 for its first 4 hourly steps."""
    import dataclasses
    from shakti_tpu_torch.setups import setup_bench
    md = setup_bench.initialize(days=2)
    md.device, md.dtype, md.operator = dev, torch.float64, op
    md.timesteps = md.timesteps[:4]
    if op == "bcsr":
        md.operator_block = 32
    if solver:
        md.solver = dataclasses.replace(md.solver, **solver)
    return md


def run_counted(md, **kw):
    """md.solve with every launch count set to 0 just before and read just
    after."""
    from shakti_tpu_torch.ops import spmv_cuda
    spmv_cuda.reset_launches()
    out = md.solve(progress=False, **kw)
    return out, dict(spmv_cuda.launches)


def phase_formats(dev):
    """Phase 9: the four formats agree on the bench model in float64."""
    ref, res = None, {}
    for op, kernel in (("bell", "bell_spmv"), ("ell", "ell_spmv"),
                       ("bcsr", "ell_spmv"), ("cells", None)):
        md = bench_f64(dev, op, lag_operator=None)
        out, launches = run_counted(md)
        if kernel is not None and launches[kernel] <= 0:
            raise RuntimeError(f"{op}: {kernel} never launched ({launches})")
        N = md.to_user_order(out["state"].N)
        b = md.to_user_order(out["state"].b)
        r = dict(newton=out["newton_iters_total"], cg=out["cg_iters_total"],
                 launches=launches)
        if ref is None:
            ref = (N, b)
        else:
            r["err_N"] = float(np.abs(N - ref[0]).max() / np.abs(ref[0]).max())
            r["err_b"] = float(np.abs(b - ref[1]).max() / np.abs(ref[1]).max())
            if max(r["err_N"], r["err_b"]) > 1e-7:
                raise RuntimeError(f"{op} differs from bell: {r}")
        res[op] = r
        log(f"  {op}: " + json.dumps(r))
    return res, ref[0]


WRAPPER = """import numpy as np

from shakti_tpu_torch.setups import setup_bench


def initialize():
    md = setup_bench.initialize(days=2, results_name={rdir!r})
    md.timesteps = md.timesteps[:{steps}]
    return md
"""


def phase_resume(dev, tmp, full_dir):
    """Phase 10: 25 steps, then --resume through cli.main to step 48; every
    output equal to phase 5's uninterrupted run."""
    from shakti_tpu_torch.cli import main as cli_main
    from shakti_tpu_torch.ops import spmv_cuda
    rdir = os.path.join(tmp, "resumed")
    launches = {}
    for steps, extra in ((25, []), (48, ["--resume"])):
        path = os.path.join(tmp, f"wrap_{steps}.py")
        with open(path, "w") as f:
            f.write(WRAPPER.format(rdir=rdir, steps=steps))
        spmv_cuda.reset_launches()
        if cli_main([path, "--device", str(dev), "--quiet", *extra]) != 0:
            raise RuntimeError(f"cli.main {extra} failed")
        launches[steps] = spmv_cuda.launches["bell_spmv"]
    a = np.load(os.path.join(full_dir, "checkpoint.npz"))
    b = np.load(os.path.join(rdir, "checkpoint.npz"))
    same = {k: bool(np.array_equal(a[k], b[k])) for k in ("N", "b", "q", "melt")}
    for k in ("N", "b", "qx", "qy"):
        same[f"{k}.npy"] = bool(np.array_equal(
            np.load(os.path.join(full_dir, f"{k}.npy")),
            np.load(os.path.join(rdir, f"{k}.npy"))))
    meta = json.load(open(os.path.join(rdir, "run_meta.json")))
    log(f"  resume: equal {same}, resumed_from {meta['resumed_from']}, "
        f"bell_spmv launches {launches}")
    if not all(same.values()) or meta["resumed_from"] != 25 or min(
            launches.values()) <= 0:
        raise RuntimeError("resume is not bit-exact")
    return dict(equal=same, launches=launches)


def phase_bootstrap(dev, tmp):
    """Phase 11: setup_cooke2's reference cold start, 24 float64 bootstrap
    steps on the card then float32, 3 days."""
    from shakti_tpu_torch.api import run as trun
    from shakti_tpu_torch.setups import setup_cooke2
    env = {"SHAKTI_MESH_DIR": os.path.join(HERE, "assets", "cooke2_synth"),
           "SHAKTI_REFERENCE_BINIT": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        md = setup_cooke2.initialize(days=3, results_name=os.path.join(tmp, "ck2"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    md.device = dev
    boot = {}
    real = trun._bootstrap_f64

    def spy(*a):
        state, wins, end = real(*a)
        boot.update(state=state, wins=wins, end=end)
        return state, wins, end

    trun._bootstrap_f64 = spy
    try:
        t0 = time.perf_counter()
        out, launches = run_counted(md)
        wall = time.perf_counter() - t0
    finally:
        trun._bootstrap_f64 = real
    s64 = boot["state"]
    for k in ("N", "b", "q", "melt", "N_prev"):
        t = getattr(s64, k)
        if t.dtype != torch.float64 or t.device.type != "cuda":
            raise RuntimeError(f"bootstrap {k}: {t.dtype} on {t.device}")
    if out["state"].N.dtype != torch.float32:
        raise RuntimeError("the run after the bootstrap is not float32")
    dg = np.concatenate([w[3] for w in boot["wins"]], axis=1)
    steps = boot["end"] + out["steps"]
    res = dict(steps=steps, boot_steps=boot["end"],
               boot_newton=int(dg[1].sum()), boot_cg=int(dg[2].sum()),
               f32_newton=out["newton_iters_total"] - int(dg[1].sum()),
               f32_cg=out["cg_iters_total"] - int(dg[2].sum()),
               wall_s=wall, launches=launches,
               b_negative_share=float((md.b_init < 0).mean()))
    log("  bootstrap: " + json.dumps(res))
    if steps != 72 or launches["bell_spmv"] <= 0:
        raise RuntimeError(f"bootstrap run: {res}")
    return res


def phase_bicgstab(dev, N_cg):
    """Phase 12: BiCGStab on the bench model in float64, against phase 9's
    cg run."""
    md = bench_f64(dev, krylov="bicgstab", lag_operator=None)
    out, launches = run_counted(md)
    N = md.to_user_order(out["state"].N)
    err = float(np.abs(N - N_cg).max() / np.abs(N_cg).max())
    res = dict(newton=out["newton_iters_total"], krylov=out["cg_iters_total"],
               err_N=err, launches=launches)
    log("  bicgstab: " + json.dumps(res))
    if err > 1e-7 or launches["bell_spmv"] <= 0:
        raise RuntimeError(f"bicgstab: {res}")
    return res


# the kernels line: "ms", "plain_ms" and "library_ms" are times per call
# between CUDA events (host work included), as "ms" has been since the first
# kernel; the *_device_ms are torch.profiler's device times
LINE_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "plain_device_ms",
             "library_ms", "library_device_ms", "bound_ms", "host_us",
             "host_us_composed")
ELL_LINE_KEYS = tuple(k for k in LINE_KEYS if k != "host_us_composed")


PHASES = ("kernel", "goldens", "main", "ell", "scale", "formats", "resume",
          "bootstrap", "bicgstab")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (resume needs main, bicgstab needs formats, scale "
                    "needs ell); the result lines need all of them")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        raise SystemExit(f"unknown phases {set(phases) - set(PHASES)}")
    t_start = time.perf_counter()
    # ---- 1. the card ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs an NVIDIA GPU")
    from shakti_tpu_torch.utils.backend import resolve_device
    dev = resolve_device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} visible)")
    log(f"nvidia-smi: {smi}")

    # ---- 2. build: one nvcc per source, started together ----
    from shakti_tpu_torch.ops import spmv_cuda
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(spmv_cuda.KERNELS)) as ex:
        infos = dict(zip(spmv_cuda.KERNELS,
                         ex.map(spmv_cuda.build, spmv_cuda.KERNELS)))
    log(f"[build] {time.perf_counter() - t0:.2f} s for {len(infos)} kernels")
    for name, info in infos.items():
        log(f"  {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(f"    {line.strip()}")

    def stamp(name):
        log(f"[{name}] (t = {time.perf_counter() - t_start:.1f} s)")

    kres = mres = sres = eres = None
    # ---- 3. bell_spmv vs plain at the bench shapes ----
    from shakti_tpu_torch.setups import setup_bench
    if "kernel" in phases:
        stamp("kernel")
        md = setup_bench.initialize(days=2)
        mesh, static = md.freeze(dev)[:2]
        NB, KB = mesh.bell_nbr.shape
        W = mesh.bell_nz_pos.shape[0]
        log(f"  bench operator: n={mesh.n_nodes} NB={NB} KB={KB} "
            f"B={mesh.bell_B}; structural view W={W}, "
            f"{int((mesh.bell_nz_pos >= 0).sum())} nonzeros")
        if (NB, KB, mesh.bell_B, mesh.n_nodes, W) != (96, 11, 128, 12270, 10):
            raise RuntimeError("bench operator shape changed")
        kres = phase_kernel(dev, mesh, static.dirichlet)
        kres["W"] = W
        del mesh, static, md

    # ---- 4. goldens on the card ----
    if "goldens" in phases:
        stamp("goldens: float64 on the card")
        phase_goldens(dev)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 5, 6. main path at full size, then its profile ----
        if "main" in phases:
            stamp("main: bench model, 2 days of hourly steps, float32")
            torch.cuda.reset_peak_memory_stats(dev)
            mres, md, state, main_dir = phase_main(dev, tmp)
            stamp("profile: one more steady day of the main path")
            phase_profile(dev, md, state)
            del md, state

        # ---- 7. ell_spmv vs plain; 8. the 1M-node mesh ----
        if "ell" in phases:
            stamp("ell: ell_spmv at the bench (ELL, BCSR 32), large and "
                  "ragged shapes")
            cases = []
            for op in ("ell", "bcsr"):
                md = setup_bench.initialize(days=2)
                md.operator, md.operator_block = op, 32
                mesh, static = md.freeze(dev)[:2]
                cases.append((f"bench {op}", mesh, static.dirichlet))
            from shakti_tpu_torch.setups import setup_slab
            for op in ("ell", "bcsr"):
                md = setup_slab.initialize(nx=12, ny=12)
                md.operator, md.operator_block = op, 32
                mesh, static = md.freeze(dev)[:2]
                cases.append((f"ragged n={mesh.n_nodes} {op}", mesh,
                              static.dirichlet))
            smd = scale_model()
            t0 = time.perf_counter()
            frozen = smd.freeze(dev)
            torch.cuda.synchronize(dev)
            freeze_s = time.perf_counter() - t0
            log(f"  large mesh: freeze {freeze_s:.2f} s host time, "
                f"{frozen[0].n_nodes} nodes, {frozen[0].n_cells} cells, BCSR "
                f"B {frozen[0].bcsr_B} nnzb {frozen[0].bcsr_brow.shape[0]}, "
                f"coarse block {frozen[3].coarse_block}")
            cases.append((f"large bcsr n={frozen[0].n_nodes}", frozen[0],
                          frozen[1].dirichlet))
            eres = phase_ell_kernel(dev, cases)
            del cases, mesh, static
            if "scale" in phases:
                stamp("scale: 24 steps on the large mesh through api/run.solve")
                sres = phase_scale(dev, smd, frozen)
                sres["freeze_s"] = freeze_s
            del smd, frozen
            torch.cuda.empty_cache()

        # ---- 9. formats agree; 12. BiCGStab ----
        if "formats" in phases:
            stamp("formats: bench model, float64, 4 steps, four operators")
            fres, N_cg = phase_formats(dev)
            if "bicgstab" in phases:
                stamp("bicgstab: bench model, float64, 4 steps")
                phase_bicgstab(dev, N_cg)

        # ---- 10. resume through the CLI ----
        if "resume" in phases and "main" in phases:
            stamp("resume: 25 steps, then --resume to 48")
            phase_resume(dev, tmp, main_dir)

        # ---- 11. the float64 bootstrap on the card ----
        if "bootstrap" in phases:
            stamp("bootstrap: setup_cooke2, reference cold start, 3 days")
            phase_bootstrap(dev, tmp)
    stamp("done")

    if phases != list(PHASES):
        log("partial run: no result lines")
        return 0
    f32 = kres["float32"]
    large = next(v for k, v in eres.items() if k.startswith("large"))
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "bell_spmv", "route": "cuda",
        "source": "shakti_tpu_torch/csrc/bell_spmv.cu",
        "replaces": "shakti_tpu/ops/spmv_pallas.py:46",
        "launches": mres["launches"], "W": kres["W"],
        **{k: f32[k] for k in LINE_KEYS}, "bound_by": f32["bound_by"],
        "float64": {k: kres["float64"][k] for k in LINE_KEYS}}, {
        "name": "ell_spmv", "route": "cuda",
        "source": "shakti_tpu_torch/csrc/ell_spmv.cu",
        "replaces": "none (not a TPU kernel): shakti_tpu/fem/bcsr.py:84 "
                    "bcsr_matvec and shakti_tpu/fem/ell.py:91 ell_matvec "
                    "run in XLA",
        "launches": sres["launches"], "W": large["float32"]["W"],
        "n": large["float32"]["n"], "nnz": large["float32"]["nnz"],
        **{k: large["float32"][k] for k in ELL_LINE_KEYS},
        "bound_by": large["float32"]["bound_by"],
        "float64": {k: large["float64"][k] for k in ELL_LINE_KEYS},
        "bench": {tag: {dt: {k: r[k] for k in ELL_LINE_KEYS}
                        for dt, r in v.items()}
                  for tag, v in eres.items() if tag.startswith("bench")}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
