"""Smoke test of the PyTorch/CUDA port (shakti_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases (any failure raises: exit code != 0 and no result line):
  1. the card: torch.cuda must be available; prints its name and
     nvidia-smi's name/power limit;
  2. build: compiles csrc/bell_spmv.cu with nvcc for sm_90a;
  3. kernel vs plain: the block-ELL operator kernel (the structural
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
     a steady step's time goes.
The line before the last is a JSON object with the kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""

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


def device_ms(fn, match=None, reps=50, warmup=5, between=None) -> float:
    """Device time from torch.profiler (CUPTI).  With ``match``: the median
    over ``reps`` calls of the one kernel per call whose name contains it
    (``between`` runs untimed before each call).  Without: all device time
    of ``reps`` calls over ``reps`` (a call may launch several kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if between is not None and match is None:
        raise ValueError("device_ms: `between` needs `match`")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        raise RuntimeError("torch.profiler recorded no device activity")
    if match is None:
        return sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3
    us = [e.time_range.elapsed_us() for e in evs if match in e.name]
    if len(us) != reps:
        raise RuntimeError(f"profiler: {len(us)} {match!r} kernels for {reps}"
                           f" calls (kernels: {sorted({e.name for e in evs})})")
    return float(np.median(us)) / 1e3


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


def check_operator(tag, vals, mesh, x, dirichlet, extra, rtol, atol_rel):
    """The kernel against its mirror twin (bitwise), the dense plain twin
    (tolerance) and itself (bitwise); returns the error against the dense
    twin."""
    from shakti_tpu_torch.ops.spmv_cuda import (bell_operator_fn,
                                                bell_operator_plain,
                                                bell_operator_structural)
    op = bell_operator_fn(vals, mesh, dirichlet, extra)
    y = op(x)
    mirror = bell_operator_structural(vals, mesh, x, dirichlet, extra)
    dense = bell_operator_plain(vals, mesh, x, dirichlet, extra)
    torch.cuda.synchronize()
    if not bitwise_equal(y, mirror):
        bad = int((y != mirror).sum())
        raise RuntimeError(f"bell_spmv {tag}: differs from its mirror twin in "
                           f"{bad} rows (max {float((y - mirror).abs().max())})")
    err = check_close(tag, y, dense, rtol, atol_rel)
    if not bitwise_equal(op(x), y):
        raise RuntimeError(f"bell_spmv {tag}: two launches differ")
    return err


def bound(mesh, dtype, epilogue: bool):
    """(ms, 'bytes' or 'operations'): the least time of one operator matvec
    on this card's published peaks, from what this run's operator needs:
    each structural nonzero's value and one int32 index, one int32 length
    per row, x and y once, plus the mask and extra with the epilogue; 2
    flops a nonzero (3 per row more with the epilogue)."""
    es = torch.tensor([], dtype=dtype).element_size()
    n = mesh.n_nodes
    nnz = int((mesh.bell_nz_pos >= 0).sum())
    nbytes = nnz * (es + 4) + 4 * n + 2 * n * es
    if epilogue:
        nbytes += n + n * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (2 * nnz + (3 * n if epilogue else 0)) / FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def csr_of(vals, mesh):
    """The same structural entries of the same vals as a torch sparse CSR
    matrix (int32 indices, columns ascending in each row): the library
    yardstick, never used by the port."""
    from shakti_tpu_torch.ops.spmv_cuda import view_columns
    n = mesh.n_nodes
    pos = mesh.bell_nz_pos.long()
    col = view_columns(pos, mesh.bell_nbr, mesh.bell_B)
    valid = pos >= 0
    rows = torch.arange(n, device=pos.device).expand_as(pos)[valid]
    cols, p = col[valid], pos[valid]
    order = torch.argsort(rows * n + cols)
    rows, cols, p = rows[order], cols[order], p[order]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=pos.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow.int(), cols.int(), vals.reshape(-1)[p],
                                   (n, n), check_invariants=True)


def phase_kernel(dev, mesh, dirichlet):
    from shakti_tpu_torch.fem.bell import bell_from_elements
    from shakti_tpu_torch.ops.spmv_cuda import (bell_operator_fn,
                                                bell_operator_plain)
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
        r["bound_ms"], r["bound_by"] = bound(mesh, dtype, True)
        r["bound_ms_product"], _ = bound(mesh, dtype, False)
        try:
            A = csr_of(vals, mesh)
            y_lib = torch.mv(A, x)
            check_close(f"bench shape {tag} library CSR vs kernel", y_lib,
                        prod(x), 1e-5 if dtype == torch.float32 else 1e-12,
                        atol_rel)
            r["library_device_ms"] = device_ms(lambda: torch.mv(A, x))
            r["library_ms"] = median_ms(lambda: torch.mv(A, x))
            del A
        except RuntimeError as e:
            log(f"  library sparse CSR mv refused in {tag}: {e}")
            r["library_device_ms"] = r["library_ms"] = None
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
    spmv_cuda.launches = 0
    out = md.solve(progress=False)
    launches = spmv_cuda.launches
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
    return res, md, st


def phase_profile(dev, md, state):
    """Where a steady step's time goes: one more simulated day from the
    main path's final state, timed, then again under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shakti_tpu_torch.solve.timestep import (make_forcing, make_step_fn,
                                                 run_window)
    mesh, static, _, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    day = {k: v[24:48] for k, v in make_forcing(
        md.timesteps, dtype=md.dtype, device=dev).items()}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, d = run_window(step, state, day)
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0) / 24
    log(f"  steady day: {ms:.3f} ms/step, newton_mean "
        f"{d['newton_iters'].mean():.4f}, cg_mean {d['cg_iters'].mean():.4f}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, d = run_window(step, state, day)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_ops = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in dev_ops) / 1e6
    count = {e.key: e.count for e in ka}
    log(f"  profiled day: {1e3 * wall / 24:.3f} ms/step, device busy "
        f"{100 * dev_s / wall:.1f} % ({1e3 * dev_s / 24:.3f} ms/step), "
        f"{count.get('cudaLaunchKernel', 0) / 24:.1f} launches/step, "
        f"{count.get('aten::_local_scalar_dense', 0) / 24:.1f} syncs/step")
    share = {e.key.removeprefix("aten::"): e.self_device_time_total
             for e in ka if e.device_type == DeviceType.CPU
             and e.key.startswith("aten::") and e.self_device_time_total}
    spmv = [e for e in dev_ops if "bell_spmv" in e.key]
    share["bell_spmv"] = sum(e.self_device_time_total for e in spmv)
    n_spmv = sum(e.count for e in spmv)
    log(f"  bell_spmv on the main path: {n_spmv / 24:.2f} launches/step, "
        f"{share['bell_spmv'] / 1e3 / max(n_spmv, 1):.5f} ms/launch (mean)")
    log("  kernels per step by name: " + "; ".join(
        f"{e.key[:48]} {e.count / 24:.2f}"
        for e in sorted(dev_ops, key=lambda e: -e.count)[:12]))
    top = sorted(share.items(), key=lambda kv: -kv[1])[:10]
    log("  device time by op: " + ", ".join(
        f"{k} {100 * v / 1e6 / max(dev_s, 1e-12):.1f} %" for k, v in top))


# the kernels line: "ms", "plain_ms" and "library_ms" are times per call
# between CUDA events (host work included), as "ms" has been since the first
# kernel; the *_device_ms are torch.profiler's device times
LINE_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "plain_device_ms",
             "library_ms", "library_device_ms", "bound_ms", "host_us",
             "host_us_composed")


def main():
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

    # ---- 2. build ----
    from shakti_tpu_torch.ops import spmv_cuda
    t0 = time.perf_counter()
    info = spmv_cuda.build()
    log(f"[build] bell_spmv: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s) -> {info['path']}")
    for line in info["log"].splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log(f"  {line.strip()}")

    # ---- 3. kernel vs plain at the bench shapes ----
    from shakti_tpu_torch.setups import setup_bench
    md = setup_bench.initialize(days=2)
    mesh, static = md.freeze(dev)[:2]
    NB, KB = mesh.bell_nbr.shape
    W = mesh.bell_nz_pos.shape[0]
    log(f"[kernel] bench operator: n={mesh.n_nodes} NB={NB} KB={KB} "
        f"B={mesh.bell_B}; structural view W={W}, "
        f"{int((mesh.bell_nz_pos >= 0).sum())} nonzeros")
    if (NB, KB, mesh.bell_B, mesh.n_nodes, W) != (96, 11, 128, 12270, 10):
        raise RuntimeError("bench operator shape changed")
    kres = phase_kernel(dev, mesh, static.dirichlet)
    del mesh, static, md

    # ---- 4. goldens on the card ----
    log("[goldens] float64 on the card")
    phase_goldens(dev)

    # ---- 5. main path at full size ----
    log("[main] bench model, 2 days of hourly steps, float32")
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        mres, md, state = phase_main(dev, tmp)
    log("[profile] one more steady day of the main path")
    phase_profile(dev, md, state)

    f32 = kres["float32"]
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "bell_spmv", "route": "cuda",
        "source": "shakti_tpu_torch/csrc/bell_spmv.cu",
        "replaces": "shakti_tpu/ops/spmv_pallas.py:46",
        "launches": mres["launches"], "W": W,
        **{k: f32[k] for k in LINE_KEYS}, "bound_by": f32["bound_by"],
        "float64": {k: kres["float64"][k] for k in LINE_KEYS}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
