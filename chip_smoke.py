"""Smoke test of the PyTorch/CUDA port (shakti_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases (any failure raises: exit code != 0 and no result line):
  1. the card: torch.cuda must be available; prints its name and
     nvidia-smi's name/power limit;
  2. build: compiles csrc/bell_spmv.cu with nvcc for sm_90a;
  3. kernel vs plain: the block-ELL SpMV kernel against its plain PyTorch
     version on the same seeded inputs, at the Cook_E2 bench shapes
     (NB 96, KB 11, B 128, n 12,270) in float32 (rtol 2e-6, atol
     1e-6 max|y|) and float64 (1e-12), plus a small ragged case, and
     bitwise repeatability; median times of both over 50
     CUDA-event-timed calls;
  4. goldens on the card: the slab and lake golden cases in float64
     through the port, against tests/goldens/*.npz at
     tests/test_goldens.py's tolerance (1e-7 of scale), every step
     converged;
  5. main path at full size: the bench model (setups/setup_bench.py, a port
     of bench.py:build_bench_model) through api/run.solve for 2 simulated
     days (48 hourly steps, f32, lag on) into a temporary results dir; every
     step converged, all fields finite, history files present, and the
     kernel launched by that run;
  6. profile: one more simulated day, timed, then under torch.profiler
     (device busy share, launches and host syncs per step, device time by
     op), to show where a steady step's time goes.
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


def median_ms(fn, reps=50, warmup=5) -> float:
    """Median device time of fn() over ``reps`` calls (CUDA events)."""
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


def check_close(name, got, ref, rtol, atol_rel):
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    atol = atol_rel * np.abs(ref).max()
    err = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)
    log(f"  {name}: max|kernel - plain| = {err:.3e} (max|y| "
        f"{np.abs(ref).max():.3e}, rtol {rtol:g}, atol {atol:.3e})")
    return err


def phase_kernel(dev, nbr, n):
    from shakti_tpu_torch.ops.spmv_cuda import bell_matvec, bell_matvec_plain
    NB, KB = nbr.shape
    B = 128
    rng = np.random.default_rng(0)
    vals64 = rng.standard_normal((NB, KB, B, B))
    x64 = rng.standard_normal(n)
    out = {}
    for dtype, rtol, atol_rel in ((torch.float32, 2e-6, 1e-6),
                                  (torch.float64, 1e-12, 1e-12)):
        vals = torch.as_tensor(vals64, dtype=dtype, device=dev)
        x = torch.as_tensor(x64, dtype=dtype, device=dev)
        y = bell_matvec(vals, nbr, x, n)
        y_ref = bell_matvec_plain(vals, nbr, x, n)
        torch.cuda.synchronize()
        tag = str(dtype).removeprefix("torch.")
        err = check_close(f"bench shape {tag}", y, y_ref, rtol, atol_rel)
        # fixed summation order: a second launch is bitwise identical
        if not torch.equal(bell_matvec(vals, nbr, x, n), y):
            raise RuntimeError(f"bell_spmv {tag}: two launches differ")
        ms = median_ms(lambda: bell_matvec(vals, nbr, x, n))
        plain_ms = median_ms(lambda: bell_matvec_plain(vals, nbr, x, n))
        gbs = vals.numel() * vals.element_size() / (ms * 1e-3) / 1e9
        log(f"  bench shape {tag}: kernel {ms:.4f} ms ({gbs:.0f} GB/s of "
            f"vals), plain {plain_ms:.4f} ms (median of 50)")
        out[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del vals, x
    # a small ragged case: 169 nodes in two 128-blocks (12 x 12 slab mesh)
    from shakti_tpu_torch.fem.bell import bell_from_elements
    from shakti_tpu_torch.setups import setup_slab
    md = setup_slab.initialize(nx=12, ny=12)
    md.dtype = torch.float64
    m = md.freeze(dev)[0]
    J = torch.as_tensor(rng.standard_normal((m.n_cells, 3, 3)), device=dev)
    for dtype, rtol, atol_rel in ((torch.float32, 2e-6, 1e-6),
                                  (torch.float64, 1e-12, 1e-12)):
        vals = bell_from_elements(J, m).to(dtype)
        x = torch.as_tensor(rng.standard_normal(m.n_nodes), dtype=dtype,
                            device=dev)
        y = bell_matvec(vals, m.bell_nbr, x, m.n_nodes)
        torch.cuda.synchronize()
        check_close(f"ragged n={m.n_nodes} {str(dtype).removeprefix('torch.')}",
                    y, bell_matvec_plain(vals, m.bell_nbr, x, m.n_nodes),
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


def phase_main(dev, tmp):
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.setups import setup_bench
    rdir = os.path.join(tmp, "bench_run")
    md = setup_bench.initialize(days=2, results_name=rdir)
    md.device = dev
    spmv_cuda.bell_matvec.launches = 0
    out = md.solve(progress=False)
    launches = spmv_cuda.bell_matvec.launches
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
    res = dict(
        nodes=n, steps=steps, launches=launches,
        ms_per_step=1e3 * out["wall_time"] / steps,
        newton_mean=out["newton_iters_total"] / steps,
        cg_mean=out["cg_iters_total"] / steps,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log("  main path: " + json.dumps(res))
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
    share["bell_spmv"] = sum(e.self_device_time_total for e in dev_ops
                             if "bell_spmv" in e.key)
    top = sorted(share.items(), key=lambda kv: -kv[1])[:10]
    log("  device time by op: " + ", ".join(
        f"{k} {100 * v / 1e6 / max(dev_s, 1e-12):.1f} %" for k, v in top))


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
    mesh = md.freeze(dev)[0]
    NB, KB = mesh.bell_nbr.shape
    log(f"[kernel] bench operator: n={mesh.n_nodes} NB={NB} KB={KB} "
        f"B={mesh.bell_B}")
    if (NB, KB, mesh.bell_B, mesh.n_nodes) != (96, 11, 128, 12270):
        raise RuntimeError("bench operator shape changed")
    kres = phase_kernel(dev, mesh.bell_nbr, mesh.n_nodes)
    del mesh, md

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
        "launches": mres["launches"], "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
