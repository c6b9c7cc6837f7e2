"""A/B of two trees of the PyTorch port (shakti_tpu_torch) on one NVIDIA GPU:
what one operator matvec costs the host and the device, and the bench
model's steady day.

    python3 torch_ab.py --root DIR [--days 3] [--large] [--no-main]

imports shakti_tpu_torch from DIR (this checkout, or a ``git archive`` of
another commit of the port) and prints, as its last line, one JSON object:

  host_us_per_matvec     the matvec as solve/newton.py builds it (the
                         operator with its Dirichlet elimination plus the
                         diagonal floor ``extra * x``) at the bench shape in
                         float32: host time per call, 1000 calls back to back
                         (chip_smoke.host_us)
  host_us_per_operator   building that matvec from vals (once per Newton
                         iteration)
  ms_per_matvec          one call between CUDA events, median of 50
  device_ms_per_matvec   all device time of one call (torch.profiler)
  kernel_device_ms       the bell_spmv kernel alone (product, no epilogue):
                         device time per launch, median of 50 (the same
                         chip_smoke.device_ms helper for every tree)
  main_ms_per_step       the 48-step main path (api/run.solve, 2 days)
  steady                 the same steady day (the second day's forcing, from
                         the main path's end state) run --days times,
                         unprofiled, each with its newton_mean and cg_mean
  host_ops_per_step      one more such day under torch.profiler: the host
                         time of the ten costliest ops per step
  ell                    the scalar-ELL and block-CSR (B 32) operators at the
                         bench shape, and with --large the 1,002,001-node
                         block-CSR operator of chip_smoke's phase 8, in float32
                         and float64, through either tree's API
                         (fold_operator_values, operator_from_values):
                         ell_spmv's device time per launch with the epilogue
                         (median of 50), the host time per matvec, the host
                         time of one fold and the bytes of the folded values
  rebuild_memory         with --large: device memory of one operator rebuild
                         at 1,002,001 nodes in float32, stage by stage
                         (precompute, element Jacobian, fold, diagonal, coarse
                         inverse, one matvec, the 3-column residual): the
                         bytes each stage leaves allocated, its peak above
                         what was allocated before it, and its time

--no-main skips the bench main path and the steady days.

To compare two commits, run them alternately in one call on one card
(parent, change, change, parent, ...): host clocks drift between machines.
"""

import argparse
import importlib.util
import inspect
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def matvec_costs(cs, md, dev):
    """Host and device cost of one newton matvec on the seeded bench
    operator, with either tree's operator API."""
    from shakti_tpu_torch.fem import bell as bellm
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.physics import residual as res
    mesh, static = md.freeze(dev)[:2]
    d = static.dirichlet
    rng = np.random.default_rng(0)
    J = torch.as_tensor(rng.standard_normal((mesh.n_cells, 3, 3)),
                        dtype=torch.float32, device=dev)
    x = torch.as_tensor(rng.standard_normal(mesh.n_nodes), dtype=torch.float32,
                        device=dev)
    extra = torch.as_tensor(rng.random(mesh.n_nodes), dtype=torch.float32,
                            device=dev) * ~d
    vals = bellm.bell_from_elements(J, mesh)
    if "extra" in inspect.signature(res.operator_from_values).parameters:
        def build():
            return res.operator_from_values(vals, mesh, d, extra)

        kernel = spmv_cuda.bell_operator_fn(vals, mesh)
    else:  # the composition solve/newton.py made before the fusion
        def build():
            m0 = res.operator_from_values(vals, mesh, d)
            return lambda v: m0(v) + extra * v

        def kernel(v):
            return bellm.bell_matvec(vals, mesh.bell_nbr, v, mesh.n_nodes)
    mv = build()
    return dict(
        host_us_per_matvec=cs.host_us(lambda: mv(x)),
        host_us_per_operator=cs.host_us(build, reps=200),
        ms_per_matvec=cs.median_ms(lambda: mv(x)),
        device_ms_per_matvec=cs.device_ms(lambda: mv(x)),
        kernel_device_ms=cs.device_ms(lambda: kernel(x), "bell_spmv"))


def ell_costs(cs, dev, large):
    """ell_spmv on the bench mesh in ELL and BCSR (and the large BCSR mesh,
    ``large`` its freeze or None): {tag: {dtype: numbers}} through the API
    both trees share."""
    from shakti_tpu_torch.physics import residual as res
    from shakti_tpu_torch.setups import setup_bench
    cases = []
    for op in ("ell", "bcsr"):
        md = setup_bench.initialize(days=2)
        md.operator, md.operator_block = op, 32
        cases.append((f"bench {op}", md.freeze(dev)[:2]))
    if large is not None:
        cases.append(("large bcsr", large[:2]))
    out = {}
    for i, (tag, (mesh, static)) in enumerate(cases):
        d = static.dirichlet
        inp = cs.operator_inputs(mesh, d, np.random.default_rng(10 + i))
        out[tag] = {"n": mesh.n_nodes}
        for dtype in (torch.float32, torch.float64):
            J, x, extra = (inp[k].to(dtype) for k in ("J", "x", "extra"))
            vals = res.fold_operator_values(J, mesh)
            mv = res.operator_from_values(vals, mesh, d, extra)
            out[tag][str(dtype).removeprefix("torch.")] = dict(
                kernel_device_ms=cs.device_ms(lambda: mv(x), "ell_spmv"),
                host_us_per_matvec=cs.host_us(lambda: mv(x)),
                fold_ms=cs.median_ms(
                    lambda: res.fold_operator_values(J, mesh), reps=10),
                vals_bytes=vals.numel() * vals.element_size())
            del vals, mv
    return out


def rebuild_memory(md, frozen, dev):
    """Device memory and time of one operator rebuild on the large mesh
    (``md`` and its freeze), stage by stage, through the API both trees
    share."""
    from shakti_tpu_torch.physics import residual as res
    from shakti_tpu_torch.solve import precond as pc
    mesh, static, state, cfg = frozen
    sq = res.static_quad_fields(mesh, static, cfg.quad_degree,
                                mesh.nodes.dtype)
    dt = torch.tensor(3600.0, dtype=md.dtype, device=dev)
    d, N = static.dirichlet, state.N
    x = torch.ones_like(N)
    torch.cuda.synchronize(dev)
    out = {"allocated_after_freeze_mb": torch.cuda.memory_allocated(dev) / 1e6}
    keep = {}

    def stage(name, fn):
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        keep[name] = fn()
        torch.cuda.synchronize(dev)
        out[name] = dict(
            ms=1e3 * (time.perf_counter() - t0),
            kept_mb=(torch.cuda.memory_allocated(dev) - before) / 1e6,
            peak_above_mb=(torch.cuda.max_memory_allocated(dev) - before) / 1e6)

    for _ in range(2):          # the second pass is the one reported (warm)
        keep.clear()
        stage("precompute", lambda: res.precompute_step(
            mesh, N, state.b, state.q, state.melt, static, dt, md.params,
            cfg.quad_degree, sq=sq))
        stage("element_jacobian", lambda: res.element_jacobian(
            N, keep["precompute"], mesh, md.params))
        stage("fold", lambda: res.fold_operator_values(
            keep["element_jacobian"], mesh))
        stage("diag", lambda: res.operator_diag_from_values(keep["fold"], mesh))
        stage("coarse_inverse", lambda: pc.coarse_from_values(
            keep["fold"], mesh, d, cfg.coarse_block))
        stage("matvec", lambda: res.operator_from_values(
            keep["fold"], mesh, d, torch.zeros_like(N))(x))
        stage("residual_3_columns", lambda: res.assemble_residual_multi(
            torch.stack([N, N, N], dim=1), keep["precompute"], mesh,
            md.params))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="tree whose shakti_tpu_torch is measured")
    ap.add_argument("--days", type=int, default=3)
    ap.add_argument("--large", action="store_true",
                    help="also the 1,002,001-node block-CSR operator")
    ap.add_argument("--no-main", action="store_true",
                    help="skip the bench main path and the steady days")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: needs an NVIDIA GPU")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = load_chip_smoke()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import shakti_tpu_torch
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.setups import setup_bench
    from shakti_tpu_torch.solve.timestep import (make_forcing, make_step_fn,
                                                 run_window)
    if not shakti_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {shakti_tpu_torch.__file__}, not {root}")
    dev = torch.device("cuda:0")
    spmv_cuda.build()
    out = {"root": root, "card": cs.nvidia_smi_line()}
    if "ell_spmv" in spmv_cuda.KERNELS:
        large_md = cs.scale_model() if args.large else None
        large = large_md.freeze(dev) if args.large else None
        out["ell"] = ell_costs(cs, dev, large)
        if args.large:
            out["rebuild_memory"] = rebuild_memory(large_md, large, dev)
        del large
    if args.no_main:
        print(json.dumps(out), flush=True)
        return
    with tempfile.TemporaryDirectory() as tmp:
        md = setup_bench.initialize(days=2,
                                    results_name=os.path.join(tmp, "run"))
        md.device = dev
        out.update(matvec_costs(cs, md, dev))
        r = md.solve(progress=False)
    out["main_ms_per_step"] = 1e3 * r["wall_time"] / r["steps"]
    mesh, static, _, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    day = {k: v[24:48] for k, v in make_forcing(
        md.timesteps, dtype=md.dtype, device=dev).items()}
    out["steady"] = []
    for _ in range(args.days):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, dg = run_window(step, r["state"], day)
        torch.cuda.synchronize(dev)
        out["steady"].append(dict(
            ms_per_step=1e3 * (time.perf_counter() - t0) / 24,
            newton_mean=float(np.mean(dg["newton_iters"])),
            cg_mean=float(np.mean(dg["cg_iters"]))))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_window(step, r["state"], day)
        torch.cuda.synchronize(dev)
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    out["host_ops_per_step"] = {
        e.key: [e.count / 24, e.self_cpu_time_total / 24 / 1e3]
        for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:10]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
