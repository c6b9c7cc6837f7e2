"""A/B of two trees of the PyTorch port (shakti_tpu_torch) on one NVIDIA GPU:
what one operator matvec costs the host and the device, and the bench
model's steady day.

    python3 torch_ab.py --root DIR [--days 3]

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="tree whose shakti_tpu_torch is measured")
    ap.add_argument("--days", type=int, default=3)
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
    out = {"root": root}
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
