"""One run of one cell: build, freeze, warm up, the timed window, the judge.

The window drives the port's own step, one hourly step after another, with
the host clock around work that ends in ``torch.cuda.synchronize()``, until
``--seconds`` have passed, and a pair of CUDA events around each step (the
device's clock: a step is too short for the host's).  Nothing else runs
inside it except the bookkeeping of the judge's sample (references to
states the step made) and, with ``--trace 1``, the profiler over its first
``trace_seconds``.

Then, with the window closed and its peak memory read, the program's model
is freed and the plain reference (benchmarks/reference) judges a sample of
the window's steps drawn from the seed, and the first step from the
reference's own initial state: the N residual of the discrete equations,
and q, melt and b against the explicit update from that N.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from benchmarks.harness import guard, spec
from benchmarks.harness import trace as tr
from benchmarks.reference import shakti_ref as ref

JUDGED = ("n_resid", "q_err", "melt_err", "b_err")


def process_age() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def seeded(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use (``stream``) of the run's seed."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, stream]))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """What the metric readers (benchmarks/metrics/*.py) read."""

    cell: str
    members: int          # 1: the single run's step; M: the ensemble's
    steps: int            # steps completed in the window
    window_s: float
    step_times_ms: list   # each step's wall by CUDA events (host clock
                          # on the CPU)
    setup_s: float
    freeze_s: float
    diag: dict            # newton_iters, cg_iters, converged: (steps[, M])
    peak_window_bytes: int
    cells: np.ndarray     # the mesh's triangles
    n: int
    value_bytes: int
    trace: tr.Trace | None


class Model:
    """A cell's configuration built and frozen once: the port's
    ModelSetup ``md``, its frozen problem and its step."""

    def __init__(self, cell: spec.Cell, device):
        from shakti_tpu_torch.parallel.ensemble import make_ensemble_step_fn
        from shakti_tpu_torch.solve.timestep import make_step_fn
        self.cell, self.device = cell, torch.device(device)
        s, t = cell.settings, cell.traffic
        t0 = time.perf_counter()
        self.fields = cell.config.fields(s)
        md = cell.config.build(self.fields, s, device)
        self.build_s = time.perf_counter() - t0
        md.device = device
        md.dtype = getattr(torch, s["dtype"])
        md.solver = dataclasses.replace(md.solver, **s.get("solver", {}),
                                        **t.get("solver", {}))
        self.md = md
        self.members = int(t["members"])
        t0 = time.perf_counter()
        self.frozen = md.freeze()
        sync(device)
        self.freeze_s = time.perf_counter() - t0
        mesh, static, _, cfg = self.frozen
        make = make_step_fn if self.members == 1 else make_ensemble_step_fn
        self.step = make(mesh, static, md.params, cfg)
        iperm = md.node_iperm
        self.iperm = None if iperm is None else torch.as_tensor(
            iperm, device=device)
        self.perm = None if iperm is None else np.argsort(iperm)

    def inputs(self, seed: int) -> dict:
        """The initial state drawn from ``seed``, user order, float64 numpy
        with a leading member axis."""
        return self.cell.config.initial(self.fields, self.cell.settings,
                                        self.cell.traffic, seeded(seed, 1))

    def program_state(self, inputs: dict):
        md, dev = self.md, self.device

        def t(a):
            a = a if self.perm is None else a[:, self.perm]
            x = torch.as_tensor(a, device=dev).to(md.dtype)
            return x[0] if self.members == 1 else x

        N = t(inputs["N"])
        lag = self.frozen[2].lag_op if self.members == 1 else None
        return dataclasses.replace(self.frozen[2], N=N, b=t(inputs["b"]),
                                   q=t(inputs["q"]), melt=t(inputs["melt"]),
                                   N_prev=N, lag_op=lag)

    def user_state(self, state) -> dict:
        """A program state in user order, float64, leading member axis."""
        def u(x):
            x = x.detach().to(torch.float64)
            x = x[None] if self.members == 1 else x
            return x if self.iperm is None else x[:, self.iperm]
        return {k: u(getattr(state, k)) for k in ("N", "b", "q", "melt")}

    def dts(self):
        """(first step's dt, every later dt): the reference's first-step
        quirk dt_0 = fraction * dt."""
        t = self.cell.traffic
        return t["first_dt_fraction"] * t["dt_s"], float(t["dt_s"])


def reference_problem(fv: dict, device, dtype=torch.float64) -> ref.Problem:
    """The reference's problem from a configuration's fields (user order),
    the same that the port was given: it works out the geometry and the
    Dirichlet nodes itself."""
    return ref.build_problem(
        fv["nodes"], fv["cells"], z_b=fv["z_b"], z_s=fv["z_s"], G=fv["G"],
        inputs=fv["inputs"], storage=fv["storage"],
        dirichlet=ref.dirichlet_nodes(fv["nodes"], fv["cells"],
                                      fv["outflow"]),
        N_bdry=fv["N_bdry"], b_min=fv["b_min"], b_max=fv["b_max"],
        dtype=dtype, device=device)


def window(model: Model, seed: int, seconds: float, trace_s: float = 0.0,
           step=None):
    """Warm-up and the timed window from ``seed``'s initial state.  Returns
    a dict: the counters of the window, the judge's samples (user order)
    and the profiler (or None).  ``step`` replaces the model's step
    (tests)."""
    step = model.step if step is None else step
    wl = model.cell.workload
    dev, dtype = model.device, model.md.dtype
    cuda = dev.type == "cuda"
    inputs = model.inputs(seed)
    state = model.program_state(inputs)
    dt0, dt = model.dts()
    dt0_t = torch.tensor(dt0, dtype=dtype, device=dev)
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    # the cold start, judged from the reference's own initial state
    t_warm = time.perf_counter()
    state, _ = step(state, dt0_t)
    start = (dt0, {k: torch.as_tensor(v, device=dev)
                   for k, v in inputs.items()}, state)
    for _ in range(int(wl["warmup_steps"])):
        state, _ = step(state, dt_t)
    sync(dev)
    t_first = time.perf_counter()
    warm_s = t_first - t_warm
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    K = int(wl["judge_steps"])
    pick = seeded(seed, 2)
    sample, diags, times = [], [], []
    if cuda:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    prof = None
    if trace_s > 0 and cuda:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        from shakti_tpu_torch.ops import spmv_cuda
        launches0 = dict(spmv_cuda.launches)
        prof.start()
    traced, launches = None, {}

    def stop_trace(steps, wall):
        prof.stop()
        return (steps, wall), {key: v - launches0[key]
                               for key, v in spmv_cuda.launches.items()}

    sync(dev)
    t0 = now = time.perf_counter()
    k = 0
    while True:
        before, then = state, now
        if cuda:
            ev0.record()
        state, d = step(state, dt_t)
        if cuda:
            ev1.record()
        sync(dev)
        now = time.perf_counter()
        times.append(ev0.elapsed_time(ev1) if cuda else 1e3 * (now - then))
        diags.append(d)
        # reservoir sample of K steps, drawn from the seed
        if k < K:
            sample.append((dt, before, state))
        else:
            j = int(pick.integers(0, k + 1))
            if j < K:
                sample[j] = (dt, before, state)
        k += 1
        if prof is not None and traced is None and now - t0 >= trace_s:
            traced, launches = stop_trace(k, now - t0)
        if now - t0 >= seconds:
            break
    window_s = now - t0
    if prof is not None and traced is None:
        traced, launches = stop_trace(k, window_s)
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del state, before
    keys = ("newton_iters", "cg_iters", "converged")
    diag = {key: np.asarray([np.asarray(d[key]) for d in diags])
            for key in keys}
    samples = [(start[0], start[1], model.user_state(start[2]))]
    samples += [(dt_, model.user_state(b), model.user_state(a))
                for dt_, b, a in sample]
    return dict(steps=k, window_s=window_s, step_times_ms=times, diag=diag,
                t_first=t_first, warm_s=warm_s, peak_setup=peak_setup,
                peak_window=peak_window, samples=samples,
                prof=prof, traced=traced, spmv_launches=launches)


def judged_members(workload: dict, members: int, seed: int) -> list:
    """The members the judge reads: all, or ``judge_members`` of them
    drawn from the seed."""
    k = int(workload.get("judge_members", members))
    if k >= members:
        return list(range(members))
    return sorted(seeded(seed, 3).choice(members, k, replace=False).tolist())


def judge(prob: ref.Problem, samples, members=None) -> dict:
    """The largest reading of each judged number over the samples and the
    ``members`` (default all; NaN reads as inf)."""
    worst = dict.fromkeys(JUDGED, 0.0)
    for dt, before, after in samples:
        for m in range(after["N"].shape[0]) if members is None else members:
            r = ref.judge(prob, {k: v[m] for k, v in before.items()},
                          {k: v[m] for k, v in after.items()}, dt)
            for key, v in r.items():
                worst[key] = max(worst[key], v if v == v else float("inf"))
    return worst


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float | None = None, step_wrap=None) -> dict:
    """One run; returns the result line's dict (without the check of the
    loaded modules, which the caller makes)."""
    t_start = time.perf_counter() - process_age() if t_start is None \
        else t_start
    t_model = time.perf_counter()
    model = Model(cell, device)
    step = None if step_wrap is None else step_wrap(model.step)
    w = window(model, seed, seconds,
               float(cell.workload["trace_seconds"]) if trace else 0.0, step)
    members = model.members
    print(f"setup: {w['t_first'] - t_start:.3f} s = imports and card "
          f"{t_model - t_start:.3f} s, configuration {model.build_s:.3f} s, "
          f"freeze {model.freeze_s:.3f} s, cold start and warm-up "
          f"{w['warm_s']:.3f} s; window: {w['steps']} steps in "
          f"{w['window_s']:.3f} s", file=sys.stderr)
    value_bytes = torch.tensor([], dtype=model.md.dtype).element_size()
    cells, n, freeze_s = (model.fields["cells"], model.fields["nodes"].shape[0],
                          model.freeze_s)
    t = None
    if w["prof"] is not None:
        t = tr.summarize(w["prof"], *w["traced"])
    record = Run(cell=cell.name, members=members, steps=w["steps"],
                 window_s=w["window_s"], step_times_ms=w["step_times_ms"],
                 setup_s=w["t_first"] - t_start, freeze_s=freeze_s,
                 diag=w["diag"], peak_window_bytes=w["peak_window"],
                 cells=cells, n=n, value_bytes=value_bytes, trace=t)
    metrics = {}
    for m in cell.metrics(trace):
        v = spec.metric_reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    out = {"attempted": w["steps"] * members,
           "failed": int((~w["diag"]["converged"].astype(bool)).sum()),
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1,
                      "memory_peak_bytes": int(max(w["peak_setup"],
                                                   w["peak_window"]))}}
    if t is not None:
        out["device"].update(busy_s=t.busy_s, window_s=t.wall_s)
        out["breakdown"] = {"device_ops": t.device_ops,
                            "idle_gaps": t.idle_gaps}
        print(f"trace: {t.steps} steps in {t.wall_s:.3f} s, {t.records} "
              f"device records, {t.launches} launches, port's kernel "
              f"launches {w['spmv_launches']}", file=sys.stderr)
    # the program's model goes before the reference runs
    fv, samples = model.fields, w["samples"]
    del w, model, t, record, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = judge(reference_problem(fv, dev), samples,
                     judged_members(cell.workload, members, seed))
    limits = cell.workload["limits"]
    out["correct"] = all(readings[k] <= limits[k] for k in JUDGED)
    out["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                     for k in JUDGED}
    return out


def finite(v: float) -> float:
    """inf (a NaN or an overflow read by the judge) as the largest float,
    which JSON can hold."""
    return v if abs(v) <= sys.float_info.max else sys.float_info.max


def result_line(out: dict) -> str:
    """The last line of standard output: the contract's keys, the checks
    last."""
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += [k for k in ("breakdown",) if k in out]
    line = {k: out[k] for k in keys}
    line["card"] = out.get("card", "")
    line["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                      for k, c in out["checks"].items()}
    return json.dumps(line)


def main(argv=None) -> int:
    import argparse
    t_start = time.perf_counter() - process_age()
    ap = argparse.ArgumentParser(description="One run of one cell of "
                                 "BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload)
    chips = next(w["chips"] for w in spec.benchmark()["workloads"]
                 if w["name"] == a.workload)
    err = guard.card_error(chips)
    if err:
        print(err, file=sys.stderr)
        return 2
    out = run(cell, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    # nvidia-smi's name and power limit, read after the window so that
    # set-up counts the program's work alone
    out["card"] = guard.card_line()
    print(f"card: {out['card']}", file=sys.stderr)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}; the benchmark "
              "measures the port alone", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(result_line(out), flush=True)
    return 0
