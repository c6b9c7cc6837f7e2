"""Where a cell's step spends the device's time, by the port's spans: for
each seed, the warm-up and a window of ``--seconds`` as a run makes them
(harness/bench.window, the profiler over the cell's first
``trace_seconds``), then the traced slice's span table
(harness/spans.py) per ensemble step, and the Krylov loop's trips
(``krylov.trips``, shakti_tpu_torch/utils/trace.py) against the members'
CG iterations, over the traced slice and the whole window.

    python3 benchmarks/spans.py --workload cooke2-ens128 --seeds 1,2 \\
        --seconds 10 --out build/spans.json

Writes the readings as JSON to ``--out`` and prints one line per seed.
The judge does not run: this is a reading of where the time goes, not a
run of the benchmark.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks.harness import bench, spans, spec  # noqa: E402
from benchmarks.harness import trace as tr  # noqa: E402
from shakti_tpu_torch.utils import trace as pt  # noqa: E402

CHILDREN = ("newton.residual", "newton.jacobian", "newton.fold",
            "newton.precond", "krylov")


def live_share(cg, trips) -> float | None:
    """100 x the members' CG iterations over the batched loop's member-slots
    (members x trips), or None without trips."""
    return 100.0 * float(cg.sum()) / (cg.shape[1] * trips) if trips else None


def device_sync_callers(prof) -> dict:
    """{caller: count} of the ``cudaDeviceSynchronize`` calls in a
    profile, the caller being the innermost PyTorch op or span around
    each ("host" where none is)."""
    out = {}
    for e in prof.events():
        if e.name != spans.DEVICE_SYNC:
            continue
        p = e.cpu_parent
        while p is not None and p.name.startswith("cu"):
            p = p.cpu_parent
        key = "host" if p is None else p.name
        out[key] = out.get(key, 0) + 1
    return out


def reading(model, seed, seconds) -> dict:
    """One seed's window, traced, reduced to per-step numbers."""
    trips = []

    def counted(step):
        def run(state, forcing):
            trips.append(pt.snapshot()["krylov.trips"])
            return step(state, forcing)
        return run

    w = bench.window(model, seed, seconds,
                     float(model.cell.workload["trace_seconds"]),
                     counted(model.step))
    trips.append(pt.snapshot()["krylov.trips"])
    t = tr.summarize(w["prof"], *w["traced"])
    tab = spans.from_profile(w["prof"], pt.SPANS)
    n = t.steps
    first = len(trips) - 1 - w["steps"]          # the window's first step
    cg = w["diag"]["cg_iters"]
    per = {name: {(k[:-2] + "_ms" if k.endswith("_s") else k):
                  v / n * (1e3 if k.endswith("_s") else 1.0)
                  for k, v in vars(row).items()}
           for name, row in tab.rows.items() if row.calls}
    for name, kernels in tab.kernels.items():
        row = per.setdefault(name or "(no span)", {})
        row["device_self_ms"] = 1e3 * sum(kernels.values()) / n
        row["top_kernels_ms"] = [[k, 1e3 * v / n]
                                 for k, v in tr.top(kernels, 4)]
    under = per.get("step", {})
    busy_ms = 1e3 * t.busy_s / n
    idle_ms = 1e3 * (t.wall_s - t.busy_s) / n
    slice_trips = trips[first + n] - trips[first]
    window_trips = trips[-1] - trips[first]
    out = dict(
        seed=seed, traced_steps=n, window_steps=w["steps"],
        members=model.members,
        wall_ms=1e3 * t.wall_s / n, busy_ms=busy_ms,
        idle_share=100.0 * (1.0 - t.busy_s / t.wall_s),
        member_steps_per_s=model.members * w["steps"] / w["window_s"],
        launches=t.launches / n, syncs=t.syncs / n,
        spans=per,
        idle_outside_step_ms=1e3 * tab.idle_outside_step_s / n,
        gap_idle_ms=1e3 * tab.idle_s / n,
        device_ms=1e3 * tab.device_s / n,
        unlaunched_ms=1e3 * tab.unlaunched_s / n,
        step_share_of_busy=(100.0 * under.get("device_ms", 0.0) / busy_ms
                            if busy_ms else None),
        children_over_step=(sum(per.get(c, {}).get("device_ms", 0.0)
                                for c in CHILDREN)
                            / under["device_ms"] if under.get("device_ms")
                            else None),
        idle_split_over_idle=((under.get("idle_ms", 0.0)
                               + 1e3 * tab.idle_outside_step_s / n) / idle_ms
                              if idle_ms > 0 else None),
        krylov_trips=slice_trips / n,
        cg_per_member=float(cg[:n].mean()),
        newton_per_member=float(w["diag"]["newton_iters"][:n].mean()),
        cg_live_share=live_share(cg[:n], slice_trips),
        cg_live_share_window=live_share(cg, window_trips),
        krylov_trips_window=window_trips / w["steps"],
        cg_per_member_window=float(cg.mean()),
        device_sync_callers={k: v / n for k, v in
                             device_sync_callers(w["prof"]).items()},
        idle_gaps=t.idle_gaps, device_ops=t.device_ops)
    del w
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    err = bench.guard.card_error(1)
    if err:
        print(err, file=sys.stderr)
        return 2
    print(f"card: {bench.guard.card_line()}", file=sys.stderr)
    model = bench.Model(spec.load_cell(a.workload), "cuda")
    res = dict(workload=a.workload, seeds=[])
    for seed in a.seeds.split(","):
        r = reading(model, int(seed), a.seconds)
        res["seeds"].append(r)
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("idle_gaps", "device_ops")}),
              flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
