"""The readings that a cell's limits of ``correct`` are set from, at the
cell's own size on the card, in one process (one freeze):

- the program: for each of ``--seeds``, the warm-up and a window of
  ``--seconds`` from that seed, judged as a run judges it;
- the control: the plain reference in the program's place, in bfloat16,
  the precision below the configuration's float32 (the step has no matrix
  product for TF32 to touch).  Its state is held in bfloat16, and each
  step is the float64 reference's converged step from that state, rounded
  to bfloat16: the answer of a bfloat16 program that solves each step
  exactly, the closest that any can come.  From each of
  ``--control-seeds``: the cold start, the warm-up and ``--control-steps``
  steps, each judged as the program's; an ensemble's first
  ``--control-members`` members.

    python3 benchmarks/calibrate.py --workload cooke2-ens128 --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 10 --out build/cal.json

Writes the readings as JSON to ``--out`` and prints them.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmarks.harness import bench, spec  # noqa: E402
from benchmarks.reference import shakti_ref as ref  # noqa: E402


def rounded(state: dict, dtype=torch.bfloat16) -> dict:
    """Each field rounded to ``dtype`` and held as float64."""
    return {k: v.to(dtype).to(torch.float64) for k, v in state.items()}


def control_samples(model, seed, members, steps, dtype=torch.bfloat16):
    """The control stepped from ``seed``'s initial state through the cold
    start, the warm-up and ``steps`` steps: [(dt, before, after)] as
    float64 with a leading member axis."""
    prob = bench.reference_problem(model.fields, model.device)
    inputs = model.inputs(seed)
    dt0, dt = model.dts()
    dts = [dt0] + [dt] * (int(model.cell.workload["warmup_steps"]) + steps)
    runs = []
    for m in range(min(members, inputs["N"].shape[0])):
        s = rounded({k: torch.as_tensor(v[m], device=model.device)
                     for k, v in inputs.items()}, dtype)
        run = []
        for d in dts:
            new = rounded(ref.step(prob, s, d), dtype)
            run.append((s, new))
            s = new
        runs.append(run)
    # stack members per step for bench.judge
    return [(d, {f: torch.stack([r[k][0][f] for r in runs]) for f in
                 runs[0][k][0]},
             {f: torch.stack([r[k][1][f] for r in runs]) for f in
              runs[0][k][1]}) for k, d in enumerate(dts)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-members", type=int, default=4)
    ap.add_argument("--control-steps", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    if a.device == "cuda":
        err = bench.guard.card_error(1)
        if err:
            print(err, file=sys.stderr)
            return 2
        print(f"card: {bench.guard.card_line()}", file=sys.stderr)
    cell = spec.load_cell(a.workload)
    t0 = time.perf_counter()
    model = bench.Model(cell, a.device)
    prob = bench.reference_problem(model.fields, model.device)
    res = dict(workload=a.workload, freeze_s=model.freeze_s,
               build_s=time.perf_counter() - t0, program={}, control={})
    for seed in filter(None, a.seeds.split(",")):
        w = bench.window(model, int(seed), a.seconds)
        t1 = time.perf_counter()
        r = bench.judge(prob, w["samples"])
        res["program"][seed] = dict(
            readings=r, steps=w["steps"], window_s=w["window_s"],
            failed=int((~w["diag"]["converged"].astype(bool)).sum()),
            judge_s=time.perf_counter() - t1)
        print(seed, json.dumps(res["program"][seed]), file=sys.stderr,
              flush=True)
        del w
    for seed in filter(None, a.control_seeds.split(",")):
        t1 = time.perf_counter()
        r = bench.judge(prob, control_samples(
            model, int(seed), a.control_members, a.control_steps))
        res["control"][seed] = dict(readings=r,
                                    seconds=time.perf_counter() - t1)
        print("control", seed, json.dumps(res["control"][seed]),
              file=sys.stderr, flush=True)
    for side in ("program", "control"):
        runs = res[side].values()
        if runs:
            res[f"{side}_max" if side == "program" else f"{side}_min"] = {
                k: (max if side == "program" else min)(
                    x["readings"][k] for x in runs) for k in bench.JUDGED}
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({k: res.get(k) for k in ("program_max", "control_min",
                                               "freeze_s")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
