"""One example twin (examples/torch_<name>.py) at the JAX example's defaults
on the card, held to the JAX example's printed results
(examples/torch_examples_jax_ref.json, written by
tests/torch_examples_ref.py on the CPU):

    python scripts/torch_examples_card.py NAME [--out FILE] [--device D]
                                          [--float64]

NAME is one of calibrate_melt, invert_melt_field, ensemble_uq,
lake_workflow, basin_pipeline.  The record (the twin's result, its wall
time, the card, the peak device memory, the bell_spmv launches and the
plain operators' calls, and the checks) is printed and written to FILE.
calibrate_melt also computes the gradient at s = 1.2 with the checkpointed
step and with the unwrapped one: the recomputations' Newton/CG counts, the
two gradients and the two peak memories.  Exits 1 when a check fails.

The checks: calibrate_melt recovers s within 1e-3 of 1.7 and within 1e-6
of JAX's; invert_melt_field ends below 0.30 of its initial field error and
within 0.005 of JAX's final error; ensemble_uq's final mean N within 1e-5
relative of JAX's and its spread within 5 %; lake_workflow's five numbers
print as JAX's; basin_pipeline's mesh has JAX's counts, N is finite and
the Newton total within 1 of JAX's.  ``--float64`` (ensemble_uq only)
runs the twin in float64 and holds it to the JAX example's run with
jax_enable_x64 on (``ensemble_uq_x64`` in the same file).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

from shakti_tpu_torch.ops import spmv_cuda  # noqa: E402
from torch_cooke2_report import CountPlain, card  # noqa: E402

REF = os.path.join(ROOT, "examples", "torch_examples_jax_ref.json")
# lake_workflow's printed formats (examples/lake_workflow.py)
LAKE_FORMATS = {"level_change_mm": "+.2f", "filling_rate_m_per_yr": "+.3f",
                "mean_gap_mm": ".3f", "peak_flux_m2s": ".3g",
                "far_field_ratio": ".3f"}


def twin(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_" + name, os.path.join(ROOT, "examples", f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def checks(name, got, ref):
    if name == "calibrate_melt":
        return {"recovers_1.7": abs(got["s"] - 1.7) <= 1e-3 * 1.7,
                "s_as_jax": abs(got["s"] - ref["s"]) <= 1e-6}
    if name == "invert_melt_field":
        return {"below_0.30": got["err"] < 0.30 * got["err0"],
                "err_as_jax": abs(got["err"] - ref["err"]) <= 0.005}
    if name == "ensemble_uq":
        return {"mean_as_jax": abs(got["final_mean_MPa"]
                                   - ref["final_mean_MPa"])
                <= 1e-5 * abs(ref["final_mean_MPa"]),
                "spread_as_jax": abs(got["final_std_MPa"]
                                     - ref["final_std_MPa"])
                <= 0.05 * ref["final_std_MPa"]}
    if name == "lake_workflow":
        return {k: format(got[k], f) == format(ref[k], f)
                for k, f in LAKE_FORMATS.items()}
    if name == "basin_pipeline":
        return {"counts": all(got[k] == ref[k] for k in (
                    "outline_vertices", "nodes", "triangles")),
                "finite": got["finite"],
                "newton_total": abs(got["newton_total"]
                                    - ref["newton_total"]) <= 1}
    raise KeyError(name)


def checkpoint_compare(mod, dev, **cut):
    """The gradient at s = 1.2 with the checkpointed step and with the
    unwrapped one (calibrate_melt's build at ``cut``, default its own),
    each with its peak memory above the start."""
    out = {}
    for remat in (True, False):
        md, state, step, dts = mod.build(device=dev, remat=remat, **cut)
        with torch.no_grad():
            N_obs = mod.final_N(step, state, dts, torch.tensor(
                1.7, dtype=md.dtype, device=dts.device))
        if remat:
            step.calls.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        loss, g = mod.value_and_grad(step, state, dts, N_obs, 1.2)
        torch.cuda.synchronize()
        out["checkpointed" if remat else "unwrapped"] = {
            "loss": loss, "grad": g, "wall_s": time.time() - t0,
            "peak_MB": (torch.cuda.max_memory_allocated() - base) / 2 ** 20,
            "counts": list(step.calls) if remat else None}
    c = out["checkpointed"]
    n = len(c["counts"]) // 2
    out["recompute_equal"] = c["counts"][n:] == c["counts"][:n][::-1]
    out["grad_equal"] = (c["grad"], c["loss"]) == (
        out["unwrapped"]["grad"], out["unwrapped"]["loss"])
    return out


def main(name, out=None, device="cuda", float64=False):
    if float64 and name != "ensemble_uq":
        raise SystemExit("--float64 is for ensemble_uq")
    with open(REF) as f:
        ref = json.load(f)[name + ("_x64" if float64 else "")]
    mod = twin(name)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    rec = {"name": name, "card": card() if on_card else None,
           "dtype": "float64" if float64 else "the setup's"}
    spmv_cuda.reset_launches()
    if on_card:
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp, CountPlain() as plain:
        args = ((os.path.join(tmp, "out"),)
                if name in ("lake_workflow", "basin_pipeline") else ())
        got = mod.main(*args, device=device,
                       **({"dtype": torch.float64} if float64 else {}))
    rec["wall_s"] = time.time() - t0
    rec["launches"] = dict(spmv_cuda.launches)
    rec["plain_calls"] = dict(plain)
    if on_card:
        rec["peak_MB"] = torch.cuda.max_memory_allocated() / 2 ** 20
    got.pop("theta", None)
    rec["result"], rec["jax"] = got, {k: v for k, v in ref.items()
                                      if k != "stdout"}
    rec["checks"] = checks(name, got, ref)
    if name == "calibrate_melt" and on_card:
        rec["checkpoint"] = checkpoint_compare(mod, device)
        rec["checks"].update(
            recompute_equal=rec["checkpoint"]["recompute_equal"],
            grad_equal=rec["checkpoint"]["grad_equal"])
    rec["checks"]["no_plain_calls"] = not any(plain.values()) or not on_card
    print(json.dumps(rec), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if all(rec["checks"].values()) else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--float64", action="store_true")
    a = ap.parse_args()
    sys.exit(main(a.name, a.out, a.device, a.float64))
