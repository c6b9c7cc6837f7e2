"""The harness end to end on the CPU at small sizes: the result's keys; a
sound run is correct; the bfloat16 control, and each fault a cell can have
planted under the timed path, come out not correct against the cells'
limits."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import benchmarks.calibrate as cal
from benchmarks.harness import bench
from benchmarks.tests.test_bench_reference import small

SEED = 2_147_483_659


def run(cell, step_wrap=None, seconds=1.0):
    torch.set_num_threads(2)
    return bench.run(cell, SEED, seconds, False, "cpu", 0.0, step_wrap)


@pytest.mark.parametrize("members", [1, 4])
def test_sound_run_is_correct(members, small_assets):
    cell = small(small_assets, "float32", members)
    out = run(cell)
    line = json.loads(bench.result_line(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "card", "checks"}
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(bench.JUDGED)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["correct"] is True, line["checks"]


def unchanged(step):
    """A step that returns its state unchanged."""
    return lambda s, f: (s, step(s, f)[1])


def altered(step):
    """An answer altered where it is produced: N 10 % high at one node.
    (The float32 program's own N lies up to ~1.5 % of N's scale from the
    float64 root at weakly coupled nodes of Cook_E2, so 1 % at one node is
    no fault the judge can tell from a sound run.)"""
    def wrapped(s, f):
        new, d = step(s, f)
        N = new.N.clone()
        N[..., N.shape[-1] // 2] *= 1.1
        return dataclasses.replace(new, N=N), d
    return wrapped


def half_left_out(step):
    """Half of the members left out: they keep their state."""
    def wrapped(s, f):
        new, d = step(s, f)
        h = s.N.shape[0] // 2
        keep = {k: torch.cat([getattr(new, k)[:h], getattr(s, k)[h:]])
                for k in ("N", "b", "q", "melt")}
        return dataclasses.replace(new, **keep), d
    return wrapped


@pytest.mark.parametrize("members,fault", [
    (1, unchanged), (1, altered), (4, unchanged), (4, altered),
    (4, half_left_out)])
def test_fault_is_not_correct(members, fault, small_assets):
    out = run(small(small_assets, "float32", members), fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("members", [1, 2])
def test_bfloat16_control_is_not_correct(members, small_assets):
    torch.set_num_threads(2)
    cell = small(small_assets, "float32", members)
    model = bench.Model(cell, "cpu")
    prob = bench.reference_problem(model.fields, "cpu")
    readings = bench.judge(prob, cal.control_samples(model, SEED, members, 2))
    limits = cell.workload["limits"]
    assert any(readings[k] > limits[k] for k in bench.JUDGED), readings


def test_nonfinite_reading_prints_as_a_number():
    out = dict(correct=False, attempted=1, failed=1, metrics={}, device={},
               checks={"n_resid": {"value": float("inf"), "limit": 1e-4}})
    line = json.loads(bench.result_line(out))
    assert np.isfinite(line["checks"]["n_resid"]["value"])
