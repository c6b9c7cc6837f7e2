"""Every file of BENCHMARK.json's cells and metrics is found by name, and
the file keeps to the benchmark's contract in what can be checked here."""

import json
import re

import pytest

from benchmarks.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell)
    assert callable(c.config.build) and callable(c.config.initial)
    assert {"warmup_steps", "judge_steps", "trace_seconds", "limits"} <= set(
        c.workload)
    assert {"members", "dt_s", "first_dt_fraction"} <= set(c.traffic)
    assert c.end_to_end and c.per_layer
    assert any(m["name"] == "setup_s" for m in c.end_to_end)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    assert callable(spec.metric_reader(metric))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moves = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moves.get("workloads", CELLS))
    assert len(set(METRICS)) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_split_name_falls_back_to_its_base_reader():
    assert spec.metric_reader("cg_per_step.ens") is not None
    base = spec.metric_reader("cg_per_step")
    assert spec.metric_reader("cg_per_step.ens").__code__.co_code == \
        base.__code__.co_code
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.ens")


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "metrics").glob(
    "*.py")), ids=lambda p: p.stem)
def test_every_reader_reads_a_run(path):
    """Each reader file, named in BENCHMARK.json or kept for a later cell,
    reads a number from a run with a trace, and None from a run with
    nothing to read."""
    import numpy as np

    from benchmarks.harness import bench, trace
    from benchmarks.tests.test_bench_bytes import square_mesh
    t = trace.Trace(steps=4, wall_s=1.0, busy_s=0.5, launches=40, syncs=8,
                    kernels=[("void bell_spmv_kernel<float>(float*)", 1e-5)],
                    device_ops=[], idle_gaps=[], records=1)
    diag = {"newton_iters": np.ones((5, 2)), "cg_iters": np.full((5, 2), 3),
            "converged": np.ones((5, 2), bool)}
    full = bench.Run(cell="c", members=2, steps=5, window_s=1.0,
                     step_times_ms=[10.0, 11.0, 12.0, 30.0, 9.0], setup_s=3.0,
                     freeze_s=1.0, diag=diag, peak_window_bytes=10 ** 9,
                     cells=square_mesh(8), n=81, value_bytes=4, trace=t)
    read = spec.load_module(path, path.stem).read
    v = read(full)
    assert isinstance(v, float) and v > 0, v
    empty = bench.Run(cell="c", members=2, steps=0, window_s=1.0,
                      step_times_ms=[], setup_s=3.0, freeze_s=1.0, diag=diag,
                      peak_window_bytes=0, cells=square_mesh(8), n=81,
                      value_bytes=4, trace=None)
    if path.stem not in ("setup_s", "freeze_s"):
        assert read(empty) is None
