"""Finding a cell's files by the names in BENCHMARK.json.

Every part of a cell is a file of its own, found by name:

- ``BENCHMARK.json`` (the root of the checkout): the cell's entry in
  ``workloads`` (its configuration and traffic names) and the metrics whose
  ``workloads`` list the cell (or that have no ``workloads`` key);
- ``benchmarks/configs/<config>.json``: the configuration as it is run, and
  ``benchmarks/configs/<config>.py``, which makes its inputs (``fields``),
  builds it from them through the port's public API (``build``) and draws
  the initial state from the seed (``initial``);
- ``benchmarks/traffic/<traffic>.json``: how the model is driven (members,
  hourly step, first-step fraction, preconditioner);
- ``benchmarks/workloads/<cell>.json``: warm-up steps, the sample the judge
  checks, the traced slice and the limits of ``correct``;
- ``benchmarks/metrics/<metric>.py``: one reader per metric,
  ``read(run) -> float | None`` (``<base>.<part>`` falls back to
  ``<base>.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    modname = "bench_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    settings: dict        # configs/<config>.json
    config: object        # configs/<config>.py
    traffic: dict         # traffic/<traffic>.json
    workload: dict        # workloads/<cell>.json
    end_to_end: list      # BENCHMARK.json entries reported with --trace 0
    per_layer: list       # ... and with --trace 1

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with all its files; raises for an unknown name or a
    missing file."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    w = entries[name]
    bdir = root / "benchmarks"
    return Cell(
        name=name, config_name=w["config"],
        settings=load_json(bdir / "configs" / f"{w['config']}.json"),
        config=load_module(bdir / "configs" / f"{w['config']}.py",
                           w["config"]),
        traffic=load_json(bdir / "traffic" / f"{w['traffic']}.json"),
        workload=load_json(bdir / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of benchmarks/metrics/<name>.py; a name ``<base>.<part>``
    with no file of its own is read by <base>.py (one quantity, split by
    the end-to-end metric that it moves, computed in one place)."""
    mdir = root / "benchmarks" / "metrics"
    path = mdir / f"{name}.py"
    if not path.is_file():
        path = mdir / f"{name.split('.', 1)[0]}.py"
    return load_module(path, path.stem).read
