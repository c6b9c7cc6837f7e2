"""On the card: one short run of each cell through the command, correct,
with every end-to-end metric of the cell (skips without a card)."""

import json
import subprocess
import sys

import pytest

from benchmarks.harness import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    r = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        cell, "--seed", "3000000019", "--seconds", "3",
                        "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    want = {m["name"] for m in spec.load_cell(cell).end_to_end}
    assert set(line["metrics"]) == want
