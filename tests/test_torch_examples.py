"""The example twins (examples/torch_*.py) against the JAX examples' code
paths (tests/torch_examples_ref.py) at cuts, in float64 on the CPU, the
JAX side of ensemble_uq and lake_workflow in block-ELL as "auto" resolves
on a TPU and on the port (torch_examples_ref.BELL):

- calibrate_melt: the secant iterates (s, loss, adjoint gradient) within
  1e-8; the checkpointed step against the unwrapped one: the backward's
  recomputations take the forward's Newton and CG counts, step for step,
  and the gradient is bitwise the same;
- invert_melt_field: theta after 3 Adam updates (torch.optim.Adam against
  optax.adam) within 1e-9 of max|theta|, the field errors
  within 1e-9;
- ensemble_uq: the per-day rows and the final members' mean and spread
  within 1e-8;
- lake_workflow: the post numbers within 1e-8 (the run through api/run
  into a results directory);
- basin_pipeline: the quantized potential and its axes read back from the
  GeoTIFF bitwise equal to the in-memory raster the twin routes on without
  Pillow, and the mesh built from either equal; the mesh's counts equal to
  JAX's.

The JAX side runs once, at torch_examples_ref.TEST_CUTS, in a child
process beside the twins (its compilations are most of this file's time).
"""

import os
import sys

import numpy as np
import pytest
import torch

from tests import torch_examples_ref as R
from tests import torch_parity  # noqa: F401  (pins torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


@pytest.fixture(scope="module")
def twin():
    """scripts/torch_examples_card.twin: examples/torch_<name>.py loaded."""
    saved = list(sys.path)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import torch_examples_card
        yield torch_examples_card.twin
    finally:
        sys.path[:] = saved


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX examples' code paths at R.TEST_CUTS in one child process,
    started with the first test so that it runs beside the twins."""
    child = R.Child("--examples-tests", tmp_path_factory.mktemp("jax_ex"))
    yield child
    child.close()


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


CAL = R.TEST_CUTS["calibrate_melt"]


def test_calibrate_matches_jax(twin, jax_runs):
    got = twin("calibrate_melt").main(device="cpu", **CAL)
    ref = jax_runs("calibrate_melt")
    assert len(got["rows"]) == len(ref["rows"]) == 2
    for g, r in zip(got["rows"], ref["rows"]):
        for k in ("s", "loss", "grad"):
            assert _rel(g[k], r[k]) <= 1e-8, (k, g, r)
    assert _rel(got["s"], ref["s"]) <= 1e-8


def test_checkpointed_step_takes_the_same_decisions(twin):
    cal = twin("calibrate_melt")
    grads, counts = {}, {}
    for remat in (True, False):
        md, state, step, dts = cal.build(**{k: CAL[k] for k in (
            "nx", "ny", "days", "nt_per_day")}, device="cpu", remat=remat)
        with torch.no_grad():
            N_obs = cal.final_N(step, state, dts, torch.tensor(1.7, dtype=F64))
        if remat:
            step.calls.clear()
        grads[remat] = cal.value_and_grad(step, state, dts, N_obs, 1.2)
        if remat:
            counts = list(step.calls)
    n = dts.shape[0]
    assert len(counts) == 2 * n                     # forward, then recompute
    assert counts[n:] == counts[:n][::-1]
    assert grads[True] == grads[False]


INV = R.TEST_CUTS["invert_melt_field"]


def test_invert_adam_matches_optax(twin, jax_runs):
    got = twin("invert_melt_field").main(device="cpu", **INV)
    ref = jax_runs("invert_melt_field")
    th, rth = np.asarray(got["theta"]), np.asarray(ref["theta"])
    assert np.abs(th - rth).max() <= 1e-9 * np.abs(rth).max()
    assert got["err0"] == pytest.approx(ref["err0"], rel=1e-12)
    assert got["err"] == pytest.approx(ref["err"], rel=1e-9)
    assert [r["iter"] for r in got["rows"]] == [r["iter"] for r in ref["rows"]]
    for g, r in zip(got["rows"], ref["rows"]):
        assert g["loss"] == pytest.approx(r["loss"], rel=1e-9)


ENS = R.TEST_CUTS["ensemble_uq"]


def test_ensemble_rows_match_jax(twin, jax_runs):
    got = twin("ensemble_uq").main(device="cpu", dtype=F64, **ENS)
    ref = jax_runs("ensemble_uq")
    assert "float64" in ref["dtype"] and len(got["rows"]) == len(ref["rows"])
    for g, r in zip(got["rows"], ref["rows"]):
        assert g["day"] == r["day"]
        for k in ("mean_N_MPa", "spread_MPa", "max_member_spread_MPa"):
            assert _rel(g[k], r[k]) <= 1e-8, (k, g, r)
    for k in ("final_mean_MPa", "final_std_MPa"):
        assert _rel(got[k], ref[k]) <= 1e-8, k


LAKE = R.TEST_CUTS["lake_workflow"]


def test_lake_post_numbers_match_jax(twin, jax_runs, tmp_path):
    got = twin("lake_workflow").main(str(tmp_path / "lake"), device="cpu",
                                      dtype=F64, **LAKE)
    ref = jax_runs("lake_workflow")
    assert got["steps"] == ref["steps"] == 4
    for k, v in ref.items():
        if k != "steps":
            assert got[k] == pytest.approx(v, rel=1e-8, abs=1e-12), k
    assert got["frames"] is None or got["frames"] > 0


def test_basin_raster_round_trip_equals_in_memory(twin, tmp_path,
                                                  monkeypatch):
    bas = twin("basin_pipeline")
    x, y, z_s, z_b, lake = bas.load_grids()
    phi = bas.basin.background_potential(z_s, z_b)
    disk = bas.quantized_raster(phi, x, y, str(tmp_path / "p.tif"))

    def no_pil(*a, **kw):
        raise ImportError("no Pillow")
    monkeypatch.setattr(bas, "write_geotiff", no_pil)
    mem = bas.quantized_raster(phi, x, y, str(tmp_path / "q.tif"))
    assert not os.path.exists(tmp_path / "q.tif")
    assert disk[3].startswith("wrote+read") and mem[3].startswith("in memory")
    for a, b in zip(disk[:3], mem[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # so the mesh is the same either way, and JAX's (committed, at the cut)
    meshes = [bas.basin.basin_mesh(xt, yt, p8.astype(np.float64),
                                    lake_outline=lake, resolution=2000.0)
              for xt, yt, p8, _ in (disk, mem)]
    for a, b in zip(*meshes):
        np.testing.assert_array_equal(a, b)
    import json
    with open(R.CUT_JSON) as f:
        ref = json.load(f)["basin_pipeline"]
    nodes, cells, outline = meshes[0]
    assert (outline.shape[0], nodes.shape[0], cells.shape[0]) == (
        ref["outline_vertices"], ref["nodes"], ref["triangles"])
