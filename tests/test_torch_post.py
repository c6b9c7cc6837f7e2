"""The port's post-processing (post.py) against shakti_tpu's: every
reduction on seeded histories to 1e-14, the dof permutation and its
refusal, load_results on a results directory the port's run layer wrote,
and render_frames' return and frame count (pixels are not compared)."""

import os

import numpy as np
import pytest
import torch

from shakti_tpu import post as jpost
from shakti_tpu.params import DEFAULT_PARAMS as JP
from shakti_tpu_torch import post as tpost
from shakti_tpu_torch.params import DEFAULT_PARAMS as TP
from shakti_tpu_torch.setups import setup_slab as tslab
from tests import torch_parity  # noqa: F401  (pins torch's threads)


@pytest.fixture(scope="module")
def hist():
    rng = np.random.default_rng(8)
    n_t, n = 9, 60
    t = np.linspace(0.0, 8 * 86400.0, n_t)
    return dict(
        t=t, N=3.7e5 + 1e4 * rng.standard_normal((n_t, n)).cumsum(0),
        b=np.abs(1e-3 + 1e-4 * rng.standard_normal((n_t, n))),
        qx=1e-5 * rng.standard_normal((n_t, n)),
        qy=1e-5 * rng.standard_normal((n_t, n)),
        lake=rng.random(n) < 0.2, far=rng.random(n) < 0.5)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A results directory written by the port's run layer (slab 6 x 6,
    float64, 8 steps, 2 daily saves)."""
    rdir = str(tmp_path_factory.mktemp("post") / "run")
    md = tslab.initialize(nx=6, ny=6, days=2.0, nt_per_day=4,
                          results_name=rdir)
    md.device, md.dtype = "cpu", torch.float64
    md.solve(progress=False)
    return rdir, md


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-14,
                               atol=1e-14 * (np.abs(ref).max() or 1.0))


@pytest.mark.parametrize("name", ["lake_mean", "lake_level", "filling_rate",
                                  "mean_gap", "mean_gap_masked", "max_flux",
                                  "max_flux_off_lake", "far_field_ratio"])
def test_reductions(hist, name):
    h = hist
    calls = {
        "lake_mean": lambda p, P: p.lake_mean(h["N"], h["lake"]),
        "lake_level": lambda p, P: p.lake_level(h["N"], h["lake"], P),
        "filling_rate": lambda p, P: p.filling_rate(h["t"], h["N"],
                                                    h["lake"], P),
        "mean_gap": lambda p, P: p.mean_gap(h["b"]),
        "mean_gap_masked": lambda p, P: p.mean_gap(h["b"], h["far"]),
        "max_flux": lambda p, P: p.max_flux(h["qx"], h["qy"]),
        "max_flux_off_lake": lambda p, P: p.max_flux(h["qx"], h["qy"],
                                                     h["lake"]),
        "far_field_ratio": lambda p, P: p.far_field_ratio(h["N"], h["far"],
                                                          3.7e5),
    }
    got, ref = calls[name](tpost, TP), calls[name](jpost, JP)
    assert type(got) is type(ref)
    _close(got, ref)


def test_lake_level_with_other_params(hist):
    got = tpost.lake_level(hist["N"], hist["lake"], TP.replace(g=9.7))
    _close(got, jpost.lake_level(hist["N"], hist["lake"], JP.replace(g=9.7)))
    direct = hist["N"][:, hist["lake"]].mean(1)
    _close(got, -(direct - direct[0]) / (TP.rho_w * 9.7))


def test_dofs_to_serial():
    rng = np.random.default_rng(2)
    serial = rng.uniform(0, 1e4, (50, 2))
    perm = rng.permutation(50)
    parallel = serial[perm] + 1e-4 * rng.standard_normal((50, 2))
    got = tpost.dofs_to_serial(parallel, serial)
    np.testing.assert_array_equal(got, jpost.dofs_to_serial(parallel, serial))
    assert got.dtype == np.int64
    np.testing.assert_allclose(parallel[got], serial, atol=1e-2)
    moved = serial.copy()
    moved[3] += 1.0
    for mod in (tpost, jpost):
        with pytest.raises(ValueError, match="do not match"):
            mod.dofs_to_serial(parallel, moved)


def test_load_results_on_a_port_run(run_dir):
    rdir, md = run_dir
    got, ref = tpost.load_results(rdir), jpost.load_results(rdir)
    assert set(got) == set(ref) == {"t", "nodes_x", "nodes_y", "N", "b",
                                    "qx", "qy"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["N"].shape == (2, md.x.size) and np.isfinite(got["N"]).all()
    assert tpost.load_results(os.path.dirname(rdir)) == {}


def test_render_frames(run_dir, tmp_path):
    pytest.importorskip("matplotlib")
    rdir, md = run_dir
    res = tpost.load_results(rdir)
    lake = md.x < np.median(md.x)
    kw = dict(lake_outline=np.array([[0.0, 0.0], [5e3, 0.0], [5e3, 5e3]]),
              lake_mask=lake, storage_on=True,
              outflow_mask=np.zeros(md.x.size, bool), cells=md.cells)
    got = tpost.render_frames(res, str(tmp_path / "t"), **kw)
    ref = jpost.render_frames(res, str(tmp_path / "j"), **kw)
    assert got == ref == {"frames": 2, "panels": 6}
    pngs = [sorted(f for f in os.listdir(tmp_path / d) if f.endswith(".png"))
            for d in ("t", "j")]
    assert pngs[0] == pngs[1] and len(pngs[0]) == 2
