"""The port's geo-data readers (data/netcdf.py, data/lakes.py) and its
setup_cooke2 on real-format data, against shakti_tpu's, on tiny fixture
files built as tests/test_ingest.py builds them (netCDF-4 = HDF5, written
with h5py): every array bitwise equal, every contract violation the same
exception; setup_cooke2's nodal fields equal to 1e-14 of scale and its
6-step float64 run to 1e-8 with equal Newton counts.  Unlike the JAX
setup, the port's raises when a grid file exists and no netCDF backend
imports."""

import os
import sys

import numpy as np
import pytest
import torch

import setups.setup_cooke2 as jck2
from shakti_tpu.data import lakes as jlakes
from shakti_tpu.data import netcdf as jnc
from shakti_tpu.mesh.generate import rectangle_mesh
from shakti_tpu_torch.data import lakes as tlakes
from shakti_tpu_torch.data import netcdf as tnc
from shakti_tpu_torch.mesh.msh_io import write_msh
from shakti_tpu_torch.setups import setup_cooke2 as tck2
from tests import torch_parity  # noqa: F401  (pins torch's threads)
from tests.torch_parity import rel_err

h5py = pytest.importorskip("h5py")

LX = LY = 100e3
GRID_ENV = ("SHAKTI_BEDMACHINE", "SHAKTI_ATL14", "SHAKTI_AQ1")


def _write_h5(path, var, xvar, yvar, x, y, f, attrs=None, dtype=np.float64):
    with h5py.File(path, "w") as h5:
        h5.create_dataset(xvar, data=np.asarray(x, np.float64))
        h5.create_dataset(yvar, data=np.asarray(y, np.float64))
        ds = h5.create_dataset(var, data=np.asarray(f, dtype))
        for k, v in (attrs or {}).items():
            ds.attrs[k] = v
    return str(path)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """tests/test_ingest.py:data_dir's files: BedMachine (y descending),
    ATL14, AQ1 in mW/m^2, a Siegfried & Fricker-style outline HDF5 and a
    16 x 16 gmsh mesh."""
    d = tmp_path_factory.mktemp("ingest")
    gx = np.linspace(-0.2 * LX, 1.2 * LX, 60)
    gy = np.linspace(-0.2 * LY, 1.2 * LY, 55)
    X, Y = np.meshgrid(gx, gy)
    r2 = ((X - 0.55 * LX) ** 2 + (Y - 0.5 * LY) ** 2) / (12e3) ** 2
    bed = -400.0 + 0.004 * X + 0.002 * Y - 120.0 * np.exp(-r2)
    surf = bed + 1500.0 - 0.006 * X
    ghf_mw = 55.0 + 10.0 * np.sin(X / 3e4) * np.cos(Y / 4e4)
    paths = {
        "bm": _write_h5(d / "bedmachine.nc", "bed", "x", "y", gx, gy[::-1],
                        np.flipud(bed)),
        "atl": _write_h5(d / "atl14.nc", "h", "x", "y", gx, gy, surf),
        "aq1": _write_h5(d / "aq1.nc", "Q", "X", "Y", gx, gy, ghf_mw),
        "aq1_w": _write_h5(d / "aq1_w.nc", "Q", "X", "Y", gx, gy,
                           ghf_mw * 1e-3),
    }
    th = np.linspace(0, 2 * np.pi, 37)
    ox = 0.55 * LX + 11e3 * np.cos(th)
    oy = 0.5 * LY + 9e3 * np.sin(th)
    paths["lakes"] = str(d / "outlines.h5")
    with h5py.File(paths["lakes"], "w") as h5:
        for name, scale in (("Cook_E2", 1.0), ("Other_Lake", 0.3)):
            g = h5.create_group(name)
            g.create_dataset("x", data=(ox * scale)[None, :])
            g.create_dataset("y", data=(oy * scale)[None, :])
            g.attrs["citation"] = np.array([b"Siegfried & Fricker (2018)"])
    nodes, cells = rectangle_mesh(16, 16, LX, LY, jitter=0.2, seed=3)
    (d / "meshes").mkdir()
    write_msh(str(d / "meshes" / "Cook_E2_mesh.msh"), nodes, cells)
    paths["mesh_dir"] = str(d / "meshes")
    paths["dir"] = d
    return paths


def _same(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("reader,key", [("read_bedmachine", "bm"),
                                        ("read_atl14", "atl"),
                                        ("read_aq1", "aq1"),
                                        ("read_aq1", "aq1_w")])
def test_dataset_readers(data_dir, reader, key):
    got = getattr(tnc, reader)(data_dir[key])
    _same(got, getattr(jnc, reader)(data_dir[key]))
    assert np.all(np.diff(got[1]) > 0) and np.all(np.diff(got[0]) > 0)
    if reader == "read_aq1":
        assert 0.04 < np.median(got[2]) < 0.08


def _grid_case(tmp_path, case):
    """A read_grid input: (path, kwargs) for each layout the reader fixes."""
    x = np.linspace(0, 10e3, 7)
    y = np.linspace(0, 5e3, 5)
    f = np.add.outer(y, 3.0 * x)
    p = tmp_path / f"{case}.nc"
    if case == "transposed":
        return _write_h5(p, "bed", "x", "y", x, y, f.T), {}
    if case == "descending_x":
        return _write_h5(p, "bed", "x", "y", x[::-1], y, f[:, ::-1]), {}
    if case == "descending_y_kept":
        return (_write_h5(p, "bed", "x", "y", x, y[::-1], f[::-1]),
                {"flip_y": "never"})
    if case == "cf_packed":
        raw = np.round(f / 0.5).astype(np.int16) - 100
        raw[1, 2] = -32767
        return _write_h5(p, "bed", "x", "y", x, y, raw, dtype=np.int16,
                         attrs={"_FillValue": np.int16(-32767),
                                "scale_factor": 0.5, "add_offset": 50.0}), {}
    if case == "missing_value":
        g = f.copy()
        g[0, 0] = -9999.0
        return _write_h5(p, "bed", "x", "y", x, y, g,
                         attrs={"missing_value": -9999.0}), {}
    raise ValueError(case)


@pytest.mark.parametrize("case", ["transposed", "descending_x",
                                  "descending_y_kept", "cf_packed",
                                  "missing_value"])
def test_read_grid_layouts(tmp_path, case):
    path, kw = _grid_case(tmp_path, case)
    got = tnc.read_grid(path, "bed", **kw)
    _same(got, jnc.read_grid(path, "bed", **kw))
    if case in ("cf_packed", "missing_value"):
        assert np.isnan(got[2]).sum() == 1


def _bad_case(tmp_path, case):
    """tests/test_ingest.py:148-204's contract violations, and two more."""
    x = np.linspace(0, 10e3, 8)
    y = np.linspace(0, 10e3, 6)
    p = tmp_path / f"{case}.nc"
    reader = "read_grid"
    if case == "shape_mismatch":
        _write_h5(p, "bed", "x", "y", x, y, np.zeros((9, 9)))
    elif case == "3d":
        _write_h5(p, "bed", "x", "y", x, y, np.zeros((2, 6, 8)))
    elif case == "bedmachine_units":
        _write_h5(p, "bed", "x", "y", x, y, np.full((6, 8), 123456.0))
        reader = "read_bedmachine"
    elif case == "aq1_units":
        _write_h5(p, "Q", "X", "Y", x, y, np.full((6, 8), 5e4))
        reader = "read_aq1"
    elif case == "aq1_no_finite":
        _write_h5(p, "Q", "X", "Y", x, y, np.full((6, 8), np.nan))
        reader = "read_aq1"
    elif case == "nonmonotonic":
        _write_h5(p, "bed", "x", "y", np.array([0.0, 2, 1, 3, 4, 5, 6, 7]),
                  y, np.zeros((6, 8)))
    elif case == "short_axis":
        _write_h5(p, "bed", "x", "y", x[:1], y, np.zeros((6, 1)))
    elif case == "atl14_no_finite":
        _write_h5(p, "h", "x", "y", x, y, np.full((6, 8), np.nan))
        reader = "read_atl14"
    return str(p), reader


@pytest.mark.parametrize("case", ["shape_mismatch", "3d", "bedmachine_units",
                                  "aq1_units", "aq1_no_finite", "nonmonotonic",
                                  "short_axis", "atl14_no_finite"])
def test_read_grid_contracts(tmp_path, case):
    path, reader = _bad_case(tmp_path, case)
    args = (path, "bed") if reader == "read_grid" else (path,)
    with pytest.raises(Exception) as ref:
        getattr(jnc, reader)(*args)
    with pytest.raises(type(ref.value)) as got:
        getattr(tnc, reader)(*args)
    assert type(got.value) is type(ref.value) is ValueError
    assert str(got.value) == str(ref.value)


# ----------------------------------------------------------------- inventory

def _same_inventory(got, ref):
    assert list(got) == list(ref)
    for name in ref:
        assert got[name]["outline"].tobytes() == ref[name]["outline"].tobytes()
        assert got[name]["area_km2"] == ref[name]["area_km2"]
        assert got[name]["cite"] == ref[name]["cite"]


@pytest.mark.parametrize("geodesic", [False, True])
def test_load_inventory_hdf5(data_dir, geodesic):
    """geodesic=True needs pyproj: without it both keep the planar area."""
    got = tlakes.load_inventory_hdf5(data_dir["lakes"], geodesic_areas=geodesic)
    _same_inventory(got, jlakes.load_inventory_hdf5(data_dir["lakes"],
                                                    geodesic_areas=geodesic))
    assert got["Cook_E2"]["outline"].shape == (37, 2)
    assert got["Cook_E2"]["area_km2"] == pytest.approx(np.pi * 99.0, rel=0.02)
    _same_inventory(tlakes.load_inventory(data_dir["lakes"]), got)


def test_inventory_npz_round_trip(data_dir, tmp_path):
    """Each package reads the other's npz; a ring split by a NaN row and a
    missing area (recomputed) survive."""
    inv = tlakes.load_inventory_hdf5(data_dir["lakes"])
    ring = inv["Other_Lake"]["outline"]
    inv["Split"] = {"outline": np.vstack([ring, [[np.nan, np.nan]],
                                          ring + 40.0])}
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tlakes.save_inventory_npz(tp, inv)
    jlakes.save_inventory_npz(jp, inv)
    for path in (tp, jp):
        got = tlakes.load_inventory(path)
        _same_inventory(got, jlakes.load_inventory(path))
    _same_inventory(tlakes.load_inventory_npz(jp), jlakes.load_inventory_npz(tp))
    assert tlakes.outline_m(got, "Split").tobytes() == \
        jlakes.outline_m(got, "Split").tobytes()


def test_load_inventory_dispatch_errors(monkeypatch, tmp_path):
    monkeypatch.delenv("SHAKTI_LAKE_INVENTORY", raising=False)
    for mod in (tlakes, jlakes):
        with pytest.raises(FileNotFoundError, match="SHAKTI_LAKE_INVENTORY"):
            mod.load_inventory()
        with pytest.raises(ValueError, match="unknown inventory format"):
            mod.load_inventory(str(tmp_path / "lakes.csv"))


# ------------------------------------------------------------- setup_cooke2

def _set_env(monkeypatch, data_dir):
    monkeypatch.setenv("SHAKTI_MESH_DIR", data_dir["mesh_dir"])
    monkeypatch.setenv("SHAKTI_LAKE_INVENTORY", data_dir["lakes"])
    for env, key in zip(GRID_ENV, ("bm", "atl", "aq1")):
        monkeypatch.setenv(env, data_dir[key])


def _log_rows(rdir):
    with open(os.path.join(rdir, "log.csv")) as f:
        return [r.split(",")[:4] for r in f.read().splitlines()]


def test_setup_cooke2_real_data_end_to_end(data_dir, monkeypatch, tmp_path):
    """tests/test_ingest.py:test_setup_cooke2_consumes_real_data_end_to_end
    in both packages: the nodal fields, the lake mask and the outflow
    Dirichlet nodes equal, then 6 float64 hourly steps on block-ELL."""
    _set_env(monkeypatch, data_dir)
    jmd = jck2.initialize(days=0.25, results_name=str(tmp_path / "jax"))
    tmd = tck2.initialize(days=0.25, results_name=str(tmp_path / "torch"))
    for k in ("z_b", "z_s", "G"):
        a, b = getattr(tmd, k), getattr(jmd, k)
        assert rel_err(a, b) <= 1e-14, k
    np.testing.assert_array_equal(tmd.lake_bdry, jmd.lake_bdry)
    np.testing.assert_array_equal(tmd.dirichlet_nodes(), jmd.dirichlet_nodes())
    # the fields came from the files, not the synthetic fallback
    from shakti_tpu_torch.data.interp import GridInterpolator
    for k, key in (("z_b", "bm"), ("G", "aq1")):
        reader = tnc.read_bedmachine if key == "bm" else tnc.read_aq1
        np.testing.assert_allclose(
            getattr(tmd, k), GridInterpolator(*reader(data_dir[key]))(
                tmd.x, tmd.y), rtol=1e-12)
    assert 0.01 < tmd.lake_bdry.mean() < 0.2 and tmd.dirichlet_nodes().size

    import jax.numpy as jnp
    from shakti_tpu.api.run import solve as jsolve
    jmd.dtype, jmd.operator = jnp.float64, "bell"
    tmd.dtype, tmd.device, tmd.operator = torch.float64, "cpu", "bell"
    jout = jsolve(jmd, progress=False)
    tout = tmd.solve(progress=False)
    assert tout["steps"] == jout["steps"] == 6
    assert tout["newton_iters_total"] == jout["newton_iters_total"]
    assert _log_rows(tmd.results_name) == _log_rows(jmd.results_name)
    for k in ("N", "b"):
        got = tmd.to_user_order(getattr(tout["state"], k))
        ref = jmd.to_user_order(np.asarray(getattr(jout["state"], k)))
        assert rel_err(got, ref) <= 1e-8, k


def test_setup_cooke2_synthetic_fallback_matches_jax(monkeypatch):
    """No dataset set: both packages build the same synthetic model."""
    for env in (*GRID_ENV, "SHAKTI_LAKE_INVENTORY", "SHAKTI_MESH_DIR",
                "SHAKTI_REFERENCE_BINIT"):
        monkeypatch.delenv(env, raising=False)
    jmd = jck2.initialize(days=0.25, results_name=None)
    tmd = tck2.initialize(days=0.25, results_name=None)
    for k in ("nodes", "cells", "lake_bdry", "b_init", "N_init", "timesteps"):
        np.testing.assert_array_equal(getattr(tmd, k), getattr(jmd, k), k)
    for k in ("z_b", "z_s", "G"):     # interpolated: equal to roundoff
        assert rel_err(getattr(tmd, k), getattr(jmd, k)) <= 1e-14, k
    np.testing.assert_array_equal(tmd.dirichlet_nodes(), jmd.dirichlet_nodes())


@pytest.mark.parametrize("env", GRID_ENV)
def test_setup_cooke2_raises_without_a_netcdf_backend(data_dir, monkeypatch,
                                                      env):
    """A grid file that exists with neither netCDF4 nor h5py importable:
    ImportError naming the variable, the file and both libraries (the JAX
    setup falls back to the synthetic fields there)."""
    _set_env(monkeypatch, data_dir)
    for other in GRID_ENV:
        if other != env:
            monkeypatch.delenv(other)
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "netCDF4", None)
    monkeypatch.delenv("SHAKTI_LAKE_INVENTORY")     # the .h5 needs h5py too
    with pytest.raises(ImportError) as e:
        tck2.initialize(days=0.25, results_name=None)
    msg = str(e.value)
    assert env in msg and os.environ[env] in msg
    assert "netCDF4" in msg and "h5py" in msg
    # a variable naming no file still takes the synthetic field
    monkeypatch.setenv(env, str(data_dir["dir"] / "absent.nc"))
    md = tck2.initialize(days=0.25, results_name=None)
    assert np.isfinite(md.z_b).all()
