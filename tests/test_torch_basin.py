"""The port's drainage-basin pipeline (mesh/basin.py) and GeoTIFF adapter
(data/geotiff.py) against shakti_tpu's, on tests/test_basin.py's two-valley
grid: integer outputs equal, float outputs bitwise equal, the basin mesh's
nodes and cells equal, GeoTIFF files byte-equal; and the Cook_E2 pipeline
of chip_smoke.py phase 18 (a), at its full 600 x 600 size, reproducing
assets/cooke2_synth."""

import numpy as np
import pytest

import chip_smoke
from shakti_tpu.data import geotiff as jtif
from shakti_tpu.mesh import basin as jb
from shakti_tpu_torch.data import geotiff as ttif
from shakti_tpu_torch.mesh import basin as tb
from tests import torch_parity  # noqa: F401  (pins torch's threads)


def _two_valley_grid(n=81):
    """tests/test_basin.py:_two_valley_grid: two catchments with point
    outlets at (0.25, 0) and (0.75, 0), divide at x = 0.5."""
    x = np.linspace(0.0, 1.0, n)
    y = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(x, y)
    phi = 2.0 * np.minimum(np.hypot(X - 0.25, Y), np.hypot(X - 0.75, Y))
    return x, y, phi, X, Y


@pytest.fixture(scope="module")
def grid():
    x, y, phi, X, Y = _two_valley_grid()
    carved = phi.copy()
    carved[30:38, 15:24] -= 5.0          # a closed depression to fill
    filled = jb.fill_sinks(carved)
    nxt = jb.d8_flow(filled, dx=x[1] - x[0], dy=y[1] - y[0])
    labels, _ = jb.drainage_basins(nxt)
    lake = np.hypot(X - 0.25, Y - 0.6) < 0.08
    return dict(x=x, y=y, phi=phi, X=X, Y=Y, carved=carved, filled=filled,
                nxt=nxt, labels=labels, lake=lake)


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("quantize", [None, 255])
def test_background_potential(grid, quantize):
    z_s = 900.0 + grid["phi"] * 50.0
    z_b = -100.0 + 20.0 * grid["X"]
    _bitwise(tb.background_potential(z_s, z_b, quantize=quantize),
             jb.background_potential(z_s, z_b, quantize=quantize))


@pytest.mark.parametrize("field", ["phi", "carved"])
def test_fill_sinks(grid, field):
    got = tb.fill_sinks(grid[field])
    _bitwise(got, jb.fill_sinks(grid[field]))
    assert (got >= grid[field]).all()


def test_fill_sinks_cap_warns_alike(grid):
    with pytest.warns(RuntimeWarning, match="fixpoint"):
        got = tb.fill_sinks(grid["carved"], max_iter=3)
    with pytest.warns(RuntimeWarning, match="fixpoint"):
        ref = jb.fill_sinks(grid["carved"], max_iter=3)
    _bitwise(got, ref)


@pytest.mark.parametrize("spacing", [(1.0, 1.0), (0.0125, 0.025)])
def test_d8_flow(grid, spacing):
    dx, dy = spacing
    _bitwise(tb.d8_flow(grid["filled"], dx=dx, dy=dy),
             jb.d8_flow(grid["filled"], dx=dx, dy=dy))


def test_flow_accumulation(grid):
    got = tb.flow_accumulation(grid["nxt"])
    _bitwise(got, jb.flow_accumulation(grid["nxt"]))
    assert got.max() > grid["phi"].size / 3


def test_drainage_basins(grid):
    tl, to = tb.drainage_basins(grid["nxt"])
    jl, jo = jb.drainage_basins(grid["nxt"])
    _bitwise(tl, jl)
    _bitwise(to, jo)
    assert to.size >= 2


def test_basin_labels_for_mask(grid):
    got = tb.basin_labels_for_mask(grid["labels"], grid["lake"])
    _bitwise(got, jb.basin_labels_for_mask(grid["labels"], grid["lake"]))
    empty = np.zeros_like(grid["lake"])
    for mod in (tb, jb):
        with pytest.raises(ValueError, match="no grid cells"):
            mod.basin_labels_for_mask(grid["labels"], empty)


def test_largest_component_and_boundary(grid):
    mask = np.isin(grid["labels"].reshape(grid["phi"].shape),
                   tb.basin_labels_for_mask(grid["labels"], grid["lake"])[:1])
    mask = mask.copy()
    mask[70:74, 70:74] = True               # a detached island to drop
    comp = tb._largest_component(mask)
    _bitwise(comp, jb._largest_component(mask))
    _bitwise(tb._trace_mask_boundary(comp, grid["x"], grid["y"]),
             jb._trace_mask_boundary(comp, grid["x"], grid["y"]))


@pytest.mark.parametrize("tol", [0.0, 0.02, 0.08])
def test_simplify_polygon(tol):
    t = np.linspace(0, 2 * np.pi, 400, endpoint=False)
    sq = np.column_stack([np.round(np.cos(t) * 20) / 20,
                          np.round(np.sin(t) * 20) / 20])
    _bitwise(tb.simplify_polygon(sq, tol), jb.simplify_polygon(sq, tol))


@pytest.mark.parametrize("lake_as", ["mask", "outline"])
@pytest.mark.parametrize("n_basins", [1, 2])
def test_basin_outline(grid, lake_as, n_basins):
    th = np.linspace(0, 2 * np.pi, 33)
    kw = ({"lake_mask": grid["lake"]} if lake_as == "mask" else
          {"lake_outline": np.column_stack([0.25 + 0.08 * np.cos(th),
                                            0.6 + 0.08 * np.sin(th)])})
    got = tb.basin_outline(grid["x"], grid["y"], grid["phi"],
                           n_basins=n_basins, **kw)
    _bitwise(got, jb.basin_outline(grid["x"], grid["y"], grid["phi"],
                                   n_basins=n_basins, **kw))
    assert got.shape[0] >= 3


def test_basin_outline_rejects_alike(grid):
    for mod in (tb, jb):
        with pytest.raises(ValueError, match="lake_mask or lake_outline"):
            mod.basin_outline(grid["x"], grid["y"], grid["phi"])
        with pytest.raises(ValueError, match="covers only"):
            mod.basin_outline(grid["x"], grid["y"], grid["phi"],
                              lake_mask=grid["lake"], min_area_cells=10 ** 6)


def test_basin_mesh(grid):
    L = 40e3
    args = (grid["x"] * L, grid["y"] * L, grid["phi"])
    tn, tc, to = tb.basin_mesh(*args, lake_mask=grid["lake"],
                               resolution=1500.0)
    jn, jc, jo = jb.basin_mesh(*args, lake_mask=grid["lake"],
                               resolution=1500.0)
    _bitwise(tn, jn)
    _bitwise(tc, jc)
    _bitwise(to, jo)
    assert tn.shape[0] > 100


# ------------------------------------------------------------------ GeoTIFF

def test_quantize_potential(grid):
    _bitwise(ttif.quantize_potential(grid["phi"]),
             jtif.quantize_potential(grid["phi"]))
    flat = np.full((3, 4), 7.0)
    _bitwise(ttif.quantize_potential(flat), jtif.quantize_potential(flat))


@pytest.mark.parametrize("dtype,epsg", [(np.uint8, 3031), (np.float32, None),
                                        (np.int32, 4326)])
def test_geotiff_write_read(grid, tmp_path, dtype, epsg):
    """Each package writes the same bytes; each reads either file to the
    same axes, values and metadata."""
    pytest.importorskip("PIL")
    data = (ttif.quantize_potential(grid["phi"]) if dtype == np.uint8
            else (grid["phi"] * 1e3).astype(dtype))[::-1]
    kw = dict(west=-1000.0, north=2000.0, dx=25.0, dy=12.5, epsg=epsg)
    tp, jp = tmp_path / "t.tif", tmp_path / "j.tif"
    ttif.write_geotiff(str(tp), data, **kw)
    jtif.write_geotiff(str(jp), data, **kw)
    assert tp.read_bytes() == jp.read_bytes()
    tx, ty, td, tm = ttif.read_geotiff(str(jp))
    jx, jy, jd, jm = jtif.read_geotiff(str(jp))
    for a, b in ((tx, jx), (ty, jy), (td, jd)):
        _bitwise(a, b)
    assert tm == jm and tm["epsg"] == epsg
    _bitwise(td, data)


def test_geotiff_rejects_alike(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(tmp_path / "p.tif")
    for mod in (ttif, jtif):
        with pytest.raises(ValueError, match="georeferencing"):
            mod.read_geotiff(str(tmp_path / "p.tif"))


# ------------------------------------------------- the Cook_E2 catchment mesh

def test_cooke2_pipeline_reproduces_the_committed_mesh(tmp_path):
    """chip_smoke.py phase 18 (a) on the CPU: the 600 x 600 potential ->
    basin outline -> scaled catchment -> polygon_mesh -> write_msh through
    the port, equal to assets/cooke2_synth (outline, lake and nodes
    bitwise, cells as a set of triangles)."""
    info = chip_smoke.cooke2_mesh(str(tmp_path))
    same, n, c = chip_smoke.same_mesh(str(tmp_path))
    assert same == {"outline.npy": True, "lake.npy": True, "nodes": True,
                    "cells": True}
    assert (n, c) == (12270, 23990) and info["basin_vertices"] > 100
