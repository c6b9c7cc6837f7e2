"""The port's copies of shakti_tpu's numpy host modules against the originals,
on the slab 12x12, lake 16x16 and Cook_E2 bench meshes: mesh generation and
.msh reading, RCB ordering, boundary and Dirichlet location, the lake's
point-in-polygon mask, gridded interpolation and the quadrature tables.
The originals may take their native library's path here; the copies keep
the numpy path only, so integer results must be equal and interpolated
values agree to roundoff (1e-14 of scale)."""

import os

import numpy as np
import pytest

from shakti_tpu.data import interp as jinterp
from shakti_tpu.fem import p1 as jp1
from shakti_tpu.mesh import generate as jgen
from shakti_tpu.mesh import geometry as jgeo
from shakti_tpu.mesh import msh_io as jmsh
from shakti_tpu.parallel import partition as jpart
from shakti_tpu.params import DEFAULT_PARAMS as JP
from shakti_tpu_torch import params as tparams
from shakti_tpu_torch.data import interp as tinterp
from shakti_tpu_torch.fem import p1 as tp1
from shakti_tpu_torch.mesh import generate as tgen
from shakti_tpu_torch.mesh import geometry as tgeo
from shakti_tpu_torch.mesh import msh_io as tmsh
from shakti_tpu_torch.parallel import partition as tpart

BENCH_MSH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "cooke2_synth", "Cook_E2_mesh.msh")

# the setups' own arguments (setup_slab nx=ny=12, setup_lake nx=ny=16)
RECT = {"slab": ((12, 12, 10e3, 10e3), {}),
        "lake": ((16, 16, 40e3, 40e3), {"jitter": 0.2, "seed": 0})}
MESHES = ["slab", "lake", "bench"]


def _mesh(name):
    if name == "bench":
        return jmsh.read_msh(BENCH_MSH)
    args, kw = RECT[name]
    return jgen.rectangle_mesh(*args, **kw)


@pytest.mark.parametrize("name", ["slab", "lake"])
@pytest.mark.parametrize("diagonal", ["alternating", "right"])
def test_rectangle_mesh(name, diagonal):
    args, kw = RECT[name]
    jn, jc = jgen.rectangle_mesh(*args, diagonal=diagonal, **kw)
    tn, tc = tgen.rectangle_mesh(*args, diagonal=diagonal, **kw)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    assert tc.dtype == jc.dtype


def test_read_msh_bench():
    jn, jc = jmsh.read_msh(BENCH_MSH)
    tn, tc = tmsh.read_msh(BENCH_MSH)
    assert tn.shape == (12270, 2) and tc.shape == (23990, 3)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("name", ["slab", "lake"])
@pytest.mark.parametrize("binary", [False, True])
def test_read_msh_written(name, binary, tmp_path):
    """MSH 4.1 files written by shakti_tpu's writer, ASCII and binary."""
    nodes, cells = _mesh(name)
    path = str(tmp_path / f"{name}.msh")
    jmsh.write_msh(path, nodes, cells, binary=binary)
    tn, tc = tmsh.read_msh(path)
    jn, jc = jmsh.read_msh(path)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tc, cells)


@pytest.mark.parametrize("name", MESHES)
def test_rcb_order(name):
    nodes, _ = _mesh(name)
    perm = tpart.rcb_order(nodes)
    np.testing.assert_array_equal(perm, jpart.rcb_order(nodes))
    assert np.array_equal(np.sort(perm), np.arange(nodes.shape[0]))


@pytest.mark.parametrize("name", MESHES)
def test_boundary_and_dirichlet(name):
    nodes, cells = _mesh(name)
    tb, jb = tgeo.boundary_edges(cells), jgeo.boundary_edges(cells)
    assert {tuple(sorted(e)) for e in tb} == {tuple(sorted(e)) for e in jb}
    x0, lx = nodes[:, 0].min(), np.ptp(nodes[:, 0])

    def pred(p):
        return p[:, 0] < x0 + 0.02 * lx + 1e-9

    tnodes = tgeo.locate_boundary_nodes(nodes, cells, pred)
    np.testing.assert_array_equal(tnodes,
                                  jgeo.locate_boundary_nodes(nodes, cells, pred))
    assert tnodes.size > 0
    np.testing.assert_array_equal(tgeo.dirichlet_mask(nodes.shape[0], tnodes),
                                  jgeo.dirichlet_mask(nodes.shape[0], tnodes))


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("rings", [1, 2])
def test_points_in_polygon(name, rings):
    """A circle (the lake setup's outline) and a NaN-delimited two-ring
    outline with a repeated closing vertex."""
    nodes, _ = _mesh(name)
    c = nodes.mean(axis=0)
    r = 0.2 * np.ptp(nodes, axis=0)
    th = np.linspace(0, 2 * np.pi, 121)
    ring = np.column_stack([c[0] + r[0] * np.cos(th), c[1] + r[1] * np.sin(th)])
    poly = ring
    if rings == 2:
        poly = np.vstack([ring, [[np.nan, np.nan]], ring * 0.5 + 0.5 * nodes.min(0)])
    got = tgeo.points_in_polygon(nodes, poly)
    np.testing.assert_array_equal(got, jgeo.points_in_polygon(nodes, poly))
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("name", MESHES)
def test_grid_interpolator(name):
    """A seeded grid with a descending y axis, cropped like
    ModelSetup.interp_data, evaluated at the mesh nodes (some outside the
    crop, where both clamp)."""
    nodes, _ = _mesh(name)
    rng = np.random.default_rng(3)
    lo, hi = nodes.min(0), nodes.max(0)
    span = hi - lo
    x = np.sort(rng.uniform(lo[0] - 0.1 * span[0], hi[0] + 0.1 * span[0], 40))
    y = np.sort(rng.uniform(lo[1] - 0.1 * span[1], hi[1] + 0.1 * span[1], 30))[::-1]
    f = rng.standard_normal((30, 40))
    bounds = [lo[0] + 0.05 * span[0], hi[0], lo[1], hi[1] - 0.05 * span[1]]
    tx, ty, tf = tinterp.subset_grid(x, y, f, bounds)
    jx, jy, jf = jinterp.subset_grid(x, y, f, bounds)
    for a, b in ((tx, jx), (ty, jy), (tf, jf)):
        np.testing.assert_array_equal(a, b)
    got = tinterp.GridInterpolator(tx, ty, tf)(nodes[:, 0], nodes[:, 1])
    ref = jinterp.GridInterpolator(jx, jy, jf)(nodes[:, 0], nodes[:, 1])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14 * np.abs(ref).max())


def test_grid_interpolator_rejects_bad_shape():
    with pytest.raises(ValueError):
        tinterp.GridInterpolator(np.arange(3.0), np.arange(4.0), np.zeros((3, 4)))


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_quadrature(degree):
    tphi, tw = tp1.quadrature(degree)
    jphi, jw = jp1.quadrature(degree)
    np.testing.assert_array_equal(tphi, jphi)
    np.testing.assert_array_equal(tw, jw)


def test_params():
    assert tparams.DEFAULT_PARAMS.replace(g=1.0) == tparams.PhysicalParams(g=1.0)
    assert (vars(tparams.DEFAULT_PARAMS) == vars(JP))
