"""The port's copies of shakti_tpu's numpy host modules against the originals,
on the slab 12x12, lake 16x16 and Cook_E2 bench meshes: mesh generation,
.msh reading and writing, RCB ordering and partitioning (rcb_partition,
partition_cells, pad_to_blocks), the halo plan and its localize /
globalize maps, boundary and Dirichlet location, the lake's
point-in-polygon mask, gridded interpolation and the quadrature tables;
the ring disk mesh, the boundary node list, VERTEX_PHI, ModelSetup's
default dtype, and the public two-level constructor (its apply on the
12x12 slab in float64 within 1e-12 of JAX's).
The originals may take their native library's path here; the copies keep
the numpy path only, so integer results must be equal and interpolated
values agree to roundoff (1e-14 of scale)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.data import interp as jinterp
from shakti_tpu.fem import p1 as jp1
from shakti_tpu.mesh import generate as jgen
from shakti_tpu.mesh import geometry as jgeo
from shakti_tpu.mesh import msh_io as jmsh
from shakti_tpu.parallel import halo as jhalo
from shakti_tpu.parallel import partition as jpart
from shakti_tpu.mesh.mesh import build_mesh as jbuild
from shakti_tpu.params import DEFAULT_PARAMS as JP
from shakti_tpu.physics import residual as jres
from shakti_tpu.solve import precond as jpc
from shakti_tpu_torch import params as tparams
from shakti_tpu_torch.data import interp as tinterp
from shakti_tpu_torch.fem import p1 as tp1
from shakti_tpu_torch.mesh import generate as tgen
from shakti_tpu_torch.mesh import geometry as tgeo
from shakti_tpu_torch.mesh import msh_io as tmsh
from shakti_tpu_torch.parallel import halo as thalo
from shakti_tpu_torch.mesh.mesh import build_mesh as tbuild
from shakti_tpu_torch.parallel import partition as tpart
from shakti_tpu_torch.physics import residual as tres
from shakti_tpu_torch.solve import precond as tpc
from tests import torch_parity  # noqa: F401  (pins torch's threads)

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
    """MSH 4.1 files written by the port's writer, ASCII and binary."""
    nodes, cells = _mesh(name)
    path = str(tmp_path / f"{name}.msh")
    tmsh.write_msh(path, nodes, cells, binary=binary)
    tn, tc = tmsh.read_msh(path)
    jn, jc = jmsh.read_msh(path)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tc, cells)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("binary", [False, True])
def test_write_msh_byte_equal(name, binary, tmp_path):
    """Both packages' writers give the same bytes, ASCII and binary."""
    nodes, cells = _mesh(name)
    tp, jp = tmp_path / "t.msh", tmp_path / "j.msh"
    tmsh.write_msh(str(tp), nodes, cells, binary=binary)
    jmsh.write_msh(str(jp), nodes, cells, binary=binary)
    assert tp.read_bytes() == jp.read_bytes()


@pytest.mark.parametrize("name", MESHES)
def test_rcb_order(name):
    nodes, _ = _mesh(name)
    perm = tpart.rcb_order(nodes)
    np.testing.assert_array_equal(perm, jpart.rcb_order(nodes))
    assert np.array_equal(np.sort(perm), np.arange(nodes.shape[0]))


@pytest.mark.parametrize("rings", [1, 2, 3, 7])
def test_disk_mesh(rings):
    tn, tc = tgen.disk_mesh(rings, radius=5e3, center=(1e3, -2e3))
    jn, jc = jgen.disk_mesh(rings, radius=5e3, center=(1e3, -2e3))
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    assert tc.dtype == jc.dtype and tn.shape[0] == 1 + 3 * rings * (rings + 1)


@pytest.mark.parametrize("name", MESHES + ["disk"])
def test_boundary_nodes(name):
    nodes, cells = (jgen.disk_mesh(4) if name == "disk" else _mesh(name))
    got = tgeo.boundary_nodes(cells)
    np.testing.assert_array_equal(got, jgeo.boundary_nodes(cells))
    if name == "disk":       # the outer ring: its 24 nodes, last in order
        np.testing.assert_array_equal(got, np.arange(nodes.shape[0] - 24,
                                                     nodes.shape[0]))


def test_vertex_phi_and_default_dtype():
    from shakti_tpu_torch.api import model as tmodel
    np.testing.assert_array_equal(tp1.VERTEX_PHI, jp1.VERTEX_PHI)
    assert tp1.VERTEX_PHI.dtype == jp1.VERTEX_PHI.dtype
    assert tmodel.default_dtype() is torch.float32
    nodes, cells = _mesh("slab")
    assert tmodel.ModelSetup(nodes, cells).dtype is tmodel.default_dtype()


@pytest.mark.parametrize("with_vals", [True, False])
def test_make_two_level_matches_jax(with_vals):
    """The apply z = D^-1 r + P A_c^-1 P^T r on the 12x12 slab (ELL, float64,
    aggregates of 16): from the values folded as Newton folds them and from
    the element blocks (symmetric and definite, as at a Newton iterate)."""
    nodes, cells = _mesh("slab")
    n = nodes.shape[0]
    jm = jbuild(nodes, cells, dtype=jnp.float64, operator="ell")
    tm = tbuild(nodes, cells, dtype=torch.float64, operator="ell")
    rng = np.random.default_rng(11)
    M = rng.normal(size=(cells.shape[0], 3, 3))
    J = -(M @ M.transpose(0, 2, 1) + np.eye(3))
    d = np.zeros(n, dtype=bool)
    d[tgeo.boundary_nodes(cells)[::3]] = True
    r = rng.normal(size=n)
    jv = jres.fold_operator_values(jnp.asarray(J), jm)
    tv = tres.fold_operator_values(torch.as_tensor(J), tm)
    ja = jres.operator_diag_from_values(jv, jm)
    ta = tres.operator_diag_from_values(tv, tm)
    ref = jpc.make_two_level(jnp.asarray(J), jm, jnp.asarray(d), ja, 16,
                             vals=jv if with_vals else None)(jnp.asarray(r))
    got = tpc.make_two_level(torch.as_tensor(J), tm, torch.as_tensor(d), ta,
                             16, vals=tv if with_vals else None)(
        torch.as_tensor(r))
    err = float(np.abs(got.numpy() - np.asarray(ref)).max()
                / np.abs(np.asarray(ref)).max())
    assert err <= 1e-12, err


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


def _valley_outline():
    """The SHMIP valley footprint (setups/setup_shmip.valley_outline's shape,
    built here so that the test needs neither setup)."""
    x = np.linspace(0.0, 0.985 * 6e3, 80)
    w = np.maximum(40.0 + 900.0 * np.sqrt(x / 6e3) * (1.0 - x / 6e3), 40.0)
    return np.vstack([np.column_stack([x, w]),
                      np.column_stack([x[::-1], -w[::-1]])])


@pytest.mark.parametrize("outline,resolution,kw", [
    ("valley", 75.0, {"jitter": 0.2, "seed": 0}),
    ("valley", 150.0, {}),
    ("closed square", 0.1, {"margin": 0.3, "jitter": 0.1, "seed": 4})])
def test_polygon_mesh(outline, resolution, kw):
    """Delaunay meshes of a polygon's interior (the SHMIP valley suites'
    mesher): a jittered and a plain lattice, and a unit square given with its
    closing vertex repeated; nodes and cells equal."""
    poly = (_valley_outline() if outline == "valley" else
            np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0, 0]], float))
    jn, jc = jgen.polygon_mesh(poly, resolution, **kw)
    tn, tc = tgen.polygon_mesh(poly, resolution, **kw)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    assert tc.dtype == jc.dtype and tc.shape[0] > 50


def test_min_dist2_chunked():
    """The chunked nearest-boundary distance (polygon_mesh's path for large
    lattices), with a chunk that does not divide the points."""
    rng = np.random.default_rng(5)
    grid, bpts = rng.standard_normal((1000, 2)), rng.standard_normal((70, 2))
    got = tgen._min_dist2_chunked(grid, bpts, chunk=96)
    np.testing.assert_array_equal(got, jgen._min_dist2_chunked(grid, bpts,
                                                               chunk=96))
    np.testing.assert_allclose(
        got, ((grid[:, None] - bpts[None]) ** 2).sum(-1).min(1), rtol=1e-15)


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


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("parts", [2, 3, 8])
def test_rcb_partition_and_cells(name, parts):
    nodes, cells = _mesh(name)
    np.testing.assert_array_equal(tpart.rcb_partition(nodes, parts),
                                  jpart.rcb_partition(nodes, parts))
    order, counts = tpart.partition_cells(nodes, cells, parts)
    jorder, jcounts = jpart.partition_cells(nodes, cells, parts)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(counts, jcounts)
    for a, b in zip(tpart.pad_to_blocks(order, counts),
                    jpart.pad_to_blocks(jorder, jcounts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("parts", [2, 4, 8])
def test_build_halo_and_localize(name, parts):
    nodes, cells = _mesh(name)
    order = jpart.rcb_order(nodes)
    cells = np.argsort(order)[cells].astype(np.int32)
    n = nodes.shape[0]
    plan, jplan = thalo.build_halo(n, cells, parts), jhalo.build_halo(
        n, cells, parts)
    assert plan.keys() == jplan.keys()
    for k in plan:
        np.testing.assert_array_equal(plan[k], jplan[k], err_msg=k)
    f = np.random.default_rng(0).normal(size=(n, 2))
    loc = thalo.localize_nodal(plan, f)
    np.testing.assert_array_equal(loc, jhalo.localize_nodal(jplan, f))
    for p in range(parts):
        np.testing.assert_array_equal(thalo.localize_rank(plan, f, p), loc[p])
    np.testing.assert_array_equal(thalo.globalize_nodal(plan, loc),
                                  jhalo.globalize_nodal(jplan, loc))
    np.testing.assert_array_equal(thalo.globalize_nodal(plan, loc), f)
