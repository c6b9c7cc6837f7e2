"""The block-ELL operator's structural view (fem/bell.structural_view) and the
fused operator (ops/spmv_cuda.bell_operator_fn) on the CPU, on the slab
12x12, lake 16x16 and Cook_E2 bench meshes, in float64:

- the mirror twin over the view (what the CUDA kernel computes, operation
  for operation) equals the dense block-ELL product (rtol 1e-13: the two
  sum the same nonzero terms, in another order);
- the fold writes nothing outside the view, and W is 10 on the bench mesh;
- the fused operator's plain path equals shakti_tpu's operator_from_values
  plus extra * x, and is bitwise the composition it replaced.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.mesh.mesh import build_mesh as jbuild
from shakti_tpu.physics import residual as jres
from shakti_tpu_torch.fem import bell as tbell
from shakti_tpu_torch.ops import spmv_cuda as spmv
from shakti_tpu_torch.physics import residual as tres
from shakti_tpu_torch.setups import setup_bench, setup_lake, setup_slab
from tests.torch_parity import rel_err

SETUPS = {"slab": lambda: setup_slab.initialize(nx=12, ny=12),
          "lake": lambda: setup_lake.initialize(nx=16, ny=16),
          "bench": lambda: setup_bench.initialize(days=2)}


@pytest.fixture(scope="module", params=sorted(SETUPS))
def frozen(request):
    md = SETUPS[request.param]()
    md.dtype = torch.float64
    mesh, static, _, _ = md.freeze("cpu")
    return request.param, mesh, static.dirichlet


def _inputs(mesh, dirichlet, seed):
    rng = np.random.default_rng(seed)
    J = torch.as_tensor(rng.standard_normal((mesh.n_cells, 3, 3)))
    vals = tbell.bell_from_elements(J, mesh)
    x = torch.as_tensor(rng.standard_normal(mesh.n_nodes))
    extra = torch.where(dirichlet, 0.0,
                        torch.as_tensor(rng.random(mesh.n_nodes)))
    return vals, x, extra


def test_view_shape_and_row_counts(frozen):
    name, mesh, _ = frozen
    pos = mesh.bell_nz_pos
    col = spmv.view_columns(pos, mesh.bell_nbr, mesh.bell_B)
    W, n = pos.shape
    assert pos.dtype == torch.int32 and n == mesh.n_nodes
    counts = (pos >= 0).sum(0)
    assert int(counts.max()) == W <= spmv.W_MAX
    # every row holds its diagonal; padding sits after the entries
    assert int(counts.min()) >= 1
    valid = pos >= 0
    assert torch.equal(valid, torch.arange(W)[:, None] < counts[None, :])
    assert torch.equal(col[~valid], torch.arange(n).expand(W, n)[~valid])
    if name == "bench":
        assert W == 10 and int(valid.sum()) == 84_788


def test_fold_writes_only_the_view(frozen):
    _, mesh, dirichlet = frozen
    pos = mesh.bell_nz_pos
    valid = pos[pos >= 0].long()
    assert torch.equal(torch.sort(valid).values, mesh.bell_fold_slots)
    vals, _, _ = _inputs(mesh, dirichlet, 3)
    outside = vals.reshape(-1).clone()
    outside[valid] = 0.0
    assert int(torch.count_nonzero(outside)) == 0
    # row and column of every entry, against the flat position's meaning
    NB, KB = mesh.bell_nbr.shape
    B = mesh.bell_B
    r, rest = valid // (KB * B * B), valid % (KB * B * B)
    k, i, j = rest // (B * B), (rest // B) % B, rest % B
    rows = torch.arange(mesh.n_nodes).expand_as(pos)[pos >= 0]
    assert torch.equal(r * B + i, rows)
    cols = spmv.view_columns(pos, mesh.bell_nbr, B)[pos >= 0]
    assert torch.equal(mesh.bell_nbr[r, k] * B + j, cols)
    # the (row, column) pairs are exactly the mesh's vertex pairs per cell
    c = mesh.cells
    pairs = torch.stack([c[:, :, None].expand(-1, 3, 3).reshape(-1),
                         c[:, None, :].expand(-1, 3, 3).reshape(-1)])
    n = mesh.n_nodes
    assert torch.equal(torch.unique(pairs[0] * n + pairs[1]),
                       torch.sort(rows * n + cols).values)


@pytest.mark.parametrize("epilogue", [False, True])
def test_mirror_twin_matches_dense_f64(frozen, epilogue):
    _, mesh, dirichlet = frozen
    vals, x, extra = _inputs(mesh, dirichlet, 5)
    d, e = (dirichlet, extra) if epilogue else (None, None)
    ref = spmv.bell_operator_plain(vals, mesh, x, d, e)
    got = spmv.bell_operator_structural(vals, mesh, x, d, e)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-13,
                               atol=1e-13 * ref.abs().max().item())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_operator_matches_jax(frozen, seed):
    """Random Dirichlet masks and increments: the port's operator equals
    shakti_tpu's operator_from_values(x) + extra * x."""
    _, mesh, _ = frozen
    rng = np.random.default_rng(100 + seed)
    dmask = rng.random(mesh.n_nodes) < 0.2
    d = torch.as_tensor(dmask)
    vals, x, extra = _inputs(mesh, d, seed)
    jm = jbuild(mesh.nodes.numpy(), mesh.cells.numpy().astype(np.int32),
                dtype=jnp.float64, operator="bell", bell_block=mesh.bell_B)
    assert np.array_equal(np.asarray(jm.bell_nbr), mesh.bell_nbr.numpy())
    jv, jx, je = (jnp.asarray(t.numpy()) for t in (vals, x, extra))
    ref = jres.operator_from_values(jv, jm, jnp.asarray(dmask))(jx) + je * jx
    got = tres.operator_from_values(vals, mesh, d, extra)(x)
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-13


def test_fused_operator_is_bitwise_the_old_composition(frozen):
    """On the CPU the fused operator computes exactly the composition it
    replaced: where, the dense product, where, then + extra * x."""
    _, mesh, dirichlet = frozen
    vals, x, extra = _inputs(mesh, dirichlet, 7)
    xf = torch.where(dirichlet, 0.0, x)
    y = spmv.bell_matvec_plain(vals, mesh.bell_nbr, xf, mesh.n_nodes)
    old = torch.where(dirichlet, x, y) + extra * x
    new = tres.operator_from_values(vals, mesh, dirichlet, extra)(x)
    assert torch.equal(new, old)
    assert torch.equal(new.view(torch.int64), old.view(torch.int64))


def test_view_rejects_rows_beyond_the_kernel_maximum():
    # one row (node 0) with W_MAX + 1 entries in block 0
    B, W = 32, spmv.W_MAX + 1
    nbr = np.zeros((1, 1), np.int64)
    slots = np.arange(W)
    with pytest.raises(ValueError, match="structural entries"):
        tbell.structural_view(nbr, slots, B, B)
    assert tbell.structural_view(nbr, slots[:-1], B, B).shape == (W - 1, B)


def test_view_rejects_int32_overflow():
    B = 128
    nbr = np.zeros((1024, 1024), np.int64)
    with pytest.raises(ValueError, match="int32"):
        tbell.structural_view(nbr, np.arange(3), 1024 * B, B)
