"""shakti_tpu_torch.mesh and .fem.ops vs shakti_tpu: every Mesh field of
build_mesh(operator="bell") equals JAX's, and every ops function matches on
seeded inputs in float64 (rtol 1e-13)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.fem import ops as jops
from shakti_tpu.mesh.generate import rectangle_mesh
from shakti_tpu.mesh.mesh import build_mesh as jbuild
from shakti_tpu.parallel.partition import rcb_order
from shakti_tpu_torch.fem import ops as tops
from shakti_tpu_torch.mesh.mesh import build_mesh as tbuild
from tests.torch_parity import to_numpy

RTOL = 1e-13


def _meshes(nx=14, ny=12, B=128, seed=4):
    nodes, cells = rectangle_mesh(nx, ny, 3e3, 2e3, jitter=0.3, seed=seed)
    perm = rcb_order(nodes)
    iperm = np.argsort(perm)
    nodes, cells = nodes[perm], iperm[cells].astype(np.int32)
    jm = jbuild(nodes, cells, dtype=jnp.float64, operator="bell", bell_block=B)
    tm = tbuild(nodes, cells, dtype=torch.float64, bell_block=B)
    return jm, tm


@pytest.mark.parametrize("B", [32, 128])
def test_mesh_fields_equal_jax(B):
    jm, tm = _meshes(B=B)
    ref = to_numpy(jm)
    assert set(ref) == {"nodes", "cells", "area", "grads", "node_area",
                        "cell_valid", "inc_map", "bell_nbr", "bell_map",
                        "bell_diag_pos", "bell_B"}
    for k, v in ref.items():
        got = getattr(tm, k)
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        assert got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def _fields(rng, n, c):
    return {
        "f1": 1e6 + 1e3 * rng.normal(size=n), "fk": rng.normal(size=(n, 3)),
        "c3": rng.normal(size=(c, 3)), "c3k": rng.normal(size=(c, 3, 2)),
        "cc": rng.normal(size=c), "cck": rng.normal(size=(c, 2)),
    }


OPS = {
    "gather_cells": "f1", "cell_grad": "f1", "cell_grad_k": "fk",
    "scatter_add_cells": "c3", "scatter_add_cells_k": "c3k",
    "cell_to_node_avg": "cc", "cell_to_node_avg_k": "cck",
    "cellnodal_to_node_avg": "c3", "cellnodal_to_node_avg_k": "c3k",
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_ops_match_jax(name):
    jm, tm = _meshes()
    data = _fields(np.random.default_rng(1), tm.n_nodes, tm.n_cells)
    x = data[OPS[name]]
    fn = name.removesuffix("_k")
    ref = np.asarray(getattr(jops, fn)(jm, jnp.asarray(x)))
    got = getattr(tops, fn)(tm, torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("k", [None, 4])
def test_interpolate_at_quad_matches_jax(k):
    from shakti_tpu.fem.p1 import quadrature
    phi, _ = quadrature(4)
    rng = np.random.default_rng(2)
    fc = rng.normal(size=(50, 3) if k is None else (50, 3, k))
    ref = np.asarray(jops.interpolate_at_quad(jnp.asarray(phi), jnp.asarray(fc)))
    got = tops.interpolate_at_quad(torch.as_tensor(phi), torch.as_tensor(fc))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def test_cellnodal_avg_dead_slot_guard():
    """A node with zero node area averages to 0, not 0/0 = NaN."""
    import dataclasses
    _, tm = _meshes()
    na = tm.node_area.clone()
    na[0] = 0.0
    dead = dataclasses.replace(tm, node_area=na)
    v = torch.ones((tm.n_cells, 3), dtype=torch.float64)
    out = tops.cellnodal_to_node_avg(dead, v)
    assert out[0].item() == 0.0 and torch.isfinite(out).all()


def test_build_mesh_rejects_other_formats():
    """The four formats build; any other name raises."""
    nodes, cells = rectangle_mesh(3, 3, 1.0, 1.0)
    for op in ("bell", "ell", "bcsr", "cells"):
        tbuild(nodes, cells, operator=op, bell_block=8)
    with pytest.raises(ValueError, match="operator must be one of"):
        tbuild(nodes, cells, operator="csr")
