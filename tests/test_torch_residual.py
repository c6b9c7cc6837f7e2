"""shakti_tpu_torch.physics.residual (+ the block-ELL fold, diagonal and
coarse build) vs shakti_tpu on one seeded problem in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.fem import bell as jbell
from shakti_tpu.mesh.generate import rectangle_mesh
from shakti_tpu.mesh.mesh import build_mesh as jbuild
from shakti_tpu.params import DEFAULT_PARAMS as P
from shakti_tpu.parallel.partition import rcb_order
from shakti_tpu.physics import residual as jres
from shakti_tpu.solve import precond as jpc
from shakti_tpu.solve.timestep import make_static_fields as jstatic
from shakti_tpu_torch.fem import bell as tbell
from shakti_tpu_torch.mesh.mesh import build_mesh as tbuild
from shakti_tpu_torch.ops import spmv_cuda as spmv
from shakti_tpu_torch.physics import residual as tres
from shakti_tpu_torch.solve import precond as tpc
from shakti_tpu_torch.solve.timestep import make_static_fields as tstatic
from tests.torch_parity import rel_err, to_numpy


@pytest.fixture(scope="module")
def problem():
    nodes, cells = rectangle_mesh(16, 16, 4e3, 4e3, jitter=0.3, seed=3)
    perm = rcb_order(nodes)
    iperm = np.argsort(perm)
    nodes, cells = nodes[perm], iperm[cells].astype(np.int32)
    n = nodes.shape[0]
    rng = np.random.default_rng(11)
    dmask = nodes[:, 0] < 1.0
    sargs = (rng.normal(size=n), rng.normal(size=n) + 500, np.full(n, 0.05),
             1e-8 * np.abs(rng.normal(size=n)), (rng.random(n) < 0.3) * 1.0,
             dmask, 1e5, 1e-5, P)
    jm = jbuild(nodes, cells, dtype=jnp.float64, operator="bell", bell_block=128)
    tm = tbuild(nodes, cells, dtype=torch.float64, bell_block=128)
    js, ts = jstatic(jm, *sargs), tstatic(tm, *sargs)
    N_n = 1e5 + 1e4 * rng.normal(size=n)
    b = np.abs(1e-3 + 1e-4 * rng.normal(size=n))
    q = 1e-4 * rng.normal(size=(n, 2))
    q[::4] = 0.0
    melt = 1e-7 * np.abs(rng.normal(size=n))
    jpre = jax.jit(lambda m, s, *a: jres.precompute_step(
        m, *a, s, jnp.asarray(3600.0), P, quad_degree=4))(
        jm, js, *map(jnp.asarray, (N_n, b, q, melt)))
    tpre = tres.precompute_step(tm, *map(torch.as_tensor, (N_n, b, q, melt)), ts,
                                torch.tensor(3600.0, dtype=torch.float64), P,
                                quad_degree=4)
    Ns = np.stack([1e5 + 1e4 * rng.normal(size=n) for _ in range(3)], axis=1)
    # the JAX side runs jitted (eager dispatch would dominate the test time)
    J = np.asarray(jax.jit(lambda N, pre, m: jres.element_jacobian(N, pre, m, P))(
        jnp.asarray(Ns[:, 0]), jpre, jm))
    jv = jax.jit(jres.fold_operator_values)(jnp.asarray(J), jm)
    return dict(jm=jm, tm=tm, js=js, ts=ts, jpre=jpre, tpre=tpre, Ns=Ns,
                dmask=dmask, J=J, jv=jv)


def test_static_and_precompute_match_jax(problem):
    p = problem
    np.testing.assert_allclose(p["ts"].gb0.numpy(), np.asarray(p["js"].gb0),
                               rtol=1e-13, atol=1e-13 * np.abs(p["js"].gb0).max())
    ref = to_numpy(p["jpre"])
    for k, v in ref.items():
        assert rel_err(getattr(p["tpre"], k).numpy(), v) <= 1e-13, k


def test_residual_multi_matches_jax(problem):
    p = problem
    ref = np.asarray(jax.jit(
        lambda Ns, pre, m: jres.assemble_residual_multi(Ns, pre, m, P))(
        jnp.asarray(p["Ns"]), p["jpre"], p["jm"]))
    got = tres.assemble_residual_multi(torch.as_tensor(p["Ns"]), p["tpre"],
                                       p["tm"], P).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_residual_columns_bitexact_vs_single(problem):
    p = problem
    Ns = torch.as_tensor(p["Ns"])
    multi = tres.assemble_residual_multi(Ns, p["tpre"], p["tm"], P)
    for k in range(3):
        single = tres.assemble_residual(Ns[:, k], p["tpre"], p["tm"], P)
        assert torch.equal(multi[:, k], single), f"column {k}"


def test_element_jacobian_matches_jax(problem):
    p = problem
    ref = p["J"]
    got = tres.element_jacobian(torch.as_tensor(p["Ns"][:, 0]), p["tpre"],
                                p["tm"], P)
    assert got.shape == ref.shape == (p["tm"].n_cells, 3, 3)
    assert rel_err(got.numpy(), ref) <= 1e-10


def test_fold_and_diag_match_jax(problem):
    p = problem
    jv = p["jv"]
    tv = tres.fold_operator_values(torch.as_tensor(p["J"]), p["tm"])
    assert tv.shape == tres.operator_values_shape(p["tm"]) == jv.shape
    assert rel_err(tv.numpy(), np.asarray(jv)) <= 1e-12
    assert rel_err(tres.operator_diag_from_values(tv, p["tm"]).numpy(),
                   np.asarray(jres.operator_diag_from_values(jv, p["jm"]))) <= 1e-12
    # and the operator itself: Dirichlet-eliminated matvec
    x = np.random.default_rng(5).normal(size=p["tm"].n_nodes)
    d = torch.as_tensor(p["dmask"])
    y = tres.operator_from_values(tv, p["tm"], d)(torch.as_tensor(x))
    y_ref = jres.operator_from_values(jv, p["jm"], jnp.asarray(p["dmask"]))(
        jnp.asarray(x))
    assert rel_err(y.numpy(), np.asarray(y_ref)) <= 1e-12


def test_fold_is_deterministic_gather(problem):
    """The fold equals an exact (float64 np.add.at) segment sum."""
    tm = problem["tm"]
    J = np.random.default_rng(9).normal(size=(tm.n_cells, 3, 3))
    ref = np.zeros(int(np.prod(tres.operator_values_shape(tm))))
    np.add.at(ref, tm.bell_map.numpy(), J.reshape(-1))
    got = tbell.bell_from_elements(torch.as_tensor(J), tm).reshape(-1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("block", [32, 64, 128, 256])
def test_coarse_from_values_matches_jax(problem, block):
    """Both block-ELL branches: aggregates dividing the 128-wide blocks
    (sub-tiles) and multiples of them (whole blocks)."""
    p = problem
    tv = tres.fold_operator_values(torch.as_tensor(p["J"]), p["tm"])
    d = p["dmask"]
    ref = np.asarray(jax.jit(
        lambda v, m, dm: jpc.coarse_from_values(v, m, dm, block))(
        p["jv"], p["jm"], jnp.asarray(d)))
    got = tpc.coarse_from_values(tv, p["tm"], torch.as_tensor(d), block)
    assert got.shape == ref.shape
    # compare the coarse operators themselves (the inverse amplifies
    # summation-order roundoff by the coarse condition number)
    assert rel_err(np.linalg.inv(got.numpy()), np.linalg.inv(ref)) <= 1e-12
    # a second call reuses the cached plan and gives the identical result
    assert (id(p["tm"].bell_nbr), block, p["tm"].n_nodes) in tpc._PLANS
    assert torch.equal(tpc.coarse_from_values(tv, p["tm"], torch.as_tensor(d),
                                              block), got)


def test_bell_matvec_fold_roundtrip_vs_jax_bell(problem):
    """The operator wrapper without mask or increment: on CPU the plain
    block-ELL product, equal to shakti_tpu.fem.bell.bell_matvec."""
    tm = problem["tm"]
    rng = np.random.default_rng(6)
    J = rng.normal(size=(tm.n_cells, 3, 3))
    x = rng.normal(size=tm.n_nodes)
    tv = tbell.bell_from_elements(torch.as_tensor(J), tm)
    NB, KB = tm.bell_nbr.shape
    jv = jbell.bell_from_elements(jnp.asarray(J), problem["jm"].bell_map, NB, KB, 128)
    y = spmv.bell_operator(tv, tm, torch.as_tensor(x))
    y_ref = jbell.bell_matvec(jv, problem["jm"].bell_nbr, jnp.asarray(x), tm.n_nodes)
    assert rel_err(y.numpy(), np.asarray(y_ref)) <= 1e-13
