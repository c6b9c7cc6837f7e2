"""The ensemble's closed-form element residual and Jacobian
(shakti_tpu_torch/ops/element_cuda.py, the plain twin of
csrc/element_batched.cu) in float64 on the CPU, on the 8x8 slab with lake
storage on part of the nodes, the flux zero over part of the cells, two
padding cells and M = 3 members whose shared fields have member stride 0:

- the twin equals the forward-AD route it replaces in the batched Newton
  solve (vmap of physics/residual.element_jacobian, assemble_residual and
  assemble_residual_multi) and the JAX package's element_jacobian and
  assemble_residual, each to 1e-12 of the largest entry;
- a column of a 3-column call is bitwise a 1-column call; the node sum is
  bitwise fem/ops.scatter_add_cells, completion across ranks included;
- padding cells give zero blocks and zero contributions, nothing is NaN;
- the wrappers refuse what the kernels do not take, CPU tensors launch
  nothing, and the library registers its entries with the build.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.mesh.mesh import build_mesh as jbuild
from shakti_tpu.params import DEFAULT_PARAMS as P
from shakti_tpu.physics import residual as jres
from shakti_tpu.solve.timestep import make_static_fields as jstatic
from shakti_tpu_torch.fem import ops
from shakti_tpu_torch.mesh.generate import rectangle_mesh
from shakti_tpu_torch.mesh.mesh import build_mesh as tbuild
from shakti_tpu_torch.ops import element_cuda as ec
from shakti_tpu_torch.ops import spmv_cuda
from shakti_tpu_torch.parallel.partition import rcb_order
from shakti_tpu_torch.physics import residual as tres
from shakti_tpu_torch.solve.timestep import make_static_fields as tstatic
from shakti_tpu_torch.utils import trace
from tests.torch_parity import rel_err  # noqa: F401  (pins torch's threads)

M, PAD, DT = 3, 2, 3600.0
SHARED = ("G_q", "inputs_q", "storage_q", "gb0", "dt", "phi", "wq")


def close(got, ref, tol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= tol * np.abs(ref).max()


def blocks_close(got, ref, tol=1e-12):
    """Each 3x3 block to ``tol`` of its own largest entry (a lake cell's
    storage term outweighs a dry cell's blocks by ~1e6)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)
    return bool((np.abs(got - ref) <= tol * scale).all())


def rows_close(problem, got, ref):
    """To 1e-12 of the largest entry, over all rows and over the dry rows
    alone."""
    dry = problem["dry"]
    return close(got, ref) and close(np.asarray(got)[:, dry],
                                      np.asarray(ref)[:, dry])


@pytest.fixture(scope="module")
def problem():
    """The padded slab in both packages, M members' states, the port's
    batched StepPre (the ensemble's vmapped precompute) and JAX's element
    Jacobian and residual per member at each member's N."""
    nodes, cells = rectangle_mesh(8, 8, 4e3, 4e3, jitter=0.3, seed=3)
    perm = rcb_order(nodes)
    nodes, cells = nodes[perm], np.argsort(perm)[cells].astype(np.int32)
    n, c = nodes.shape[0], cells.shape[0]
    rng = np.random.default_rng(7)
    lake = (nodes[:, 0] > 2e3) & (nodes[:, 1] > 2e3)
    sargs = (rng.normal(size=n), rng.normal(size=n) + 500, np.full(n, 0.05),
             1e-8 * np.abs(rng.normal(size=n)), lake * 1.0,
             nodes[:, 0] < 1.0, 1e5, 1e-5, P)
    tm = tbuild(nodes, np.concatenate([cells, np.zeros((PAD, 3), np.int32)]),
                dtype=torch.float64, operator="cells",
                cell_valid=np.r_[np.ones(c), np.zeros(PAD)])
    jm = jbuild(nodes, cells, dtype=jnp.float64, n_cells_pad=c + PAD)
    ts, js = tstatic(tm, *sargs), jstatic(jm, *sargs)
    Nn = 1e5 + 1e4 * rng.normal(size=(M, n))
    b = np.abs(1e-3 + 1e-4 * rng.normal(size=(M, n)))
    q = 1e-4 * rng.normal(size=(M, n, 2))
    q[0, nodes[:, 0] < 1.5e3] = 0.0         # whole cells without flux
    q[1, ::4] = 0.0
    melt = 1e-7 * np.abs(rng.normal(size=(M, n)))
    X = 1e5 + 1e4 * rng.normal(size=(M, n, 3))
    dt = torch.tensor(DT, dtype=torch.float64)
    sq = tres.static_quad_fields(tm, ts, 4, torch.float64)
    pre = tres.StepPre(*torch.func.vmap(
        lambda N_, b_, q_, m_: tres.pre_values(tres.precompute_step(
            tm, N_, b_, q_, m_, ts, dt, P, 4, sq=sq)))(
        *map(torch.as_tensor, (Nn, b, q, melt))))
    jpre = jax.jit(lambda N_, b_, q_, m_: jres.precompute_step(
        jm, N_, b_, q_, m_, js, jnp.asarray(DT), P, quad_degree=4))
    jac = jax.jit(lambda N_, p: jres.element_jacobian(N_, p, jm, P))
    resid = jax.jit(lambda N_, p: jres.assemble_residual(N_, p, jm, P))
    jJ, jF = [], []
    for m in range(M):
        p = jpre(*map(jnp.asarray, (Nn[m], b[m], q[m], melt[m])))
        jJ.append(np.asarray(jac(jnp.asarray(X[m, :, 0]), p)))
        jF.append(np.asarray(resid(jnp.asarray(X[m, :, 0]), p)))
    # the rows that no lake cell touches, whose residual is ~1e-4 of the
    # lake rows' (the storage term dominates there)
    dry = np.ones(n, bool)
    dry[cells[lake[cells].any(axis=1)]] = False
    return dict(tm=tm, pre=pre, batch=ec.prepare(pre, tm, P),
                X=torch.as_tensor(X), jJ=np.stack(jJ), jF=np.stack(jF),
                dirichlet=ts.dirichlet, c=c, dry=dry)


def vmapped(problem, fn, X):
    """``fn`` of physics/residual per member under torch.func.vmap: the
    route the batched Newton solve took before the closed forms."""
    tm = problem["tm"]
    return torch.func.vmap(lambda N, *p: fn(N, tres.StepPre(*p), tm, P))(
        X, *tres.pre_values(problem["pre"]))


def test_shared_fields_have_member_stride_zero(problem):
    batch = problem["batch"]
    for k in ec.FIELDS:
        t = batch.fields[k]
        assert t.shape[0] == M
        assert (t.stride(0) == 0) == (k in SHARED), k


def test_jacobian_matches_forward_ad_and_jax(problem):
    X, batch = problem["X"], problem["batch"]
    got = ec.jacobian(batch, X[..., 0].contiguous())
    assert got.shape == (M, problem["tm"].n_cells, 3, 3)
    ad = vmapped(problem, tres.element_jacobian, X[..., 0])
    assert close(got, ad) and blocks_close(got, ad)
    assert close(got, problem["jJ"]) and blocks_close(got, problem["jJ"])


def test_residual_matches_forward_ad_and_jax(problem):
    X, batch = problem["X"], problem["batch"]
    got = ec.residual(batch, X)
    assert got.shape == X.shape
    assert problem["dry"].sum() >= 20
    assert rows_close(problem, got,
                      vmapped(problem, tres.assemble_residual_multi, X))
    one = ec.residual(batch, X[..., 0].contiguous())
    assert one.shape == X.shape[:2]
    assert rows_close(problem, one,
                      vmapped(problem, tres.assemble_residual, X[..., 0]))
    assert rows_close(problem, one, problem["jF"])


def test_columns_bitwise_single_calls(problem):
    X, batch = problem["X"], problem["batch"]
    corner = ec.corner_residual(batch, X)
    multi = ec.residual(batch, X, problem["dirichlet"])
    for j in range(3):
        Xj = X[..., j:j + 1].contiguous()
        assert torch.equal(ec.corner_residual(batch, Xj)[..., 0],
                           corner[..., j]), j
        assert torch.equal(ec.residual(batch, Xj[..., 0],
                                       problem["dirichlet"]),
                           multi[..., j]), j


def test_inputs_in_any_layout(problem):
    """A strided N or X (the ensemble's state may be one) reads as its
    contiguous copy."""
    X, batch = problem["X"], problem["batch"]
    Xt = X.transpose(0, 1).contiguous().transpose(0, 1)
    assert not Xt.is_contiguous() and not X[..., 0].is_contiguous()
    assert torch.equal(ec.jacobian(batch, X[..., 0]),
                       ec.jacobian(batch, X[..., 0].contiguous()))
    assert torch.equal(ec.residual(batch, Xt), ec.residual(batch, X))


def test_node_sum_bitwise_scatter_add_cells(problem):
    X, batch, tm = problem["X"], problem["batch"], problem["tm"]
    corner = ec.corner_residual(batch, X)
    got = ec.node_sum(batch, corner)
    for m in range(M):
        assert torch.equal(got[m], ops.scatter_add_cells(tm, corner[m]))
    d = problem["dirichlet"]
    masked = ec.node_sum(batch, corner, d)
    assert torch.equal(masked, torch.where(d[:, None], 0.0, got))
    assert bool((masked[:, d] == 0).all()) and bool(d.any())


class _Ranks:
    """A stand-in for a rank's collectives: a deterministic map of the
    local sums (the completion's place in the sum is what is checked)."""

    def accumulate(self, x):
        return 2.0 * x + torch.roll(x, 1, 0)

    allsum = accumulate


@pytest.mark.parametrize("kind", ["halo", "paxis"])
def test_node_sum_completes_as_scatter_add_cells(problem, kind):
    tm = dataclasses.replace(problem["tm"], **{kind: _Ranks()})
    batch = ec.prepare(problem["pre"], tm, P)
    corner = ec.corner_residual(batch, problem["X"])
    d = problem["dirichlet"]
    got = ec.node_sum(batch, corner, d)
    for m in range(M):
        ref = torch.where(d[:, None], 0.0, ops.scatter_add_cells(tm, corner[m]))
        assert torch.equal(got[m], ref)


def test_padding_cells_give_zero_blocks(problem):
    X, batch, c = problem["X"], problem["batch"], problem["c"]
    J = ec.jacobian(batch, X[..., 0].contiguous())
    corner = ec.corner_residual(batch, X)
    assert bool(torch.isfinite(J).all()) and bool(torch.isfinite(corner).all())
    assert bool((J[:, c:] == 0).all()) and bool((corner[:, c:] == 0).all())
    assert bool((J[:, :c].abs().amax(dim=(2, 3)) > 0).all())


def bad_pre(problem, **fields):
    return dataclasses.replace(problem["pre"], **fields)


def test_prepare_refuses_what_the_kernels_do_not_take(problem):
    pre, tm = problem["pre"], problem["tm"]
    cases = {
        "dtype": bad_pre(problem, Tq=pre.Tq.float()),
        "shape": bad_pre(problem, b_q=pre.b_q[:, :-1]),
        "device": bad_pre(problem, q_q=pre.q_q.to("meta")),
        "nq": bad_pre(problem, wq=torch.zeros(M, 7, dtype=torch.float64)),
        "members": bad_pre(problem, dt=pre.dt[0]),
    }
    for name, p in cases.items():
        with pytest.raises(ValueError):
            ec.prepare(p, tm, P)
    wide = dataclasses.replace(
        tm, inc_map=torch.full((tm.n_nodes, ec.S_MAX + 1), 3 * tm.n_cells))
    with pytest.raises(ValueError, match="incidence slots"):
        ec.prepare(pre, wide, P)


def test_wrappers_refuse_what_the_kernels_do_not_take(problem):
    X, batch = problem["X"], problem["batch"]
    for bad in (torch.cat([X, X[..., :1]], dim=-1), X.float(), X[:2],
                X[:, :-1]):
        with pytest.raises(ValueError):
            ec.residual(batch, bad)
    with pytest.raises(ValueError):
        ec.jacobian(batch, X[..., 0].float().contiguous())
    with pytest.raises(ValueError):
        ec.jacobian(batch, X[..., :2])
    corner = ec.corner_residual(batch, X)
    with pytest.raises(ValueError, match="mask"):
        ec.node_sum(batch, corner, problem["dirichlet"].double())


def test_cpu_tensors_launch_nothing(problem):
    X, batch = problem["X"], problem["batch"]
    before = trace.snapshot()
    assert {f"element_cuda.launches.{k}" for k in ec.ENTRIES} <= before.keys()
    ec.residual(batch, X)
    ec.jacobian(batch, X[..., 0].contiguous())
    assert trace.snapshot() == before
    assert ec.launches.keys() == ec.ENTRIES.keys()


def test_library_registered_with_the_build(monkeypatch, tmp_path):
    """The build's table holds the library and its entries, each entry is
    defined in the source for both types, and a failed build names it."""
    assert spmv_cuda.LIBRARIES["element_batched"] is ec.ENTRIES
    src = (spmv_cuda._CSRC / "element_batched.cu").read_text()
    for entry in ec.ENTRIES:
        assert f"int {entry}_##SUFFIX(" in src, entry
    assert "ELEMENT_ENTRIES(float, f32)" in src
    assert "ELEMENT_ENTRIES(double, f64)" in src
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"$@\" >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(spmv_cuda, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(spmv_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError,
                       match="(?s)element_batched.cu.*libelement_batched_"):
        spmv_cuda.build.__wrapped__("element_batched")
