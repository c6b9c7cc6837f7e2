"""The scalar-ELL, block-CSR and matrix-free ('cells') operators of the port
against shakti_tpu, in float64 on the CPU:

- the host builders (build_ell_map, build_bcsr) equal JAX's exactly, and so
  does every Mesh field of build_mesh in each format;
- the folds (the port's structural values scattered into JAX's layout),
  diagonals, plain matvecs, the matrix-free operator and the coarse builds
  (from the structural values at every aggregate size; from elements) agree
  with JAX's to 1e-13 (the coarse operators to 1e-12);
- the plain version of csrc/ell_spmv.cu over the structural values equals
  the product in JAX's layout to 1e-12, padding and Dirichlet rows
  included, and the view holds exactly the mesh's vertex pairs;
  tests/test_torch_structural.py holds the structural storage itself;
- the slice steps like JAX's in every format (1e-10 of scale, equal Newton
  counts) and meets the goldens (1e-7), and BiCGStab matches JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.fem import bcsr as jbcsr
from shakti_tpu.fem import ell as jell
from shakti_tpu.mesh.mesh import build_mesh as jbuild
from shakti_tpu.physics import residual as jres
from shakti_tpu.solve import krylov as jkrylov
from shakti_tpu.solve import precond as jpc
from shakti_tpu.solve.timestep import make_step_fn as jstep_fn
from shakti_tpu.solve.timestep import timestep_sizes as jdts
from shakti_tpu_torch.convert import problem_from_numpy
from shakti_tpu_torch.fem import bcsr as tbcsr
from shakti_tpu_torch.fem import ell as tell
from shakti_tpu_torch.mesh.mesh import build_mesh as tbuild
from shakti_tpu_torch.ops import spmv_cuda as spmv
from shakti_tpu_torch.parallel.partition import rcb_order
from shakti_tpu_torch.physics import residual as tres
from shakti_tpu_torch.solve import krylov as tkrylov
from shakti_tpu_torch.solve import precond as tpc
from shakti_tpu_torch.solve.timestep import make_step_fn, run_window, timestep_sizes
from tests import golden_cases as jcases
from tests import torch_golden_cases as tcases
from tests.torch_parity import frozen_to_numpy, rel_err, to_numpy

# name -> (operator, block edge): B = 16 leaves the last block row of both
# meshes partly padding
FORMATS = {"ell": ("ell", None), "bcsr8": ("bcsr", 8), "bcsr16": ("bcsr", 16)}


def _case_mesh(name):
    md = {"slab": jcases.slab_case, "lake": jcases.lake_case}[name]()[0]
    perm = rcb_order(md.nodes)
    iperm = np.argsort(perm)
    return md.nodes[perm], iperm[md.cells].astype(np.int32)


@pytest.mark.parametrize("name", ["slab", "lake"])
def test_build_ell_map_equals_jax(name):
    nodes, cells = _case_mesh(name)
    got = tell.build_ell_map(cells, nodes.shape[0])
    ref = jell.build_ell_map(cells, nodes.shape[0])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == np.int32


@pytest.mark.parametrize("name", ["slab", "lake"])
@pytest.mark.parametrize("B", [8, 16])
def test_build_bcsr_equals_jax(name, B):
    nodes, cells = _case_mesh(name)
    got = tbcsr.build_bcsr(cells, nodes.shape[0], B)
    ref = jbcsr.build_bcsr(cells, nodes.shape[0], B)
    assert got[-1] == ref[-1]
    for g, r in zip(got[:-1], ref[:-1]):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == np.int32


@pytest.mark.parametrize("op", ["ell", "bcsr", "cells"])
def test_mesh_fields_equal_jax(op):
    nodes, cells = _case_mesh("lake")
    jm = jbuild(nodes, cells, dtype=jnp.float64, operator=op, bell_block=16)
    tm = tbuild(nodes, cells, dtype=torch.float64, operator=op, bell_block=16)
    ref = to_numpy(jm)
    for k, v in ref.items():
        got = getattr(tm, k)
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        assert got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    assert (tm.nz_pos is None) == (op == "cells")


@pytest.fixture(scope="module", params=sorted(FORMATS))
def fmt(request):
    """One format on the lake mesh: both packages' meshes, seeded element
    blocks, both folds, a Dirichlet mask, x and a diagonal increment."""
    op, B = FORMATS[request.param]
    nodes, cells = _case_mesh("lake")
    n = nodes.shape[0]
    jm = jbuild(nodes, cells, dtype=jnp.float64, operator=op, bell_block=B or 128)
    tm = tbuild(nodes, cells, dtype=torch.float64, operator=op, bell_block=B or 128)
    rng = np.random.default_rng(21)
    J = rng.normal(size=(tm.n_cells, 3, 3))
    dmask = rng.random(n) < 0.15
    extra = rng.random(n) * ~dmask
    x = rng.normal(size=n)
    return dict(name=request.param, B=B, jm=jm, tm=tm, J=J, dmask=dmask,
                extra=extra, x=x, jv=np.asarray(jres.fold_operator_values(
                    jnp.asarray(J), jm)),
                tv=tres.fold_operator_values(torch.as_tensor(J), tm))


def test_fold_diag_matvec_match_jax(fmt):
    jm, tm, jv, tv = fmt["jm"], fmt["tm"], fmt["jv"], fmt["tv"]
    assert tv.shape == tres.operator_values_shape(tm) == tm.nz_col.shape
    dense = tell.to_dense(tv, tm)
    assert dense.shape == jv.shape
    assert rel_err(dense.numpy(), jv) <= 1e-13
    assert rel_err(tres.operator_diag_from_values(tv, tm).numpy(),
                   np.asarray(jres.operator_diag_from_values(
                       jnp.asarray(jv), jm))) <= 1e-13
    d, x, e = fmt["dmask"], fmt["x"], fmt["extra"]
    y = tres.operator_from_values(tv, tm, torch.as_tensor(d),
                                  torch.as_tensor(e))(torch.as_tensor(x))
    y_ref = (jres.operator_from_values(jnp.asarray(jv), jm, jnp.asarray(d))(
        jnp.asarray(x)) + e * x)
    assert rel_err(y.numpy(), np.asarray(y_ref)) <= 1e-13


def test_fold_is_zero_outside_the_view(fmt):
    """The structural values hold every nonzero of JAX's fold, exact zeros
    on padding, and scatter to zero outside the view."""
    tm, tv = fmt["tm"], fmt["tv"]
    pos = tm.nz_pos
    assert pos.dtype == torch.int64 and tm.nz_col.dtype == torch.int32
    inside = pos[pos >= 0]
    assert torch.equal(torch.sort(inside).values,
                       torch.as_tensor(np.flatnonzero(fmt["jv"].reshape(-1))))
    assert int(torch.count_nonzero(tv[pos < 0])) == 0
    outside = tell.to_dense(tv, tm).reshape(-1).clone()
    outside[inside] = 0.0
    assert int(torch.count_nonzero(outside)) == 0
    # the view's (row, column) pairs are exactly the mesh's vertex pairs,
    # W is the largest row count, padding sits after the entries
    n = tm.n_nodes
    valid = pos >= 0
    rows = torch.arange(n).expand_as(pos)[valid]
    c = tm.cells
    pairs = torch.unique(c[:, :, None].expand(-1, 3, 3).reshape(-1) * n
                         + c[:, None, :].expand(-1, 3, 3).reshape(-1))
    assert torch.equal(pairs, torch.sort(rows * n + tm.nz_col[valid].long()).values)
    counts = valid.sum(0)
    assert int(counts.max()) == pos.shape[0]
    assert torch.equal(valid, torch.arange(pos.shape[0])[:, None] < counts)
    assert torch.equal(tm.nz_col[~valid].long(),
                       torch.arange(n).expand_as(pos)[~valid])


@pytest.mark.parametrize("epilogue", [False, True])
def test_mirror_matches_plain_f64(fmt, epilogue):
    """The kernel's plain version (and mirror) over the structural values
    against the product over JAX's layout: the same terms summed in another
    order."""
    tm, tv = fmt["tm"], fmt["tv"]
    x = torch.as_tensor(fmt["x"])
    d, e = ((torch.as_tensor(fmt["dmask"]), torch.as_tensor(fmt["extra"]))
            if epilogue else (None, None))
    ref = spmv.ell_operator_dense(tv, tm, x, d, e)
    got = spmv.ell_operator_plain(tv, tm, x, d, e)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12 * ref.abs().max().item())
    if epilogue:
        assert torch.equal(got[d], x[d] + e[d] * x[d])
    if fmt["B"] == 16:
        assert tm.n_nodes % 16 != 0      # a partly padded last block row
    # the CPU wrapper computes the plain version and launches nothing
    before = dict(spmv.launches)
    assert torch.equal(spmv.ell_operator_fn(tv, tm, d, e)(x), got)
    assert spmv.launches == before


@pytest.mark.parametrize("block", [8, 16, 32, 64])
def test_coarse_from_values_matches_jax(fmt, block):
    """ELL and BCSR at any aggregate size from the structural values; JAX
    from its blocks, with sub-tiles (block < B) and whole blocks
    (block >= B)."""
    jm, tm = fmt["jm"], fmt["tm"]
    B = fmt["B"]
    assert tpc.vals_coarse_ok(tm, block)
    assert jpc.vals_coarse_ok(jm, block) == (B is None or block % B == 0
                                             or B % block == 0)
    d = fmt["dmask"]
    ref = np.asarray(jax.jit(
        lambda v, m, dm: jpc.coarse_from_values(v, m, dm, block))(
        jnp.asarray(fmt["jv"]), jm, jnp.asarray(d)))
    got = tpc.coarse_from_values(fmt["tv"], tm, torch.as_tensor(d), block)
    assert rel_err(np.linalg.inv(got.numpy()), np.linalg.inv(ref)) <= 1e-12


@pytest.mark.parametrize("op,block", [("cells", 24), ("bcsr", 24),
                                      ("cells", 64)])
def test_coarse_inverse_matches_jax(op, block):
    """The element path: the matrix-free operator's, and JAX's for
    block-CSR when the aggregates (24) do not tile its blocks (16); the
    port's structural values tile any aggregate, and both of its paths
    meet JAX's element path."""
    nodes, cells = _case_mesh("lake")
    jm = jbuild(nodes, cells, dtype=jnp.float64, operator=op, bell_block=16)
    tm = tbuild(nodes, cells, dtype=torch.float64, operator=op, bell_block=16)
    assert not jpc.vals_coarse_ok(jm, block)
    assert tpc.vals_coarse_ok(tm, block) == (op == "bcsr")
    rng = np.random.default_rng(3)
    J = rng.normal(size=(tm.n_cells, 3, 3))
    d = rng.random(tm.n_nodes) < 0.1
    ref = np.asarray(jpc.coarse_inverse(jnp.asarray(J), jm, jnp.asarray(d), block))
    got = tpc.coarse_inverse(torch.as_tensor(J), tm, torch.as_tensor(d), block)
    assert rel_err(np.linalg.inv(got.numpy()), np.linalg.inv(ref)) <= 1e-12
    if op == "bcsr":
        got = tpc.coarse_from_values(
            tres.fold_operator_values(torch.as_tensor(J), tm), tm,
            torch.as_tensor(d), block)
        assert rel_err(np.linalg.inv(got.numpy()), np.linalg.inv(ref)) <= 1e-12
    else:
        with pytest.raises(ValueError, match="coarse_inverse"):
            tpc.coarse_from_values(torch.zeros(1), tm, torch.as_tensor(d),
                                   block)


@pytest.mark.parametrize("op", ["cells", "ell", "bcsr"])
def test_make_operator_matches_jax(op):
    """(matvec, diag) of A = -J, matrix-free for 'cells'; and the diagonal
    of the matrix-free operator equals the folded one."""
    nodes, cells = _case_mesh("slab")
    jm = jbuild(nodes, cells, dtype=jnp.float64, operator=op, bell_block=16)
    tm = tbuild(nodes, cells, dtype=torch.float64, operator=op, bell_block=16)
    rng = np.random.default_rng(4)
    J = rng.normal(size=(tm.n_cells, 3, 3))
    d = rng.random(tm.n_nodes) < 0.2
    x = rng.normal(size=tm.n_nodes)
    jmv, jdiag = jres.make_operator(jnp.asarray(J), jm, jnp.asarray(d))
    tmv, tdiag = tres.make_operator(torch.as_tensor(J), tm, torch.as_tensor(d))
    assert rel_err(tmv(torch.as_tensor(x)).numpy(),
                   np.asarray(jmv(jnp.asarray(x)))) <= 1e-13
    assert rel_err(tdiag.numpy(), np.asarray(jdiag)) <= 1e-13
    if op == "cells":
        with pytest.raises(ValueError, match="foldable"):
            tres.operator_values_shape(tm)


def test_wrapper_raises_where_the_kernel_cannot_run():
    """Off the CPU, a view wider than the kernel's W_MAX and one of 2**31
    or more slots raise (meta tensors: nothing is allocated)."""
    nodes, cells = _case_mesh("slab")
    tm = tbuild(nodes, cells, dtype=torch.float64, operator="bcsr", bell_block=16)
    n = tm.n_nodes

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    wide = dataclasses.replace(
        tm, nz_col=meta((spmv.W_MAX + 1, n), torch.int32))
    with pytest.raises(ValueError, match="W <= 16"):
        spmv.ell_operator_fn(meta((spmv.W_MAX + 1, n), torch.float64), wide)
    W, n_big = 16, 2 ** 27
    big = dataclasses.replace(tm, nodes=meta((n_big, 2), torch.float64),
                              nz_col=meta((W, n_big), torch.int32))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        spmv.ell_operator_fn(meta((W, n_big), torch.float64), big)
    with pytest.raises(ValueError, match="structural"):
        spmv.ell_operator_fn(meta((W, n), torch.float64), tm)
    with pytest.raises(ValueError, match="int32"):
        tell.scalar_view(np.zeros(1), np.array([2 ** 31]), np.zeros(1), 1)


def _jax_problem(case, op, **solver):
    md, n, fname = getattr(jcases, case)()
    md.operator = op
    md.operator_block = 16
    md.solver = dataclasses.replace(md.solver, **solver)
    mesh, static, state, cfg = md.freeze()
    return md, n, fname, (mesh, static, state, cfg)


@pytest.mark.parametrize("op,solver", [
    ("ell", {}), ("bcsr", {"coarse_block": 24}), ("cells", {}),
    ("bcsr", {"krylov": "bicgstab"}), ("bcsr", {"lag_operator": True})],
    ids=["ell", "bcsr16-coarse24", "cells", "bcsr16-bicgstab", "bcsr16-lag"])
def test_steps_match_jax(op, solver):
    """The lake golden case through the same frozen problem (convert.py) in
    each format, lag carry included: N/b/q/melt at 1e-10 of scale and equal
    Newton counts after every step."""
    md, n, _, (mesh, static, state, cfg) = _jax_problem("lake_case", op, **solver)
    jstep = jax.jit(jstep_fn(mesh, static, md.params, cfg))
    dts = np.asarray(jdts(md.timesteps, dtype=md.dtype))[:n]
    tm, ts, tstate, tcfg = problem_from_numpy(
        *frozen_to_numpy(mesh, static, state, cfg))
    assert tcfg.krylov == cfg.krylov and tcfg.coarse_block == cfg.coarse_block
    tstep = make_step_fn(tm, ts, md.params, tcfg)
    tdts = timestep_sizes(md.timesteps, torch.float64)[:n]
    for i in range(n):
        state, d = jstep(state, dts[i])
        tstate, td = tstep(tstate, tdts[i])
        assert td["converged"] and bool(d["converged"]), i
        assert td["newton_iters"] == int(d["newton_iters"]), i
        for k in ("N", "b", "q", "melt"):
            err = rel_err(getattr(tstate, k).numpy(), np.asarray(getattr(state, k)))
            assert err <= 1e-10, (i, k, err)


@pytest.mark.parametrize("op", ["ell", "bcsr", "cells"])
def test_port_matches_golden(op):
    """Every format through the port's own freeze, against the slab
    golden (tests/test_goldens.py's tolerance); ELL and 'cells' keep the
    caller's node order."""
    md, n, fname = tcases.slab_case()
    md.dtype, md.device, md.operator = torch.float64, "cpu", op
    mesh, static, state, cfg = md.freeze()
    assert (md.node_iperm is None) == (op != "bcsr")
    assert not cfg.lag_operator
    step = make_step_fn(mesh, static, md.params, cfg)
    state, diags = run_window(step, state,
                              timestep_sizes(md.timesteps, md.dtype)[:n])
    assert diags["converged"].all()
    errs = tcases.golden_errors(md, state, fname)
    assert max(errs.values()) <= tcases.GOLDEN_ATOL, errs


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_bicgstab_matches_jax(precond):
    """A nonsymmetric operator (the element Jacobian's convection part)."""
    rng = np.random.default_rng(1)
    n = 60
    A = rng.normal(size=(n, n)) + n * np.diag(1.0 + rng.random(n))
    b = rng.normal(size=n)
    d = 1.0 / np.diag(A) if precond == "jacobi" else None
    jx, ji = jkrylov.bicgstab(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                              None if d is None else jnp.asarray(d), rtol=1e-11)
    tA = torch.as_tensor(A)
    tx, ti = tkrylov.bicgstab(lambda v: tA @ v, torch.as_tensor(b),
                              None if d is None else torch.as_tensor(d),
                              rtol=1e-11)
    assert ti["iters"] == int(ji["iters"]) > 3
    assert ti["converged"] and bool(ji["converged"])
    assert rel_err(tx.numpy(), np.asarray(jx)) <= 1e-9
    assert tkrylov.get_solver("bicgstab") is tkrylov.bicgstab
    with pytest.raises(ValueError, match="Krylov"):
        tkrylov.get_solver("gmres")


def test_auto_operator_rule():
    """'auto' is block-ELL up to 200k nodes on every device (the TPU's
    rule), block-CSR beyond; the lag carry is on for block-ELL only and
    the coarse aggregate starts at 128 there, 64 otherwise."""
    from shakti_tpu_torch.api import model
    from shakti_tpu_torch.setups import setup_slab
    md = setup_slab.initialize(nx=12, ny=12)
    md.device, md.dtype = "cpu", torch.float64
    mesh, _, state, cfg = md.freeze()
    assert mesh.bell_nbr is not None and cfg.lag_operator
    assert cfg.coarse_block == 128 and state.lag_op is not None
    md.operator = "bcsr"
    mesh, _, state, cfg = md.freeze()
    assert mesh.bcsr_B == 32 and not cfg.lag_operator and cfg.coarse_block == 64
    assert state.lag_op is None
    md.operator_block = 8
    assert md.freeze()[0].bcsr_B == 8
    md.operator = "cells"
    md.solver = dataclasses.replace(md.solver, lag_operator=True)
    with pytest.raises(ValueError, match="foldable"):
        md.freeze()
    assert model.BELL_MAX_NODES == 200_000
