"""The structural storage of the port's scalar-ELL and block-CSR operators
(fem/ell.py: ``svals`` (W, n), only the structural entries, column-major in
view order) against the dense layouts of shakti_tpu, in float64 on the CPU,
inputs from a numpy seed on the lake mesh:

- the structural fold scattered by to_dense equals the dense fold bit for
  bit (the plan of fem/ops.gather_plan applied as before the structural
  layout, and the port's JAX-layout fold functions) and JAX's fold to 1e-13
  of scale; from_dense(to_dense(s)) == s; padding slots are exactly 0;
- the structural diagonal equals the dense one bit for bit, JAX's to 1e-13;
- the plain matvec over svals, with and without the Dirichlet/diagonal-
  floor epilogue, equals shakti_tpu's operator_from_values product to 1e-13
  of scale (another summation order);
- the coarse inverse from svals, at one aggregate size that tiles the
  blocks (16) and one that does not (24), equals JAX's (from its values
  where they tile, else from its elements) to 1e-12 of scale after
  inverting back;
- the chunked segment sum equals numpy's;
- a checkpoint with an ELL or block-CSR lag carry keeps JAX's dense
  ``lag_vals`` and crosses between the two packages both ways (the run ends
  at the uninterrupted JAX run to 1e-10 of scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import setups.setup_slab as jslab
from shakti_tpu.api import run as jrun
from shakti_tpu.mesh.mesh import build_mesh as jbuild
from shakti_tpu.physics import residual as jres
from shakti_tpu.solve import precond as jpc
from shakti_tpu_torch.convert import problem_from_numpy, state_to_numpy
from shakti_tpu_torch.fem import bcsr as tbcsr
from shakti_tpu_torch.fem import ell as tell
from shakti_tpu_torch.fem import ops as tops
from shakti_tpu_torch.io import checkpoint as tckpt
from shakti_tpu_torch.mesh.mesh import build_mesh as tbuild
from shakti_tpu_torch.ops import spmv_cuda as spmv
from shakti_tpu_torch.physics import residual as tres
from shakti_tpu_torch.solve import precond as tpc
from tests.test_torch_checkpoint import KEYS, _half, _tmd
from tests.test_torch_formats import FORMATS, _case_mesh
from tests.torch_parity import rel_err, to_numpy


@pytest.fixture(scope="module", params=sorted(FORMATS))
def fmt(request):
    """One format on the lake mesh: both packages' meshes, seeded element
    blocks, JAX's dense fold and the port's structural fold."""
    op, B = FORMATS[request.param]
    nodes, cells = _case_mesh("lake")
    n = nodes.shape[0]
    jm = jbuild(nodes, cells, dtype=jnp.float64, operator=op, bell_block=B or 128)
    tm = tbuild(nodes, cells, dtype=torch.float64, operator=op, bell_block=B or 128)
    rng = np.random.default_rng(33)
    J = rng.normal(size=(tm.n_cells, 3, 3))
    dmask = rng.random(n) < 0.15
    return dict(B=B, jm=jm, tm=tm, J=J, dmask=dmask,
                extra=rng.random(n) * ~dmask, x=rng.normal(size=n),
                jv=np.asarray(jres.fold_operator_values(jnp.asarray(J), jm)),
                sv=tres.fold_operator_values(torch.as_tensor(J), tm))


def _dense_plan_fold(J, tm, B):
    """-J folded into the JAX layout by fem/ops.gather_plan + plan_sum over
    the element -> position maps: the fold as it was before the structural
    layout, built here from the mesh's JAX fields alone."""
    if B:
        keys = tbcsr.fold_keys(tm.bcsr_blk.numpy(), tm.bcsr_off.numpy(), B)
    else:
        keys = tm.ell_map.numpy()
    slots, idx = tops.gather_plan(keys)
    shape = tell.dense_shape(tm)
    return tops.plan_sum(-torch.as_tensor(J), torch.as_tensor(slots),
                         torch.as_tensor(idx), int(np.prod(shape))).reshape(shape)


def test_to_dense_equals_dense_fold(fmt):
    tm, sv, B = fmt["tm"], fmt["sv"], fmt["B"]
    W, n = tm.nz_col.shape
    assert sv.shape == (W, n) == tres.operator_values_shape(tm)
    dense = tell.to_dense(sv, tm)
    assert torch.equal(dense, _dense_plan_fold(fmt["J"], tm, B))
    port_fold = tbcsr.bcsr_from_elements if B else tell.ell_from_elements
    assert torch.equal(dense, port_fold(-torch.as_tensor(fmt["J"]), tm))
    assert dense.shape == fmt["jv"].shape
    assert rel_err(dense.numpy(), fmt["jv"]) <= 1e-13
    assert torch.equal(tell.from_dense(dense, tm), sv)
    pad = tm.nz_pos < 0
    assert int(pad.sum()) > 0 and int(torch.count_nonzero(sv[pad])) == 0
    # every structural slot of this seeded operator is a nonzero
    assert int(torch.count_nonzero(sv[~pad])) == int((~pad).sum())
    assert torch.equal(tm.nz_col[pad].long(),
                       torch.arange(n).expand(W, n)[pad])


def test_structural_diag_equals_jax(fmt):
    tm, jm, sv, B = fmt["tm"], fmt["jm"], fmt["sv"], fmt["B"]
    got = tres.operator_diag_from_values(sv, tm)
    dense = tell.to_dense(sv, tm)
    ref = (tbcsr.bcsr_diag(dense, tm.bcsr_diag_blk, tm.bcsr_diag_off) if B
           else tell.ell_diag(dense, tm.ell_diag_slot))
    assert torch.equal(got, ref)
    jd = jres.operator_diag_from_values(jnp.asarray(fmt["jv"]), jm)
    assert rel_err(got.numpy(), np.asarray(jd)) <= 1e-13
    # each diagonal slot names its own row as the column
    n = tm.n_nodes
    assert torch.equal(tm.nz_col.reshape(-1)[tm.nz_diag].long(), torch.arange(n))
    assert torch.equal(tm.nz_diag % n, torch.arange(n))


@pytest.mark.parametrize("epilogue", [False, True])
def test_plain_matvec_matches_jax_operator(fmt, epilogue):
    tm, jm, sv = fmt["tm"], fmt["jm"], fmt["sv"]
    d, e, x = fmt["dmask"], fmt["extra"], fmt["x"]
    tx = torch.as_tensor(x)
    if epilogue:
        y = spmv.ell_operator_plain(sv, tm, tx, torch.as_tensor(d),
                                    torch.as_tensor(e))
        ref = jres.operator_from_values(jnp.asarray(fmt["jv"]), jm,
                                        jnp.asarray(d))(jnp.asarray(x)) + e * x
        assert torch.equal(y, tres.operator_from_values(
            sv, tm, torch.as_tensor(d), torch.as_tensor(e))(tx))
    else:
        y = spmv.ell_operator_plain(sv, tm, tx)
        ref = jres.operator_from_values(
            jnp.asarray(fmt["jv"]), jm,
            jnp.zeros(tm.n_nodes, bool))(jnp.asarray(x))
        assert torch.equal(y, spmv.structural_matvec(sv, tm.nz_col, tx))
    assert rel_err(y.numpy(), np.asarray(ref)) <= 1e-13


@pytest.mark.parametrize("block", [16, 24])
def test_structural_coarse_inverse_matches_jax(fmt, block):
    """16 tiles the blocks of B 8 and 16 (JAX sums its values); 24 does not
    (JAX sums its elements); ELL tiles always."""
    jm, tm, d = fmt["jm"], fmt["tm"], fmt["dmask"]
    assert tpc.vals_coarse_ok(tm, block)
    if jpc.vals_coarse_ok(jm, block):
        ref = jax.jit(lambda v, m, dm: jpc.coarse_from_values(v, m, dm, block))(
            jnp.asarray(fmt["jv"]), jm, jnp.asarray(d))
    else:
        assert fmt["B"] and block == 24
        ref = jpc.coarse_inverse(jnp.asarray(fmt["J"]), jm, jnp.asarray(d), block)
    got = tpc.coarse_from_values(fmt["sv"], tm, torch.as_tensor(d), block)
    assert rel_err(np.linalg.inv(got.numpy()),
                   np.linalg.inv(np.asarray(ref))) <= 1e-12
    # the same build again: the same bits (a cached plan, no atomics)
    assert torch.equal(got, tpc.coarse_from_values(
        fmt["sv"], tm, torch.as_tensor(d), block))


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_chunked_sum_equals_numpy(chunk):
    rng = np.random.default_rng(5)
    size, n = 40, 3000
    keys = np.minimum(rng.integers(0, size, n), rng.integers(0, size, n))
    keys[keys == 7] = 8                                  # an empty segment
    at = rng.permutation(2 * n)[:n]                      # positions in values
    values = rng.normal(size=2 * n)
    slots, idx1, idx2 = tops.chunked_plan(keys, at, 2 * n, chunk)
    assert idx1.shape[1] == chunk and 7 not in slots
    got = tops.chunked_sum(torch.as_tensor(values), torch.as_tensor(slots),
                           torch.as_tensor(idx1), torch.as_tensor(idx2), size)
    ref = np.bincount(keys, weights=values[at], minlength=size)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    assert got[7] == 0.0


@pytest.mark.parametrize("op", ["ell", "bcsr"])
def test_lag_carry_converts_with_the_problem(op):
    """convert.problem_from_numpy reads JAX's dense lag values into the
    structural carry, and state_to_numpy writes them back."""
    nodes, cells = _case_mesh("slab")
    tm = tbuild(nodes, cells, dtype=torch.float64, operator=op, bell_block=16)
    rng = np.random.default_rng(6)
    sv = tres.fold_operator_values(
        torch.as_tensor(rng.normal(size=(tm.n_cells, 3, 3))), tm)
    dense = tell.to_dense(sv, tm).numpy()
    n = tm.n_nodes
    lag = (np.asarray(True), np.asarray(2), dense, rng.normal(size=n), None,
           np.asarray(0.5), np.asarray(1))
    state = dict(N=np.zeros(n), b=np.zeros(n), q=np.zeros(n), melt=np.zeros(n),
                 lag_op=lag)
    static = dict(z_b=np.zeros(n), z_s=np.ones(n), G=np.zeros(n),
                  inputs=np.zeros(n), storage=np.zeros(n), gb0=np.zeros(n),
                  dirichlet=np.zeros(n, bool), N_bdry=np.zeros(n),
                  b_min=np.zeros(n))
    jm = jbuild(nodes, cells, dtype=jnp.float64, operator=op, bell_block=16)
    m2, _, st, _ = problem_from_numpy(to_numpy(jm), static, state, {})
    assert st.lag_op[:2] == (True, 2) and torch.equal(st.lag_op[2], sv)
    back = state_to_numpy(st, m2)["lag_op"]
    np.testing.assert_array_equal(back[2], dense)


@pytest.mark.parametrize("op", ["ell", "bcsr"])
def test_structural_carry_needs_the_mesh(tmp_path, op):
    """Without the mesh the structural carry cannot be written in the file's
    layout nor read from it: save_state, load_state and state_to_numpy raise
    instead of keeping the wrong layout."""
    nodes, cells = _case_mesh("slab")
    tm = tbuild(nodes, cells, dtype=torch.float64, operator=op, bell_block=16)
    n = tm.n_nodes
    sv = tres.fold_operator_values(torch.as_tensor(
        np.random.default_rng(7).normal(size=(tm.n_cells, 3, 3))), tm)
    z = torch.zeros(n, dtype=torch.float64)
    st = tckpt.State(N=z, b=z, q=z, melt=z, N_prev=z,
                     lag_op=(True, 1, sv, z, None, 0.0, 0))
    with pytest.raises(ValueError, match="needs mesh="):
        tckpt.save_state(str(tmp_path), st, 3, 1)
    with pytest.raises(ValueError, match="needs its mesh"):
        state_to_numpy(st)
    assert not (tmp_path / "checkpoint.npz").exists()
    tckpt.save_state(str(tmp_path), st, 3, 1, include_lag=False)   # no carry
    assert tckpt.load_state(str(tmp_path), dtype=torch.float64)[1:] == (3, 1)
    tckpt.save_state(str(tmp_path), st, 3, 1, mesh=tm)
    with pytest.raises(ValueError, match="needs mesh="):
        tckpt.load_state(str(tmp_path), dtype=torch.float64)
    back = tckpt.load_state(str(tmp_path), dtype=torch.float64, mesh=tm)[0]
    assert torch.equal(back.lag_op[2], sv)


def _jmd(tmp_path, name, op):
    """tests/test_torch_checkpoint._tmd's model in shakti_tpu, float64, with
    the lag carry on in format ``op`` (block edge 16)."""
    md = jslab.initialize(nx=8, ny=8, days=5.0, nt_per_day=4,
                          results_name=str(tmp_path / name))
    md.operator, md.operator_block = op, 16
    md.solver = dataclasses.replace(md.solver, lag_operator=True)
    return md


def _tmd_op(tmp_path, name, op):
    md = _tmd(tmp_path, name, lag_operator=True)
    md.operator, md.operator_block = op, 16
    return md


@pytest.fixture(scope="module", params=["ell", "bcsr"])
def jax_full(request, tmp_path_factory):
    """shakti_tpu's uninterrupted run in one format, in user order."""
    md = _jmd(tmp_path_factory.mktemp("jax_" + request.param), "full",
              request.param)
    out = jrun.solve(md, progress=False)
    unp = slice(None) if md.node_iperm is None else md.node_iperm
    return {"op": request.param, "N": np.asarray(out["state"].N)[unp],
            "b": np.asarray(out["state"].b)[unp],
            "history": {k: np.asarray(v) for k, v in out["history"].items()}}


@pytest.mark.parametrize("direction", ["jax_then_torch", "torch_then_jax"])
def test_structural_carry_crosses_packages(tmp_path, jax_full, direction):
    """Half the run in one package, its final checkpoint (lag carry
    included, dense as JAX stores it) resumed by the other."""
    op = jax_full["op"]
    if direction == "jax_then_torch":
        jrun.solve(_half(_jmd(tmp_path, "x", op)), progress=False)
        md = _tmd_op(tmp_path, "x", op)
        md.nt_check = 2 * md.nt_save
        mesh = md.freeze()[0]
        loaded = tckpt.load_state(str(tmp_path / "x"), dtype=torch.float64,
                                  mesh=mesh)[0]
        assert loaded.lag_op[0] and loaded.lag_op[2].shape == mesh.nz_col.shape
        assert int(torch.count_nonzero(loaded.lag_op[2])) > 0
        out = md.solve(resume=True, progress=False)
        N, b = (md.to_user_order(out["state"].N.numpy()),
                md.to_user_order(out["state"].b.numpy()))
    else:
        _half(_tmd_op(tmp_path, "x", op)).solve(progress=False)
        z = np.load(tmp_path / "x" / "checkpoint.npz")
        mesh = _tmd_op(tmp_path, "unused", op).freeze()[0]
        assert z["lag_vals"].shape == tell.dense_shape(mesh) and z["lag_ok"]
        md = _jmd(tmp_path, "x", op)
        md.nt_check = 2 * md.nt_save
        out = jrun.solve(md, resume=True, progress=False)
        unp = slice(None) if md.node_iperm is None else md.node_iperm
        N, b = np.asarray(out["state"].N)[unp], np.asarray(out["state"].b)[unp]
    assert out["steps"] == 20 - 11
    assert rel_err(N, jax_full["N"]) <= 1e-10
    assert rel_err(b, jax_full["b"]) <= 1e-10
    for k in KEYS:
        assert rel_err(np.asarray(out["history"][k]),
                       jax_full["history"][k]) <= 1e-10, k
