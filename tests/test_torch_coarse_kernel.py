"""The ensemble's two-level coarse operators (shakti_tpu_torch/ops/
element_cuda.coarse, the plain twin of csrc/element_batched.cu's
coarse_batched) on the CPU, on a 16x16 slab with M = 3 members:

- the twin equals, member by member, solve/precond.coarse_inverse's sum
  before its inverse bit for bit, in float64 and float32;
- in float64 the batched two-level's coarse inverses from the element
  blocks equal each member's route through the folded values
  (coarse_from_values) within 1e-12 of scale, in bell, ell and bcsr at
  aggregates of 16 and 64 nodes, and so do the applies;
- an aggregate whose nodes are all Dirichlet nodes has exactly zero rows
  and columns before the regularization;
- the plan is built once per (cells, block), lists gather_plan's positions
  in order, longest pair first, and goes with the cells;
- the wrapper refuses what the kernel does not take and, off the CPU,
  raises rather than falling back when the library cannot load.
"""

import dataclasses
import gc
import types

import numpy as np
import pytest
import torch

from shakti_tpu_torch.mesh.generate import rectangle_mesh
from shakti_tpu_torch.mesh.mesh import build_mesh
from shakti_tpu_torch.ops import element_cuda as ec
from shakti_tpu_torch.ops import spmv_cuda
from shakti_tpu_torch.parallel.partition import rcb_order
from shakti_tpu_torch.physics import residual as res
from shakti_tpu_torch.solve import precond as pc
from tests.torch_parity import rel_err

M = 3


def slab(op="bell", dtype=torch.float64):
    """The 16x16 slab (289 nodes) in RCB order, block-ELL and block-CSR
    with 16-node blocks, so that the last block row is partly padding."""
    nodes, cells = rectangle_mesh(16, 16, 8e3, 8e3, jitter=0.3, seed=5)
    perm = rcb_order(nodes)
    nodes, cells = nodes[perm], np.argsort(perm)[cells].astype(np.int32)
    return build_mesh(nodes, cells, dtype=dtype, operator=op, bell_block=16)


def inputs(mesh, dtype=torch.float64, seed=11):
    """M members' element blocks (members differ; a few exact zeros) and a
    Dirichlet mask on ~15 % of the nodes."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(M, mesh.n_cells, 3, 3))
    J[1, ::7] = 0.0
    d = rng.random(mesh.n_nodes) < 0.15
    return torch.as_tensor(J, dtype=dtype), torch.as_tensor(d)


def pre_inverse(J, mesh, d, block, monkeypatch):
    """coarse_inverse's coarse operator before its inverse."""
    seen = []
    monkeypatch.setattr(pc, "regularized_inverse",
                        lambda A_c, *a: seen.append(A_c) or A_c)
    pc.coarse_inverse(J, mesh, d, block)
    monkeypatch.undo()
    return seen[0]


def bits(x):
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("block", [16, 64])
def test_twin_is_coarse_inverse_sum_bitwise(dtype, block, monkeypatch):
    mesh = slab(dtype=dtype)
    J, d = inputs(mesh, dtype)
    d[32:48] = True                     # an aggregate of 16 all fixed
    got = ec.coarse(mesh, J, d, block)
    m = -(-mesh.n_nodes // block)
    assert got.shape == (M, m, m)
    assert torch.equal(bits(got), bits(ec.coarse_plain(mesh, J, d, block)))
    for mb in range(M):
        ref = pre_inverse(J[mb], mesh, d, block, monkeypatch)
        assert ref.dtype == dtype
        assert torch.equal(bits(got[mb]), bits(ref)), mb


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_order_is_the_twin_bitwise(dtype):
    """csrc/element_batched.cu's coarse_kernel, step by step in numpy
    scalars: each pair's masked entries added left to right to -0 (the
    additive identity: -0 + x is x, also for x = +0 or -0), then one + 0
    when the pair is shorter than the longest (the twin's padding zeros
    turn a sum of -0s into +0), zeros elsewhere."""
    mesh = slab()
    J, d = inputs(mesh)
    d[32:48] = True
    J = J.numpy().astype(dtype).reshape(M, -1)
    plan = ec.coarse_plan(mesh, 16)
    cells, fixed = mesh.cells.numpy(), d.numpy()
    out = np.zeros((M, plan.m * plan.m), dtype)
    offsets, positions = plan.offsets.numpy(), plan.positions.numpy()
    negative_zeros = 0
    for u, slot in enumerate(plan.slots.tolist()):
        for mb in range(M):
            acc = dtype(-0.0)
            for pos in positions[offsets[u]:offsets[u + 1]]:
                cell, e = divmod(int(pos), 9)
                fr = dtype(0 if fixed[cells[cell, e // 3]] else 1)
                fc = dtype(0 if fixed[cells[cell, e % 3]] else 1)
                acc = acc + -J[mb, pos] * (fr * fc)
            if offsets[u + 1] - offsets[u] < plan.maxlen:
                negative_zeros += bool(acc == 0 and np.signbit(acc))
                acc = acc + dtype(0)
            out[mb, slot] = acc
    twin = ec.coarse_plain(mesh, torch.as_tensor(J).reshape(
        M, mesh.n_cells, 3, 3), d, 16).reshape(M, -1)
    assert torch.equal(bits(torch.as_tensor(out)), bits(twin))
    assert negative_zeros > 0           # the + 0 decided some signs


@pytest.mark.parametrize("name", ["two_level", "mg"])
@pytest.mark.parametrize("op", ["bell", "ell", "bcsr"])
@pytest.mark.parametrize("block", [16, 64])
def test_batched_two_level_matches_values_route(op, block, name,
                                                monkeypatch):
    """The batched build (from J_c) against each member's single build
    from its folded values; 'mg' on a mesh without a hierarchy is the
    two-level."""
    mesh = slab(op)
    assert mesh.mg is None and pc.vals_coarse_ok(mesh, block)
    J, d = inputs(mesh)
    rng = np.random.default_rng(4)
    a_diag = torch.as_tensor(1.0 + rng.random((M, mesh.n_nodes)))
    r = torch.as_tensor(rng.normal(size=(M, mesh.n_nodes)))
    inverses = []
    real = pc.two_level_from_inverse
    monkeypatch.setattr(pc, "two_level_from_inverse",
                        lambda A_inv, *a: inverses.append(A_inv)
                        or real(A_inv, *a))
    z = pc.make_preconditioner_batched(name, mesh, d, a_diag, block,
                                       J_c=J)(r)
    batched = inverses.pop()
    assert batched.shape[0] == M
    for m in range(M):
        vals = res.fold_operator_values(J[m], mesh)
        z_m = pc.make_two_level(J[m], mesh, d, a_diag[m], block,
                                vals=vals)(r[m])
        assert rel_err(batched[m], inverses.pop()) <= 1e-12
        assert rel_err(z[m], z_m) <= 1e-12


@pytest.mark.parametrize("block", [16, 64])
def test_fixed_aggregate_rows_are_zero(block):
    mesh = slab()
    J, d = inputs(mesh)
    d[:] = False
    d[64:128] = True                    # aggregates 4-7 of 16, 1 of 64
    A_c = ec.coarse(mesh, J, d, block)
    rows = slice(64 // block, 128 // block)
    assert (A_c[:, rows, :] == 0).all() and (A_c[:, :, rows] == 0).all()
    others = torch.ones(A_c.shape[1], dtype=torch.bool)
    others[rows] = False
    assert (torch.diagonal(A_c, dim1=1, dim2=2)[:, others] != 0).all()


def test_plan_is_gather_plan_in_order():
    mesh = slab()
    plan = ec.coarse_plan(mesh, 16)
    assert ec.coarse_plan(mesh, 16) is plan
    assert ec.coarse_plan(mesh, 64) is not plan
    slots, idx = pc._host_plan(mesh, 16, elements=True)
    size = 9 * mesh.n_cells
    rows = {int(s): row[row < size] for s, row in zip(slots, idx)}
    counts = np.diff(plan.offsets.numpy())
    assert sorted(plan.slots.tolist()) == sorted(rows)
    assert (np.diff(counts) <= 0).all() and plan.maxlen == counts[0]
    assert plan.positions.dtype == plan.offsets.dtype == torch.int32
    for u, s in enumerate(plan.slots.tolist()):
        lo, hi = plan.offsets[u], plan.offsets[u + 1]
        np.testing.assert_array_equal(plan.positions[lo:hi].numpy(), rows[s])
    assert plan.filled.sum() == len(rows)
    assert plan.filled[plan.slots].all()
    key = (id(mesh.cells), 16, mesh.n_nodes)
    assert key in ec._PLANS
    del mesh, plan
    gc.collect()
    assert key not in ec._PLANS


def test_wrapper_refuses_what_the_kernel_does_not_take():
    mesh = slab()
    J, d = inputs(mesh)
    for bad_J in (J[0], J[:, :-1], J.to(torch.int64), J[..., :2]):
        with pytest.raises(ValueError, match="J_c"):
            ec.coarse(mesh, bad_J, d, 16)
    for bad_d in (d.double(), d[:-1]):
        with pytest.raises(ValueError, match="dirichlet"):
            ec.coarse(mesh, J, bad_d, 16)
    with pytest.raises(ValueError, match="block"):
        ec.coarse(mesh, J, d, 0)


def test_off_the_cpu_raises_when_the_library_cannot_load(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises: with the build
    failing, the wrapper raises and neither launches nor computes the
    twin."""
    mesh = slab()
    meta = types.SimpleNamespace(
        n_cells=mesh.n_cells, n_nodes=mesh.n_nodes,
        cells=mesh.cells.to("meta"), structural=False,
        bell_nbr=mesh.bell_nbr.to("meta"))
    J = torch.empty((M, mesh.n_cells, 3, 3), device="meta")
    d = torch.empty(mesh.n_nodes, dtype=torch.bool, device="meta")

    def no_nvcc(*names):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(spmv_cuda, "build_all", no_nvcc)
    monkeypatch.setattr(ec, "coarse_plain", None)
    ec._library.cache_clear()
    before = dict(ec.launches)
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ec.coarse(meta, J, d, 16)
    finally:
        ec._library.cache_clear()
    assert ec.launches == before


def test_entry_registered_with_a_launch_counter():
    from shakti_tpu_torch.utils import trace
    assert "coarse_batched" in spmv_cuda.LIBRARIES["element_batched"]
    assert "element_cuda.launches.coarse_batched" in trace.snapshot()
    mesh = slab()
    J, d = inputs(mesh)
    before = dict(ec.launches)
    ec.coarse(mesh, J, d, 64)
    assert ec.launches == before
    assert dataclasses.is_dataclass(ec.coarse_plan(mesh, 64))
