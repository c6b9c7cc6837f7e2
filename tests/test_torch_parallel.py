"""The port's halo exchange (shakti_tpu_torch/parallel/halo.py) and its
cell-sharded step (parallel/shard.py) on 4 gloo ranks on the CPU:

- push / accumulate / accumulate_split against test_dist.py's numpy oracle
  (the owner's value is the sum of every copy, the ghosts refreshed to
  it), for (L,) and (L, 2) fields; accumulate_split bitwise equal to the
  plain accumulate;
- the reductions give the same bits on every rank;
- the cell-sharded step on the 10x10 slab for 4 float64 steps against the
  JAX package's make_parallel_runner on 4 devices: N and b within 1e-8, q
  within 1e-6 (tests/test_parallel.py's tolerances), equal Newton counts,
  CG within one per Krylov solve, every rank's state bit for bit equal;
- no atomic sum (index_add_ / scatter_add_) on the distributed path;
- mg on the halo path (the V-cycle, 16x16, 3 float64 steps) against the
  JAX package's make_distributed_runner on 4 devices: equal Newton and CG
  counts (both accumulate the Chebyshev bound's offabs twice), N and b
  within 1e-8;
- the node-sharded transient at P = 8 on the 8x8 toy of
  __graft_entry__.dryrun_multichip (2 steps, float64), where the last rank
  owns no cell, against the JAX package's make_distributed_runner: equal
  Newton and CG counts, N and b within 1e-8.

The ranks are subprocesses of tests/torch_dist_worker.py (one world for the
file); the JAX side runs here on conftest's 8 virtual devices.
"""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest

import setups.setup_slab as jslab
from shakti_tpu.parallel import halo as JH
from shakti_tpu.parallel.dist import gather_state as jgather
from shakti_tpu.parallel.dist import make_distributed_runner as jrunner
from shakti_tpu.parallel.shard import make_device_mesh, make_parallel_runner
from shakti_tpu.solve.timestep import timestep_sizes as jdts
from tests.torch_parity import (assert_ranks_agree, case, finish_world,
                                start_world)

P = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The P = 4 world and the P = 8 toy, side by side."""
    hs = [start_world(s, p, tmp_path_factory.mktemp(s))
          for s, p in (("parallel", P), ("toy8", 8))]
    return [finish_world(h) for h in hs]


@pytest.fixture(scope="module")
def world(worlds):
    return worlds[0]


@pytest.fixture(scope="module")
def halo_oracle():
    md = jslab.initialize(nx=9, ny=7)
    n = md.x.size
    plan = JH.build_halo(n, md.cells, P)
    rng = np.random.default_rng(1)
    f = rng.normal(size=n)
    f2 = rng.normal(size=(n, 2))

    def owner_sum(g):
        exp = g.copy()
        for p in range(P):
            gl = np.where(plan["g2l"][p] >= plan["omax"])[0]
            exp[gl] += g[gl]          # each ghost copy adds its value
        return exp

    return plan, f, owner_sum(f), owner_sum(f2)


def _stack(ranks, key):
    return np.stack([r[key] for r in ranks])


def test_accumulate_matches_oracle(world, halo_oracle):
    plan, f, exp, exp2 = halo_oracle
    ranks = case(world, "halo")
    for key, want in (("acc", exp), ("acc2", exp2)):
        got = _stack(ranks, key)
        np.testing.assert_allclose(JH.globalize_nodal(plan, got), want,
                                   rtol=1e-12)
        # the ghosts hold the accumulated owner values, the dump slot zero
        for p in range(P):
            gl = np.where(plan["g2l"][p] >= plan["omax"])[0]
            np.testing.assert_allclose(got[p][plan["g2l"][p][gl]], want[gl],
                                       rtol=1e-12)
            assert not got[p][-1].any()


def test_split_accumulate_bitwise(world):
    for r in case(world, "halo"):
        np.testing.assert_array_equal(r["split"], r["acc"])


def test_push_refreshes_ghosts(world, halo_oracle):
    plan, f, _, _ = halo_oracle
    got = _stack(case(world, "halo"), "push")
    np.testing.assert_array_equal(got[:, :-1],
                                  JH.localize_nodal(plan, f)[:, :-1])


def test_reductions_identical_on_every_rank(world, halo_oracle):
    plan, f, _, _ = halo_oracle
    ranks = case(world, "halo")
    assert_ranks_agree(ranks, ("dot", "norm", "max", "allsum"))
    np.testing.assert_allclose(ranks[0]["dot"], f @ f, rtol=1e-13)
    assert ranks[0]["max"] == max(
        JH.localize_nodal(plan, f)[p].max() for p in range(P))


def test_dist_mg_matches_jax(world):
    ranks = case(world, "mg_v")
    assert_ranks_agree(ranks)
    r = ranks[0]
    assert r["converged"].all() and str(r["precond"]) == "mg"
    md = jslab.initialize(nx=16, ny=16, days=1.0, nt_per_day=4)
    md.b_init = np.full(md.x.size, 0.01)
    md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0,
                                    precond="mg", mg_agg=4, mg_coarse_cap=16)
    md.distributed = True
    runner, st0, plan = jrunner(md, make_device_mesh(P))
    assert plan["mg_plan"] is not None
    s, d = runner(st0, jdts(md.timesteps, dtype=md.dtype)[:3])
    g = jgather(plan, s)
    np.testing.assert_array_equal(r["newton"], np.asarray(d["newton_iters"]))
    np.testing.assert_array_equal(r["cg"], np.asarray(d["cg_iters"]))
    np.testing.assert_allclose(r["N"], np.asarray(g.N)[md.node_iperm],
                               rtol=1e-8)
    np.testing.assert_allclose(r["b"], np.asarray(g.b)[md.node_iperm],
                               rtol=1e-8)


@pytest.fixture(scope="module")
def jax_shard():
    md = jslab.initialize(nx=10, ny=10, days=1.0, nt_per_day=4)
    mesh, static, state, cfg = md.freeze()
    runner = make_parallel_runner(mesh, static, md.params, cfg,
                                  make_device_mesh(P))
    s, d = runner(state, jdts(md.timesteps, dtype=md.dtype)[:4])
    return {k: np.asarray(v) for k, v in
            dict(N=s.N, b=s.b, q=s.q, newton=d["newton_iters"],
                 cg=d["cg_iters"], converged=d["converged"]).items()}


def test_cell_sharded_step_matches_jax(world, jax_shard):
    ranks = case(world, "shard")
    assert_ranks_agree(ranks, ("newton", "cg", "rnorm", "N", "b", "q"))
    r = ranks[0]
    assert r["converged"].all() and jax_shard["converged"].all()
    np.testing.assert_array_equal(r["newton"], jax_shard["newton"])
    assert np.abs(r["cg"] - jax_shard["cg"]).max() <= r["newton"].max()
    np.testing.assert_allclose(r["N"], jax_shard["N"], rtol=1e-8)
    np.testing.assert_allclose(r["b"], jax_shard["b"], rtol=1e-8)
    np.testing.assert_allclose(r["q"], jax_shard["q"], rtol=1e-6,
                               atol=1e-18)


@pytest.mark.parametrize("path", [
    "parallel/halo.py", "parallel/dist.py", "parallel/shard.py",
    "solve/precond.py", "solve/mg.py", "fem/ops.py", "physics/residual.py"])
def test_no_atomic_sums_on_the_distributed_path(path):
    src = open(os.path.join(ROOT, "shakti_tpu_torch", path)).read()
    code = re.sub(r'"""[\s\S]*?"""|#.*', "", src)
    assert not re.search(r"index_add_?|scatter_add_?\(|scatter_reduce", code)


def test_toy_at_p8_with_a_cell_less_rank_matches_jax(worlds):
    ranks = case(worlds[1], "toy")
    assert_ranks_agree(ranks)
    assert min(int(r["cells"]) for r in ranks) == 1    # the padding cell
    md = jslab.initialize(nx=8, ny=8, days=2.0, nt_per_day=4)
    md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0,
                                    lag_operator=False)
    md.distributed = True
    runner, st0, plan = jrunner(md, make_device_mesh(8))
    assert not plan["cell_valid"][-1].any()
    s, d = runner(st0, jdts(md.timesteps, dtype=md.dtype)[:2])
    g = jgather(plan, s)
    r = ranks[0]
    np.testing.assert_array_equal(r["newton"], np.asarray(d["newton_iters"]))
    assert (np.abs(r["cg"] - np.asarray(d["cg_iters"])) <= r["newton"]).all()
    np.testing.assert_allclose(r["N"], np.asarray(g.N)[md.node_iperm],
                               rtol=1e-8)
    np.testing.assert_allclose(r["b"], np.asarray(g.b)[md.node_iperm],
                               rtol=1e-8)
