"""Cell-sharded, node-replicated ranks: the first multi-device scheme.

Port of shakti_tpu/parallel/shard.py.  The cells are partitioned by RCB
(parallel/partition.py) between the ranks of a process group; each rank
assembles its own cells' element contributions over the replicated global
nodes, and one sum over the ranks completes each assembly
(fem/ops.scatter_add_cells with ``mesh.paxis``).  Krylov vector algebra runs
replicated, so dots and norms need no communication, and the sum over the
ranks (parallel/halo.Collectives.allsum: rank order, the same bits on every
rank) keeps every rank's state and every host decision identical.  The
operator is the matrix-free one over the rank's cells and the
preconditioner Jacobi, as in the JAX package; nodal memory is replicated.
The node-sharded scheme with halo exchange is parallel/dist.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from shakti_tpu_torch.mesh.mesh import Mesh, incidence_map
from shakti_tpu_torch.parallel.halo import Collectives
from shakti_tpu_torch.parallel.partition import partition_cells
from shakti_tpu_torch.solve.timestep import make_step_fn, run_window


def rank_cells(mesh: Mesh, n_parts: int, rank: int) -> np.ndarray:
    """The global ids of the cells of part ``rank`` (RCB on the centroids)."""
    order, counts = partition_cells(mesh.nodes.cpu().numpy(),
                                    mesh.cells.cpu().numpy(), n_parts)
    off = int(counts[:rank].sum())
    return order[off:off + int(counts[rank])]


def make_parallel_step_fn(mesh: Mesh, static, params, cfg, group=None):
    """step(state, forcing) of solve/timestep.make_step_fn, run cell-sharded
    over the ranks of ``group`` (default: the world): the same signature and
    results (up to the order of the sums over the ranks), on every rank.
    ``mesh``/``static``: the global problem (api/model.freeze), on this
    rank's device.  Takes differentiable=False: the JAX package has no
    differentiable cell-sharded step (its shard_map there keeps the vma
    check, which drops custom_vjp cotangents, shakti_tpu/parallel/shard.py),
    and the sum over the ranks that completes each assembly here has no
    transpose (parallel/halo.Collectives).  The node-sharded runner
    (parallel/dist.py) is the differentiable distributed path."""
    if cfg.differentiable:
        raise NotImplementedError(
            "the cell-sharded step takes differentiable=False; use the "
            "node-sharded runner (parallel/dist.make_distributed_runner)")
    # the rank's cells have no foldable operator structure: no operator carry
    cfg = dataclasses.replace(cfg, lag_operator=False)
    ids = rank_cells(mesh, dist.get_world_size(group), dist.get_rank(group))
    dev = mesh.nodes.device
    idx = torch.as_tensor(ids, device=dev)
    lmesh = Mesh(nodes=mesh.nodes, cells=mesh.cells[idx], area=mesh.area[idx],
                 grads=mesh.grads[idx], node_area=mesh.node_area,
                 cell_valid=mesh.cell_valid[idx],
                 inc_map=torch.as_tensor(incidence_map(
                     mesh.cells.cpu().numpy()[ids], mesh.n_nodes), device=dev),
                 paxis=Collectives(dev, group))
    lstatic = dataclasses.replace(static, gb0=static.gb0[idx])
    return make_step_fn(lmesh, lstatic, params, cfg)


def make_parallel_runner(mesh: Mesh, static, params, cfg, group=None):
    """(state, forcing) -> (state, diags): run_window over the cell-sharded
    step (:func:`make_parallel_step_fn`)."""
    step = make_parallel_step_fn(mesh, static, params, cfg, group)
    return lambda state, forcing: run_window(step, state, forcing)
