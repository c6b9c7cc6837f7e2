"""Multi-process launch: one process per rank on torch.distributed.

Port of shakti_tpu/utils/multihost.py.  The reference scales out with
``mpirun -np N python main.py <setup>``; the JAX package joins one process
per host into one device mesh.  Here every rank is a process, launched by
torchrun, which sets the standard variables:

    torchrun --nproc-per-node P -m shakti_tpu_torch <setup> --dist

    MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK

and the node-sharded runner (parallel/dist.py) runs one share on each rank.

IO: the run layer (api/run.py) funnels all file IO through rank 0, like the
reference's rank-0 gather funnel (reference solvers.py:86-102, 205-215);
every rank reaches every collective.  A resume reads the checkpoint on every
rank and so assumes a shared filesystem, as the reference does.

Where the JAX package warns and carries on with one process when the
launcher's environment is there but the group cannot be formed, this port
raises: a lone rank that went on would write the results of a run the
others never joined.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the cards present, so
    that ranks share a card when there are fewer cards than ranks) for a
    CUDA ``device`` without an index, else ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return dev


def init_multihost(device="cuda", backend: str | None = None, timeout=None):
    """Join the process group torchrun describes (idempotent).

    ``backend``: None for NCCL on ``cuda:LOCAL_RANK`` with a CUDA
    ``device``, gloo with ``device='cpu'``; 'gloo' lets several ranks share
    one card (NCCL refuses two ranks on one GPU).  ``timeout``: a
    datetime.timedelta after which a collective no peer joins aborts the
    run (default parallel/halo.TIMEOUT).  Returns (world_size, rank,
    is_primary).  Without torchrun's variables: (1, 0, True), no group.
    With them, a group that cannot be formed raises."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_rank() == 0
    missing = [k for k in ENV if k != "LOCAL_RANK" and k not in os.environ]
    if len(missing) == len(ENV) - 1:
        return 1, 0, True
    if missing:
        raise RuntimeError(f"init_multihost: the launcher set only part of "
                           f"its environment (missing {', '.join(missing)})")
    from shakti_tpu_torch.parallel.halo import TIMEOUT
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    try:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout or TIMEOUT, **kw)
    except Exception as e:
        raise RuntimeError(
            f"init_multihost: rank {os.environ['RANK']} of "
            f"{os.environ['WORLD_SIZE']} could not join the {backend} group "
            f"at {os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']} "
            f"({e})") from e
    return dist.get_world_size(), dist.get_rank(), dist.get_rank() == 0


def world() -> tuple[int, int]:
    """(world size, rank): (1, 0) when no process group is formed."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def to_host(x, group=None) -> np.ndarray:
    """Every rank's ``x`` (equal shapes) concatenated along axis 0, as a host
    numpy array on EVERY rank: one all_gather, so every rank of the group
    must reach the call.  Without a group, ``x`` itself."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x.detach().cpu().numpy()
    from shakti_tpu_torch.parallel.halo import Collectives
    parts = Collectives(x.device, group).gather(x.detach())
    return torch.cat(parts).cpu().numpy()


def broadcast_flag(flag: bool, group=None) -> bool:
    """Rank 0's ``flag`` on every rank (the pre-existing-directory verdict
    of api/run.py, so that every rank aborts together)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return bool(flag)
    from shakti_tpu_torch.parallel.halo import Collectives
    c = Collectives("cpu" if dist.get_backend(group) == "gloo"
                    else torch.device("cuda", torch.cuda.current_device()),
                    group)
    t = torch.tensor([int(flag) if c.rank == 0 else 0], device=c.device)
    return bool(c.max(t).item())
