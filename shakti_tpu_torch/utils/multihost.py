"""Multi-process launch: one process per rank on torch.distributed.

Port of shakti_tpu/utils/multihost.py.  The reference scales out with
``mpirun -np N python main.py <setup>``; the JAX package joins one process
per host into one device mesh.  Here every rank is a process, launched by
torchrun, which sets the standard variables:

    torchrun --nproc-per-node P -m shakti_tpu_torch <setup> --dist

    MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK

and the node-sharded runner (parallel/dist.py) runs one share on each rank.
A bespoke launcher names the group itself, as the JAX package's
``init_multihost(coordinator, num_processes, process_id)`` does, here by
keyword: ``init_multihost(coordinator="host:port", num_processes=P,
process_id=r)``.

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


def local_device(device="cuda", rank: int | None = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (without it ``cuda:rank``,
    the explicit route's process id, else ``cuda:0``; modulo the cards
    present, so that ranks share a card when there are fewer cards than
    ranks) for a CUDA ``device`` without an index, else ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        dev = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    return dev


def init_multihost(*, coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device="cuda",
                   backend: str | None = None, timeout=None):
    """Join a process group (idempotent).  Keywords only: a call in the JAX
    package's positional order raises TypeError.

    With ``coordinator`` ("host:port"; tests, bespoke launchers) the group
    forms over ``tcp://coordinator`` with ``num_processes`` ranks, this one
    ``process_id`` (the JAX package's jax.distributed.initialize route);
    rank 0 hosts the rendezvous store there unless the launcher's agent
    does (TORCHELASTIC_USE_AGENT_STORE).  Otherwise from torchrun's
    variables; without them (1, 0, True) and no group.

    ``backend``: None for NCCL on this rank's card with a CUDA ``device``,
    gloo with ``device='cpu'``; 'gloo' lets several ranks share one card
    (NCCL refuses two ranks on one GPU).  ``timeout``: a datetime.timedelta
    after which a collective no peer joins aborts the run (default
    parallel/halo.TIMEOUT).  Returns (world_size, rank, is_primary).  A
    group that cannot be formed raises."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_rank() == 0
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_multihost: coordinator needs "
                             "num_processes and process_id")
        init, rank, size = (f"tcp://{coordinator}", int(process_id),
                            int(num_processes))
        where = coordinator
    else:
        missing = [k for k in ENV if k != "LOCAL_RANK" and k not in os.environ]
        if len(missing) == len(ENV) - 1:
            return 1, 0, True
        if missing:
            raise RuntimeError(f"init_multihost: the launcher set only part "
                               f"of its environment (missing "
                               f"{', '.join(missing)})")
        init, rank, size = ("env://", int(os.environ["RANK"]),
                            int(os.environ["WORLD_SIZE"]))
        where = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    from shakti_tpu_torch.parallel.halo import TIMEOUT
    dev = local_device(device, rank if coordinator is not None else None)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    if coordinator is not None:
        kw.update(rank=rank, world_size=size)
    try:
        dist.init_process_group(backend, init_method=init,
                                timeout=timeout or TIMEOUT, **kw)
    except Exception as e:
        raise RuntimeError(
            f"init_multihost: rank {rank} of {size} could not join the "
            f"{backend} group at {where} ({e})") from e
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
