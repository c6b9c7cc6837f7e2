"""Helpers for the parity tests between shakti_tpu (JAX) and
shakti_tpu_torch: frozen JAX dataclasses -> dicts of numpy arrays, the form
shakti_tpu_torch.convert.problem_from_numpy reads.

Every port test file imports this module, which pins torch's intra-op
threads to the worker's share of the cores: under pytest-xdist each worker
would otherwise start a pool of one thread per core, and six such pools on
the same cores (beside XLA's) make the port's small-mesh tests several
times slower than alone."""

import dataclasses
import os

import numpy as np
import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def to_numpy(obj) -> dict:
    """Dataclass of jax arrays -> dict field name -> numpy array (None and
    non-array fields dropped; a lag_op tuple keeps its slots)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, str) or f.name in ("mg", "halo"):
            continue
        if f.name == "lag_op":
            out[f.name] = tuple(None if a is None else np.asarray(a) for a in v)
        else:
            out[f.name] = np.asarray(v)
    return out


def frozen_to_numpy(mesh, static, state, cfg):
    """shakti_tpu freeze() outputs -> problem_from_numpy arguments."""
    return (to_numpy(mesh), to_numpy(static), to_numpy(state),
            dataclasses.asdict(cfg))


def rel_err(got, ref):
    """max |got - ref| / max |ref| (max |ref| = 0 -> absolute)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max() or 1.0
    return float(np.abs(got - ref).max() / scale)


def start_world(suite: str, world: int, out_dir, env_init: bool = False):
    """Start tests/torch_dist_worker.py's ``suite`` on ``world`` gloo ranks
    (one subprocess each, file:// init, or torchrun's variables with
    ``env_init``); :func:`finish_world` collects it.

    With ``env_init`` this process hosts the rendezvous store, as torchrun's
    agent does: it binds port 0 (the system picks a free port and the
    store holds it from then on) and every rank joins as a client
    (TORCHELASTIC_USE_AGENT_STORE).  A port chosen free and bound later by
    rank 0 could be taken in between by another process of a loaded host."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "torch_dist_worker.py")
    out_dir = str(out_dir)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("SHAKTI_RUN_GROUP", None)
    init = os.path.join(out_dir, "init")
    store = None
    if env_init:
        import datetime

        from torch.distributed import TCPStore
        store = TCPStore("localhost", 0, is_master=True,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=300))
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(store.port),
                   WORLD_SIZE=str(world), TORCHELASTIC_USE_AGENT_STORE="True")
        init = "env"
    procs = []
    for r in range(world):
        e = dict(env, RANK=str(r), LOCAL_RANK=str(r)) if env_init else env
        procs.append(subprocess.Popen(
            [sys.executable, worker, suite, str(r), str(world), init,
             out_dir], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return suite, world, out_dir, procs, store


def _tails(procs, logs, lines=40) -> str:
    """Every rank's exit code and the last ``lines`` lines of its log."""
    return "\n".join(
        f"--- rank {r} (exit {p.returncode}):\n"
        + "\n".join((log or "").splitlines()[-lines:])
        for r, (p, log) in enumerate(zip(procs, logs)))


def finish_world(handle, timeout: float = 240.0) -> dict:
    """Wait for a world of :func:`start_world` and return {case: [per-rank
    result dicts]} ({case: traceback} where a rank raised).  A world still
    running ``timeout`` seconds after this call is killed and fails the
    test; a failure shows every rank's last log lines."""
    import signal
    import subprocess
    import time

    import pytest

    suite, world, out_dir, procs, _store = handle
    deadline = time.monotonic() + timeout
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            # each rank still running prints its Python stack
            # (torch_dist_worker.py registers SIGUSR1), then is killed
            for q in procs:
                if q.poll() is None:
                    q.send_signal(signal.SIGUSR1)
            time.sleep(2.0)
            for q in procs:
                q.kill()
            logs = [q.communicate()[0] for q in procs]
            done = sorted(f for f in os.listdir(out_dir)
                          if f.endswith((".npz", ".err")))
            pytest.fail(f"{suite}: a rank hung past {timeout} s (cases "
                        f"written: {done})\n" + _tails(procs, logs))
    names = sorted({f.rsplit("_r", 1)[0] for f in os.listdir(out_dir)
                    if f.endswith((".npz", ".err")) and "_r" in f})
    out = {}
    for name in names:
        errs = [os.path.join(out_dir, f"{name}_r{r}.err") for r in range(world)]
        errs = [open(e).read() for e in errs if os.path.exists(e)]
        if errs:
            out[name] = errs[0]
            continue
        out[name] = []
        for r in range(world):
            with np.load(os.path.join(out_dir, f"{name}_r{r}.npz")) as z:
                out[name].append({k: z[k] for k in z.files})
    if (any(p.returncode != 0 for p in procs)
            and not any(isinstance(v, str) for v in out.values())):
        pytest.fail(f"{suite}: a rank exited non-zero\n"
                    + _tails(procs, logs))
    return out


def spawn_world(suite: str, world: int, out_dir, timeout: float = 240.0,
                env_init: bool = False) -> dict:
    """:func:`start_world` then :func:`finish_world`."""
    return finish_world(start_world(suite, world, out_dir, env_init), timeout)


def case(results: dict, name: str) -> list:
    """The per-rank results of one case, or a failure with its traceback."""
    import pytest
    r = results[name]
    if isinstance(r, str):
        pytest.fail(f"case {name} raised on a rank:\n{r}")
    return r


def assert_ranks_agree(ranks: list, keys=("newton", "cg", "rnorm")):
    """Every rank's counts and residual norms bit for bit equal."""
    for k in keys:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
