"""The port's multi-process run protocol (shakti_tpu_torch/utils/multihost.py,
api/run.py's distributed path, cli.py's --dist) on 2 gloo ranks joined
through torchrun's variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
LOCAL_RANK), in float64 on the 10x10 slab (8 steps, saves every 4):

- api/run.solve with md.distributed: rank 0 writes the results files and
  holds the histories (rank 1 none), within 1e-8 of the single-process run;
- per-window pulls (SHAKTI_RUN_GROUP=1) bitwise equal to grouped ones;
- solve returning on every rank only once rank 0 has written its files
  (rank 0's checkpoint writes held back a second);
- 6 steps then --resume to 8 equal to the uninterrupted run;
- seasonal forcing within 1e-8 of the single-process run;
- a resume from the checkpoint.npz of the JAX package's distributed solve
  (6 steps on 8 devices) within 1e-8 of the port's uninterrupted run;
- cli.main([... '--dist']) on both ranks, then the same results directory
  again: both ranks refuse it (rank 0's verdict is broadcast);
- init_multihost without the launcher's variables and with only part of
  them; every rank's final state and counts bit for bit equal;
- init_multihost's explicit route (coordinator=, num_processes=,
  process_id=: the JAX package's arguments, by keyword) forms a 2-rank gloo
  world over tcp:// on a store the test hosts, without any of torchrun's
  variables; a call in the JAX package's positional order raises TypeError
  and never takes the address for a device.
"""

import datetime
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import setups.setup_slab as jslab
from shakti_tpu.api.run import solve as jsolve
from shakti_tpu_torch.api.run import solve as tsolve
from shakti_tpu_torch.setups import setup_slab as tslab
from shakti_tpu_torch.utils import multihost
from tests.torch_parity import case, finish_world, start_world

KEYS = ("N", "b", "qx", "qy")
CLI_SETUP = """\
import os
import torch
from shakti_tpu_torch.setups import setup_slab


def initialize():
    md = setup_slab.initialize(nx=10, ny=10, days=2.0, nt_per_day=4,
                               results_name=os.path.join({out!r}, "res_cli"))
    md.dtype = torch.float64
    return md
"""


def _single(seasonal=None):
    md = tslab.initialize(nx=10, ny=10, days=2.0, nt_per_day=4)
    md.device, md.dtype = "cpu", torch.float64
    md.seasonal_inputs = seasonal
    return tsolve(md, progress=False)["history"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    with open(out / "cli_setup.py", "w") as f:
        f.write(CLI_SETUP.format(out=str(out)))
    # the JAX package's distributed solve, stopped after 6 of 8 steps
    md = jslab.initialize(nx=10, ny=10, days=2.0, nt_per_day=4,
                          results_name=str(out / "res_jax"))
    md.distributed = True
    md.timesteps = md.timesteps[:6]
    jsolve(md, progress=False)
    h = start_world("multihost", 2, out, env_init=True)
    ref = {"plain": _single(), "seasonal": _single((0.8, 86400.0, 0.3))}
    return finish_world(h), ref, out


def _ranks(world, name):
    ranks = case(world[0], name)
    for r in ranks[1:]:
        for k in ("N", "b", "newton_total", "cg_total", "steps"):
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    assert not ranks[0]["history_none"] and ranks[1]["history_none"]
    return ranks[0]


def test_solve_writes_rank0_files_matching_single(world):
    r = _ranks(world, "solve")
    ref, out = world[1]["plain"], world[2]
    files = set(os.listdir(out / "res_solve"))
    assert {"t.npy", "nodes_x.npy", "nodes_y.npy", "log.csv",
            "checkpoint.npz", "run_meta.json", "setup_slab.py",
            *(f"{k}.npy" for k in KEYS)} <= files
    assert int(r["steps"]) == 8
    for k in KEYS:
        on_disk = np.load(out / "res_solve" / f"{k}.npy")
        np.testing.assert_array_equal(on_disk, r[f"hist_{k}"])
        np.testing.assert_allclose(on_disk, ref[k], rtol=1e-8,
                                   atol=1e-8 * np.abs(ref[k]).max())


def test_grouped_dispatch_bitwise(world):
    a, b = _ranks(world, "solve"), _ranks(world, "group")
    for k in KEYS:
        np.testing.assert_array_equal(a[f"hist_{k}"], b[f"hist_{k}"])


def test_solve_returns_once_rank0_has_written(world):
    for r in case(world[0], "written"):
        assert int(r["next_step"]) == 8


def test_resume_equals_uninterrupted(world):
    a, b = _ranks(world, "solve"), _ranks(world, "resume")
    assert int(b["steps"]) == 2
    for k in KEYS:
        np.testing.assert_array_equal(a[f"hist_{k}"], b[f"hist_{k}"])
    np.testing.assert_array_equal(a["N"], b["N"])


def test_seasonal_forcing_matches_single(world):
    r = _ranks(world, "seasonal")
    ref = world[1]["seasonal"]
    for k in KEYS:
        np.testing.assert_allclose(r[f"hist_{k}"], ref[k], rtol=1e-8,
                                   atol=1e-8 * np.abs(ref[k]).max())


def test_resume_from_jax_distributed_checkpoint(world):
    r, ref = _ranks(world, "jax_resume"), _ranks(world, "solve")
    assert int(r["steps"]) == 2
    for k in KEYS:
        np.testing.assert_allclose(r[f"hist_{k}"][-1], ref[f"hist_{k}"][-1],
                                   rtol=1e-8,
                                   atol=1e-8 * np.abs(ref[f"hist_{k}"]).max())


def test_cli_dist_and_refusal_on_both_ranks(world):
    ranks = case(world[0], "cli")
    out = world[2]
    for r in ranks:
        assert int(r["rc"]) == 0
        assert "already exists" in str(r["refused"])
    ref = _ranks(world, "solve")
    np.testing.assert_array_equal(np.load(out / "res_cli" / "N.npy"),
                                  ref["hist_N"])


def test_init_multihost_without_launcher(monkeypatch):
    for k in multihost.ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_multihost(device="cpu") == (1, 0, True)
    assert multihost.world() == (1, 0)
    x = torch.arange(3.0)
    np.testing.assert_array_equal(multihost.to_host(x), x.numpy())
    assert multihost.broadcast_flag(False) is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(RuntimeError, match="missing"):
        multihost.init_multihost(device="cpu")


_EXPLICIT = """
import sys
import torch
import torch.distributed as dist
from shakti_tpu_torch.utils import multihost
coordinator, rank = sys.argv[1], int(sys.argv[2])
got = multihost.init_multihost(coordinator=coordinator, num_processes=2,
                               process_id=rank, device="cpu")
t = torch.tensor([rank + 1.0])
dist.all_reduce(t)
print("GOT", *got, multihost.world(), float(t))
dist.destroy_process_group()
"""


def test_init_multihost_explicit_route():
    """Two ranks join through coordinator=, num_processes=, process_id=
    alone: the store is this test's (bound on a port the system picked, as
    torchrun's agent hosts it), every rank a client of it."""
    from torch.distributed import TCPStore
    store = TCPStore("localhost", 0, is_master=True, wait_for_workers=False,
                     timeout=datetime.timedelta(seconds=120))
    env = {k: v for k, v in os.environ.items() if k not in multihost.ENV}
    env.update(TORCHELASTIC_USE_AGENT_STORE="True", OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _EXPLICIT, f"localhost:{store.port}", str(r)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert out.strip().splitlines()[-1] == \
            f"GOT 2 {r} {r == 0} (2, {r}) 3.0", out


def test_init_multihost_jax_positional_order_raises(monkeypatch):
    for k in multihost.ENV:
        monkeypatch.delenv(k, raising=False)
    for args in (("localhost:29500", 2, 0), ("localhost:29500",), ("cpu",)):
        with pytest.raises(TypeError):
            multihost.init_multihost(*args)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.init_multihost(coordinator="localhost:29500", device="cpu")
