"""The port's setups, run layer and CLI against shakti_tpu's, its device
policy, and its independence from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import setups.setup_lake as jlake
import setups.setup_slab as jslab
from shakti_tpu_torch.setups import setup_lake as tlake
from shakti_tpu_torch.setups import setup_slab as tslab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = ("nodes", "cells", "z_b", "z_s", "G", "inputs", "b_init", "N_init",
          "q_init", "melt_init", "lake_bdry", "timesteps", "bounds")
SCALARS = ("N_bdry", "b_min", "nt_save", "nt_check", "outflow_on",
           "storage_on", "setup_name", "lake_name", "results_name", "operator")


@pytest.mark.parametrize("pair", [(jslab, tslab), (jlake, tlake)],
                         ids=["slab", "lake"])
def test_setup_twin_produces_identical_arrays(pair):
    jmod, tmod = pair
    jmd, tmd = jmod.initialize(), tmod.initialize()
    for k in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(tmd, k)),
                                      np.asarray(getattr(jmd, k)), err_msg=k)
    for k in SCALARS:
        assert getattr(tmd, k) == getattr(jmd, k), k
    np.testing.assert_array_equal(tmd.dirichlet_nodes(), jmd.dirichlet_nodes())
    assert tmd.dirichlet_nodes().size > 0
    assert tmd.dtype == torch.float32 and tmd.device == "cuda"


def _wrapper(path, pkg, rdir):
    mod = ("shakti_tpu_torch.setups.setup_slab" if pkg == "torch"
           else "setups.setup_slab")
    path.write_text(
        f"import {mod} as slab\n\n\ndef initialize():\n"
        f"    return slab.initialize(nx=6, ny=6, days=2.0, nt_per_day=4,\n"
        f"                           results_name={str(rdir)!r})\n")
    return str(path)


def test_cli_writes_the_jax_results_protocol(tmp_path, capsys):
    from shakti_tpu.cli import main as jmain
    from shakti_tpu_torch.cli import main as tmain
    jdir, tdir = tmp_path / "jax_run", tmp_path / "torch_run"
    assert jmain([_wrapper(tmp_path / "wj.py", "jax", jdir), "--quiet"]) == 0
    assert tmain([_wrapper(tmp_path / "wt.py", "torch", tdir), "--device",
                  "cpu", "--quiet"]) == 0
    jfiles, tfiles = set(os.listdir(jdir)), set(os.listdir(tdir))
    assert tfiles == jfiles
    assert "checkpoint.npz" in tfiles
    for k in ("t", "nodes_x", "nodes_y"):
        np.testing.assert_array_equal(np.load(tdir / f"{k}.npy"),
                                      np.load(jdir / f"{k}.npy"))
    for k in ("N", "b", "qx", "qy"):
        a, b = np.load(tdir / f"{k}.npy"), np.load(jdir / f"{k}.npy")
        assert a.shape == b.shape == (2, 49) and np.isfinite(a).all()
    # default float32 port vs the float64 reference, both in user order
    N_t, N_j = np.load(tdir / "N.npy"), np.load(jdir / "N.npy")
    assert np.abs(N_t - N_j).max() <= 1e-4 * np.abs(N_j).max()
    jlog = (jdir / "log.csv").read_text().splitlines()
    tlog = (tdir / "log.csv").read_text().splitlines()
    assert tlog[0] == jlog[0] == ("step,t,newton_mean,newton_max,cg_mean,"
                                  "rnorm_max,N_min")
    assert [r.split(",")[:2] for r in tlog[1:]] == \
        [r.split(",")[:2] for r in jlog[1:]]
    # a second run refuses the existing directory, like the reference
    with pytest.raises(FileExistsError):
        tmain([str(tmp_path / "wt.py"), "--device", "cpu", "--quiet"])


def test_bare_setup_name_resolves_to_the_port_first():
    """./setups/setup_slab.py (the JAX setup) exists too; the port's own
    setups directory wins."""
    from shakti_tpu_torch.cli import load_setup
    assert os.path.exists(os.path.join(REPO, "setups", "setup_slab.py"))
    assert load_setup("setup_slab") is tslab


def test_cuda_request_without_gpu_raises(monkeypatch, tmp_path):
    """--device cuda never falls back to the CPU."""
    from shakti_tpu_torch.cli import main as tmain
    from shakti_tpu_torch.utils.backend import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tmain([_wrapper(tmp_path / "w.py", "torch", tmp_path / "r")])
    md = tslab.initialize(nx=4, ny=4, days=1.0, nt_per_day=4)
    with pytest.raises(RuntimeError, match="cuda"):
        md.freeze()
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("what", ["operator", "mg", "differentiable"])
def test_unported_options_raise(what):
    """What stays unported raises NotImplementedError naming its ROADMAP
    item; an unknown operator name raises ValueError."""
    import dataclasses
    md = tslab.initialize(nx=4, ny=4, days=1.0, nt_per_day=4)
    md.device, md.dtype = "cpu", torch.float64
    if what == "operator":
        md.operator = "csr"
        with pytest.raises(ValueError, match="md.operator"):
            md.solve(progress=False)
        return
    md.solver = dataclasses.replace(md.solver, **(
        {"precond": "mg"} if what == "mg" else {"differentiable": True}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        md.solve(progress=False)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import shakti_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    shakti_tpu_torch.__path__, 'shakti_tpu_torch.')\n"
        "    if not m.name.endswith('__main__')]\n"
        "for m in mods + ['tests.torch_golden_cases', 'chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20
