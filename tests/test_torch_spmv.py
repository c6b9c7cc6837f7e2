"""The block-ELL operator wrapper (shakti_tpu_torch/ops/spmv_cuda.py) on the
CPU, where it computes its plain version: against shakti_tpu's XLA block-ELL
matvec (f64, 1e-13) and the Pallas kernel in interpret mode (f32, as
tests/test_pallas.py:27 checks it).  The CUDA kernel itself is checked
against its plain twins on the card by chip_smoke.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.fem import bell as jbell
from shakti_tpu.mesh.generate import rectangle_mesh
from shakti_tpu.mesh.mesh import build_mesh as jbuild
from shakti_tpu.ops.spmv_pallas import bell_matvec_pallas
from shakti_tpu_torch.mesh.mesh import build_mesh as tbuild
from shakti_tpu_torch.ops import spmv_cuda
from shakti_tpu_torch.ops.spmv_cuda import bell_operator, bell_operator_plain
from tests import torch_parity  # noqa: F401  (pins torch's threads)


def _operator(nx, ny, B, dtype, seed=0):
    """Seeded folded values on a jittered rectangle, with the JAX and the
    port mesh of the same nodes."""
    nodes, cells = rectangle_mesh(nx, ny, 1.0, 1.0, jitter=0.2, seed=8)
    n = nodes.shape[0]
    m = jbuild(nodes, cells, dtype=jnp.float64, operator="bell", bell_block=B)
    tm = tbuild(nodes, cells, dtype=torch.float64, bell_block=B)
    NB, KB = m.bell_nbr.shape
    rng = np.random.default_rng(seed)
    J = jnp.asarray(rng.normal(size=(m.n_cells, 3, 3)), dtype)
    vals = jbell.bell_from_elements(J, m.bell_map, NB, KB, B)
    x = jnp.asarray(rng.normal(size=n), dtype)
    return vals, m.bell_nbr, x, n, tm


def _torch(vals, x):
    return torch.as_tensor(np.array(vals)), torch.as_tensor(np.array(x))


# (nx, ny, B): n = (nx+1)(ny+1) is ragged against B in every case
@pytest.mark.parametrize("nx,ny,B", [(12, 12, 128), (9, 7, 32), (20, 14, 64)])
def test_plain_matches_jax_bell_f64(nx, ny, B):
    vals, nbr, x, n, tm = _operator(nx, ny, B, jnp.float64)
    assert n % B != 0
    ref = np.asarray(jbell.bell_matvec(vals, nbr, x, n))
    tv, tx = _torch(vals, x)
    got = bell_operator(tv, tm, tx)
    assert got.shape == (n,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13,
                               atol=1e-13 * np.abs(ref).max())
    assert torch.equal(got, bell_operator_plain(tv, tm, tx))


def test_plain_matches_pallas_interpret_f32():
    vals, nbr, x, n, tm = _operator(12, 12, 128, jnp.float32)
    ref = np.asarray(bell_matvec_pallas(vals, nbr, x, n, interpret=True))
    tv, tx = _torch(vals, x)
    got = bell_operator(tv, tm, tx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=1e-6)


def test_cpu_tensors_do_not_count_launches():
    vals, _, x, _, tm = _operator(9, 7, 32, jnp.float64)
    tv, tx = _torch(vals, x)
    before = dict(spmv_cuda.launches)
    matvec = spmv_cuda.bell_operator_fn(tv, tm)
    batched = spmv_cuda.bell_operator_batched_fn(tv[None].repeat(2, 1, 1, 1, 1),
                                                 tm)
    for _ in range(3):
        matvec(tx)
        batched(tx[None].repeat(2, 1))
    assert spmv_cuda.launches == before == {"bell_spmv": 0, "ell_spmv": 0,
                                            "bell_spmv_batched": 0}


@pytest.mark.parametrize("bad", ["dtype", "nbr_dtype", "view_dtype", "n", "B",
                                 "mixed"])
def test_wrapper_rejects_malformed_input(bad):
    vals, _, x, _, tm = _operator(9, 7, 32, jnp.float64)
    vals, x = _torch(vals, x)
    if bad == "dtype":
        x = x.float()
    elif bad == "nbr_dtype":
        tm = dataclasses.replace(tm, bell_nbr=tm.bell_nbr.int())
    elif bad == "view_dtype":
        tm = dataclasses.replace(tm, bell_nz_pos=tm.bell_nz_pos.long())
    elif bad == "n":
        x = x[:-1]
    elif bad == "B":
        vals = vals[:, :, :16, :16].contiguous()
    else:
        vals = vals.float()
    with pytest.raises(ValueError):
        bell_operator(vals, tm, x)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc anywhere: the build raises (there is no CUDA fallback)."""
    monkeypatch.setattr(spmv_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(spmv_cuda, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        spmv_cuda.build.__wrapped__()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'bell_spmv.cu(1): error: boom' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(spmv_cuda, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(spmv_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)exit 2.*error: boom"):
        spmv_cuda.build.__wrapped__()
    assert not list((tmp_path / "build").glob("*.so"))


def test_each_kernel_builds_from_its_own_source(monkeypatch, tmp_path):
    """One nvcc per source: ell_spmv builds csrc/ell_spmv.cu into its own
    library (a failed build names that source)."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"$@\" >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(spmv_cuda, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(spmv_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)ell_spmv.cu.*libell_spmv_"):
        spmv_cuda.build.__wrapped__("ell_spmv")
    assert set(spmv_cuda.KERNELS) == {"bell_spmv", "ell_spmv"}
    # the member-batched entry point lives in bell_spmv's library
    assert {lib for lib, _ in spmv_cuda.BATCHED.values()} <= set(spmv_cuda.KERNELS)
    assert spmv_cuda.launches.keys() == {*spmv_cuda.KERNELS, *spmv_cuda.BATCHED}


def test_build_dir_checkout_or_user_cache(monkeypatch, tmp_path):
    """A source checkout builds under its build/; an installed package
    (no pyproject.toml beside it) under $XDG_CACHE_HOME."""
    assert spmv_cuda._build_dir() == spmv_cuda._ROOT / "build" / "shakti_tpu_torch"
    monkeypatch.setattr(spmv_cuda, "_ROOT", tmp_path / "site-packages")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert spmv_cuda._build_dir() == tmp_path / "cache" / "shakti_tpu_torch"
