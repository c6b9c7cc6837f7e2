"""The block-ELL SpMV wrapper (shakti_tpu_torch/ops/spmv_cuda.py) on the CPU,
where it computes its plain version: against shakti_tpu's XLA block-ELL
matvec (f64, 1e-13) and the Pallas kernel in interpret mode (f32, as
tests/test_pallas.py:27 checks it).  The CUDA kernel itself is checked
against the plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.fem import bell as jbell
from shakti_tpu.mesh.generate import rectangle_mesh
from shakti_tpu.mesh.mesh import build_mesh as jbuild
from shakti_tpu.ops.spmv_pallas import bell_matvec_pallas
from shakti_tpu_torch.ops import spmv_cuda
from shakti_tpu_torch.ops.spmv_cuda import bell_matvec, bell_matvec_plain


def _operator(nx, ny, B, dtype, seed=0):
    nodes, cells = rectangle_mesh(nx, ny, 1.0, 1.0, jitter=0.2, seed=8)
    n = nodes.shape[0]
    m = jbuild(nodes, cells, dtype=jnp.float64, operator="bell", bell_block=B)
    NB, KB = m.bell_nbr.shape
    rng = np.random.default_rng(seed)
    J = jnp.asarray(rng.normal(size=(m.n_cells, 3, 3)), dtype)
    vals = jbell.bell_from_elements(J, m.bell_map, NB, KB, B)
    x = jnp.asarray(rng.normal(size=n), dtype)
    return vals, m.bell_nbr, x, n


def _torch(vals, nbr, x):
    return (torch.as_tensor(np.array(vals)),
            torch.as_tensor(np.array(nbr, np.int64)), torch.as_tensor(np.array(x)))


# (nx, ny, B): n = (nx+1)(ny+1) is ragged against B in every case
@pytest.mark.parametrize("nx,ny,B", [(12, 12, 128), (9, 7, 32), (20, 14, 64)])
def test_plain_matches_jax_bell_f64(nx, ny, B):
    vals, nbr, x, n = _operator(nx, ny, B, jnp.float64)
    assert n % B != 0
    ref = np.asarray(jbell.bell_matvec(vals, nbr, x, n))
    got = bell_matvec(*_torch(vals, nbr, x), n)
    assert got.shape == (n,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13,
                               atol=1e-13 * np.abs(ref).max())
    assert torch.equal(got, bell_matvec_plain(*_torch(vals, nbr, x), n))


def test_plain_matches_pallas_interpret_f32():
    vals, nbr, x, n = _operator(12, 12, 128, jnp.float32)
    ref = np.asarray(bell_matvec_pallas(vals, nbr, x, n, interpret=True))
    got = bell_matvec(*_torch(vals, nbr, x), n)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=1e-6)


def test_cpu_tensors_do_not_count_launches():
    vals, nbr, x, n = _operator(9, 7, 32, jnp.float64)
    before = spmv_cuda.bell_matvec.launches
    for _ in range(3):
        bell_matvec(*_torch(vals, nbr, x), n)
    assert spmv_cuda.bell_matvec.launches == before == 0


@pytest.mark.parametrize("bad", ["dtype", "nbr_dtype", "n", "B", "mixed"])
def test_wrapper_rejects_malformed_input(bad):
    vals, nbr, x = _torch(*_operator(9, 7, 32, jnp.float64)[:3])
    n = x.shape[0]
    if bad == "dtype":
        x = x.float()
    elif bad == "nbr_dtype":
        nbr = nbr.int()
    elif bad == "n":
        n = vals.shape[0] * vals.shape[2] + 1
    elif bad == "B":
        vals, x, n = vals[:, :, :16, :16].contiguous(), x[:40], 40
    else:
        vals = vals.float()
    with pytest.raises(ValueError):
        bell_matvec(vals, nbr, x, n)


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


def test_build_dir_checkout_or_user_cache(monkeypatch, tmp_path):
    """A source checkout builds under its build/; an installed package
    (no pyproject.toml beside it) under $XDG_CACHE_HOME."""
    assert spmv_cuda._build_dir() == spmv_cuda._ROOT / "build" / "shakti_tpu_torch"
    monkeypatch.setattr(spmv_cuda, "_ROOT", tmp_path / "site-packages")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert spmv_cuda._build_dir() == tmp_path / "cache" / "shakti_tpu_torch"
