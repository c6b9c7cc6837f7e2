"""Block-ELL SpMV: the CUDA kernel csrc/bell_spmv.cu and its plain twin.

Replaces shakti_tpu/ops/spmv_pallas.py:bell_matvec_pallas (the TPU's
Pallas kernel).  :func:`bell_matvec` launches the kernel on CUDA tensors and
raises if it cannot; on CPU tensors it computes :func:`bell_matvec_plain`,
the same function as shakti_tpu/fem/bell.py:bell_matvec (row-block gather
plus one batched contraction).  The kernel is bound by memory bandwidth: it
streams ``vals`` once per call (see the note in the source).

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles
the source into ``build/shakti_tpu_torch/`` at the repository root (an
installed package: the per-user cache, see :func:`_build_dir`), under a
name keyed by the source's hash (an edited source rebuilds).  The library
has a plain C interface and is loaded with ctypes.  A missing ``nvcc`` or a
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "bell_spmv.cu"
_ROOT = Path(__file__).resolve().parents[2]


def _build_dir() -> Path:
    """``build/shakti_tpu_torch/`` in a source checkout; for an installed
    package, a per-user cache ($XDG_CACHE_HOME or ~/.cache)."""
    if (_ROOT / "pyproject.toml").exists():
        return _ROOT / "build" / "shakti_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "shakti_tpu_torch"


BUILD_DIR = _build_dir()
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/"
                       "bin): the block-ELL SpMV kernel is built from "
                       f"{_SRC} at first use and has no fallback on CUDA")


@functools.cache
def build() -> dict:
    """Compile (if needed) and load the kernel library.  Returns
    dict(lib, path, seconds, log); ``seconds`` is 0.0 when a library for
    this source hash was already built."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libbell_spmv_{tag}.so"
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}"
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed (exit {r.returncode}) building "
                               f"{_SRC}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.bell_spmv_f32, lib.bell_spmv_f64):
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = i
    log = log_path.read_text() if log_path.exists() else ""
    return {"lib": lib, "path": str(path), "seconds": seconds, "log": log}


def _check(vals, nbr, x, n: int):
    if vals.dim() != 4 or vals.shape[2] != vals.shape[3]:
        raise ValueError(f"vals must be (NB, KB, B, B), got {tuple(vals.shape)}")
    NB, KB, B, _ = vals.shape
    if tuple(nbr.shape) != (NB, KB) or nbr.dtype != torch.int64:
        raise ValueError(f"nbr must be int64 ({NB}, {KB}), got "
                         f"{nbr.dtype} {tuple(nbr.shape)}")
    if x.dim() != 1 or x.shape[0] != n or not 0 < n <= NB * B:
        raise ValueError(f"x must be ({n},) with 0 < n <= NB*B = {NB * B}, "
                         f"got {tuple(x.shape)}")
    if vals.dtype not in (torch.float32, torch.float64) or x.dtype != vals.dtype:
        raise ValueError(f"vals/x must share float32 or float64, got "
                         f"{vals.dtype}/{x.dtype}")
    if not (vals.device == nbr.device == x.device):
        raise ValueError(f"vals/nbr/x on different devices: {vals.device}, "
                         f"{nbr.device}, {x.device}")
    if B % 32:
        raise ValueError(f"block edge B={B} must be a multiple of 32 "
                         "(one warp strides a block row)")


def bell_matvec_plain(vals, nbr, x, n: int):
    """y = A x in plain PyTorch: row-block gather + batched contraction."""
    NB, KB, B, _ = vals.shape
    xb = torch.nn.functional.pad(x, (0, NB * B - n)).reshape(NB, B)
    y = torch.einsum("nkij,nkj->ni", vals, xb[nbr])
    return y.reshape(-1)[:n]


def bell_matvec(vals, nbr, x, n: int):
    """y = A x with A in block-ELL form (vals (NB, KB, B, B), nbr (NB, KB)
    int64, x (n,)).  CUDA tensors: the csrc/bell_spmv.cu kernel (or an
    error); CPU tensors: :func:`bell_matvec_plain`."""
    _check(vals, nbr, x, n)
    if x.device.type == "cpu":
        return bell_matvec_plain(vals, nbr, x, n)
    if x.device.type != "cuda":
        raise ValueError(f"bell_matvec: unsupported device {x.device}")
    if not (vals.is_contiguous() and nbr.is_contiguous() and x.is_contiguous()):
        raise ValueError("bell_matvec: vals, nbr and x must be contiguous")
    lib = build()["lib"]
    NB, KB, B, _ = vals.shape
    fn = lib.bell_spmv_f32 if x.dtype == torch.float32 else lib.bell_spmv_f64
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(vals.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(),
                 KB, B, n, stream)
    if err != 0:
        raise RuntimeError(f"bell_spmv launch failed: cudaError {err}")
    bell_matvec.launches += 1
    return y


# kernel launches since the last reset (chip_smoke.py reads it to show the
# main path went through the kernel)
bell_matvec.launches = 0
