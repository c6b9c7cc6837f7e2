"""The block-ELL operator matvec: the CUDA kernel csrc/bell_spmv.cu and its
plain twins.

Replaces shakti_tpu/ops/spmv_pallas.py:bell_matvec_pallas (the TPU's Pallas
kernel) together with the operator epilogue around it
(shakti_tpu/physics/residual.py:operator_from_values, and the diagonal
floor ``matvec0(x) + extra * x`` of shakti_tpu/solve/newton.py):

    xm = where(d, 0, x);  y0 = where(d, x, A xm);  y = y0 + extra * x

:func:`bell_operator_fn` checks an operator once and returns its matvec.
On CUDA tensors each call is one launch of the kernel (or an error), which
reads only the operator's structural nonzeros through the mesh's scalar-ELL
view (``mesh.bell_nz_pos``, fem/bell.structural_view, whose positions name
their columns through ``mesh.bell_nbr``: :func:`view_columns`); see the note
in the source.  On CPU tensors it computes
:func:`bell_operator_plain`, the dense block-ELL product of
shakti_tpu/fem/bell.py:bell_matvec with the epilogue composed in PyTorch.
:func:`bell_operator_structural` is the kernel's mirror over the view, the
same operations in the same order; tests and chip_smoke.py compare the
kernel with it bit for bit.

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

from shakti_tpu_torch.fem.ops import fixed_sum

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "bell_spmv.cu"
_ROOT = Path(__file__).resolve().parents[2]

# the kernel's compile-time maximum of structural entries per row (kWMax in
# the source, which refuses a launch with more)
W_MAX = 16


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
        fn.argtypes = [p, p, p, i, i, i, i, p, p, p, p, i, p]
        fn.restype = i
    log = log_path.read_text() if log_path.exists() else ""
    return {"lib": lib, "path": str(path), "seconds": seconds, "log": log}


def _check(vals, mesh, dirichlet, extra):
    """Shapes, dtypes, devices and layout of one operator (run once per
    operator, not per matvec)."""
    NB, KB = mesh.bell_nbr.shape
    B, n = mesh.bell_B, mesh.n_nodes
    if tuple(vals.shape) != (NB, KB, B, B):
        raise ValueError(f"vals must be (NB, KB, B, B) = {(NB, KB, B, B)}, "
                         f"got {tuple(vals.shape)}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"vals must be float32 or float64, got {vals.dtype}")
    pos, nbr = mesh.bell_nz_pos, mesh.bell_nbr
    if (pos.dtype != torch.int32 or pos.dim() != 2 or pos.shape[1] != n
            or not 1 <= pos.shape[0] <= W_MAX):
        raise ValueError(f"the structural view must be int32 (W, {n}) with "
                         f"1 <= W <= {W_MAX}, got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if nbr.dtype != torch.int64:
        raise ValueError(f"nbr must be int64, got {nbr.dtype}")
    if dirichlet is not None and (dirichlet.dtype != torch.bool
                                  or tuple(dirichlet.shape) != (n,)):
        raise ValueError(f"dirichlet must be bool ({n},), got "
                         f"{dirichlet.dtype} {tuple(dirichlet.shape)}")
    if extra is not None and (extra.dtype != vals.dtype
                              or tuple(extra.shape) != (n,)):
        raise ValueError(f"extra must be {vals.dtype} ({n},), got "
                         f"{extra.dtype} {tuple(extra.shape)}")
    tensors = [t for t in (vals, pos, nbr, dirichlet, extra) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("vals, the structural view, dirichlet and extra on "
                         f"different devices: {[t.device for t in tensors]}")
    if vals.device.type == "cuda" and not all(t.is_contiguous()
                                              for t in tensors):
        raise ValueError("vals, the structural view, dirichlet and extra must "
                         "be contiguous")


def _compose(product, x, dirichlet, extra):
    """The operator epilogue around y = A xm, as PyTorch ops."""
    xm = x if dirichlet is None else torch.where(dirichlet, 0.0, x)
    y = product(xm)
    if dirichlet is not None:
        y = torch.where(dirichlet, x, y)
    return y if extra is None else y + extra * x


def bell_matvec_plain(vals, nbr, x, n: int):
    """y = A x in plain PyTorch: row-block gather + batched contraction
    (shakti_tpu/fem/bell.py:bell_matvec)."""
    NB, KB, B, _ = vals.shape
    xb = torch.nn.functional.pad(x, (0, NB * B - n)).reshape(NB, B)
    y = torch.einsum("nkij,nkj->ni", vals, xb[nbr])
    return y.reshape(-1)[:n]


def bell_operator_plain(vals, mesh, x, dirichlet=None, extra=None):
    """The operator in plain PyTorch over the dense blocks: what the CPU
    path computes."""
    return _compose(
        lambda xm: bell_matvec_plain(vals, mesh.bell_nbr, xm, mesh.n_nodes),
        x, dirichlet, extra)


def view_columns(nz_pos, nbr, B: int):
    """Column node id of each entry of the view: the flat position
    ((r KB + k) B + i) B + j names column ``nbr[r, k] * B + j`` (what the
    kernel works out); padding: the row itself."""
    pos = nz_pos.long()
    p = pos.clamp_min(0)
    col = nbr.reshape(-1)[p // (B * B)] * B + p % B
    rows = torch.arange(pos.shape[1], device=pos.device).expand_as(pos)
    return torch.where(pos >= 0, col, rows)


def structural_matvec_plain(vals, nz_pos, nbr, x):
    """y = A x over the structural view: gather, multiply, and sum the W
    terms of each row in order from the first (the kernel's order; a
    padding term is 0 * 0)."""
    valid = nz_pos >= 0
    v = torch.where(valid, vals.reshape(-1)[nz_pos.long().clamp_min(0)], 0.0)
    xc = torch.where(valid, x[view_columns(nz_pos, nbr, vals.shape[-1])], 0.0)
    return fixed_sum(v * xc, 0)


def bell_operator_structural(vals, mesh, x, dirichlet=None, extra=None):
    """The kernel's plain mirror: the operator over the structural view."""
    return _compose(
        lambda xm: structural_matvec_plain(vals, mesh.bell_nz_pos,
                                           mesh.bell_nbr, xm),
        x, dirichlet, extra)


# kernel launches since the last reset: _Launcher adds one per launch
# (chip_smoke.py reads it to show the main path went through the kernel)
launches = 0


class _Launcher:
    """One checked operator on the card: each call is a ``torch.empty`` and
    one kernel launch.  Holds the tensors whose pointers it passes."""

    def __init__(self, vals, mesh, dirichlet, extra):
        if vals.device.type != "cuda":
            raise ValueError(f"bell_operator: unsupported device {vals.device}")
        if mesh.bell_B & (mesh.bell_B - 1):
            raise ValueError(f"the kernel takes a block edge B that is a power "
                             f"of two, got {mesh.bell_B}")
        lib = build()["lib"]
        self.fn = (lib.bell_spmv_f32 if vals.dtype == torch.float32
                   else lib.bell_spmv_f64)
        pos, nbr = mesh.bell_nz_pos, mesh.bell_nbr
        self.keep = (vals, pos, nbr, dirichlet, extra)
        self.n = mesh.n_nodes
        self.dtype, self.device = vals.dtype, vals.device
        self.index = vals.device.index
        self.args = (vals.data_ptr(), pos.data_ptr(), nbr.data_ptr(),
                     nbr.shape[1], mesh.bell_B, pos.shape[0], self.n)
        self.epilogue = (None if dirichlet is None else dirichlet.data_ptr(),
                         None if extra is None else extra.data_ptr())

    def __call__(self, x):
        global launches
        _check_x(x, self.n, self.dtype, self.device)
        y = torch.empty_like(x)
        # the current stream's handle, without building a torch.cuda.Stream
        stream = torch._C._cuda_getCurrentRawStream(self.index)
        err = self.fn(*self.args, x.data_ptr(), *self.epilogue, y.data_ptr(),
                      self.index, stream)
        if err != 0:
            raise RuntimeError(f"bell_spmv launch failed: cudaError {err}")
        launches += 1
        return y


def _check_x(x, n, dtype, device):
    if (x.shape != (n,) or x.dtype != dtype or x.device != device
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous {dtype} ({n},) on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def bell_operator_fn(vals, mesh, dirichlet=None, extra=None):
    """The operator's matvec ``x -> y`` for the block-ELL values ``vals``
    (NB, KB, B, B) on ``mesh``, with optional Dirichlet mask (bool (n,)) and
    diagonal increment ``extra`` (n,).  Checked here, once (each call checks
    only x's shape, type, device and layout).  CUDA tensors:
    the csrc/bell_spmv.cu kernel (or an error); CPU tensors:
    :func:`bell_operator_plain`."""
    _check(vals, mesh, dirichlet, extra)
    if vals.device.type == "cpu":
        return functools.partial(_cpu_operator, vals, mesh,
                                 dirichlet=dirichlet, extra=extra)
    return _Launcher(vals, mesh, dirichlet, extra)


def _cpu_operator(vals, mesh, x, dirichlet, extra):
    _check_x(x, mesh.n_nodes, vals.dtype, vals.device)
    return bell_operator_plain(vals, mesh, x, dirichlet, extra)


def bell_operator(vals, mesh, x, dirichlet=None, extra=None):
    """One matvec of the operator (:func:`bell_operator_fn` applied to x)."""
    return bell_operator_fn(vals, mesh, dirichlet, extra)(x)
