"""The operator matvecs on the card: the CUDA kernels csrc/bell_spmv.cu and
csrc/ell_spmv.cu, and their plain twins.

Each computes an operator matvec together with the operator epilogue around
it (shakti_tpu/physics/residual.py:operator_from_values, and the diagonal
floor ``matvec0(x) + extra * x`` of shakti_tpu/solve/newton.py):

    xm = where(d, 0, x);  y0 = where(d, x, A xm);  y = y0 + extra * x

- **bell_spmv** replaces shakti_tpu/ops/spmv_pallas.py:bell_matvec_pallas
  (the TPU's Pallas kernel), A in block-ELL.  :func:`bell_operator_fn`
  checks an operator once and returns its matvec.  On CUDA tensors each
  call is one launch, which reads only the structural nonzeros through the
  mesh's view (``mesh.bell_nz_pos``, fem/bell.structural_view, whose
  positions name their columns through ``mesh.bell_nbr``:
  :func:`view_columns`).  On CPU tensors it computes
  :func:`bell_operator_plain`, the dense block-ELL product of
  shakti_tpu/fem/bell.py:bell_matvec with the epilogue composed in PyTorch.
  :func:`bell_operator_structural` is the kernel's mirror over the view.
- **ell_spmv** serves the scalar-ELL and the block-CSR operator, which the
  JAX package computes in XLA (no TPU kernel).  Both store their structural
  values alone, ``svals`` (W, n) with columns ``mesh.nz_col`` (fem/ell.py).
  :func:`ell_operator_fn`: on CUDA tensors one launch reading svals and
  nz_col at m * n + i; on CPU tensors :func:`ell_operator_plain`, the same
  terms in the same order as PyTorch ops (:func:`structural_matvec` with
  the epilogue composed), which is also the kernel's mirror.
  :func:`ell_operator_dense` is the second yardstick: the JAX-layout
  product (fem/ell.ell_matvec, fem/bcsr.bcsr_matvec) after fem/ell.to_dense.

The mirrors do the kernels' operations in the kernels' order, so tests and
chip_smoke.py compare each kernel with its mirror bit for bit.

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles
each source into its own library under ``build/shakti_tpu_torch/`` at the
repository root (an installed package: the per-user cache, see
:func:`_build_dir`), named by the source's hash (an edited source rebuilds).
The libraries have a plain C interface and load with ctypes.  A missing
``nvcc`` or a failed build raises with the compiler's output.
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

from shakti_tpu_torch.fem.bcsr import bcsr_matvec
from shakti_tpu_torch.fem.ell import ell_matvec, to_dense
from shakti_tpu_torch.fem.ops import fixed_sum

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]

# the kernels' compile-time maximum of structural entries per row (kWMax in
# the sources, which refuse a launch with more)
W_MAX = 16

_p, _i = ctypes.c_void_p, ctypes.c_int
# C signature of each library's f32/f64 entry points
KERNELS = {
    "bell_spmv": [_p, _p, _p, _i, _i, _i, _i, _p, _p, _p, _p, _i, _p],
    "ell_spmv": [_p, _p, _i, _i, _p, _p, _p, _p, _i, _p],
}


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
                       "bin): the SpMV kernels are built from "
                       f"{_CSRC} at first use and have no fallback on CUDA")


@functools.cache
def build(name: str = "bell_spmv") -> dict:
    """Compile (if needed) and load the library of kernel ``name`` (a key of
    :data:`KERNELS`, source csrc/<name>.cu).  Returns dict(lib, path,
    seconds, log); ``seconds`` is 0.0 when a library for this source hash
    was already built.  Different kernels may build in parallel threads."""
    src_path = _CSRC / f"{name}.cu"
    src = src_path.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"lib{name}_{tag}.so"
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src_path)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}"
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed (exit {r.returncode}) building "
                               f"{src_path}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for fn in (getattr(lib, f"{name}_f32"), getattr(lib, f"{name}_f64")):
        fn.argtypes = KERNELS[name]
        fn.restype = _i
    log = log_path.read_text() if log_path.exists() else ""
    return {"lib": lib, "path": str(path), "seconds": seconds, "log": log}


# kernel launches since the last reset, per kernel: each launcher adds one
# per launch (chip_smoke.py reads them to show a path went through a kernel)
launches = dict.fromkeys(KERNELS, 0)


def reset_launches():
    for k in launches:
        launches[k] = 0


def _check_epilogue(vals, n, dirichlet, extra, tensors):
    """Types, devices and layout shared by both operators (run once per
    operator, not per matvec); ``tensors`` are the structure's."""
    if vals.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"vals must be float32 or float64, got {vals.dtype}")
    if dirichlet is not None and (dirichlet.dtype != torch.bool
                                  or tuple(dirichlet.shape) != (n,)):
        raise ValueError(f"dirichlet must be bool ({n},), got "
                         f"{dirichlet.dtype} {tuple(dirichlet.shape)}")
    if extra is not None and (extra.dtype != vals.dtype
                              or tuple(extra.shape) != (n,)):
        raise ValueError(f"extra must be {vals.dtype} ({n},), got "
                         f"{extra.dtype} {tuple(extra.shape)}")
    tensors = [t for t in (vals, *tensors, dirichlet, extra) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("vals, the structure, dirichlet and extra on "
                         f"different devices: {[t.device for t in tensors]}")
    if vals.device.type == "cuda" and not all(t.is_contiguous()
                                              for t in tensors):
        raise ValueError("vals, the structure, dirichlet and extra must "
                         "be contiguous")


def _check_view(pos, n, w_max):
    if (pos.dtype != torch.int32 or pos.dim() != 2 or pos.shape[1] != n
            or not 1 <= pos.shape[0] <= w_max):
        raise ValueError(f"the structural view must be int32 (W, {n}) with "
                         f"1 <= W <= {w_max}, got {pos.dtype} "
                         f"{tuple(pos.shape)}")


def _check(vals, mesh, dirichlet, extra):
    """The block-ELL operator's checks."""
    NB, KB = mesh.bell_nbr.shape
    B, n = mesh.bell_B, mesh.n_nodes
    if tuple(vals.shape) != (NB, KB, B, B):
        raise ValueError(f"vals must be (NB, KB, B, B) = {(NB, KB, B, B)}, "
                         f"got {tuple(vals.shape)}")
    _check_view(mesh.bell_nz_pos, n, W_MAX)
    if mesh.bell_nbr.dtype != torch.int64:
        raise ValueError(f"nbr must be int64, got {mesh.bell_nbr.dtype}")
    _check_epilogue(vals, n, dirichlet, extra,
                    (mesh.bell_nz_pos, mesh.bell_nbr))


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


def view_matvec(vals, nz_pos, nz_col, x):
    """y = A x over a scalar-ELL view: gather, multiply, and sum the W terms
    of each row in order from the first (the kernels' order; a padding term
    is 0 * 0)."""
    valid = nz_pos >= 0
    v = torch.where(valid, vals.reshape(-1)[nz_pos.long().clamp_min(0)], 0.0)
    xc = torch.where(valid, x[nz_col.long()], 0.0)
    return fixed_sum(v * xc, 0)


def structural_matvec_plain(vals, nz_pos, nbr, x):
    """y = A x over the block-ELL structural view (columns from ``nbr``)."""
    return view_matvec(vals, nz_pos, view_columns(nz_pos, nbr, vals.shape[-1]),
                       x)


def bell_operator_structural(vals, mesh, x, dirichlet=None, extra=None):
    """The bell kernel's plain mirror: the operator over the structural
    view."""
    return _compose(
        lambda xm: structural_matvec_plain(vals, mesh.bell_nz_pos,
                                           mesh.bell_nbr, xm),
        x, dirichlet, extra)


def structural_matvec(svals, nz_col, x):
    """y = A x over the structural values (W, n): gather x at the columns,
    multiply, and sum the W terms of each row in order from the first (the
    kernel's order; a padding term is 0 * x[row])."""
    return fixed_sum(svals * x[nz_col], 0)


def ell_operator_plain(svals, mesh, x, dirichlet=None, extra=None):
    """The ELL or BCSR operator in plain PyTorch over the structural values:
    what the CPU path computes, and the ell kernel's mirror (the same
    operations in the same order)."""
    return _compose(lambda xm: structural_matvec(svals, mesh.nz_col, xm), x,
                    dirichlet, extra)


def ell_operator_dense(svals, mesh, x, dirichlet=None, extra=None):
    """The same operator through the JAX package's layout: fem/ell.to_dense,
    then fem/bcsr.bcsr_matvec or fem/ell.ell_matvec with the epilogue
    composed.  A yardstick for tests and chip_smoke.py; the solve path
    never calls it."""
    vals = to_dense(svals, mesh)
    if mesh.bcsr_brow is not None:
        return _compose(lambda xm: bcsr_matvec(vals, mesh, xm), x, dirichlet,
                        extra)
    return _compose(lambda xm: ell_matvec(vals, mesh.ell_cols, xm), x,
                    dirichlet, extra)


class _Launcher:
    """One checked operator on the card: each call is a ``torch.empty`` and
    one launch of kernel ``name``, whose arguments before x are ``args``.
    Holds the tensors whose pointers it passes (``keep``)."""

    def __init__(self, name, vals, n, args, keep, dirichlet, extra):
        if vals.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {vals.device}")
        lib = build(name)["lib"]
        self.name = name
        self.fn = getattr(lib, f"{name}_f32" if vals.dtype == torch.float32
                          else f"{name}_f64")
        self.keep = (vals, *keep, dirichlet, extra)
        self.n = n
        self.dtype, self.device = vals.dtype, vals.device
        self.index = vals.device.index
        self.args = args
        self.epilogue = (None if dirichlet is None else dirichlet.data_ptr(),
                         None if extra is None else extra.data_ptr())

    def __call__(self, x):
        _check_x(x, self.n, self.dtype, self.device)
        y = torch.empty_like(x)
        # the current stream's handle, without building a torch.cuda.Stream
        stream = torch._C._cuda_getCurrentRawStream(self.index)
        err = self.fn(*self.args, x.data_ptr(), *self.epilogue, y.data_ptr(),
                      self.index, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        launches[self.name] += 1
        return y


def _check_x(x, n, dtype, device):
    if (x.shape != (n,) or x.dtype != dtype or x.device != device
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous {dtype} ({n},) on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _cpu_operator(plain, vals, mesh, x, dirichlet, extra):
    _check_x(x, mesh.n_nodes, vals.dtype, vals.device)
    return plain(vals, mesh, x, dirichlet, extra)


def bell_operator_fn(vals, mesh, dirichlet=None, extra=None):
    """The operator's matvec ``x -> y`` for the block-ELL values ``vals``
    (NB, KB, B, B) on ``mesh``, with optional Dirichlet mask (bool (n,)) and
    diagonal increment ``extra`` (n,).  Checked here, once (each call checks
    only x's shape, type, device and layout).  CUDA tensors:
    the csrc/bell_spmv.cu kernel (or an error); CPU tensors:
    :func:`bell_operator_plain`."""
    _check(vals, mesh, dirichlet, extra)
    if vals.device.type == "cpu":
        return functools.partial(_cpu_operator, bell_operator_plain, vals,
                                 mesh, dirichlet=dirichlet, extra=extra)
    if mesh.bell_B & (mesh.bell_B - 1):
        raise ValueError(f"the kernel takes a block edge B that is a power "
                         f"of two, got {mesh.bell_B}")
    pos, nbr = mesh.bell_nz_pos, mesh.bell_nbr
    return _Launcher("bell_spmv", vals, mesh.n_nodes,
                     (vals.data_ptr(), pos.data_ptr(), nbr.data_ptr(),
                      nbr.shape[1], mesh.bell_B, pos.shape[0], mesh.n_nodes),
                     (pos, nbr), dirichlet, extra)


def bell_operator(vals, mesh, x, dirichlet=None, extra=None):
    """One matvec of the operator (:func:`bell_operator_fn` applied to x)."""
    return bell_operator_fn(vals, mesh, dirichlet, extra)(x)


def ell_operator_fn(svals, mesh, dirichlet=None, extra=None):
    """The operator's matvec ``x -> y`` for the structural values ``svals``
    (W, n) of an ELL or BCSR mesh (fem/ell.fold_structural), with the
    optional Dirichlet mask and diagonal increment of
    :func:`bell_operator_fn`.  CUDA tensors: the csrc/ell_spmv.cu kernel
    over svals and ``mesh.nz_col`` (or an error: also for W > W_MAX or a
    view of 2**31 or more slots, which the kernel's int32 indices cannot
    address); CPU tensors: :func:`ell_operator_plain`."""
    n = mesh.n_nodes
    col = mesh.nz_col
    if col is None:
        raise ValueError("mesh has neither an ELL nor a BCSR structure")
    if svals.shape != col.shape:
        raise ValueError(f"svals must be the structural (W, n) = "
                         f"{tuple(col.shape)}, got {tuple(svals.shape)}")
    _check_epilogue(svals, n, dirichlet, extra, (col,))
    if svals.device.type == "cpu":
        return functools.partial(_cpu_operator, ell_operator_plain, svals,
                                 mesh, dirichlet=dirichlet, extra=extra)
    _check_view(col, n, W_MAX)
    if col.numel() >= 2 ** 31:
        raise ValueError(f"the structural view has {col.numel()} >= 2**31 "
                         "slots: they do not fit the kernel's int32")
    return _Launcher("ell_spmv", svals, n,
                     (svals.data_ptr(), col.data_ptr(), col.shape[0], n),
                     (col,), dirichlet, extra)
