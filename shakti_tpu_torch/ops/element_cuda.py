"""The ensemble's element residual and element Jacobian on the card: the
CUDA kernels of csrc/element_batched.cu, and their plain twin.

The member-batched Newton solve (solve/newton.newton_solve_batched) needs,
for M members on one mesh, the element Jacobian blocks J (M, c, 3, 3) once
per Newton iteration and the assembled residual of up to three stacked
states per member at each residual call.  The single-member path takes both
from physics/residual.py by forward AD (``torch.func.jvp`` over
``corner_residual_multi``), which it also differentiates through for the
adjoint.  Here both are written out in closed form, the derivative of
``corner_residual_multi`` term by term, with w = area * cell_valid, g_i the
cell's basis gradients, gt_j = g_j - (g_0 + g_1 + g_2) / 3 (the derivative
of the mean-centred gradient, fem/ops.center), Tbar = sum_q w_q T_q and
c_m = 1/rho_i - 1/rho_w:

    J_ij = w [ -(Tbar / (rho_w g)) (g_i . gt_j)
               + sum_q w_q phi_qi (c_m / L_h (q_q . gt_j) - r_q phi_qj) ]
    r_q  = n A b_q |N_q|^(n-1) + storage_q / (rho_w g dt)

    F_i  = w [ Tbar (grad h . g_i) + sum_q (w_q phi_qi) src_q ]

with grad h and src_q as ``corner_residual_multi`` has them.  The residual
is two passes: the corner contributions of every cell
(:func:`corner_residual`, k <= 3 columns, each column bitwise a k = 1
call), then the nodal sums over the incidence map (:func:`node_sum`, the
adds of fem/ops.scatter_add_cells, bitwise equal to it), completed across
ranks as scatter_add_cells completes them.

:func:`prepare` checks the step's frozen data once (physics/residual.StepPre
with a leading member axis, as the ensemble's vmapped precompute makes it;
a field all members share comes with member stride 0 and is never copied).
On CUDA tensors each function is one launch of an entry of
csrc/element_batched.cu (or an error: no fallback); on CPU tensors it is
the plain twin below, which does the kernels' operations in their order
without FMA contraction (the kernels agree with it to rounding).

Each launch adds one to :data:`launches` under its entry's name.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from shakti_tpu_torch.fem.ops import fixed_sum
from shakti_tpu_torch.ops import spmv_cuda as spmv
from shakti_tpu_torch.params import PhysicalParams

# the step's frozen data (physics/residual.StepPre's fields) in the kernels'
# order, and each field's shape after the member axis ("c": cells, "q":
# quadrature points)
FIELDS = {"Tq": ("c", "q"), "q_q": ("c", "q", 2), "b_q": ("c", "q"),
          "mdiff_q": ("c", "q"), "G_q": ("c", "q"), "inputs_q": ("c", "q"),
          "storage_q": ("c", "q"), "Nn_q": ("c", "q"), "gb0": ("c", 2),
          "dt": (), "phi": ("q", 3), "wq": ("q",)}
Q_MAX, K_MAX, S_MAX = 6, 3, 16      # kQMax, kKMax, kSMax in the source
MEMBERS_MAX = 65535 * 8             # the grid's second axis, 8 members a CTA

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_HEAD = [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i64]
ENTRIES = {
    "element_jacobian_batched": _HEAD + [_p, _p, _i, _p],
    "element_residual_batched": _HEAD + [_i, _p, _p, _i, _p],
    "node_sum_batched": [_p, _i, _p, _i, _i64, _i, _i, _p, _p, _i, _p],
}
spmv.LIBRARIES["element_batched"] = ENTRIES

launches = dict.fromkeys(ENTRIES, 0)


def reset_launches():
    for k in launches:
        launches[k] = 0


@dataclasses.dataclass(frozen=True)
class Batch:
    """One step's frozen data of M members on one mesh, checked: ``fields``
    maps each name of :data:`FIELDS` to its (M, ...) tensor; ``consts`` are
    (rho_w g, c_m, L_h, A, n).  On CUDA, ``table`` holds the kernels' field
    pointers, strides and constants (host arrays) and ``lib`` the loaded
    library."""

    mesh: object
    fields: dict
    consts: tuple
    M: int
    nq: int
    dtype: torch.dtype
    device: torch.device
    table: tuple | None = None
    lib: object = None


def constants(p: PhysicalParams) -> tuple:
    return (p.rho_w * p.g, 1.0 / p.rho_i - 1.0 / p.rho_w, p.Lh, p.A, p.n)


def prepare(pre, mesh, params: PhysicalParams) -> Batch:
    """The checked :class:`Batch` of ``pre`` (physics/residual.StepPre with
    a leading member axis on every field) on ``mesh``.  Raises ValueError
    on what the kernels do not take: fields of another shape, type or
    device than the mesh's, more than 6 quadrature points or
    :data:`MEMBERS_MAX` members, an incidence map wider than 16 slots."""
    fields = {k: getattr(pre, k) for k in FIELDS}
    M = fields["dt"].shape[0] if fields["dt"].dim() == 1 else -1
    nq = fields["wq"].shape[-1]
    dims = {"c": mesh.n_cells, "q": nq}
    dtype, device = mesh.grads.dtype, mesh.grads.device
    if not 1 <= M <= MEMBERS_MAX:
        raise ValueError(f"dt must be (M,) with 1 <= M <= {MEMBERS_MAX}, "
                         f"got {tuple(fields['dt'].shape)}")
    if not 1 <= nq <= Q_MAX:
        raise ValueError(f"the kernels take 1 to {Q_MAX} quadrature points, "
                         f"got {nq}")
    for k, axes in FIELDS.items():
        t = fields[k]
        shape = (M, *(dims.get(a, a) for a in axes))
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
            raise ValueError(f"{k} must be {dtype} {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= mesh.inc_map.shape[1] <= S_MAX:
        raise ValueError(f"the node sum takes 1 to {S_MAX} incidence slots, "
                         f"got {mesh.inc_map.shape[1]}")
    consts = constants(params)
    table = lib = None
    if device.type == "cuda":
        geometry = (mesh.cells, mesh.grads, mesh.area, mesh.cell_valid,
                    mesh.inc_map)
        if (not all(t.is_contiguous() for t in geometry)
                or mesh.cells.dtype != torch.int64
                or mesh.inc_map.dtype != torch.int64):
            raise ValueError("cells, grads, area, cell_valid and inc_map must "
                             "be contiguous, cells and inc_map int64")
        ptrs = (_p * len(FIELDS))(*(fields[k].data_ptr() for k in FIELDS))
        strides = (_i64 * (4 * len(FIELDS)))(*(
            s for k in FIELDS
            for s in (list(fields[k].stride()) + [0, 0, 0])[:4]))
        table = (ptrs, strides, (ctypes.c_double * 5)(*consts))
        spmv_lib = ("ell_spmv" if mesh.structural else
                    "bell_spmv" if mesh.bell_nbr is not None else None)
        lib = _library(spmv_lib)
    return Batch(mesh=mesh, fields=fields, consts=consts, M=M,
                 nq=nq, dtype=dtype, device=device, table=table, lib=lib)


@functools.cache
def _library(spmv_lib: str | None):
    """csrc/element_batched.cu's library, compiled at first use side by
    side with ``spmv_lib``, the SpMV library of the mesh's operator format
    (one nvcc each: a step of the ensemble launches both, so the first
    step waits for the longer build, not for both)."""
    names = ("element_batched",) + (() if spmv_lib is None else (spmv_lib,))
    return spmv.build_all(*names)["element_batched"]["lib"]


def _launch(batch: Batch, entry: str, *args):
    fn = getattr(batch.lib, f"{entry}_f32" if batch.dtype == torch.float32
                 else f"{entry}_f64")
    index = batch.device.index
    err = fn(*args, index, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    launches[entry] += 1


def _geometry_args(batch: Batch):
    m = batch.mesh
    return (*batch.table, m.cells.data_ptr(), m.grads.data_ptr(),
            m.area.data_ptr(), m.cell_valid.data_ptr(), batch.nq, m.n_cells,
            batch.M, m.n_nodes)


def _check(batch: Batch, x, shape, name):
    """``x`` checked, in the contiguous layout the kernels read."""
    if (tuple(x.shape) != tuple(shape) or x.dtype != batch.dtype
            or x.device != batch.device):
        raise ValueError(f"{name} must be {batch.dtype} {tuple(shape)} on "
                         f"{batch.device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.contiguous()


def _columns(batch: Batch, X):
    """X (M, n, k) with 1 <= k <= 3, checked and contiguous."""
    if X.dim() != 3 or not 1 <= X.shape[2] <= K_MAX:
        raise ValueError(f"X must be (M, n, k) with 1 <= k <= {K_MAX}, got "
                         f"{tuple(X.shape)}")
    return _check(batch, X, (batch.M, batch.mesh.n_nodes, X.shape[2]), "X")


# ---- the plain twin: the kernels' operations in their order -------------

def _view(batch: Batch):
    f = batch.fields
    mesh = batch.mesh
    w = (mesh.area * mesh.cell_valid)[None, :, None, None]
    return f, mesh, w


def corner_residual_plain(batch: Batch, X):
    """The corner contributions (M, c, 3, k) of the stacked states X
    (M, n, k), as csrc/element_batched.cu's residual_kernel computes them."""
    f, mesh, w = _view(batch)
    rwg, c_m, Lh, A, n = batch.consts
    Nc = X[:, mesh.cells]                                    # (M, c, 3, k)
    gx = mesh.grads[None, :, :, 0, None]                     # (1, c, 3, 1)
    gy = mesh.grads[None, :, :, 1, None]
    mean = ((Nc[:, :, 0] + Nc[:, :, 1]) + Nc[:, :, 2]) / 3.0  # (M, c, k)
    d = Nc - mean[:, :, None]
    ghx = f["gb0"][:, :, 0, None] - fixed_sum(d * gx, 2) / rwg
    ghy = f["gb0"][:, :, 1, None] - fixed_sum(d * gy, 2) / rwg
    wq = f["wq"][:, None, :, None]                           # (M, 1, nq, 1)
    tbar = fixed_sum(wq * f["Tq"][..., None], 2)             # (M, c, 1)
    qq = f["q_q"][..., None]                                 # (M, c, nq, 2, 1)
    qdgh = qq[:, :, :, 0] * ghx[:, :, None] + qq[:, :, :, 1] * ghy[:, :, None]
    mq = ((f["G_q"][..., None] - rwg * qdgh) / Lh
          + f["mdiff_q"][..., None])                         # (M, c, nq, k)
    phi = f["phi"][:, None, :, :, None]                      # (M, 1, nq, 3, 1)
    Nq = fixed_sum(phi * Nc[:, :, None], 3)                  # (M, c, nq, k)
    C = A * f["b_q"][..., None] * Nq * torch.abs(Nq) ** (n - 1.0)
    lake = (f["storage_q"][..., None] * (Nq - f["Nn_q"][..., None])
            / (rwg * f["dt"][:, None, None, None]))
    src = ((c_m * mq - C) - lake) - f["inputs_q"][..., None]
    wphi = (f["wq"][:, :, None] * f["phi"])[:, None, :, :, None]
    src_i = fixed_sum(wphi * src[:, :, :, None], 2)          # (M, c, 3, k)
    flux_i = tbar[:, :, None] * (ghx[:, :, None] * gx + ghy[:, :, None] * gy)
    return w * (flux_i + src_i)


def node_sum_plain(batch: Batch, corner, mask=None):
    """The nodal sums (M, n, k) of the corner contributions (M, c, 3, k):
    each member's fem/ops.scatter_add_cells without its completion, masked
    rows 0."""
    M, c, _, k = corner.shape
    flat = corner.reshape(M, 3 * c, k)
    ext = torch.cat([flat, flat.new_zeros(M, 1, k)], dim=1)
    out = fixed_sum(ext[:, batch.mesh.inc_map], 2)
    return out if mask is None else torch.where(mask[:, None], 0.0, out)


def jacobian_plain(batch: Batch, N):
    """The element Jacobian blocks (M, c, 3, 3) at N (M, n), as
    csrc/element_batched.cu's jacobian_kernel computes them."""
    f, mesh, w = _view(batch)
    rwg, c_m, Lh, A, n = batch.consts
    Nc = N[:, mesh.cells]                                    # (M, c, 3)
    g = mesh.grads                                           # (c, 3, 2)
    gt = g - ((g[:, 0] + g[:, 1]) + g[:, 2])[:, None] / 3.0
    K = (g[:, :, None, 0] * gt[:, None, :, 0]
         + g[:, :, None, 1] * gt[:, None, :, 1])             # (c, i, j)
    tbar = fixed_sum(f["wq"][:, None, :] * f["Tq"], 2)       # (M, c)
    Nq = fixed_sum(f["phi"][:, None] * Nc[:, :, None, :], 3)  # (M, c, nq)
    r = ((A * n) * f["b_q"] * torch.abs(Nq) ** (n - 1.0)
         + f["storage_q"] / (rwg * f["dt"][:, None, None]))
    qq = f["q_q"][..., None]                                 # (M, c, nq, 2, 1)
    adv = (c_m / Lh) * (qq[:, :, :, 0] * gt[None, :, None, :, 0]
                        + qq[:, :, :, 1] * gt[None, :, None, :, 1])
    phi = f["phi"][:, None]                                  # (M, 1, nq, 3)
    wphi = f["wq"][:, None, :, None] * phi                   # (M, 1, nq, i)
    term = wphi[..., :, None] * (adv[..., None, :]
                                 - r[..., None, None] * phi[..., None, :])
    acc = fixed_sum(term, 2)                                 # (M, c, i, j)
    return w * (acc - (tbar / rwg)[..., None, None] * K[None])


# ---- the wrappers ---------------------------------------------------------

def corner_residual(batch: Batch, X):
    """The corner contributions (M, c, 3, k) of X (M, n, k), 1 <= k <= 3:
    one launch of ``element_residual_batched`` on CUDA tensors, else
    :func:`corner_residual_plain`."""
    X = _columns(batch, X)
    if batch.device.type == "cpu":
        return corner_residual_plain(batch, X)
    k = X.shape[2]
    out = torch.empty((batch.M, batch.mesh.n_cells, 3, k), dtype=batch.dtype,
                      device=batch.device)
    _launch(batch, "element_residual_batched", *_geometry_args(batch), k,
            X.data_ptr(), out.data_ptr())
    return out


def node_sum(batch: Batch, corner, mask=None):
    """The assembled residual (M, n, k) from the corner contributions
    (M, c, 3, k): the incidence map's slots summed in order (one launch of
    ``node_sum_batched`` on CUDA tensors, else :func:`node_sum_plain`),
    completed across the ranks of a distributed mesh as
    fem/ops.scatter_add_cells completes a member's sum; then the rows of the
    bool (n,) ``mask`` set to 0."""
    mesh = batch.mesh
    k = corner.shape[-1]
    corner = _check(batch, corner, (batch.M, mesh.n_cells, 3, k), "corner")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (mesh.n_nodes,)
                             or mask.device != batch.device):
        raise ValueError(f"mask must be bool ({mesh.n_nodes},) on "
                         f"{batch.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    mask = None if mask is None else mask.contiguous()
    complete = mesh.halo.accumulate if mesh.halo is not None else (
        mesh.paxis.allsum if mesh.paxis is not None else None)
    fused = mask if complete is None else None
    if batch.device.type == "cpu":
        out = node_sum_plain(batch, corner, fused)
    else:
        if not 1 <= k <= K_MAX:
            raise ValueError(f"corner must have 1 to {K_MAX} columns, got {k}")
        out = torch.empty((batch.M, mesh.n_nodes, k), dtype=batch.dtype,
                          device=batch.device)
        _launch(batch, "node_sum_batched", corner.data_ptr(), mesh.n_cells,
                mesh.inc_map.data_ptr(), mesh.inc_map.shape[1], mesh.n_nodes,
                batch.M, k, None if fused is None else fused.data_ptr(),
                out.data_ptr())
    if complete is None:
        return out
    out = torch.stack([complete(o) for o in out])
    return out if mask is None else torch.where(mask[:, None], 0.0, out)


def residual(batch: Batch, X, mask=None):
    """The assembled residuals of X (M, n) or of k <= 3 stacked states per
    member (M, n, k), the same shape back, the rows of ``mask`` 0: on CUDA
    tensors two launches (:func:`corner_residual`, :func:`node_sum`)."""
    X3 = X[..., None] if X.dim() == 2 else X
    out = node_sum(batch, corner_residual(batch, X3), mask)
    return out[..., 0] if X.dim() == 2 else out


def jacobian(batch: Batch, N):
    """The element Jacobian blocks (M, c, 3, 3) at N (M, n): one launch of
    ``element_jacobian_batched`` on CUDA tensors, else
    :func:`jacobian_plain`."""
    mesh = batch.mesh
    N = _check(batch, N, (batch.M, mesh.n_nodes), "N")
    if batch.device.type == "cpu":
        return jacobian_plain(batch, N)
    out = torch.empty((batch.M, mesh.n_cells, 3, 3), dtype=batch.dtype,
                      device=batch.device)
    _launch(batch, "element_jacobian_batched", *_geometry_args(batch),
            N.data_ptr(), out.data_ptr())
    return out
