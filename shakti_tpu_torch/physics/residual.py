r"""Weak-form residual of the effective-pressure equation on torch tensors.

Port of shakti_tpu/physics/residual.py.  The weak form:

    F_i = \int [ -q_w(N) . grad(phi_i)
                 + ( (1/rho_i - 1/rho_w) m(N) - C(N)
                     - storage (N - N_n)/(rho_w g dt) - inputs ) phi_i ] dx

with b, q (hence Re) and the lagged melt frozen at the previous step; the
frozen data is precomputed once per step into :class:`StepPre`.  Element
3x3 Jacobian blocks come from forward-mode AD (``torch.func.jvp``).  Every
function of one member batches over an ensemble's members with
``torch.func.vmap`` (:data:`PRE_FIELDS` flattens a StepPre for it).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from shakti_tpu_torch.fem import bell as bellm
from shakti_tpu_torch.fem import ell as ellm
from shakti_tpu_torch.fem import ops
from shakti_tpu_torch.fem.ops import fixed_sum
from shakti_tpu_torch.fem.p1 import quadrature
from shakti_tpu_torch.ops import spmv_cuda as spmv
from shakti_tpu_torch.params import PhysicalParams
from shakti_tpu_torch.physics import constitutive as law


@dataclasses.dataclass(frozen=True)
class StepPre:
    """Per-timestep data frozen during the Newton solve for N.
    All *_q tensors are values at quadrature points, shape (n_cells, nq)."""

    phi: Any        # (nq, 3) shape functions at quad points
    wq: Any         # (nq,) quadrature weights (sum to 1)
    gb0: Any        # (c, 2) background head gradient
    Tq: Any         # (c, nq) transmissivity
    q_q: Any        # (c, nq, 2) frozen water flux
    b_q: Any        # (c, nq) frozen gap height
    mdiff_q: Any    # (c, nq) frozen melt-regularization term
    G_q: Any        # (c, nq) geothermal flux
    inputs_q: Any   # (c, nq) moulin/distributed input
    storage_q: Any  # (c, nq) lake-storage indicator
    Nn_q: Any       # (c, nq) previous-step N
    dt: Any         # 0-d timestep


# StepPre's fields in order: StepPre(*values) rebuilds one
PRE_FIELDS = tuple(f.name for f in dataclasses.fields(StepPre))


def pre_values(pre: StepPre) -> tuple:
    """The fields of ``pre`` in :data:`PRE_FIELDS` order."""
    return tuple(getattr(pre, k) for k in PRE_FIELDS)


def static_quad_fields(mesh, static, quad_degree: int, dtype):
    """Quadrature-point values of the time-independent forcing fields."""
    phi_np, wq_np = quadrature(quad_degree)
    dev = mesh.nodes.device
    phi = torch.as_tensor(phi_np, dtype=dtype, device=dev)
    wq = torch.as_tensor(wq_np, dtype=dtype, device=dev)

    def at_q(f):
        return ops.interpolate_at_quad(phi, ops.gather_cells(mesh, f))

    return {"phi": phi, "wq": wq, "G_q": at_q(static.G),
            "inputs_q": at_q(static.inputs), "storage_q": at_q(static.storage),
            "zs_q": at_q(static.z_s)}


def precompute_step(mesh, N_n, b, q, melt_n, static, dt, params: PhysicalParams,
                    quad_degree: int = 4, sq=None) -> StepPre:
    """Frozen per-step data from one fused 5-column corner gather."""
    if sq is None:
        sq = static_quad_fields(mesh, static, quad_degree, b.dtype)
    phi, wq = sq["phi"], sq["wq"]
    stacked = torch.stack([b, melt_n, N_n, q[:, 0], q[:, 1]], dim=1)
    sc = ops.gather_cells(mesh, stacked)                         # (c, 3, 5)
    sq_q = ops.interpolate_at_quad(phi, sc)                      # (c, nq, 5)
    b_q, melt_q, Nn_q = sq_q[..., 0], sq_q[..., 1], sq_q[..., 2]
    q_q = sq_q[..., 3:5]
    Tq = law.transmissivity(b_q, law.reynolds(q_q, params), params)
    grads_sc = fixed_sum(ops.center(sc)[:, :, :, None]
                         * mesh.grads[:, :, None, :], 1)         # (c, 5, 2)
    mdiff_q = law.melt_regularization(
        b_q, melt_q, grads_sc[:, None, 0], grads_sc[:, None, 1])
    return StepPre(phi=phi, wq=wq, gb0=static.gb0, Tq=Tq, q_q=q_q, b_q=b_q,
                   mdiff_q=mdiff_q, G_q=sq["G_q"], inputs_q=sq["inputs_q"],
                   storage_q=sq["storage_q"], Nn_q=Nn_q, dt=dt)


def corner_residual_multi(N_ck, pre: StepPre, mesh, params: PhysicalParams):
    """Element residual contributions for k stacked states:
    N_ck (c, 3, k) corner values -> (c, 3, k).  Columns never mix and every
    reduction is a fixed-order sum, so each column is bit-identical to a
    k = 1 call (:func:`corner_residual`)."""
    p = params
    grad_N = fixed_sum(ops.center(N_ck)[:, :, None, :]
                       * mesh.grads[:, :, :, None], 1)          # (c, 2, k)
    grad_h = pre.gb0[:, :, None] - grad_N / (p.rho_w * p.g)     # (c, 2, k)
    flux_q = -pre.Tq[:, :, None, None] * grad_h[:, None, :, :]  # (c,nq,2,k)
    qdgh = fixed_sum(pre.q_q[:, :, :, None] * grad_h[:, None, :, :], 2)
    m_q = ((pre.G_q[:, :, None] - p.rho_w * p.g * qdgh) / p.Lh
           + pre.mdiff_q[:, :, None])
    N_q = fixed_sum(pre.phi[None, :, :, None] * N_ck[:, None, :, :], 2)
    C_q = law.closure(pre.b_q[:, :, None], N_q, p)
    c_m = 1.0 / p.rho_i - 1.0 / p.rho_w
    lake_q = (pre.storage_q[:, :, None] * (N_q - pre.Nn_q[:, :, None])
              / (p.rho_w * p.g * pre.dt))
    src_q = c_m * m_q - C_q - lake_q - pre.inputs_q[:, :, None]
    w_cell = mesh.area * mesh.cell_valid
    # term_flux_ci = -sum_q sum_d w_q flux_q[c,q,d] grads[c,i,d]
    term_flux = -fixed_sum(fixed_sum(
        pre.wq[None, :, None, None, None] * flux_q[:, :, None, :, :]
        * mesh.grads[:, None, :, :, None], 3), 1)               # (c, 3, k)
    # term_src_ci = sum_q w_q src_q[c,q] phi[q,i]
    term_src = fixed_sum((pre.wq[:, None] * pre.phi)[None, :, :, None]
                         * src_q[:, :, None, :], 1)             # (c, 3, k)
    return w_cell[:, None, None] * (term_flux + term_src)


def corner_residual(N_c, pre: StepPre, mesh, params: PhysicalParams):
    """Element residual contributions F_ci for corner values N_c (c, 3)."""
    return corner_residual_multi(N_c[:, :, None], pre, mesh, params)[:, :, 0]


def assemble_residual(N, pre: StepPre, mesh, params: PhysicalParams):
    """Global residual vector F(N) (n_nodes,)."""
    return ops.scatter_add_cells(
        mesh, corner_residual(ops.gather_cells(mesh, N), pre, mesh, params))


def assemble_residual_multi(Ns, pre: StepPre, mesh, params: PhysicalParams):
    """Residuals for k stacked states at once: (n, k) -> (n, k)."""
    return ops.scatter_add_cells(
        mesh, corner_residual_multi(ops.gather_cells(mesh, Ns), pre, mesh,
                                    params))


def element_jacobian(N, pre: StepPre, mesh, params: PhysicalParams):
    """Element Jacobian blocks J_cij = dF_ci / dN_cj (c, 3, 3).

    One forward-mode pass over the 3-column residual: column j carries the
    tangent e_j, so the output tangent's column j is J[:, :, j]."""
    N_c = ops.gather_cells(mesh, N)
    N_ck = N_c[:, :, None].expand(-1, -1, 3).contiguous()
    eye = torch.eye(3, dtype=N.dtype, device=N.device)
    tangent = eye.expand(N_c.shape[0], 3, 3).contiguous()
    return torch.func.jvp(
        lambda x: corner_residual_multi(x, pre, mesh, params), (N_ck,),
        (tangent,))[1]


def jacobian_diag(J_c, mesh):
    """Assembled Jacobian diagonal from element blocks (for Jacobi PC)."""
    return ops.scatter_add_cells(mesh, torch.diagonal(J_c, dim1=1, dim2=2))


def make_matvec(J_c, mesh, dirichlet, extra=None):
    """Matrix-free action of A = -J with symmetric Dirichlet elimination
    (the 'cells' operator), plus ``extra * x`` when ``extra`` is given: a
    corner gather, the element products and the incidence-gather sum."""
    def matvec(x):
        xc = torch.where(dirichlet, 0.0, x)[mesh.cells]         # (c, 3)
        yc = fixed_sum(J_c * xc[:, None, :], 2)
        y = torch.where(dirichlet, x, -ops.scatter_add_cells(mesh, yc))
        return y if extra is None else y + extra * x
    return matvec


def has_values(mesh) -> bool:
    """Does the mesh carry an assembled-operator format (bcsr, bell or
    ell), rather than the matrix-free 'cells' operator?"""
    return (mesh.bcsr_brow is not None or mesh.bell_nbr is not None
            or mesh.ell_cols is not None)


def operator_values_shape(mesh):
    """Shape of the folded values as the solve path stores them (seeds the
    lag carry): the structural (W, n) for BCSR and ELL, the blocks (NB, KB,
    B, B) for block-ELL; raises for the matrix-free operator."""
    if mesh.structural:
        return tuple(mesh.nz_col.shape)
    if mesh.bell_nbr is not None:
        NB, KB = mesh.bell_nbr.shape
        return (NB, KB, mesh.bell_B, mesh.bell_B)
    raise ValueError("mesh has no foldable operator structure")


def fold_operator_values(J_c, mesh):
    """Element blocks -> stored values of A = -J in the mesh's format, in
    the JAX package's priority bcsr > bell > ell (the small element blocks
    are negated, not the folded values)."""
    nJ = -J_c
    if mesh.structural:
        return ellm.fold_structural(nJ, mesh)
    if mesh.bell_nbr is not None:
        return bellm.bell_from_elements(nJ, mesh)
    raise ValueError("mesh has no foldable operator structure")


def operator_diag_from_values(vals, mesh):
    """Assembled diagonal of A from the folded values (on a rank's share
    of a node-sharded mesh, completed by one halo accumulate)."""
    if mesh.structural:
        a_diag = ellm.structural_diag(vals, mesh)
    else:
        a_diag = bellm.bell_diag(vals, mesh.bell_diag_pos)
    if mesh.halo is not None:
        a_diag = mesh.halo.accumulate(a_diag)
    return a_diag


def operator_from_values(vals, mesh, dirichlet, extra=None):
    """Matvec of A = -J with symmetric Dirichlet elimination (constrained
    inputs are zeroed and constrained rows act as the identity), plus
    ``extra * x`` when ``extra`` is given (the diagonal floor).  Checked
    once here; on the card each matvec is one kernel launch
    (ops/spmv_cuda.py: bell_spmv for block-ELL, ell_spmv for BCSR and
    ELL).

    On a rank's share of a node-sharded mesh (``mesh.halo``) the rank's
    operator holds its own cells' entries only: the kernel computes
    ``where(d, x, A_local xm)`` over every local row, one halo accumulate
    completes the owned rows and refreshes the ghosts, and the Dirichlet
    rows and ``extra * x`` follow (a ghost copy of a Dirichlet row adds x
    to its owner's row, which the Dirichlet select then overwrites)."""
    fn = spmv.ell_operator_fn if mesh.structural else spmv.bell_operator_fn
    if mesh.halo is None:
        return fn(vals, mesh, dirichlet, extra)
    local = fn(vals, mesh, dirichlet)
    halo = mesh.halo

    def matvec(x):
        y = torch.where(dirichlet, x, halo.accumulate(local(x)))
        return y if extra is None else y + extra * x

    return matvec


def make_operator(J_c, mesh, dirichlet):
    """(matvec, diag) for A = -J with Dirichlet elimination: folded into the
    mesh's format when it has one, matrix-free otherwise."""
    if has_values(mesh):
        vals = fold_operator_values(J_c, mesh)
        return (operator_from_values(vals, mesh, dirichlet),
                operator_diag_from_values(vals, mesh))
    return make_matvec(J_c, mesh, dirichlet), -jacobian_diag(J_c, mesh)


def member_operators(vals, J_c, mesh, dirichlet, extra):
    """The operator of each member of a batch (``vals`` (M, ...) in the
    mesh's format, else the element blocks ``J_c`` (M, c, 3, 3), and
    ``extra`` (M, n)): a list of M single-member matvecs, each one kernel
    launch on the card (:func:`operator_from_values`) or the matrix-free
    product."""
    if vals is not None:
        return [operator_from_values(vals[m], mesh, dirichlet, extra[m])
                for m in range(vals.shape[0])]
    return [make_matvec(J_c[m], mesh, dirichlet, extra[m])
            for m in range(J_c.shape[0])]


def batched_operator(vals, J_c, mesh, dirichlet, extra):
    """The matvec (M, n) -> (M, n) of a batch of operators: block-ELL values
    take one member-batched launch for all members
    (ops/spmv_cuda.bell_operator_batched_fn); ELL and block-CSR launch
    ell_spmv once per member, and the matrix-free operator runs per member
    (:func:`member_operators`)."""
    if vals is not None and not mesh.structural:
        return spmv.bell_operator_batched_fn(vals, mesh, dirichlet, extra)
    ops_ = member_operators(vals, J_c, mesh, dirichlet, extra)
    return lambda x: torch.stack([op(x[m]) for m, op in enumerate(ops_)])
