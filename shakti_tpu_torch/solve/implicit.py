"""Differentiable implicit solves: reverse mode through the Newton solve by
the implicit-function theorem.

Port of shakti_tpu/solve/implicit.py (single device).  The converged
solution of

    F(N*, pre) = 0        on free nodes,
    N*          = N_bdry  on Dirichlet nodes

gets its exact derivative instead of an unrolled one: for a cotangent ``ct``
on N*,

    A^T lambda = ct|_free        (A = -J, the forward Krylov operator)
    ct_pre     = (dF/dpre)^T lambda

i.e. one adjoint Krylov solve per step, with the operator format, Dirichlet
elimination, diagonal floor and preconditioner class (cfg.precond) of the
forward iteration, then one vector-Jacobian product of the residual with N
held fixed.  The adjoint operator is exact: the element blocks are
transposed before the fold (J^T = sum_c S_c J_c^T S_c^T), so on the card
each adjoint matvec is a launch of the forward solve's kernel (bell_spmv for
block-ELL, ell_spmv for ELL and block-CSR).

The solve is a ``torch.autograd.Function``: its forward runs newton_solve
under no_grad (it records no graph through the iterations), and N_init and
N_ref get zero gradients (the converged solution does not depend on where
the iteration started).  Gradients flow into every tensor of ``pre``, hence
into the previous state, dt, the per-step forcing and the static fields
(solve/timestep.make_runner).  An adjoint Krylov solve that does not
converge warns; with ``SHAKTI_ADJOINT_STRICT=1`` it also fills lambda with
NaN, so that an optimizer cannot use the inaccurate gradient.

Enable with ``NewtonConfig(differentiable=True)``; incompatible with
``lag_operator``.

On a rank's share of a node-sharded mesh (``mesh.halo``, parallel/dist.py)
the same algebra runs on the [owned | ghosts | dump] slots with the JAX
package's three adaptations: (1) the incoming cotangent holds the rank's
partial contributions at owned AND ghost slots (the rank's cells read
ghost copies of N*), so it is halo-accumulated into the global cotangent
before the solve; (2) the adjoint Krylov solve takes the owned-slot dots
and norm summed over the ranks, as the forward's does, so every rank
takes the same decisions (and warns, or poisons, alike); (3) the residual
whose VJP gives ``ct_pre`` is masked to OWNED rows: a ghost row repeats
its owner's equation, and unmasked it would count each interface
equation once per copy.  The VJP runs through the recorded halo
exchanges of the assembly (parallel/halo.py), whose backward carries the
cotangents of ghost copies to their owners.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch

from shakti_tpu_torch.physics import residual as res
from shakti_tpu_torch.solve import krylov
from shakti_tpu_torch.solve.newton import linear_operator, newton_solve


@dataclasses.dataclass
class _Problem:
    """What the Function needs besides its tensor inputs: the mesh and
    boundary data, the configuration, the non-tensor fields of ``pre``, and
    the forward's stats (read by the caller)."""

    mesh: object
    dirichlet: torch.Tensor
    dirichlet_value: torch.Tensor
    params: object
    cfg: object
    names: tuple = ()       # the tensor fields of pre, in input order
    fixed: dict = dataclasses.field(default_factory=dict)  # the others
    stats: dict | None = None

    def pre(self, values):
        return res.StepPre(**self.fixed, **dict(zip(self.names, values)))


class _ImplicitSolve(torch.autograd.Function):

    @staticmethod
    def forward(ctx, prob, N_init, N_ref, *values):
        with torch.no_grad():
            N, prob.stats = newton_solve(
                N_init, prob.pre(values), prob.mesh, prob.dirichlet,
                prob.dirichlet_value, prob.params, prob.cfg, N_ref=N_ref)
        ctx.prob = prob
        ctx.save_for_backward(N, *values)
        return N

    @staticmethod
    def backward(ctx, ct_N):
        prob = ctx.prob
        N, *values = ctx.saved_tensors
        mesh, dirichlet, cfg = prob.mesh, prob.dirichlet, prob.cfg
        halo = mesh.halo
        reduce = {} if halo is None else dict(dot=halo.dot, norm=halo.norm,
                                              dots=halo.dots)
        with torch.no_grad():
            if halo is not None:
                # the ranks' partial cotangents, owned and ghost slots,
                # summed into the global one
                ct_N = halo.accumulate(ct_N)
            # the exact adjoint operator: the element blocks transposed
            # before the fold (J^T = sum_c S_c J_c^T S_c^T), with the
            # forward solve's floor and preconditioner class
            J_t = res.element_jacobian(N, prob.pre(values), mesh,
                                       prob.params).transpose(1, 2)
            matvec, minv = linear_operator(J_t, mesh, dirichlet, cfg)
            rhs = torch.where(dirichlet, 0.0, ct_N)
            lam, info = krylov.get_solver(cfg.krylov)(
                matvec, rhs, minv, rtol=cfg.lin_rtol, maxiter=cfg.lin_maxiter,
                **reduce)
        if not info["converged"]:
            warnings.warn(
                f"adjoint Krylov solve unconverged (resnorm "
                f"{info['resnorm']:.3e} after {info['iters']} iterations): "
                "gradients from this step may be inaccurate; raise "
                "NewtonConfig.lin_maxiter or strengthen cfg.precond",
                RuntimeWarning, stacklevel=2)
            if os.environ.get("SHAKTI_ADJOINT_STRICT", "0") == "1":
                lam = torch.full_like(lam, float("nan"))
        # ct_pre = (dF/dpre)^T lambda, N held fixed; lambda vanishes on
        # Dirichlet rows, so the row mask of F is immaterial; on a rank,
        # F's owned rows only
        need = ctx.needs_input_grad[3:]
        leaves = [v.detach().requires_grad_(w) for v, w in zip(values, need)]
        wanted = [v for v, w in zip(leaves, need) if w]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                F = torch.where(dirichlet, 0.0, res.assemble_residual(
                    N, prob.pre(leaves), mesh, prob.params))
                if halo is not None:
                    F = F * halo.owned_mask
                grads = iter(torch.autograd.grad(F, wanted, lam,
                                                 allow_unused=True))
        ct_pre = [next(grads) if w else None for w in need]
        zeros = [torch.zeros_like(N) if w else None
                 for w in ctx.needs_input_grad[1:3]]
        return (None, *zeros, *ct_pre)


def make_implicit_solver(mesh, dirichlet, dirichlet_value, params, cfg):
    """Returns solve(N_init, N_ref, pre) -> (N, stats): the ``newton_solve``
    of solve/timestep.make_step_fn with the implicit-function-theorem
    gradient (see the module docstring)."""
    if cfg.coarse_block is None:
        # direct callers may skip freeze's resolution
        cfg = dataclasses.replace(cfg, coarse_block=64)

    def solve(N_init, N_ref, pre):
        fields = res.pre_values(pre)
        names = tuple(k for k, v in zip(res.PRE_FIELDS, fields)
                      if torch.is_tensor(v))
        fixed = {k: v for k, v in zip(res.PRE_FIELDS, fields)
                 if not torch.is_tensor(v)}
        prob = _Problem(mesh, dirichlet, dirichlet_value, params, cfg,
                        names, fixed)
        N = _ImplicitSolve.apply(prob, N_init, N_ref,
                                 *(getattr(pre, k) for k in names))
        return N, prob.stats

    return solve
