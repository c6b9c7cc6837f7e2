"""Preconditioned conjugate gradients on torch tensors.

Port of shakti_tpu/solve/krylov.py:pcg.  The ``lax.while_loop`` becomes a
Python loop whose ``norm(r) > tol`` test is one host sync per iteration
(ROADMAP kernel item K8 moves the loop onto the device).  ``bicgstab`` is
not ported yet (ROADMAP).
"""

from __future__ import annotations

import torch


def dot(a, b):
    return torch.sum(a * b)


def norm(a):
    return torch.linalg.vector_norm(a)


def pcg(matvec, b, minv=None, x0=None, *, rtol=1e-8, atol=0.0, maxiter=1000):
    """Preconditioned conjugate gradients for A x = b.

    ``minv``: a callable preconditioner apply, a diagonal inverse (tensor),
    or None.  Returns (x, info) with info = dict(iters, resnorm, converged)
    as Python numbers."""
    x = torch.zeros_like(b) if x0 is None else x0
    if minv is None:
        def apply_pc(r):
            return r
    elif callable(minv):
        apply_pc = minv
    else:
        def apply_pc(r):
            return minv * r
    tol = max(rtol * float(norm(b)), float(atol))
    r = b - matvec(x)
    z = apply_pc(r)
    p = z
    rz = dot(r, z)
    k = 0
    while float(norm(r)) > tol and k < maxiter:
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_pc(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    resnorm = float(norm(r))
    return x, {"iters": k, "resnorm": resnorm, "converged": resnorm <= tol}


SOLVERS = {"cg": pcg}


def get_solver(name: str):
    if name not in SOLVERS:
        raise NotImplementedError(
            f"Krylov solver {name!r}: the port has 'cg' only so far; "
            "bicgstab is ROADMAP, still to port, item 5")
    return SOLVERS[name]
