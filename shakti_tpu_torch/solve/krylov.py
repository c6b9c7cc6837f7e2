"""Preconditioned Krylov solvers on torch tensors: CG and BiCGStab.

Port of shakti_tpu/solve/krylov.py.  Each ``lax.while_loop`` becomes a
Python loop whose ``norm(r) > tol`` test is one host sync per iteration
(ROADMAP kernel item K8 moves the loop onto the device).
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
    apply_pc = _preconditioner(minv)
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


def bicgstab(matvec, b, minv=None, x0=None, *, rtol=1e-8, atol=0.0,
             maxiter=1000):
    """Right-preconditioned BiCGStab for A x = b (``minv`` as in
    :func:`pcg`).  Returns (x, info) like :func:`pcg`."""
    x = torch.zeros_like(b) if x0 is None else x0
    apply_pc = _preconditioner(minv)
    tol = max(rtol * float(norm(b)), float(atol))
    r = b - matvec(x)
    rhat = r
    p = v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    k = 0
    while float(norm(r)) > tol and k < maxiter:
        rho_new = dot(rhat, r)
        beta = (rho_new / torch.where(rho == 0, 1.0, rho)) * (
            alpha / torch.where(omega == 0, 1.0, omega))
        p = r + beta * (p - omega * v)
        phat = apply_pc(p)
        v = matvec(phat)
        denom = dot(rhat, v)
        alpha = rho_new / torch.where(denom == 0, 1.0, denom)
        s = r - alpha * v
        shat = apply_pc(s)
        t = matvec(shat)
        tt = dot(t, t)
        omega = dot(t, s) / torch.where(tt == 0, 1.0, tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    resnorm = float(norm(r))
    return x, {"iters": k, "resnorm": resnorm, "converged": resnorm <= tol}


def _preconditioner(minv):
    if minv is None:
        return lambda r: r
    if callable(minv):
        return minv
    return lambda r: minv * r


SOLVERS = {"cg": pcg, "bicgstab": bicgstab}


def get_solver(name: str):
    if name not in SOLVERS:
        raise ValueError(f"Krylov solver must be one of {sorted(SOLVERS)}, "
                         f"got {name!r}")
    return SOLVERS[name]
