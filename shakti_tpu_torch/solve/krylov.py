"""Preconditioned Krylov solvers on torch tensors: CG and BiCGStab.

Port of shakti_tpu/solve/krylov.py.  Each ``lax.while_loop`` becomes a
Python loop whose ``norm(r) > tol`` test is one host sync per iteration
(ROADMAP kernel item K8 moves the loop onto the device).

:func:`pcg_batched` and :func:`bicgstab_batched` solve an ensemble's M
systems at once, as ``jax.vmap`` of the JAX solvers does: each member
iterates until its own test stops it and then keeps its iterate, and the
loop runs while any member is live (one host read per iteration).  A
member's iterates are those of its own single solve.
"""

from __future__ import annotations

import torch

from shakti_tpu_torch.utils.trace import counts


def dot(a, b, dim=None):
    return torch.sum(a * b, dim=dim)


def norm(a, dim=None):
    return torch.linalg.vector_norm(a, dim=dim)


# the defaults of pcg's and bicgstab's dot= and norm= (their parameters
# shadow the names)
_dot, _norm = dot, norm


def pcg(matvec, b, minv=None, x0=None, *, rtol=1e-8, atol=0.0, maxiter=1000,
        dot=None, norm=None, dots=None):
    """Preconditioned conjugate gradients for A x = b.

    ``minv``: a callable preconditioner apply, a diagonal inverse (tensor),
    or None.  ``dot``/``norm``: the inner product and norm (default: this
    module's; a node-sharded rank passes its halo's owned-slot reductions,
    which give the same scalars on every rank).  ``dots``: optional
    ``dots([(a, b), ...])`` -> the (k,) inner products in one reduction
    (parallel/halo.Halo.dots): r.z and r.r are then read together, one
    reduction per iteration fewer, the same values.  Returns (x, info)
    with info = dict(iters, resnorm, converged) as Python numbers."""
    dot, norm = dot or _dot, norm or _norm

    def rz_rnorm(r, z):
        if dots is None:
            return dot(r, z), norm(r)
        v = dots([(r, z), (r, r)])
        return v[0], torch.sqrt(v[1])

    x = torch.zeros_like(b) if x0 is None else x0
    apply_pc = _preconditioner(minv)
    tol = max(rtol * float(norm(b)), float(atol))
    r = b - matvec(x)
    z = apply_pc(r)
    p = z
    rz, rnorm = rz_rnorm(r, z)
    k = 0
    while float(rnorm) > tol and k < maxiter:
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_pc(r)
        rz_new, rnorm = rz_rnorm(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
        counts["krylov.trips"] += 1
    resnorm = float(rnorm)
    return x, {"iters": k, "resnorm": resnorm, "converged": resnorm <= tol}


def bicgstab(matvec, b, minv=None, x0=None, *, rtol=1e-8, atol=0.0,
             maxiter=1000, dot=None, norm=None, dots=None):
    """Right-preconditioned BiCGStab for A x = b (``minv``, ``dot``,
    ``norm`` and ``dots`` as in :func:`pcg`: with ``dots``, t.t and t.s are
    read together).  Returns (x, info) like :func:`pcg`."""
    dot, norm = dot or _dot, norm or _norm
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
        tt, ts = (dot(t, t), dot(t, s)) if dots is None else dots(
            [(t, t), (t, s)])
        omega = ts / torch.where(tt == 0, 1.0, tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
        counts["krylov.trips"] += 1
    resnorm = float(norm(r))
    return x, {"iters": k, "resnorm": resnorm, "converged": resnorm <= tol}


def _live(active, r, tol, k, maxiter):
    return active & (norm(r, dim=-1).double() > tol) & (k < maxiter)


def pcg_batched(matvec, b, minv=None, *, rtol=1e-8, atol=0.0, maxiter=1000,
                active=None):
    """:func:`pcg` for M systems at once: ``b`` (M, n), ``matvec`` and
    ``minv`` map (M, n) to (M, n) (``minv`` may be a (M, n) diagonal
    inverse), ``atol`` a number or a (M,) tensor; members outside the bool
    (M,) ``active`` do not iterate.  Returns (x, info) with info =
    dict(iters, resnorm, converged) as (M,) tensors."""
    x = torch.zeros_like(b)
    apply_pc = _preconditioner(minv)
    k = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    active = (torch.ones_like(k, dtype=torch.bool) if active is None
              else active)
    tol = torch.clamp_min(rtol * norm(b, dim=-1).double(), atol)
    r = b - matvec(x)
    z = apply_pc(r)
    p = z
    rz = dot(r, z, dim=-1)
    live = _live(active, r, tol, k, maxiter)
    while bool(live.any()):
        Ap = matvec(p)
        pAp = dot(p, Ap, dim=-1)
        alpha = (rz / torch.where(pAp == 0, 1.0, pAp))[:, None]
        r_new = r - alpha * Ap
        z = apply_pc(r_new)
        rz_new = dot(r_new, z, dim=-1)
        beta = (rz_new / torch.where(rz == 0, 1.0, rz))[:, None]
        lv = live[:, None]
        x = torch.where(lv, x + alpha * p, x)
        r = torch.where(lv, r_new, r)
        p = torch.where(lv, z + beta * p, p)
        rz = torch.where(live, rz_new, rz)
        k = k + live
        live = _live(live, r, tol, k, maxiter)
        counts["krylov.trips"] += 1
    resnorm = norm(r, dim=-1).double()
    return x, {"iters": k, "resnorm": resnorm, "converged": resnorm <= tol}


def bicgstab_batched(matvec, b, minv=None, *, rtol=1e-8, atol=0.0,
                     maxiter=1000, active=None):
    """:func:`bicgstab` for M systems at once (arguments and result as in
    :func:`pcg_batched`)."""
    x = torch.zeros_like(b)
    apply_pc = _preconditioner(minv)
    M = b.shape[0]
    k = torch.zeros(M, dtype=torch.int64, device=b.device)
    active = (torch.ones_like(k, dtype=torch.bool) if active is None
              else active)
    tol = torch.clamp_min(rtol * norm(b, dim=-1).double(), atol)
    r = b - matvec(x)
    rhat = r
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones(M, dtype=b.dtype, device=b.device)
    live = _live(active, r, tol, k, maxiter)
    while bool(live.any()):
        rho_new = dot(rhat, r, dim=-1)
        beta = (rho_new / torch.where(rho == 0, 1.0, rho)) * (
            alpha / torch.where(omega == 0, 1.0, omega))
        p_new = r + beta[:, None] * (p - omega[:, None] * v)
        phat = apply_pc(p_new)
        v_new = matvec(phat)
        denom = dot(rhat, v_new, dim=-1)
        alpha_new = rho_new / torch.where(denom == 0, 1.0, denom)
        s = r - alpha_new[:, None] * v_new
        shat = apply_pc(s)
        t = matvec(shat)
        tt = dot(t, t, dim=-1)
        omega_new = dot(t, s, dim=-1) / torch.where(tt == 0, 1.0, tt)
        lv = live[:, None]
        x = torch.where(lv, x + alpha_new[:, None] * phat
                        + omega_new[:, None] * shat, x)
        r = torch.where(lv, s - omega_new[:, None] * t, r)
        p = torch.where(lv, p_new, p)
        v = torch.where(lv, v_new, v)
        rho = torch.where(live, rho_new, rho)
        alpha = torch.where(live, alpha_new, alpha)
        omega = torch.where(live, omega_new, omega)
        k = k + live
        live = _live(live, r, tol, k, maxiter)
        counts["krylov.trips"] += 1
    resnorm = norm(r, dim=-1).double()
    return x, {"iters": k, "resnorm": resnorm, "converged": resnorm <= tol}


def _preconditioner(minv):
    if minv is None:
        return lambda r: r
    if callable(minv):
        return minv
    return lambda r: minv * r


SOLVERS = {"cg": pcg, "bicgstab": bicgstab}
BATCHED_SOLVERS = {"cg": pcg_batched, "bicgstab": bicgstab_batched}


def get_solver(name: str, batched: bool = False):
    """The solver ``name`` ('cg' or 'bicgstab'), or its batched form."""
    if name not in SOLVERS:
        raise ValueError(f"Krylov solver must be one of {sorted(SOLVERS)}, "
                         f"got {name!r}")
    return (BATCHED_SOLVERS if batched else SOLVERS)[name]
