"""Plain reference of one SHAKTI timestep, written from the model's equations.

SHAKTI (Sommers et al. 2018, GMD 11:2955) on P1 triangles: effective
pressure N from the weak form

    F_i(N) = sum_cells area * [ sum_q w_q T_q grad(h) . grad(phi_i)
             + sum_q w_q phi_qi ((1/rho_i - 1/rho_w) m_q - C_q
                                  - storage_q (N_q - Nn_q) / (rho_w g dt)
                                  - inputs_q) ] = 0,

grad(h) = grad(h0) - grad(N) / (rho_w g), with the gap b, the flux q (so
the transmissivity T and Reynolds number) and the lagged melt frozen at the
step's start; then the explicit update of q (Reynolds number from the old
q), the melt (new q; old b and melt in the Warburton et al. 2024
regularization) and b (forward Euler with the new q and melt, clamped to
[b_min, b_max]).  Cell quantities reach the nodes by area-weighted averages.

This file imports torch and numpy only.  It takes the mesh and the input
fields as the benchmark made them, in the benchmark's node order, and works
everything else out itself: geometry, quadrature values, the Dirichlet
nodes, the frozen per-step data.  It serves three purposes:

- :func:`judge`: how far a computed step (a state before it and after it)
  lies from the discrete equations (the residual of N as a relative change
  of N) and from the explicit update worked out from that N;
- :func:`step`: the step computed here (damped Newton, matrix-free
  BiCGStab with a Jacobi preconditioner), in any floating type: the
  control in bfloat16, and the CPU tests' yardstick in float64;
- :func:`dirichlet_nodes`: the outflow nodes from a predicate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# SI constants of the model (Sommers et al. 2018, Table 1)
PARAMS = dict(g=9.81, rho_i=917.0, rho_w=1000.0, nu=1.787e-6, Lh=3.34e5,
              omega=1e-3, n=3.0, A=2.24e-24)

# Dunavant's 6-point rule, exact to degree 4: barycentric points, weights
# summing to 1
_A1, _B1 = 0.816847572980459, 0.091576213509771
_A2, _B2 = 0.108103018168070, 0.445948490915965
_W1, _W2 = 0.109951743655322, 0.223381589678011
QUAD_POINTS = np.array([[_A1, _B1, _B1], [_B1, _A1, _B1], [_B1, _B1, _A1],
                        [_A2, _B2, _B2], [_B2, _A2, _B2], [_B2, _B2, _A2]])
QUAD_WEIGHTS = np.array([_W1, _W1, _W1, _W2, _W2, _W2])


def dirichlet_nodes(nodes, cells, predicate) -> np.ndarray:
    """Bool (n,): the nodes of every boundary edge (an edge of one triangle
    only) whose two ends satisfy ``predicate`` ((m, 2) -> (m,) bool)."""
    e = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]])
    lo, hi = e.min(1).astype(np.int64), e.max(1).astype(np.int64)
    _, first, count = np.unique(lo * nodes.shape[0] + hi, return_index=True,
                                return_counts=True)
    edges = e[first[count == 1]]
    ok = predicate(nodes[edges[:, 0]]) & predicate(nodes[edges[:, 1]])
    mask = np.zeros(nodes.shape[0], bool)
    mask[edges[ok].reshape(-1)] = True
    return mask


@dataclasses.dataclass
class Problem:
    """The mesh and the static fields on one device in one type."""

    cells: torch.Tensor      # (c, 3) int64
    area: torch.Tensor       # (c,)
    grads: torch.Tensor      # (c, 3, 2) gradients of the hat functions
    node_area: torch.Tensor  # (n,) summed area of the adjacent cells
    phi: torch.Tensor        # (nq, 3)
    wq: torch.Tensor         # (nq,)
    gh0: torch.Tensor        # (c, 2) grad(h) at N = 0
    G_q: torch.Tensor        # (c, nq)
    inputs_q: torch.Tensor   # (c, nq)
    storage_q: torch.Tensor  # (c, nq)
    G: torch.Tensor          # (n,)
    dirichlet: torch.Tensor  # (n,) bool
    N_bdry: float
    b_min: float
    b_max: torch.Tensor | None

    @property
    def n(self) -> int:
        return self.node_area.shape[0]


def build_problem(nodes, cells, *, z_b, z_s, G, inputs, storage, dirichlet,
                  N_bdry, b_min, b_max=None, dtype=torch.float64,
                  device="cpu") -> Problem:
    """The geometry (in float64 on the host, then cast) and the static
    fields' quadrature values of a mesh ``nodes`` (n, 2), ``cells`` (c, 3)."""
    nodes = np.asarray(nodes, np.float64)
    cells = np.asarray(cells, np.int64)
    p = nodes[cells]                                       # (c, 3, 2)
    x, y = p[..., 0], p[..., 1]
    twice = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
             - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
    # grad(phi_i) = (y_j - y_k, x_k - x_j) / (2 A), (i, j, k) cyclic
    j, k = [1, 2, 0], [2, 0, 1]
    grads = np.stack([y[:, j] - y[:, k], x[:, k] - x[:, j]], -1) \
        / twice[:, None, None]
    area = 0.5 * np.abs(twice)
    node_area = np.bincount(cells.reshape(-1), np.repeat(area, 3),
                            minlength=nodes.shape[0])
    node_area[node_area == 0.0] = 1.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(
            dtype)

    prob = Problem(cells=torch.as_tensor(cells, device=device), area=t(area),
                   grads=t(grads), node_area=t(node_area),
                   phi=t(QUAD_POINTS), wq=t(QUAD_WEIGHTS), gh0=None,
                   G_q=None, inputs_q=None, storage_q=None, G=t(G),
                   dirichlet=torch.as_tensor(np.asarray(dirichlet, bool),
                                             device=device),
                   N_bdry=float(N_bdry), b_min=float(b_min),
                   b_max=None if b_max is None else t(b_max))
    r = PARAMS["rho_i"] / PARAMS["rho_w"]
    gzb, gzs = cell_grad(prob, t(z_b)), cell_grad(prob, t(z_s))
    prob.gh0 = gzb + r * (gzs - gzb)
    prob.G_q = at_quad(prob, t(G))
    prob.inputs_q = at_quad(prob, t(inputs))
    prob.storage_q = at_quad(prob, t(storage))
    return prob


def corners(prob: Problem, f):
    """(n, ...) -> (c, 3, ...)."""
    return f[prob.cells]


def cell_grad(prob: Problem, f):
    """The cellwise gradient (c, 2) of a nodal field (n,), from its corner
    values less their mean (the hat gradients sum to zero)."""
    fc = corners(prob, f)
    fc = fc - fc.mean(1, keepdim=True)
    return (fc[:, :, None] * prob.grads).sum(1)


def at_quad(prob: Problem, f):
    """A nodal field (n,) at the quadrature points (c, nq)."""
    return corners(prob, f) @ prob.phi.T


def to_nodes(prob: Problem, v):
    """Sum of per-(cell, corner) values (c, 3) at the nodes (n,)."""
    out = torch.zeros(prob.n, dtype=v.dtype, device=v.device)
    return out.index_add_(0, prob.cells.reshape(-1), v.reshape(-1))


def node_average(prob: Problem, v):
    """Area-weighted average at the nodes of per-(cell, corner) values."""
    return to_nodes(prob, v * prob.area[:, None]) / prob.node_area


def reynolds(q):
    return torch.sqrt((q * q).sum(-1)) / PARAMS["nu"]


def transmissivity(b, Re):
    P = PARAMS
    return b.abs() ** 3 * P["g"] / (12.0 * P["nu"] * (1.0 + P["omega"] * Re))


def closure(b, N):
    return PARAMS["A"] * b * N * N.abs() ** (PARAMS["n"] - 1.0)


def melt_regularization(b, m, grad_b, grad_m):
    """grad(b) . (m grad(b) + b grad(m)) / (1 + |grad(b)|^2); b, m (c, k),
    the gradients (c, 2)."""
    gb = grad_b[:, None, :]
    num = (gb * (m[..., None] * gb + b[..., None] * grad_m[:, None, :])).sum(-1)
    return num / (1.0 + (grad_b * grad_b).sum(-1))[:, None]


@dataclasses.dataclass
class Frozen:
    """The data frozen over one N solve, at the quadrature points."""

    T: torch.Tensor      # (c, nq)
    q: torch.Tensor      # (c, nq, 2)
    b: torch.Tensor      # (c, nq)
    mdiff: torch.Tensor  # (c, nq)
    Nn: torch.Tensor     # (c, nq)
    dt: float


def freeze_step(prob: Problem, N, b, q, melt, dt) -> Frozen:
    """Transmissivity, flux, gap, melt regularization and previous N at the
    quadrature points, from the state at the step's start."""
    q_q = torch.stack([at_quad(prob, q[:, 0]), at_quad(prob, q[:, 1])], -1)
    b_q = at_quad(prob, b)
    mdiff = melt_regularization(b_q, at_quad(prob, melt),
                                cell_grad(prob, b), cell_grad(prob, melt))
    return Frozen(T=transmissivity(b_q, reynolds(q_q)), q=q_q, b=b_q,
                  mdiff=mdiff, Nn=at_quad(prob, N), dt=float(dt))


def element_terms(prob: Problem, N_c, fz: Frozen):
    """Per-(cell, corner) contributions to F (c, 3) from the corner values
    N_c (c, 3), and the sum of the magnitudes of their terms (c, 3)."""
    P = PARAMS
    rwg = P["rho_w"] * P["g"]
    Nc = N_c - N_c.mean(1, keepdim=True)
    grad_h = prob.gh0 - (Nc[:, :, None] * prob.grads).sum(1) / rwg   # (c, 2)
    # the flux term: -sum_q w_q q_w . grad(phi_i), q_w = -T grad(h)
    Tbar = fz.T @ prob.wq                                            # (c,)
    flux = Tbar[:, None] * (prob.grads * grad_h[:, None, :]).sum(-1)  # (c, 3)
    qdgh = (fz.q * grad_h[:, None, :]).sum(-1)                        # (c, nq)
    m = (prob.G_q - rwg * qdgh) / P["Lh"] + fz.mdiff
    N_q = N_c @ prob.phi.T
    parts = ((1.0 / P["rho_i"] - 1.0 / P["rho_w"]) * m,
             -closure(fz.b, N_q),
             -prob.storage_q * (N_q - fz.Nn) / (rwg * fz.dt),
             -prob.inputs_q)
    wphi = prob.wq[:, None] * prob.phi                                # (nq, 3)
    src = sum(parts) @ wphi
    size = flux.abs() + sum(t.abs() for t in parts) @ wphi
    a = prob.area[:, None]
    return a * (flux + src), a * size


def residual(prob: Problem, N, fz: Frozen):
    """F(N) (n,) with the Dirichlet rows zeroed, and the nodes' term sizes."""
    F_c, S_c = element_terms(prob, corners(prob, N), fz)
    F = torch.where(prob.dirichlet, 0.0, to_nodes(prob, F_c))
    return F, to_nodes(prob, S_c)


def explicit_update(prob: Problem, N, b, q_old, melt_old, dt):
    """(q, melt, b) after the step from the solved N and the state at the
    step's start."""
    P = PARAMS
    rwg = P["rho_w"] * P["g"]
    grad_N, grad_b = cell_grad(prob, N), cell_grad(prob, b)
    grad_m_old = cell_grad(prob, melt_old)
    grad_h = prob.gh0 - grad_N / rwg                                  # (c, 2)
    b_c, m_old_c = corners(prob, b), corners(prob, melt_old)
    w = prob.area[:, None]
    grad_h_n = torch.stack([
        to_nodes(prob, (w * grad_h[:, d:d + 1]).expand(-1, 3))
        for d in range(2)], -1) / prob.node_area[:, None]
    mdiff_old = node_average(prob, melt_regularization(b_c, m_old_c, grad_b,
                                                       grad_m_old))
    Tn = transmissivity(b, reynolds(q_old))
    q = -Tn[:, None] * grad_h_n
    m0 = (prob.G - rwg * (q * grad_h_n).sum(-1)) / P["Lh"]
    melt = m0 + mdiff_old
    mdiff_new = node_average(prob, melt_regularization(
        b_c, corners(prob, melt), grad_b, cell_grad(prob, melt)))
    b_new = b + dt * ((m0 + mdiff_new) / P["rho_i"] - closure(b, N))
    b_new = torch.clamp_min(b_new, prob.b_min)
    if prob.b_max is not None:
        b_new = torch.minimum(b_new, prob.b_max)
    return q, melt, b_new


def judge(prob: Problem, before, after, dt) -> dict:
    """How far the step ``before`` -> ``after`` (dicts of N, b, q, melt in
    the problem's node order) lies from the reference's, in the problem's
    type:

    - n_resid: the largest |F_i(N)| over the largest sum_j |dF_i/dN_j|
      |N_j| (the residual as a relative change of N, in the largest-row
      norm: the program's Newton stops on a norm over all rows, so a weakly
      coupled row may keep a larger share), and on the Dirichlet rows the
      largest error of N against its boundary value, relative;
    - q_err, melt_err: the largest error of q and of the melt against the
      explicit update from ``after``'s N, relative to their largest value;
    - b_err: the same for b, relative to the largest change of b."""
    fz = freeze_step(prob, before["N"], before["b"], before["q"],
                     before["melt"], dt)
    N = after["N"]
    F, _ = residual(prob, N, fz)
    J = element_jacobian(prob, N, fz)
    size = to_nodes(prob, (J.abs() * corners(prob, N).abs()[:, None, :]).sum(-1))
    free = ~prob.dirichlet
    n_resid = (F.abs().max() / size[free].max()).item()
    if bool(prob.dirichlet.any()):
        n_resid = max(n_resid, ((N[prob.dirichlet] - prob.N_bdry).abs().max()
                                / abs(prob.N_bdry)).item())
    q, melt, b = explicit_update(prob, N, before["b"], before["q"],
                                 before["melt"], dt)

    def rel(got, ref, scale):
        return ((got - ref).abs().max() / scale.abs().max()).item()

    return dict(n_resid=n_resid, q_err=rel(after["q"], q, q),
                melt_err=rel(after["melt"], melt, melt),
                b_err=rel(after["b"], b, b - before["b"]))


def element_jacobian(prob: Problem, N, fz: Frozen):
    """dF_ci / dN_cj (c, 3, 3) by forward-mode differentiation."""
    N_c = corners(prob, N)
    cols = []
    for j in range(3):
        tangent = torch.zeros_like(N_c)
        tangent[:, j] = 1.0
        cols.append(torch.func.jvp(
            lambda x: element_terms(prob, x, fz)[0], (N_c,), (tangent,))[1])
    return torch.stack(cols, -1)


def bicgstab(matvec, rhs, minv, rtol, maxiter):
    """BiCGStab with the diagonal preconditioner ``minv``; stops at
    ||r|| <= rtol ||rhs|| or after ``maxiter`` iterations."""
    x = torch.zeros_like(rhs)
    r = rhs.clone()
    rhat, p, v = r.clone(), torch.zeros_like(r), torch.zeros_like(r)
    rho = alpha = omega = 1.0
    tol = rtol * float(torch.linalg.vector_norm(rhs.double()))
    for _ in range(maxiter):
        if not float(torch.linalg.vector_norm(r.double())) > tol:
            break
        rho_new = float(torch.dot(rhat.double(), r.double()))
        if rho_new == 0.0 or omega == 0.0:
            break
        p = r + (rho_new / rho) * (alpha / omega) * (p - omega * v)
        ph = minv * p
        v = matvec(ph)
        den = float(torch.dot(rhat.double(), v.double()))
        if den == 0.0:
            break
        alpha = rho_new / den
        s = r - alpha * v
        sh = minv * s
        t = matvec(sh)
        tt = float(torch.dot(t.double(), t.double()))
        omega = float(torch.dot(t.double(), s.double())) / tt if tt else 0.0
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
    return x


def solve_N(prob: Problem, fz: Frozen, N_start, *, rtol=1e-12, max_newton=50,
            lin_rtol=1e-12, lin_maxiter=20_000):
    """Damped Newton for F(N) = 0 from ``N_start`` in the problem's type:
    each update solves A dN = F, A = -dF/dN with the Dirichlet rows and
    columns eliminated, by BiCGStab; up to four halvings of the step while
    the residual does not fall."""
    d = prob.dirichlet
    N = torch.where(d, prob.N_bdry, N_start)

    def norm(F):
        return float(torch.linalg.vector_norm(F.double()))

    F = residual(prob, N, fz)[0]
    r0 = rn = norm(F)
    for _ in range(max_newton):
        if not rn > rtol * r0:
            break
        J = element_jacobian(prob, N, fz)
        diag = -to_nodes(prob, torch.diagonal(J, dim1=1, dim2=2))
        tiny = torch.finfo(N.dtype).tiny
        minv = torch.where(d | (diag.abs() < tiny), 1.0,
                           1.0 / torch.where(diag == 0, 1.0, diag))

        def matvec(x, J=J):
            xc = corners(prob, torch.where(d, 0.0, x))
            return torch.where(d, x, -to_nodes(prob, (J * xc[:, None, :]).sum(-1)))

        dN = bicgstab(matvec, F, minv, lin_rtol, lin_maxiter)
        a = 1.0
        for _ in range(5):
            N_try = N + a * dN
            F_try = residual(prob, N_try, fz)[0]
            rn_try = norm(F_try)
            if rn_try < rn:
                break
            a *= 0.5
        if not rn_try < rn:
            break
        N, F, rn = N_try, F_try, rn_try
    return N


def step(prob: Problem, state: dict, dt, **solver) -> dict:
    """One timestep from ``state`` (N, b, q, melt): Newton from the state's
    N, then the explicit update; everything in the problem's type."""
    fz = freeze_step(prob, state["N"], state["b"], state["q"], state["melt"],
                     dt)
    N = solve_N(prob, fz, state["N"], **solver)
    q, melt, b = explicit_update(prob, N, state["b"], state["q"],
                                 state["melt"], dt)
    return dict(N=N, b=b, q=q, melt=melt)
