"""Constitutive relations of the SHAKTI model on torch tensors.

Port of shakti_tpu/physics/constitutive.py: every function is the same
array -> array map (nodal, quadrature-point or per-cell values alike) and is
differentiable by torch's forward AD, which the element Jacobian uses
(physics/residual.element_jacobian).  Gradients of P1 fields are cellwise
constants computed by the FEM layer (fem/ops.cell_grad) and passed in.
"""

from __future__ import annotations

import torch

from shakti_tpu_torch.params import PhysicalParams


def head(N, z_b, z_s, p: PhysicalParams):
    """Hydraulic head [m]:  h = z_b + (rho_i/rho_w)(z_s - z_b) - N/(rho_w g)."""
    return z_b + (p.rho_i / p.rho_w) * (z_s - z_b) - N / (p.rho_w * p.g)


def head_gradient(grad_zb, grad_zs, grad_N, p: PhysicalParams):
    """grad(h) given gradients of its ingredients (all (..., 2) tensors)."""
    r = p.rho_i / p.rho_w
    return grad_zb + r * (grad_zs - grad_zb) - grad_N / (p.rho_w * p.g)


def background_head_gradient(grad_zb, grad_zs, p: PhysicalParams):
    """grad(h) at N == 0: the 'background' hydraulic gradient."""
    r = p.rho_i / p.rho_w
    return grad_zb + r * (grad_zs - grad_zb)


def background_potential(z_b, z_s, p: PhysicalParams):
    """rho_w g h(N=0) [Pa]: outflow detection and meshing, not the PDE."""
    return p.rho_w * p.g * head(torch.zeros_like(z_b), z_b, z_s, p)


def water_flux(b, grad_h, Re, p: PhysicalParams):
    """q = -|b|^3 g grad(h) / (12 nu (1 + omega Re)); b, Re (...,),
    grad_h (..., 2)."""
    coeff = -(torch.abs(b) ** 3) * p.g / (12.0 * p.nu * (1.0 + p.omega * Re))
    return coeff[..., None] * grad_h


def transmissivity(b, Re, p: PhysicalParams):
    """Scalar coefficient T such that q = -T grad(h)."""
    return (torch.abs(b) ** 3) * p.g / (12.0 * p.nu * (1.0 + p.omega * Re))


def reynolds(q, p: PhysicalParams):
    """Local Reynolds number |q| / nu.  The where-guards keep the value
    bit-identical to a plain sqrt and choose the subgradient 0 at q == 0
    (sqrt's derivative there is inf -> NaN under AD)."""
    s = torch.sum(q * q, dim=-1)
    live = s > 0
    return torch.where(live, torch.sqrt(torch.where(live, s, 1.0)), 0.0) / p.nu


def melt_opening(q, grad_h, G, p: PhysicalParams):
    """Dissipation + geothermal melt m0 = (G - rho_w g q . grad(h)) / Lh."""
    qdot = torch.sum(q * grad_h, dim=-1)
    return (G - p.rho_w * p.g * qdot) / p.Lh


def melt_regularization(b, melt, grad_b, grad_melt):
    """Warburton et al. (2024) melt-diffusion term within a cell:
    c . (m grad(b) + b grad(m)) / (1 + |c|^2) with c = grad(b)."""
    denom = 1.0 + torch.sum(grad_b * grad_b, dim=-1)
    num = torch.sum(grad_b * (melt[..., None] * grad_b
                              + b[..., None] * grad_melt), dim=-1)
    return num / denom


def melt(q, grad_h, G, b, melt_prev, grad_b, grad_melt_prev, p: PhysicalParams):
    """Full melt rate m = m0 + m_diff (lagged b and melt in m_diff)."""
    return (melt_opening(q, grad_h, G, p)
            + melt_regularization(b, melt_prev, grad_b, grad_melt_prev))


def closure(b, N, p: PhysicalParams):
    """Viscous creep closure C = A b N |N|^(n-1) [m/s]."""
    return p.A * b * N * torch.abs(N) ** (p.n - 1.0)


def closure_rate(N, p: PhysicalParams):
    """Creep-closure rate per unit gap, C/b = A N |N|^(n-1) [1/s]."""
    return p.A * N * torch.abs(N) ** (p.n - 1.0)
