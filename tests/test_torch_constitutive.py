"""shakti_tpu_torch.physics.constitutive vs shakti_tpu's, function by
function, on the same seeded inputs in float64 (rtol 1e-13: the same
elementwise formulas, only op scheduling may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shakti_tpu.params import DEFAULT_PARAMS as P
from shakti_tpu.physics import constitutive as jlaw
from shakti_tpu_torch.physics import constitutive as tlaw
from tests import torch_parity  # noqa: F401  (pins torch's threads)

RTOL = 1e-13


def _inputs(rng, n=64):
    N = 1e5 + 1e5 * rng.normal(size=n)
    N[::7] = 0.0                                    # N = 0 rows
    q = 1e-4 * rng.normal(size=(n, 2))
    q[::5] = 0.0                                    # q = 0 rows
    g2 = lambda s: s * rng.normal(size=(n, 2))      # noqa: E731
    return {
        "N": N, "z_b": 100 * rng.normal(size=n),
        "z_s": 1000 + 100 * rng.normal(size=n), "b": 1e-3 * rng.normal(size=n),
        "Re": np.abs(10 * rng.normal(size=n)), "q": q, "G": 0.05 + 0 * N,
        "melt": 1e-7 * rng.normal(size=n), "grad_zb": g2(1e-2),
        "grad_zs": g2(1e-2), "grad_N": g2(10.0), "grad_h": g2(1e-2),
        "grad_b": g2(1e-6), "grad_melt": g2(1e-10),
    }


CASES = {
    "head": ("N", "z_b", "z_s"),
    "head_gradient": ("grad_zb", "grad_zs", "grad_N"),
    "background_head_gradient": ("grad_zb", "grad_zs"),
    "background_potential": ("z_b", "z_s"),
    "water_flux": ("b", "grad_h", "Re"),
    "transmissivity": ("b", "Re"),
    "reynolds": ("q",),
    "melt_opening": ("q", "grad_h", "G"),
    "melt_regularization": ("b", "melt", "grad_b", "grad_melt"),
    "melt": ("q", "grad_h", "G", "b", "melt", "grad_b", "grad_melt"),
    "closure": ("b", "N"),
    "closure_rate": ("N",),
}
NO_PARAMS = {"melt_regularization"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_constitutive_matches_jax(name):
    data = _inputs(np.random.default_rng(sorted(CASES).index(name)))
    args = [data[k] for k in CASES[name]]
    extra = () if name in NO_PARAMS else (P,)
    ref = np.asarray(getattr(jlaw, name)(*[jnp.asarray(a) for a in args], *extra))
    got = getattr(tlaw, name)(*[torch.as_tensor(a) for a in args], *extra)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def test_reynolds_zero_flux_value_and_derivative_finite():
    """Re(0) = 0 exactly, and forward AD through the q = 0 guard gives the
    subgradient 0 instead of NaN."""
    q = torch.tensor([[0.0, 0.0], [3e-4, 4e-4]], dtype=torch.float64)
    Re, dRe = torch.func.jvp(lambda x: tlaw.reynolds(x, P), (q,),
                             (torch.ones_like(q),))
    assert Re[0].item() == 0.0
    assert Re[1].item() == pytest.approx(5e-4 / P.nu, rel=1e-15)
    assert torch.isfinite(dRe).all() and dRe[0].item() == 0.0
