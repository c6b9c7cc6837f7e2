"""SHMIP F5 from the cold start at 2-hour steps in scalar ELL: the port
against the JAX package's steps (tests/torch_f5_ref.json), float64 on the
CPU.  In this format both packages converge at every step, with equal
Newton counts: N within 1e-12 of scale through step 3, and within 1e-3
after step 4, a hard step of 26 Newton iterations whose CG counts part
(tests/torch_f5.py; the block-ELL side is tests/test_torch_f5_bell.py)."""

import pytest

from tests import torch_f5 as F
from tests import torch_parity  # noqa: F401  (pins torch's threads)


@pytest.fixture(scope="module")
def runs():
    return F.port_steps("ell"), F.reference("ell")


def test_f5_ell_converges_with_jax_newton_counts(runs):
    port, jax = runs
    assert [r["converged"] for r in jax] == [True] * len(jax)
    assert [r["converged"] for r in port] == [True] * len(port)
    assert [r["newton"] for r in port] == [r["newton"] for r in jax]


@pytest.mark.parametrize("k", range(5))
def test_f5_ell_N_as_jax(runs, k):
    port, jax = runs
    tol = 1e-12 if k <= 3 else 1e-3
    assert F.rel_err(port[k]["N"], jax[k]["N"]) <= tol
