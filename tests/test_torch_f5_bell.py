"""SHMIP F5 from the cold start at 2-hour steps in block-ELL, the format
"auto" picks on a TPU and on the port: the port against the JAX package's
steps (tests/torch_f5_ref.json), float64 on the CPU.  Both packages take
the same path: equal Newton counts through step 4, N within 1e-10 of
scale through step 3, and at step 4 both stop unconverged, where both
converge in scalar ELL (tests/test_torch_f5_ell.py).  The divergence of F5
at these steps is the block-ELL path's, in the reference as in the port
(ROADMAP §3): with the operator carry off, the JAX package's block-ELL run
converges at every step with ELL's Newton counts through step 3 (the
record's ``bell_nolag``; the port's side is ``python -m tests.torch_f5
bell_nolag``)."""

import pytest

from tests import torch_f5 as F
from tests import torch_parity  # noqa: F401  (pins torch's threads)


@pytest.fixture(scope="module")
def runs():
    return F.port_steps("bell"), F.reference("bell")


def test_f5_bell_newton_counts_as_jax(runs):
    port, jax = runs
    assert [r["newton"] for r in port] == [r["newton"] for r in jax]


def test_f5_bell_parts_from_ell_in_both_packages(runs):
    port, jax = runs
    ell = F.reference("ell")
    assert all(r["converged"] for r in ell)
    assert [r["converged"] for r in port[:4]] == [True] * 4
    assert [r["converged"] for r in jax[:4]] == [True] * 4
    assert not port[4]["converged"] and not jax[4]["converged"]


@pytest.mark.parametrize("k", range(4))
def test_f5_bell_N_as_jax(runs, k):
    port, jax = runs
    assert F.rel_err(port[k]["N"], jax[k]["N"]) <= 1e-10


def test_f5_bell_without_the_operator_carry_converges_in_jax():
    ell, nolag = F.reference("ell"), F.reference("bell_nolag")
    assert all(r["converged"] for r in nolag)
    assert [r["newton"] for r in nolag[:4]] == [r["newton"] for r in ell[:4]]
