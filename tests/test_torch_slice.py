"""The slice end to end on the CPU in float64: the slab and lake golden cases
through the port's freeze/make_step_fn/run_window against the oracle
goldens (tests/test_goldens.py's tolerance), and step by step against
shakti_tpu with the block-ELL operator on both sides."""

import jax
import numpy as np
import pytest
import torch

from shakti_tpu.solve.timestep import make_step_fn as jstep_fn
from shakti_tpu.solve.timestep import timestep_sizes as jdts
from shakti_tpu_torch.convert import problem_from_numpy
from shakti_tpu_torch.solve.timestep import make_step_fn, run_window, timestep_sizes
from tests import golden_cases as jcases
from tests import torch_golden_cases as tcases
from tests.torch_parity import frozen_to_numpy, rel_err


@pytest.mark.parametrize("case", ["slab_case", "lake_case"])
def test_port_matches_golden(case):
    md, n, fname = getattr(tcases, case)()
    md.dtype, md.device = torch.float64, "cpu"
    mesh, static, state, cfg = md.freeze()
    assert md.node_iperm is not None and cfg.lag_operator
    step = make_step_fn(mesh, static, md.params, cfg)
    state, diags = run_window(step, state,
                              timestep_sizes(md.timesteps, md.dtype)[:n])
    assert diags["converged"].all()
    errs = tcases.golden_errors(md, state, fname)
    assert max(errs.values()) <= tcases.GOLDEN_ATOL, errs


@pytest.mark.parametrize("case", ["slab_case", "lake_case"])
def test_port_steps_match_jax_bell(case):
    """Same frozen problem (convert.py), same dt per step: N/b/q/melt at
    1e-9 of scale and equal Newton counts after every step."""
    md, n, _ = getattr(jcases, case)()
    md.operator = "bell"
    mesh, static, state, cfg = md.freeze()
    jstep = jax.jit(jstep_fn(mesh, static, md.params, cfg))
    dts = np.asarray(jdts(md.timesteps, dtype=md.dtype))[:n]
    tm, ts, tstate, tcfg = problem_from_numpy(
        *frozen_to_numpy(mesh, static, state, cfg))
    tstep = make_step_fn(tm, ts, md.params, tcfg)
    tdts = timestep_sizes(md.timesteps, torch.float64)[:n]
    np.testing.assert_array_equal(tdts.numpy(), dts)
    for i in range(n):
        state, d = jstep(state, dts[i])
        tstate, td = tstep(tstate, tdts[i])
        assert td["converged"] and bool(d["converged"]), i
        assert td["newton_iters"] == int(d["newton_iters"]), i
        for k in ("N", "b", "q", "melt"):
            err = rel_err(getattr(tstate, k).numpy(), np.asarray(getattr(state, k)))
            assert err <= 1e-9, (i, k, err)
