"""The differentiable transient of the port (shakti_tpu_torch/solve/
implicit.py, the implicit-function adjoint as a torch.autograd.Function, and
solve/timestep.make_runner) against shakti_tpu's custom VJP, in float64 on
the CPU, with tests/test_adjoint.py's tight solver settings (the adjoint is
exact only where F(N*) = 0 holds to roundoff):

- on the 12x12 slab over 5 hourly steps, the gradients of JAX's losses
  equal jax.grad's within rel 1e-8: d mean(N)/d inputs_scale, the gradient
  with respect to an initial gap b that has nodes at b_min (where the clamp
  b >= b_min ties and both packages split the gradient in halves), and the
  gradient with respect to the (n,) inputs field through make_runner;
- the forward trajectory is bitwise the one of differentiable=False;
- N_init gets a zero gradient; SHAKTI_ADJOINT_STRICT=1 turns an unconverged
  adjoint into NaN (else a warning); lag_operator=True raises;
- one central difference in the port; the adjoint in block-ELL, scalar ELL
  and the matrix-free operator on the 8x8 slab agree.
The distributed adjoint (tests/test_adjoint.py's two dist tests) waits for
the port of parallel/dist.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import setups.setup_slab as jslab
from shakti_tpu.solve import timestep as jts
from shakti_tpu_torch.convert import problem_from_numpy
from shakti_tpu_torch.setups import setup_slab as tslab
from shakti_tpu_torch.solve import timestep as tts
from tests.torch_parity import frozen_to_numpy, rel_err

TIGHT = dict(adaptive_dt_levels=0, lag_operator=False, rtol=1e-12,
             atol=1e-13, lin_rtol=1e-12, differentiable=True)


def _b_at_floor(n, b_min):
    """b = 0.01 with every fifth node at b_min."""
    b = np.full(n, 0.01)
    b[::5] = b_min
    return b


@pytest.fixture(scope="module")
def case():
    """The 12x12 slab frozen by the JAX package, and jax.grad of the three
    losses (the one shared JAX computation of this file)."""
    md = jslab.initialize(nx=12, ny=12, days=5 / 24.0, nt_per_day=24)
    md.b_init = np.full(md.x.size, 0.01)
    md.solver = dataclasses.replace(md.solver, **TIGHT)
    mesh, static, state, cfg = md.freeze()
    step = jts.make_step_fn(mesh, static, md.params, cfg)
    dts = jts.timestep_sizes(md.timesteps, dtype=md.dtype)
    b0 = jnp.asarray(_b_at_floor(mesh.n_nodes, md.b_min))
    base = static.inputs + 1e-7
    runner = jts.make_runner(md.params, cfg)

    def loss_scale(s):
        out, _ = jts.run_window(step, state,
                                {"dt": dts, "inputs_scale": jnp.full_like(dts, s)})
        return jnp.mean(out.N)

    def loss_b(b):
        out, _ = jts.run_window(step, dataclasses.replace(state, b=b), dts)
        return jnp.mean(out.N) / 1e5 + 1e3 * jnp.mean(out.b)

    def loss_inputs(inputs):
        out, _ = runner(mesh, dataclasses.replace(static, inputs=inputs),
                        state, dts)
        return jnp.mean(out.N) / 1e5

    grads = {"scale": float(jax.jit(jax.grad(loss_scale))(1.0)),
             "b": np.asarray(jax.jit(jax.grad(loss_b))(b0)),
             "inputs": np.asarray(jax.jit(jax.grad(loss_inputs))(base))}
    tm, tsf, tstate, tcfg = problem_from_numpy(
        *frozen_to_numpy(mesh, static, state, cfg))
    return dict(md=md, mesh=tm, static=tsf, state=tstate, cfg=tcfg,
                dts=tts.timestep_sizes(md.timesteps, torch.float64),
                b0=torch.as_tensor(np.array(b0)),
                base=torch.as_tensor(np.array(base)), jax=grads)


def _scale_loss(c, step=None):
    step = step or tts.make_step_fn(c["mesh"], c["static"], c["md"].params,
                                    c["cfg"])

    def loss(s):
        out, d = tts.run_window(step, c["state"], {
            "dt": c["dts"], "inputs_scale": s.expand(c["dts"].shape[0])})
        assert d["converged"].all()
        return out.N.mean()
    return loss


def _grad(loss, x):
    x = x.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x), x)
    return g


def test_gradient_wrt_forcing_scale_matches_jax(case):
    g = _grad(_scale_loss(case), torch.tensor(1.0, dtype=torch.float64))
    assert rel_err(g.item(), case["jax"]["scale"]) <= 1e-8, (
        g.item(), case["jax"]["scale"])


def test_gradient_wrt_initial_gap_at_b_min_matches_jax(case):
    """The state-to-state chain b0 -> pre -> N* -> b1 ..., from a gap with
    nodes at b_min."""
    c = case
    step = tts.make_step_fn(c["mesh"], c["static"], c["md"].params, c["cfg"])

    def loss(b):
        out, _ = tts.run_window(step, dataclasses.replace(c["state"], b=b),
                                c["dts"])
        return out.N.mean() / 1e5 + 1e3 * out.b.mean()

    g = _grad(loss, c["b0"]).numpy()
    assert np.abs(c["jax"]["b"]).max() > 0
    assert rel_err(g, c["jax"]["b"]) <= 1e-8


def test_gradient_wrt_inputs_field_through_make_runner_matches_jax(case):
    c = case
    runner = tts.make_runner(c["md"].params, c["cfg"])

    def loss(inputs):
        out, _ = runner(c["mesh"], dataclasses.replace(c["static"],
                                                       inputs=inputs),
                        c["state"], c["dts"])
        return out.N.mean() / 1e5

    g = _grad(loss, c["base"]).numpy()
    assert rel_err(g, c["jax"]["inputs"]) <= 1e-8


def test_forward_trajectory_unchanged(case):
    """differentiable=True leaves the forward trajectory bitwise as it
    was."""
    c = case
    outs = []
    for diff in (False, True):
        cfg = dataclasses.replace(c["cfg"], differentiable=diff)
        step = tts.make_step_fn(c["mesh"], c["static"], c["md"].params, cfg)
        out, d = tts.run_window(step, c["state"], c["dts"])
        assert d["converged"].all()
        outs.append(out)
    for k in ("N", "b", "q", "melt"):
        assert torch.equal(getattr(outs[0], k), getattr(outs[1], k)), k


def _slab8(op="auto", steps=3, **solver):
    md = tslab.initialize(nx=8, ny=8, days=steps / 24.0, nt_per_day=24)
    md.b_init = np.full(md.x.size, 0.01)
    md.device, md.dtype, md.operator = "cpu", torch.float64, op
    md.solver = dataclasses.replace(md.solver, **{**TIGHT, **solver})
    return md


def test_initial_iterate_gets_zero_gradient():
    md = _slab8(steps=2)
    mesh, static, state, cfg = md.freeze()
    step = tts.make_step_fn(mesh, static, md.params, cfg)
    dts = tts.timestep_sizes(md.timesteps, torch.float64)[:1]

    def loss(N0):
        out, _ = tts.run_window(
            step, dataclasses.replace(state, N_prev=N0), dts)
        return out.N.mean()

    g = _grad(loss, state.N * 1.01)
    assert torch.equal(g, torch.zeros_like(g))


def test_strict_mode_poisons_unconverged_adjoint(monkeypatch):
    """lin_maxiter=1 binds only the adjoint solve here (the forward Newton
    certifies by its own stats): a warning and a finite gradient by default,
    NaN everywhere under SHAKTI_ADJOINT_STRICT=1."""
    md = _slab8(steps=2, lin_maxiter=1, max_iter=60)
    mesh, static, state, cfg = md.freeze()
    step = tts.make_step_fn(mesh, static, md.params, cfg)
    dts = tts.timestep_sizes(md.timesteps, torch.float64)[:1]

    def loss(b0):
        out, _ = tts.run_window(step, dataclasses.replace(state, b=b0), dts)
        return out.N.mean()

    monkeypatch.delenv("SHAKTI_ADJOINT_STRICT", raising=False)
    with pytest.warns(RuntimeWarning, match="adjoint Krylov solve"):
        g = _grad(loss, state.b)
    assert torch.isfinite(g).all()
    monkeypatch.setenv("SHAKTI_ADJOINT_STRICT", "1")
    with pytest.warns(RuntimeWarning):
        g = _grad(loss, state.b)
    assert torch.isnan(g).all()


def test_lag_operator_rejected():
    md = _slab8(lag_operator=True)
    with pytest.raises(ValueError, match="differentiable"):
        mesh, static, state, cfg = md.freeze()
        tts.make_step_fn(mesh, static, md.params, cfg)


def test_adjoint_agrees_across_operator_formats():
    """d mean(N)/d inputs_scale over 3 steps of the 8x8 slab: block-ELL
    (the bell_spmv path on the card), scalar ELL (ell_spmv) and the
    matrix-free operator agree within 1e-9, and block-ELL's gradient within
    2e-5 of a central difference (tests/test_adjoint.py's step and
    tolerance)."""
    grads, losses = {}, {}
    for op in ("bell", "ell", "cells"):
        md = _slab8(op)
        mesh, static, state, cfg = md.freeze()
        c = dict(mesh=mesh, static=static, state=state, cfg=cfg, md=md,
                 dts=tts.timestep_sizes(md.timesteps, torch.float64))
        losses[op] = _scale_loss(c)
        grads[op] = _grad(losses[op], torch.tensor(1.0, dtype=torch.float64))
    for op in ("ell", "cells"):
        assert rel_err(grads[op].item(), grads["bell"].item()) <= 1e-9, grads
    with torch.no_grad():
        h = 1e-5
        fd = (losses["bell"](torch.tensor(1 + h, dtype=torch.float64))
              - losses["bell"](torch.tensor(1 - h, dtype=torch.float64))
              ).item() / (2 * h)
    assert fd != 0.0
    assert abs(grads["bell"].item() - fd) <= 2e-5 * abs(fd), (grads, fd)
