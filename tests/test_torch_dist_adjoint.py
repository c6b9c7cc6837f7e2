"""The port's distributed adjoint (shakti_tpu_torch/parallel/halo.py's
recorded exchanges, parallel/dist.localize and make_distributed_runner's
control=, solve/implicit.py's halo branch) on 2, 3 and 4 gloo ranks on the
CPU, in float64, against the JAX package:

- dot-product tests of the exchanges' transposes at P = 2, 3, 4 on the
  12x12 slab's halo plan: summed over the ranks, <op(x), y> = <x, op^T(y)>
  within 1e-13 for push, accumulate and accumulate_split ((L,) and (L, k)
  fields) and for localize against a global vector; the recorded forward
  bitwise equal to the unrecorded one;
- tests/test_adjoint.py's case (12x12 slab, 5 hourly steps, tight solves):
  at P = 2 the forward with differentiable=True bitwise equal to False on
  every rank; d(mean owned N)/d(inputs_scale) summed over the ranks at P = 2 and
  4 within 1e-6 of JAX's single-device jax.grad and 2e-5 of a central
  difference of the port's distributed forward, the same bits on every
  rank; at P = 2 the (n,) gradient with respect to the inputs field through
  control="inputs" within rtol 1e-7 / atol 1e-7 max|g| of JAX's, and a
  seeded directional difference within 1e-4; at P = 3 control="G" and
  "storage" each through one backward, an unknown control refused;
- the gradient under mg on the halo of 4 ranks within 1e-6 of the port's
  single-device mg gradient;
- on 8 ranks, the 8x8 slab (its last rank owns no cell and keeps one
  zero-weight padding cell): d(mean owned N)/d(inputs_scale) through 5
  hourly steps, summed over the ranks, within 1e-6 of JAX's 8-device
  gradient (tests/test_adjoint.py:116's) and of the port's single
  device;
- strict mode (lin_maxiter=1) at P = 3: every rank warns, and with
  SHAKTI_ADJOINT_STRICT=1 every rank's gradient is NaN;
- every reduction over the ranks given a tensor that requires grad
  raises; the cell-sharded step refuses differentiable=True.
The JAX side runs in this process as tests/test_adjoint.py runs it on the
CPU; the ranks run their auto format (block-ELL) through the plain
version of bell_spmv.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import setups.setup_slab as jslab
from shakti_tpu.solve.timestep import make_runner as jmake_runner
from shakti_tpu.solve.timestep import make_step_fn as jstep_fn
from shakti_tpu.solve.timestep import run_window as jrun_window
from shakti_tpu.solve.timestep import timestep_sizes as jdts
from shakti_tpu_torch.parallel import dist as pdist
from shakti_tpu_torch.parallel.shard import make_parallel_step_fn
from shakti_tpu_torch.setups import setup_slab as tslab
from shakti_tpu_torch.solve.timestep import make_step_fn, run_window, timestep_sizes
from tests.torch_parity import case, finish_world, start_world

ADJ = dict(adaptive_dt_levels=0, lag_operator=False, rtol=1e-12, atol=1e-13,
           lin_rtol=1e-12, differentiable=True)
MG = dict(precond="mg", mg_agg=4, mg_coarse_cap=16)
OPS = ("push", "push2", "accumulate", "accumulate3", "split", "localize")


def _jmd(nx=12):
    md = jslab.initialize(nx=nx, ny=nx, days=5 / 24.0, nt_per_day=24)
    md.b_init = np.full(md.x.size, 0.01)
    md.solver = dataclasses.replace(md.solver, **ADJ)
    return md


def _jax_reference():
    """JAX's single-device gradients of tests/test_adjoint.py:116 and :192,
    the field's in user order."""
    md = _jmd()
    mesh, static, state, cfg = md.freeze()
    step = jstep_fn(mesh, static, md.params, cfg)
    dts = jdts(md.timesteps, dtype=md.dtype)

    def loss_scale(scale):
        out, _ = jrun_window(step, state, {"dt": dts,
                                           "inputs_scale": jnp.full_like(dts, scale)})
        return jnp.mean(out.N)

    runner = jmake_runner(md.params, cfg)
    base = static.inputs + jnp.asarray(1e-7, md.dtype)

    def loss_field(inputs):
        out, _ = runner(mesh, dataclasses.replace(static, inputs=inputs),
                        state, dts)
        return jnp.mean(out.N) / 1e5

    loss, g = jax.jit(jax.value_and_grad(loss_scale))(jnp.asarray(1.0, md.dtype))
    field_loss, field_g = jax.jit(jax.value_and_grad(loss_field))(base)
    return {"loss": float(loss), "g": float(g), "field_loss": float(field_loss),
            "field_g": md.to_user_order(np.asarray(field_g))}


def _jax_toy8():
    """JAX's d mean(N)/d inputs_scale on 8 devices (tests/test_adjoint.py:116)
    on the 8x8 slab."""
    from shakti_tpu.parallel.dist import make_distributed_runner
    from shakti_tpu.parallel.shard import make_device_mesh
    md = _jmd(nx=8)
    dts = jdts(md.timesteps, dtype=md.dtype)
    runner, state0, plan = make_distributed_runner(md, make_device_mesh(8))
    owned = jnp.asarray(plan["owned_mask"].reshape(-1), md.dtype)

    def loss(scale):
        out, _ = runner(state0, {"dt": dts,
                                 "inputs_scale": jnp.full_like(dts, scale)})
        return jnp.vdot(out.N * owned, owned) / md.x.size

    loss, g = jax.jit(jax.value_and_grad(loss))(jnp.asarray(1.0, md.dtype))
    return float(loss), float(g)


def _port_gradient(nx=12, **solver):
    """The port's single-device d mean(N)/d inputs_scale."""
    md = tslab.initialize(nx=nx, ny=nx, days=5 / 24.0, nt_per_day=24)
    md.device, md.dtype = "cpu", torch.float64
    md.b_init = np.full(md.x.size, 0.01)
    md.solver = dataclasses.replace(md.solver, **ADJ, **solver)
    mesh, static, state, cfg = md.freeze()
    dts = timestep_sizes(md.timesteps)
    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    out, _ = run_window(make_step_fn(mesh, static, md.params, cfg), state,
                        {"dt": dts, "inputs_scale": s.expand(dts.shape[0])})
    out.N.mean().backward()
    return float(s.grad)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds side by side while the references compute."""
    hs = {P: start_world(f"adjoint{P}", P,
                         tmp_path_factory.mktemp(f"adjoint{P}"))
          for P in (2, 3, 4)}
    ref = _jax_reference()
    ref["port_mg_g"] = _port_gradient(**MG)
    return {P: finish_world(h) for P, h in hs.items()}, ref


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """The 8-rank world on its own, while JAX's 8-device gradient and the
    port's single-device one compute."""
    h = start_world("adjoint8", 8, tmp_path_factory.mktemp("adjoint8"))
    loss, g = _jax_toy8()
    return finish_world(h), {"loss": loss, "g": g,
                             "port_g": _port_gradient(nx=8)}


@pytest.fixture(scope="module")
def jax_ref(worlds):
    return worlds[1]


def _world(worlds, P):
    return worlds[0][P]


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    return ranks[0][key]


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("op", OPS)
def test_exchange_transpose_dot_product(op, P, worlds):
    ranks = case(_world(worlds, P), "dot")
    fwd = sum(float(r[f"{op}_fwd"]) for r in ranks)
    if op == "localize":
        adj = float(ranks[0]["f"] @ sum(r["localize_grad"] for r in ranks))
    else:
        adj = sum(float(r[f"{op}_adj"]) for r in ranks)
    assert abs(fwd - adj) <= 1e-13 * max(abs(fwd), abs(adj)), (fwd, adj)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_recorded_exchange_bitwise_equal_to_plain(P, worlds):
    for r in case(_world(worlds, P), "dot"):
        for op in OPS:
            assert bool(r[f"{op}_same"]), op


@pytest.mark.parametrize("P", [2, 4])
def test_ranks_agree_on_the_recorded_forward(P, worlds):
    ranks = case(_world(worlds, P), "grad_scale")
    for k in ("newton", "cg", "rnorm", "loss"):
        _same_on_every_rank(ranks, k)
    assert ranks[0]["converged"].all()
    assert str(ranks[0]["format"]) == "bell"


def test_forward_unchanged_by_differentiable(worlds):
    for r in case(_world(worlds, 2), "grad_scale"):
        assert bool(r["same_N"]) and bool(r["same_b"])


@pytest.mark.parametrize("P", [2, 4])
def test_scalar_gradient_matches_jax_and_fd(P, worlds, jax_ref):
    ranks = case(_world(worlds, P), "grad_scale")
    g = float(_same_on_every_rank(ranks, "g"))
    fd = float(ranks[0]["fd"])
    # the ranks' partial gradients sum to the global one
    assert g == pytest.approx(sum(float(r["g_rank"]) for r in ranks),
                              rel=1e-12)
    assert float(ranks[0]["loss"]) == pytest.approx(jax_ref["loss"],
                                                    rel=1e-10)
    assert abs(g - jax_ref["g"]) <= 1e-6 * abs(jax_ref["g"]), (g, jax_ref)
    assert fd != 0.0
    assert abs(g - fd) <= 2e-5 * abs(fd), (g, fd)


def test_field_gradient_matches_jax_and_fd(worlds, jax_ref):
    ranks = case(_world(worlds, 2), "field")
    g = _same_on_every_rank(ranks, "g")
    ref = jax_ref["field_g"]
    assert float(ranks[0]["loss"]) == pytest.approx(jax_ref["field_loss"],
                                                    rel=1e-10)
    np.testing.assert_allclose(g, ref, rtol=1e-7, atol=1e-7 * np.abs(ref).max())
    np.testing.assert_allclose(sum(r["g_rank"] for r in ranks), g,
                               rtol=1e-12, atol=1e-12 * np.abs(g).max())
    gdir, fd = float(ranks[0]["gdir"]), float(ranks[0]["fd"])
    assert fd != 0.0
    assert abs(gdir - fd) <= 1e-4 * abs(fd), (gdir, fd)


def test_other_controls_and_unknown_refused(worlds):
    ranks = case(_world(worlds, 3), "controls")
    for ctl in ("G", "storage"):
        g = _same_on_every_rank(ranks, f"g_{ctl}")
        assert np.isfinite(g).all() and g.shape == (169,)
    assert np.abs(ranks[0]["g_G"]).max() > 0
    for r in ranks:
        assert "control must be one of" in str(r["refused"])
    with pytest.raises(ValueError, match="control must be one of"):
        pdist.make_distributed_runner(None, control="z_s")


def test_mg_gradient_matches_single_device_port(worlds, jax_ref):
    ranks = case(_world(worlds, 4), "mg")
    assert str(ranks[0]["precond"]) == "mg"
    g = float(_same_on_every_rank(ranks, "g"))
    ref = jax_ref["port_mg_g"]
    assert abs(g - ref) <= 1e-6 * abs(ref), (g, ref)


def test_gradient_on_8_ranks_with_a_cell_less_rank(world8):
    ranks = case(world8[0], "grad_toy")
    for k in ("newton", "cg", "rnorm", "loss"):
        _same_on_every_rank(ranks, k)
    assert ranks[0]["converged"].all()
    assert int(ranks[-1]["cells"]) == 1            # the padding cell
    g = float(_same_on_every_rank(ranks, "g"))
    assert g == pytest.approx(sum(float(r["g_rank"]) for r in ranks),
                              rel=1e-12)
    assert float(ranks[-1]["g_rank"]) == 0.0       # it owns no row's N
    ref = world8[1]
    assert float(ranks[0]["loss"]) == pytest.approx(ref["loss"], rel=1e-10)
    for ref in (ref["g"], ref["port_g"]):
        assert abs(g - ref) <= 1e-6 * abs(ref), (g, ref)


def test_strict_mode_on_every_rank(worlds):
    for r in case(_world(worlds, 3), "strict"):
        own = r["strict_owned"]
        assert int(r["loose_warnings"]) >= 1 and int(r["strict_warnings"]) >= 1
        assert np.isfinite(r["loose_g"]).all()
        assert np.isnan(r["strict_g"][own]).all()


def test_reductions_with_grad_raise(worlds):
    for r in case(_world(worlds, 2), "raise"):
        for k in [k for k in r if k.startswith("raised_")]:
            assert "has no transpose" in str(r[k]), k
        assert float(r["no_grad_dot"]) == float(r["detached_dot"]) == 81.0


def test_cell_sharded_step_refuses_differentiable():
    md = tslab.initialize(nx=8, ny=8)
    md.device, md.dtype = "cpu", torch.float64
    md.solver = dataclasses.replace(md.solver, lag_operator=False,
                                    differentiable=True)
    mesh, static, _, cfg = md.freeze()
    with pytest.raises(NotImplementedError, match="differentiable"):
        make_parallel_step_fn(mesh, static, md.params, cfg)
