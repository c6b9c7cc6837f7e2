"""The port's spans and counters (shakti_tpu_torch/utils/trace.py) on the
CPU, with the small slab of tests/test_torch_ensemble.py:

- with no profiler recording, ``span`` is the shared null context and makes
  no profiler call;
- a single step and an ensemble step give bitwise the same state and
  diagnostics under torch.profiler as without it;
- one ensemble step's events hold each of the step's spans, nested as
  utils/trace.py documents them: all under ``step``, one ``krylov`` per
  Newton trip;
- the host syncs inside the ``krylov`` spans are the change of
  ``krylov.trips`` plus one test per call, and each Krylov solver counts
  one trip per pass of its loop.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shakti_tpu_torch.parallel import ensemble as tens
from shakti_tpu_torch.setups import setup_slab as tslab
from shakti_tpu_torch.solve import krylov
from shakti_tpu_torch.solve import timestep as tts
from shakti_tpu_torch.utils import trace
from tests import torch_parity  # noqa: F401  (pins torch's threads)

SYNC = "aten::_local_scalar_dense"
STEP_SPANS = tuple(n for n in trace.SPANS if not n.startswith("polish."))


def slab(lag: bool = False):
    """The 8x8 slab in float64 block-ELL, two-level, no dt halving: its
    frozen problem, parameters and first dt."""
    md = tslab.initialize(nx=8, ny=8, days=1.0, nt_per_day=4)
    md.b_init = np.full(md.x.size, 0.01)
    md.device, md.dtype, md.operator = "cpu", torch.float64, "bell"
    md.operator_block = 16
    md.solver = dataclasses.replace(md.solver, precond="two_level",
                                    adaptive_dt_levels=0, lag_operator=lag)
    mesh, static, state, cfg = md.freeze()
    dt = tts.timestep_sizes(md.timesteps, torch.float64)[0]
    return mesh, static, state, cfg, md.params, dt


def ensemble_step():
    mesh, static, state, cfg, params, dt = slab()
    ens = tens.perturbed_ensemble(state, 2, b_scale=5e-3, seed=3)
    return tens.make_ensemble_step_fn(mesh, static, params, cfg), ens, dt


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def inside(e, outer) -> bool:
    return (outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


def test_span_without_profiler_is_the_shared_null_context(monkeypatch):
    assert trace.span("step") is trace.span("krylov")
    with trace.span("step") as v:
        assert v is None

    def refuse(name):
        raise AssertionError(f"profiler range {name!r} made with no "
                             "profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    step, ens, dt = ensemble_step()
    _, diag = step(ens, dt)
    assert diag["converged"].all()


def test_span_under_the_profiler_is_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("newton.fold"):
            torch.ones(3).sum()
    (fold,) = [e for e in prof.events() if e.name == "newton.fold"]
    assert not fold.is_user_annotation
    assert [c.name for c in fold.cpu_children] == ["aten::ones", "aten::sum"]


@pytest.mark.parametrize("kind", ["single", "single_lag", "ensemble"])
def test_step_is_bitwise_under_the_profiler(kind):
    if kind == "ensemble":
        step, state, dt = ensemble_step()
    else:
        mesh, static, state, cfg, params, dt = slab(lag=kind == "single_lag")
        step = tts.make_step_fn(mesh, static, params, cfg)
    plain = step(state, dt)
    traced, events = profiled(lambda: step(state, dt))
    assert sum(e.name == "step" for e in events) == 1
    for k in ("N", "b", "q", "melt"):
        assert torch.equal(getattr(plain[0], k), getattr(traced[0], k)), k
    assert plain[1].keys() == traced[1].keys()
    for k, v in plain[1].items():
        assert np.array_equal(v, traced[1][k]), k


def test_ensemble_step_spans_nest_as_documented():
    step, ens, dt = ensemble_step()
    (_, diag), events = profiled(lambda: step(ens, dt))
    spans = {n: [e for e in events if e.name == n] for n in STEP_SPANS}
    trips = int(diag["newton_iters"].max())
    assert trips >= 1
    (top,) = spans["step"]
    for name in STEP_SPANS[1:]:
        assert spans[name], name
        for e in spans[name]:
            assert inside(e, top), name
            parent = e.cpu_parent
            while parent is not None and parent.name not in trace.SPANS:
                parent = parent.cpu_parent
            # the Newton spans and krylov are siblings directly under step
            assert parent is top, (name, parent and parent.name)
    for name in ("newton.jacobian", "newton.fold", "newton.precond",
                 "krylov"):
        assert len(spans[name]) == trips, name
    # the probe, then a trial residual per trip (and line-search steps)
    assert len(spans["newton.residual"]) >= 1 + trips


def test_krylov_syncs_are_its_trips_plus_one_test_per_call():
    step, ens, dt = ensemble_step()
    before = trace.snapshot()["krylov.trips"]
    _, events = profiled(lambda: step(ens, dt))
    trips = trace.snapshot()["krylov.trips"] - before
    calls = [e for e in events if e.name == "krylov"]
    syncs = sum(1 for e in events if e.name == SYNC
                and any(inside(e, c) for c in calls))
    assert trips >= 1
    assert syncs == trips + len(calls)


def spd(n: int = 24, M: int = 3):
    """M symmetric positive definite tridiagonal systems of size n."""
    g = torch.Generator().manual_seed(0)
    d = 2.0 + torch.rand(M, n, generator=g, dtype=torch.float64)
    b = torch.randn(M, n, generator=g, dtype=torch.float64)

    def matvec(x):
        y = d * x
        y[..., 1:] -= x[..., :-1]
        y[..., :-1] -= x[..., 1:]
        return y
    return matvec, b


@pytest.mark.parametrize("solver", ["pcg", "bicgstab", "pcg_batched",
                                    "bicgstab_batched"])
def test_each_krylov_pass_is_one_trip(solver):
    matvec, b = spd()
    fn = getattr(krylov, solver)
    before = trace.snapshot()
    if solver.endswith("_batched"):
        _, info = fn(matvec, b, rtol=1e-10, maxiter=200)
        iters = int(info["iters"].max())
    else:
        _, info = fn(matvec, b[0], rtol=1e-10, maxiter=200)
        iters = info["iters"]
    after = trace.snapshot()
    assert iters >= 2
    assert after["krylov.trips"] - before["krylov.trips"] == iters
    # the kernels' launch counters ride along, unmoved by a CPU solve
    launches = [k for k in after if k.startswith("spmv_cuda.launches.")]
    assert launches and all(after[k] == before[k] for k in launches)


def test_reset_zeroes_the_counters():
    matvec, b = spd()
    krylov.pcg(matvec, b[0], rtol=1e-10)
    assert trace.counts["krylov.trips"] > 0
    trace.reset()
    assert trace.snapshot()["krylov.trips"] == 0
