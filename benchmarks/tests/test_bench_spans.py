"""The span table (harness/spans.py) on synthetic intervals, and on a CPU
profile of the port's spans."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks.harness import spans

NAMES = ("step", "newton.fold", "krylov")
# two steps; in the first, the fold and then the Krylov solve
SPANS = [(0.0, 100.0, "step"), (10.0, 20.0, "newton.fold"),
         (30.0, 80.0, "krylov"), (120.0, 200.0, "step")]


def table(records=(), marks=(), device=((0.0, 200.0),)):
    return spans.table(SPANS, list(records), list(marks), list(device),
                       0.0, 200.0, NAMES)


def test_calls_and_host_time():
    t = table()
    assert [t.rows[n].calls for n in NAMES] == [2, 1, 1]
    assert t.rows["step"].host_s == pytest.approx(180e-6)
    assert t.rows["krylov"].host_s == pytest.approx(50e-6)


def test_kernel_counts_in_the_span_of_its_launch_and_above():
    t = table(records=[(15.0, 40.0, 45.0, "mul"),     # in the fold
                       (5.0, 50.0, 51.0, "mul"),      # in the step alone
                       (110.0, 112.0, 114.0, "add"),  # between the steps
                       (None, 150.0, 151.0, "add")])  # launch not found
    assert t.rows["newton.fold"].device_s == pytest.approx(5e-6)
    assert t.rows["step"].device_s == pytest.approx(6e-6)
    assert t.rows["krylov"].device_s == 0.0
    assert t.device_s == pytest.approx(9e-6)
    assert t.unlaunched_s == pytest.approx(1e-6)
    assert t.kernels == {"newton.fold": {"mul": pytest.approx(5e-6)},
                         "step": {"mul": pytest.approx(1e-6)},
                         "": {"add": pytest.approx(2e-6)}}


def test_syncs_and_launches_count_where_they_start():
    t = table(marks=[(35.0, spans.SYNC), (36.0, "cudaLaunchKernel"),
                     (12.0, "cudaLaunchKernel"), (150.0, spans.SYNC),
                     (110.0, spans.SYNC), (13.0, spans.DEVICE_SYNC)])
    assert (t.rows["krylov"].syncs, t.rows["krylov"].launches) == (1, 1)
    assert t.rows["newton.fold"].device_syncs == 1
    assert t.rows["step"].device_syncs == 1
    assert (t.rows["newton.fold"].syncs,
            t.rows["newton.fold"].launches) == (0, 1)
    assert (t.rows["step"].syncs, t.rows["step"].launches) == (2, 2)


def test_gap_goes_to_its_innermost_span():
    # idle from 40 to 50: the middle, 45, lies in krylov inside the step
    t = table(device=[(0.0, 40.0), (50.0, 200.0)])
    assert t.rows["krylov"].idle_s == pytest.approx(10e-6)
    assert t.rows["step"].idle_s == pytest.approx(10e-6)
    assert t.rows["newton.fold"].idle_s == 0.0
    assert t.rows["krylov"].idle_self_s == pytest.approx(10e-6)
    assert t.rows["step"].idle_self_s == 0.0
    assert t.idle_outside_step_s == 0.0
    assert t.idle_s == pytest.approx(10e-6)


def test_gap_between_steps_is_outside():
    # idle from 95 to 125: the middle, 110, lies between the two steps
    t = table(device=[(0.0, 95.0), (125.0, 200.0)])
    assert t.idle_outside_step_s == pytest.approx(30e-6)
    assert t.rows["step"].idle_s == 0.0
    assert t.idle_s == pytest.approx(30e-6)
    assert t.rows["step"].idle_s + t.idle_outside_step_s == \
        pytest.approx(t.idle_s)


def test_gaps_at_the_slice_ends():
    assert spans.gaps([(10.0, 20.0), (15.0, 30.0)], 0.0, 40.0) == [
        (0.0, 10.0), (30.0, 40.0)]


def test_from_a_cpu_profile():
    from shakti_tpu_torch.utils import trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("step"):
            with trace.span("krylov"):
                torch.ones(3).sum().item()
            torch.ones(3).sum().item()
    t = spans.from_profile(prof, trace.SPANS)
    assert list(t.rows) == list(trace.SPANS)
    assert (t.rows["step"].calls, t.rows["step"].syncs) == (1, 2)
    assert (t.rows["krylov"].calls, t.rows["krylov"].syncs) == (1, 1)
    assert t.rows["newton.fold"].calls == 0
    assert t.device_s == 0.0


def test_a_profile_without_spans_reads_empty_rows():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(3).sum().item()
    t = spans.from_profile(prof, NAMES)
    assert all(r.calls == 0 and r.syncs == 0 for r in t.rows.values())
