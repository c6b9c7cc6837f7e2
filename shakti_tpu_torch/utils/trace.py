"""Spans and counters of the port's Newton–Krylov step.

A span is a profiler range, made only while a profiler is recording: it
then lands on the profiler's timeline, on the clock of the CUDA device
records, around the kernels it launches.  With no profiler recording,
:func:`span` returns one shared null context and costs one C call.

The range is the function-scope one that PyTorch's own compiled code
records (``torch._C._profiler._RecordFunctionFast``), not
``torch.profiler.record_function``: the profiler draws a user annotation
on the device's timeline too, as a device record over every kernel of the
range, which a reader of the device records would count as work.  A
function-scope range stays on the host, costs ~2 µs recorded (a user
annotation ~14), and is the profiler's link for the kernels launched in it
outside any PyTorch op (ops/spmv_cuda's, through ctypes).

The spans (:data:`SPANS`), the same on the single and the batched path:

- ``step``: one timestep (solve/timestep.make_step_fn's, and
  parallel/ensemble.make_ensemble_step_fn's);
- ``newton.residual``: a residual evaluation of the Newton solve (the
  3-column probe, the trial step, each line-search step);
- ``newton.jacobian``: the element Jacobian;
- ``newton.fold``: the fold into the operator's values, its diagonal, the
  degenerate-row floor and the matvec's construction;
- ``newton.precond``: the preconditioner's build (the coarse operator and
  its inverse; the applies run inside ``krylov``);
- ``krylov``: one call of the Krylov solve;
- ``polish.jacobian``, ``polish.lu``, ``polish.armijo``: the steady
  polish's parts (solve/monolithic.py).

The counters (:data:`counts`): ``krylov.trips``, one per pass of a Krylov
loop's body (a batched solve's passes, whatever number of members are
live).  :func:`snapshot` also reads the kernel launches of ops/spmv_cuda
and ops/element_cuda.
"""

from __future__ import annotations

import contextlib

import torch

SPANS = ("step", "newton.residual", "newton.jacobian", "newton.fold",
         "newton.precond", "krylov", "polish.jacobian", "polish.lu",
         "polish.armijo")

_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled

counts = {"krylov.trips": 0}


def span(name: str):
    """A profiler range called ``name`` while a profiler is recording,
    else the shared null context."""
    if _recording():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL


def reset():
    """Zero this module's counters (the kernels' launch counts are left as
    they are)."""
    for k in counts:
        counts[k] = 0


def snapshot() -> dict:
    """Every counter of the port: this module's, and the kernel launches of
    ops/spmv_cuda and ops/element_cuda as ``<module>.launches.<entry
    point>``."""
    from shakti_tpu_torch.ops import element_cuda, spmv_cuda
    out = dict(counts)
    for name, mod in (("spmv_cuda", spmv_cuda), ("element_cuda", element_cuda)):
        out.update({f"{name}.launches.{k}": v for k, v in mod.launches.items()})
    return out
