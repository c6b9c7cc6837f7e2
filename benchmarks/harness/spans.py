"""The span table of a traced slice: the port's spans
(shakti_tpu_torch/utils/trace.SPANS, ``torch.profiler.record_function``
ranges on the host) joined to the device records of the same
torch.profiler trace, which share their clock.

For each span name, over its ranges (nested ranges of one name counted
once):

- ``calls``: the ranges; ``host_s``: the time they cover;
- ``device_s``: the device time of the records launched inside them (a
  record's launch is the start of the runtime call, ``cudaLaunchKernel``,
  ``cudaMemcpyAsync`` and the like, that carries its correlation id);
- ``launches``, ``syncs`` and ``device_syncs``: the ``cudaLaunch*``
  calls, the host syncs (``aten::_local_scalar_dense``, a value read back)
  and the ``cudaDeviceSynchronize`` calls that start inside them;
- ``idle_s``: the device's idle time whose gap middle lies inside them;
  ``idle_self_s``: the part of it whose innermost span is this one.

Beside the table: the device time by kernel name and innermost span, the
idle time whose gap middle lies outside every ``step`` range, and the
device time whose launch was not found.
"""

from __future__ import annotations

import bisect
import dataclasses

SYNC = "aten::_local_scalar_dense"
DEVICE_SYNC = "cudaDeviceSynchronize"
STEP = "step"


@dataclasses.dataclass
class Row:
    calls: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    launches: int = 0
    syncs: int = 0
    device_syncs: int = 0
    idle_s: float = 0.0
    idle_self_s: float = 0.0


@dataclasses.dataclass
class Table:
    rows: dict            # {span name: Row}
    kernels: dict         # {innermost span or "": {kernel name: seconds}}
    idle_outside_step_s: float
    idle_s: float         # every gap of the device within the slice
    device_s: float       # every device record's time
    unlaunched_s: float   # ... of the records whose launch was not found


def merged(ranges):
    """Sorted disjoint [start, end] covering ``ranges`` ((start, end))."""
    out = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(device, t0, t1):
    """The device's idle (start, end) intervals within [t0, t1], from its
    busy (start, end) intervals."""
    out, prev = [], t0
    for s, e in merged(device):
        if s > prev:
            out.append((prev, min(s, t1)))
        prev = max(prev, e)
    if t1 > prev:
        out.append((prev, t1))
    return [g for g in out if g[1] > g[0]]


class Cover:
    """The union of one name's ranges, for point queries."""

    def __init__(self, ranges):
        self.ranges = merged(ranges)
        self.starts = [s for s, _ in self.ranges]

    def find(self, t):
        """The merged range holding ``t`` (start inclusive), or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.ranges[i][1]:
            return self.ranges[i]
        return None


def innermost(cover: dict, t):
    """The name whose range holding ``t`` starts last (the shorter on a
    tie), or "" where none holds it."""
    best, key = "", None
    for n, c in cover.items():
        r = c.find(t)
        if r is not None and (key is None or (r[0], -r[1]) > key):
            best, key = n, (r[0], -r[1])
    return best


def table(spans, records, marks, device, t0, t1, names=None) -> Table:
    """The span table of one slice, in seconds, from times in µs (the
    profiler's): ``spans`` (start, end, name) host ranges; ``records``
    (launch, start, end, name) device records, launch None where not
    found; ``marks`` (time, name) host syncs (:data:`SYNC`), launches
    (``cudaLaunch*``) and :data:`DEVICE_SYNC` calls; ``device`` (start,
    end) busy intervals; the slice [t0, t1].  ``names``: the rows, in
    order (default those of ``spans``)."""
    names = list(dict.fromkeys(n for *_, n in spans)) if names is None \
        else list(names)
    by_name = {n: [(s, e) for s, e, m in spans if m == n] for n in names}
    cover = {n: Cover(r) for n, r in by_name.items()}
    rows = {n: Row(calls=len(r),
                   host_s=sum(e - s for s, e in cover[n].ranges) / 1e6)
            for n, r in by_name.items()}
    unlaunched = 0.0
    kernels = {}
    for launch, s, e, kernel in records:
        if launch is None:
            unlaunched += e - s
            continue
        for n in names:
            if cover[n].find(launch) is not None:
                rows[n].device_s += (e - s) / 1e6
        own = kernels.setdefault(innermost(cover, launch), {})
        own[kernel] = own.get(kernel, 0.0) + (e - s) / 1e6
    for t, what in marks:
        field = ("syncs" if what == SYNC else
                 "device_syncs" if what == DEVICE_SYNC else "launches")
        for n in names:
            if cover[n].find(t) is not None:
                setattr(rows[n], field, getattr(rows[n], field) + 1)
    idle = outside = 0.0
    step = cover.get(STEP, Cover([]))
    for a, b in gaps(device, t0, t1):
        mid, length = 0.5 * (a + b), (b - a) / 1e6
        idle += length
        if step.find(mid) is None:
            outside += length
        for n in names:
            if cover[n].find(mid) is not None:
                rows[n].idle_s += length
        inner = innermost(cover, mid)
        if inner:
            rows[inner].idle_self_s += length
    return Table(rows=rows, kernels=kernels, idle_outside_step_s=outside,
                 idle_s=idle, device_s=sum(e - s for _, s, e, _ in records)
                 / 1e6, unlaunched_s=unlaunched / 1e6)


def from_profile(prof, names) -> Table:
    """The span table of a finished torch.profiler.profile, rows
    ``names``.  A device record's launch is the runtime call with its
    correlation id; device records named as a span (a profiler may draw a
    span on the device's timeline too) are not work and are left out."""
    from torch.autograd import DeviceType
    names = list(names)
    skip = set(names)
    spans, marks, device, runtime = [], [], [], {}
    starts, ends = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        starts.append(s)
        ends.append(t)
        if e.device_type == DeviceType.CUDA:
            if e.name not in skip:
                device.append((e.id, s, t, e.name))
        elif e.name in skip:
            spans.append((s, t, e.name))
        else:
            if e.name in (SYNC, DEVICE_SYNC) or \
                    e.name.startswith("cudaLaunch"):
                marks.append((s, e.name))
            if e.name.startswith("cu"):
                runtime[e.id] = s
    records = [(runtime.get(i), s, t, k) for i, s, t, k in device]
    return table(spans, records, marks, [(s, t) for _, s, t, _ in device],
                 min(starts, default=0.0), max(ends, default=0.0), names)
