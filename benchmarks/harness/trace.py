"""Reduction of a torch.profiler trace of the window's first steps.

From the profiler's events: the device's busy time (the union of the
intervals in which a kernel, copy or fill ran), the host's kernel launches
(``cudaLaunch*``) and host syncs (``aten::_local_scalar_dense``, a tensor
read back to a Python number), the device time of kernels by name, and the
device's idle gaps, each labelled with the host operation that was running
at its middle (the innermost one; "host" where none was).  The arithmetic
of chip_smoke.profile_steps, extended to intervals.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

SYNC = "aten::_local_scalar_dense"
TOP = 10


@dataclasses.dataclass
class Trace:
    steps: int                 # steps inside the traced slice
    wall_s: float              # its length by the host clock
    busy_s: float              # union of the device intervals
    launches: int
    syncs: int
    kernels: list              # [(name, seconds)] of every device record
    device_ops: list           # the TOP names by device time: [[name, s]]
    idle_gaps: list            # the TOP host labels by idle time: [[label, s]]
    records: int               # device records in the trace

    def kernel_times(self, pattern: str) -> dict:
        """{match: (count, seconds)} of the device records whose name
        matches the regular expression ``pattern``, by the text of the
        match's first group."""
        rx = re.compile(pattern)
        out = defaultdict(lambda: (0, 0.0))
        for name, s in self.kernels:
            m = rx.search(name)
            if m:
                c, t = out[m.group(1)]
                out[m.group(1)] = (c + 1, t + s)
        return dict(out)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(device, host, t0, t1):
    """{label: seconds} of the device's idle time within [t0, t1]:
    ``device`` and ``host`` are (start, end, name) in one clock; a gap's
    label is the innermost host interval around its middle."""
    merged = []
    for s, e, _ in sorted(device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, prev = [], t0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, min(s, t1)))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    gaps = [g for g in gaps if g[1] > g[0]]
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out = defaultdict(float)
    stack, i = [], 0
    for a, b in sorted(gaps, key=lambda g: 0.5 * (g[0] + g[1])):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        out[stack[-1][2] if stack else "host"] += b - a
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, argument list and the
    namespaces that every PyTorch kernel repeats, at most 120 characters."""
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch in "<[{"
        depth -= ch in ">]}"
        if ch == "(" and depth == 0 and i and name[i - 1] not in " :":
            cut = i
            break
    name = name[:cut].removeprefix("void ")
    for ns in ("at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(ns, "")
    return re.sub(r"\s+", " ", name)[:120]


def top(d: dict, k: int = TOP):
    """The ``k`` largest entries of {name: seconds}, names shortened and
    merged."""
    merged = defaultdict(float)
    for name, v in d.items():
        merged[short_name(name)] += v
    return [[name, v] for name, v in
            sorted(merged.items(), key=lambda kv: -kv[1])[:k]]


def summarize(prof, steps: int, wall_s: float) -> Trace:
    """The Trace of a finished torch.profiler.profile over ``steps`` steps
    that took ``wall_s`` seconds by the host clock."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end, e.name)
        (device if e.device_type == DeviceType.CUDA else host).append(iv)
    launches = sum(1 for h in host if h[2].startswith("cudaLaunch"))
    syncs = sum(1 for h in host if h[2] == SYNC)
    by_name = defaultdict(float)
    for s, e, name in device:
        by_name[name] += (e - s) / 1e6
    starts = [iv[0] for iv in device + host]
    ends = [iv[1] for iv in device + host]
    t0 = min(starts) if starts else 0.0
    t1 = max(ends) if ends else 0.0
    gaps = idle_gaps(device, host, t0, t1)
    return Trace(steps=steps, wall_s=wall_s,
                 busy_s=union_length((s, e) for s, e, _ in device) / 1e6,
                 launches=launches, syncs=syncs,
                 kernels=[(name, (e - s) / 1e6) for s, e, name in device],
                 device_ops=top(by_name),
                 idle_gaps=top({k: v / 1e6 for k, v in gaps.items()}),
                 records=len(device))
