"""Device idle under the program's own spans.

The port names each phase of its train step with a profiler range
(``lgs.step`` and, inside it, ``lgs.step.prep``, ``.forward``, ``.loss``,
``.backward``, ``.allreduce``, ``.update``) on the thread that drives the
step. The profiler stamps those ranges and the device's operations on one
clock, so the stretches of the traced window in which no device operation
runs can be split by the phase the step thread was in. Idle outside every
``lgs.step`` range belongs to the benchmark's own loop.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

STEP = "lgs.step"

Intervals = List[Tuple[int, int]]


def _union(intervals: Iterable[Tuple[int, int]]) -> Intervals:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _overlap_ns(a: Intervals, b: Intervals) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, e - s)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> Intervals:
    """The stretches of the traced window no device operation covers."""
    edges = [trace.t0_ns] + [x for iv in trace.busy_intervals() for x in iv] + [trace.t1_ns]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_under_s(trace, names) -> float:
    """Seconds of device idle while the step thread is inside a range
    named in ``names``."""
    inside = _union((max(s, trace.t0_ns), min(e, trace.t1_ns))
                    for n, s, e in trace.host if n in names)
    return _overlap_ns(inside, idle_intervals(trace)) / 1e9


def idle_ms_per_step(ctx, phases) -> Optional[float]:
    """Device idle per traced step inside the phase ranges ``phases``, in
    ms; None without a device trace or without the program's step
    ranges (a program that has none)."""
    tr = ctx.trace
    if tr is None or not ctx.traced_steps or tr.busy_s() <= 0:
        return None
    if not any(n == STEP for n, _, _ in tr.host):
        return None
    return 1e3 * idle_under_s(tr, set(phases)) / ctx.traced_steps
