"""Reading a ``torch.profiler`` trace: device operations, their union, the
host's ranges, and the breakdown the result line carries.

Device operations are the trace's CUDA activities (kernels, copies,
sets); ``busy_s`` is the length of their union inside the traced window.
Idle gaps are the stretches of the window no device operation covers,
named by the innermost host range (the benchmark's ``lgsb.*`` ranges or
an aten op) that covers the gap's middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class Trace:
    t0_ns: int
    t1_ns: int
    device: List[Tuple[str, int, int]] = field(default_factory=list)  # name, start, end
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def clipped(self) -> List[Tuple[int, int]]:
        return [(max(s, self.t0_ns), min(e, self.t1_ns)) for _, s, e in self.device
                if e > self.t0_ns and s < self.t1_ns]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for s, e in sorted(self.clipped()):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_seconds(self, match) -> float:
        """Summed duration of the device operations whose name ``match``
        accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e9

    def top_device_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(int)
        for name, s, e in self.device:
            by[name] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], v / 1e9] for name, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        busy = self.busy_intervals()
        edges = [self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = defaultdict(int)
        for s, e in gaps:
            mid = (s + e) // 2
            name = "host: no range"
            # the most recently started range that covers the middle is the
            # innermost one (host ranges nest)
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 5000, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            by[name] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], v / 1e9] for name, v in top]


def read_profile(prof, window_range: str) -> Trace:
    """The trace of ``prof`` (stopped) over the host range named
    ``window_range``."""
    import torch

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # kernels, copies and sets; not the host ranges' images on the
            # device's timeline
            if not (ev.is_user_annotation() or ev.name().startswith("lgsb.")):
                device.append((ev.name(), s, e))
        else:
            host.append((ev.name(), s, e, ev.start_thread_id()))
    win = [(s, e, t) for n, s, e, t in host if n == window_range]
    if not win:
        raise RuntimeError(f"the trace holds no {window_range!r} range")
    s0, e0, tid = win[0]
    # the host ranges of the thread that drives the step
    return Trace(s0, e0, device, [(n, s, e) for n, s, e, t in host if t == tid])
