"""Wall-clock timers and running averages (reference lib/utils.py:128-189).

Counterpart of ``languagegroundedsemseg_tpu/utils/timer.py``.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.calls = 0
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        assert self._t0 is not None, "toc() before tic()"
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.calls += 1
        return self.average_time if average else dt

    @property
    def average_time(self) -> float:
        return self.total / max(self.calls, 1)

    def __enter__(self):
        self.tic()
        return self

    def __exit__(self, *exc):
        self.toc(average=False)


class AverageMeter:
    """Streaming weighted mean (reference MetricAverageMeter semantics,
    lib/losses/utils.py:106-119)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.value = 0.0
        self.total = 0

    def update(self, value: float, count: int = 1):
        self.value += float(value) * count
        self.total += count

    def compute(self) -> float:
        return self.value / max(self.total, 1)
