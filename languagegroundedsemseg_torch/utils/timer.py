"""Running averages (reference lib/utils.py:128-189).

Counterpart of ``languagegroundedsemseg_tpu/utils/timer.py``.
"""

from __future__ import annotations


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
