"""Observability: TensorBoard scalar events + torch.profiler trace capture.

Counterpart of ``languagegroundedsemseg_tpu/utils/observability.py``
(:18-108). The reference logs every PL metric to TensorBoard (main.py:178
TensorBoardLogger); the trainer also captures a profiler trace of a few
steps behind a flag. TensorBoard event writing degrades to a no-op when the
`tensorboard` package is absent (``TensorBoardLogger.active`` is then
False, and metrics.jsonl stays the record), and the profiler writes a
Chrome trace (host ranges and, on the card, the device's kernels) under
<log_dir>/plugins/profile/<timestamp>/.
"""

from __future__ import annotations

import os
import time
from typing import Dict


class TensorBoardLogger:
    """Scalar event writer; silently inert when tensorboard is missing."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self._writer = None
        self.log_dir = log_dir
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir)
        except Exception:
            try:
                from tensorboardX import SummaryWriter  # type: ignore

                self._writer = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._writer = None

    @property
    def active(self) -> bool:
        return self._writer is not None

    def log_scalars(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        if self._writer is None:
            return
        for k, v in scalars.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            if v != v:  # skip NaNs: TB renders them as gaps anyway
                continue
            self._writer.add_scalar(prefix + k, v, global_step=step)
        self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class ProfilerHook:
    """Capture a torch.profiler trace for steps [start, start + num).

    Call ``maybe_start(step)`` before and ``maybe_stop(step)`` after each
    train step. The Chrome trace lands at
    <log_dir>/plugins/profile/<timestamp>/trace.json.
    """

    def __init__(self, log_dir: str, enabled: bool, start_step: int, num_steps: int):
        self.log_dir = log_dir
        self.enabled = enabled and num_steps > 0
        self.start_step = int(start_step)
        self.stop_step = int(start_step) + int(num_steps)
        self._prof = None
        self.captured = False
        self.trace_path = None

    def maybe_start(self, step: int):
        if not self.enabled or self._prof is not None or self.captured:
            return
        if step >= self.start_step:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()

    def maybe_stop(self, step: int):
        if self._prof is not None and step + 1 >= self.stop_step:
            self._finish()

    def close(self):
        if self._prof is not None:
            self._finish()

    def _finish(self):
        self._prof.stop()
        out = os.path.join(self.log_dir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(out, exist_ok=True)
        self.trace_path = os.path.join(out, "trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self.captured = True


def step_timer_scope(name: str):
    """Annotate a host-side region in profiler traces."""
    import torch

    return torch.profiler.record_function(name)
