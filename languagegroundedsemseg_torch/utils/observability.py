"""Observability: TensorBoard scalar events, torch.profiler trace capture
and the program's spans.

Counterpart of ``languagegroundedsemseg_tpu/utils/observability.py``
(:18-108). The reference logs every PL metric to TensorBoard (main.py:178
TensorBoardLogger); the trainer also captures a profiler trace of a few
steps behind a flag. TensorBoard event writing degrades to a no-op when the
`tensorboard` package is absent (``TensorBoardLogger.active`` is then
False, and metrics.jsonl stays the record), and the profiler writes a
Chrome trace (host ranges and, on the card, the device's kernels) under
<log_dir>/plugins/profile/<timestamp>/. Under data parallelism only rank 0
writes either (``rank`` of each constructor); the others are inert.

``span`` names a stretch of the program (``lgs.<layer>.<what>``) as a range
of whatever ``torch.profiler`` session is recording: the trainer's
``ProfilerHook`` or an operator's own. The profiler stamps the range and
the device's activity on one clock, so the trace shows which span the
card was busy or idle under. With no session recording a span costs one
flag check; it keeps no buffer and no clock of its own.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Tuple

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


class _Range:
    """One profiler range, entered and left once: the user-scope record
    function ``torch.profiler.record_function`` opens, with ``args`` as its
    inputs. A session that records shapes shows numbers among them as the
    range's "Concrete Inputs", on every thread it profiles;
    ``record_function``'s own string argument reaches no trace."""

    __slots__ = ("_name", "_args", "_handle")

    def __init__(self, name: str, args: Tuple):
        self._name, self._args = name, args

    def __enter__(self):
        self._handle = torch.autograd._record_function_with_args_enter(
            self._name, *self._args)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self._handle)


def span(name: str, args: Tuple = ()):
    """A context naming the region it wraps ``name`` in any recording
    ``torch.profiler`` session, with the numbers ``args`` (a batch
    counter, a scene index) as its arguments. The check is the profiler's
    process-wide flag: ``torch.autograd._profiler_enabled()`` is per thread
    and reads False on the loader's workers, and on every thread when the
    session profiles all threads."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Range(name, args)


class TensorBoardLogger:
    """Scalar event writer; silently inert when tensorboard is missing."""

    def __init__(self, log_dir: str, enabled: bool = True, rank: int = 0):
        self._writer = None
        self.log_dir = log_dir
        if not enabled or rank != 0:
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
    <log_dir>/plugins/profile/<timestamp>/trace.json. It profiles every
    thread, so the loader's workers' spans appear beside the step's, and
    records shapes, so each span's arguments appear with it.
    """

    def __init__(self, log_dir: str, enabled: bool, start_step: int, num_steps: int,
                 rank: int = 0):
        self.log_dir = log_dir
        self.enabled = enabled and num_steps > 0 and rank == 0
        self.start_step = int(start_step)
        self.stop_step = int(start_step) + int(num_steps)
        self._prof = None
        self.captured = False
        self.trace_path = None

    def maybe_start(self, step: int):
        if not self.enabled or self._prof is not None or self.captured:
            return
        if step >= self.start_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts, record_shapes=True,
                experimental_config=torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True))
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
