"""Train state: the model (parameters and BN running statistics), the
optimizer (with its state), the step counter and the plateau scale.

Counterpart of ``languagegroundedsemseg_tpu/train/state.py``. PyTorch keeps
parameters and optimizer state in place, so the state holds the objects
themselves; the train step updates them and advances ``step``.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from languagegroundedsemseg_torch.train.solvers import ScheduledOptimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: ScheduledOptimizer
    step: int = 0
    # host-controlled multiplier of the update for ReduceLROnPlateau
    # (reference lib/solvers.py:87-100); 1.0 otherwise
    lr_scale: float = 1.0
