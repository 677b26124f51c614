"""Optimizers and LR schedules with the reference's semantics.

Counterpart of ``languagegroundedsemseg_tpu/train/solvers.py`` (reference
lib/solvers.py:45-102):

- SGD with torch semantics is ``torch.optim.SGD`` itself: grad += wd * param;
  the first step sets the momentum buffer to the raw (decayed) gradient,
  later ones buf = momentum * buf + (1 - dampening) * grad; update =
  -lr * buf (dampening 0.1 is the reference default).
- Adam is ``torch.optim.Adam``, weight decay as L2 on the gradient.
- Schedules (StepLR / MultiStepLR / PolyLR / SquaredLR / ExpLR) are pure
  functions of the number of updates made; ReduceLROnPlateau is a host-side
  scale passed as ``lr_scale``.

``ScheduledOptimizer`` wraps the torch optimizer: before each update it sets
every param group's ``lr`` to ``schedule(updates) * lr_scale`` (both
optimizers' state is independent of lr, so this equals scaling the update,
as the reference's train step does), and with ``iter_size > 1`` it
accumulates the running mean of the gradients over ``iter_size`` calls and
updates on the last one, as ``optax.MultiSteps`` does.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]


class ScheduledOptimizer:
    """A torch optimizer driven by a schedule, with gradient accumulation."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Schedule,
                 iter_size: int = 1):
        self.inner = inner
        self.schedule = schedule
        self.iter_size = max(int(iter_size), 1)
        self.updates = 0     # updates made: the schedule's step
        self.mini_step = 0   # micro-batches accumulated since the last one
        self._acc = None

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self, lr_scale: float = 1.0) -> bool:
        """Apply the gradients now in ``p.grad``; True if the parameters
        were updated (False on an accumulating micro-step)."""
        params = [p for g in self.inner.param_groups for p in g["params"]
                  if p.grad is not None]
        if self.iter_size > 1:
            with torch.no_grad():
                if self._acc is None:
                    self._acc = [torch.zeros_like(p) for p in params]
                n = self.mini_step
                for a, p in zip(self._acc, params):
                    a.add_((p.grad - a) / (n + 1))  # Welford running mean
            self.mini_step += 1
            if self.mini_step < self.iter_size:
                return False
            for a, p in zip(self._acc, params):
                p.grad = a
            self._acc, self.mini_step = None, 0
        lr = float(self.schedule(self.updates)) * float(lr_scale)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.updates += 1
        return True


def _schedule(learning_rate: Union[float, Schedule]) -> Schedule:
    if callable(learning_rate):
        return learning_rate
    return lambda s: learning_rate


def sgd_torch(params: Iterable, learning_rate: Union[float, Schedule],
              momentum: float = 0.9, dampening: float = 0.1,
              weight_decay: float = 1e-4,
              iter_size: int = 1) -> ScheduledOptimizer:
    sched = _schedule(learning_rate)
    inner = torch.optim.SGD(params, lr=float(sched(0)), momentum=momentum,
                            dampening=dampening, weight_decay=weight_decay)
    return ScheduledOptimizer(inner, sched, iter_size)


def adam_torch(params: Iterable, learning_rate: Union[float, Schedule],
               b1: float = 0.9, b2: float = 0.999,
               weight_decay: float = 1e-4,
               iter_size: int = 1) -> ScheduledOptimizer:
    sched = _schedule(learning_rate)
    inner = torch.optim.Adam(params, lr=float(sched(0)), betas=(b1, b2),
                             eps=1e-8, weight_decay=weight_decay)
    return ScheduledOptimizer(inner, sched, iter_size)


def make_lr_schedule(scheduler: Optional[str], base_lr: float, *,
                     step_size: float = 2e4, step_gamma: float = 0.3,
                     multi_step_milestones: Sequence[int] = (120, 150),
                     poly_power: float = 0.9, max_steps: float = 400,
                     exp_gamma: float = 0.95,
                     exp_step_size: float = 445) -> Schedule:
    """Returns schedule(step) -> lr. The unit of ``step`` matches the
    reference's scheduler stepping cadence (epochs under PL's default)."""
    if scheduler == "StepLR":
        return lambda s: base_lr * step_gamma ** (s // step_size)
    if scheduler == "MultiStepLR":
        ms = tuple(multi_step_milestones)
        return lambda s: base_lr * step_gamma ** sum(s >= m for m in ms)
    if scheduler == "PolyLR":
        return lambda s: base_lr * max(1.0 - s / (max_steps + 1), 0.0) ** poly_power
    if scheduler == "SquaredLR":
        return lambda s: base_lr * max(1.0 - s / (max_steps + 1), 0.0) ** 2
    if scheduler == "ExpLR":
        return lambda s: base_lr * exp_gamma ** (s / exp_step_size)
    if scheduler in ("ReduceLROnPlateau", "none", None):
        return lambda s: base_lr
    raise ValueError(f"unknown scheduler {scheduler!r}")


def initialize_optimizer(params: Iterable, config,
                         schedule: Optional[Schedule] = None
                         ) -> ScheduledOptimizer:
    """Optimizer from a config object (reference lib/solvers.py:45-72):
    ``optimizer`` ('SGD' | 'Adam'), ``lr``, ``sgd_momentum``,
    ``sgd_dampening``, ``weight_decay``, ``adam_beta1``, ``adam_beta2`` and
    ``iter_size``. A schedule, if given, replaces ``config.lr``."""
    lr = schedule if schedule is not None else config.lr
    iter_size = int(getattr(config, "iter_size", 1) or 1)
    if config.optimizer == "SGD":
        return sgd_torch(params, lr, momentum=config.sgd_momentum,
                         dampening=config.sgd_dampening,
                         weight_decay=config.weight_decay,
                         iter_size=iter_size)
    if config.optimizer == "Adam":
        return adam_torch(params, lr, b1=config.adam_beta1,
                          b2=config.adam_beta2,
                          weight_decay=config.weight_decay,
                          iter_size=iter_size)
    raise ValueError(f"optimizer {config.optimizer!r} not supported")
