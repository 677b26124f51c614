"""Per-voxel classification losses (CE / weighted CE / focal).

Counterpart of ``languagegroundedsemseg_tpu/losses/classification.py``.
Semantics match the reference:

- CE: ``torch.nn.CrossEntropyLoss(ignore_index)`` — ignored rows give 0
  loss; 'mean' divides by the number of non-ignored rows, or, with class
  weights, by the sum of the selected weights.
- Focal (reference lib/losses/FocalLoss.py:9-93): (1 - pt)^gamma *
  alpha[y] * (-log pt); 'mean' divides by the number of non-ignored rows.

Every function also takes ``row_mask`` to exclude padding rows.
"""

from __future__ import annotations

from typing import Optional

import torch


def _valid(labels, ignore_index, row_mask):
    v = labels != ignore_index
    if row_mask is not None:
        v = v & (row_mask > 0)
    return v


def _log_pt(logits, labels):
    """(log p of each row's label, clipped label) in f32."""
    safe = torch.clamp(labels.long(), 0, logits.shape[-1] - 1)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return logp.gather(1, safe[:, None])[:, 0], safe


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255,
                       weight: Optional[torch.Tensor] = None,
                       row_mask: Optional[torch.Tensor] = None,
                       reduction: str = "mean") -> torch.Tensor:
    """Softmax CE. weight: optional (C,) per-class weights (weighted CE)."""
    valid = _valid(labels, ignore_index, row_mask)
    log_pt, safe = _log_pt(logits, labels)
    nll = -log_pt
    if weight is not None:
        w = weight.to(torch.float32)[safe]
        nll = nll * w
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if weight is not None:
        denom = torch.where(valid, w, torch.zeros((), device=w.device)).sum()
    else:
        denom = valid.sum().to(torch.float32)
    return nll.sum() / torch.clamp(denom, min=1.0)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, alpha: Optional[torch.Tensor] = None,
               ignore_index: int = 255,
               row_mask: Optional[torch.Tensor] = None,
               reduction: str = "mean") -> torch.Tensor:
    valid = _valid(labels, ignore_index, row_mask)
    log_pt, safe = _log_pt(logits, labels)
    ce = -log_pt
    if alpha is not None:
        ce = ce * alpha.to(torch.float32)[safe]
    loss = (1.0 - torch.exp(log_pt)) ** gamma * ce
    loss = torch.where(valid, loss, torch.zeros((), device=loss.device))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / torch.clamp(valid.sum().to(torch.float32), min=1.0)


def loss_by_name(name: str, ignore_index: int = 255,
                 weight: Optional[torch.Tensor] = None,
                 focal_gamma: float = 2.0, focal_alpha_scale: float = 1.0,
                 reduction: str = "mean"):
    """Criterion factory (reference lib/utils.py:112 loss_by_name).

    Returns ``fn(logits, labels, row_mask=None) -> loss``.
    name: 'cross_entropy' | 'weighted_ce' | 'focal'. For 'focal' the
    category weights scaled by ``focal_alpha_scale`` are the alpha vector,
    as the reference trainer's init_criterions does."""
    if name == "cross_entropy":
        return lambda lg, lb, row_mask=None: cross_entropy_loss(
            lg, lb, ignore_index, None, row_mask, reduction)
    if name == "weighted_ce":
        if weight is None:
            raise ValueError("weighted_ce requires category weights")
        return lambda lg, lb, row_mask=None: cross_entropy_loss(
            lg, lb, ignore_index, weight, row_mask, reduction)
    if name == "focal":
        alpha = None if weight is None else weight * focal_alpha_scale
        return lambda lg, lb, row_mask=None: focal_loss(
            lg, lb, focal_gamma, alpha, ignore_index, row_mask, reduction)
    raise ValueError(f"unknown loss type {name!r}")
