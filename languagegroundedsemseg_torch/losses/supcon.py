"""Supervised point-contrastive loss with confusion-driven hard negatives.

Counterpart of ``languagegroundedsemseg_tpu/losses/supcon.py``, the
vectorized redesign of reference lib/losses/PointSupConLoss.py:15-154:
positives are exact-uniform same-label draws through a sorted-by-label
prefix table; negatives are Gumbel-categorical draws over classes weighted
by the confusion histogram row (times the in-batch class counts), then a
uniform point draw inside the chosen class. Hinge losses as in the
contrastive language loss.

The random draws can be passed in: ``u_pos`` (num_pos, N) uniforms for the
positives, ``gumbel`` (num_neg, N, C) for the negatives' classes and
``u_neg`` (num_neg, N) uniforms for their points. Each is drawn from
``generator`` (on the features' device) only when absent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from languagegroundedsemseg_torch.losses.contrastive import _pair_dist


def _class_tables(labels: torch.Tensor, valid: torch.Tensor, num_classes: int):
    """Rows sorted by class (invalid rows last, stable) and each class's
    (start, count) in that order, for uniform draws."""
    safe = torch.where(valid, labels.long(), torch.full_like(labels.long(), num_classes))
    order = torch.argsort(safe, stable=True)
    counts = torch.bincount(safe, minlength=num_classes + 1)[:num_classes]
    starts = torch.cumsum(counts, 0) - counts
    return order, starts, counts


def _uniform_draw_in_class(u, cls, order, starts, counts, fallback):
    """For each row, the point at uniform ``u`` among those of class
    ``cls[i]`` (``fallback`` when the class has none)."""
    c = counts[cls]
    r = torch.floor(u * torch.clamp(c, min=1).to(u.dtype)).long()
    pos = starts[cls] + torch.minimum(r, torch.clamp(c - 1, min=0))
    return torch.where(c > 0, order[pos], fallback)


def _gumbel(generator, shape, device):
    """Standard Gumbel draws, as ``jax.random.gumbel`` forms them from
    uniforms on [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device) * (1.0 - tiny) + tiny
    return -torch.log(-torch.log(u))


def point_supcon_loss(
    generator: Optional[torch.Generator],
    features: torch.Tensor,
    labels: torch.Tensor,
    confusion_hist: torch.Tensor,
    *,
    num_pos: int = 1,
    num_neg: int = 3,
    pos_thresh: float = 0.0,
    neg_thresh: float = 0.6,
    neg_weight: float = 1.0,
    distance: str = "cos",
    ignore_index: int = 255,
    row_mask: Optional[torch.Tensor] = None,
    preds: Optional[torch.Tensor] = None,
    u_pos: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
    u_neg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss, pos_loss_per_point, neg_loss_per_point)."""
    c = confusion_hist.shape[0]
    n = features.shape[0]
    dev = features.device
    feats = features.to(torch.float32)
    comp = feats.detach()  # the reference contrasts against detached feats

    valid = labels != ignore_index
    if row_mask is not None:
        valid = valid & (row_mask > 0)
    safe = torch.clamp(labels.long(), 0, c - 1)
    self_idx = torch.arange(n, device=dev)

    # positives: uniform same-label points (self allowed, as in the reference)
    order, starts, counts = _class_tables(safe, valid, c)
    if u_pos is None:
        u_pos = torch.rand((num_pos, n), generator=generator, device=dev)
    pos_idx = torch.stack([
        _uniform_draw_in_class(u_pos[s], safe, order, starts, counts, self_idx)
        for s in range(num_pos)], dim=1)
    pos = comp[pos_idx]

    # negatives: class ~ confusion[l] * counts * present * (c' != l), then a
    # uniform point of that class (restricted to correct preds if given)
    present = (counts > 0).to(torch.float32)
    conf = confusion_hist.to(device=dev, dtype=torch.float32) + 1.0  # +1 smoothing
    w = conf[safe] * counts.to(torch.float32)[None, :] * present[None, :]
    w = w * (1.0 - torch.nn.functional.one_hot(safe, c).to(torch.float32))
    logw = torch.log(torch.clamp(w, min=1e-20))
    has_any = w.sum(-1) > 0

    if preds is not None:
        correct = valid & (preds == labels)
        order_c, starts_c, counts_c = _class_tables(safe, correct, c)
    else:
        order_c, starts_c, counts_c = order, starts, counts

    if gumbel is None:
        gumbel = _gumbel(generator, (num_neg, n, c), dev)
    if u_neg is None:
        u_neg = torch.rand((num_neg, n), generator=generator, device=dev)
    neg_list = []
    for s in range(num_neg):
        neg_cls = torch.argmax(logw + gumbel[s], dim=-1)
        idx = _uniform_draw_in_class(u_neg[s], neg_cls, order_c, starts_c,
                                     counts_c, self_idx)
        neg_list.append(torch.where(has_any, idx, self_idx))
    neg = comp[torch.stack(neg_list, dim=1)]

    zero = torch.zeros((), device=dev)
    d_pos = torch.where(valid, _pair_dist(feats, pos, distance), zero)
    d_neg = torch.where(valid, _pair_dist(feats, neg, distance), zero)
    pos_loss = torch.where(valid, torch.relu(d_pos - pos_thresh), zero)
    neg_loss = torch.where(valid, torch.relu(neg_thresh - d_neg), zero)
    denom = torch.clamp((row_mask > 0).sum(), min=1) if row_mask is not None else max(n, 1)
    loss = pos_loss.sum() / denom + neg_weight * neg_loss.sum() / denom
    return loss, pos_loss, neg_loss
