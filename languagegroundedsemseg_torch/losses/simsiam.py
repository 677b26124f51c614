"""SimSiam-style paired-view losses with voxel correspondences, and two
more per-voxel classification losses.

Counterpart of ``languagegroundedsemseg_tpu/losses/simsiam.py``, the
mirror of reference lib/losses/SupervisedSimiam.py:
- ``point_simsiam_loss`` (:67-88): mean (1 - cos) between view-1 features
  and the corresponding view-2 features;
- ``supervised_simsiam_loss`` (:14-64): per-view anchor cosine losses (to
  the label's CLIP feature), / 4, each balanced-masked; the paired cosine
  terms are computed for logging.
Correspondence arrays may hold -1 (a dropped partner row), masked out.
``soft_iou_loss`` (reference lib/losses/SoftIoULoss.py:6-41) and
``recall_cross_entropy`` (RecallCrossEntropy.py:4-46).

The balanced masking's two draws, one per view (JAX splits its key in
two), can be passed in as ``u1`` / ``u2``; each is drawn from
``generator`` only when absent and a ratio is set.
"""

from __future__ import annotations

from typing import Optional

import torch

from languagegroundedsemseg_torch.losses.balancing import balanced_loss_masking
from languagegroundedsemseg_torch.losses.classification import _valid
from languagegroundedsemseg_torch.losses.contrastive import _normalize


def cosine_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return 1.0 - (_normalize(a) * _normalize(b)).sum(-1)


def point_simsiam_loss(z1, z2, corrs1, row_mask1=None):
    """Mean 1 - cos(z1[i], z2[corrs1[i]]) over the valid correspondences."""
    ok = corrs1 >= 0
    if row_mask1 is not None:
        ok = ok & (row_mask1 > 0)
    partner = z2[torch.clamp(corrs1, min=0).long()]
    per = torch.where(ok, cosine_loss(z1, partner),
                      torch.zeros((), device=z1.device))
    return per.sum() / torch.clamp(ok.sum(), min=1)


def supervised_simsiam_loss(
    generator: Optional[torch.Generator],
    config,
    p1, p2, z1, z2,
    corrs1, corrs2,
    labels1, labels2,
    anchors: torch.Tensor,
    split_matrix=None,
    row_mask1=None, row_mask2=None,
    *,
    u1: Optional[torch.Tensor] = None,
    u2: Optional[torch.Tensor] = None,
):
    """Returns (total_loss, metrics)."""
    c = anchors.shape[0]

    def view_loss(p, labels, row_mask, u):
        valid = _valid(labels, config.ignore_label, row_mask)
        target = anchors[torch.clamp(labels.long(), 0, c - 1)]
        per = torch.where(valid, cosine_loss(p, target),
                          torch.zeros((), device=p.device)) / 4.0
        if config.balanced_category_sampling and split_matrix is not None:
            return balanced_loss_masking(
                generator, per, labels, torch.as_tensor(split_matrix),
                head_ratio=config.balanced_sample_head_ratio,
                common_ratio=config.balanced_sample_common_ratio,
                ignore_index=config.ignore_label, row_mask=row_mask, u=u,
            ).loss
        return per.sum() / torch.clamp(valid.sum(), min=1)

    loss1 = view_loss(p1, labels1, row_mask1, u1)
    loss2 = view_loss(p2, labels2, row_mask2, u2)
    metrics = {
        "simsiam_loss1": point_simsiam_loss(p1, z2, corrs1, row_mask1),
        "simsiam_loss2": point_simsiam_loss(p2, z1, corrs2, row_mask2),
        "anchor_loss1": loss1,
        "anchor_loss2": loss2,
    }
    return loss1 + loss2, metrics


def soft_iou_loss(logits, labels, num_classes: int, ignore_index: int = 255,
                  row_mask=None):
    """1 - the mean over classes of the soft IoU over the valid points."""
    valid = _valid(labels, ignore_index, row_mask)
    pred = torch.softmax(logits.to(torch.float32), dim=-1)
    onehot = torch.nn.functional.one_hot(
        torch.clamp(labels.long(), 0, num_classes - 1), num_classes).to(torch.float32)
    m = valid[:, None].to(torch.float32)
    inter = (pred * onehot * m).sum(0)
    union = ((pred + onehot - pred * onehot) * m).sum(0)
    return 1.0 - (inter / (union + 1e-16)).mean()


def recall_cross_entropy(logits, labels, num_classes: int, ignore_index: int = 255,
                         row_mask=None):
    """CE reweighted by each class's in-batch false-negative rate."""
    valid = _valid(labels, ignore_index, row_mask)
    safe = torch.clamp(labels.long(), 0, num_classes - 1)
    pred = torch.argmax(logits, dim=-1)
    wrong = valid & (pred != labels)
    none = torch.full_like(safe, num_classes)

    def count(sel):
        return torch.clamp(torch.bincount(torch.where(sel, safe, none),
                                          minlength=num_classes + 1)[:num_classes],
                           min=1)

    weight = count(wrong).to(torch.float32) / count(valid).to(torch.float32)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ce = -logp.gather(1, safe[:, None])[:, 0]
    per = torch.where(valid, weight[safe] * ce, torch.zeros((), device=logits.device))
    return per.sum() / torch.clamp(valid.sum(), min=1)
