"""Objective functions for the training modes.

Counterpart of ``languagegroundedsemseg_tpu/train/objectives.py`` (:1-192),
re-expressing the loss assembly of the reference trainers as functions the
train step calls:
- baseline (pl_BaselineTrainer.py:311-358): CE/weighted-CE/focal, optional
  added embedding loss ('both'), head/common/tail balanced masking;
- representation (pl_RepresentationTrainer.py:200-256): contrastive or l2
  loss against CLIP text anchors + optional feature-norm penalty, with
  nearest-anchor predictions for metrics.

``objective(logits, features, batch, generator, row_mask, draws=None) ->
(loss, metrics)``. The random draws come from ``generator`` (on the
tensors' device) in a fixed order: the augmentation's coins and attributes,
the negatives, the balanced-masking uniform. ``draws`` may hold any of them
under the keyword names the loss functions take (``do_cat``, ``attr_cat``,
``negatives``, ``u``); a draw given there is used instead of drawn.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from languagegroundedsemseg_torch.losses.balancing import balanced_loss_masking
from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss, focal_loss
from languagegroundedsemseg_torch.losses.contrastive import (
    contrastive_language_loss,
    feature_norm_penalty,
    feature_sim,
    l2_anchor_loss,
    latent_attribute_augmentation,
)


def _tensor(a, device, dtype=torch.float32):
    return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _per_point_criterion(config, logits, labels, weights, row_mask):
    if config.loss_type == "focal":
        alpha = None if weights is None else weights * config.focal_alpha
        return focal_loss(
            logits, labels, gamma=config.focal_gamma, alpha=alpha,
            ignore_index=config.ignore_label, row_mask=row_mask, reduction="none",
        )
    w = weights if (config.loss_type == "weighted_ce" or config.weighted_cross_entropy) else None
    return cross_entropy_loss(
        logits, labels, ignore_index=config.ignore_label, weight=w,
        row_mask=row_mask, reduction="none",
    )


def _finalize(config, generator, per_point, labels, split_matrix, row_mask, u=None):
    """Balanced masking + split logging, or a plain valid mean."""
    metrics: Dict[str, torch.Tensor] = {}
    if config.balanced_category_sampling and split_matrix is not None:
        bl = balanced_loss_masking(
            generator,
            per_point,
            labels,
            split_matrix,
            head_ratio=config.balanced_sample_head_ratio,
            common_ratio=config.balanced_sample_common_ratio,
            ignore_index=config.ignore_label,
            row_mask=row_mask,
            u=u,
        )
        metrics["head_loss"] = bl.split_loss[0]
        metrics["common_loss"] = bl.split_loss[1]
        metrics["tail_loss"] = bl.split_loss[2]
        return bl.loss, metrics
    valid = (labels != config.ignore_label) & (row_mask > 0)
    loss = per_point.sum() / torch.clamp(valid.sum(), min=1)
    return loss, metrics


def _contrastive(config, generator, features, labels, anchors, row_mask,
                 pos_slot=None, negatives=None):
    return contrastive_language_loss(
        generator, features, labels, anchors, pos_slot=pos_slot,
        num_negatives=config.num_negative_samples,
        pos_thresh=config.contrast_pos_thresh,
        neg_thresh=config.contrast_neg_thresh,
        neg_weight=config.contrast_neg_weight,
        distance=config.representation_distance_type,
        ignore_index=config.ignore_label,
        row_mask=row_mask, reduction="none", negatives=negatives,
    )


def make_baseline_objective(
    config,
    category_weights: Optional[np.ndarray] = None,
    split_matrix: Optional[np.ndarray] = None,
    anchors: Optional[np.ndarray] = None,
    device="cuda",
):
    """objective(logits, features, batch, generator, row_mask, draws=None)
    -> (loss, metrics).

    When config.use_embedding_loss == 'both', the contrastive language loss
    on backbone features is added to the classification loss
    (pl_BaselineTrainer.py:325-347, scripts/fine_tune_classifier.sh).
    The tables (weights, split, anchors) live on ``device``.
    """
    weights = _tensor(category_weights, device)
    split = _tensor(split_matrix, device, torch.bool)
    anchors_t = _tensor(anchors, device)

    def objective(logits, features, batch, generator, row_mask, draws=None):
        draws = draws or {}
        labels = batch.labels
        per_point = _per_point_criterion(config, logits, labels, weights, row_mask)
        metrics: Dict[str, torch.Tensor] = {}

        if config.use_embedding_loss and anchors_t is not None:
            if config.embedding_loss_type == "l2":
                emb = l2_anchor_loss(
                    features, labels, anchors_t, config.ignore_label, row_mask
                )
            else:
                _, pos_l, neg_l = _contrastive(
                    config, generator, features, labels, anchors_t, row_mask,
                    negatives=draws.get("negatives"))
                emb = pos_l + config.contrast_neg_weight * neg_l
            emb = emb * config.embedding_loss_lambda
            metrics["embedding_loss"] = emb.sum() / torch.clamp((row_mask > 0).sum(), min=1)
            per_point = per_point + emb

        loss, m2 = _finalize(config, generator, per_point, labels, split,
                             row_mask, u=draws.get("u"))
        metrics.update(m2)
        return loss, metrics

    return objective


def make_representation_objective(
    config,
    anchors: np.ndarray,
    split_matrix: Optional[np.ndarray] = None,
    projection_w: Optional[np.ndarray] = None,
    device="cuda",
):
    """Language-grounded pretraining loss (RepresentationTrainer).

    When config.instance_augmentation == 'latent' and attributed anchors
    (C, A>1, D) plus projection weights are available, tail-category features
    are rotated into a random attribute's latent space and pulled toward the
    attributed prompt anchor (reference pl_RepresentationTrainer.py:46 +
    ContrastiveLanguageLoss.py:161-166).
    """
    anchors_t = _tensor(anchors, device)
    latent = (
        config.instance_augmentation == "latent"
        and projection_w is not None
        and anchors_t.dim() == 3
        and anchors_t.shape[1] > 1
        and split_matrix is not None
    )
    proj_t = _tensor(projection_w, device)
    split = _tensor(split_matrix, device, torch.bool)
    tail_mask = split[:, 2] if latent else None

    def objective(features, _features_again, batch, generator, row_mask, draws=None):
        draws = draws or {}
        labels = batch.labels
        pos_slot = None
        if latent:
            features, pos_slot = latent_attribute_augmentation(
                generator, features, labels, proj_t, tail_mask,
                config.instance_augmentation_color_aug_prob,
                ignore_index=config.ignore_label,
                do_cat=draws.get("do_cat"), attr_cat=draws.get("attr_cat"),
            )
        if config.use_embedding_loss == "l2" or config.embedding_loss_type == "l2":
            per_point = l2_anchor_loss(features, labels, anchors_t, config.ignore_label, row_mask)
            pos_mean = per_point.sum() / torch.clamp((row_mask > 0).sum(), min=1)
            neg_mean = torch.zeros((), device=per_point.device)
        else:
            _, pos_l, neg_l = _contrastive(
                config, generator, features, labels, anchors_t, row_mask,
                pos_slot=pos_slot, negatives=draws.get("negatives"))
            per_point = pos_l + config.contrast_neg_weight * neg_l
            denom = torch.clamp((row_mask > 0).sum(), min=1)
            pos_mean, neg_mean = pos_l.sum() / denom, neg_l.sum() / denom

        loss, metrics = _finalize(config, generator, per_point, labels, split,
                                  row_mask, u=draws.get("u"))
        metrics["pos_loss"] = pos_mean
        metrics["neg_loss"] = neg_mean

        if config.normalize_features:
            pen = feature_norm_penalty(features, row_mask, config.feat_norm_loss_max)
            metrics["feat_norm_penalty"] = pen
            loss = loss + pen
        return loss, metrics

    return objective


def representation_predictions(features, anchors, distance: str = "cos"):
    """Nearest-anchor classification for pretraining metrics
    (pl_RepresentationTrainer.py:238-239 feature_sim argmax)."""
    anchors = torch.as_tensor(anchors, device=features.device)
    return torch.argmax(feature_sim(features, anchors, distance), dim=-1)
