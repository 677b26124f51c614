"""Language-grounded contrastive losses against CLIP text anchors.

Counterpart of ``languagegroundedsemseg_tpu/losses/contrastive.py``
(:25-234), the vectorized redesign of reference
lib/losses/ContrastiveLanguageLoss.py:20-237: positives are one gather
(``anchors[labels]``) and negatives one uniform draw with self-exclusion.

Distance conventions mirror feat_dist (:73-95): per-point distance is the
mean over the sampled anchors of
  cos: 1 - cos_sim        l2: sqrt(||a-b||^2 + 1e-7)     l1: signed sum diff
Hinges: relu(d_pos - pos_thresh) + neg_weight * relu(neg_thresh - d_neg),
ignored rows contribute 0 but still count in the mean denominator (the
reference means over the full point tensor).

On the card, the cosine distance against one anchor a class runs as one
autograd node on hand-written kernels (``ops/contrastive.py``), which keeps
per-row scalars where the eager arithmetic keeps (N, S, D) tensors; the
CPU, the other distances and the attributed anchors stay eager.

Each random draw is split from the arithmetic that uses it: the negatives'
class ids (``negatives``) and the augmentation's per-category coins and
attributes (``do_cat``, ``attr_cat``) can be passed in, and are drawn from
``generator`` (on the features' device) only when absent.
"""

from __future__ import annotations

from typing import Optional

import torch

from languagegroundedsemseg_torch.ops.contrastive import contrastive_cos


def _normalize(x, dim=-1, eps=1e-12):
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _pair_dist(feats, samples, kind: str):
    """feats (N, D), samples (N, S, D) -> (N,) mean distance over S."""
    if kind == "cos":
        fn = _normalize(feats)[:, None, :]  # (N, 1, D)
        sn = _normalize(samples, dim=-1)
        return 1.0 - (fn * sn).sum(dim=-1).mean(dim=-1)
    if kind == "l2":
        d2 = ((feats[:, None, :] - samples) ** 2).sum(dim=-1)
        return torch.sqrt(d2 + 1e-7).mean(dim=-1)
    if kind == "l1":
        # Signed sum — intentional parity with the reference's l1 branch.
        return (feats[:, None, :] - samples).sum(dim=-1).mean(dim=-1)
    raise ValueError(f"unknown distance {kind!r}")


def _takes_node(features, distance: str, attributed) -> bool:
    """Whether the hinges run as the one autograd node of
    ``ops/contrastive.py``: on the card, cosine distance, one anchor a
    class. Nothing of size (N, S, D) is made there."""
    return features.is_cuda and distance == "cos" and attributed is None


def sample_negatives(
    generator: Optional[torch.Generator],
    labels: torch.Tensor,
    num_classes: int,
    num_samples: int,
    r: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(N, S) class ids drawn uniformly from {0..C-1} \\ {label}. ``r``:
    the (N, S) draw from {0..C-2} (drawn from ``generator`` when None)."""
    n = labels.shape[0]
    if r is None:
        r = torch.randint(0, num_classes - 1, (n, num_samples),
                          generator=generator, device=labels.device)
    lab = torch.clamp(labels.long(), 0, num_classes - 1)[:, None]
    return r.long() + (r >= lab).long()


def latent_attribute_augmentation(
    generator: Optional[torch.Generator],
    features: torch.Tensor,
    labels: torch.Tensor,
    projection_w: torch.Tensor,
    augment_mask: torch.Tensor,
    aug_prob: float,
    ignore_index: int = 255,
    *,
    do_cat: Optional[torch.Tensor] = None,
    attr_cat: Optional[torch.Tensor] = None,
):
    """Latent attribute augmentation (reference
    ContrastiveLanguageLoss.py:61-69,161-166, vectorized).

    For each eligible (tail) category, with probability ``aug_prob`` that
    category's features are rotated through one randomly chosen attribute
    head of the pretrained AttributeFittingModel and the positive anchor is
    retargeted to the attributed prompt. The per-category coin and
    attribute are (C,) vectors and the projection is applied as A masked
    matmuls.

    projection_w: (A, D, D) attribute rotations.
    augment_mask: (C,) bool — categories eligible (the tail split).
    do_cat: (C,) bool coins (drawn when None; ANDed with augment_mask).
    attr_cat: (C,) attribute ids in [0, A) (drawn when None).
    Returns (features', pos_slot (N,) int32): slot 0 = raw category prompt,
    slot a+1 = attributed prompt a, matching the anchor layout
    anchors[:, 0] = raw / anchors[:, 1:] = attributed.
    """
    num_attributes = projection_w.shape[0]
    num_cats = augment_mask.shape[0]
    dev = features.device
    augment_mask = augment_mask.to(device=dev, dtype=torch.bool)
    if do_cat is None:
        do_cat = torch.rand((num_cats,), generator=generator, device=dev) < aug_prob
    do_cat = do_cat.to(device=dev, dtype=torch.bool) & augment_mask
    if attr_cat is None:
        attr_cat = torch.randint(0, num_attributes, (num_cats,),
                                 generator=generator, device=dev)
    attr_cat = attr_cat.to(device=dev, dtype=torch.long)

    safe = torch.clamp(labels.long(), 0, num_cats - 1)
    valid = labels != ignore_index
    do_pt = do_cat[safe] & valid
    attr_pt = attr_cat[safe]

    f32 = features.to(torch.float32)
    out = f32
    proj = projection_w.to(device=dev, dtype=torch.float32)
    for a in range(num_attributes):  # A masked matmuls, (N, D) memory
        sel = (do_pt & (attr_pt == a))[:, None]
        out = torch.where(sel, f32 @ proj[a], out)
    pos_slot = torch.where(do_pt, attr_pt + 1, 0).to(torch.int32)
    return out.to(features.dtype), pos_slot


def contrastive_language_loss(
    generator: Optional[torch.Generator],
    features: torch.Tensor,
    labels: torch.Tensor,
    anchors: torch.Tensor,
    *,
    num_negatives: int = 3,
    pos_thresh: float = 0.0,
    neg_thresh: float = 0.6,
    neg_weight: float = 1.0,
    distance: str = "cos",
    ignore_index: int = 255,
    row_mask: Optional[torch.Tensor] = None,
    reduction: str = "mean",
    pos_slot: Optional[torch.Tensor] = None,
    negatives: Optional[torch.Tensor] = None,
):
    """Returns (loss, pos_loss_per_point, neg_loss_per_point).

    ``pos_slot`` (from latent_attribute_augmentation) selects the attributed
    anchor slot per point when ``anchors`` is (C, A, D); negatives always
    come from the raw slot 0 (reference ContrastiveLanguageLoss.py:176).
    ``negatives``: the (N, num_negatives) negative class ids, as
    ``sample_negatives`` returns them (drawn from ``generator`` when None).
    """
    attributed = None
    if anchors.dim() == 3:  # (C, A, D) attributed anchors
        if pos_slot is not None and anchors.shape[1] > 1:
            attributed = anchors.to(torch.float32)
        anchors = anchors[:, 0, :]
    c = anchors.shape[0]
    anchors = anchors.to(torch.float32)
    safe = torch.clamp(labels.long(), 0, c - 1)
    if negatives is None:
        negatives = sample_negatives(generator, safe, c, num_negatives)

    if _takes_node(features, distance, attributed):
        pos_loss, neg_loss = contrastive_cos(
            features, labels, anchors, negatives, row_mask=row_mask,
            ignore_index=ignore_index, pos_thresh=pos_thresh,
            neg_thresh=neg_thresh)
    else:
        feats = features.to(torch.float32)
        valid = labels != ignore_index
        if row_mask is not None:
            valid = valid & (row_mask > 0)
        if attributed is not None:
            slot = torch.clamp(pos_slot.long(), 0, attributed.shape[1] - 1)
            pos = attributed[safe, slot][:, None, :]  # (N, 1, D)
        else:
            pos = anchors[safe][:, None, :]  # (N, 1, D)
        neg = anchors[negatives.long()]  # (N, S, D)
        zero = _zero(feats)
        d_pos = torch.where(valid, _pair_dist(feats, pos, distance), zero)
        d_neg = torch.where(valid, _pair_dist(feats, neg, distance), zero)
        pos_loss = torch.where(valid, torch.relu(d_pos - pos_thresh), zero)
        neg_loss = torch.where(valid, torch.relu(neg_thresh - d_neg), zero)

    if reduction == "mean":
        denom = (
            torch.clamp((row_mask > 0).sum(), min=1)
            if row_mask is not None
            else pos_loss.shape[0]
        )
        loss = pos_loss.sum() / denom + neg_weight * neg_loss.sum() / denom
        return loss, pos_loss, neg_loss
    return pos_loss + neg_weight * neg_loss, pos_loss, neg_loss


def contrastive_language_ce_loss(
    features: torch.Tensor,
    labels: torch.Tensor,
    anchors: torch.Tensor,
    *,
    distance: str = "cos",
    ignore_index: int = 255,
    row_mask: Optional[torch.Tensor] = None,
):
    """CE over anchor-similarity logits (reference
    ContrastiveLanguageCELoss:197-237)."""
    from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss

    if anchors.dim() == 3:
        anchors = anchors[:, 0, :]
    sims = feature_sim(features, anchors, distance)
    return cross_entropy_loss(sims, labels, ignore_index, row_mask=row_mask)


def l2_anchor_loss(
    features: torch.Tensor,
    labels: torch.Tensor,
    anchors: torch.Tensor,
    ignore_index: int = 255,
    row_mask: Optional[torch.Tensor] = None,
):
    """Per-point mean-squared distance to the own-category anchor — the 'l2'
    embedding loss path (reference lib/losses/utils.py:6-10). Returns the
    per-point loss vector (0 at ignored/padding rows)."""
    if anchors.dim() == 3:
        anchors = anchors[:, 0, :]
    c = anchors.shape[0]
    valid = labels != ignore_index
    if row_mask is not None:
        valid = valid & (row_mask > 0)
    safe = torch.clamp(labels.long(), 0, c - 1)
    target = anchors.to(torch.float32)[safe]
    per_point = ((features.to(torch.float32) - target) ** 2).mean(dim=-1)
    return torch.where(valid, per_point, _zero(per_point))


def feature_sim(features: torch.Tensor, anchors: torch.Tensor, distance: str = "cos"):
    """(N, C) similarity scores; argmax = nearest-anchor classification
    (reference lib/losses/utils.py:80-103)."""
    if anchors.dim() == 3:
        anchors = anchors[:, 0, :]
    f = features.to(torch.float32)
    a = anchors.to(device=f.device, dtype=torch.float32)
    if distance == "cos":
        return _normalize(f) @ _normalize(a).T
    if distance == "l2":
        d2 = (f * f).sum(-1, keepdim=True) - 2.0 * (f @ a.T) + (a * a).sum(-1)[None, :]
        return -d2
    if distance == "l1":
        # Signed-sum parity with the reference.
        return -(f.sum(-1, keepdim=True) - a.sum(-1)[None, :])
    raise ValueError(f"unknown distance {distance!r}")


def feature_norm_penalty(features, row_mask=None, max_penalty: float = 0.2):
    """Unit-sphere projection penalty (reference
    pl_RepresentationTrainer.py:233-235, config normalize_features)."""
    norms = torch.linalg.vector_norm(features.to(torch.float32), dim=-1)
    pen = torch.clamp((norms - 1.0) ** 2, max=max_penalty)
    if row_mask is not None:
        pen = torch.where(row_mask > 0, pen, _zero(pen))
        return pen.sum() / torch.clamp((row_mask > 0).sum(), min=1)
    return pen.mean()
