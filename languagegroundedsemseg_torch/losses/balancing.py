"""Head/common/tail balanced loss masking.

Counterpart of ``languagegroundedsemseg_tpu/losses/balancing.py`` (:20-85),
the vectorized equivalent of reference lib/losses/utils.py:13-77
(sample_categories_for_balancing): per-point Bernoulli keep masks replace
the per-category numpy choice-without-replacement loop (same expectation,
fully on the device). Tail categories are always kept; head/common are
subsampled by the configured ratios (<= 0 means keep all). Also returns
per-split mean losses for the head/common/tail logging the reference does.

The one random draw, the per-point uniform ``u``, can be passed in; it is
drawn from ``generator`` (on the loss's device) only when absent.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class BalancedLoss(NamedTuple):
    loss: torch.Tensor          # scalar: masked loss mean
    split_loss: torch.Tensor    # (3,) head/common/tail mean losses (detached)
    split_count: torch.Tensor   # (3,) number of points per split


def split_masks_from_sets(num_classes: int, head_ids, common_ids, tail_ids) -> np.ndarray:
    """(C, 3) bool matrix — the dataset's frequency_organized_cats
    (reference lib/datasets/scannet.py:127-141)."""
    m = np.zeros((num_classes, 3), dtype=bool)
    m[np.asarray(list(head_ids), dtype=int), 0] = True
    m[np.asarray(list(common_ids), dtype=int), 1] = True
    m[np.asarray(list(tail_ids), dtype=int), 2] = True
    return m


def balanced_loss_masking(
    generator: Optional[torch.Generator],
    loss: torch.Tensor,
    labels: torch.Tensor,
    split_matrix: torch.Tensor,
    *,
    head_ratio: float = -1.0,
    common_ratio: float = -1.0,
    ignore_index: int = 255,
    row_mask: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> BalancedLoss:
    """loss: per-point loss (N,); labels: (N,); split_matrix: (C, 3) bool.

    Mean semantics follow the reference: the masked loss is averaged over all
    (non-padding) rows — not just the sampled ones (lib/losses/utils.py:75-77).
    ``u``: the (N,) uniform draw of the keep masks (drawn from
    ``generator`` when None and a ratio is set).
    """
    c = split_matrix.shape[0]
    valid = labels != ignore_index
    if row_mask is not None:
        valid = valid & (row_mask > 0)
    safe = torch.clamp(labels.long(), 0, c - 1)
    split = split_matrix.to(device=loss.device, dtype=torch.int32)[safe]  # (N, 3)
    split = split * valid[:, None].to(torch.int32)
    is_head, is_common, is_tail = split[:, 0], split[:, 1], split[:, 2]

    keep = valid
    if head_ratio > 0.0 or common_ratio > 0.0:
        if u is None:
            u = torch.rand(loss.shape, generator=generator, device=loss.device)
        if head_ratio > 0.0:
            keep = keep & torch.where(is_head > 0, u < head_ratio, True)
        if common_ratio > 0.0:
            keep = keep & torch.where(is_common > 0, u < common_ratio, True)

    masked = torch.where(keep, loss, torch.zeros((), device=loss.device))
    denom = (
        torch.clamp((row_mask > 0).sum(), min=1) if row_mask is not None else loss.shape[0]
    )
    mean_loss = masked.sum() / denom

    counts = torch.stack([is_head.sum(), is_common.sum(), is_tail.sum()]).to(torch.float32)
    sums = torch.stack([
        (loss * is_head).sum(),
        (loss * is_common).sum(),
        (loss * is_tail).sum(),
    ])
    split_loss = sums / torch.clamp(counts, min=1.0)
    return BalancedLoss(mean_loss, split_loss.detach(), counts)
