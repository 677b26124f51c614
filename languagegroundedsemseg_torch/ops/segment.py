"""Per-batch-item (segment) reductions over sparse rows.

Counterpart of ``languagegroundedsemseg_tpu/ops/segment.py`` (``batch_mean``,
``batch_broadcast``): segment sums keyed by the batch index, with invalid
rows sent to a dropped extra segment.
"""

from __future__ import annotations

import torch


def batch_sum(x, batch_idx, mask, num_segments: int) -> torch.Tensor:
    """(cap, C) -> (B, C) per-batch-item sum over valid rows."""
    seg = torch.where(mask > 0, batch_idx.long(),
                      torch.full_like(batch_idx, num_segments, dtype=torch.long))
    out = torch.zeros((num_segments + 1, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, seg, x.to(torch.float32))[:num_segments]


def batch_count(batch_idx, mask, num_segments: int) -> torch.Tensor:
    ones = mask.to(torch.float32)[:, None]
    return batch_sum(ones, batch_idx, mask, num_segments)[:, 0]


def batch_mean(x, batch_idx, mask, num_segments: int) -> torch.Tensor:
    """(cap, C) -> (B, C) per-batch-item mean over valid rows."""
    s = batch_sum(x, batch_idx, mask, num_segments)
    c = batch_count(batch_idx, mask, num_segments)
    return s / torch.clamp(c, min=1.0)[:, None]


def batch_broadcast(values, batch_idx) -> torch.Tensor:
    """(B, C) per-item values -> (cap, C) rows."""
    return values[batch_idx.long()]
