"""Per-batch-item (segment) reductions over sparse rows.

Counterpart of ``languagegroundedsemseg_tpu/ops/segment.py``: segment sums
and maxima keyed by the batch index, with invalid rows sent to a dropped
extra segment, and the masked batch statistics of a batch norm.
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


def batch_max(x, batch_idx, mask, num_segments: int) -> torch.Tensor:
    """(cap, C) -> (B, C) per-batch-item max over valid rows (ME global max
    pooling); -inf for an item without rows, as JAX's segment_max leaves
    it."""
    seg = torch.where(mask > 0, batch_idx.long(),
                      torch.full_like(batch_idx, num_segments, dtype=torch.long))
    neg = torch.finfo(torch.float32).min
    xm = torch.where((mask > 0)[:, None], x.to(torch.float32),
                     torch.full((), neg, device=x.device))
    out = torch.full((num_segments + 1, x.shape[1]), float("-inf"),
                     dtype=torch.float32, device=x.device)
    idx = seg[:, None].expand(-1, x.shape[1])
    m = out.scatter_reduce(0, idx, xm, reduce="amax")[:num_segments]
    return torch.where(m == neg, torch.zeros((), device=x.device), m)


def masked_mean_var(x, mask):
    """(mean (C,), biased variance (C,), count ()) over the valid rows of
    the whole batch: padding rows are excluded, which keeps batch-norm
    statistics equal to ME's (ME has no padding)."""
    m = mask.to(torch.float32)[:, None]
    cnt = torch.clamp(m.sum(), min=1.0)
    xf = x.to(torch.float32)
    mean = (xf * m).sum(dim=0) / cnt
    d = (xf - mean) * m
    return mean, (d * d).sum(dim=0) / cnt, cnt
