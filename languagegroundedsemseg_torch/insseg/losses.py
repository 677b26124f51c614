"""Offset regression losses for instance segmentation.

Counterpart of ``languagegroundedsemseg_tpu/insseg/losses.py`` (:17-40),
the mirror of reference downstream/insseg/lib/pl_Trainer.py:286-298:
- norm loss: mean L1 distance between predicted and GT offsets (voxel
  coords -> meters via voxel_size), over points with a valid instance id;
- direction loss: mean negative cosine between predicted and GT offset
  directions.
"""

from __future__ import annotations

from typing import Tuple

import torch


def offset_losses(
    pt_offsets: torch.Tensor,
    coords_xyz: torch.Tensor,
    centers: torch.Tensor,
    instance_valid: torch.Tensor,
    voxel_size: float,
    row_mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """pt_offsets (N,3) in meters; coords_xyz (N,3) voxel coords; centers
    (N,3) voxel coords of each point's instance center; instance_valid (N,)
    bool-ish. Rows weigh ``instance_valid`` (times ``row_mask``), so rows
    with no instance (centers -1) and padding rows add nothing. Returns
    (norm_loss, dir_loss)."""
    gt = (centers.to(torch.float32) - coords_xyz.to(torch.float32)) * voxel_size
    valid = instance_valid.to(torch.float32)
    if row_mask is not None:
        valid = valid * row_mask.to(torch.float32)
    denom = valid.sum() + 1e-6

    pt = pt_offsets.to(torch.float32)
    norm_loss = ((pt - gt).abs().sum(-1) * valid).sum() / denom

    gt_dir = gt / (torch.linalg.vector_norm(gt, dim=-1, keepdim=True) + 1e-8)
    pt_dir = pt / (torch.linalg.vector_norm(pt, dim=-1, keepdim=True) + 1e-8)
    dir_loss = ((-(gt_dir * pt_dir).sum(-1)) * valid).sum() / denom
    return norm_loss, dir_loss
