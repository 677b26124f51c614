"""PointNet++ set-abstraction / feature-propagation modules.

Counterpart of ``languagegroundedsemseg_tpu/models/pointnet2.py``, the
reference's pointnet2 module wrappers (reference
lib/ext/pointnet2/pointnet2_modules.py:1-518): SA = FPS centroids +
ball-query grouping + shared MLP + max pool; FP = 3-NN inverse-distance
interpolation + MLP. Built on ``ops/points.py`` with fixed shapes and
padding masks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from languagegroundedsemseg_torch.models.layers import dense, linear
from languagegroundedsemseg_torch.ops.points import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    three_interpolate,
    three_nn,
)


class SharedMLP(nn.Module):
    """Per-point MLP (1x1 convs in the torch original): ``mlp{i}`` linear
    layers computing in ``dtype``, each followed by a relu."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 device="cuda", generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.n = len(channels)
        self.dtype = dtype
        for i, c in enumerate(channels):
            setattr(self, f"mlp{i}", linear(in_channels, c, device=device,
                                            generator=generator))
            in_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = torch.relu(dense(getattr(self, f"mlp{i}"), x, self.dtype))
        return x


class SetAbstraction(nn.Module):
    """FPS -> ball query -> grouping -> shared MLP (``mlp``) -> max pool.
    ``in_channels``: the width of ``feats`` (0 for none).

    forward(xyz (N, 3), feats (N, C) or None, valid_mask (N,)) ->
    (new_xyz (npoint, 3), new_feats (npoint, mlp[-1]), new_mask (npoint,)).
    """

    def __init__(self, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], in_channels: int = 0, use_xyz: bool = True,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.use_xyz = use_xyz
        c_in = in_channels + (3 if use_xyz or in_channels == 0 else 0)
        self.mlp = SharedMLP(c_in, mlp, device=device, generator=generator,
                             dtype=dtype)

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor],
                valid_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        idx = furthest_point_sample(xyz, self.npoint, valid_mask)
        new_xyz = gather_points(xyz, idx)
        new_mask = (torch.ones(self.npoint, dtype=torch.bool, device=xyz.device)
                    if valid_mask is None
                    else valid_mask[idx.long()].to(torch.bool))
        nbr = ball_query(new_xyz, xyz, self.radius, self.nsample,
                         ref_mask=valid_mask)  # (npoint, nsample), -1 pad
        has = nbr >= 0
        safe = torch.clamp(nbr, min=0)
        grouped_xyz = group_points(xyz, safe) - new_xyz[:, None, :]
        if feats is None:
            g = grouped_xyz
        elif self.use_xyz:
            g = torch.cat([grouped_xyz, group_points(feats, safe)], dim=-1)
        else:
            g = group_points(feats, safe)
        g = self.mlp(g.to(self.dtype))
        g = torch.where(has[..., None], g,
                        torch.full((), float("-inf"), device=g.device))
        pooled = g.max(dim=1).values
        keep = (has.any(dim=1) & new_mask)[:, None]
        pooled = torch.where(keep, pooled, torch.zeros((), device=g.device))
        return new_xyz, pooled.to(self.dtype), new_mask


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance interpolation of the sparse set's features
    onto the dense set, concatenated with the dense set's own (when
    given), then the shared MLP (``mlp``). ``in_channels``: the width of
    the interpolated features plus the dense skip features."""

    def __init__(self, in_channels: int, mlp: Sequence[int], device="cuda",
                 generator: Optional[torch.Generator] = None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp = SharedMLP(in_channels, mlp, device=device, generator=generator,
                             dtype=dtype)

    def forward(self, xyz_dense: torch.Tensor, feats_dense: Optional[torch.Tensor],
                xyz_sparse: torch.Tensor, feats_sparse: torch.Tensor,
                sparse_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dist, idx = three_nn(xyz_dense, xyz_sparse, ref_mask=sparse_mask)
        interp = three_interpolate(feats_sparse, idx, dist)
        if feats_dense is not None:
            interp = torch.cat([interp, feats_dense], dim=-1)
        return self.mlp(interp.to(self.dtype))
