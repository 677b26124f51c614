"""Residual blocks over sparse voxel grids.

Counterpart of ``languagegroundedsemseg_tpu/models/blocks.py``: the
``BasicBlock`` Res16UNet34C is built from. ``Bottleneck`` and
``SEBasicBlock`` come with the rest of the model zoo.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from languagegroundedsemseg_torch.models.layers import Norm, SparseConv
from languagegroundedsemseg_torch.sparse.types import ConvGraph


class BasicBlock(nn.Module):
    """conv3-norm-relu-conv3-norm + residual (+relu unless the caller
    passes final_relu=False, the NoReluBlock variant). A pointwise conv +
    norm (``downsample.0`` / ``downsample.1``) matches the residual's width
    when it differs from ``planes``."""

    expansion = 1

    def __init__(self, in_channels: int, planes: int, map_name: str,
                 kernel_volume: int = 27, bn_momentum: float = 0.02,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()

        def norm():
            return Norm(planes, bn_momentum, device=device)

        self.conv1 = SparseConv(in_channels, planes, map_name, kernel_volume,
                                device=device, generator=generator)
        self.norm1 = norm()
        self.conv2 = SparseConv(planes, planes, map_name, kernel_volume,
                                device=device, generator=generator)
        self.norm2 = norm()
        self.downsample = None
        if in_channels != planes * self.expansion:
            self.downsample = nn.ModuleList([
                SparseConv(in_channels, planes * self.expansion, None,
                           device=device, generator=generator),
                norm(),
            ])

    def forward(self, x: torch.Tensor, graph: ConvGraph, mask: torch.Tensor,
                final_relu: bool = True) -> torch.Tensor:
        residual = x
        out = torch.relu(self.norm1(self.conv1(x, graph), mask))
        out = self.norm2(self.conv2(out, graph), mask)
        if self.downsample is not None:
            conv, norm = self.downsample
            residual = norm(conv(x, graph), mask)
        out = out + residual
        if final_relu:
            out = torch.relu(out)
        return out
