"""Residual blocks over sparse voxel grids.

Counterpart of ``languagegroundedsemseg_tpu/models/blocks.py`` (reference
models/modules/resnet_block.py BasicBlock :8-57, Bottleneck :72-119,
NoReluBlock :134-161, and senet_block.py): every conv is bound to a named
kernel map of the batch's ConvGraph, every norm is a ``Norm`` of the
block's ``norm_type``; every layer computes in the block's ``dtype``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from languagegroundedsemseg_torch.models.layers import Norm, SELayer, SparseConv
from languagegroundedsemseg_torch.sparse.types import ConvGraph


def _norm_factory(bn_momentum, device, norm_type, max_batch, dtype):
    return functools.partial(Norm, momentum=bn_momentum, device=device,
                             norm_type=norm_type, max_batch=max_batch,
                             dtype=dtype)


class BasicBlock(nn.Module):
    """conv3-norm-relu-conv3-norm + residual (+relu unless the caller
    passes final_relu=False, the NoReluBlock variant). A pointwise conv +
    norm (``downsample.0`` / ``downsample.1``) matches the residual's width
    when it differs from ``planes * expansion``."""

    expansion = 1

    def __init__(self, in_channels: int, planes: int, map_name: str,
                 kernel_volume: int = 27, bn_momentum: float = 0.02,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 norm_type: str = "batch", max_batch: int = 32,
                 dtype=torch.float32):
        super().__init__()
        norm = _norm_factory(bn_momentum, device, norm_type, max_batch, dtype)
        self.conv1 = SparseConv(in_channels, planes, map_name, kernel_volume,
                                device=device, generator=generator, dtype=dtype)
        self.norm1 = norm(planes)
        self.conv2 = SparseConv(planes, planes, map_name, kernel_volume,
                                device=device, generator=generator, dtype=dtype)
        self.norm2 = norm(planes)
        self._downsample(in_channels, planes, norm, device, generator, dtype)

    def _downsample(self, in_channels, planes, norm, device, generator, dtype):
        self.downsample = None
        c_out = planes * self.expansion
        if in_channels != c_out:
            self.downsample = nn.ModuleList([
                SparseConv(in_channels, c_out, None, device=device,
                           generator=generator, dtype=dtype),
                norm(c_out),
            ])

    def _body(self, x, graph, mask, batch_idx):
        out = torch.relu(self.norm1(self.conv1(x, graph), mask, batch_idx))
        return self.norm2(self.conv2(out, graph), mask, batch_idx)

    def forward(self, x: torch.Tensor, graph: ConvGraph, mask: torch.Tensor,
                batch_idx: Optional[torch.Tensor] = None,
                final_relu: bool = True) -> torch.Tensor:
        """``batch_idx`` (the level's scene id per row) is read by the
        instance norms and the SE gate only."""
        residual = x
        if self.downsample is not None:
            conv, norm = self.downsample
            residual = norm(conv(x, graph), mask, batch_idx)
        out = self._body(x, graph, mask, batch_idx) + residual
        return torch.relu(out) if final_relu else out


class Bottleneck(BasicBlock):
    """1x1 -> k3 -> 1x1 (x4) bottleneck residual block: ``conv1`` and
    ``conv3`` are pointwise, ``conv2`` runs on the block's k3 map."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int, map_name: str,
                 kernel_volume: int = 27, bn_momentum: float = 0.02,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 norm_type: str = "batch", max_batch: int = 32,
                 dtype=torch.float32):
        nn.Module.__init__(self)
        norm = _norm_factory(bn_momentum, device, norm_type, max_batch, dtype)
        self.conv1 = SparseConv(in_channels, planes, None, device=device,
                                generator=generator, dtype=dtype)
        self.norm1 = norm(planes)
        self.conv2 = SparseConv(planes, planes, map_name, kernel_volume,
                                device=device, generator=generator, dtype=dtype)
        self.norm2 = norm(planes)
        self.conv3 = SparseConv(planes, planes * self.expansion, None,
                                device=device, generator=generator, dtype=dtype)
        self.norm3 = norm(planes * self.expansion)
        self._downsample(in_channels, planes, norm, device, generator, dtype)

    def _body(self, x, graph, mask, batch_idx):
        out = torch.relu(self.norm1(self.conv1(x, graph), mask, batch_idx))
        out = torch.relu(self.norm2(self.conv2(out, graph), mask, batch_idx))
        return self.norm3(self.conv3(out, graph), mask, batch_idx)


class SEBasicBlock(BasicBlock):
    """BasicBlock + a squeeze-excitation gate (``se``) on the body's output
    before the residual add (reference models/modules/senet_block.py:26-76)."""

    def __init__(self, in_channels: int, planes: int, map_name: str,
                 kernel_volume: int = 27, bn_momentum: float = 0.02,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 norm_type: str = "batch", max_batch: int = 32,
                 dtype=torch.float32, reduction: int = 16):
        super().__init__(in_channels, planes, map_name, kernel_volume,
                         bn_momentum, device, generator, norm_type, max_batch,
                         dtype)
        self.se = SELayer(planes, reduction, max_batch, device=device,
                          generator=generator, dtype=dtype)

    def _body(self, x, graph, mask, batch_idx):
        return self.se(super()._body(x, graph, mask, batch_idx), batch_idx, mask)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck, "se_basic": SEBasicBlock}
