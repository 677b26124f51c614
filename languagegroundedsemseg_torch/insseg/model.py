"""Res16UNet + per-voxel offset head for instance segmentation.

Counterpart of ``languagegroundedsemseg_tpu/insseg/model.py`` (:21-51),
the mirror of reference downstream/insseg/insseg_models/
insseg_res16unet.py:197-263: the offset head is 1x1 conv -> norm -> relu ->
1x1 conv to 3 dims, applied to the last decoder block's features; forward
returns (offsets, logits, features). The head's modules carry the JAX
names (``offsets_pre``, ``bntr_offset``, ``offsets``), so
``convert.state_dict_from_jax`` carries a JAX head across as it is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from languagegroundedsemseg_torch.models.layers import Norm, SparseConv
from languagegroundedsemseg_torch.models.res16unet import Res16UNet34C
from languagegroundedsemseg_torch.sparse.types import ConvGraph


class InstanceRes16UNet(Res16UNet34C):
    """Default insseg backbone (34C); swap PLANES/LAYERS via subclassing as
    with the semseg zoo."""

    def __init__(self, in_channels: int = 3, out_channels: int = 20,
                 conv1_kernel_size: int = 3, bn_momentum: float = 0.02,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__(in_channels, out_channels, conv1_kernel_size,
                         bn_momentum, device=device, generator=generator,
                         dtype=dtype)
        c = self.PLANES[-1]
        self.offsets_pre = SparseConv(c, c, None, use_bias=True, device=device,
                                      generator=generator, dtype=dtype)
        self.bntr_offset = Norm(c, bn_momentum, device=device, dtype=dtype)
        self.offsets = SparseConv(c, 3, None, use_bias=True, device=device,
                                  generator=generator, dtype=dtype)

    def forward(self, feats: torch.Tensor, graph: ConvGraph,
                representation_only: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(offsets (N, 3), logits (N, out_channels), features)."""
        logits, features = super().forward(feats, graph)
        h = self.offsets_pre(features, graph)
        h = torch.relu(self.bntr_offset(h, graph.levels[0].mask()))
        return self.offsets(h, graph), logits, features


class InstanceRes16UNet14A(InstanceRes16UNet):
    LAYERS: Tuple[int, ...] = (1, 1, 1, 1, 1, 1, 1, 1)
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 128, 128, 96, 96)
