"""Plain sparse ResNet classifier family.

Counterpart of ``languagegroundedsemseg_tpu/models/resnet.py`` (reference
models/resnet.py:10-216): conv1 (conv1_kernel_size) -> norm -> relu ->
sum-pool (k2 s2) -> 4 stride-2 residual stages -> pointwise classifier at
stride 32. Variants ResNet14 / 18 / 34 / 50 / 101.

The maps carry no fusion annotation (``resnet_graph_spec``): the stride-1
k3 convs, the k3 and k1 stride-2 convs and the pool all run the flat
gather paths, so a ResNet reaches none of the hand-written kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from languagegroundedsemseg_torch.models.blocks import BLOCKS
from languagegroundedsemseg_torch.models.layers import Norm, SparseConv
from languagegroundedsemseg_torch.ops.spconv import sparse_sum_pool
from languagegroundedsemseg_torch.sparse.graph_host import GraphSpec, MapSpec
from languagegroundedsemseg_torch.sparse.offsets import ConvKind
from languagegroundedsemseg_torch.sparse.types import ConvGraph

NUM_LEVELS = 6  # strides 1, 2, 4, 8, 16, 32


def resnet_graph_spec(conv1_kernel_size: int = 3, d: int = 3) -> GraphSpec:
    maps = {}
    maps[f"l0.k{conv1_kernel_size}"] = MapSpec(0, 0, ConvKind(conv1_kernel_size))
    maps["down0"] = MapSpec(0, 1, ConvKind(2, stride=2))  # sum pool
    for e in range(4):
        lin, lout = e + 1, e + 2
        maps[f"down_k3_l{lin}"] = MapSpec(lin, lout, ConvKind(3, stride=2))
        maps[f"down_k1_l{lin}"] = MapSpec(lin, lout, ConvKind(1, stride=2))
        maps[f"l{lout}.k3"] = MapSpec(lout, lout, ConvKind(3))
    return GraphSpec(num_levels=NUM_LEVELS, maps=maps, d=d)


class StridedBlock(nn.Module):
    """First block of a ResNet stage, from level ``lvl_in`` to the next:
    basic: k3 s2 conv -> norm -> relu -> k3 conv -> norm; bottleneck: 1x1
    (norm at the input level) -> k3 s2 -> 1x1 (x expansion); plus a k1 s2
    conv + norm shortcut (``downsample.0`` / ``downsample.1``)."""

    def __init__(self, in_channels: int, planes: int, lvl_in: int,
                 block: str = "basic", bn_momentum: float = 0.02,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 norm_type: str = "batch", max_batch: int = 32):
        super().__init__()
        self.lvl_in, self.block = lvl_in, block
        exp = BLOCKS[block].expansion
        lout = lvl_in + 1

        def conv(ci, co, map_name=None, k=1):
            return SparseConv(ci, co, map_name, k, device=device,
                              generator=generator)

        def norm(c):
            return Norm(c, bn_momentum, device=device, norm_type=norm_type,
                        max_batch=max_batch)

        if block == "basic":
            self.conv1 = conv(in_channels, planes, f"down_k3_l{lvl_in}", 27)
            self.norm1 = norm(planes)
            self.conv2 = conv(planes, planes, f"l{lout}.k3", 27)
            self.norm2 = norm(planes)
        else:
            self.conv1 = conv(in_channels, planes)
            self.norm1 = norm(planes)
            self.conv2 = conv(planes, planes, f"down_k3_l{lvl_in}", 27)
            self.norm2 = norm(planes)
            self.conv3 = conv(planes, planes * exp)
            self.norm3 = norm(planes * exp)
        self.downsample = nn.ModuleList([
            conv(in_channels, planes * exp, f"down_k1_l{lvl_in}", 1),
            norm(planes * exp)])

    def forward(self, x, graph: ConvGraph, masks, bidx) -> torch.Tensor:
        lin, lout = self.lvl_in, self.lvl_in + 1
        m, b = masks[lout], bidx[lout]
        if self.block == "basic":
            out = torch.relu(self.norm1(self.conv1(x, graph), m, b))
            out = self.norm2(self.conv2(out, graph), m, b)
        else:
            out = torch.relu(self.norm1(self.conv1(x, graph), masks[lin], bidx[lin]))
            out = torch.relu(self.norm2(self.conv2(out, graph), m, b))
            out = self.norm3(self.conv3(out, graph), m, b)
        conv, norm = self.downsample
        return torch.relu(out + norm(conv(x, graph), m, b))


class ResNetBase(nn.Module):
    BLOCK: str = "basic"
    LAYERS: Tuple[int, ...] = (1, 1, 1, 1)
    PLANES: Tuple[int, ...] = (64, 128, 256, 512)
    INIT_DIM: int = 64
    NORM_TYPE: str = "batch"
    classifier_trainable_prefixes: Tuple[str, ...] = ("final",)

    @classmethod
    def graph_spec(cls, conv1_kernel_size: int = 3, d: int = 3) -> GraphSpec:
        return resnet_graph_spec(conv1_kernel_size, d)

    def __init__(self, in_channels: int = 3, out_channels: int = 20,
                 conv1_kernel_size: int = 3, bn_momentum: float = 0.02,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 norm_type: Optional[str] = None, max_batch: int = 32):
        super().__init__()
        self.norm_type = norm_type or self.NORM_TYPE
        block_cls = BLOCKS[self.BLOCK]
        exp = block_cls.expansion
        mk = dict(bn_momentum=bn_momentum, device=device, generator=generator,
                  norm_type=self.norm_type, max_batch=max_batch)
        self.conv1 = SparseConv(in_channels, self.INIT_DIM,
                                f"l0.k{conv1_kernel_size}", conv1_kernel_size ** 3,
                                device=device, generator=generator)
        self.bn1 = Norm(self.INIT_DIM, bn_momentum, device=device,
                        norm_type=self.norm_type, max_batch=max_batch)
        c = self.INIT_DIM
        for s in range(4):
            lvl, planes = s + 2, self.PLANES[s]
            stage = [StridedBlock(c, planes, s + 1, self.BLOCK, **mk)]
            c = planes * exp
            for _ in range(1, self.LAYERS[s]):
                stage.append(block_cls(c, planes, f"l{lvl}.k3", 27, **mk))
            setattr(self, f"layer{s + 1}", nn.ModuleList(stage))
        self.final = SparseConv(c, out_channels, None, use_bias=True,
                                device=device, generator=generator)

    def input_conv(self) -> SparseConv:
        return self.conv1

    def forward(self, feats: torch.Tensor, graph: ConvGraph,
                representation_only: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, features), both at the stride-32 level (L5);
        ``representation_only`` is accepted and ignored, as in JAX."""
        masks = [graph.levels[l].mask() for l in range(NUM_LEVELS)]
        needs = self.norm_type != "batch" or self.BLOCK == "se_basic"
        bidx = [graph.levels[l].batch_idx if needs else None
                for l in range(NUM_LEVELS)]
        out = torch.relu(self.bn1(self.conv1(feats, graph), masks[0], bidx[0]))
        out = sparse_sum_pool(out, graph.maps["down0"].idx)  # L0 -> L1
        for s in range(4):
            lvl = s + 2
            first, *rest = getattr(self, f"layer{s + 1}")
            out = first(out, graph, masks, bidx)
            for blk in rest:
                out = blk(out, graph, masks[lvl], bidx[lvl])
        return self.final(out, graph), out


class ResNet14(ResNetBase):
    LAYERS: Tuple[int, ...] = (1, 1, 1, 1)


class ResNet18(ResNetBase):
    LAYERS: Tuple[int, ...] = (2, 2, 2, 2)


class ResNet34(ResNetBase):
    LAYERS: Tuple[int, ...] = (3, 4, 6, 3)


class ResNet50(ResNetBase):
    BLOCK: str = "bottleneck"
    LAYERS: Tuple[int, ...] = (3, 4, 6, 3)


class ResNet101(ResNetBase):
    BLOCK: str = "bottleneck"
    LAYERS: Tuple[int, ...] = (3, 4, 23, 3)
