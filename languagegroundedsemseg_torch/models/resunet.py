"""ResUNet (MinkUNet) family: the alternate 3-level UNet.

Counterpart of ``languagegroundedsemseg_tpu/models/resunet.py`` (reference
models/resunet.py:12-253): conv1(ks) @L0 -> block1 @L0 -> [k2s2 down ->
blocks] x3 (L1..L3) -> [k2s2 transpose up -> concat -> blocks] x3 -> head
(1x1 -> 512 -> norm -> relu -> 1x1 classifier). The Hyper variant (:270)
also upsamples the L2 and L1 decoder stages to L0 (``broadcast_from_level``,
ME's pooling transpose) and concatenates them for the head. It runs on the
first four levels of the Res16UNet graph.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from languagegroundedsemseg_torch.models.blocks import BLOCKS
from languagegroundedsemseg_torch.models.layers import Norm, SparseConv
from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec
from languagegroundedsemseg_torch.ops.onehot_conv import _abs_parent
from languagegroundedsemseg_torch.sparse.graph_host import GraphSpec, map_volume
from languagegroundedsemseg_torch.sparse.types import (
    ChildSumMap,
    ConvGraph,
    ParentMap,
)

NUM_LEVELS = 4  # strides 1, 2, 4, 8


def broadcast_from_level(x: torch.Tensor, graph: ConvGraph,
                         level: int) -> torch.Tensor:
    """Level-``level`` features copied to every L0 row under them, by
    chaining the k2s2 parent maps down the levels. An up map served
    through its companion down map's ChildSumMap (no gmap of its own)
    reads that partition's (parent, slot) of each finer row; guard rows
    are 0."""
    out = x
    for l in range(level, 0, -1):
        pm = graph.gmaps.get(f"up{l}")
        km = graph.maps.get(f"up{l}")
        cs = None
        if pm is None and km is not None and km.companion:
            cand = graph.gmaps.get(km.companion)
            if isinstance(cand, ChildSumMap):
                cs = cand
        if isinstance(pm, ParentMap):
            parent = pm.parent.long()
            valid = (pm.kslot < pm.num_slots)[:, None]
        elif cs is not None:
            parent = torch.clamp(_abs_parent(cs).long(), max=out.shape[0] - 1)
            valid = (cs.kslot.long() < cs.num_slots)[:, None]
        else:
            parent = km.idx.max(dim=0).values.long()
            valid = (parent >= 0)[:, None]
            parent = torch.clamp(parent, min=0)
        out = torch.where(valid, out[parent],
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


class MinkUNetBase(nn.Module):
    BLOCK: str = "basic"
    PLANES: Tuple[int, ...] = (64, 128, 256, 512, 256, 128, 128)
    LAYERS: Tuple[int, ...] = (2, 2, 2, 2, 2, 2)
    INIT_DIM: int = 64
    NORM_TYPE: str = "batch"
    HYPER: bool = False
    classifier_trainable_prefixes: Tuple[str, ...] = ("final",)

    @classmethod
    def graph_spec(cls, conv1_kernel_size: int = 3, d: int = 3) -> GraphSpec:
        # ResUNet uses the first 4 levels of the Res16UNet map set
        return res16unet_graph_spec(conv1_kernel_size, d)

    def __init__(self, in_channels: int = 3, out_channels: int = 20,
                 conv1_kernel_size: int = 3, bn_momentum: float = 0.02,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 norm_type: Optional[str] = None, max_batch: int = 32):
        super().__init__()
        P, L = self.PLANES, self.LAYERS
        self.norm_type = norm_type or self.NORM_TYPE
        spec = self.graph_spec(conv1_kernel_size)
        block_cls = BLOCKS[self.BLOCK]
        exp = block_cls.expansion

        def conv(ci, co, map_name=None):
            k = 1 if map_name is None else map_volume(spec, map_name)
            return SparseConv(ci, co, map_name, k, device=device,
                              generator=generator)

        def norm(c):
            return Norm(c, bn_momentum, device=device,
                        norm_type=self.norm_type, max_batch=max_batch)

        def blocks(n, ci, planes, lvl):
            out = []
            for _ in range(n):
                out.append(block_cls(
                    ci, planes, f"l{lvl}.k3", map_volume(spec, f"l{lvl}.k3"),
                    bn_momentum, device=device, generator=generator,
                    norm_type=self.norm_type, max_batch=max_batch))
                ci = planes * exp
            return nn.ModuleList(out)

        self.conv1p1s1 = conv(in_channels, self.INIT_DIM,
                              f"l0.k{conv1_kernel_size}")
        self.bn1 = norm(self.INIT_DIM)
        self.block1 = blocks(L[0], self.INIT_DIM, P[0], 0)
        c = P[0] * exp
        skip_c = [c]
        for e in range(3):
            setattr(self, f"conv{e + 2}p{1 << e}s2", conv(c, c, f"down{e}"))
            setattr(self, f"bn{e + 2}", norm(c))
            setattr(self, f"block{e + 2}", blocks(L[e + 1], c, P[e + 1], e + 1))
            c = P[e + 1] * exp
            skip_c.append(c)
        hyper_c = 0
        for d in range(3):
            lvl = 3 - d
            planes = P[4 + d] if 4 + d < len(P) else P[-1]
            n = L[4 + d] if 4 + d < len(L) else 1
            setattr(self, f"convtr{4 + d}p{1 << lvl}s2",
                    conv(c, P[4 + d], f"up{lvl}"))
            setattr(self, f"bntr{4 + d}", norm(P[4 + d]))
            setattr(self, f"block{5 + d}",
                    blocks(n, P[4 + d] + skip_c[2 - d], planes, lvl - 1))
            c = planes * exp
            if self.HYPER and lvl - 1 > 0:
                hyper_c += c
        self.final_conv = conv(c + hyper_c, 512)
        self.final_bn = norm(512)
        self.final_out = SparseConv(512, out_channels, None, use_bias=True,
                                    device=device, generator=generator)

    def input_conv(self) -> SparseConv:
        return self.conv1p1s1

    def forward(self, feats: torch.Tensor, graph: ConvGraph,
                representation_only: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, last decoder features (the Hyper concat for Hyper));
        ``representation_only`` is accepted and ignored, as in JAX."""
        masks = [graph.levels[l].mask() for l in range(NUM_LEVELS)]
        needs = self.norm_type != "batch" or self.BLOCK == "se_basic"
        bidx = [graph.levels[l].batch_idx if needs else None
                for l in range(NUM_LEVELS)]

        def norm_relu(mod, x, lvl):
            return torch.relu(mod(x, masks[lvl], bidx[lvl]))

        def run(stage, x, lvl):
            for blk in stage:
                x = blk(x, graph, masks[lvl], bidx[lvl])
            return x

        out = norm_relu(self.bn1, self.conv1p1s1(feats, graph), 0)
        out = run(self.block1, out, 0)
        skips = [out]
        for e in range(3):
            lvl = e + 1
            out = getattr(self, f"conv{e + 2}p{1 << e}s2")(out, graph)
            out = norm_relu(getattr(self, f"bn{e + 2}"), out, lvl)
            out = run(getattr(self, f"block{e + 2}"), out, lvl)
            skips.append(out)

        hyper_feats = []
        for d in range(3):
            lvl = 3 - d
            out = getattr(self, f"convtr{4 + d}p{1 << lvl}s2")(out, graph)
            out = norm_relu(getattr(self, f"bntr{4 + d}"), out, lvl - 1)
            out = torch.cat([out, skips[2 - d]], dim=-1)
            out = run(getattr(self, f"block{5 + d}"), out, lvl - 1)
            if self.HYPER and lvl - 1 > 0:
                hyper_feats.append(broadcast_from_level(out, graph, lvl - 1))
        if self.HYPER:
            out = torch.cat(hyper_feats + [out], dim=-1)

        h = norm_relu(self.final_bn, self.final_conv(out, graph), 0)
        return self.final_out(h, graph), out


class ResUNet14(MinkUNetBase):
    LAYERS: Tuple[int, ...] = (1, 1, 1, 1, 1, 1)


class ResUNet18(MinkUNetBase):
    LAYERS: Tuple[int, ...] = (2, 2, 2, 2, 2, 2)


class ResUNet18INBN(ResUNet18):
    NORM_TYPE: str = "instance_batch"


class ResUNet34(MinkUNetBase):
    LAYERS: Tuple[int, ...] = (3, 4, 6, 3, 2, 2)


class ResUNet50(MinkUNetBase):
    BLOCK: str = "bottleneck"
    LAYERS: Tuple[int, ...] = (3, 4, 6, 3, 2, 2)


class ResUNet101(MinkUNetBase):
    BLOCK: str = "bottleneck"
    LAYERS: Tuple[int, ...] = (3, 4, 23, 3, 2, 2)


class ResUNet14D(ResUNet14):
    PLANES: Tuple[int, ...] = (64, 128, 256, 512, 512, 512, 512)


class ResUNet18D(ResUNet18):
    PLANES: Tuple[int, ...] = (64, 128, 256, 512, 512, 512, 512)


class MinkUNetHyper(MinkUNetBase):
    HYPER: bool = True


class MinkUNetHyper14INBN(MinkUNetHyper):
    LAYERS: Tuple[int, ...] = (1, 1, 1, 1, 1, 1)
    NORM_TYPE: str = "instance_batch"
