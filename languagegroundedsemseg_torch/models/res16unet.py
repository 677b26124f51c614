"""Res16UNet family: the BasicBlock variants.

Counterpart of ``languagegroundedsemseg_tpu/models/res16unet.py``: a 4-level
stride-2 sparse encoder and a 4-level transpose-conv decoder with skip
concatenations, every conv bound to a kernel map of the batch's ConvGraph.

  conv0(k3) -> bn -> relu                                     @ L0
  [conv k2 s2 -> bn -> relu -> blocks] x4                     @ L1..L4
  [convtr k2 s2 -> bn -> relu -> concat(skip) -> blocks] x4   @ L3..L0
  final: pointwise conv to out_channels (bias)

Module names follow the reference state_dict (``conv0p1s1.kernel``,
``bn0.bn.weight``, ``block1.0.conv1.kernel``, ``final.bias``), so
``convert.state_dict_from_jax`` maps the JAX package's trees onto it one to
one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from languagegroundedsemseg_torch.models.blocks import BasicBlock
from languagegroundedsemseg_torch.models.layers import Norm, SparseConv
from languagegroundedsemseg_torch.sparse.graph_host import GraphSpec, MapSpec
from languagegroundedsemseg_torch.sparse.offsets import ConvKind
from languagegroundedsemseg_torch.sparse.types import ConvGraph

NUM_LEVELS = 5  # strides 1, 2, 4, 8, 16


def res16unet_graph_spec(conv1_kernel_size: int = 3, d: int = 3) -> GraphSpec:
    """All kernel maps a Res16UNet needs (the reference's spec, :35-66).

    Every stride-1 k3 map gets the masked-shift fusion and, when the anchor
    spread admits one, a selector window annotation. The down maps'
    ChildSumMap partition serves both the down and the up convs, so their
    flat tables need not ship (keep_flat=False)."""
    maps = {}
    for l in range(NUM_LEVELS):
        maps[f"l{l}.k3"] = MapSpec(l, l, ConvKind(kernel_size=3), fuse_width=3)
    if conv1_kernel_size != 3:
        maps[f"l0.k{conv1_kernel_size}"] = MapSpec(
            0, 0, ConvKind(kernel_size=conv1_kernel_size))
    for l in range(NUM_LEVELS - 1):
        maps[f"down{l}"] = MapSpec(
            l, l + 1, ConvKind(kernel_size=2, stride=2), companion=f"up{l + 1}",
            keep_flat=False)
    for l in range(1, NUM_LEVELS):
        maps[f"up{l}"] = MapSpec(
            l, l - 1, ConvKind(kernel_size=2, stride=2, transpose=True),
            companion=f"down{l - 1}", keep_flat=False)
    return GraphSpec(num_levels=NUM_LEVELS, maps=maps, d=d)


class Res16UNetBase(nn.Module):
    """Configurable Res16UNet; subclasses pin PLANES / LAYERS like the
    reference variant zoo. Parameters are created on ``device`` (the card
    by default) from ``generator`` (a fresh default generator if None)."""

    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 256, 256, 256, 256)
    LAYERS: Tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2, 2)
    INIT_DIM: int = 32
    # parameter-name prefixes that stay trainable under --classifier_only
    # (reference set_classifier_mode, pl_BaselineTrainer.py:411)
    classifier_trainable_prefixes: Tuple[str, ...] = ("final",)
    # block8's last relu stripped in every mode (the CLIP variants'
    # NoReluBlock, models/clip_models.py); representation_only strips it
    # for any variant
    STRIP_FINAL_RELU: bool = False

    def __init__(self, in_channels: int = 3, out_channels: int = 20,
                 conv1_kernel_size: int = 3, bn_momentum: float = 0.02,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        P, L = self.PLANES, self.LAYERS
        ks0 = conv1_kernel_size

        def conv(ci, co, map_name, k):
            return SparseConv(ci, co, map_name, k, device=device,
                              generator=generator)

        def norm(c):
            return Norm(c, bn_momentum, device=device)

        def blocks(n, ci, planes, lvl):
            out = []
            for _ in range(n):
                out.append(BasicBlock(ci, planes, f"l{lvl}.k3", 27,
                                      bn_momentum, device=device,
                                      generator=generator))
                ci = planes
            return nn.ModuleList(out)

        self.conv0p1s1 = conv(in_channels, self.INIT_DIM, f"l0.k{ks0}", ks0 ** 3)
        self.bn0 = norm(self.INIT_DIM)
        c = self.INIT_DIM
        for e in range(4):
            lvl = e + 1
            setattr(self, f"conv{lvl}p{1 << e}s2", conv(c, c, f"down{e}", 8))
            setattr(self, f"bn{lvl}", norm(c))
            setattr(self, f"block{lvl}", blocks(L[e], c, P[e], lvl))
            c = P[e]
        skip_c = [P[2], P[1], P[0], self.INIT_DIM]
        for d in range(4):
            lvl = 4 - d
            setattr(self, f"convtr{4 + d}p{1 << lvl}s2",
                    conv(c, P[4 + d], f"up{lvl}", 8))
            setattr(self, f"bntr{4 + d}", norm(P[4 + d]))
            setattr(self, f"block{5 + d}",
                    blocks(L[4 + d], P[4 + d] + skip_c[d], P[4 + d], lvl - 1))
            c = P[4 + d]
        self.final = SparseConv(c, out_channels, None, use_bias=True,
                                device=device, generator=generator)

    def forward(self, feats: torch.Tensor, graph: ConvGraph,
                representation_only: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, last decoder features); with ``representation_only``
        the head is skipped and the features come back twice."""
        masks = [graph.levels[l].mask() for l in range(NUM_LEVELS)]

        out = self.conv0p1s1(feats, graph)
        out_p1 = torch.relu(self.bn0(out, masks[0]))

        skips = []
        out = out_p1
        for e in range(4):
            lvl = e + 1
            out = getattr(self, f"conv{lvl}p{1 << e}s2")(out, graph)
            out = torch.relu(getattr(self, f"bn{lvl}")(out, masks[lvl]))
            for blk in getattr(self, f"block{lvl}"):
                out = blk(out, graph, masks[lvl])
            skips.append(out)

        dec_skips = [skips[2], skips[1], skips[0], out_p1]
        for d in range(4):
            lvl = 4 - d
            out = getattr(self, f"convtr{4 + d}p{1 << lvl}s2")(out, graph)
            out = torch.relu(getattr(self, f"bntr{4 + d}")(out, masks[lvl - 1]))
            out = torch.cat([out, dec_skips[d]], dim=-1)
            stage = getattr(self, f"block{5 + d}")
            # representation output (and the CLIP variants): block8's last
            # relu is stripped so raw features live in the embedding space
            # (NoReluBlock)
            strip = d == 3 and (self.STRIP_FINAL_RELU or representation_only)
            for i, blk in enumerate(stage):
                out = blk(out, graph, masks[lvl - 1],
                          final_relu=not (strip and i == len(stage) - 1))

        features = out
        if representation_only:
            return features, features
        return self.final(features, graph), features


# The BasicBlock variants of the reference zoo (JAX
# models/res16unet.py:241-252, 263-321). Res16UNet50 / 101 (Bottleneck) and
# the ST variants (d=4) come with the rest of the model zoo.


class Res16UNet14(Res16UNetBase):
    LAYERS: Tuple[int, ...] = (1, 1, 1, 1, 1, 1, 1, 1)


class Res16UNet18(Res16UNetBase):
    LAYERS: Tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2, 2)


class Res16UNet34(Res16UNetBase):
    LAYERS: Tuple[int, ...] = (2, 3, 4, 6, 2, 2, 2, 2)


class Res16UNet14A(Res16UNet14):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 128, 128, 96, 96)


class Res16UNet14A2(Res16UNet14A):
    LAYERS: Tuple[int, ...] = (1, 1, 1, 1, 2, 2, 2, 2)


class Res16UNet14B(Res16UNet14):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 128, 128, 128, 128)


class Res16UNet14B2(Res16UNet14B):
    LAYERS: Tuple[int, ...] = (1, 1, 1, 1, 2, 2, 2, 2)


class Res16UNet14B3(Res16UNet14B):
    LAYERS: Tuple[int, ...] = (2, 2, 2, 2, 1, 1, 1, 1)


class Res16UNet14C(Res16UNet14):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 192, 192, 128, 128)


class Res16UNet14D(Res16UNet14):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 384, 384, 384, 384)


class Res16UNet18A(Res16UNet18):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 128, 128, 96, 96)


class Res16UNet18B(Res16UNet18):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 128, 128, 128, 128)


class Res16UNet18D(Res16UNet18):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 384, 384, 384, 384)


class Res16UNet34A(Res16UNet34):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 256, 128, 64, 64)


class Res16UNet34B(Res16UNet34):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 256, 128, 64, 32)


class Res16UNet34C(Res16UNet34):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 256, 128, 96, 96)


class Res16UNet34C200(Res16UNet34):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 256, 128, 96, 200)


class Res16UNet34C100(Res16UNet34):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 256, 128, 128, 100)
