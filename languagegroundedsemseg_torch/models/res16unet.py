"""Res16UNet family: the workhorse backbone and its spatio-temporal variants.

Counterpart of ``languagegroundedsemseg_tpu/models/res16unet.py``: a 4-level
stride-2 sparse encoder and a 4-level transpose-conv decoder with skip
concatenations, every conv bound to a kernel map of the batch's ConvGraph.

  conv0(k3) -> norm -> relu                                     @ L0
  [conv k2 s2 -> norm -> relu -> blocks] x4                     @ L1..L4
  [convtr k2 s2 -> norm -> relu -> concat(skip) -> blocks] x4   @ L3..L0
  final_head: pointwise conv to out_channels (bias)

``BLOCK`` picks the residual block ('basic', 'bottleneck' with expansion
4, 'se_basic'); a block's output is ``planes * expansion`` wide, and the
down convs, the skips and the head take those widths. ``NORM_TYPE`` is
the norm of every layer ('batch', 'instance', 'instance_batch').

Module names follow the reference state_dict (``conv0p1s1.kernel``,
``bn0.bn.weight``, ``block1.0.conv1.kernel``, ``final.bias``), so
``convert.state_dict_from_jax`` maps the JAX package's trees onto it one to
one.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from languagegroundedsemseg_torch.models.blocks import BLOCKS
from languagegroundedsemseg_torch.models.layers import Norm, SparseConv, recomputing
from languagegroundedsemseg_torch.sparse.graph_host import (
    GraphSpec,
    MapSpec,
    map_volume,
)
from languagegroundedsemseg_torch.sparse.offsets import ConvKind, KernelRegion
from languagegroundedsemseg_torch.sparse.types import ConvGraph
from languagegroundedsemseg_torch.utils.observability import span

NUM_LEVELS = 5  # strides 1, 2, 4, 8, 16
_ENC_SPANS = tuple(f"lgs.model.enc{e}" for e in range(1, 5))
_DEC_SPANS = tuple(f"lgs.model.dec{d}" for d in range(1, 5))


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


def _remat_contexts():
    """``checkpoint``'s (forward, recompute) contexts: the recompute leaves
    the running statistics alone."""
    return contextlib.nullcontext(), recomputing()


class Res16UNetBase(nn.Module):
    """Configurable Res16UNet; subclasses pin BLOCK / PLANES / LAYERS /
    NORM_TYPE like the reference variant zoo. Parameters are created on
    ``device`` (the card by default) from ``generator`` (a fresh default
    generator if None). ``max_batch`` bounds the scenes a batch holds (the
    instance norms' and SE gates' segment count)."""

    BLOCK: str = "basic"
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 256, 256, 256, 256)
    LAYERS: Tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2, 2)
    INIT_DIM: int = 32
    NORM_TYPE: str = "batch"
    # parameter-name prefixes that stay trainable under --classifier_only
    # (reference set_classifier_mode, pl_BaselineTrainer.py:411); every
    # head module, the deeper Dv2 / Dv3 heads included, is named final*
    classifier_trainable_prefixes: Tuple[str, ...] = ("final",)
    # block8's last relu stripped in every mode (the CLIP variants'
    # NoReluBlock, models/clip_models.py); representation_only strips it
    # for any variant
    STRIP_FINAL_RELU: bool = False

    @classmethod
    def graph_spec(cls, conv1_kernel_size: int = 3, d: int = 3) -> GraphSpec:
        return res16unet_graph_spec(conv1_kernel_size, d)

    def __init__(self, in_channels: int = 3, out_channels: int = 20,
                 conv1_kernel_size: int = 3, bn_momentum: float = 0.02,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 norm_type: Optional[str] = None, max_batch: int = 32,
                 dtype=torch.float32, remat: bool = False):
        super().__init__()
        P, L = self.PLANES, self.LAYERS
        self.norm_type = norm_type or self.NORM_TYPE
        self.max_batch = max_batch
        self.dtype, self.remat = dtype, remat
        spec = self.graph_spec(conv1_kernel_size)
        block_cls = BLOCKS[self.BLOCK]
        exp = block_cls.expansion
        # the scene id per row is read by instance norms and SE gates only
        self._needs_batch_idx = (self.norm_type != "batch"
                                 or self.BLOCK == "se_basic")

        def conv(ci, co, map_name):
            return SparseConv(ci, co, map_name, map_volume(spec, map_name),
                              device=device, generator=generator, dtype=dtype)

        def norm(c):
            return Norm(c, bn_momentum, device=device,
                        norm_type=self.norm_type, max_batch=max_batch,
                        dtype=dtype)

        def blocks(n, ci, planes, lvl):
            out = []
            for _ in range(n):
                out.append(block_cls(
                    ci, planes, f"l{lvl}.k3", map_volume(spec, f"l{lvl}.k3"),
                    bn_momentum, device=device, generator=generator,
                    norm_type=self.norm_type, max_batch=max_batch, dtype=dtype))
                ci = planes * exp
            return nn.ModuleList(out)

        self.conv0p1s1 = conv(in_channels, self.INIT_DIM,
                              f"l0.k{conv1_kernel_size}")
        self.bn0 = norm(self.INIT_DIM)
        c = self.INIT_DIM
        for e in range(4):
            lvl = e + 1
            setattr(self, f"conv{lvl}p{1 << e}s2", conv(c, c, f"down{e}"))
            setattr(self, f"bn{lvl}", norm(c))
            setattr(self, f"block{lvl}", blocks(L[e], c, P[e], lvl))
            c = P[e] * exp
        skip_c = [P[2] * exp, P[1] * exp, P[0] * exp, self.INIT_DIM]
        for d in range(4):
            lvl = 4 - d
            setattr(self, f"convtr{4 + d}p{1 << lvl}s2",
                    conv(c, P[4 + d], f"up{lvl}"))
            setattr(self, f"bntr{4 + d}", norm(P[4 + d]))
            setattr(self, f"block{5 + d}",
                    blocks(L[4 + d], P[4 + d] + skip_c[d], P[4 + d], lvl - 1))
            c = P[4 + d] * exp
        self._make_head(c, out_channels, spec, bn_momentum, device, generator)

    def _make_head(self, c, out_channels, spec, bn_momentum, device, generator):
        """The classifier (reference models/res16unet.py:193): a pointwise
        conv with bias. CLIP variants make deeper heads, every module named
        final*."""
        self.final = SparseConv(c, out_channels, None, use_bias=True,
                                device=device, generator=generator,
                                dtype=self.dtype)

    def input_conv(self) -> SparseConv:
        """The conv that takes the input features (no dX in a train step)."""
        return self.conv0p1s1

    def final_head(self, features: torch.Tensor, graph: ConvGraph,
                   batch_idx0, mask0) -> torch.Tensor:
        return self.final(features, graph)

    def stage_blocks(self):
        """The residual blocks of the eight stages (the ones ``remat``
        checkpoints), in order."""
        return [blk for s in range(1, 9) for blk in getattr(self, f"block{s}")]

    def _block(self, blk, *args, **kwargs):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False,
                              context_fn=_remat_contexts, **kwargs)
        return blk(*args, **kwargs)

    def forward(self, feats: torch.Tensor, graph: ConvGraph,
                representation_only: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, last decoder features); with ``representation_only``
        the head is skipped and the features come back twice. Each stage
        runs under its span: ``lgs.model.stem``, ``.enc1``-``.enc4``,
        ``.dec1``-``.dec4``, ``.head``."""

        def norm_relu(mod, x, lvl):
            return torch.relu(mod(x, masks[lvl], bidx[lvl]))

        with span("lgs.model.stem"):
            masks = [graph.levels[l].mask() for l in range(NUM_LEVELS)]
            bidx = [graph.levels[l].batch_idx if self._needs_batch_idx else None
                    for l in range(NUM_LEVELS)]
            out = self.conv0p1s1(feats, graph)
            out_p1 = norm_relu(self.bn0, out, 0)

        skips = []
        out = out_p1
        for e in range(4):
            lvl = e + 1
            with span(_ENC_SPANS[e]):
                out = getattr(self, f"conv{lvl}p{1 << e}s2")(out, graph)
                out = norm_relu(getattr(self, f"bn{lvl}"), out, lvl)
                for blk in getattr(self, f"block{lvl}"):
                    out = self._block(blk, out, graph, masks[lvl], bidx[lvl])
            skips.append(out)

        dec_skips = [skips[2], skips[1], skips[0], out_p1]
        for d in range(4):
            lvl = 4 - d
            with span(_DEC_SPANS[d]):
                out = getattr(self, f"convtr{4 + d}p{1 << lvl}s2")(out, graph)
                out = norm_relu(getattr(self, f"bntr{4 + d}"), out, lvl - 1)
                out = torch.cat([out, dec_skips[d]], dim=-1)
                stage = getattr(self, f"block{5 + d}")
                # representation output (and the CLIP variants): block8's
                # last relu is stripped so raw features live in the
                # embedding space (NoReluBlock)
                strip = d == 3 and (self.STRIP_FINAL_RELU or representation_only)
                for i, blk in enumerate(stage):
                    out = self._block(blk, out, graph, masks[lvl - 1], bidx[lvl - 1],
                                      final_relu=not (strip and i == len(stage) - 1))

        features = out
        if representation_only:
            return features, features
        with span("lgs.model.head"):
            return self.final_head(features, graph, bidx[0], masks[0]), features


# ---- Variant zoo (reference models/res16unet.py:273-355) -------------------


class Res16UNet14(Res16UNetBase):
    LAYERS: Tuple[int, ...] = (1, 1, 1, 1, 1, 1, 1, 1)


class Res16UNet18(Res16UNetBase):
    LAYERS: Tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2, 2)


class Res16UNet34(Res16UNetBase):
    LAYERS: Tuple[int, ...] = (2, 3, 4, 6, 2, 2, 2, 2)


class Res16UNet50(Res16UNetBase):
    BLOCK: str = "bottleneck"
    LAYERS: Tuple[int, ...] = (2, 3, 4, 6, 2, 2, 2, 2)


class Res16UNet101(Res16UNetBase):
    BLOCK: str = "bottleneck"
    LAYERS: Tuple[int, ...] = (2, 3, 4, 23, 2, 2, 2, 2)


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


# ---- Spatio-temporal variants (reference models/res16unet.py:356-396) ------


def _st_res16unet_spec(block: ConvKind, conv1_kernel_size: int,
                       conv1: ConvKind) -> GraphSpec:
    """The 4D maps: ``block`` for the k3 maps, ``conv1`` for a first conv
    of another size than 3 (else it runs on l0.k3), spatial-only k2 s2
    down / up maps."""
    maps = {}
    for l in range(NUM_LEVELS):
        maps[f"l{l}.k3"] = MapSpec(l, l, block)
    if conv1_kernel_size != 3:
        maps[f"l0.k{conv1_kernel_size}"] = MapSpec(0, 0, conv1)
    for l in range(NUM_LEVELS - 1):
        maps[f"down{l}"] = MapSpec(
            l, l + 1, ConvKind(kernel_size=(2, 2, 2, 1), stride=2),
            companion=f"up{l + 1}")
    for l in range(1, NUM_LEVELS):
        maps[f"up{l}"] = MapSpec(
            l, l - 1, ConvKind(kernel_size=(2, 2, 2, 1), stride=2, transpose=True),
            companion=f"down{l - 1}")
    return GraphSpec(num_levels=NUM_LEVELS, maps=maps, d=4)


def st_res16unet_graph_spec(conv1_kernel_size: int = 3) -> GraphSpec:
    """4D spatio-temporal maps: spatial-cube x temporal-cross block kernels
    (29 slots), spatial-only striding (reference ConvType
    SPATIAL_HYPERCUBE_TEMPORAL_HYPERCROSS, models/modules/common.py:110-174).
    The k3 maps carry no fusion annotation, so the block convs run the
    flat gather paths; the down / up convs ride the down maps' child-sum
    partition, which runs the csum kernel where it is windowed."""
    ks = conv1_kernel_size
    return _st_res16unet_spec(
        ConvKind(kernel_size=3, region=KernelRegion.SPATIAL_CUBE_TEMPORAL_CROSS),
        ks, ConvKind(kernel_size=(ks,) * 3 + (1,)))


class STRes16UNetBase(Res16UNetBase):
    """Spatio-temporal Res16UNet (D=4): the module is Res16UNet's, the
    geometry lives in the 4D ConvGraph."""

    @classmethod
    def graph_spec(cls, conv1_kernel_size: int = 3, d: int = 4) -> GraphSpec:
        return st_res16unet_graph_spec(conv1_kernel_size)


# The JAX package declares STRes16UNet14 / 18 / 34 / 50 / 101 as
# (STRes16UNetBase, Res16UNetXX) and STResTesseract16UNet18A as
# (STResTesseract16UNetBase, STRes16UNet18A). Its flax dataclass fields
# resolve those diamonds to STRes16UNetBase's defaults, so its instances
# have the base PLANES / LAYERS / BLOCK whatever the second parent says
# (ROADMAP Queue 3). These classes carry the values JAX's instances have.


class STRes16UNet14(STRes16UNetBase):
    pass


class STRes16UNet14A(STRes16UNetBase):
    LAYERS: Tuple[int, ...] = (1, 1, 1, 1, 1, 1, 1, 1)
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 128, 128, 96, 96)


class STRes16UNet18(STRes16UNetBase):
    pass


class STRes16UNet34(STRes16UNetBase):
    pass


class STRes16UNet50(STRes16UNetBase):
    pass


class STRes16UNet101(STRes16UNetBase):
    pass


class STRes16UNet18A(STRes16UNetBase):
    LAYERS: Tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2, 2)
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 128, 128, 96, 96)


class STResTesseract16UNetBase(STRes16UNetBase):
    """Full 4D hypercube block kernels (81 slots)."""

    @classmethod
    def graph_spec(cls, conv1_kernel_size: int = 3, d: int = 4) -> GraphSpec:
        ks = conv1_kernel_size
        return _st_res16unet_spec(ConvKind(kernel_size=3), ks, ConvKind(kernel_size=ks))


class STResTesseract16UNet18A(STResTesseract16UNetBase):
    pass
