"""CLIP-space model variants for language-grounded pretraining.

Counterpart of ``languagegroundedsemseg_tpu/models/clip_models.py``
(reference models/clip_models.py):
- Res16UNet34CR (:95-188) / 34C_P: 34C whose block8 last relu is
  stripped; under representation_only the classifier is skipped and raw
  features are the output (in the anchor space).
- Res16UNet34CR_Proj (:192-200): also learns a 512 -> PLANES[7]
  projection (``projection_layer``) applied to the anchor features.
- Res16UNet34D (:205-215): CLIP-dimensional variant, PLANES[-1] = 512, the
  model of the reference's language-grounded pretraining
  (scripts/text_representation_train.sh).
- Res16UNet34DPaired (:219-319): one 34D ``backbone`` called on two views
  (SimSiam).
- Res16UNet34Dv2 / Dv3 (:408-437): deeper classifier heads.
- Res16UNet34GloVe (:10-91): the GloVe-dimensional (100) 34C100.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from languagegroundedsemseg_torch.models.blocks import BasicBlock
from languagegroundedsemseg_torch.models.layers import (
    SparseConv,
    SparseInstanceNorm,
    dense,
    linear,
)
from languagegroundedsemseg_torch.models.res16unet import (
    Res16UNet34C,
    Res16UNet34C100,
    Res16UNetBase,
)
from languagegroundedsemseg_torch.sparse.graph_host import map_volume
from languagegroundedsemseg_torch.sparse.types import ConvGraph


class Res16UNet34CR(Res16UNet34C):
    STRIP_FINAL_RELU: bool = True


class Res16UNet34C_P(Res16UNet34C):
    STRIP_FINAL_RELU: bool = True


class Res16UNet34D(Res16UNet34CR):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 256, 256, 256, 512)


class Res16UNet34GloVe(Res16UNet34C100):
    pass


class Res16UNet34CR_Proj(Res16UNet34CR):
    """Called with ``anchors`` (C, 512), returns ((logits_or_features,
    features), projected anchors (C, PLANES[7])); without, what 34CR
    returns."""

    ANCHOR_DIM: int = 512

    def __init__(self, *args, device="cuda",
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, device=device, generator=generator, **kwargs)
        self.projection_layer = linear(self.ANCHOR_DIM, self.PLANES[7],
                                       device=device, generator=generator)

    def forward(self, feats, graph, representation_only: bool = False,
                anchors: Optional[torch.Tensor] = None):
        out = super().forward(feats, graph, representation_only)
        if anchors is None:
            return out
        return out, dense(self.projection_layer, anchors, self.dtype)


class _PairedBackbone(Res16UNet34D):
    """34D without a classifier: the paired model runs it under
    representation_only only, so JAX's backbone never makes one."""

    def _make_head(self, *args):
        pass


class Res16UNet34DPaired(Res16UNetBase):
    """SimSiam dual forward with a shared backbone (reference :314-319):
    the 34D ``backbone`` runs on (feats, graph) and, when given, on
    (feats2, graph2), both under representation_only; returns the two
    feature fields (the first twice without a second view). ``dtype`` and
    ``remat`` are the backbone's."""

    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 256, 256, 256, 512)
    LAYERS: Tuple[int, ...] = (2, 3, 4, 6, 2, 2, 2, 2)
    STRIP_FINAL_RELU: bool = True

    def __init__(self, *args, **kwargs):
        torch.nn.Module.__init__(self)
        backbone = type("_PairedBackbone", (_PairedBackbone,),
                        {"PLANES": self.PLANES, "LAYERS": self.LAYERS})
        self.backbone = backbone(*args, **kwargs)

    def input_conv(self) -> SparseConv:
        return self.backbone.conv0p1s1

    def forward(self, feats, graph, representation_only: bool = True,
                feats2=None, graph2=None):
        z1 = self.backbone(feats, graph, representation_only=True)[0]
        if feats2 is None:
            return z1, z1
        return z1, self.backbone(feats2, graph2, representation_only=True)[0]


class Res16UNet34Dv2(Res16UNet34D):
    """Deeper head: 1x1 512 -> 1x1 512 -> instance norm -> relu -> 1x1
    classifier (reference :408-418)."""

    def _make_head(self, c, out_channels, spec, bn_momentum, device, generator):
        def pw(ci, co):
            return SparseConv(ci, co, None, use_bias=True, device=device,
                              generator=generator, dtype=self.dtype)

        self.final_conv1 = pw(c, 512)
        self.final_conv2 = pw(512, 512)
        self.final_in = SparseInstanceNorm(512, max_batch=self.max_batch,
                                           device=device, dtype=self.dtype)
        self.final_out = pw(512, out_channels)

    def final_head(self, features: torch.Tensor, graph: ConvGraph,
                   batch_idx0, mask0) -> torch.Tensor:
        if batch_idx0 is None:
            batch_idx0 = graph.levels[0].batch_idx
        h = self.final_conv2(self.final_conv1(features, graph), graph)
        h = torch.relu(self.final_in(h, batch_idx0, mask0))
        return self.final_out(h, graph)


class Res16UNet34Dv3(Res16UNet34D):
    """Deeper still: a residual block with instance norms on the L0 k3 map
    (``final_block``), instance norm, relu, then the v2 stack (reference
    :422-437)."""

    def _make_head(self, c, out_channels, spec, bn_momentum, device, generator):
        def pw(ci, co):
            return SparseConv(ci, co, None, use_bias=True, device=device,
                              generator=generator, dtype=self.dtype)

        def inorm(ch):
            return SparseInstanceNorm(ch, max_batch=self.max_batch, device=device,
                                      dtype=self.dtype)

        self.final_block = BasicBlock(
            c, self.PLANES[7], "l0.k3", map_volume(spec, "l0.k3"), bn_momentum,
            device=device, generator=generator, norm_type="instance",
            max_batch=self.max_batch, dtype=self.dtype)
        self.final_in0 = inorm(self.PLANES[7])
        self.final_conv1 = pw(self.PLANES[7], 512)
        self.final_conv2 = pw(512, 512)
        self.final_in1 = inorm(512)
        self.final_out = pw(512, out_channels)

    def final_head(self, features: torch.Tensor, graph: ConvGraph,
                   batch_idx0, mask0) -> torch.Tensor:
        if batch_idx0 is None:
            batch_idx0 = graph.levels[0].batch_idx
        h = self.final_block(features, graph, mask0, batch_idx0)
        h = torch.relu(self.final_in0(h, batch_idx0, mask0))
        h = self.final_conv2(self.final_conv1(h, graph), graph)
        h = torch.relu(self.final_in1(h, batch_idx0, mask0))
        return self.final_out(h, graph)
