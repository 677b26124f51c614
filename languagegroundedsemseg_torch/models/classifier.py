"""Classifier and projection models.

Counterpart of ``languagegroundedsemseg_tpu/models/classifier.py``:
- ClassifierNet: one linear layer (``classifier``) over precomputed
  features (reference models/classifier_models.py:4-17), the model of the
  classifier fine-tuning trainer.
- AttributeFittingModel: 8 per-attribute linear maps 512 -> 512 (``maps``,
  (A, D, D), applied as x @ maps[a]), pretrained offline and used for
  latent instance augmentation (reference models/projection_models.py:4-19).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.models.layers import linear


class ClassifierNet(nn.Module):
    """(N, D) features -> ((N, out_channels) logits, the features). The
    graph and mode arguments are accepted for the trainers' call shape."""

    def __init__(self, in_channels: int = 512, out_channels: int = 200,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.classifier = linear(in_channels, out_channels, device=device,
                                 generator=generator)

    def forward(self, feats: torch.Tensor, graph=None,
                representation_only: bool = False):
        return self.classifier(feats.to(torch.float32)), feats


class AttributeFittingModel(nn.Module):
    """(N, D) -> (N, A, D): each attribute's linear projection."""

    def __init__(self, feature_dim: int = 512, num_attributes: int = 8,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        w = 0.02 * torch.randn((num_attributes, feature_dim, feature_dim),
                               generator=generator)
        self.maps = nn.Parameter(w.to(resolve_device(device)))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return torch.einsum("nd,ade->nae", feats.to(torch.float32), self.maps)
