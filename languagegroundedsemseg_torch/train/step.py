"""The eval step — the serving entry point — and the batch it consumes.

Counterpart of ``languagegroundedsemseg_tpu/train/step.py``: ``TrainBatch``
with its wire decompaction (:38-53) and ``make_eval_step`` (:113-131). The
train step comes with the backward kernels in a later slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import numpy as np
import torch

from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.sparse.types import ConvGraph


@dataclass
class TrainBatch:
    """One batch: padded per-voxel feats and labels plus the ConvGraph.
    Arrays are numpy on the host (``BatchBuilder.build_host``) or torch
    tensors after ``.to(device)``."""

    feats: Any
    labels: Any
    graph: ConvGraph
    extras: Dict[str, Any] = field(default_factory=dict)

    def replace(self, **changes) -> "TrainBatch":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "TrainBatch":
        dev = resolve_device(device)

        def move(a):
            if isinstance(a, np.ndarray):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return a.to(dev)

        return TrainBatch(
            feats=move(self.feats), labels=move(self.labels),
            graph=self.graph.to(dev),
            extras={k: move(v) for k, v in self.extras.items()},
        )

    def decompact(self) -> "TrainBatch":
        """Undo the wire compaction on tensors: uint8 feats -> colors
        normalized to [-0.5, 0.5] in f32, f16 feats -> f32, narrow labels
        -> int32."""
        b = self
        if b.feats.dtype == torch.uint8:
            b = b.replace(feats=b.feats.to(torch.float32) / 255.0 - 0.5)
        elif b.feats.dtype == torch.float16:
            b = b.replace(feats=b.feats.to(torch.float32))
        if b.labels.dtype != torch.int32:
            b = b.replace(labels=b.labels.to(torch.int32))
        return b


def make_eval_step(model, representation_only: bool = False,
                   device="cuda") -> Callable:
    """Build ``eval(batch) -> (logits_or_features, features)``.

    Moves ``model`` to ``device`` in eval mode (BatchNorm reads its running
    statistics) and runs the forward under ``torch.inference_mode()``. A
    host batch (numpy leaves) is moved to the device first; tensors already
    there are used as they are."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def step(batch: TrainBatch):
        with torch.inference_mode():
            batch = batch.to(dev).decompact()
            return model(batch.feats, batch.graph,
                         representation_only=representation_only)

    return step
