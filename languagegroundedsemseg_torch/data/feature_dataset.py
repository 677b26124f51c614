"""Per-epoch class-balanced feature dataset for classifier fine-tuning.

Counterpart of ``languagegroundedsemseg_tpu/data/feature_dataset.py``. The
reference's ClassifierTrainer calls ``train_dataset.resample_features()``
at every epoch start (reference lib/train_test/pl_ClassifierTrainer.py:120),
but its feature dataset class is absent from the reference repo; this is
the contract as the JAX package completed it:

- pools of precomputed frozen-model features grouped by label;
- a per-epoch redraw of ``samples_per_class`` features per class (without
  replacement while the pool lasts, with replacement for tail classes
  whose pool is smaller than the quota);
- fixed-size shuffled batches, the tail batch wrapping around.

``ResampledFeatureDataset`` is numpy only and draws what JAX's draws from
the same ``np.random.default_rng(seed)``. ``extract_features`` runs the
trainer's eval step over a loader once and reads each batch's valid rows
back with one copy.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch


class ResampledFeatureDataset:
    """Class-balanced, per-epoch-resampled (feature, label) dataset."""

    def __init__(
        self,
        feats: np.ndarray,
        labels: np.ndarray,
        samples_per_class: int = 256,
        num_classes: Optional[int] = None,
        seed: int = 0,
    ):
        if feats.ndim != 2 or labels.ndim != 1 or len(feats) != len(labels):
            raise ValueError(f"feats {feats.shape} and labels {labels.shape}: "
                             "want (N, D) and (N,)")
        self.feats = np.asarray(feats, np.float32)
        self.labels = np.asarray(labels, np.int64)
        self.num_classes = (
            int(num_classes) if num_classes is not None
            else int(self.labels.max(initial=0)) + 1
        )
        self.samples_per_class = int(samples_per_class)
        self._pools = [
            np.flatnonzero(self.labels == c) for c in range(self.num_classes)
        ]
        self._rng = np.random.default_rng(seed)
        self._epoch_idx: np.ndarray = np.zeros(0, np.int64)
        self.resample_features()

    @property
    def feature_dim(self) -> int:
        return self.feats.shape[1]

    def resample_features(self) -> None:
        """Redraw the epoch's balanced subset (the reference's per-epoch
        hook). Classes with an empty pool contribute nothing; classes
        smaller than the quota draw with replacement."""
        picks = []
        for pool in self._pools:
            if len(pool) == 0:
                continue
            picks.append(self._rng.choice(
                pool, self.samples_per_class,
                replace=len(pool) < self.samples_per_class))
        idx = np.concatenate(picks) if picks else np.zeros(0, np.int64)
        self._rng.shuffle(idx)
        self._epoch_idx = idx

    def __len__(self) -> int:
        return len(self._epoch_idx)

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Fixed-size shuffled batches over the epoch's subset; the tail
        batch wraps around to the subset's start."""
        n = len(self._epoch_idx)
        for start in range(0, n, batch_size):
            sel = self._epoch_idx[start:start + batch_size]
            if len(sel) < batch_size:
                sel = np.concatenate(
                    [sel, self._epoch_idx[: batch_size - len(sel)]])
            yield self.feats[sel], self.labels[sel].astype(np.int32)


def extract_features(
    eval_fn: Callable,
    loader,
    max_batches: Optional[int] = None,
    ignore_index: int = 255,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run the frozen model over ``loader`` once and pool its per-voxel
    features with their labels: (N, D) f32, (N,) int64, over the valid,
    labelled rows in the loader's order.

    ``eval_fn(batch) -> (logits_or_repr, features)`` is the trainer's eval
    step. Each batch's rows are selected on the batch's device (the level-0
    mask and the labels) and the selection crosses to the host in one copy
    of the features and one of the labels."""
    feats_l, labels_l = [], []
    for i, batch in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        _, features = eval_fn(batch)
        labels = torch.as_tensor(batch.labels, device=features.device)
        keep = batch.graph.levels[0].mask(torch.bool).to(features.device)
        keep = keep & (labels != ignore_index)
        feats_l.append(features[keep].to(torch.float32).cpu().numpy())
        labels_l.append(labels[keep].cpu().numpy().astype(np.int64))
    if not feats_l:
        return np.zeros((0, 1), np.float32), np.zeros(0, np.int64)
    return np.concatenate(feats_l), np.concatenate(labels_l)
