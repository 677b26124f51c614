"""Classifier fine-tuning on precomputed features with per-epoch
class-balanced resampling.

Counterpart of ``languagegroundedsemseg_tpu/train/classifier.py``. The
reference stage (lib/train_test/pl_ClassifierTrainer.py) trains a plain
linear ClassifierNet over frozen-model features and calls
``train_dataset.resample_features()`` at every epoch start (:120).

Flow: the trainer extracts the features once (``data/feature_dataset.py``),
then this loop trains ``models/classifier.py``'s ClassifierNet on the
features' device, redrawing the balanced subset every epoch. Its optimizer
is ``torch.optim.SGD`` with momentum and no dampening, Nesterov or weight
decay: optax's ``sgd(lr, momentum)`` (trace = g + momentum * trace,
p -= lr * trace; the first trace is g in both).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from languagegroundedsemseg_torch.data.feature_dataset import ResampledFeatureDataset
from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss
from languagegroundedsemseg_torch.models.classifier import ClassifierNet


def train_classifier_on_features(
    dataset: ResampledFeatureDataset,
    num_classes: int,
    epochs: int = 10,
    batch_size: int = 4096,
    lr: float = 0.1,
    momentum: float = 0.9,
    seed: int = 0,
    val: Optional[ResampledFeatureDataset] = None,
    log_fn: Optional[Callable[[Dict], None]] = None,
    device="cuda",
):
    """Train ClassifierNet on ``dataset``; returns (model, history). Its
    weights are drawn from a ``torch.Generator`` seeded with ``seed``.
    Each epoch's record: ``epoch``, ``loss`` (the mean of its batches'
    losses, ignore label 255) and, with ``val``, ``val_acc`` (accuracy over
    ``val``'s whole pool, predicted in chunks of ``batch_size``)."""
    dev = resolve_device(device)
    model = ClassifierNet(dataset.feature_dim, num_classes, device=dev,
                          generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum)

    def predict(feats: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            logits, _ = model(torch.as_tensor(feats, device=dev))
            return torch.argmax(logits, dim=-1).cpu().numpy()

    history = []
    for epoch in range(epochs):
        dataset.resample_features()  # the reference's per-epoch hook
        losses = []
        for feats, labels in dataset.batches(batch_size):
            logits, _ = model(torch.as_tensor(feats, device=dev))
            loss = cross_entropy_loss(logits, torch.as_tensor(labels, device=dev),
                                      ignore_index=255)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        rec = {"epoch": epoch,
               "loss": float(np.mean(torch.stack(losses).cpu().numpy()))
               if losses else float("nan")}
        if val is not None and len(val.feats):
            pred = np.concatenate([predict(val.feats[s:s + batch_size])
                                   for s in range(0, len(val.feats), batch_size)])
            rec["val_acc"] = float((pred == val.labels).mean())
        history.append(rec)
        if log_fn:
            log_fn(rec)
    return model, history
