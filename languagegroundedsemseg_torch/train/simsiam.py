"""SimSiam-style paired-view pretraining.

Counterpart of ``languagegroundedsemseg_tpu/train/simsiam.py``, the
paired pipeline of the reference (paired_cfl collate lib/transforms.py:453,
Res16UNet34DPaired, the SupervisedSimSiam loss): each scene is voxelized
twice with independent augmentations (``Voxelizer.voxelize_pair``),
per-category nearest-neighbour correspondences link the views, and the
shared-backbone model is trained with the paired cosine and CLIP-anchor
losses.

``build_paired_batch`` is host code over the port's ``BatchBuilder``; its
correspondences are numpy. ``make_simsiam_train_step`` runs on ``device``
(the card unless the caller asks for the CPU), so on the card both views'
convs run the port's kernels.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.losses.simsiam import supervised_simsiam_loss
from languagegroundedsemseg_torch.ops.onehot_conv import with_inverse_anchors
from languagegroundedsemseg_torch.train.state import TrainState
from languagegroundedsemseg_torch.train.step import TrainBatch


def _remap(corrs_scene, lay_self, lay_other, cap_self: int, n_other: int) -> np.ndarray:
    """Scene-local correspondences -> rows of the other view's
    concatenation -> its padded device rows. Both layouts may interleave
    sentinel rows, so kept row i of a view sits at its layout's pos0[i];
    rows without a partner (and padding) read -1."""
    inv_other = np.full(n_other, -1, dtype=np.int64)
    inv_other[lay_other["order"]] = lay_other["pos0"]
    cat = np.concatenate([np.where(c >= 0, c + off, -1) for c, off in corrs_scene])
    ordered = cat[lay_self["order"]]
    mapped = np.where((ordered >= 0) & (ordered < n_other),
                      inv_other[np.clip(ordered, 0, n_other - 1)], -1)
    out = np.full(cap_self, -1, dtype=np.int32)
    out[lay_self["pos0"]] = mapped
    return out


def build_paired_batch(
    builder: BatchBuilder,
    dataset,
    indices: List[int],
    rng: np.random.Generator,
    normalize_color: bool = True,
    dropout_ratio: float = 0.35,
    device="cuda",
) -> Tuple[TrainBatch, TrainBatch, np.ndarray, np.ndarray]:
    """-> (batch1, batch2, corrs1, corrs2): the two views' batches on
    ``device`` and, per padded row of each, the padded row of its partner
    in the other batch (int32, -1 = none)."""
    views1, views2, corr_parts = [], [], []
    for idx in indices:
        xyz, rgb, labels, _inst, _name = (
            dataset.load_cloud(idx) if hasattr(dataset, "load_cloud")
            else dataset.load_instance_cloud(idx))
        (c0, f0, l0, _, corr0), (c1, f1, l1, _, corr1) = dataset.voxelizer.voxelize_pair(
            rng, xyz.astype(np.float64), rgb, labels, dropout_ratio=dropout_ratio)
        l0, l1 = dataset.map_labels(l0), dataset.map_labels(l1)
        if normalize_color:
            f0 = f0.copy()
            f0[:, :3] = f0[:, :3] / 255.0 - 0.5
            f1 = f1.copy()
            f1[:, :3] = f1[:, :3] / 255.0 - 0.5
        views1.append((c0, f0, l0))
        views2.append((c1, f1, l1))
        corr_parts.append((corr0, corr1))

    b1, lay1 = builder.build(views1, return_layout=True, device=device)
    b2, lay2 = builder.build(views2, return_layout=True, device=device)
    n1 = sum(len(v[0]) for v in views1)
    n2 = sum(len(v[0]) for v in views2)
    corrs1 = _remap([(cp[0], lay2["scene_offsets"][i]) for i, cp in enumerate(corr_parts)],
                    lay1, lay2, b1.feats.shape[0], n2)
    corrs2 = _remap([(cp[1], lay1["scene_offsets"][i]) for i, cp in enumerate(corr_parts)],
                    lay2, lay1, b2.feats.shape[0], n1)
    return b1, b2, corrs1, corrs2


def make_simsiam_train_step(model, optimizer, config, anchors,
                            split_matrix=None, device="cuda") -> Callable:
    """Build ``step(state, b1, b2, corrs1, corrs2, generator=None, *,
    u1=None, u2=None) -> (state, metrics)``.

    Moves ``model`` (``Res16UNet34DPaired``) to ``device``. Each call runs
    the train-mode forward of both views through the shared backbone (view
    1 first, so each batch norm's running statistics move once per view in
    JAX's order), the supervised SimSiam loss on the level-0 row masks
    (anchor terms against ``anchors`` (C, D); ``u1`` / ``u2`` are the
    balanced masking's draws, from ``generator`` when absent), the
    backward, and ``optimizer``'s update scaled by ``state.lr_scale``; then
    ``state.step += 1``. Metrics (0-d tensors on the device): the loss's
    and ``loss``."""
    dev = resolve_device(device)
    model = model.to(dev)
    anchors_t = torch.as_tensor(np.asarray(anchors), dtype=torch.float32, device=dev)
    split_t = (None if split_matrix is None
               else torch.as_tensor(np.asarray(split_matrix), device=dev))

    def prepare(batch):
        batch = batch.to(dev).decompact()
        return batch.replace(graph=with_inverse_anchors(batch.graph))

    def step(state: TrainState, b1: TrainBatch, b2: TrainBatch, corrs1, corrs2,
             generator: Optional[torch.Generator] = None, *,
             u1: Optional[torch.Tensor] = None, u2: Optional[torch.Tensor] = None):
        b1, b2 = prepare(b1), prepare(b2)
        c1 = torch.as_tensor(np.asarray(corrs1), device=dev)
        c2 = torch.as_tensor(np.asarray(corrs2), device=dev)
        model.train()
        model.zero_grad(set_to_none=True)
        z1, z2 = model(b1.feats, b1.graph, feats2=b2.feats, graph2=b2.graph)
        loss, metrics = supervised_simsiam_loss(
            generator, config, z1, z2, z1, z2, c1, c2, b1.labels, b2.labels,
            anchors_t, split_t, b1.graph.levels[0].mask(), b2.graph.levels[0].mask(),
            u1=u1, u2=u2)
        loss.backward()
        optimizer.step(lr_scale=state.lr_scale)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    return step
