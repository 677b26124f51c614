"""Textual (language-grounded) ScanNet200 datasets.

Counterpart of ``languagegroundedsemseg_tpu/data/prior_info.py`` (:24-77).

Mirror of reference lib/datasets/prior_info.py:3-68: the dataset additionally
loads precomputed CLIP text embeddings of the category names
(clip_feats_scannet_200.pkl) into ``loaded_text_features`` — the anchors the
contrastive language loss pulls voxel features toward. The pickle maps raw
class id -> (A, 512) array (row 0 = the plain category prompt, rows 1+ =
attribute prompts) or (512,).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from languagegroundedsemseg_torch.data.scannet import (
    Scannet200Voxelization2cmDataset,
    Scannet200VoxelizationDataset,
)


class _TextualMixin:
    FEATURE_DIM = 512

    def _load_text_features(self, config):
        root = config.scannet_path or config.data_dir
        path = os.path.join(root, config.language_features_path)
        feats = np.zeros((self.num_train_labels, 1, self.FEATURE_DIM), dtype=np.float32)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                d = pickle.load(f)
            max_attrs = 1
            for raw_id, v in d.items():
                v = np.asarray(v, dtype=np.float32)
                if v.ndim == 1:
                    v = v[None, :]
                max_attrs = max(max_attrs, v.shape[0])
            feats = np.zeros((self.num_train_labels, max_attrs, self.FEATURE_DIM), np.float32)
            for raw_id, v in d.items():
                raw_id = int(raw_id)
                if raw_id >= len(self.label_map_array):
                    continue
                tid = int(self.label_map_array[raw_id])
                if tid == self.ignore_mask:
                    continue
                v = np.asarray(v, dtype=np.float32)
                if v.ndim == 1:
                    v = v[None, :]
                feats[tid, : v.shape[0]] = v
        else:
            # No pkl on disk (tests/synthetic runs): deterministic pseudo
            # anchors so the pretraining path stays runnable.
            rng = np.random.default_rng(0)
            feats = rng.normal(size=(self.num_train_labels, 1, self.FEATURE_DIM)).astype(
                np.float32
            )
            feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        self.loaded_text_features = feats

    @property
    def text_anchors(self) -> np.ndarray:
        """(C, A, D) anchors in train-id order."""
        return self.loaded_text_features


class Scannet200Textual2cmDataset(_TextualMixin, Scannet200Voxelization2cmDataset):
    def __init__(self, config, **kw):
        super().__init__(config, **kw)
        self._load_text_features(config)


class Scannet200TextualDataset(_TextualMixin, Scannet200VoxelizationDataset):
    def __init__(self, config, **kw):
        super().__init__(config, **kw)
        self._load_text_features(config)
