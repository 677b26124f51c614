"""In-memory synthetic datasets implementing the VoxelizationDataset API.

Counterpart of ``languagegroundedsemseg_tpu/data/synthetic_dataset.py``.

Used by tests, the benchmark, and dry runs when ScanNet data isn't on disk;
registered in the dataset registry alongside the real datasets.
"""

from __future__ import annotations

import numpy as np

from languagegroundedsemseg_torch.data.dataset import DatasetPhase, VoxelizationDataset
from languagegroundedsemseg_torch.data.synthetic import synthetic_scene


class SyntheticDatasetBase(VoxelizationDataset):
    VOXEL_SIZE = 0.02
    NUM_SCENES = 16
    POINTS_PER_SCENE = 60_000
    NUM_CLASSES = 200
    ANCHOR_DIM = 512

    ROTATION_AUGMENTATION_BOUND = (
        (-np.pi / 64, np.pi / 64),
        (-np.pi / 64, np.pi / 64),
        (-np.pi, np.pi),
    )
    TRANSLATION_AUGMENTATION_RATIO_BOUND = ((-0.2, 0.2), (-0.2, 0.2), (0, 0))
    ELASTIC_DISTORT_PARAMS = ((0.2, 0.4), (0.8, 1.6))
    NUM_IN_CHANNEL = 3

    def __init__(self, config, phase=DatasetPhase.Train, augment_data=True, **kw):
        # Labels are already contiguous train ids in the synthetic generator.
        self.NUM_LABELS = self.NUM_CLASSES
        self.IGNORE_LABELS = ()
        super().__init__(config, phase=phase, augment_data=augment_data, **kw)
        self.category_weights = np.ones(self.NUM_CLASSES, dtype=np.float32)
        from languagegroundedsemseg_torch import constants as C

        if self.NUM_CLASSES == 200:
            self.frequency_organized_cats = C.frequency_organized_cats(200)
        else:
            self.frequency_organized_cats = np.zeros((self.NUM_CLASSES, 3), dtype=bool)
            self.frequency_organized_cats[:, 0] = True
        # Deterministic pseudo CLIP anchors for pretraining paths.
        rng = np.random.default_rng(7)
        anchors = rng.normal(size=(self.NUM_CLASSES, 1, self.ANCHOR_DIM)).astype(np.float32)
        self.loaded_text_features = anchors / np.linalg.norm(anchors, axis=-1, keepdims=True)

    def _resolve_data_paths(self):
        return [f"synthetic_{i:04d}" for i in range(self.NUM_SCENES)]

    def load_cloud(self, index: int):
        rng = np.random.default_rng(1000 + index)
        xyz, rgb, labels = synthetic_scene(
            rng, num_points=self.POINTS_PER_SCENE, num_classes=self.NUM_CLASSES
        )
        return xyz, rgb, labels, None, self.data_paths[index]


class Synthetic200Voxelization2cmDataset(SyntheticDatasetBase):
    pass


class SyntheticTiny20Dataset(SyntheticDatasetBase):
    NUM_SCENES = 4
    POINTS_PER_SCENE = 3000
    NUM_CLASSES = 20
    ANCHOR_DIM = 96  # matches Res16UNet14A's PLANES[7] for fast repr tests
