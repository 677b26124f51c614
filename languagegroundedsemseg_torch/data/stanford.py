"""Stanford S3DIS (Area-5 split) datasets.

Counterpart of ``languagegroundedsemseg_tpu/data/stanford.py`` (:14-80).

Mirror of reference lib/datasets/stanford.py:19-214: 13 classes (clutter
merged), coords appended to features (NUM_IN_CHANNEL=6), 30cm clip bound,
z-rotation augmentation, room-merged full-cloud evaluation.
"""

from __future__ import annotations

import numpy as np

from languagegroundedsemseg_torch.data.dataset import DatasetPhase, VoxelizationDataset

# Alphabetical 14-class id space (the SpatioTemporalSegmentation recipe the
# reference inherits): index 10 = stairs, dropped via IGNORE_LABELS
# (reference stanford.py:20-24 "remove stairs, following SegCloud").
CLASSES = [
    "beam", "board", "bookcase", "ceiling", "chair", "clutter", "column",
    "door", "floor", "sofa", "stairs", "table", "wall", "window",
]


class StanfordVoxelizationDatasetBase:
    CLIP_SIZE = None
    CLIP_BOUND = None
    LOCFEAT_IDX = 2
    ROTATION_AXIS = "z"
    IGNORE_LABELS_RAW = (10,)  # stairs, reference stanford.py:24
    IS_FULL_POINTCLOUD_EVAL = True
    DATA_PATH_FILE = {
        DatasetPhase.Train: "train.txt",
        DatasetPhase.Val: "val.txt",
        DatasetPhase.TrainVal: "trainval.txt",
        DatasetPhase.Test: "test.txt",
    }


class StanfordDataset(StanfordVoxelizationDatasetBase, VoxelizationDataset):
    VOXEL_SIZE = 0.05

    CLIP_BOUND = 4  # [-N, N] half-box, reference stanford.py:93
    TEST_CLIP_BOUND = None

    ROTATION_AUGMENTATION_BOUND = ((-np.pi / 32, np.pi / 32), (-np.pi / 32, np.pi / 32), (-np.pi, np.pi))
    TRANSLATION_AUGMENTATION_RATIO_BOUND = ((-0.2, 0.2), (-0.2, 0.2), (-0.05, 0.05))
    ELASTIC_DISTORT_PARAMS = ((0.2, 0.4), (0.8, 1.6))

    AUGMENT_COORDS_TO_FEATS = True
    NUM_IN_CHANNEL = 6
    NUM_LABELS = 14
    IGNORE_LABELS = (10,)

    def __init__(self, config, phase=DatasetPhase.Train, augment_data=True, **kw):
        self.CLASS_LABELS = CLASSES
        self.VALID_CLASS_IDS = np.array(
            [i for i in range(self.NUM_LABELS) if i not in self.IGNORE_LABELS], np.int32
        )
        super().__init__(config, phase=phase, augment_data=augment_data, **kw)
        self.category_weights = np.ones(self.num_train_labels, dtype=np.float32)
        self.frequency_organized_cats = np.zeros((self.num_train_labels, 3), dtype=bool)
        self.frequency_organized_cats[:, 0] = True  # no long-tail split for S3DIS


class StanfordArea5Dataset(StanfordDataset):
    """Area-5 held out for validation (the standard split)."""

    DATA_PATH_FILE = {
        DatasetPhase.Train: "area1245.txt",
        DatasetPhase.Val: "area5.txt",
        DatasetPhase.Test: "area5.txt",
    }


class StanfordArea53cmDataset(StanfordArea5Dataset):
    CLIP_BOUND = 3.2
    VOXEL_SIZE = 0.03


class StanfordArea5Dataset2cm(StanfordArea5Dataset):
    VOXEL_SIZE = 0.02
