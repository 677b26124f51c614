"""Dataset base classes: cloud loading, label remap, voxelize+augment.

Counterpart of ``languagegroundedsemseg_tpu/data/dataset.py`` (:25-241).

Behavioral mirror of reference lib/dataset.py:21-416 (DatasetPhase,
VoxelizationDataset.__getitem__ pipeline: prevoxel downsample -> prevoxel
transforms -> voxelize -> input/target transforms -> label remap -> optional
coords-as-feats), re-structured for explicit RNG and the fixed-capacity
batch builder instead of torch DataLoader collates.
"""

from __future__ import annotations

import enum
import glob
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from languagegroundedsemseg_torch.data import transforms as t
from languagegroundedsemseg_torch.data.voxelizer import Voxelizer
from languagegroundedsemseg_torch.sparse.graph_host import quantize


class DatasetPhase(enum.Enum):
    Train = 0
    Val = 1
    TrainVal = 2
    Test = 3


def str2datasetphase(phase: str) -> DatasetPhase:
    return {
        "train": DatasetPhase.Train,
        "val": DatasetPhase.Val,
        "trainval": DatasetPhase.TrainVal,
        "test": DatasetPhase.Test,
    }[phase.lower()]


class VoxelizationDataset:
    """Loads labeled clouds, voxelizes with augmentation, remaps labels."""

    # Voxelization
    VOXEL_SIZE: float = 0.05
    CLIP_BOUND = None
    TEST_CLIP_BOUND = None
    PREVOXELIZATION_VOXEL_SIZE: Optional[float] = None

    # Coordinate augmentation bounds (reference lib/dataset.py:205-210)
    SCALE_AUGMENTATION_BOUND = (0.9, 1.1)
    ROTATION_AUGMENTATION_BOUND = (
        (-np.pi / 6, np.pi / 6),
        (-np.pi, np.pi),
        (-np.pi / 6, np.pi / 6),
    )
    TRANSLATION_AUGMENTATION_RATIO_BOUND = ((-0.2, 0.2), (-0.05, 0.05), (-0.2, 0.2))
    ELASTIC_DISTORT_PARAMS = None
    ROTATION_AXIS = "z"
    IS_TEMPORAL = False
    LOCFEAT_IDX = 2

    # Labels
    NUM_LABELS: int = 0  # raw label id space size
    IGNORE_LABELS: Sequence[int] = ()
    AUGMENT_COORDS_TO_FEATS = False
    NUM_IN_CHANNEL = 3
    IS_FULL_POINTCLOUD_EVAL = False

    DATA_PATH_FILE: Dict[DatasetPhase, str] = {}

    def __init__(
        self,
        config,
        phase: DatasetPhase | str = DatasetPhase.Train,
        augment_data: bool = False,
        prevoxel_transform=None,
        input_transform=None,
        target_transform=None,
        cache: bool = False,
    ):
        if isinstance(phase, str):
            phase = str2datasetphase(phase)
        self.config = config
        self.phase = phase
        self.augment_data = augment_data
        self.prevoxel_transform = prevoxel_transform
        self.input_transform = input_transform
        self.target_transform = target_transform
        self.ignore_mask = config.ignore_label
        self.cache = cache
        self._cache: Dict[int, tuple] = {}

        self.data_paths = self._resolve_data_paths()

        self.voxelizer = Voxelizer(
            voxel_size=self.VOXEL_SIZE,
            clip_bound=self.CLIP_BOUND,
            use_augmentation=augment_data,
            scale_augmentation_bound=self.SCALE_AUGMENTATION_BOUND,
            rotation_augmentation_bound=self.ROTATION_AUGMENTATION_BOUND,
            translation_augmentation_ratio_bound=self.TRANSLATION_AUGMENTATION_RATIO_BOUND,
            ignore_label=config.ignore_label,
        )

        # Dense raw->train id lookup (reference lib/dataset.py:258-273).
        self.label_map_array = self._build_label_map()
        self.inverse_label_map = {
            int(train_id): int(raw)
            for raw, train_id in enumerate(self.label_map_array)
            if train_id != self.ignore_mask
        }
        self.num_train_labels = self.NUM_LABELS - len(self.IGNORE_LABELS)

    # -- label map -----------------------------------------------------------

    def _build_label_map(self) -> np.ndarray:
        ignore = set(int(i) for i in self.IGNORE_LABELS)
        table = np.full(max(self.NUM_LABELS, 1), self.ignore_mask, dtype=np.int64)
        n_used = 0
        for l in range(self.NUM_LABELS):
            if l not in ignore:
                table[l] = n_used
                n_used += 1
        return table

    def map_labels(self, labels: np.ndarray) -> np.ndarray:
        clipped = np.clip(labels, 0, len(self.label_map_array) - 1)
        mapped = self.label_map_array[clipped]
        mapped = np.where(
            (labels < 0) | (labels >= len(self.label_map_array)), self.ignore_mask, mapped
        )
        return mapped.astype(np.int32)

    # -- data access ---------------------------------------------------------

    def _resolve_data_paths(self) -> List[str]:
        root = getattr(self.config, "scannet_path", "") or self.config.data_dir
        fname = self.DATA_PATH_FILE.get(self.phase)
        if fname:
            list_path = os.path.join(root, fname)
            if os.path.isfile(list_path):
                with open(list_path) as f:
                    return [os.path.join(root, line.strip()) for line in f if line.strip()]
        # fall back: glob plys under root
        if root and os.path.isdir(root):
            return sorted(glob.glob(os.path.join(root, "**", "*.ply"), recursive=True))
        return []

    def load_cloud(self, index: int):
        """-> (xyz f32 (N,3), rgb f32 in [0,255], raw labels i32,
        instance_ids or None, scene_name)."""
        if self.cache and index in self._cache:
            return self._cache[index]
        from languagegroundedsemseg_torch.utils.ply import read_ply_cloud

        path = self.data_paths[index]
        xyz, rgb, labels, inst = read_ply_cloud(path)
        name = Path(path).stem
        out = (xyz, rgb, labels, inst, name)
        if self.cache:
            self._cache[index] = out
        return out

    def __len__(self) -> int:
        return len(self.data_paths)

    def _augment_coords_to_feats(self, coords, feats):
        norm_coords = coords - coords.mean(0)
        return np.concatenate([feats, norm_coords], axis=1)

    # -- the per-item pipeline ----------------------------------------------

    def get_item(self, index: int, rng: np.random.Generator):
        """-> dict(coords int32 (M,3), feats f32 (M,F), labels i32 (M,),
        scene_name, transform). Mirrors reference __getitem__
        (lib/datasets/scannet.py:321-373)."""
        xyz, rgb, labels, instance_ids, scene_name = self.load_cloud(index)
        coords, feats = xyz.astype(np.float64), rgb.astype(np.float32)

        if self.PREVOXELIZATION_VOXEL_SIZE is not None:
            keep = quantize(np.floor(coords / self.PREVOXELIZATION_VOXEL_SIZE).astype(np.int64))
            coords, feats, labels = coords[keep], feats[keep], labels[keep]
            if instance_ids is not None:
                instance_ids = instance_ids[keep]

        if self.prevoxel_transform is not None:
            coords, feats, labels = self.prevoxel_transform(rng, coords, feats, labels)

        coords, feats, labels = self.hook_before_voxelize(
            rng, coords, feats, labels, instance_ids, scene_name
        )

        vcoords, vfeats, vlabels, transform = self.voxelizer.voxelize(
            rng, coords, feats, labels, augment=self.augment_data
        )

        if self.input_transform is not None:
            vcoords, vfeats, vlabels = self.input_transform(rng, vcoords, vfeats, vlabels)
        if self.target_transform is not None:
            vcoords, vfeats, vlabels = self.target_transform(rng, vcoords, vfeats, vlabels)

        if self.IGNORE_LABELS is not None and vlabels is not None:
            vlabels = self.map_labels(vlabels)

        if self.AUGMENT_COORDS_TO_FEATS:
            vfeats = self._augment_coords_to_feats(vcoords, vfeats)

        return dict(
            coords=vcoords.astype(np.int32),
            feats=vfeats.astype(np.float32),
            labels=vlabels,
            scene_name=scene_name,
            transform=transform,
        )

    def hook_before_voxelize(self, rng, coords, feats, labels, instance_ids, scene_name):
        """Subclass hook (tail-instance sampling, instance augmentation)."""
        return coords, feats, labels


def build_input_transforms(config, dataset_cls, augment_data: bool):
    """Assemble prevoxel/input transform stacks exactly like the reference
    loader (lib/dataset.py:360-391)."""
    prevoxel = None
    if augment_data and config.elastic_distortion and dataset_cls.ELASTIC_DISTORT_PARAMS:
        prevoxel = t.Compose([t.ElasticDistortion(dataset_cls.ELASTIC_DISTORT_PARAMS)])

    input_transforms = []
    if augment_data:
        input_transforms += [
            t.RandomHorizontalFlip(dataset_cls.ROTATION_AXIS, dataset_cls.IS_TEMPORAL),
            t.ChromaticAutoContrast(),
            t.ChromaticTranslation(config.data_aug_color_trans_ratio),
            t.ChromaticJitter(config.data_aug_color_jitter_std),
        ]
    if config.data_aug_color_scaling_factor != 1.0:
        input_transforms.append(t.ChromaticScale(config.data_aug_color_scaling_factor))
    if config.data_aug_patch_dropout_ratio == 0.0:
        input_transforms.append(t.RandomDropout(0.2))
    return prevoxel, (t.Compose(input_transforms) if input_transforms else None)
