"""Instance-segmentation datasets: .pth scenes with instance ids.

Counterpart of ``languagegroundedsemseg_tpu/insseg/dataset.py`` (:24-184),
on the port's data layer (``data/dataset.py``, ``data/synthetic.py``); the
same scenes give the same arrays.
A ``.pth`` scene is the tuple of numpy arrays the preprocessing writes
(``data/preprocessing/scannet.py --mode insseg``, in either package), so
it loads with ``torch.load(..., weights_only=False)``: open only files your
own preprocessing wrote.

Mirror of reference downstream/insseg/datasets/: scannet.py:131-147 loads
(points, colors, semantic, instance) .pth tuples; dataset.py:290-304
computes per-point instance centers; the voxelizer carries instance ids
through quantization. Data-efficient sampled_inds limiting (:87-90,139-145)
is supported via ``sampled_inds`` files.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Dict

import numpy as np

from languagegroundedsemseg_torch.data.dataset import DatasetPhase, VoxelizationDataset
from languagegroundedsemseg_torch.data.synthetic import synthetic_scene


def get_instance_info(xyz: np.ndarray, instance_ids: np.ndarray) -> Dict:
    """Per-point instance centers + per-instance occupancy/bbox (reference
    datasets/dataset.py:290-304)."""
    centers = np.full((len(xyz), 3), -1.0, dtype=np.float32)
    occupancy, bbox = {}, {}
    for iid in np.unique(instance_ids):
        if iid == -1:
            continue
        mask = instance_ids == iid
        pts = xyz[mask]
        centers[mask] = pts.mean(0)
        occupancy[int(iid)] = int(mask.sum())
        bbox[int(iid)] = np.concatenate([pts.min(0), pts.max(0)])
    return {"ids": instance_ids, "center": centers, "occupancy": occupancy, "bbox": bbox}


class InstanceVoxelizationDataset(VoxelizationDataset):
    """Voxelized scenes with per-voxel (semantic, instance, center)."""

    VOXEL_SIZE = 0.02
    NUM_CLASSES = 20
    ROTATION_AUGMENTATION_BOUND = (
        (-np.pi / 64, np.pi / 64),
        (-np.pi / 64, np.pi / 64),
        (-np.pi, np.pi),
    )
    TRANSLATION_AUGMENTATION_RATIO_BOUND = ((-0.2, 0.2), (-0.2, 0.2), (0, 0))
    ELASTIC_DISTORT_PARAMS = ((0.2, 0.4), (0.8, 1.6))

    def __init__(self, config, phase=DatasetPhase.Train, augment_data=True, **kw):
        from languagegroundedsemseg_torch import constants as C

        self.VALID_CLASS_IDS = C.valid_class_ids(self.NUM_CLASSES)
        self.CLASS_LABELS = C.class_labels(self.NUM_CLASSES)
        self.NUM_LABELS = int(self.VALID_CLASS_IDS.max()) + 1
        self.IGNORE_LABELS = tuple(
            set(range(self.NUM_LABELS)) - set(int(i) for i in self.VALID_CLASS_IDS)
        )
        super().__init__(config, phase=phase, augment_data=augment_data, **kw)
        self.sampled_inds: Dict[str, np.ndarray] = {}

    def _resolve_data_paths(self):
        root = self.config.scannet_path or self.config.data_dir
        phase_dir = {
            DatasetPhase.Train: "train",
            DatasetPhase.Val: "val",
            DatasetPhase.TrainVal: "trainval",
            DatasetPhase.Test: "test",
        }.get(self.phase, "train")
        if root and os.path.isdir(os.path.join(root, phase_dir)):
            return sorted(glob.glob(os.path.join(root, phase_dir, "*.pth")))
        return []

    def load_instance_cloud(self, index: int):
        import torch

        path = self.data_paths[index]
        data = torch.load(path, weights_only=False)
        xyz, rgb, semantic, instance = (np.asarray(d) for d in data[:4])
        scene = Path(path).stem
        # data-efficient limited supervision (sampled_inds masking)
        if scene in self.sampled_inds:
            mask = np.zeros(len(xyz), dtype=bool)
            mask[self.sampled_inds[scene]] = True
            semantic = np.where(mask, semantic, self.ignore_mask)
            instance = np.where(mask, instance, -1)
        return (
            xyz.astype(np.float32),
            rgb.astype(np.float32),
            semantic.astype(np.int32),
            instance.astype(np.int32),
            scene,
        )

    def get_item(self, index: int, rng: np.random.Generator):
        xyz, rgb, semantic, instance, scene = self.load_instance_cloud(index)
        if rgb.max() <= 1.001:  # insseg .pth colors are in [-1, 1] or [0, 1]
            rgb = (rgb + (rgb.min() < 0)) * (255.0 / 2 if rgb.min() < 0 else 255.0)

        if self.prevoxel_transform is not None:
            xyz, rgb, semantic = self.prevoxel_transform(rng, xyz, rgb, semantic)

        stacked = np.stack([semantic, instance], axis=1)
        vcoords, vfeats, vstacked, transform = self.voxelizer.voxelize(
            rng, xyz.astype(np.float64), rgb, stacked, augment=self.augment_data
        )
        if self.input_transform is not None:
            vcoords, vfeats, vstacked = self.input_transform(rng, vcoords, vfeats, vstacked)
        vsem = self.map_labels(vstacked[:, 0])
        vinst = vstacked[:, 1].astype(np.int32)
        info = get_instance_info(vcoords.astype(np.float32), vinst)
        return dict(
            coords=vcoords.astype(np.int32),
            feats=vfeats.astype(np.float32),
            labels=vsem,
            instances=vinst,
            centers=info["center"],
            scene_name=scene,
            transform=transform,
            # full-resolution cloud for instance eval back-projection
            # (reference get_original_pointcloud,
            # downstream/insseg/datasets/scannet.py:149-170)
            original=dict(xyz=xyz.astype(np.float32), semantic=semantic, instance=instance),
        )


class ScannetInstance2cmDataset(InstanceVoxelizationDataset):
    NUM_CLASSES = 20


class Scannet200Instance2cmDataset(InstanceVoxelizationDataset):
    NUM_CLASSES = 200


class SyntheticInstanceDataset(InstanceVoxelizationDataset):
    """In-memory instance scenes for tests (boxes = instances)."""

    NUM_SCENES = 4
    POINTS_PER_SCENE = 4000
    NUM_CLASSES = 20

    def __init__(self, config, phase=DatasetPhase.Train, augment_data=True, **kw):
        super().__init__(config, phase=phase, augment_data=augment_data, **kw)
        # Labels from the generator are already contiguous ids; identity map.
        self.NUM_LABELS = self.NUM_CLASSES
        self.IGNORE_LABELS = ()
        self.label_map_array = np.arange(self.NUM_CLASSES, dtype=np.int64)
        self.num_train_labels = self.NUM_CLASSES

    def _resolve_data_paths(self):
        return [f"synthinst_{i:04d}" for i in range(self.NUM_SCENES)]

    def load_instance_cloud(self, index: int):
        rng = np.random.default_rng(2000 + index)
        xyz, rgb, labels, inst = synthetic_scene(
            rng,
            num_points=self.POINTS_PER_SCENE,
            num_classes=self.NUM_CLASSES,
            num_objects=5,
            return_instances=True,
        )
        return xyz, rgb, labels, inst, self.data_paths[index]


_INSTANCE_DATASETS = {
    c.__name__: c
    for c in (
        ScannetInstance2cmDataset,
        Scannet200Instance2cmDataset,
        SyntheticInstanceDataset,
    )
}


def load_instance_dataset(name: str):
    """Instance-dataset registry for the CLI insseg mode."""
    if name not in _INSTANCE_DATASETS:
        raise KeyError(
            f"unknown instance dataset {name!r}; have {sorted(_INSTANCE_DATASETS)}"
        )
    return _INSTANCE_DATASETS[name]
