"""ScanNet / ScanNet200 datasets with long-tail balancing machinery.

Counterpart of ``languagegroundedsemseg_tpu/data/scannet.py`` (:26-342).

Behavioral mirror of reference lib/datasets/scannet.py:24-457: class-id maps,
category/instance-sampling weight loading, head/common/tail partitions,
on-the-fly tail-instance placement with height-map collision avoidance,
per-instance augmentation, and full-pointcloud KD-query evaluation.
"""

from __future__ import annotations

import glob
import os
import pickle
from pathlib import Path
from typing import Optional

import numpy as np
from scipy import ndimage, spatial

from languagegroundedsemseg_torch import constants as C
from languagegroundedsemseg_torch.data.dataset import DatasetPhase, VoxelizationDataset
from languagegroundedsemseg_torch.data.transforms import InstanceAugmentation
from languagegroundedsemseg_torch.sparse.graph_host import quantize


def boxes_intersect(a: np.ndarray, b: np.ndarray) -> bool:
    """AABB overlap: boxes given as (2, 3) [min; max] (reference
    lib/datasets/preprocessing/utils.py:73 box_intersect)."""
    a_min, a_max = np.minimum(a[0], a[1]), np.maximum(a[0], a[1])
    b_min, b_max = np.minimum(b[0], b[1]), np.maximum(b[0], b[1])
    return bool((a_min <= b_max).all() and (b_min <= a_max).all())


class ScannetVoxelizationDataset(VoxelizationDataset):
    """20-class ScanNet semantic segmentation at 5cm (reference :24-439)."""

    VOXEL_SIZE = 0.05
    CLIP_BOUND = None
    TEST_CLIP_BOUND = None

    NUM_CLASSES = 20

    ROTATION_AUGMENTATION_BOUND = (
        (-np.pi / 64, np.pi / 64),
        (-np.pi / 64, np.pi / 64),
        (-np.pi, np.pi),
    )
    TRANSLATION_AUGMENTATION_RATIO_BOUND = ((-0.2, 0.2), (-0.2, 0.2), (0, 0))
    ELASTIC_DISTORT_PARAMS = ((0.2, 0.4), (0.8, 1.6))
    ROTATION_AXIS = "z"
    IS_FULL_POINTCLOUD_EVAL = True
    NUM_IN_CHANNEL = 3

    DATA_PATH_FILE = {
        DatasetPhase.Train: "train.txt",
        DatasetPhase.Val: "val.txt",
        DatasetPhase.TrainVal: "trainval.txt",
        DatasetPhase.Test: "test.txt",
    }

    def __init__(self, config, phase=DatasetPhase.Train, augment_data=True, **kw):
        self.VALID_CLASS_IDS = C.valid_class_ids(self.NUM_CLASSES)
        self.CLASS_LABELS = C.class_labels(self.NUM_CLASSES)
        self.SCANNET_COLOR_MAP = C.color_map(self.NUM_CLASSES)
        self.NUM_LABELS = int(self.VALID_CLASS_IDS.max()) + 1
        self.IGNORE_LABELS = tuple(
            set(range(self.NUM_LABELS)) - set(int(i) for i in self.VALID_CLASS_IDS)
        )
        if isinstance(phase, str):
            from languagegroundedsemseg_torch.data.dataset import str2datasetphase

            phase = str2datasetphase(phase)
        if phase not in (DatasetPhase.Train, DatasetPhase.TrainVal):
            self.CLIP_BOUND = self.TEST_CLIP_BOUND
        super().__init__(config, phase=phase, augment_data=augment_data, **kw)

        root = config.scannet_path or config.data_dir

        # Category weights for weighted CE / focal alpha (reference :86-97).
        self.category_weights = np.ones(self.num_train_labels, dtype=np.float32)
        cw_path = os.path.join(root, config.category_weights)
        if os.path.isfile(cw_path):
            with open(cw_path, "rb") as f:
                for cat_id, v in pickle.load(f).items():
                    if cat_id > 0 and cat_id < len(self.label_map_array):
                        mapped = int(self.label_map_array[cat_id])
                        if mapped != self.ignore_mask:
                            self.category_weights[mapped] = v

        # Instance-sampling weights for tail resampling (reference :99-109).
        self.instance_sampling_weights = np.ones(len(self.VALID_CLASS_IDS), dtype=np.float64)
        isw_path = os.path.join(root, config.instance_sampling_weights)
        if os.path.isfile(isw_path) and config.sample_tail_instances:
            with open(isw_path, "rb") as f:
                w = pickle.load(f)
            for i, cat_id in enumerate(self.VALID_CLASS_IDS):
                if int(cat_id) in w:
                    self.instance_sampling_weights[i] = w[int(cat_id)]
        self.instance_sampling_weights /= self.instance_sampling_weights.sum()

        self.id2cat_name = {int(i): n for i, n in zip(self.VALID_CLASS_IDS, self.CLASS_LABELS)}

        # Bounding boxes of all scene instances (for placement collision).
        self.bounding_boxes = None
        bb_path = os.path.join(root, config.bounding_boxes_path)
        if os.path.isfile(bb_path):
            with open(bb_path, "rb") as f:
                self.bounding_boxes = pickle.load(f)

        self.instance_augmentation_transform = InstanceAugmentation()
        self.aug_color_prob = config.instance_augmentation_color_aug_prob
        self.aug_scale_prob = config.instance_augmentation_scale_aug_prob

        # Head/common/tail partition over train ids (reference :127-141).
        head, common, tail = C.head_common_tail_names()
        self.frequency_organized_cats = np.zeros((self.num_train_labels, 3), dtype=bool)
        self.head_ids, self.common_ids, self.tail_ids = [], [], []
        for raw_id, name in zip(self.VALID_CLASS_IDS, self.CLASS_LABELS):
            tid = int(self.label_map_array[int(raw_id)])
            if name in head:
                self.head_ids.append(tid)
                self.frequency_organized_cats[tid, 0] = True
            elif name in common:
                self.common_ids.append(tid)
                self.frequency_organized_cats[tid, 1] = True
            else:
                self.tail_ids.append(tid)
                self.frequency_organized_cats[tid, 2] = True

    # -- tail-instance machinery --------------------------------------------

    def _instance_folder(self) -> str:
        phase = "train" if self.config.is_train else "val"
        root = self.config.scannet_path or self.config.data_dir
        return os.path.join(root, "train", f"{phase}_instances")

    def augment_instances(self, rng, coords, feats, labels, instance_ids=None):
        """Per-tail-instance color/scale augmentation with attribute labels
        (reference :243-319). ``labels`` is (N, 2): [category, attribute]."""
        aug_c, aug_f, aug_l, remove = [], [], [], []
        scene_scale = coords.max(0) - coords.min(0)
        tail = self.frequency_organized_cats[:, 2]
        idx_all = np.arange(len(coords))

        for raw_cat in np.unique(labels[:, 0]).astype(int):
            if raw_cat < 0 or raw_cat >= len(self.label_map_array):
                continue
            tid = int(self.label_map_array[raw_cat])
            if tid == self.ignore_mask or not tail[tid]:
                continue
            cat_inds = labels[:, 0] == raw_cat
            groups = (
                [cat_inds & (instance_ids == i) for i in np.unique(instance_ids[cat_inds])]
                if instance_ids is not None
                else [np.ones(len(coords), dtype=bool)]
            )
            for p in groups:
                ic, iff, il = coords[p], feats[p], labels[p]
                if rng.random() < self.aug_color_prob:
                    ic, iff, il = self.instance_augmentation_transform.shift_color(rng, ic, iff, il)
                elif rng.random() < self.aug_scale_prob:
                    ic, iff, il = self.instance_augmentation_transform.shift_scale(
                        rng, ic, iff, il, scene_scale
                    )
                aug_c.append(ic)
                aug_f.append(iff)
                aug_l.append(il)
                remove.append(idx_all[p])

        if aug_c:
            remove = np.concatenate(remove)
            keep = np.ones(len(coords), dtype=bool)
            keep[remove] = False
            coords = np.vstack([coords[keep], *aug_c])
            feats = np.vstack([feats[keep], *aug_f])
            labels = np.vstack([labels[keep], *aug_l])
        return coords, feats, labels

    def add_instances_to_cloud(self, rng, coords, feats, labels, scene_name, transformations):
        """Place sampled tail instances into a voxelized scene: height-map
        supported, bbox-collision avoided (reference :143-241)."""
        inst_root = self._instance_folder()
        if not os.path.isdir(inst_root) or self.bounding_boxes is None:
            return coords, feats, labels, False
        voxel_scale, trans_rot = transformations
        coords = coords.astype(int)
        scene_bbs = self.bounding_boxes.get(scene_name, {"instances": []})

        samples = rng.choice(
            self.VALID_CLASS_IDS,
            self.config.num_instances_to_add,
            p=self.instance_sampling_weights,
        )
        scene_max, scene_min = coords.max(0), coords.min(0)
        dims = scene_max - scene_min + 1

        # Height map with max-filter hole filling (reference :163-172).
        hm = np.full((dims[0], dims[1]), scene_min[2], dtype=np.float64)
        mx, my = coords[:, 0] - scene_min[0], coords[:, 1] - scene_min[1]
        np.maximum.at(hm, (mx, my), coords[:, 2])
        hm = ndimage.maximum_filter(hm, size=5)

        from languagegroundedsemseg_torch.utils.ply import read_ply_cloud

        for raw_cat in samples:
            cat_dir = os.path.join(inst_root, self.id2cat_name[int(raw_cat)])
            files = os.listdir(cat_dir) if os.path.isdir(cat_dir) else []
            if not files:
                continue
            f = os.path.join(cat_dir, files[rng.integers(len(files))])
            ixyz, irgb, ilab, iinst = read_ply_cloud(f)
            ilabels = ilab
            if self.config.instance_augmentation is not None:
                ilabels = np.hstack([ilab[:, None], np.zeros_like(ilab)[:, None]])
                if self.config.instance_augmentation == "raw":
                    ixyz, irgb, ilabels = self.augment_instances(rng, ixyz, irgb, ilabels, iinst)

            ic, iff, il, _ = self.voxelizer.voxelize(rng, ixyz, irgb, ilabels)
            sdim = ic.max(0) - ic.min(0) + 1

            centroid = np.zeros(3, dtype=int)
            for _ in range(self.config.max_instance_placing_iterations):
                rx = rng.integers(scene_min[0], scene_max[0] + 1)
                ry = rng.integers(scene_min[1], scene_max[1] + 1)
                h = float(hm[rx - scene_min[0], ry - scene_min[1]])
                centroid = np.array([rx, ry, int(h + sdim[2] / 2.0)])
                rand_bb = np.array([centroid - sdim / 2.0, centroid + sdim / 2.0])
                hit = False
                for bb_dict in scene_bbs["instances"]:
                    bb = np.asarray(bb_dict["bb"], dtype=np.float64)
                    homo = np.hstack([bb, np.ones((len(bb), 1))])
                    bb = homo @ voxel_scale.T[:, :3]
                    if boxes_intersect(bb, rand_bb):
                        hit = True
                        break
                if not hit:
                    break

            ic = ic - ic.mean(0).astype(int) + centroid
            coords = np.concatenate([coords, ic])
            feats = np.concatenate([feats, iff])
            labels = np.concatenate([labels, il]) if labels.ndim == il.ndim else np.concatenate(
                [labels, il[:, 0]]
            )

        # Apply the deferred rotation, re-quantize (reference :233-241).
        homo = np.hstack([coords, np.ones((len(coords), 1))])
        coords_aug = np.floor(homo @ trans_rot.T[:, :3]).astype(np.int32)
        keep = quantize(coords_aug)
        return coords_aug[keep], feats[keep], labels[keep], True

    # -- per-item pipeline with tail sampling (reference :321-373) ----------

    def get_item(self, index: int, rng: np.random.Generator):
        if not (self.config.sample_tail_instances and self.augment_data):
            return super().get_item(index, rng)

        xyz, rgb, labels, instance_ids, scene_name = self.load_cloud(index)
        coords, feats = xyz.astype(np.float64), rgb.astype(np.float32)
        if self.PREVOXELIZATION_VOXEL_SIZE is not None:
            keep = quantize(np.floor(coords / self.PREVOXELIZATION_VOXEL_SIZE).astype(np.int64))
            coords, feats, labels = coords[keep], feats[keep], labels[keep]
        if self.prevoxel_transform is not None:
            coords, feats, labels = self.prevoxel_transform(rng, coords, feats, labels)

        # Voxelize without rotation, place instances, then rotate+requantize.
        vcoords, vfeats, vlabels, transform = self.voxelizer.voxelize(
            rng, coords, feats, labels, augment=False
        )
        vcoords, vfeats, vlabels, _ = self.add_instances_to_cloud(
            rng, vcoords, vfeats, vlabels, scene_name, transform
        )

        if self.input_transform is not None:
            vcoords, vfeats, vlabels = self.input_transform(rng, vcoords, vfeats, vlabels)
        if vlabels is not None:
            if vlabels.ndim == 2:
                vlabels = np.hstack(
                    [self.map_labels(vlabels[:, 0])[:, None], vlabels[:, 1:].astype(np.int32)]
                )
            else:
                vlabels = self.map_labels(vlabels)
        return dict(
            coords=vcoords.astype(np.int32),
            feats=vfeats.astype(np.float32),
            labels=vlabels,
            scene_name=scene_name,
            transform=transform,
        )

    def get_output_id(self, iteration: int) -> str:
        return "_".join(Path(self.data_paths[iteration]).stem.split("_")[:2])

    # -- full-pointcloud evaluation (reference :391-439) ---------------------

    def test_pointcloud(self, pred_dir: str, num_labels: int):
        from languagegroundedsemseg_torch.eval.miou import fast_hist, per_class_iou
        from languagegroundedsemseg_torch.utils.ply import read_ply_cloud, write_ply

        eval_path = os.path.join(pred_dir, "fulleval")
        os.makedirs(eval_path, exist_ok=True)
        hist = np.zeros((num_labels, num_labels), dtype=np.int64)
        for i, data_path in enumerate(self.data_paths):
            room_id = self.get_output_id(i)
            pred_files = glob.glob(os.path.join(pred_dir, f"*pred*{i:04d}.npy"))
            if not pred_files:
                continue
            pred = np.load(pred_files[0])
            pred[:, :3] *= self.voxelizer.voxel_size

            query_xyz, _, query_label, _ = read_ply_cloud(data_path)
            tree = spatial.KDTree(pred[:, :3], leafsize=500)
            _, nearest = tree.query(query_xyz)
            ptc_pred = pred[nearest, 3].astype(int)

            np.savetxt(os.path.join(eval_path, f"{room_id}.txt"), ptc_pred, fmt="%i")
            cmap = self.SCANNET_COLOR_MAP
            write_ply(
                os.path.join(eval_path, f"{room_id}.ply"),
                query_xyz,
                np.array([cmap.get(int(p), (0, 0, 0)) for p in ptc_pred]),
            )
            mapped_pred = self.map_labels(ptc_pred)
            mapped_gt = self.map_labels(query_label)
            hist += fast_hist(mapped_pred, mapped_gt, num_labels)
        ious = per_class_iou(hist) * 100
        miou = float(np.nanmean(ious))
        print(f"Full-cloud mIoU: {miou:.2f}")
        return miou, ious


class ScannetVoxelization2cmDataset(ScannetVoxelizationDataset):
    VOXEL_SIZE = 0.02


class Scannet200VoxelizationDataset(ScannetVoxelizationDataset):
    NUM_CLASSES = 200
    VOXEL_SIZE = 0.05


class Scannet200Voxelization2cmDataset(Scannet200VoxelizationDataset):
    VOXEL_SIZE = 0.02
