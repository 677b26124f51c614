"""Voxelizer: augmentation matrix + floor quantization + dedup.

Counterpart of ``languagegroundedsemseg_tpu/data/voxelizer.py`` (:41-216);
``quantize`` is the port's copy in ``sparse/graph_host.py``.

Behavioral mirror of reference lib/voxelizer.py:13-239 with numpy Generators:
- random per-axis rotations composed in random order, scale jitter folded
  into the 1/voxel_size voxelization matrix (:44-74);
- optional spatial clip with translation jitter of the clip center (:76-106);
- floor(coords @ M^T) then first-occurrence dedup (:138-142);
- paired-view voxelization with per-category nearest-neighbor
  correspondences + patch dropout for SimSiam pretraining (:151-239).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import KDTree

from languagegroundedsemseg_torch.sparse.graph_host import quantize


def rotation_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation about `axis` by `theta` (reference uses
    expm(cross(eye, axis/norm * theta)), same result)."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0 or theta == 0:
        return np.eye(3)
    axis = axis / n
    a = np.cos(theta / 2.0)
    b, c, d = -axis * np.sin(theta / 2.0)
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
            [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
            [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
        ]
    ).T


class Voxelizer:
    def __init__(
        self,
        voxel_size: float = 1.0,
        clip_bound=None,
        use_augmentation: bool = False,
        scale_augmentation_bound: Optional[Tuple[float, float]] = None,
        rotation_augmentation_bound=None,
        translation_augmentation_ratio_bound=None,
        ignore_label: int = 255,
    ):
        self.voxel_size = voxel_size
        self.clip_bound = clip_bound
        self.ignore_label = ignore_label
        self.use_augmentation = use_augmentation
        self.scale_augmentation_bound = scale_augmentation_bound
        self.rotation_augmentation_bound = rotation_augmentation_bound
        self.translation_augmentation_ratio_bound = translation_augmentation_ratio_bound

    def get_transformation_matrix(self, rng: np.random.Generator):
        voxelization_matrix, rotation_matrix4 = np.eye(4), np.eye(4)
        rot = np.eye(3)
        if self.use_augmentation and self.rotation_augmentation_bound is not None:
            mats = []
            for axis_ind, rot_bound in enumerate(self.rotation_augmentation_bound):
                theta = 0.0
                axis = np.zeros(3)
                axis[axis_ind] = 1
                if rot_bound is not None:
                    theta = rng.uniform(*rot_bound)
                mats.append(rotation_matrix(axis, theta))
            rng.shuffle(mats)
            rot = mats[0] @ mats[1] @ mats[2]
        rotation_matrix4[:3, :3] = rot
        scale = 1.0 / self.voxel_size
        if self.use_augmentation and self.scale_augmentation_bound is not None:
            scale *= rng.uniform(*self.scale_augmentation_bound)
        np.fill_diagonal(voxelization_matrix[:3, :3], scale)
        return voxelization_matrix, rotation_matrix4

    def clip(self, coords, center=None, trans_aug_ratio=None):
        bound_min = coords.min(0).astype(float)
        bound_max = coords.max(0).astype(float)
        bound_size = bound_max - bound_min
        if center is None:
            center = bound_min + bound_size * 0.5
        if trans_aug_ratio is not None:
            center = center + trans_aug_ratio * bound_size
        lim = self.clip_bound
        if isinstance(lim, (int, float)):
            if bound_size.max() < lim:
                return None
            return (
                (coords[:, 0] >= -lim + center[0]) & (coords[:, 0] < lim + center[0])
                & (coords[:, 1] >= -lim + center[1]) & (coords[:, 1] < lim + center[1])
                & (coords[:, 2] >= -lim + center[2]) & (coords[:, 2] < lim + center[2])
            )
        return (
            (coords[:, 0] >= lim[0][0] + center[0]) & (coords[:, 0] < lim[0][1] + center[0])
            & (coords[:, 1] >= lim[1][0] + center[1]) & (coords[:, 1] < lim[1][1] + center[1])
            & (coords[:, 2] >= lim[2][0] + center[2]) & (coords[:, 2] < lim[2][1] + center[2])
        )

    def _clip_if_needed(self, rng, coords, feats, labels):
        if self.clip_bound is None:
            return coords, feats, labels
        trans_aug_ratio = np.zeros(3)
        if self.use_augmentation and self.translation_augmentation_ratio_bound is not None:
            for axis_ind, bound in enumerate(self.translation_augmentation_ratio_bound):
                trans_aug_ratio[axis_ind] = rng.uniform(*bound)
        inds = self.clip(coords, None, trans_aug_ratio)
        if inds is not None:
            coords, feats = coords[inds], feats[inds]
            if labels is not None:
                labels = labels[inds]
        return coords, feats, labels

    def voxelize(self, rng, coords, feats, labels, augment: bool = True):
        """-> (voxel_coords int32 (M,3), feats (M,F), labels (M,),
        (M_voxelization, M_rotation))."""
        assert coords.shape[1] == 3 and coords.shape[0] == feats.shape[0] and coords.shape[0]
        coords, feats, labels = self._clip_if_needed(rng, coords, feats, labels)

        m_v, m_r = self.get_transformation_matrix(rng)
        rigid = m_v
        if augment and self.use_augmentation:
            rigid = m_r @ rigid
        homo = np.hstack([coords, np.ones((len(coords), 1), coords.dtype)])
        coords_aug = np.floor(homo @ rigid.T[:, :3]).astype(np.int32)

        keep = quantize(coords_aug)
        return coords_aug[keep], feats[keep], (labels[keep] if labels is not None else None), (m_v, m_r)

    def voxelize_pair(
        self,
        rng,
        coords,
        feats,
        labels,
        dropout_ratio: float = 0.3,
        dropout_patch_point_num: int = 30,
    ):
        """Two independently-augmented voxelized views with per-category
        nearest-neighbor correspondences, with random patch dropout on each
        view (reference :151-239). Returns two
        (coords, feats, labels, transform, corrs) tuples; corrs index into
        the *other* view's rows."""
        coords, feats, labels = self._clip_if_needed(rng, coords, feats, labels)

        views = []
        for _ in range(2):
            m_v, m_r = self.get_transformation_matrix(rng)
            rigid = m_r @ m_v if self.use_augmentation else m_v
            homo = np.hstack([coords, np.ones((len(coords), 1), coords.dtype)])
            aug = np.floor(homo @ rigid.T[:, :3]).astype(np.int32)
            keep = np.sort(quantize(aug))
            views.append(dict(aug=aug, keep=keep, transform=(m_v, m_r)))

        k0, k1 = views[0]["keep"], views[1]["keep"]
        n0, n1 = len(k0), len(k1)

        # Per-category nearest-neighbor correspondences in the *original*
        # point space (mirrors reference :169-186).
        corrs0 = np.zeros(n0, dtype=np.int64)
        corrs1 = np.zeros(n1, dtype=np.int64)
        lab0, lab1 = labels[k0], labels[k1]
        for target in np.unique(labels):
            t0 = np.flatnonzero(lab0 == target)
            t1 = np.flatnonzero(lab1 == target)
            if len(t0) == 0 or len(t1) == 0:
                continue
            tree0 = KDTree(coords[k0[t0]])
            tree1 = KDTree(coords[k1[t1]])
            _, c0 = tree1.query(coords[k0[t0]], k=1)
            _, c1 = tree0.query(coords[k1[t1]], k=1)
            corrs0[t0] = t1[c0]
            corrs1[t1] = t0[c1]

        out = []
        masks = []
        for vi, (keep, corrs) in enumerate([(k0, corrs0), (k1, corrs1)]):
            aug = views[vi]["aug"][keep]
            if dropout_ratio > 0:
                tree = KDTree(aug)
                seed_num = round(len(aug) * dropout_ratio / dropout_patch_point_num)
                seeds = rng.choice(len(aug), size=min(seed_num, len(aug)), replace=False)
                if len(seeds):
                    _, drop = tree.query(aug[seeds], k=min(dropout_patch_point_num, len(aug)))
                    drop = np.unique(np.asarray(drop).ravel())
                else:
                    drop = np.empty(0, dtype=int)
                mask = np.ones(len(aug), dtype=bool)
                mask[drop] = False
            else:
                mask = np.ones(len(aug), dtype=bool)
            masks.append(mask)

        # Remap correspondences through the dropout compactions.
        new_index = []
        for mask in masks:
            ni = np.cumsum(mask) - 1  # position after compaction
            new_index.append(ni)

        for vi, (keep, corrs, mask) in enumerate(
            [(k0, corrs0, masks[0]), (k1, corrs1, masks[1])]
        ):
            other = 1 - vi
            aug = views[vi]["aug"][keep][mask]
            f = feats[keep][mask]
            l = labels[keep][mask] if labels is not None else None
            c = new_index[other][corrs[mask]]  # may point at dropped rows of
            # the other view; mark those invalid with -1
            dropped = ~masks[other][corrs[mask]]
            c = np.where(dropped, -1, c)
            out.append((aug, f, l, views[vi]["transform"], c.astype(np.int64)))
        return tuple(out)
