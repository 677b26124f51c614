"""Pinhole camera: project / backproject point clouds and depth maps.

Counterpart of ``languagegroundedsemseg_tpu/utils/camera.py``, copied (numpy
only).

Parity with reference lib/pc_utils.py:134-260 Camera (whose ``project`` was
left NotImplementedError — implemented here), kept host-side numpy: this
supports visualization and RGB-D ingestion tooling, not the training path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class Camera:
    def __init__(self, intrinsics: Dict[str, float]):
        self.intrinsics = intrinsics
        self.camera_matrix = self.build_camera_matrix(intrinsics)
        self.K_inv = np.linalg.inv(self.camera_matrix)

    @staticmethod
    def build_camera_matrix(intrinsics: Dict[str, float]) -> np.ndarray:
        """3x3 K from {focal_length, pp_x, pp_y} (HZ eq. 6.10)."""
        f = intrinsics["focal_length"]
        K = np.array(
            [[f, 0, intrinsics["pp_x"]], [0, f, intrinsics["pp_y"]], [0, 0, 1]],
            dtype=np.float32,
        )
        assert np.linalg.matrix_rank(K) == 3
        return K

    @staticmethod
    def extrinsics2RT(extrinsics: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Split a 4x4 extrinsics matrix into (R 3x3, T 3x1)."""
        assert extrinsics.shape == (4, 4)
        R = extrinsics[:3, :3].copy()
        T = extrinsics[3, :3].copy().reshape(3, 1)
        return R, T

    def world2camera(self, extrinsics: np.ndarray, points: np.ndarray) -> np.ndarray:
        R, T = self.extrinsics2RT(extrinsics)
        return (R @ points[:, :3].T + T).T

    def project(
        self, points_3d: np.ndarray, extrinsics: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """(N, 3) camera- or world-space points -> (N, 3) [u, v, depth]."""
        pts = points_3d[:, :3]
        if extrinsics is not None:
            pts = self.world2camera(extrinsics, pts)
        uvw = (self.camera_matrix @ pts.T).T
        z = uvw[:, 2:3]
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = np.where(z != 0, uvw[:, :2] / z, 0.0)
        return np.concatenate([uv, z], axis=1)

    def backproject(
        self,
        depth_map: np.ndarray,
        rgb_img: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        max_depth: Optional[float] = None,
        max_height: Optional[float] = None,
        min_height: Optional[float] = None,
        prune: bool = True,
    ) -> np.ndarray:
        """Depth map (H, W) -> (N, 6[+1]) XYZRGB[L] camera-space points.

        Points at depth 0 / 65535, beyond max_depth, or outside the height
        band are pruned (reference backproject semantics).
        """
        h, w = depth_map.shape[:2]
        if rgb_img is None:
            rgb_img = np.full((h, w, 3), 128, np.uint8)
        v, u = np.mgrid[0:h, 0:w]
        z = depth_map.astype(np.float32).reshape(-1)
        uv1 = np.stack([u.reshape(-1), v.reshape(-1), np.ones(h * w)], axis=0)
        xyz = (self.K_inv @ (uv1 * z)).T  # (N, 3)
        cols = [xyz, rgb_img.reshape(h * w, -1)[:, :3].astype(np.float32)]
        if labels is not None:
            cols.append(labels.reshape(h * w, -1)[:, :1].astype(np.float32))
        pts = np.concatenate(cols, axis=1)
        if not prune:
            return pts
        keep = (z > 0) & (z < 65535)
        if max_depth is not None:
            keep &= z <= max_depth
        y = xyz[:, 1]
        if max_height is not None:
            keep &= y <= max_height
        if min_height is not None:
            keep &= y >= min_height
        return pts[keep]
