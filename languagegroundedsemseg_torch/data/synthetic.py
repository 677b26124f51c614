"""Synthetic indoor-scene point clouds for tests and benchmarks.

Produces ScanNet-like geometry — floor + walls + box 'furniture' with
per-surface colors, labels and instance ids — so kernels and the input
pipeline can be exercised and benchmarked at realistic voxel occupancy
without the dataset on disk.

Surfaces are rasterized on a jittered sub-voxel grid (~1 cm spacing for
2 cm voxels) so that, like real fused RGB-D meshes, they quantize into
*contiguous* voxel shells; random elliptical holes and scan clutter then
bring kernel-map occupancy down to real-scan statistics. Measured at
180k points/scene: ~105k voxels/scene, k3 kernel fill ~0.39 and ~1.6
missing-center z-gap entries per voxel, versus ~0.35 fill measured for
preprocessed ScanNet at 2 cm (reference lib/datasets/scannet.py:442
VOXEL_SIZE) — the previous random-sampled generator measured 0.20 fill,
i.e. a workload dominated by pathological isolated voxels.
"""

from __future__ import annotations

import numpy as np


def _raster_surface(rng, origin, u_vec, v_vec, step=0.011, jitter=0.0025,
                    hole_frac=0.22):
    """Points covering a parallelogram on a jittered grid, with random
    elliptical holes removing ~hole_frac of the area (scan shadows)."""
    lu = float(np.linalg.norm(u_vec))
    lv = float(np.linalg.norm(v_vec))
    nu = max(int(lu / step), 1)
    nv = max(int(lv / step), 1)
    uu, vv = np.meshgrid((np.arange(nu) + 0.5) / nu,
                         (np.arange(nv) + 0.5) / nv, indexing="ij")
    uu = uu.reshape(-1)
    vv = vv.reshape(-1)
    if hole_frac > 0 and nu * nv > 64:
        keep = np.ones(uu.shape[0], bool)
        target = hole_frac * lu * lv
        removed = 0.0
        for _ in range(8):
            if removed >= target:
                break
            cu, cv = rng.random(2)
            ru = (0.05 + 0.2 * rng.random())
            rv = (0.05 + 0.2 * rng.random())
            hole = ((uu - cu) / ru) ** 2 + ((vv - cv) / rv) ** 2 < 1.0
            keep &= ~hole
            removed += np.pi * ru * lu * rv * lv
        uu, vv = uu[keep], vv[keep]
    pts = (origin[None, :] + uu[:, None] * u_vec[None, :]
           + vv[:, None] * v_vec[None, :])
    return pts + rng.normal(0, jitter, pts.shape)


def synthetic_scene(
    rng: np.random.Generator,
    num_points: int = 120_000,
    extent: float = 6.0,
    height: float = 2.6,
    num_objects: int = 12,
    num_classes: int = 200,
    noise: float = 0.001,
    return_instances: bool = False,
):
    """Returns (xyz float32 (N,3) meters, rgb float32 (N,3) in [0,255],
    labels int32 (N,)) and, if return_instances, per-point instance ids
    (walls/floor = -1, each furniture box its own id).

    ``num_points`` scales the room dimensions (surface density is fixed
    by the rasterization step) and bounds the returned point count.
    """
    # surface area that yields ~num_points at the raster density
    step = 0.011
    target_area = num_points * step * step
    scale = np.sqrt(target_area / (extent * extent + 4 * extent * height
                                   + num_objects * 0.9))
    ex = extent * scale * (0.85 + 0.3 * rng.random())
    ey = extent * scale * (0.85 + 0.3 * rng.random())
    hz = min(height, height * scale * 1.6 + 0.4)
    parts = []

    z0 = np.zeros(3)
    wall_specs = [
        (z0, np.array([ex, 0, 0]), np.array([0, ey, 0]), 1),      # floor
        (z0, np.array([ex, 0, 0]), np.array([0, 0, hz]), 0),
        (np.array([0.0, ey, 0.0]), np.array([ex, 0, 0]), np.array([0, 0, hz]), 0),
        (z0, np.array([0, ey, 0]), np.array([0, 0, hz]), 0),
        (np.array([ex, 0.0, 0.0]), np.array([0, ey, 0]), np.array([0, 0, hz]), 0),
    ]
    for o, u, v, lab in wall_specs:
        pts = _raster_surface(rng, o, u, v)
        col = np.full((len(pts), 3), 140.0) + rng.normal(0, 12, (len(pts), 3))
        parts.append((pts, col, np.full(len(pts), lab, np.int32),
                      np.full(len(pts), -1, np.int32)))

    for obj_id in range(num_objects):
        size = (np.array([0.25, 0.25, 0.18]) * (scale + 0.5)
                + rng.random(3) * np.array([0.8, 0.8, 0.7]) * (scale + 0.3))
        size = np.minimum(size, [max(ex - 0.1, 0.2), max(ey - 0.1, 0.2), hz])
        pos = np.array([rng.random() * max(ex - size[0], 0.05),
                        rng.random() * max(ey - size[1], 0.05), 0.0])
        lab = int(rng.integers(2, num_classes))
        base_col = rng.random(3) * 255.0
        faces = [
            (pos + np.array([0, 0, size[2]]), np.array([size[0], 0, 0]), np.array([0, size[1], 0])),
            (pos, np.array([size[0], 0, 0]), np.array([0, 0, size[2]])),
            (pos + np.array([0, size[1], 0]), np.array([size[0], 0, 0]), np.array([0, 0, size[2]])),
            (pos, np.array([0, size[1], 0]), np.array([0, 0, size[2]])),
            (pos + np.array([size[0], 0, 0]), np.array([0, size[1], 0]), np.array([0, 0, size[2]])),
        ]
        for o, u, v in faces:
            pts = _raster_surface(rng, o, u, v)
            col = base_col[None, :] + rng.normal(0, 8, (len(pts), 3))
            parts.append((pts, col, np.full(len(pts), lab, np.int32),
                          np.full(len(pts), obj_id, np.int32)))

    # scan clutter: isolated fuzz (sensor noise / small unscanned objects)
    n_clutter = max(num_points // 50, 16)
    pts = rng.random((n_clutter, 3)) * np.array([ex, ey, hz])
    parts.append((pts, rng.random((n_clutter, 3)) * 255.0,
                  rng.integers(0, num_classes, n_clutter).astype(np.int32),
                  np.full(n_clutter, -1, np.int32)))

    xyz = np.concatenate([p[0] for p in parts]).astype(np.float32)
    rgb = np.clip(np.concatenate([p[1] for p in parts]), 0, 255).astype(np.float32)
    labels = np.concatenate([p[2] for p in parts]).astype(np.int32)
    inst = np.concatenate([p[3] for p in parts]).astype(np.int32)
    xyz += rng.normal(0, noise, xyz.shape).astype(np.float32)

    perm = rng.permutation(len(xyz))[:num_points]
    if return_instances:
        return xyz[perm], rgb[perm], labels[perm], inst[perm]
    return xyz[perm], rgb[perm], labels[perm]


def voxelize_scene(rng, num_points, voxel_size=0.02, raw_color=False):
    """One synthetic scene quantized to ``voxel_size`` voxels: (voxel
    coords int32 (N, 3), feats, labels) with one row per occupied voxel.

    Feats are colors normalized to [-0.5, 0.5] as float32, or the raw uint8
    colors of the production wire format (``raw_color=True``; the eval step
    normalizes them on the device, ``TrainBatch.decompact``)."""
    from languagegroundedsemseg_torch.sparse.graph_host import quantize

    xyz, rgb, labels = synthetic_scene(rng, num_points=num_points)
    vc = np.floor(xyz / voxel_size).astype(np.int32)
    keep = quantize(vc)
    if raw_color:
        return vc[keep], rgb[keep].astype(np.uint8), labels[keep]
    return vc[keep], (rgb[keep] / 255.0 - 0.5).astype(np.float32), labels[keep]
