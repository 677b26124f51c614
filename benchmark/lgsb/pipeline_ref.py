"""Plain reference of the training data path: what the port's dataset and
loader must hand the step, worked out again from the raw scene and the
seed.

Frozen copies of the port's per-scene pipeline (``data/dataset.py``
``get_item``, ``data/transforms.py``, ``data/voxelizer.py``, the
``quantize`` of ``sparse/graph_host.py``) and of the loader's per-scene
generator, epoch order and wire format (``data/loader.py``), as the
reference trainer defines them (reference lib/dataset.py, lib/transforms.py,
lib/voxelizer.py). NumPy and SciPy only: the same operations in the same
order, so a sound port gives the same voxels, colours and labels to the
bit.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate
import scipy.ndimage

VOXEL_SIZE = 0.02
SCALE_BOUND = (0.9, 1.1)
ROTATION_BOUND = ((-np.pi / 64, np.pi / 64), (-np.pi / 64, np.pi / 64),
                  (-np.pi, np.pi))
ELASTIC_PARAMS = ((0.2, 0.4), (0.8, 1.6))
COLOR_TRANS_RATIO, COLOR_JITTER_STD = 0.10, 0.05


def _elastic(rng, coords, granularity, magnitude):
    blurs = [np.ones((3, 1, 1, 1), np.float32) / 3,
             np.ones((1, 3, 1, 1), np.float32) / 3,
             np.ones((1, 1, 3, 1), np.float32) / 3]
    cmin = coords.min(0)
    dim = ((coords - cmin).max(0) // granularity).astype(int) + 3
    noise = rng.standard_normal(size=(*dim, 3)).astype(np.float32)
    for _ in range(2):
        for b in blurs:
            noise = scipy.ndimage.convolve(noise, b, mode="constant", cval=0)
    ax = [np.linspace(lo, hi, d) for lo, hi, d in
          zip(cmin - granularity, cmin + granularity * (dim - 2), dim)]
    interp = scipy.interpolate.RegularGridInterpolator(
        ax, noise, bounds_error=False, fill_value=0)
    return coords + interp(coords) * magnitude


def _rotation(axis, theta):
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0 or theta == 0:
        return np.eye(3)
    axis = axis / n
    a = np.cos(theta / 2.0)
    b, c, d = -axis * np.sin(theta / 2.0)
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
        [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
        [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
    ]).T


def _pack(c):
    """(N, 4) (b, x, y, z) -> int64 keys, 16 bits a field."""
    c = np.asarray(c, np.int64)
    xyz = c[:, 1:] + (1 << 15)
    if xyz.size and (xyz.min() < 0 or xyz.max() > 0xFFFF):
        raise ValueError("coordinates out of [-32768, 32767]")
    return (c[:, 0] << 48) | (xyz[:, 0] << 32) | (xyz[:, 1] << 16) | xyz[:, 2]


def first_per_voxel(vc):
    """Index of the first point of each occupied voxel, in key order."""
    c = np.concatenate([np.zeros((len(vc), 1), vc.dtype), vc], axis=1)
    return np.unique(_pack(c), return_index=True)[1]


def voxelized_scene(xyz, rgb, labels, rng):
    """One training scene through the augmentation and voxelization:
    (coords int32 (M, 3), feats f32 (M, 3) raw colours, labels i32 (M,))."""
    coords, feats = xyz.astype(np.float64), rgb.astype(np.float32)
    # elastic distortion (prevoxel), p = 0.95
    if rng.random() < 0.95:
        for g, m in ELASTIC_PARAMS:
            coords = _elastic(rng, coords, g, m)
    # voxelizer: rotation about each axis (shuffled), scale, floor, dedup
    mats = []
    for i, bound in enumerate(ROTATION_BOUND):
        axis = np.zeros(3)
        axis[i] = 1
        mats.append(_rotation(axis, rng.uniform(*bound)))
    rng.shuffle(mats)
    rot4 = np.eye(4)
    rot4[:3, :3] = mats[0] @ mats[1] @ mats[2]
    vox = np.eye(4)
    np.fill_diagonal(vox[:3, :3], (1.0 / VOXEL_SIZE) * rng.uniform(*SCALE_BOUND))
    rigid = rot4 @ vox
    homo = np.hstack([coords, np.ones((len(coords), 1), coords.dtype)])
    vc = np.floor(homo @ rigid.T[:, :3]).astype(np.int32)
    keep = first_per_voxel(vc)
    vc, feats, labels = vc[keep], feats[keep], labels[keep]
    # horizontal flips of x and y, p = 0.95 then 0.5 an axis
    if rng.random() < 0.95:
        vc = vc.copy()
        for ax in (0, 1):
            if rng.random() < 0.5:
                vc[:, ax] = vc[:, ax].max() - vc[:, ax]
    # chromatic auto-contrast, p = 0.2
    if rng.random() < 0.2:
        lo = feats[:, :3].min(0, keepdims=True)
        hi = feats[:, :3].max(0, keepdims=True)
        if hi.max() > 1:
            stretched = (feats[:, :3] - lo) * (255 / np.maximum(hi - lo, 1e-6))
            blend = rng.random()
            feats = feats.copy()
            feats[:, :3] = (1 - blend) * feats[:, :3] + blend * stretched
    # chromatic translation, p = 0.95
    if rng.random() < 0.95:
        tr = (rng.random((1, 3)) - 0.5) * 255 * 2 * COLOR_TRANS_RATIO
        feats = feats.copy()
        feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
    # chromatic jitter, p = 0.95
    if rng.random() < 0.95:
        noise = rng.standard_normal((feats.shape[0], 3)) * COLOR_JITTER_STD * 255
        feats = feats.copy()
        feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
    return (vc.astype(np.int32), feats.astype(np.float32),
            np.asarray(labels, np.int32))


def batched(coords) -> np.ndarray:
    """Scenes' voxel coordinates stacked as (N, 4) int64 (scene, x, y, z)."""
    return np.concatenate([np.concatenate(
        [np.full((len(c), 1), b, np.int64), np.asarray(c, np.int64)], 1)
        for b, c in enumerate(coords)])


def scene_rng(seed: int, batch_counter: int, j: int) -> np.random.Generator:
    """The generator of the j-th scene of the loader's batch_counter-th
    batch."""
    return np.random.default_rng((seed, batch_counter, j))


def epoch_order(seed: int, epoch: int, n: int, shuffle: bool) -> np.ndarray:
    order = np.arange(n)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    return order


def batch_indices(seed: int, n: int, batch: int, shuffle: bool, k: int):
    """Dataset indices of the loader's k-th batch (one rank, epochs padded
    by wrap-around to whole batches)."""
    per_epoch = -(-n // batch)
    epoch, pos = divmod(k, per_epoch)
    order = np.resize(epoch_order(seed, epoch, n, shuffle), per_epoch * batch)
    return [int(i) for i in order[pos * batch:(pos + 1) * batch]]


def wire_feats(scenes_feats):
    """The batch's colours as the loader ships them and as the step reads
    them: (wire, feats). When every scene's colours lie in [0, 255] the
    wire holds them rounded to uint8 and the step reads c / 255 - 0.5;
    otherwise the wire holds c / 255 - 0.5 in float16."""
    as_uint8 = all(f.size == 0 or (f.min() >= 0.0 and f.max() <= 255.0)
                   for f in scenes_feats)
    f = np.concatenate([s[:, :3] for s in scenes_feats])
    if as_uint8:
        wire = np.round(f).astype(np.uint8)
        return wire, wire.astype(np.float32) / 255.0 - 0.5
    wire = (f / 255.0 - 0.5).astype(np.float16)
    return wire, wire.astype(np.float32)
