"""The benchmark's raw scenes: a frozen copy of the port's synthetic scene
generator and the heavy-tailed scene sizes the traffic draws from.

``synthetic_scene`` is copied from ``languagegroundedsemseg_torch/data/
synthetic.py`` so that a later change to the program cannot change the
benchmark's inputs. It builds ScanNet-like rooms (floor, walls, box
furniture, scan clutter) whose 2 cm voxelization has real-scan kernel-map
occupancy.

Scene sizes follow a clipped log-normal law that the traffic file states
(``scene_points``: ``median``, ``log_sigma``, ``min``, ``max``). A pool of
``n`` scenes takes the n stratified quantiles of that law, so every seed
draws the same set of sizes; the seed only orders them and shapes the
rooms.

The capacity envelope (``envelope_sizes``) is one batch that takes the
largest size of each stratum, scaled up: in set-up the port's builder
builds it first, so its capacities, not the seed's scenes, set how far
every batch is padded.
"""

from __future__ import annotations

import statistics

import numpy as np

def pool_sizes(n: int, law: dict) -> np.ndarray:
    """The n stratified quantiles of the scene-size law, ascending."""
    nd = statistics.NormalDist()
    q = [law["median"] * np.exp(law["log_sigma"] * nd.inv_cdf((i + 0.5) / n))
         for i in range(n)]
    return np.clip(np.round(q), law["min"], law["max"]).astype(np.int64)


def stratified_order(n: int, batch: int, rng: np.random.Generator) -> np.ndarray:
    """Sizes (indices into ``pool_sizes(n)``) laid out so that every run of
    ``batch`` consecutive scenes takes one size from each of ``batch``
    strata: batches of equal expected work. Strata are ``n // batch``
    consecutive quantiles; the seed permutes within each stratum and the
    order of scenes inside a batch."""
    per = n // batch
    if per * batch != n:
        raise ValueError(f"pool of {n} scenes is not a whole number of "
                         f"{batch}-scene batches")
    strata = np.arange(n).reshape(batch, per)
    strata = np.stack([rng.permutation(s) for s in strata])  # (batch, per)
    out = np.empty(n, np.int64)
    for j in range(per):
        out[j * batch:(j + 1) * batch] = rng.permutation(strata[:, j])
    return out


def envelope_sizes(n: int, batch: int, law: dict, scale: float) -> np.ndarray:
    """The capacity envelope's scene sizes: the largest of each of the
    ``batch`` strata of ``pool_sizes(n)``, times ``scale``."""
    top = pool_sizes(n, law).reshape(batch, n // batch)[:, -1]
    return np.round(top * scale).astype(np.int64)


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

