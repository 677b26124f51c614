"""Data-efficient (limited supervision) split generation.

Counterpart of
``languagegroundedsemseg_tpu/data/preprocessing/data_efficient.py``; FPS is
the port's ``ops/points.furthest_point_sample`` on CPU tensors. The
per-scene rng is seeded with ``abs(hash(name))`` as in the JAX file, so
``by_points`` output depends on ``PYTHONHASHSEED`` (set it to reproduce a
split across processes).

Equivalent of the reference's data-efficient experiments
(downstream/insseg/scripts/data_efficient/by_points.sh, by_scenes.sh):
- by_points: keep labels on only N annotated points per scene (the official
  ScanNet data-efficient benchmark's sampled_inds), FPS-spread so annotations
  cover the scene;
- by_scenes: keep only a fraction of fully-annotated scenes.

Outputs a pickle {scene_name: kept point indices} consumed by
insseg.dataset.InstanceVoxelizationDataset.sampled_inds, or a scene-list txt.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from pathlib import Path

import numpy as np


def sample_points_per_scene(scene_paths, points_per_scene: int, seed: int = 0, use_fps: bool = True):
    import torch

    out = {}
    for p in scene_paths:
        data = torch.load(p, weights_only=False)
        xyz = np.asarray(data[0])
        name = Path(p).stem
        rng = np.random.default_rng((seed, abs(hash(name)) % (2 ** 31)))
        k = min(points_per_scene, len(xyz))
        if use_fps:
            from languagegroundedsemseg_torch.ops.points import furthest_point_sample

            # subsample for FPS tractability on huge scenes
            cand = rng.choice(len(xyz), min(len(xyz), 50_000), replace=False)
            sel = furthest_point_sample(torch.as_tensor(xyz[cand]), k).numpy()
            out[name] = cand[sel]
        else:
            out[name] = rng.choice(len(xyz), k, replace=False)
    return out


def sample_scenes(scene_paths, fraction: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = max(int(round(len(scene_paths) * fraction)), 1)
    keep = rng.choice(len(scene_paths), n, replace=False)
    return [scene_paths[i] for i in sorted(keep)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="dir of .pth scenes")
    ap.add_argument("--output", required=True)
    ap.add_argument("--mode", choices=["by_points", "by_scenes"], required=True)
    ap.add_argument("--points", type=int, default=200, help="points per scene")
    ap.add_argument("--fraction", type=float, default=0.1, help="scene fraction")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    paths = sorted(glob.glob(os.path.join(args.input, "*.pth")))
    if args.mode == "by_points":
        inds = sample_points_per_scene(paths, args.points, args.seed)
        with open(args.output, "wb") as f:
            pickle.dump(inds, f)
        print(f"wrote sampled_inds for {len(inds)} scenes -> {args.output}")
    else:
        keep = sample_scenes(paths, args.fraction, args.seed)
        with open(args.output, "w") as f:
            f.write("\n".join(Path(p).stem for p in keep) + "\n")
        print(f"wrote {len(keep)} scene names -> {args.output}")


if __name__ == "__main__":
    main()
