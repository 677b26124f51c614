"""S3DIS (Stanford3dDataset) preprocessing -> per-room labeled .ply + splits.

Counterpart of ``languagegroundedsemseg_tpu/data/preprocessing/stanford.py``
(numpy and the port's PLY IO; the same files from the same rooms).

    python -m languagegroundedsemseg_torch.data.preprocessing.stanford \
        --input /data/Stanford3dDataset_v1.2_Aligned_Version --output /data/s3dis

The reference consumes pre-made plys through lib/datasets/stanford.py (the
conversion itself lives upstream in the SpatioTemporalSegmentation lineage);
this reproduces that recipe: walk Area_*/<room>/Annotations/*.txt instance
files (lines "x y z r g b"), label each instance by its filename's class
token in the alphabetical 14-class id space (data/stanford.py:CLASSES,
stairs=10 later ignored), concatenate per room, save binary .ply with a
label channel, and write the Area-5 split lists the datasets expect
(DATA_PATH_FILE: area1245.txt / area5.txt / trainval.txt).

Known data quirks handled: malformed numeric tokens in a few annotation
files (e.g. Area_5/hallway_6) are coerced and dropped with a warning.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from languagegroundedsemseg_torch.data.stanford import CLASSES
from languagegroundedsemseg_torch.utils.ply import write_ply

CLASS_TO_ID = {c: i for i, c in enumerate(CLASSES)}
CLUTTER_ID = CLASS_TO_ID["clutter"]


def _read_annotation_txt(path: str) -> np.ndarray:
    """(N, 6) float array; malformed rows dropped."""
    try:
        arr = np.loadtxt(path, dtype=np.float64, ndmin=2)
        if arr.shape[1] >= 6:
            return arr[:, :6]
    except ValueError:
        pass
    # slow path: coerce token-by-token (S3DIS ships a few corrupt chars)
    rows = []
    bad = 0
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            try:
                rows.append([float(p) for p in parts[:6]])
            except ValueError:
                bad += 1
    if bad:
        print(f"  {path}: dropped {bad} malformed lines")
    return np.asarray(rows, np.float64).reshape(-1, 6)


def process_room(room_dir: str, out_path: str) -> int:
    """Concatenate a room's annotation instances into one labeled ply."""
    ann_files = sorted(glob.glob(os.path.join(room_dir, "Annotations", "*.txt")))
    if not ann_files:
        return 0
    pts, labels = [], []
    for f in ann_files:
        cls = os.path.basename(f).split("_")[0].lower()
        cid = CLASS_TO_ID.get(cls, CLUTTER_ID)
        arr = _read_annotation_txt(f)
        if not len(arr):
            continue
        pts.append(arr)
        labels.append(np.full(len(arr), cid, np.int32))
    if not pts:
        return 0
    pts = np.concatenate(pts)
    labels = np.concatenate(labels)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    write_ply(
        out_path,
        pts[:, :3].astype(np.float32),
        pts[:, 3:6].astype(np.uint8),
        labels,
    )
    return len(pts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True,
                    help="Stanford3dDataset_v1.2_Aligned_Version root")
    ap.add_argument("--output", required=True, help="output dataset root")
    args = ap.parse_args(argv)

    rel_paths = []
    for area_dir in sorted(glob.glob(os.path.join(args.input, "Area_*"))):
        area = os.path.basename(area_dir)
        for room_dir in sorted(glob.glob(os.path.join(area_dir, "*"))):
            if not os.path.isdir(room_dir):
                continue
            room = os.path.basename(room_dir)
            rel = os.path.join(area, f"{room}.ply")
            n = process_room(room_dir, os.path.join(args.output, rel))
            if n:
                rel_paths.append(rel)
                print(f"{rel}: {n} points")

    splits = {
        "area1245.txt": [p for p in rel_paths if not p.startswith("Area_5")],
        "area5.txt": [p for p in rel_paths if p.startswith("Area_5")],
        "trainval.txt": rel_paths,
        "train.txt": [p for p in rel_paths if not p.startswith("Area_5")],
        "val.txt": [p for p in rel_paths if p.startswith("Area_5")],
        "test.txt": [p for p in rel_paths if p.startswith("Area_5")],
    }
    for name, paths in splits.items():
        with open(os.path.join(args.output, name), "w") as f:
            f.write("\n".join(paths) + "\n")
    print(f"{len(rel_paths)} rooms; splits written to {args.output}")


if __name__ == "__main__":
    main()
