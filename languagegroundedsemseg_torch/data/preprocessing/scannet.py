"""Offline preprocessing: raw ScanNet scans -> training-ready files.

Counterpart of ``languagegroundedsemseg_tpu/data/preprocessing/scannet.py``:
the same outputs from the same scans; FPS is the port's
``ops/points.furthest_point_sample`` on CPU tensors.

Behavioral mirror of reference lib/datasets/preprocessing/scannet_long.py and
scannet200_insseg.py:
- semseg: _vh_clean_2.ply + .segs.json + .aggregation.json (+ axis-align
  matrix from the scene .txt) -> labeled .ply with per-point label and
  instance id; optional limited-annotation mode keeps labels on only
  ``ratio_of_annotated`` FPS-sampled points per instance (reference
  :99-104 uses the CUDA FPS; here the port's torch FPS on the CPU);
- optional export of tail-category instance .plys into the instance library
  the tail-resampling path consumes (:112-121);
- insseg: -> (points, colors, semantic, instance) .pth tuples (torch.save).

Run: python -m languagegroundedsemseg_torch.data.preprocessing.scannet
       --input /path/ScanNet/scans --output /path/processed --mode semseg
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from languagegroundedsemseg_torch.utils.ply import read_ply, write_ply


def read_axis_align_matrix(scene_txt: str):
    if not os.path.isfile(scene_txt):
        return None
    with open(scene_txt) as f:
        for line in f:
            if line.startswith("axisAlignment"):
                vals = [float(v) for v in line.split("=")[1].split()]
                return np.array(vals).reshape(4, 4)
    return None


def point_indices_from_group(seg_indices: np.ndarray, group: dict) -> np.ndarray:
    """Segment ids -> point indices (reference preprocessing/utils.py:11)."""
    segs = set(group["segments"])
    return np.flatnonzero(np.isin(seg_indices, list(segs)))


def load_scene(scene_dir: str, label_mapper=None):
    """-> (xyz, rgb, labels (raw ids), instance_ids)."""
    scene = Path(scene_dir).name
    ply_path = os.path.join(scene_dir, f"{scene}_vh_clean_2.ply")
    segs_path = os.path.join(scene_dir, f"{scene}_vh_clean_2.0.010000.segs.json")
    agg_path = os.path.join(scene_dir, f"{scene}.aggregation.json")
    meta_path = os.path.join(scene_dir, f"{scene}.txt")

    d = read_ply(ply_path)
    xyz = np.stack([d["x"], d["y"], d["z"]], 1).astype(np.float64)
    rgb = np.stack([d["red"], d["green"], d["blue"]], 1).astype(np.float32)

    align = read_axis_align_matrix(meta_path)
    if align is not None:
        homo = np.hstack([xyz, np.ones((len(xyz), 1))])
        xyz = (homo @ align.T)[:, :3]

    labels = np.zeros(len(xyz), dtype=np.int32)
    instance_ids = np.full(len(xyz), -1, dtype=np.int32)
    if os.path.isfile(segs_path) and os.path.isfile(agg_path):
        with open(segs_path) as f:
            seg_indices = np.asarray(json.load(f)["segIndices"])
        with open(agg_path) as f:
            groups = json.load(f)["segGroups"]
        for g in groups:
            inds = point_indices_from_group(seg_indices, g)
            raw = g["label"]
            lab = label_mapper(raw) if label_mapper is not None else 0
            labels[inds] = lab
            instance_ids[inds] = g.get("id", g.get("objectId", -1))
    return xyz.astype(np.float32), rgb, labels, instance_ids


def make_raw_label_mapper(labels_tsv: str, target: str = "id"):
    """scannetv2-labels.combined.tsv: raw category text -> benchmark id."""
    mapping = {}
    with open(labels_tsv) as f:
        header = f.readline().rstrip("\n").split("\t")
        col = header.index(target)
        raw_col = header.index("raw_category")
        for line in f:
            parts = line.rstrip("\n").split("\t")
            try:
                mapping[parts[raw_col]] = int(parts[col])
            except (ValueError, IndexError):
                continue
    return lambda raw: mapping.get(raw, 0)


def limited_annotation_mask(xyz, instance_ids, ratio: float, rng):
    """Keep labels on only an FPS-sampled fraction of each instance
    (reference scannet_long.py:99-104)."""
    import torch

    from languagegroundedsemseg_torch.ops.points import furthest_point_sample

    keep = np.zeros(len(xyz), dtype=bool)
    for iid in np.unique(instance_ids):
        if iid < 0:
            continue
        inds = np.flatnonzero(instance_ids == iid)
        k = max(int(round(len(inds) * ratio)), 1)
        if k >= len(inds):
            keep[inds] = True
            continue
        sel = furthest_point_sample(torch.as_tensor(xyz[inds]), k).numpy()
        keep[inds[sel]] = True
    return keep


def process_scene_semseg(
    scene_dir: str,
    out_dir: str,
    label_mapper,
    ratio_of_annotated: float = 1.0,
    export_instances_dir: str | None = None,
    tail_raw_ids=None,
    seed: int = 0,
):
    scene = Path(scene_dir).name
    xyz, rgb, labels, inst = load_scene(scene_dir, label_mapper)
    rng = np.random.default_rng(seed)

    if ratio_of_annotated < 1.0:
        keep = limited_annotation_mask(xyz, inst, ratio_of_annotated, rng)
        labels = np.where(keep, labels, 0)

    os.makedirs(out_dir, exist_ok=True)
    _write_labeled_ply(os.path.join(out_dir, f"{scene}.ply"), xyz, rgb, labels, inst)

    if export_instances_dir and tail_raw_ids:
        for iid in np.unique(inst):
            if iid < 0:
                continue
            mask = inst == iid
            lab = int(np.bincount(labels[mask]).argmax())
            if lab in tail_raw_ids:
                d = os.path.join(export_instances_dir, str(lab))
                os.makedirs(d, exist_ok=True)
                write_ply(
                    os.path.join(d, f"{scene}_{iid}.ply"), xyz[mask], rgb[mask], labels[mask]
                )
    return scene


def _write_labeled_ply(path, xyz, rgb, labels, instance_ids):
    rec = np.empty(
        len(xyz),
        dtype=np.dtype(
            [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
             ("blue", "u1"), ("label", "<i4"), ("instance_id", "<i4")]
        ),
    )
    rec["x"], rec["y"], rec["z"] = xyz.T
    c = np.clip(rgb, 0, 255).astype(np.uint8)
    rec["red"], rec["green"], rec["blue"] = c.T
    rec["label"] = labels
    rec["instance_id"] = instance_ids
    with open(path, "wb") as f:
        hdr = [
            "ply", "format binary_little_endian 1.0", f"element vertex {len(xyz)}",
            "property float x", "property float y", "property float z",
            "property uchar red", "property uchar green", "property uchar blue",
            "property int label", "property int instance_id", "end_header",
        ]
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(rec.tobytes())


def process_scene_insseg(scene_dir: str, out_dir: str, label_mapper):
    """-> .pth tuple (points, colors in [-1,1], semantic, instance)
    (reference scannet200_insseg.py:37-84)."""
    import torch

    scene = Path(scene_dir).name
    xyz, rgb, labels, inst = load_scene(scene_dir, label_mapper)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(
        (xyz, rgb / 127.5 - 1.0, labels.astype(np.float64), inst.astype(np.float64)),
        os.path.join(out_dir, f"{scene}.pth"),
    )
    return scene


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="ScanNet scans dir")
    ap.add_argument("--output", required=True)
    ap.add_argument("--mode", choices=["semseg", "insseg"], default="semseg")
    ap.add_argument("--labels_tsv", default=None, help="scannetv2-labels.combined.tsv")
    ap.add_argument("--ratio_of_annotated", type=float, default=1.0)
    ap.add_argument("--export_instances", default=None)
    ap.add_argument("--num_workers", type=int, default=8)
    args = ap.parse_args(argv)

    mapper = make_raw_label_mapper(args.labels_tsv) if args.labels_tsv else (lambda r: 0)
    scenes = sorted(
        d for d in Path(args.input).iterdir() if d.is_dir() and d.name.startswith("scene")
    )
    with ProcessPoolExecutor(args.num_workers) as ex:
        if args.mode == "semseg":
            futs = [
                ex.submit(
                    process_scene_semseg, str(s), args.output, mapper,
                    args.ratio_of_annotated, args.export_instances,
                )
                for s in scenes
            ]
        else:
            futs = [ex.submit(process_scene_insseg, str(s), args.output, mapper) for s in scenes]
        for f in futs:
            print(f.result())


if __name__ == "__main__":
    main()
