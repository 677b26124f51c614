"""Prediction visualization + confusion dumps.

Counterpart of ``languagegroundedsemseg_tpu/utils/visualization.py``,
copied (numpy only) over the port's ``fast_hist`` and ``write_ply``.

Mirror of reference lib/utils.py:340-435 visualize_results and
lib/pc_utils.py colorize helpers: write colored pred/gt/rgb .ply per scene
and pickle per-scene confusion matrices.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from languagegroundedsemseg_torch.eval.miou import fast_hist
from languagegroundedsemseg_torch.utils.ply import write_ply


def colorize_labels(labels: np.ndarray, color_map: Dict[int, tuple]) -> np.ndarray:
    out = np.zeros((len(labels), 3), dtype=np.float32)
    for lab, color in color_map.items():
        out[labels == lab] = color
    return out


def visualize_results(
    out_dir: str,
    scene_name: str,
    coords_xyz: np.ndarray,
    colors: Optional[np.ndarray],
    pred: np.ndarray,
    target: np.ndarray,
    color_map: Dict[int, tuple],
    num_labels: int,
    iteration: int = 0,
    save_confusion: bool = True,
    inverse_map: Optional[np.ndarray] = None,
):
    """Write {scene}_pred/gt/rgb.ply + confusion pickle + raw pred npy (the
    *pred*NNNN.npy files test_pointcloud consumes).

    pred/target are contiguous train ids; ``inverse_map`` (train id -> raw
    dataset id) converts them for the .npy dump and colorization — the
    reference saves decoded raw ids (lib/utils.py:340-435) and
    test_pointcloud re-maps them (lib/datasets/scannet.py:405-434).
    """
    os.makedirs(out_dir, exist_ok=True)
    if inverse_map is not None:
        inv = np.asarray(inverse_map)
        pred_raw = inv[np.clip(pred, 0, len(inv) - 1)]
        tgt_clip = np.clip(target, 0, len(inv) - 1)
        target_raw = np.where(target < len(inv), inv[tgt_clip], target)
    else:
        pred_raw, target_raw = pred, target
    write_ply(
        os.path.join(out_dir, f"{scene_name}_pred.ply"),
        coords_xyz, colorize_labels(pred_raw, color_map),
        labels=pred_raw,
    )
    write_ply(
        os.path.join(out_dir, f"{scene_name}_gt.ply"),
        coords_xyz, colorize_labels(target_raw, color_map),
        labels=target_raw,
    )
    if colors is not None:
        write_ply(os.path.join(out_dir, f"{scene_name}_rgb.ply"), coords_xyz, colors)

    np.save(
        os.path.join(out_dir, f"{scene_name}_pred_{iteration:04d}.npy"),
        np.hstack([coords_xyz, pred_raw[:, None]]).astype(np.float32),
    )
    if save_confusion:
        hist = fast_hist(pred, target, num_labels)
        with open(os.path.join(out_dir, f"{scene_name}_confusion.pkl"), "wb") as f:
            pickle.dump(hist, f)
