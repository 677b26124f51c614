"""ScanNet benchmark constants (class ids, labels, color maps, splits).

Counterpart of ``languagegroundedsemseg_tpu/constants/__init__.py`` with its
own copy of the data file. Stored as JSON data (constants/data/scannet.json)
— these are public
ScanNet/ScanNet200 benchmark facts, the same data the reference keeps in
lib/constants/scannet_constants.py:3834-3840 and dataset_sets.py:1516-1518.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

_DATA = Path(__file__).parent / "data" / "scannet.json"


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    with open(_DATA) as f:
        return json.load(f)


def valid_class_ids(num_labels: int) -> np.ndarray:
    key = {20: "valid_class_ids_20", 200: "valid_class_ids_200", 549: "valid_class_ids_long"}[num_labels]
    return np.asarray(_load()[key], dtype=np.int32)


def class_labels(num_labels: int) -> list[str]:
    key = {20: "class_labels_20", 200: "class_labels_200", 549: "class_labels_long"}[num_labels]
    return list(_load()[key])


def color_map(num_labels: int) -> dict[int, tuple]:
    key = {20: "scannet_color_map_20", 200: "scannet_color_map_200", 549: "scannet_color_map_long"}[num_labels]
    return {int(k): tuple(v) for k, v in _load()[key].items()}


def head_common_tail_names() -> tuple[list[str], list[str], list[str]]:
    d = _load()
    return (
        list(d["head_cats_scannet_200"]),
        list(d["common_cats_scannet_200"]),
        list(d["tail_cats_scannet_200"]),
    )


def frequency_organized_cats(num_labels: int = 200) -> np.ndarray:
    """(C, 3) bool matrix: head/common/tail membership by *train id*
    (contiguous index into class_labels) — the dataset attribute the
    balancing losses consume (reference lib/datasets/scannet.py:127-141)."""
    labels = class_labels(num_labels)
    head, common, tail = head_common_tail_names()
    m = np.zeros((len(labels), 3), dtype=bool)
    for i, name in enumerate(labels):
        if name in head:
            m[i, 0] = True
        elif name in common:
            m[i, 1] = True
        else:
            m[i, 2] = True
    return m


def train_scenes() -> list[str]:
    return list(_load()["train_scenes"])


def val_scenes() -> list[str]:
    return list(_load()["val_scenes"])


def label_map(num_labels: int, ignore_label: int = 255) -> np.ndarray:
    """Dense raw-label -> contiguous-train-id lookup table (vectorized
    replacement for the reference's np.vectorize remap, lib/dataset.py:321).

    Index with raw ScanNet ids (clipped to table length); unknown ids map to
    ignore_label.
    """
    ids = valid_class_ids(num_labels)
    size = int(ids.max()) + 2
    table = np.full(size, ignore_label, dtype=np.int32)
    for train_id, raw in enumerate(ids):
        table[raw] = train_id
    return table
