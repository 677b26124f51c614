"""ScanNet-benchmark instance segmentation AP evaluator.

Counterpart of ``languagegroundedsemseg_tpu/insseg/evaluation.py``: numpy
only, so the port keeps its own copy, line for line.

Exact protocol of the official benchmark evaluator as shipped in the
reference (downstream/insseg/datasets/evaluation/evaluate_semantic_instance.py,
itself adapted from the CityScapes scripts):

- GT instances are packed per-vertex ids ``label_id * 1000 + instance_index``
  (0 / invalid labels are void); instances whose label is outside the valid
  set are ignored (:253 bool_void).
- Matching is GT-DRIVEN and greedy in instance order (:115-141): each GT
  walks its overlapping predictions in insertion order; a prediction already
  consumed (globally per overlap threshold) is skipped; a second match to an
  already-matched GT turns the lower-confidence prediction into a false
  positive (:126-135); a GT with no match is a hard false negative.
- GT instances are filtered by min_region_size / med_dist / dist_conf before
  matching (:105); small GTs still absorb prediction overlap into the ignore
  pool.
- An unmatched prediction is a false positive only if its ignored fraction
  (void intersection + group-GT + small-GT intersections) satisfies
  ``proportion_ignore <= overlap_th`` (:156-166).
- AP integrates the precision-recall curve with the benchmark's
  cumsum + unique-threshold + [-0.5, 0, 0.5] convolution scheme (:180-226);
  overlaps are 0.5:0.95:0.05 plus 0.25, the headline AP excludes 0.25.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
MIN_REGION_SIZE = 10  # verts (reference :57)
DISTANCE_THRESH = float("inf")
DISTANCE_CONF = -float("inf")


class _Gt:
    __slots__ = ("gid", "label", "count", "med_dist", "dist_conf", "matched")

    def __init__(self, gid: int, count: int):
        self.gid = int(gid)
        self.label = int(gid) // 1000
        self.count = int(count)
        # distance fields exist for protocol parity; ScanNet leaves them at
        # the always-pass defaults (util_3d.Instance: med_dist=-1, conf=0)
        self.med_dist = -1.0
        self.dist_conf = 0.0
        self.matched: List[tuple] = []  # (pred, intersection) insertion order

    @property
    def passes_filters(self) -> bool:
        return (
            self.gid >= 1000
            and self.count >= MIN_REGION_SIZE
            and self.med_dist <= DISTANCE_THRESH
            and self.dist_conf >= DISTANCE_CONF
        )


class _Pred:
    __slots__ = ("uid", "label", "conf", "count", "void_int", "matched")

    def __init__(self, uid: int, label: int, conf: float, count: int, void_int: int):
        self.uid = uid  # global id for the per-threshold visited set
        self.label = label
        self.conf = float(conf)
        self.count = int(count)
        self.void_int = int(void_int)
        self.matched: List[tuple] = []  # (gt, intersection)


class InstanceEvaluator:
    """add_gt / add_prediction per scene, then evaluate().

    add_gt accepts either (scene, semantic, instance_ids) — packed here as
    semantic * 1000 + instance (the reference trainer's convention,
    pl_Trainer.py:362) — or pre-packed ids via add_gt_packed.
    """

    def __init__(self, class_ids: Sequence[int], class_names: Optional[Sequence[str]] = None):
        self.class_ids = [int(c) for c in class_ids]
        self.class_names = list(class_names) if class_names else [str(c) for c in class_ids]
        self.gt_ids: Dict[str, np.ndarray] = {}
        self.preds: Dict[str, List[dict]] = {}

    # -- accumulation ---------------------------------------------------------

    def add_gt(self, scene: str, semantic: np.ndarray, instance_ids: np.ndarray):
        """semantic: per-point raw benchmark class ids; instance_ids: per
        point instance index (< 0 = none)."""
        sem = np.asarray(semantic).astype(np.int64)
        inst = np.asarray(instance_ids).astype(np.int64)
        packed = np.where(inst >= 0, sem * 1000 + inst + 1, 0)
        packed = np.where(sem > 0, packed, 0)
        self.add_gt_packed(scene, packed)

    def add_gt_packed(self, scene: str, gt_ids: np.ndarray):
        self.gt_ids[scene] = np.asarray(gt_ids).astype(np.int64)

    def add_prediction(self, scene: str, instances: Dict[int, dict]):
        """instances: {id: {conf, label_id (raw benchmark id), pred_mask}} in
        insertion order (matching order is order-sensitive per protocol)."""
        self.preds[scene] = [
            {
                "label_id": int(v["label_id"]),
                "conf": float(v["conf"]),
                "mask": np.asarray(v["pred_mask"]) != 0,
            }
            for v in instances.values()
        ]

    # -- core -----------------------------------------------------------------

    def _assign(self):
        """Per scene: GT instances + predictions with cross intersections."""
        valid = set(self.class_ids)
        scenes = {}
        uid = 0
        for scene, ids in self.gt_ids.items():
            gts: Dict[int, List[_Gt]] = {c: [] for c in self.class_ids}
            for gid in np.unique(ids):
                if gid == 0:
                    continue
                label = int(gid) // 1000
                if label in valid:
                    gts[label].append(_Gt(gid, (ids == gid).sum()))
            bool_void = ~np.isin(ids // 1000, self.class_ids)
            preds: Dict[int, List[_Pred]] = {c: [] for c in self.class_ids}
            for p in self.preds.get(scene, []):
                label = p["label_id"]
                if label not in valid:
                    continue
                mask = p["mask"]
                count = int(np.count_nonzero(mask))
                if count < MIN_REGION_SIZE:
                    continue
                pred = _Pred(uid, label, p["conf"], count,
                             np.count_nonzero(bool_void & mask))
                uid += 1
                for gt in gts[label]:
                    inter = int(np.count_nonzero((ids == gt.gid) & mask))
                    if inter > 0:
                        gt.matched.append((pred, inter))
                        pred.matched.append((gt, inter))
                preds[label].append(pred)
            scenes[scene] = (gts, preds)
        return scenes, uid

    def _ap_matrix(self) -> np.ndarray:
        """(num_classes, num_overlaps) AP table."""
        scenes, n_pred = self._assign()
        ap = np.zeros((len(self.class_ids), len(OVERLAPS)))
        for oi, overlap_th in enumerate(OVERLAPS):
            visited = np.zeros(n_pred, dtype=bool)
            for li, cls in enumerate(self.class_ids):
                y_true: List[float] = []
                y_score: List[float] = []
                hard_fn = 0
                has_gt = has_pred = False
                for scene, (gts, preds) in scenes.items():
                    gt_list = [g for g in gts[cls] if g.passes_filters]
                    pred_list = preds[cls]
                    has_gt = has_gt or bool(gt_list)
                    has_pred = has_pred or bool(pred_list)

                    cur_true: List[float] = []
                    cur_score: List[float] = []
                    for gt in gt_list:
                        found, gt_score = False, -float("inf")
                        matched_once = False
                        dup_entries: List[float] = []
                        for pred, inter in gt.matched:
                            if visited[pred.uid]:
                                continue
                            ov = inter / (gt.count + pred.count - inter)
                            if ov > overlap_th:
                                if matched_once:
                                    # duplicate match: lower score becomes FP
                                    hi = max(gt_score, pred.conf)
                                    lo = min(gt_score, pred.conf)
                                    gt_score = hi
                                    dup_entries.append(lo)
                                else:
                                    found = matched_once = True
                                    gt_score = pred.conf
                                    visited[pred.uid] = True
                        if matched_once:
                            cur_true.append(1.0)
                            cur_score.append(gt_score)
                            for lo in dup_entries:
                                cur_true.append(0.0)
                                cur_score.append(lo)
                        if not found:
                            hard_fn += 1

                    for pred in pred_list:
                        found_gt = any(
                            inter / (gt.count + pred.count - inter) > overlap_th
                            for gt, inter in pred.matched
                        )
                        if not found_gt:
                            num_ignore = pred.void_int
                            for gt, inter in pred.matched:
                                if gt.gid < 1000:  # group instance
                                    num_ignore += inter
                                if (
                                    gt.count < MIN_REGION_SIZE
                                    or gt.med_dist > DISTANCE_THRESH
                                    or gt.dist_conf < DISTANCE_CONF
                                ):
                                    num_ignore += inter
                            if num_ignore / pred.count <= overlap_th:
                                cur_true.append(0.0)
                                cur_score.append(pred.conf)

                    y_true.extend(cur_true)
                    y_score.extend(cur_score)

                if has_gt and has_pred:
                    ap[li, oi] = _benchmark_ap(
                        np.asarray(y_true), np.asarray(y_score), hard_fn
                    )
                elif has_gt:
                    ap[li, oi] = 0.0
                else:
                    ap[li, oi] = float("nan")
        return ap

    def evaluate(self) -> Dict[str, object]:
        """-> {'all_ap', 'ap_50', 'ap_25', 'classes': {name: {...}}} with the
        benchmark's averaging (all_ap excludes the 0.25 overlap)."""
        aps = self._ap_matrix()
        o50 = np.isclose(OVERLAPS, 0.5)
        o25 = np.isclose(OVERLAPS, 0.25)
        not25 = ~o25
        per_class = {}
        for li, name in enumerate(self.class_names):
            per_class[name] = {
                "ap": float(np.average(aps[li, not25])),
                "ap_50": float(np.average(aps[li, o50])),
                "ap_25": float(np.average(aps[li, o25])),
            }
        return {
            "all_ap": float(np.nanmean(aps[:, not25])),
            "ap_50": float(np.nanmean(aps[:, o50])),
            "ap_25": float(np.nanmean(aps[:, o25])),
            "classes": per_class,
        }

    # -- official benchmark export (reference :346-361) -----------------------

    def export_benchmark(self, out_dir: str, scene: str, instances: Dict[int, dict]):
        os.makedirs(os.path.join(out_dir, "predicted_masks"), exist_ok=True)
        lines = []
        for i, inst in instances.items():
            rel = f"predicted_masks/{scene}_{i:03d}.txt"
            mask = np.asarray(inst["pred_mask"], dtype=np.int32)
            np.savetxt(os.path.join(out_dir, rel), mask, fmt="%d")
            lines.append(f"{rel} {inst['label_id']} {inst['conf']:.4f}")
        with open(os.path.join(out_dir, f"{scene}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def _benchmark_ap(y_true: np.ndarray, y_score: np.ndarray, hard_fn: int) -> float:
    """The benchmark's PR integration (evaluate_semantic_instance.py:180-226):
    ascending-score sort, one PR point per unique threshold, trapezoid
    integration via convolution with [-0.5, 0, 0.5]."""
    order = np.argsort(y_score)
    y_score = y_score[order]
    y_true = y_true[order]
    cum = np.cumsum(y_true)
    thresholds, unique_idx = np.unique(y_score, return_index=True)
    num_pr = len(unique_idx) + 1
    num_examples = len(y_score)
    num_true = cum[-1] if len(cum) else 0

    precision = np.zeros(num_pr)
    recall = np.zeros(num_pr)
    cum = np.append(cum, 0)  # so cum[-1] (idx_scores == 0) reads 0
    for out_i, score_i in enumerate(unique_idx):
        c = cum[score_i - 1]
        tp = num_true - c
        fp = num_examples - score_i - tp
        fn = c + hard_fn
        precision[out_i] = tp / (tp + fp)
        recall[out_i] = tp / (tp + fn)
    precision[-1] = 1.0
    recall[-1] = 0.0

    recall_conv = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(recall_conv, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))
