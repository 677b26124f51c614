"""Confusion-matrix semantic-segmentation metrics.

Counterpart of ``languagegroundedsemseg_tpu/eval/miou.py``: ``fast_hist``,
``per_class_iou``, ``per_class_accuracy``, ``IoUEvaluator`` and the binned AP
finalizers, copied (numpy). The JAX module's device-side accumulators,
``fast_hist_jax`` and ``ap_histograms_jax``, are ``fast_hist_torch`` and
``ap_histograms_torch`` here: torch functions on the device's tensors, built
on ``torch.bincount``, that read nothing back to the host.

fast_hist / per_class_iou mirror reference lib/utils.py:92-109; the streaming
evaluator adds per-class accuracy/precision/recall and the head/common/tail
split summary the reference prints via print_info (lib/utils.py:581-609).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def fast_hist(pred: np.ndarray, label: np.ndarray, n: int) -> np.ndarray:
    """(n, n) confusion counts; rows = gt, cols = pred. Labels outside
    [0, n) (the ignore label) are dropped."""
    k = (label >= 0) & (label < n)
    return np.bincount(
        n * label[k].astype(int) + pred[k].astype(int), minlength=n ** 2
    ).reshape(n, n)


def fast_hist_torch(pred: torch.Tensor, label: torch.Tensor, n: int,
                    row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Device-side (n, n) int64 confusion counts (rows = gt, cols = pred);
    labels outside [0, n) and rows with ``row_mask`` 0 are dropped."""
    label = label.long()
    valid = (label >= 0) & (label < n)
    if row_mask is not None:
        valid = valid & (row_mask > 0)
    idx = torch.where(valid, n * label + torch.clamp(pred.long(), 0, n - 1),
                      n * n)
    return torch.bincount(idx, minlength=n * n + 1)[: n * n].reshape(n, n)


def per_class_iou(hist: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))


def per_class_accuracy(hist: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / hist.sum(1)


class IoUEvaluator:
    """Streaming evaluator over batches of (pred, label)."""

    def __init__(self, num_classes: int, split_matrix: Optional[np.ndarray] = None,
                 class_names: Optional[Sequence[str]] = None):
        self.n = num_classes
        self.hist = np.zeros((num_classes, num_classes), dtype=np.int64)
        self.split_matrix = split_matrix  # (C, 3) head/common/tail bools
        self.class_names = class_names

    def reset(self):
        self.hist[:] = 0

    def update(self, pred: np.ndarray, label: np.ndarray):
        self.hist += fast_hist(pred.ravel(), label.ravel(), self.n)

    def update_hist(self, hist: np.ndarray):
        self.hist += np.asarray(hist, dtype=np.int64)

    def compute(self) -> Dict[str, object]:
        ious = per_class_iou(self.hist)
        accs = per_class_accuracy(self.hist)
        out: Dict[str, object] = {
            "miou": float(np.nanmean(ious)),
            "macc": float(np.nanmean(accs)),
            "per_class_iou": ious,
            "per_class_acc": accs,
            "overall_acc": float(np.diag(self.hist).sum() / max(self.hist.sum(), 1)),
        }
        if self.split_matrix is not None:
            for i, name in enumerate(["head", "common", "tail"]):
                sel = self.split_matrix[:, i]
                out[f"{name}_miou"] = float(np.nanmean(ious[sel])) if sel.any() else float("nan")
        return out

    def summary_table(self) -> str:
        """Per-class IoU/acc table + head/common/tail summary (the analog of
        print_info, reference lib/utils.py:581-609)."""
        m = self.compute()
        lines = []
        if self.class_names:
            for i, nm in enumerate(self.class_names):
                iou = m["per_class_iou"][i] * 100
                acc = m["per_class_acc"][i] * 100
                lines.append(f"{nm:32s} IoU {iou:6.2f}  acc {acc:6.2f}")
        lines.append(
            f"mIoU {m['miou']*100:.2f}  mAcc {m['macc']*100:.2f}  oAcc {m['overall_acc']*100:.2f}"
        )
        if "head_miou" in m:
            lines.append(
                f"head {m['head_miou']*100:.2f}  common {m['common_miou']*100:.2f}  tail {m['tail_miou']*100:.2f}"
            )
        return "\n".join(lines)


def ap_histograms_torch(probs: torch.Tensor, labels: torch.Tensor,
                        num_classes: int, num_bins: int = 2048,
                        row_mask: Optional[torch.Tensor] = None):
    """Device-side per-class score histograms for streaming AP.

    Returns (tp_hist, fp_hist), f32 of shape (C, num_bins): counts of
    positive / negative examples per probability bin. Accumulate over
    batches, then finalize with ``ap_from_histograms``. The binned AP
    differs from the exact torchmetrics AveragePrecision (reference
    pl_BaselineTrainer.py:54-70) only by intra-bin score ordering.
    Each count is one ``bincount`` over the flat (class, bin) index; the
    negatives are every row's count less the positives."""
    c, nb = num_classes, num_bins
    labels = labels.long()
    valid = (labels >= 0) & (labels < c)
    if row_mask is not None:
        valid = valid & (row_mask > 0)
    bins = torch.clamp((probs * nb).to(torch.int32), 0, nb - 1).long()  # (N, C)
    flat = bins + nb * torch.arange(c, device=bins.device)[None, :]
    sentinel = c * nb
    safe = torch.clamp(labels, 0, c - 1)
    pos = torch.where(valid, flat.gather(1, safe[:, None])[:, 0], sentinel)
    every = torch.where(valid[:, None], flat, sentinel)
    tp = torch.bincount(pos, minlength=sentinel + 1)[:sentinel]
    n_all = torch.bincount(every.reshape(-1), minlength=sentinel + 1)[:sentinel]
    return (tp.to(torch.float32).reshape(c, nb),
            (n_all - tp).to(torch.float32).reshape(c, nb))


def ap_from_histograms(tp_hist: np.ndarray, fp_hist: np.ndarray) -> np.ndarray:
    """(C, B) histograms -> (C,) average precision (threshold-binned)."""
    tp = np.asarray(tp_hist)[:, ::-1].cumsum(axis=1)
    fp = np.asarray(fp_hist)[:, ::-1].cumsum(axis=1)
    n_pos = tp[:, -1]
    recall = tp / np.maximum(n_pos[:, None], 1)
    precision = tp / np.maximum(tp + fp, 1)
    r_prev = np.concatenate([np.zeros((len(tp), 1)), recall[:, :-1]], axis=1)
    ap = ((recall - r_prev) * precision).sum(axis=1)
    return np.where(n_pos > 0, ap, np.nan)


def average_precision_binned(
    probs: np.ndarray, labels: np.ndarray, num_classes: int, num_bins: int = 100
):
    """Streaming-friendly per-class AP with threshold bins (the
    replacement for torchmetrics AveragePrecision used at reference
    pl_BaselineTrainer.py:54-70). Returns (C,) AP."""
    aps = np.full(num_classes, np.nan)
    valid = (labels >= 0) & (labels < num_classes)
    probs, labels = probs[valid], labels[valid]
    edges = np.linspace(0, 1, num_bins + 1)
    for c in range(num_classes):
        pc = probs[:, c]
        pos = labels == c
        if not pos.any():
            continue
        tp_hist = np.histogram(pc[pos], bins=edges)[0][::-1].cumsum()
        fp_hist = np.histogram(pc[~pos], bins=edges)[0][::-1].cumsum()
        recall = tp_hist / max(pos.sum(), 1)
        precision = tp_hist / np.maximum(tp_hist + fp_hist, 1)
        # standard AP: sum over recall increments
        aps[c] = float(np.sum(np.diff(np.concatenate([[0], recall])) * precision))
    return aps
