"""Evaluation: mIoU / confusion metrics."""

from languagegroundedsemseg_torch.eval.miou import (
    fast_hist,
    fast_hist_torch,
    ap_histograms_torch,
    per_class_iou,
    IoUEvaluator,
)

__all__ = ["fast_hist", "fast_hist_torch", "ap_histograms_torch",
           "per_class_iou", "IoUEvaluator"]
