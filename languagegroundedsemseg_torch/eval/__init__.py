"""Evaluation: mIoU / confusion metrics."""

from languagegroundedsemseg_torch.eval.miou import (
    fast_hist,
    per_class_iou,
    IoUEvaluator,
)

__all__ = ["fast_hist", "per_class_iou", "IoUEvaluator"]
