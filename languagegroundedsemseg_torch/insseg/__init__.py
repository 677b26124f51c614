"""Downstream instance segmentation (PointGroup-style) subsystem.

Counterpart of ``languagegroundedsemseg_tpu/insseg/``: Res16UNet + offset
head, semantic + offset losses, vote-shift clustering via radius graph +
connected components, the ScanNet instance-AP evaluator, the instance
datasets and ``InssegTrainer`` (one device). Reuses the port's core
framework (data layer, loader, solvers, checkpoints).
"""

from languagegroundedsemseg_torch.insseg.clustering import Clustering
from languagegroundedsemseg_torch.insseg.evaluation import InstanceEvaluator
from languagegroundedsemseg_torch.insseg.model import InstanceRes16UNet

__all__ = ["InstanceRes16UNet", "Clustering", "InstanceEvaluator"]
