"""Utilities: PLY IO, running averages, host allocator tuning."""

from languagegroundedsemseg_torch.utils.ply import read_ply, write_ply
from languagegroundedsemseg_torch.utils.timer import AverageMeter

__all__ = ["read_ply", "write_ply", "AverageMeter"]
