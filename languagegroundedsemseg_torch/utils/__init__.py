"""Utilities: PLY IO, timers, host allocator tuning."""

from languagegroundedsemseg_torch.utils.ply import read_ply, write_ply
from languagegroundedsemseg_torch.utils.timer import Timer, AverageMeter

__all__ = ["read_ply", "write_ply", "Timer", "AverageMeter"]
