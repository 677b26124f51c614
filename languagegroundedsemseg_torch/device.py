"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``. Entry points default to the card;
    asking for CUDA where there is none raises instead of running on the
    CPU — a caller that wants the CPU says so (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
