"""The data-parallel world of this process.

Counterpart of ``languagegroundedsemseg_tpu/parallel/mesh.py:make_mesh``
(:12-35). JAX builds a one-axis mesh over the devices of one process; here
each rank is a process, launched by ``torchrun`` (one per card), which
sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and the store's
``MASTER_ADDR`` / ``MASTER_PORT``). ``make_mesh`` joins that group, or
takes the one the caller already made with ``init_process_group``, and
returns a ``Mesh`` record of (group, rank, world, device).

The backend follows the device: ``nccl`` for a CUDA device, ``gloo`` for
the CPU. The JAX function falls back to virtual CPU devices when there are
too few chips; this one has no fallback: too few ranks, or a failed init,
raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from languagegroundedsemseg_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world. ``group`` is None
    for a process outside any group; with it, or with a group of one rank,
    every collective is the identity."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device
    # True when make_mesh made the process group (close() destroys it)
    owns_group: bool = False

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the logs, the checkpoints and the traces."""
        return self.rank == 0

    def close(self) -> None:
        """Destroy the process group if ``make_mesh`` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _torchrun_env():
    """(rank, world, local rank) from torchrun's environment, or None."""
    if "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    return rank, int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", rank))


def _rank_device(device, local_rank: int) -> torch.device:
    """``device`` as it is when it names an index or the CPU; a bare
    ``cuda`` becomes ``cuda:LOCAL_RANK``, one card per rank."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return dev


def make_mesh(num_devices: int = 0, device="cuda") -> Mesh:
    """The ``Mesh`` of ``num_devices`` ranks (0: the torchrun world, or one
    rank without torchrun).

    An existing process group is used as it is (its backend included: two
    ranks may share one card over gloo). Otherwise, with torchrun's
    environment, this joins its group (``init_method="env://"``) with the
    backend of ``device``; without it, one rank and no group. More ranks
    asked for than the world has, or a world that differs from
    ``num_devices``, raises: the ranks are processes, started by
    ``torchrun --nproc_per_node N``."""
    env = _torchrun_env()
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        local_rank = env[2] if env is not None else rank
    elif env is not None:
        rank, world, local_rank = env
    else:
        rank, world, local_rank = 0, 1, 0
    want = num_devices or world
    if want != world:
        raise RuntimeError(
            f"num_devices={num_devices} but this process is one of {world} "
            f"rank(s): start one process per device with torchrun "
            f"--nproc_per_node {want} -m languagegroundedsemseg_torch.cli.main "
            f"... --num_devices {want}")
    dev = _rank_device(device, local_rank)
    if env is None and not dist.is_initialized():
        return Mesh(None, 0, 1, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return Mesh(dist.group.WORLD, rank, world, dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, rank=rank, world_size=world)
    return Mesh(dist.group.WORLD, rank, world, dev, owns_group=True)
