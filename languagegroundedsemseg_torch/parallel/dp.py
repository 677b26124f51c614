"""Data parallelism: one process per rank, each with its own batch shard.

Counterpart of ``languagegroundedsemseg_tpu/parallel/dp.py``. There, one
program runs ``shard_map`` over a mesh: every device steps on its shard of
a stacked batch, and the step psums the gradients, the BN statistics and
the metrics over the mesh axis (``shard_train_step`` / ``shard_eval_step``,
:121-159). Here every rank is a process that runs the ordinary train step
(``train.step.make_train_step(..., group=...)``) on the batch its own loader
built, and the same three things cross ranks: the BN statistics inside
``SparseBatchNorm`` (``models.layers.convert_sync_batchnorm``), and the
gradients, the loss and the metrics after the backward (``average_gradients``
and ``collectives.all_reduce_mean``). Gathers never cross ranks.

Why an explicit all-reduce and not ``DistributedDataParallel``:
- DDP's reducer raises on parameters that take no gradient in a step (the
  head under ``representation_only``) unless ``find_unused_parameters`` is
  set, which costs a graph walk every step;
- its overlap of the gradient traffic with the backward buys nothing with
  two ranks on one card, the only multi-rank setting measured so far;
- its input moving walks the ``ConvGraph`` dataclass on every call.
One flat all-reduce after the backward is what JAX's pmean of the gradient
tree computes.

``stack_batches`` (:25-113) has no counterpart. ``shard_map`` needs one
static structure and shape for all shards, so JAX intersects and pads the
shards' fused kernel maps to a common signature, a semantic no-op
(tests/test_train_step.py pins that each shard's logits equal its solo
build's). A rank here runs its own host-built graph as it is.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.distributed as dist
from torch import nn

from languagegroundedsemseg_torch.parallel.collectives import group_size


def _by_dtype(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def average_gradients(grads: List[torch.Tensor], group=None) -> None:
    """Replace each gradient by its mean over the ranks (``jax.lax.pmean``
    of the gradient tree), through one flat all-reduce per dtype."""
    n = group_size(group)
    if n == 1 or not grads:
        return
    for same in _by_dtype(grads):
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= n
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))


@torch.no_grad()
def broadcast_module(model: nn.Module, group=None, src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers to every rank (one flat
    broadcast per dtype), so all ranks start from the same weights."""
    if group_size(group) == 1:
        return
    tensors = list(model.parameters()) + list(model.buffers())
    for same in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))
