"""Collectives over the data-parallel process group, differentiable where
JAX's are.

Counterpart of ``languagegroundedsemseg_tpu/parallel/collectives.py``
(:17-44). JAX runs them inside ``shard_map`` over a mesh axis; here each
rank is a process and they run over a ``torch.distributed`` group. With no
group (``group=None``) or a group of one rank every function is the
identity, so single-device code takes the same calls.

``AllReduceSum`` is the counterpart of ``jax.lax.psum``, whose transpose is
a psum: the backward all-reduces the cotangent with SUM. SyncBN's
statistics and the feature gather rely on that, since each rank's loss
reads every rank's activations through them. (The autograd-aware ops of
``torch.distributed.nn.functional`` do the same but are deprecated.)

Every collective here is an ``all_reduce``, which every backend takes on
CUDA and CPU tensors alike (gloo included); the gather is an all-reduce of
rank-placed blocks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

Tree = Union[torch.Tensor, Dict[str, torch.Tensor]]


def group_size(group) -> int:
    """Ranks in ``group``; 1 for ``None``."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group``; 0 for ``None``."""
    return 0 if group is None else dist.get_rank(group)


class AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the group's ranks; the backward sums the
    cotangent over the ranks (the transpose of ``jax.lax.psum``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(tree: Tree, group=None) -> Tree:
    """``tree`` (a tensor or a dict of tensors) summed over the ranks,
    differentiably. A dict's tensors of one dtype go through one flat
    all-reduce."""
    if group_size(group) == 1:
        return tree
    if isinstance(tree, torch.Tensor):
        return AllReduceSum.apply(tree, group)
    out = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for k, v in tree.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = AllReduceSum.apply(
            torch.cat([tree[k].reshape(-1) for k in keys]), group)
        for k, part in zip(keys, flat.split([tree[k].numel() for k in keys])):
            out[k] = part.view(tree[k].shape)
    return {k: out[k] for k in tree}


def all_reduce_mean(tree: Tree, group=None) -> Tree:
    """``tree`` averaged over the ranks (``jax.lax.pmean``): the sum
    divided by the number of ranks."""
    n = group_size(group)
    if n == 1:
        return tree
    summed = all_reduce_sum(tree, group)
    if isinstance(summed, torch.Tensor):
        return summed / n
    return {k: v / n for k, v in summed.items()}


def all_gather_features(x: torch.Tensor, valid_mask: Optional[torch.Tensor] = None,
                        group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (n_rank, F) rows, rank after rank, differentiably.

    Ranks may hold different row counts: each block is padded to the
    largest, as the reference's ``all_gather_differentiable`` does
    (downstream/insseg/lib/distributed.py:148-181). Returns
    ((world * n_max, F) rows, (world * n_max,) mask), the mask 1 on real
    rows (times ``valid_mask`` where given) and 0 on padding. The gradient
    of a rank's rows is the sum over the ranks of the gathered rows'
    cotangents, as for JAX's fixed-capacity ``all_gather``, which returns
    the same rows and mask once its padding is dropped."""
    mask = (torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
            if valid_mask is None else valid_mask.to(x.dtype))
    n = group_size(group)
    if n == 1:
        return x, mask
    rank = group_rank(group)
    counts = torch.zeros(n, dtype=torch.int64, device=x.device)
    counts[rank] = x.shape[0]
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    n_max = int(counts.max())
    placed = x.new_zeros((n, n_max) + tuple(x.shape[1:]))
    placed[rank, :x.shape[0]] = x
    placed_mask = mask.new_zeros((n, n_max))
    placed_mask[rank, :x.shape[0]] = mask.detach()
    rows = AllReduceSum.apply(placed, group).reshape((n * n_max,) + tuple(x.shape[1:]))
    dist.all_reduce(placed_mask, op=dist.ReduceOp.SUM, group=group)
    return rows, placed_mask.reshape(-1)


def barrier(group=None) -> None:
    """Wait until every rank of ``group`` reaches this call (reference
    distributed.py:135-147); nothing with one rank."""
    if group_size(group) > 1:
        dist.barrier(group=group)
