"""The train and eval steps and the batch they consume.

Counterpart of ``languagegroundedsemseg_tpu/train/step.py``: ``TrainBatch``
with its wire decompaction (:38-53), ``make_train_step`` (:56-110) and
``make_eval_step`` (:113-131). With a process ``group`` the train step is
the data-parallel one (JAX's ``axis_name``, :66-68 and :91-94): its
generator is folded with the rank, and the gradients, the loss and the
metrics are averaged over the ranks after the backward (``parallel/dp.py``
says why this is not ``DistributedDataParallel``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.ops.onehot_conv import with_inverse_anchors
from languagegroundedsemseg_torch.parallel.collectives import (
    all_reduce_mean,
    group_rank,
    group_size,
)
from languagegroundedsemseg_torch.parallel.dp import average_gradients
from languagegroundedsemseg_torch.sparse.types import ConvGraph, leaf_to
from languagegroundedsemseg_torch.train.state import TrainState
from languagegroundedsemseg_torch.utils.observability import span

# objective(*model outputs, batch, generator, row_mask) -> (loss, metrics):
# (logits, features, ...) for the semantic models, (offsets, logits,
# features, ...) for the instance model
Objective = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclass
class TrainBatch:
    """One batch: padded per-voxel feats and labels plus the ConvGraph.
    Arrays are numpy on the host (``BatchBuilder.build_host``) or torch
    tensors after ``.to(device)``."""

    feats: Any
    labels: Any
    graph: ConvGraph
    extras: Dict[str, Any] = field(default_factory=dict)

    def replace(self, **changes) -> "TrainBatch":
        return dataclasses.replace(self, **changes)

    def to(self, device, non_blocking: bool = False) -> "TrainBatch":
        """A copy with every array on ``device``. ``non_blocking`` pins the
        host arrays and queues the copies on the current stream (the
        loader's side stream); the caller orders its use after them."""
        dev = resolve_device(device)
        return TrainBatch(
            feats=leaf_to(self.feats, dev, non_blocking),
            labels=leaf_to(self.labels, dev, non_blocking),
            graph=self.graph.to(dev, non_blocking),
            extras={k: leaf_to(v, dev, non_blocking)
                    for k, v in self.extras.items()},
        )

    def decompact(self) -> "TrainBatch":
        """Undo the wire compaction on tensors: uint8 feats -> colors
        normalized to [-0.5, 0.5] in f32, f16 feats -> f32, narrow labels
        -> int32."""
        b = self
        if b.feats.dtype == torch.uint8:
            b = b.replace(feats=b.feats.to(torch.float32) / 255.0 - 0.5)
        elif b.feats.dtype == torch.float16:
            b = b.replace(feats=b.feats.to(torch.float32))
        if b.labels.dtype != torch.int32:
            b = b.replace(labels=b.labels.to(torch.int32))
        return b


def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A new generator on ``generator``'s device whose seed mixes the
    generator's seed with ``data`` (the counterpart of
    ``jax.random.fold_in``; the bits differ from JAX's)."""
    seed = np.random.SeedSequence(
        [generator.initial_seed(), int(data)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(int(seed))


def make_train_step(model, optimizer, objective: Objective,
                    representation_only: bool = False,
                    device="cuda", group=None) -> Callable:
    """Build ``step(state, batch, generator=None) -> (state, metrics)``.

    Moves ``model`` to ``device``. Each call runs the train-mode forward
    (BatchNorm over valid rows, running statistics updated), the objective
    with the level-0 row mask, the backward, and ``optimizer``'s update
    scaled by ``state.lr_scale``; then ``state.step += 1``. ``state`` is the
    ``TrainState`` of this model and optimizer. The objective's generator is
    ``generator`` folded with the step; a model that ``takes_generator``
    (the CRF wrappers) gets that generator folded with 1. Metrics (0-d
    tensors on the device):
    the objective's, ``loss``, and ``grad_norm``, the global L2 norm of the
    gradients before the update.

    With a process ``group`` of more than one rank (each rank calls the
    step on its own batch shard, the model's batch norms synced by
    ``convert_sync_batchnorm``): the generator is folded with the rank
    first, then with the step, and after the backward the gradients, the
    loss and the metrics are averaged over the ranks; ``grad_norm`` reads
    the averaged gradients, as ``optax.global_norm`` reads JAX's after its
    pmean. Every rank then makes the same update.

    Each call is a span ``lgs.step`` holding the consecutive phase spans
    ``lgs.step.prep`` (the batch to the device, its inverse tiling, the
    generators, the zeroed gradients), ``.forward``, ``.loss``,
    ``.backward``, with a group ``.allreduce``, and ``.update`` (the
    gradient norm, the optimizer, the metrics)."""
    dev = resolve_device(device)
    model = model.to(dev)
    data_parallel = group_size(group) > 1
    rank = group_rank(group)

    def step(state: TrainState, batch: "TrainBatch",
             generator: Optional[torch.Generator] = None):
        # consecutive phase spans inside lgs.step; the backward's work runs
        # on autograd's own thread, so lgs.step.backward names the wait
        with span("lgs.step"):
            with span("lgs.step.prep"):
                batch = batch.to(dev).decompact()
                # the selector convs' dW reads the inverse tiling: rebuild
                # it once per map for this batch where the wire format left
                # it out
                batch = batch.replace(graph=with_inverse_anchors(batch.graph))
                gen = generator
                if gen is not None and data_parallel:
                    gen = fold_in(gen, rank)
                gen = None if gen is None else fold_in(gen, state.step)
                model.train()
                # every parameter's gradient, also those the optimizer does
                # not update (classifier_only), so grad_norm reads this
                # step's only
                model.zero_grad(set_to_none=True)
                kw = {}
                if gen is not None and getattr(model, "takes_generator", False):
                    # the CRF wrapper's coin (JAX: rngs={"crf": fold_in(key, 1)})
                    kw["generator"] = fold_in(gen, 1)
            with span("lgs.step.forward"):
                outputs = model(batch.feats, batch.graph,
                                representation_only=representation_only, **kw)
            with span("lgs.step.loss"):
                row_mask = batch.graph.levels[0].mask()
                loss, metrics = objective(*outputs, batch, gen, row_mask)
            with span("lgs.step.backward"):
                loss.backward()
                grads = [p.grad for p in model.parameters() if p.grad is not None]
            if data_parallel:
                with span("lgs.step.allreduce"):
                    average_gradients(grads, group)
                    reduced = all_reduce_mean(
                        {**{k: v.detach() for k, v in metrics.items()},
                         "loss": loss.detach()}, group)
                    loss, metrics = reduced.pop("loss"), reduced
            with span("lgs.step.update"):
                grad_norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g) for g in grads]))
                optimizer.step(lr_scale=state.lr_scale)
                state.step += 1
                metrics = {k: v.detach() for k, v in metrics.items()}
                metrics["loss"] = loss.detach()
                metrics["grad_norm"] = grad_norm
            return state, metrics

    return step


def make_eval_step(model, representation_only: bool = False,
                   device="cuda") -> Callable:
    """Build ``eval(batch) -> (logits_or_features, features)``.

    Moves ``model`` to ``device`` and runs the forward in eval mode
    (BatchNorm reads its running statistics; set on every call, since a
    train step between calls puts the model in train mode) under
    ``torch.inference_mode()``. A host batch (numpy leaves) is moved to the
    device first; tensors already there are used as they are."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def step(batch: TrainBatch):
        model.eval()
        with torch.inference_mode():
            batch = batch.to(dev).decompact()
            return model(batch.feats, batch.graph,
                         representation_only=representation_only)

    return step
