"""Mean-field CRF post-filtering over the joint spatial-chromatic space.

Counterpart of ``languagegroundedsemseg_tpu/models/crf.py`` (reference
models/conditional_random_fields.py:119-157, models/wrapper.py:20-30): the
pairwise term is a kNN graph in the scaled 6D (xyz / spatial_sigma, rgb /
chromatic_sigma) feature space, 7D with a time column; messages are
gaussian-weighted neighbor sums of the current beliefs mixed by a learned
class-compatibility matrix, iterated ``iterations`` times.

As in JAX, the kNN runs over every row of the batch with no batch column,
so rows of different scenes can be each other's neighbors, and it is brute
force: O(N^2) distances, ranked in blocks of query rows (``ops/points.py``
``KNN_BLOCK_ROWS``; ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.ops.points import knn


class MeanFieldCRF(nn.Module):
    def __init__(self, num_classes: int, spatial_sigma: float = 1.0,
                 chromatic_sigma: float = 12.0, temporal_sigma: float = 1.0,
                 iterations: int = 10, num_neighbors: int = 16, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.spatial_sigma, self.chromatic_sigma = spatial_sigma, chromatic_sigma
        self.temporal_sigma = temporal_sigma
        self.iterations, self.num_neighbors = iterations, num_neighbors
        c = num_classes
        # learned class compatibility, Potts-initialized
        compat = -(torch.eye(c) - 1.0 / c)
        self.compatibility = nn.Parameter(compat.to(resolve_device(device)))

    def forward(self, unaries: torch.Tensor, coords_xyz: torch.Tensor,
                colors: torch.Tensor, row_mask: torch.Tensor,
                time: Optional[torch.Tensor] = None) -> torch.Tensor:
        """unaries (N, C) logits; coords_xyz (N, 3) voxel coords; colors
        (N, 3) in [0, 255]; time (N,) for the trilateral 7D space ->
        refined logits (N, C) in ``dtype`` (the iterations run in f32)."""
        f32 = torch.float32
        cols = [coords_xyz.to(f32) / self.spatial_sigma,
                colors.to(f32) / self.chromatic_sigma]
        if time is not None:
            cols.append(time.to(f32)[:, None] / self.temporal_sigma)
        feat = torch.cat(cols, dim=1)
        with torch.no_grad():
            dist, idx = knn(feat, feat, self.num_neighbors + 1, row_mask)
        dist, idx = dist[:, 1:], idx[:, 1:].long()  # drop self
        m = row_mask.to(f32)
        w = torch.exp(-0.5 * dist ** 2) * m[idx] * m[:, None]

        unaries = unaries.to(f32)
        q_logits = unaries
        for _ in range(self.iterations):
            q = torch.softmax(q_logits, dim=-1)
            msg = (q[idx] * w[..., None]).sum(dim=1)
            q_logits = unaries - msg @ self.compatibility
        return q_logits.to(self.dtype)


class Wrapper(nn.Module):
    """A base model whose logits the CRF (``crf``) refines (reference
    models/wrapper.py:20-30): always in eval mode, and in training with
    probability 0.5 (a coin a step) so the base net stays filter-invariant.
    The coin is drawn from the ``generator`` the train step passes
    (``draw_coin``); training without one applies the filter, as JAX does
    without its 'crf' rng. The level-0 coords must ship with the batch."""

    USE_TEMPORAL: bool = False
    # the train step passes its generator to this model's forward
    takes_generator: bool = True

    def __init__(self, base: nn.Module, num_classes: int,
                 spatial_sigma: float = 1.0, chromatic_sigma: float = 12.0,
                 temporal_sigma: float = 1.0, iterations: int = 10,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.base = base
        self.crf = MeanFieldCRF(num_classes, spatial_sigma, chromatic_sigma,
                                temporal_sigma, iterations, device=device,
                                dtype=dtype)

    def input_conv(self):
        return self.base.input_conv()

    @staticmethod
    def draw_coin(generator: torch.Generator) -> torch.Tensor:
        """A 0-d bool tensor, True with probability 0.5."""
        return torch.rand((), generator=generator,
                          device=generator.device) < 0.5

    def forward(self, feats: torch.Tensor, graph, representation_only: bool = False,
                apply_crf: bool = True,
                generator: Optional[torch.Generator] = None):
        logits, features = self.base(feats, graph, representation_only)
        if not apply_crf:
            return logits, features
        lvl0 = graph.levels[0]
        if lvl0.coords is None:
            raise ValueError(
                "CRF wrappers need device-side coords: build batches with "
                "ship_coords=True (the trainer does this when wrapper_type "
                "is set)")
        coords = lvl0.coords
        # coords layout (batch, x, y, z[, t]): 4D graphs carry time last
        time = (coords[:, 4] if self.USE_TEMPORAL and coords.shape[1] > 4
                else None)
        refined = self.crf(logits, coords[:, 1:4], (feats[:, :3] + 0.5) * 255.0,
                           lvl0.mask(), time=time)
        if self.training and generator is not None:
            coin = self.draw_coin(generator)
        else:
            coin = torch.ones((), dtype=torch.bool, device=logits.device)
        # both branches computed, as in JAX: the compatibility's gradient is
        # 0 (not absent) on a step whose coin keeps the logits
        return torch.where(coin, refined.to(logits.dtype), logits), features


class BilateralCRF(Wrapper):
    """Spatial + chromatic (6D) filtering (reference
    models/conditional_random_fields.py:143)."""


class TrilateralCRF(Wrapper):
    """Spatial + chromatic + temporal (7D) filtering (reference :157): on
    4D graphs the time column joins the kNN space with its own sigma; on 3D
    graphs it is bilateral."""

    USE_TEMPORAL: bool = True
