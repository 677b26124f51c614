"""Layers over sparse voxel grids: conv, batch norm, norm dispatcher.

Counterpart of ``languagegroundedsemseg_tpu/models/layers.py``. Parameter
names follow the reference state_dict: a conv holds ``kernel`` (and
``bias``), a norm holds its batch norm as ``bn`` with ``weight``, ``bias``,
``running_mean`` and ``running_var``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.ops.msconv import masked_shift_conv
from languagegroundedsemseg_torch.ops.onehot_conv import (
    child_sum_conv,
    onehot_window_conv,
    transpose_child_sum_conv,
)
from languagegroundedsemseg_torch.ops.spconv import (
    pointwise_conv,
    sparse_conv,
    sparse_conv_parent,
)
from languagegroundedsemseg_torch.parallel.collectives import AllReduceSum, group_size
from languagegroundedsemseg_torch.sparse.types import (
    ChildSumMap,
    ConvGraph,
    MaskedShiftMap,
    ParentMap,
)


class SparseConv(nn.Module):
    """Sparse convolution bound to a named kernel map in the ConvGraph.

    ``map_name=None`` is a kernel-size-1 (pointwise) conv with a
    (Cin, Cout) kernel; otherwise the kernel is (K, Cin, Cout) in the map's
    slot order (``sparse/offsets.py``). He-normal init with
    fan_in = K * Cin, drawn from ``generator``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 map_name: Optional[str] = None, kernel_volume: int = 1,
                 use_bias: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.map_name = map_name
        shape = ((in_channels, out_channels) if map_name is None
                 else (kernel_volume, in_channels, out_channels))
        fan_in = in_channels * (1 if map_name is None else kernel_volume)
        w = torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5
        self.kernel = nn.Parameter(w.to(dev))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=dev))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, graph: ConvGraph) -> torch.Tensor:
        w, b = self.kernel, self.bias
        if self.map_name is None:
            return pointwise_conv(x, w, b)
        km = graph.maps[self.map_name]
        gmaps = graph.gmaps or {}
        gm = gmaps.get(self.map_name)
        # a down conv whose companion up map fused to a ParentMap gets a
        # gather-only backward through it
        cpm = gmaps.get(km.companion) if km.companion else None
        companion_parent = ((cpm.parent, cpm.kslot)
                            if isinstance(cpm, ParentMap) else None)
        if isinstance(gm, ChildSumMap):
            # down convs: child-sum kernel when window-annotated, scatter
            # form otherwise — never needs the flat table
            return child_sum_conv(x, w, gm, b)
        if gm is None and isinstance(cpm, ChildSumMap):
            # up convs ride the companion DOWN map's ChildSumMap
            return transpose_child_sum_conv(x, w, cpm, b)
        if isinstance(gm, ParentMap):
            # gather-only backward through the companion down map's table
            comp = graph.maps.get(gm.companion) if gm.companion else None
            idx_down = (comp.idx if comp is not None and comp.idx.shape[1] > 1
                        else None)
            return sparse_conv_parent(x, w, gm, b, idx_down=idx_down)
        if isinstance(gm, MaskedShiftMap):
            # selector kernel when the map carries a window annotation,
            # masked-shift gather otherwise
            out = onehot_window_conv(x, w, gm, b)
            if out is None:
                out = masked_shift_conv(x, w, gm, b)
            return out
        if km.idx.shape[1] == 1 and x.shape[0] > 1:
            raise RuntimeError(
                f"conv map '{self.map_name}': every fused path declined "
                f"(cap={x.shape[0]}, c_in={x.shape[1]}, c_out={w.shape[-1]}) "
                "but the flat table was dropped as redundant at build time "
                "(graph_host._drop_redundant_flat_maps). Build the graph "
                "with drop_redundant=False or keep_flat=True for this map.")
        return sparse_conv(x, w, km.idx, b, center_slot=km.center_slot,
                           mirror_perm=km.mirror_perm,
                           companion_parent=companion_parent)


class SparseBatchNorm(nn.Module):
    """Batch norm whose statistics cover valid rows only (torch/ME
    semantics): normalization uses the biased batch variance, the running
    variance the unbiased one, ``running = (1 - momentum) * running +
    momentum * batch``. In eval mode every row — padding included — is
    normalized with the running statistics, as the reference does.

    With a ``process_group`` (``convert_sync_batchnorm``) it is SyncBN: in
    training, (count, sum, sum of squares) are summed over the ranks before
    the statistics are formed, and the backward sums their cotangents over
    the ranks (JAX's psum over ``axis_name``, models/layers.py:161-164).
    Eval mode never syncs."""

    def __init__(self, channels: int, momentum: float = 0.02,
                 eps: float = 1e-5, device="cuda", process_group=None):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.eps = momentum, eps
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(channels, device=dev))
        self.bias = nn.Parameter(torch.zeros(channels, device=dev))
        self.register_buffer("running_mean", torch.zeros(channels, device=dev))
        self.register_buffer("running_var", torch.ones(channels, device=dev))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            m = mask.to(torch.float32)[:, None]
            cnt = m.sum()
            sx = (xf * m).sum(dim=0)
            sxx = (xf * xf * m).sum(dim=0)
            if group_size(self.process_group) > 1:
                c = sx.shape[0]
                packed = AllReduceSum.apply(
                    torch.cat([cnt[None], sx, sxx]), self.process_group)
                cnt, sx, sxx = packed[0], packed[1:c + 1], packed[c + 1:]
            cnt = torch.clamp(cnt, min=1.0)
            mean = sx / cnt
            var = torch.clamp(sxx / cnt - mean * mean, min=0.0)
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean) * inv + self.bias


def convert_sync_batchnorm(model: nn.Module, process_group) -> nn.Module:
    """Make every ``SparseBatchNorm`` of ``model`` sync its statistics over
    ``process_group`` (None: back to per-rank statistics), as
    ``nn.SyncBatchNorm.convert_sync_batchnorm`` does for torch's batch
    norm; the modules are changed in place. Returns ``model``."""
    for mod in model.modules():
        if isinstance(mod, SparseBatchNorm):
            mod.process_group = process_group
    return model


class Norm(nn.Module):
    """The reference's norm dispatcher, batch norm only: Res16UNet34C uses
    nothing else (the instance / layer norms come with the model zoo). The
    batch norm is held as ``bn``, as the reference state_dict names it."""

    def __init__(self, channels: int, momentum: float = 0.02, device="cuda"):
        super().__init__()
        self.bn = SparseBatchNorm(channels, momentum=momentum, device=device)

    def forward(self, x, mask):
        return self.bn(x, mask)
