"""Layers over sparse voxel grids: conv, norms, squeeze-excitation.

Counterpart of ``languagegroundedsemseg_tpu/models/layers.py``. Parameter
names follow the reference state_dict: a conv holds ``kernel`` (and
``bias``), a norm holds its batch norm as ``bn`` with ``weight``, ``bias``,
``running_mean`` and ``running_var``, and its instance norm as ``inorm``
with ``weight`` and ``bias``.

``dtype`` is each layer's compute dtype, JAX's flax ``dtype`` field: a conv
casts its input, kernel and bias to it; a norm forms its statistics in f32
and returns its output in it; a dense layer (``dense``) casts its input,
weight and bias. Parameters stay f32, and their gradients come back f32
through the casts.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.ops import batch_norm as bn_ops
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
from languagegroundedsemseg_torch.ops.segment import batch_broadcast, batch_mean
from languagegroundedsemseg_torch.parallel.collectives import AllReduceSum, group_size
from languagegroundedsemseg_torch.sparse.types import (
    ChildSumMap,
    ConvGraph,
    MaskedShiftMap,
    ParentMap,
)


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """The scope of a checkpointed block's recompute in the backward
    (``torch.utils.checkpoint``'s recompute context): batch norms leave
    their running statistics alone there, so they move once a step, as
    flax's ``nn.remat`` moves ``batch_stats``."""
    prev = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


def dense(lin: nn.Linear, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A flax ``Dense`` with compute dtype ``dtype``: input, weight and
    bias cast to it, the output in it; the product and the bias add round
    one after the other, as flax's two ops do."""
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


class SparseConv(nn.Module):
    """Sparse convolution bound to a named kernel map in the ConvGraph.

    ``map_name=None`` is a kernel-size-1 (pointwise) conv with a
    (Cin, Cout) kernel; otherwise the kernel is (K, Cin, Cout) in the map's
    slot order (``sparse/offsets.py``). He-normal init with
    fan_in = K * Cin, drawn from ``generator``. x, the kernel and the bias
    are cast to ``dtype`` (JAX :59-77).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 map_name: Optional[str] = None, kernel_volume: int = 1,
                 use_bias: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.map_name = map_name
        self.dtype = dtype
        shape = ((in_channels, out_channels) if map_name is None
                 else (kernel_volume, in_channels, out_channels))
        fan_in = in_channels * (1 if map_name is None else kernel_volume)
        w = torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5
        self.kernel = nn.Parameter(w.to(dev))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=dev))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, graph: ConvGraph) -> torch.Tensor:
        dt = self.dtype
        x, w = x.to(dt), self.kernel.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
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
    Eval mode never syncs. Statistics in f32, the output in ``dtype``; in
    a checkpointed block's recompute (``recomputing``) the running
    statistics are left as the first forward left them.

    On the card the norm is one autograd node on hand-written kernels
    (``ops.batch_norm.sparse_batch_norm``, six launches a training forward
    and backward); elsewhere it runs the eager arithmetic below, which the
    kernels' plain versions repeat in closed form (``eager``)."""

    def __init__(self, channels: int, momentum: float = 0.02,
                 eps: float = 1e-5, device="cuda", process_group=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.eps = momentum, eps
        self.dtype = dtype
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(channels, device=dev))
        self.bias = nn.Parameter(torch.zeros(channels, device=dev))
        self.register_buffer("running_mean", torch.zeros(channels, device=dev))
        self.register_buffer("running_var", torch.ones(channels, device=dev))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            mode = (bn_ops.EVAL if not self.training
                    else bn_ops.RECOMPUTE if getattr(_RECOMPUTE, "on", False)
                    else bn_ops.TRAIN)
            return bn_ops.sparse_batch_norm(
                x, mask, self.weight, self.bias, self.running_mean,
                self.running_var, eps=self.eps, momentum=self.momentum,
                mode=mode, group=self.process_group, out_dtype=self.dtype)
        return self.eager(x, mask)

    def eager(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The norm as eager ops on any device: the CPU's path, and the
        arithmetic the kernels' plain versions repeat."""
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
            if not getattr(_RECOMPUTE, "on", False):
                self._update_running(mean, var, cnt)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * inv + self.bias).to(self.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var, cnt):
        unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
        self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
        self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)


def convert_sync_batchnorm(model: nn.Module, process_group) -> nn.Module:
    """Make every ``SparseBatchNorm`` of ``model`` sync its statistics over
    ``process_group`` (None: back to per-rank statistics), as
    ``nn.SyncBatchNorm.convert_sync_batchnorm`` does for torch's batch
    norm; the modules are changed in place. Returns ``model``."""
    for mod in model.modules():
        if isinstance(mod, SparseBatchNorm):
            mod.process_group = process_group
    return model


class SparseInstanceNorm(nn.Module):
    """Per-batch-item normalization over each sample's valid rows
    (ME.MinkowskiInstanceNorm): the mean and biased variance of each of
    ``max_batch`` items, broadcast back to its rows; the same in train and
    eval mode. Statistics in f32, the output in ``dtype``."""

    def __init__(self, channels: int, eps: float = 1e-5, max_batch: int = 32,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.eps, self.max_batch = eps, max_batch
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels, device=dev))
        self.bias = nn.Parameter(torch.zeros(channels, device=dev))

    def forward(self, x: torch.Tensor, batch_idx: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = batch_broadcast(batch_mean(xf, batch_idx, mask, self.max_batch),
                               batch_idx)
        d = (xf - mean) * mask.to(torch.float32)[:, None]
        var = batch_broadcast(batch_mean(d * d, batch_idx, mask, self.max_batch),
                              batch_idx)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(self.dtype)


class SparseLayerNorm(nn.Module):
    """The reference's custom MinkowskiLayerNorm (models/layers.py:7-46):
    each row shifted by its batch item's mean, then scaled by its own
    variance over the channels. Statistics in f32, the output in
    ``dtype``."""

    def __init__(self, channels: int, eps: float = 1e-5, max_batch: int = 32,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.eps, self.max_batch = eps, max_batch
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels, device=dev))
        self.bias = nn.Parameter(torch.zeros(channels, device=dev))

    def forward(self, x: torch.Tensor, batch_idx: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        d = xf - batch_broadcast(batch_mean(xf, batch_idx, mask, self.max_batch),
                                 batch_idx)
        var = (d * d).mean(dim=-1, keepdim=True)
        return (d * torch.rsqrt(var + self.eps) * self.weight + self.bias).to(self.dtype)


class SELayer(nn.Module):
    """Squeeze-excitation over sparse rows (reference
    models/modules/senet_block.py:9-24): per-item mean pool -> linear
    (``fc1``, channels / reduction) -> relu -> linear (``fc2``) -> sigmoid
    gate, broadcast back to the rows. The linears compute in ``dtype``."""

    def __init__(self, channels: int, reduction: int = 16, max_batch: int = 32,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.max_batch = max_batch
        self.dtype = dtype
        self.fc1 = linear(channels, channels // reduction, device=device,
                          generator=generator)
        self.fc2 = linear(channels // reduction, channels, device=device,
                          generator=generator)

    def forward(self, x: torch.Tensor, batch_idx: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        pooled = batch_mean(x.to(torch.float32), batch_idx, mask, self.max_batch)
        dt = self.dtype
        gate = torch.sigmoid(dense(self.fc2, torch.relu(dense(self.fc1, pooled, dt)), dt))
        return (x * batch_broadcast(gate, batch_idx)).to(dt)


def linear(in_features: int, out_features: int, device="cuda",
           generator: Optional[torch.Generator] = None) -> nn.Linear:
    """``nn.Linear`` on ``device`` drawn from ``generator``: weight
    N(0, 1 / in_features) (LeCun normal; flax Dense's default is its
    truncated form), bias 0."""
    lin = nn.Linear(in_features, out_features, device=resolve_device(device))
    with torch.no_grad():
        lin.weight.copy_(torch.randn((out_features, in_features),
                                     generator=generator) * in_features ** -0.5)
        lin.bias.zero_()
    return lin


NORM_TYPES = ("batch", "instance", "instance_batch")


class Norm(nn.Module):
    """The reference's norm dispatcher (get_norm,
    models/modules/common.py:17-27): ``norm_type`` 'batch' holds a batch
    norm as ``bn``; 'instance' an instance norm as ``inorm``;
    'instance_batch' both, the instance norm first. Each outputs ``dtype``."""

    def __init__(self, channels: int, momentum: float = 0.02, device="cuda",
                 norm_type: str = "batch", max_batch: int = 32,
                 dtype=torch.float32):
        super().__init__()
        if norm_type not in NORM_TYPES:
            raise ValueError(f"unknown norm type {norm_type!r}")
        self.inorm = self.bn = None
        if norm_type != "batch":
            self.inorm = SparseInstanceNorm(channels, max_batch=max_batch,
                                            device=device, dtype=dtype)
        if norm_type != "instance":
            self.bn = SparseBatchNorm(channels, momentum=momentum, device=device,
                                      dtype=dtype)

    def forward(self, x, mask, batch_idx=None):
        if self.inorm is not None:
            x = self.inorm(x, batch_idx, mask)
        if self.bn is not None:
            x = self.bn(x, mask)
        return x
