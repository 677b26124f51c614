"""Kernel region offset generation for sparse convolutions.

Reproduces the semantics of MinkowskiEngine's KernelGenerator as used by the
reference implementation's conv factories (its models/modules/common.py,
lines 74-236):

- For each axis, a kernel of size ``k`` contributes integer offsets
  ``(i - (k - 1) // 2) * dilation * tensor_stride`` for ``i in range(k)``.
  Odd kernels are centered (e.g. k=3 -> {-1, 0, 1}); even kernels are
  forward-biased (e.g. k=2 -> {0, 1}), which is exactly how ME implements
  the stride-2 kernel-size-2 down/up convolutions of Res16UNet.
- HYPER_CUBE takes the cartesian product over axes; HYPER_CROSS only moves
  one axis at a time (plus the center).
- SPATIAL_HYPERCUBE_TEMPORAL_HYPERCROSS (D=4) is the custom region of
  common.py:110-174: cube over the 3 spatial axes, cross over time.

Offsets are returned in a canonical deterministic order (last axis fastest
for cubes; center first for custom regions, mirroring the reference's
region_offset assembly). Checkpoint converters may permute kernel slots to
match ME's internal enumeration; the framework itself is self-consistent.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass
from typing import Sequence

import numpy as np


class KernelRegion(enum.Enum):
    HYPER_CUBE = 0
    HYPER_CROSS = 1
    # Cube over spatial axes, cross over the temporal axis (D=4 only).
    SPATIAL_CUBE_TEMPORAL_CROSS = 2


def _axis_offsets(k: int, dilation: int, tensor_stride: int) -> list[int]:
    """Per-axis offsets: (i - (k-1)//2) * dilation * tensor_stride."""
    center = (k - 1) // 2
    return [(i - center) * dilation * tensor_stride for i in range(k)]


def _as_list(v, d: int) -> list[int]:
    if isinstance(v, (int, np.integer)):
        return [int(v)] * d
    v = list(v)
    assert len(v) == d, f"expected length-{d} sequence, got {v}"
    return [int(x) for x in v]


def hypercube_offsets(
    kernel_size: int | Sequence[int],
    dilation: int | Sequence[int] = 1,
    tensor_stride: int | Sequence[int] = 1,
    d: int = 3,
) -> np.ndarray:
    """Full cartesian-product kernel region. Shape (K, d), K = prod(kernel_size)."""
    ks = _as_list(kernel_size, d)
    dil = _as_list(dilation, d)
    ts = _as_list(tensor_stride, d)
    per_axis = [_axis_offsets(ks[i], dil[i], ts[i]) for i in range(d)]
    offs = np.array(list(itertools.product(*per_axis)), dtype=np.int32)
    return offs.reshape(-1, d)


def hypercross_offsets(
    kernel_size: int | Sequence[int],
    dilation: int | Sequence[int] = 1,
    tensor_stride: int | Sequence[int] = 1,
    d: int = 3,
) -> np.ndarray:
    """Cross region: center + single-axis moves. Shape (K, d)."""
    ks = _as_list(kernel_size, d)
    dil = _as_list(dilation, d)
    ts = _as_list(tensor_stride, d)
    rows = [[0] * d]
    for axis in range(d):
        for o in _axis_offsets(ks[axis], dil[axis], ts[axis]):
            if o == 0:
                continue
            row = [0] * d
            row[axis] = o
            rows.append(row)
    return np.array(rows, dtype=np.int32)


def spatial_cube_temporal_cross_offsets(
    kernel_size: int | Sequence[int],
    dilation: int | Sequence[int] = 1,
    tensor_stride: int | Sequence[int] = 1,
) -> np.ndarray:
    """D=4 custom region: cube on axes 0..2, cross on axis 3.

    Mirrors the assembly order of the reference
    (models/modules/common.py:125-174): start from the center, extend the
    spatial cube axis by axis, then append temporal cross arms.
    """
    d = 4
    ks = _as_list(kernel_size, d)
    dil = _as_list(dilation, d)
    ts = _as_list(tensor_stride, d)

    region = [[0] * d]
    for axis in range(3):  # spatial cube: progressive cartesian extension
        new_rows = []
        for base in region:
            for o in _axis_offsets(ks[axis], dil[axis], ts[axis]):
                if o == 0:
                    continue
                row = list(base)
                row[axis] = o
                new_rows.append(row)
        region.extend(new_rows)
    for o in _axis_offsets(ks[3], dil[3], ts[3]):  # temporal cross
        if o == 0:
            continue
        row = [0] * d
        row[3] = o
        region.append(row)
    return np.array(region, dtype=np.int32)


def region_offsets(
    region: KernelRegion,
    kernel_size: int | Sequence[int],
    dilation: int | Sequence[int] = 1,
    tensor_stride: int | Sequence[int] = 1,
    d: int = 3,
) -> np.ndarray:
    if region == KernelRegion.HYPER_CUBE:
        return hypercube_offsets(kernel_size, dilation, tensor_stride, d)
    if region == KernelRegion.HYPER_CROSS:
        return hypercross_offsets(kernel_size, dilation, tensor_stride, d)
    if region == KernelRegion.SPATIAL_CUBE_TEMPORAL_CROSS:
        assert d == 4, "spatial-cube/temporal-cross region requires D=4"
        return spatial_cube_temporal_cross_offsets(kernel_size, dilation, tensor_stride)
    raise ValueError(f"unknown kernel region {region}")


@dataclass(frozen=True)
class ConvKind:
    """Static description of one sparse conv's geometry.

    ``stride`` > 1 means a downsampling conv (output coords at the coarser
    stride); ``transpose=True`` means an upsampling conv whose kernel map is
    the transpose of the corresponding strided conv's map.
    """

    kernel_size: "int | tuple" = 3
    stride: int = 1
    dilation: int = 1
    region: KernelRegion = KernelRegion.HYPER_CUBE
    transpose: bool = False

    @property
    def is_pointwise(self) -> bool:
        return self.kernel_size == 1 and self.stride == 1 and not self.transpose

    def num_offsets(self, d: int = 3) -> int:
        return region_offsets(self.region, self.kernel_size, self.dilation, 1, d).shape[0]
