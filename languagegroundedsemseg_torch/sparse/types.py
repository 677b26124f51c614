"""Containers for fixed-capacity sparse voxel grids.

Counterpart of ``languagegroundedsemseg_tpu/sparse/types.py``. The host
graph builder fills these plain dataclasses with numpy arrays; ``.to(device)``
returns a copy whose array leaves are torch tensors on that device. Static
fields (``tile``, ``win``, ``cols``, ``mirror_perm``, ``ov_seg``,
``n_groups``, ``num_slots``, capacities, the valid count ``num``) stay Python
ints or tuples, so reading them never waits for the device.

Every array keeps its wire dtype across ``.to``: uint8 masks, int16 anchor
deltas and uint8 slots ship as they are and are cast where they are used.
The one exception is the uint16 block-delta ``ChildSumMap.parent``, which
crosses as its int16 bit pattern and is widened to int32 on the device
(torch's uint16 support is partial); ``ops/onehot_conv.py:_abs_parent``
decodes it against ``parent_base`` either way.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch


def leaf_to(v, device, non_blocking: bool = False):
    """An array leaf as a tensor on ``device``. With ``non_blocking`` a
    numpy array bound for the card is copied into pinned memory first, so
    the copy is queued on the current stream and the host goes on."""
    if isinstance(v, np.ndarray):
        pin = non_blocking and torch.device(device).type == "cuda"
        if v.dtype == np.uint16:
            t = _host_tensor(v.view(np.int16), pin)
            return t.to(device, non_blocking=non_blocking).to(torch.int32) & 0xFFFF
        return _host_tensor(v, pin).to(device, non_blocking=non_blocking)
    if isinstance(v, torch.Tensor):
        return v.to(device, non_blocking=non_blocking)
    return v


def _host_tensor(a: np.ndarray, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if pin else t


class _Tree:
    """Shared behaviour: functional ``replace`` and a device move that
    converts every array leaf and keeps the static fields."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device, non_blocking: bool = False):
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (np.ndarray, torch.Tensor)):
                changes[f.name] = leaf_to(v, device, non_blocking)
        return dataclasses.replace(self, **changes)


@dataclass
class SparseLevel(_Tree):
    """One stride level of the coordinate pyramid.

    coords: (capacity, 1 + d) — (batch_idx, x, y, z); None in compact
        builds, which ship ``batch_starts`` instead.
    num: number of layout rows (real + sentinel) — a Python int.
    stride: tensor stride (1, 2, 4, ... in voxel units).
    valid: (capacity,) {0, 1} — 1 for real voxel rows.
    batch_starts: (B + 1,) per-scene row starts over the padded layout
        (rows are batch-major, so the batch column is recoverable).
    """

    coords: Optional[Any]
    num: int
    stride: int
    valid: Optional[Any] = None
    batch_starts: Optional[Any] = None

    def __post_init__(self):
        self.num = int(self.num)

    @property
    def capacity(self) -> int:
        if self.coords is not None:
            return int(self.coords.shape[0])
        return int(self.valid.shape[0])

    def mask(self, dtype=torch.float32) -> torch.Tensor:
        """(capacity,) validity mask: 1 for real voxel rows, 0 for padding
        and sentinel rows."""
        if self.valid is not None:
            return torch.as_tensor(self.valid).to(dtype)
        dev = self.coords.device
        return (torch.arange(self.capacity, device=dev) < self.num).to(dtype)

    @property
    def batch_idx(self) -> torch.Tensor:
        """(capacity,) int32 scene id per row. Reads the coords' batch
        column when shipped; compact batches count the interior scene
        boundaries at or below each row (padding rows map to the last
        scene — consumers mask them out via ``mask()``)."""
        if self.coords is not None:
            return torch.as_tensor(self.coords)[:, 0].to(torch.int32)
        starts = torch.as_tensor(self.batch_starts)
        rows = torch.arange(self.capacity, dtype=torch.int32,
                            device=starts.device)
        return (rows[:, None] >= starts[None, 1:-1]).sum(dim=1).to(torch.int32)


@dataclass
class KernelMap(_Tree):
    """Padded neighbor-index table for one conv geometry.

    idx: (K, out_capacity) int32 — input row per (slot, output row), -1 if
        the neighbor is missing. A (K, 1) table is the dummy left where a
        fused map serves the conv and the flat table was dropped.
    """

    idx: Any
    center_slot: int = -1
    mirror_perm: Optional[Tuple[int, ...]] = None
    companion: Optional[str] = None
    droppable: bool = False

    @property
    def num_offsets(self) -> int:
        return int(self.idx.shape[0])

    @property
    def out_capacity(self) -> int:
        return int(self.idx.shape[1])


@dataclass
class MaskedShiftMap(_Tree):
    """Masked-shift map of a stride-1 k3 conv (see ops/msconv.py).

    T3 = [x_prev*mp | x*mc | x_next*mn] serves each (dx, dy) offset column
    with one row anchored at the column's dz=0 entry (or at a sentinel row
    interleaved at a z-run boundary).

    mp, mn, mc: (cap,) uint8 {0, 1} masks.
    anchors: (8, cap) — int32 rows, or int16 deltas against the output row
        with -32768 as the guard (production builds); guard = cap.
    ov_in / ov_out / ov_off: column-major overflow COO for anchors the
        windowed paths do not reach. Those anchors are guarded in
        ``anchors``; every forward path (gather or selector) adds the COO
        back exactly once.
    wstart: (n_tiles * 8,) selector window starts, tile-major; empty when
        no (tile, win) geometry fits.
    inv_anchors, inv_wstart, dwov_*: the inverse tiling the backward uses.
    cols: (G, 3) slot triples, center column first.
    """

    mp: Any
    mn: Any
    mc: Any
    anchors: Any
    ov_in: Any
    ov_out: Any
    ov_off: Any
    wstart: Any
    inv_anchors: Any
    inv_wstart: Any
    dwov_in: Any
    dwov_out: Any
    dwov_off: Any
    cols: Tuple[Tuple[int, int, int], ...] = ()
    mirror_perm: Tuple[int, ...] = ()
    ov_seg: int = 0
    dwov_seg: int = 0
    tile: int = 0
    win: int = 0
    companion: Optional[str] = None

    @property
    def out_capacity(self) -> int:
        return int(self.mp.shape[0])


@dataclass
class ParentMap(_Tree):
    """Map where every output row has at most one (input row, slot) pair.

    parent: (cap_out,) int32 input row (0 if none).
    kslot: (cap_out,) slot, or num_slots if no parent.
    """

    parent: Any
    kslot: Any
    num_slots: int = 0
    companion: Optional[str] = None


@dataclass
class ChildSumMap(_Tree):
    """Child-sum annotation of a strided (down) conv.

    The down map partitions the input rows: each contributes to exactly one
    (parent output, slot) pair, so out[o] = sum_{i: parent[i] == o}
    x[i] @ W[kslot[i]]. ``wstart`` holds one 128-aligned input window per
    (output tile, slot group), tile-major; children outside their tile's
    window ride the ov COO. Guard rows carry parent = cap_out and
    kslot = num_slots. A uint16 ``parent`` holds deltas against
    ``parent_base`` (one base per 128 input rows); an empty
    ``parent_base`` means ``parent`` is absolute.
    """

    wstart: Any
    parent: Any
    kslot: Any
    ov_in: Any
    ov_out: Any
    ov_off: Any
    parent_base: Any = field(default_factory=lambda: np.zeros(0, np.int32))
    num_slots: int = 0
    out_capacity_s: int = 0
    ov_seg: int = 0
    tile: int = 0
    win: int = 0
    in_capacity: int = 0
    companion: Optional[str] = None
    n_groups: int = 1

    @property
    def out_capacity(self) -> int:
        return self.out_capacity_s


@dataclass
class ConvGraph(_Tree):
    """The coordinate pyramid and every kernel map a model needs.

    ``maps`` holds the flat tables by map name ("l2.k3", "down1", "up3");
    ``gmaps`` the fused representations the convs prefer.
    """

    levels: Tuple[SparseLevel, ...]
    maps: Mapping[str, KernelMap]
    gmaps: Mapping[str, Any] = field(default_factory=dict)

    def to(self, device, non_blocking: bool = False) -> "ConvGraph":
        return ConvGraph(
            levels=tuple(l.to(device, non_blocking) for l in self.levels),
            maps={k: m.to(device, non_blocking) for k, m in self.maps.items()},
            gmaps={k: m.to(device, non_blocking)
                   for k, m in (self.gmaps or {}).items()},
        )

