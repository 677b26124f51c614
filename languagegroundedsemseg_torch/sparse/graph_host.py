"""Host-side (numpy) coordinate pyramid + kernel-map builder.

This is the production input-pipeline path: kernel maps depend only on
coordinates, so they are built on the host (vectorized numpy int64-key
searchsorted joins; a C++ builder plugs in behind the same API) while the
TPU runs the previous step. Mirrors what MinkowskiEngine's coordinate
manager computes on GPU (reference models/modules/common.py:192-203), but
with static capacities so the device graph never recompiles.

Key packing: (b, x, y, z) -> int64 with 16 bits per field. Coordinates must
lie in [-2^15, 2^15) and batch index in [0, 2^16) — comfortably above any
ScanNet scene at 2 cm voxels (~2000 voxels extent, reference
lib/datasets/scannet.py:442).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from languagegroundedsemseg_torch.sparse.offsets import ConvKind, region_offsets
from languagegroundedsemseg_torch.sparse.types import (
    ConvGraph,
    KernelMap,
    MaskedShiftMap,
    ParentMap,
    ChildSumMap,
    SparseLevel,
)

# Constants of the reference builder that decide anchors, windows and which
# flat tables are dropped. They are copies, not imports, because the port
# never imports the JAX package; they must stay equal to the reference's
# (languagegroundedsemseg_tpu/ops/msconv.py GWIN_MARGIN and
# ops/onehot_conv.py VMEM_BUDGET / _vmem_estimate) for the two builders to
# emit array-equal graphs.
#
# |anchor - out_row| bound for kept anchors; farther ones ride the overflow
# COO (and int16 anchor deltas stay in range).
GWIN_MARGIN = 16384
# Per-step on-chip budget of the selector kernel the reference sizes its
# window menu against; here it only decides whether a flat k3 table ships.
VMEM_BUDGET = 24 * 1024 * 1024


def _vmem_estimate(n_cols: int, tile: int, win: int, c_out: int) -> int:
    """Per-step footprint of the reference selector kernel: double-buffered
    column windows (bf16) + selector (bf16) + acc/out tiles (f32) + anchors
    block."""
    return (
        2 * n_cols * win * c_out * 2
        + tile * win * 2
        + 3 * tile * c_out * 4
        + n_cols * tile * 4
    )


_COORD_OFF = 1 << 15
_FIELD_BITS = 16
_FIELD_MASK = (1 << _FIELD_BITS) - 1


# 4D (spatio-temporal) layout: b(12) | x(13) | y(13) | z(13) | t(12) = 63 bits
_BITS_4D = (12, 13, 13, 13, 12)
_OFF_4D = (0, 1 << 12, 1 << 12, 1 << 12, 1 << 11)


def pack_keys(coords: np.ndarray) -> np.ndarray:
    """Pack (N, 1+d) int (b, x, y, z[, t]) rows into unique int64 keys.

    d=3 uses the 16-bit-per-field layout (matches the C++ builder); d=4 packs
    (12,13,13,13,12) bits with signed offsets.
    """
    c = np.asarray(coords, dtype=np.int64)
    assert c.ndim == 2 and c.shape[1] in (4, 5), f"expected (N, 4|5), got {c.shape}"
    if c.shape[1] == 5:
        key = np.zeros(len(c), dtype=np.int64)
        shift = 0
        for col in range(4, -1, -1):
            bits, off = _BITS_4D[col], _OFF_4D[col]
            v = c[:, col] + off
            if v.size and (int(v.min()) < 0 or int(v.max()) >= (1 << bits)):
                raise ValueError(f"4D coord column {col} out of packable range")
            key |= v << shift
            shift += bits
        return key
    b = c[:, 0]
    xyz = c[:, 1:] + _COORD_OFF
    if xyz.size:
        lo, hi = int(xyz.min()), int(xyz.max())
        if lo < 0 or hi > _FIELD_MASK:
            raise ValueError(
                f"coordinates out of packable range [-32768, 32767]: "
                f"min={lo - _COORD_OFF}, max={hi - _COORD_OFF}"
            )
    return (
        (b << (3 * _FIELD_BITS))
        | (xyz[:, 0] << (2 * _FIELD_BITS))
        | (xyz[:, 1] << _FIELD_BITS)
        | xyz[:, 2]
    )


def unpack_keys(keys: np.ndarray, d: int = 3) -> np.ndarray:
    k = np.asarray(keys, dtype=np.int64)
    if d == 4:
        cols = []
        shift = 0
        for col in range(4, -1, -1):
            bits, off = _BITS_4D[col], _OFF_4D[col]
            cols.append(((k >> shift) & ((1 << bits) - 1)) - off)
            shift += bits
        return np.stack(cols[::-1], axis=1).astype(np.int32)
    b = k >> (3 * _FIELD_BITS)
    x = ((k >> (2 * _FIELD_BITS)) & _FIELD_MASK) - _COORD_OFF
    y = ((k >> _FIELD_BITS) & _FIELD_MASK) - _COORD_OFF
    z = (k & _FIELD_MASK) - _COORD_OFF
    return np.stack([b, x, y, z], axis=1).astype(np.int32)


def quantize(
    coords: np.ndarray,
    labels: Optional[np.ndarray] = None,
    ignore_label: int = 255,
    return_inverse: bool = False,
):
    """Deduplicate integer voxel coordinates.

    Equivalent of ME.utils.sparse_quantize as used by the reference voxelizer
    (lib/voxelizer.py:142): returns indices of one representative point per
    occupied voxel (first occurrence). If ``labels`` is given, voxels whose
    points disagree on the label get ``ignore_label`` (the consensus variant
    used at lib/voxelizer.py:284).

    Accepts (N, 3) single-sample coords (treated as batch 0) or (N, 4)
    batched coords.
    """
    c = np.asarray(coords)
    if c.shape[1] == 3:
        c = np.concatenate([np.zeros((c.shape[0], 1), dtype=c.dtype), c], axis=1)
    keys = pack_keys(c)
    uniq_keys, first_idx, inverse = np.unique(keys, return_index=True, return_inverse=True)

    out = [first_idx]
    if labels is not None:
        lab = np.asarray(labels)
        # Voxel label consensus: min == max over the group -> agreed.
        nvox = uniq_keys.shape[0]
        big = np.iinfo(np.int64).max
        gmin = np.full(nvox, big, dtype=np.int64)
        gmax = np.full(nvox, -big, dtype=np.int64)
        np.minimum.at(gmin, inverse, lab.astype(np.int64))
        np.maximum.at(gmax, inverse, lab.astype(np.int64))
        vox_labels = np.where(gmin == gmax, gmin, ignore_label).astype(lab.dtype)
        out.append(vox_labels)
    if return_inverse:
        out.append(inverse)
    return out[0] if len(out) == 1 else tuple(out)


class _Lookup:
    """Sorted-key exact lookup table: packed int64 key -> row index."""

    __slots__ = ("sorted_keys", "sorted_rows")

    def __init__(self, keys: np.ndarray, rows: Optional[np.ndarray] = None):
        order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[order]
        self.sorted_rows = order.astype(np.int32) if rows is None else rows[order]

    def query(self, keys: np.ndarray) -> np.ndarray:
        """Return row index for each key, or -1 if absent."""
        if self.sorted_keys.size == 0:
            return np.full(keys.shape, -1, dtype=np.int32)
        pos = np.searchsorted(self.sorted_keys, keys)
        pos = np.minimum(pos, self.sorted_keys.size - 1)
        hit = self.sorted_keys[pos] == keys
        return np.where(hit, self.sorted_rows[pos], -1).astype(np.int32)


@dataclass(frozen=True)
class MapSpec:
    """Static description of one kernel map: which levels it connects and
    the conv geometry that generates it. ``companion`` names the map whose
    geometry is this map's transpose (down <-> up pairs) — the conv backward
    uses it to stay gather-based instead of scatter-based."""

    level_in: int
    level_out: int
    kind: ConvKind
    companion: Optional[str] = None
    # z-run fusion width for this map's consumers: 3 when 3*C <= 128 lane
    # elements, 2 when 2*C <= 128, else 1 (flat). Set from the model's known
    # channel widths (the gather fast path is capped at 128-element rows).
    fuse_width: int = 1
    # ship the flat (K, cap) table alongside the fused one: required when the
    # map has consumers whose channel width exceeds the fused fast path
    # (e.g. l1.k3 serves both the C=32 encoder and the C=96 decoder)
    keep_flat: bool = True


def _mirror_permutation(offs: np.ndarray) -> Optional[tuple]:
    """Permutation p with offs[p[k]] == -offs[k], or None if asymmetric."""
    table = {tuple(int(v) for v in o): i for i, o in enumerate(offs)}
    perm = []
    for o in offs:
        j = table.get(tuple(int(-v) for v in o))
        if j is None:
            return None
        perm.append(j)
    return tuple(perm)


@dataclass(frozen=True)
class GraphSpec:
    """Everything the graph builder needs to know about a model's geometry.

    num_levels: pyramid depth (Res16UNet: 5 — strides 1, 2, 4, 8, 16).
    maps: name -> MapSpec. Pointwise (k=1) convs need no map.
    """

    num_levels: int
    maps: Dict[str, MapSpec] = field(default_factory=dict)
    d: int = 3

    def union(self, other: "GraphSpec") -> "GraphSpec":
        maps = dict(self.maps)
        for k, v in other.maps.items():
            if k in maps:
                assert maps[k] == v, f"conflicting MapSpec for {k}"
            maps[k] = v
        return GraphSpec(max(self.num_levels, other.num_levels), maps, self.d)


def _pad_rows(arr: np.ndarray, capacity: int, fill) -> np.ndarray:
    n = arr.shape[0]
    if n >= capacity:
        return arr[:capacity]
    pad_shape = (capacity - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)


def default_capacities(n0_capacity: int, num_levels: int, ratios: Sequence[float] = None, multiple: int = 128) -> Tuple[int, ...]:
    """Per-level capacities derived from the level-0 capacity.

    Defaults are conservative (stride-2 in 3D indoor scenes empirically
    shrinks voxel counts ~6x; we budget 2x) so overflow truncation —
    the analog of the reference's ``limit_numpoints`` drop policy
    (lib/transforms.py:405-411) — is vanishingly rare.
    """
    if ratios is None:
        ratios = [1.0 / (2 ** l) for l in range(num_levels)]
    caps = []
    for l in range(num_levels):
        c = int(np.ceil(n0_capacity * ratios[l]))
        # big levels round to whole one-hot conv tiles (ops/onehot_conv.py)
        m = 1024 if c >= 4096 else multiple
        c = max(m, ((c + m - 1) // m) * m)
        caps.append(c)
    return tuple(caps)


def build_pyramid(
    coords0: np.ndarray, num_levels: int, d: int = 3
) -> Tuple[list, list]:
    """Coordinate pyramid: level l coords are the unique values of
    ``floor(level_{l-1} / (2 * stride)) * (2 * stride)`` — ME's stride map
    semantics for the kernel-size-2/stride-2 downsample convs of Res16UNet.

    Returns (list of (N_l, 4) coords arrays, list of packed-key arrays).
    Level order within each level is first-occurrence order of the sorted
    parent keys (deterministic).
    """
    coords0 = np.asarray(coords0, dtype=np.int32)
    levels = [coords0]
    keys = [pack_keys(coords0)]
    cur = coords0
    for l in range(1, num_levels):
        s = 1 << l  # stride of the new level
        down = cur.copy()
        # only spatial axes downsample; the temporal axis (d=4) keeps stride 1
        down[:, 1:4] = np.floor_divide(down[:, 1:4], s) * s
        uk = np.unique(pack_keys(down))  # sorted-key order: required for the
        # z-run contiguity that grouped kernel maps exploit
        nxt = unpack_keys(uk, d)
        levels.append(nxt)
        keys.append(uk)
        cur = nxt
    return levels, keys


def _kernel_map(
    out_coords: np.ndarray,
    in_lookup: _Lookup,
    kind: ConvKind,
    stride_in: int,
    stride_out: int,
    out_capacity: int,
    d: int,
) -> np.ndarray:
    """Build (K, out_capacity) gather-index table (int32, -1 = missing)."""
    if kind.transpose:
        # Upsampling: out row f pulls from coarse voxel at f - o_k, where the
        # offsets are in units of the *output* (finer) tensor stride — the
        # transpose of the matching strided conv's kernel map.
        offs = region_offsets(kind.region, kind.kernel_size, kind.dilation, stride_out, d)
        offs = -offs
    else:
        # Normal conv: out row c pulls from in voxel at c + o_k, offsets in
        # units of the *input* tensor stride.
        offs = region_offsets(kind.region, kind.kernel_size, kind.dilation, stride_in, d)

    k = offs.shape[0]
    n_out = out_coords.shape[0]
    idx = np.full((k, out_capacity), -1, dtype=np.int32)
    if n_out == 0:
        return idx
    # Vectorized join: (K * N_out) queries against the input level's table.
    targets = out_coords[None, :, 1:].astype(np.int64) + offs[:, None, :].astype(np.int64)
    b = np.broadcast_to(out_coords[None, :, :1].astype(np.int64), (k, n_out, 1))
    q = np.concatenate([b, targets], axis=2).reshape(-1, 1 + d)
    idx[:, :n_out] = in_lookup.query(pack_keys(q)).reshape(k, n_out)
    return idx


def _group_offset_runs(offs: np.ndarray, z_step: int, w_max: int = 5):
    """Group kernel offsets by their non-z prefix; split each column into
    maximal runs of consecutive z-offsets (step == the input level's tensor
    stride, which is the condition for the neighbors to occupy contiguous
    sorted rows), then chunk runs to length <= w_max (the xw window width).

    Returns a list of (dz_list, slot_list) with slots in ascending-dz order.
    """
    cols: dict = {}
    for k, o in enumerate(offs):
        cols.setdefault(tuple(int(v) for v in o[:-1]), []).append((int(o[-1]), k))
    groups = []
    for prefix in sorted(cols):
        entries = sorted(cols[prefix])
        runs, run = [], [entries[0]]
        for dz, k in entries[1:]:
            if dz == run[-1][0] + z_step:
                run.append((dz, k))
            else:
                runs.append(run)
                run = [(dz, k)]
        runs.append(run)
        for r in runs:
            for i in range(0, len(r), w_max):
                chunk = r[i : i + w_max]
                groups.append(([dz for dz, _ in chunk], [k for _, k in chunk]))
    return groups

def _k3_column_layout(offs: np.ndarray, z_step: int):
    """Decompose a stride-1 k3 region into its center column and the 8
    non-center (dx, dy) columns (slot triples in ascending dz), ordered for
    the one-hot window kernel: dx == 0 first, then dx < 0, then dx > 0.
    Returns (center_col, cols, windowable) or None when the region is not
    a full 3-wide-z hypercube."""
    groups = _group_offset_runs(offs, z_step, w_max=3)
    if any(len(ks) != 3 for _, ks in groups):
        return None
    center_col = None
    col_list = []
    for _, ks in groups:
        col_off = offs[ks[1]][:-1]
        if not col_off.any():
            center_col = tuple(int(k) for k in ks)
        else:
            dx = int(np.sign(col_off[0])) if len(col_off) >= 1 else 0
            dy = int(col_off[1]) if len(col_off) >= 2 else 0
            col_list.append((dx, dy, tuple(int(k) for k in ks)))
    if center_col is None:
        return None
    col_list.sort(key=lambda t: ({0: 0, -1: 1, 1: 2}.get(t[0], 3), t[1]))
    cols = [ks for _, _, ks in col_list]
    group_sizes = [1, 0, 0]
    for dx, _, _ in col_list:
        group_sizes[{0: 0, -1: 1, 1: 2}.get(dx, 0)] += 1
    windowable = len(cols) == 8 and tuple(group_sizes) == (3, 3, 3)
    return center_col, cols, windowable


def _sentinel_plan(idx: np.ndarray, offs: np.ndarray, z_step: int, num: int):
    """Plan the sentinel zero rows a level needs so its stride-1 k3 map can
    fuse leftover-free (ops/msconv.py): for every output whose dz=0
    neighbor is missing but a dz=+-1 neighbor exists, a zero row at that
    run boundary (with masks exposing exactly the true neighbors) lets the
    fused path serve the contribution with its one anchored gather.

    Returns (ins_pos, ins_mp, ins_mn) — insert j goes after row ins_pos[j]
    (-1 = before row 0), sorted ascending with at most [bottom, top] two
    rows per boundary — or None when the map shape doesn't decompose.

    Demand kinds per (output, column), from the flat map's slot triples:
      combined  dz=-1 and dz=+1 exist (size-1 z-hole, rows adjacent):
                one row, mp=mn=1 -> [x[r] | 0 | x[r+1]].
      bottom    only dz=-1 (row r = top of a run): mp=1, mn=0.
      top       only dz=+1 (row c = start of a run): mp=0, mn=1.
    A combined boundary can host no bottom/top-only demand (the size-1 hole
    forces every demand there to see both neighbors), so the allocation is
    conflict-free; bottom-only and top-only at one boundary get two rows
    in that order, matching the anchor rules a+1 / c-1 in the fuse pass.
    """
    layout = _k3_column_layout(offs, z_step)
    if layout is None:
        return None
    _, cols, _ = layout
    both_l, bot_l, top_l = [], [], []
    for kA, kB, kC in cols:
        a = idx[kA][:num].astype(np.int64)
        b = idx[kB][:num].astype(np.int64)
        c = idx[kC][:num].astype(np.int64)
        av, bv, cv = a >= 0, b >= 0, c >= 0
        both = av & cv & ~bv
        if np.any(both):
            ab, cb = a[both], c[both]
            if np.any(cb != ab + 1):
                return None  # size-1 hole rows must be physically adjacent
            both_l.append(ab)
        bot_l.append(a[av & ~cv & ~bv])
        top_l.append(c[cv & ~av & ~bv] - 1)
    both_u = np.unique(np.concatenate(both_l)) if both_l else np.zeros(0, np.int64)
    bot_u = np.unique(np.concatenate(bot_l))
    top_u = np.unique(np.concatenate(top_l))
    # combined boundaries exclude one-sided demands (see docstring); if the
    # invariant is ever violated, bail out rather than mis-serve
    if (np.intersect1d(both_u, bot_u).size
            or np.intersect1d(both_u, top_u).size):
        return None
    # one row per combined boundary (mp=mn=1); a boundary with bottom-only
    # AND top-only demand gets two rows in that order (the a+1 / c-1 anchor
    # rules) — stable sort on (position, kind-rank) with bottom before top
    pos = np.concatenate([both_u, bot_u, top_u])
    mps = np.concatenate([np.ones(both_u.size + bot_u.size, np.float32),
                          np.zeros(top_u.size, np.float32)])
    mns = np.concatenate([np.ones(both_u.size, np.float32),
                          np.zeros(bot_u.size, np.float32),
                          np.ones(top_u.size, np.float32)])
    rank = np.concatenate([np.zeros(both_u.size + bot_u.size, np.int8),
                           np.ones(top_u.size, np.int8)])
    order = np.lexsort((rank, pos))
    return pos[order], mps[order], mns[order]


def flex_bucket(n: int) -> int:
    """Round a row count up to a coarse step (~6% max pad) so jit shapes
    quantize to a handful per size octave. Counts past 3k round to whole
    one-hot conv tiles (ops/onehot_conv.py TILE)."""
    n = max(int(n), 128)
    step = max(128, 1 << max(n - 1, 1).bit_length() - 4)
    if n > 3 * 1024:
        step = max(step, 1024)
    return -(-n // step) * step


def plan_sentinels(
    spec: "GraphSpec",
    nums: list,
    maps_idx: Dict[str, np.ndarray],
) -> dict:
    """Per-level sentinel plans for the fusable stride-1 k3 maps.

    Returns {level: (map_name, (ins_pos, ins_mp, ins_mn))} for levels with
    nonzero demand; positions index *real* rows (< nums[level]) so the plan
    is valid under any level capacity >= nums[level] + len(ins_pos).
    """
    k3_by_level = {}
    for name, ms in spec.maps.items():
        ks = ms.kind.kernel_size if isinstance(ms.kind.kernel_size, int) else max(ms.kind.kernel_size)
        if (not ms.kind.transpose and ms.kind.stride == 1
                and ms.level_in == ms.level_out and ms.fuse_width >= 2
                and ks % 2 == 1 and ks > 1):
            k3_by_level.setdefault(ms.level_in, (name, ms))

    d = spec.d
    plans: dict = {}
    for l, (name, ms) in k3_by_level.items():
        stride = (1 << l) if d == 3 else 1  # d=4: temporal axis is fastest, stride 1
        offs = region_offsets(ms.kind.region, ms.kind.kernel_size,
                              ms.kind.dilation,
                              (1 << l) if d == 3 else ((1 << l),) * 3 + (1,), d)
        plan = _sentinel_plan(maps_idx[name], offs, stride, nums[l])
        if plan is not None and len(plan[0]):
            plans[l] = (name, plan)
    return plans


def expand_sentinels(
    spec: "GraphSpec",
    capacities: Sequence[int],
    kept_coords: list,
    nums: list,
    maps_idx: Dict[str, np.ndarray],
    plans: Optional[dict] = None,
) -> list:
    """Interleave sentinel zero rows into each level's row layout and remap
    every kernel map into the expanded index space.

    For each level with a fusable stride-1 k3 map, plans the sentinel rows
    (_sentinel_plan / precomputed ``plans``), inserts them at their sorted
    positions (so anchors stay local for the windowed kernels), and rewrites
    all maps' input values and output columns. Mutates kept_coords / nums /
    maps_idx.

    Returns per-level dicts {new_pos, is_sent, mp_s, mn_s, valid, num} (or
    None for levels that were not expanded — no k3 map, no demand, or the
    sentinel rows would overflow the level capacity, in which case the k3
    map simply stays on the flat path).
    """
    n_levels = spec.num_levels
    old_nums = list(nums)
    info: list = [None] * n_levels

    if plans is None:
        plans = plan_sentinels(spec, nums, maps_idx)

    for l in range(n_levels):
        if l not in plans:
            continue
        _, (ins_pos, ins_mp, ins_mn) = plans[l]
        num = old_nums[l]
        s_count = len(ins_pos)
        cap = capacities[l]
        if s_count == 0 or num + s_count > cap:
            continue
        # new position of real row i: i + #{inserts at positions < i}
        new_pos = (np.arange(num, dtype=np.int64)
                   + np.searchsorted(ins_pos, np.arange(num, dtype=np.int64)))
        sent_rows = ins_pos + 1 + np.arange(s_count, dtype=np.int64)
        is_sent = np.zeros(cap, bool)
        is_sent[sent_rows] = True
        mp_s = np.zeros(cap, np.float32)
        mn_s = np.zeros(cap, np.float32)
        mp_s[sent_rows] = ins_mp
        mn_s[sent_rows] = ins_mn
        valid = np.zeros(cap, np.float32)
        valid[new_pos] = 1.0
        coords_new = np.zeros((cap,) + kept_coords[l].shape[1:],
                              kept_coords[l].dtype)
        coords_new[new_pos] = kept_coords[l][:num]
        # sentinel rows inherit the boundary's left real row's coords (for
        # batch grouping; the valid mask excludes them from every statistic)
        src = np.clip(ins_pos, 0, max(num - 1, 0))
        coords_new[sent_rows] = kept_coords[l][src]
        kept_coords[l] = coords_new
        nums[l] = num + s_count
        info[l] = dict(new_pos=new_pos.astype(np.int32), is_sent=is_sent,
                       mp_s=mp_s, mn_s=mn_s, valid=valid, num=num + s_count)

    if all(v is None for v in info):
        return info

    # Native one-pass remap (csrc lgs_remap_map) — the numpy composition
    # below costs 3 full-map passes/copies per map and dominated the batch
    # finalize time; the ctypes path fuses them and releases the GIL.
    try:
        from languagegroundedsemseg_torch.sparse.graph_native import remap_map_native
    except Exception:  # pragma: no cover - import cycle guard
        remap_map_native = None

    for name, ms in spec.maps.items():
        in_info, out_info = info[ms.level_in], info[ms.level_out]
        if in_info is None and out_info is None:
            continue
        idx = maps_idx[name]
        if idx.shape[1] == 1 and capacities[ms.level_out] > 1:
            continue  # build-time dummy (native up-map skip): nothing to remap
        n_out_old = old_nums[ms.level_out]
        if remap_map_native is not None:
            n_in_old = old_nums[ms.level_in]
            table = (in_info["new_pos"][:n_in_old].astype(np.int32)
                     if in_info is not None else None)
            colmap = None
            if out_info is not None:
                colmap = np.full(idx.shape[1], n_out_old, np.int32)
                colmap[out_info["new_pos"]] = np.arange(n_out_old, dtype=np.int32)
            out = remap_map_native(idx, n_out_old, table=table, colmap=colmap)
            if out is not None:
                maps_idx[name] = out
                continue
        vals = idx[:, :n_out_old]
        if in_info is not None:
            # remap input rows through a lookup table; slot -1 at the END so
            # numpy's negative-index wraparound maps missing (-1) entries to
            # -1 with no mask/clip/where passes (this loop runs over every
            # (K, cap) table each batch — keep it single-gather int32)
            n_in_old = old_nums[ms.level_in]
            table = np.empty(n_in_old + 1, np.int32)
            table[:n_in_old] = in_info["new_pos"][:n_in_old]
            table[n_in_old] = -1
            vals = table[vals]
        if out_info is not None:
            # column gather through a small permutation (one pass over the
            # table): new column j reads old column colmap[j], with the
            # appended all--1 column serving rows that have no old column.
            # (np.full_like + fancy scatter measured ~5x slower here.)
            k = idx.shape[0]
            cap_out = idx.shape[1]
            colmap = np.full(cap_out, n_out_old, np.int32)
            colmap[out_info["new_pos"]] = np.arange(n_out_old, dtype=np.int32)
            vals_ext = np.concatenate(
                [vals, np.full((k, 1), -1, idx.dtype)], axis=1)
            maps_idx[name] = vals_ext[:, colmap]
        else:
            idx[:, :n_out_old] = vals
    return info


# Selector-kernel window geometry (ops/onehot_conv.py): per-(tile, column)
# median-centered windows chosen from a static (tile, win) menu — smaller
# windows cost proportionally fewer selector-matmul FLOPs, so the first
# config whose out-of-window anchor count fits the overflow budget (in BOTH
# the forward and the inverse/dW tiling) wins. Out-of-window anchors are
# routed into the small overflow COO (and guarded in the anchors array so
# no path double counts) instead of disabling the kernel outright.
# Geometry constraints learned the hard way (round 5): Mosaic HANGS
# (not errors) compiling the k3 selector kernel at tile=128 and at
# fractional lane-tile window widths (320, 448) — only the shipped
# (tile >= 256, win a multiple of 512/tile... ) combinations below are
# proven to compile. Do not add smaller k3 windows without a standalone
# compile trial first (scripts/bench_onehot_pallas.py).
_WINDOW_MENU = (
    (256, 512), (512, 1024), (256, 1024),
    (1024, 2048), (512, 2048), (1024, 4096),
)


def _menu_from_pin(menu, pin):
    """Menu suffix for a pinned window (jit-signature stabilization).

    The pin is the contract's current (tile, win) for this map; builds may
    only move FORWARD in menu order (toward costlier geometries) so the
    per-map window state is monotone and converges: a denser batch that
    cannot satisfy the pinned budget upgrades the pin, a sparser batch
    accepts it. pin == (0, 0) pins the no-window fallback permanently."""
    if pin is None:
        return menu
    if not pin[0]:
        return ()
    pin = tuple(int(v) for v in pin)
    for i, tw in enumerate(menu):
        if tuple(tw) == pin:
            return menu[i:]
    return menu


def _percol_windows(anchors, cap, tile, win, cap_in=None, center="median",
                    sort_cache=None):
    """Median-centered per-(tile, column) window starts.

    Returns (wstart (n_cols, n_tiles) int32, bad (n_cols, n_rows) bool):
    bad marks non-guard anchors outside their tile's window. Starts are
    8-row aligned and clamped to [0, cap_in - win], so windows never leave
    the anchored array and the guard value ``cap_in`` can never land
    inside one. ``cap_in`` is the anchored (input) array's row count —
    defaults to ``cap`` (= the output tiling length, the k3 same-level
    case); strided down maps anchor a different level's rows.

    sort_cache, if given, memoizes the per-tile integer sort by ``tile``
    across menu trials of the SAME anchors array (the sort dominates this
    function's cost and the menu reuses each tile size with several
    window widths).
    """
    if cap_in is None:
        cap_in = cap
    n_cols = anchors.shape[0]
    n_tiles = cap // tile
    av = anchors.reshape(n_cols, n_tiles, tile)
    if center == "midrange":
        # midrange of valid anchors: spreads are wide and skewed for
        # strided maps, where the median wastes half the window
        valid = av < cap_in
        lo = np.where(valid, av, np.int64(1) << 40).min(axis=2)
        hi = np.where(valid, av, -1).max(axis=2)
        med = np.where(hi >= 0, (lo.astype(np.int64) + hi) // 2, -1)
        cnt = (hi >= 0).astype(np.int64)
    else:
        # lower median via integer sort: guard anchors (= cap_in) sort to
        # the end, so the median of valid entries sits at index
        # (count-1)//2. (An order of magnitude faster than nanmedian's
        # masked-array path — this runs per menu trial per map per batch.)
        if sort_cache is not None and tile in sort_cache:
            srt, cnt = sort_cache[tile]
        else:
            srt = np.sort(av, axis=2)
            cnt = (srt < cap_in).sum(axis=2)
            if sort_cache is not None:
                sort_cache[tile] = (srt, cnt)
        mid = np.maximum(cnt - 1, 0) // 2
        med = np.take_along_axis(srt, mid[:, :, None], axis=2)[:, :, 0].astype(np.int64)
    # all-guard tiles get a proportional default position
    default = np.arange(n_tiles, dtype=np.int64) * tile * max(cap_in // cap, 1)
    med = np.where(cnt > 0, med, default[None, :])
    w0 = (np.clip(med - win // 2, 0, cap_in - win)) & ~7
    bad = (av < cap_in) & ((av < w0[:, :, None]) | (av >= w0[:, :, None] + win))
    return w0.astype(np.int32), bad.reshape(n_cols, cap)


def _route_bad(anchors, bad, guard=None):
    """Guard out-of-window anchors; return their (cols, out_rows, anchors)
    COO entry arrays."""
    gis, outs = np.nonzero(bad)
    entries = (gis.astype(np.int64), outs.astype(np.int64),
               anchors[gis, outs].astype(np.int64))
    anchors[bad] = anchors.shape[1] if guard is None else guard
    return entries


def _cat_entries(a, b):
    """Concatenate two (cols, outs, ins) entry triples."""
    return tuple(np.concatenate([x, y]) for x, y in zip(a, b))


_EMPTY_ENTRIES = (np.zeros(0, np.int64),) * 3


def _pack_ov(ov_entries, n_cols, ov_cap, cap, guard_in=None, guard_out=None):
    """Column-major padded COO arrays (see MaskedShiftMap.ov_*).

    ov_entries is a (cols, out_rows, anchors) triple of equal-length int64
    arrays. Static bounds are TIGHT power-of-2 buckets of the actual
    counts, not the acceptance budget: ov_seg bounds the per-column
    dynamic_slice and the array is padded so the last column's slice stays
    in bounds. The old ``ov_seg = ov_cap`` padding made the device process
    2*ov_cap gather rows and 8*ov_cap GEMM rows per conv regardless of the
    real overflow (12x the needed work at bench shapes). Pow-2 bucketing
    keeps jit cache churn bounded while tracking the data.
    """
    ov_off = np.zeros(n_cols + 1, np.int32)
    if len(ov_entries[0]) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), ov_off, 512
    gis, ov_out, ov_in = ov_entries
    order = np.lexsort((ov_in, ov_out, gis))
    gis, ov_out, ov_in = gis[order], ov_out[order], ov_in[order]
    counts = np.bincount(gis, minlength=n_cols)
    ov_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    ov_seg = max(512, 1 << int(np.ceil(np.log2(max(int(counts.max()), 1)))))
    n_real = len(ov_out)
    arr = max(1024, 1 << int(np.ceil(np.log2(n_real + ov_seg))))
    pad = arr - n_real
    ov_out = np.concatenate(
        [ov_out, np.full(pad, cap if guard_out is None else guard_out)]
    ).astype(np.int32)
    ov_in = np.concatenate(
        [ov_in, np.full(pad, cap if guard_in is None else guard_in)]
    ).astype(np.int32)
    return ov_in, ov_out, ov_off, int(ov_seg)


def _try_masked_shift_map(
    idx: np.ndarray,
    offs: np.ndarray,
    z_step: int,
    width: int,
    n_in: int,
    mirror_perm=None,
    companion=None,
    sent: Optional[dict] = None,
    validate: bool = True,
    pin_tilewin: Optional[Tuple[int, int]] = None,
) -> "Optional[MaskedShiftMap]":
    """Fuse a flat stride-1 k3 map into a MaskedShiftMap (ops/msconv.py),
    or None when the map's shape doesn't fit (non-3-z-columns, asymmetric
    region, in != out sets), the sorted z-contiguity invariant fails, or a
    gap output has no sentinel row to anchor (level not expanded) — the
    flat path is always correct, so every check fails safe.

    Everything derives from the flat table itself: a column's anchors are
    its dz=0 slot's rows (or the boundary sentinel row when dz=0 is
    missing — see expand_sentinels); mp/mn come from the center column's
    dz=-1/+1 slots, OR-ed with the sentinel masks; mc is the level's
    real-row mask (zeroes the center third at sentinel/pad rows).
    """
    if int(width) < 3 or mirror_perm is None:
        return None
    layout = _k3_column_layout(offs, z_step)
    if layout is None:
        return None
    center_col, cols, windowable = layout
    cap = idx.shape[1]

    kAc, kBc, kCc = center_col
    rows = np.arange(cap, dtype=np.int64)
    # center dz=0 must be the identity over real rows (in == out sets).
    # The np.any scans below (here and per column) are INVARIANT CHECKS
    # that hold by construction for maps our own builders emit — the
    # production loader skips them (validate=False, ~60 full-cap passes
    # per map saved); direct build_graph callers and tests keep them.
    vB = idx[kBc] >= 0
    if validate:
        if np.any(idx[kBc][vB] != rows[vB]):
            return None
        if sent is not None and np.any(vB != (sent["valid"] > 0)):
            return None
    a = idx[kAc].astype(np.int64)
    c = idx[kCc].astype(np.int64)
    if validate and (np.any((a >= 0) & (a != rows - 1))
                     or np.any((c >= 0) & (c != rows + 1))):
        return None
    mp = (a >= 0).astype(np.float32)
    mn = (c >= 0).astype(np.float32)
    if sent is not None:
        mp = np.maximum(mp, sent["mp_s"])
        mn = np.maximum(mn, sent["mn_s"])
        is_sent = sent["is_sent"]
        mc = sent["valid"].astype(np.float32)
    else:
        is_sent = np.zeros(cap, bool)
        mc = vB.astype(np.float32)

    # all 8 columns at once: (n_cols, cap) slot-triple tables
    kAs = np.array([c[0] for c in cols])
    kBs = np.array([c[1] for c in cols])
    kCs = np.array([c[2] for c in cols])
    A, B, C = idx[kAs], idx[kBs], idx[kCs]
    av, bv, cv = A >= 0, B >= 0, C >= 0
    gapL = av & ~bv
    gapR = cv & ~av & ~bv
    if (gapL.any() or gapR.any()) and sent is None:
        return None
    if validate:
        b64 = B.astype(np.int64)
        # anchored triples read physical neighbors; contiguity assert
        if np.any(av & bv & (A != b64 - 1)) or np.any(cv & bv & (C != b64 + 1)):
            return None
        # the masks must not zero a true co-valid neighbor at the anchor
        banc = np.where(bv, b64, 0)
        if np.any(av & bv & (mp[banc] == 0)) or np.any(cv & bv & (mn[banc] == 0)):
            return None
        # gap outputs anchor the boundary sentinel: a+1 (bottom/combined)
        # or c-1 (top-only); the sentinel masks must serve exactly them
        if gapL.any():
            s_ = A[gapL].astype(np.int64) + 1
            if np.any(~is_sent[s_]) or np.any(mp[s_] == 0):
                return None
            # combined demands also need the right third live there
            comb = gapL & cv
            if comb.any():
                sc = A[comb].astype(np.int64) + 1
                if np.any(mn[sc] == 0) or np.any(C[comb] != sc + 1):
                    return None
            only = gapL & ~cv
            if only.any():
                so = A[only].astype(np.int64) + 1
                if np.any(mn[so] != 0):
                    return None
        if gapR.any():
            s_ = C[gapR].astype(np.int64) - 1
            if (np.any(~is_sent[s_]) or np.any(mn[s_] == 0)
                    or np.any(mp[s_] != 0)):
                return None
    anchors = np.where(bv, B, np.int32(cap))
    anchors = np.where(gapL, A + 1, anchors)
    anchors = np.where(gapR, C - 1, anchors).astype(np.int32)

    # Inverse anchor map over the COMPLETE pair set (before any routing):
    # the per-column anchor map is injective (a (dx, dy) translation between
    # subsets of the grid, sentinels included — each gap output anchors its
    # own boundary sentinel), so inv[gi, a] = o recovers every pair exactly
    # once. The selector-kernel dW consumes pairs through this inverse
    # tiling (ops/onehot_conv.py).
    n_cols = len(cols)
    inv_anchors = np.full((n_cols, cap), cap, np.int32)
    gi_v, out_v = np.nonzero(anchors < cap)
    inv_anchors[gi_v, anchors[gi_v, out_v]] = out_v

    # ---- overflow COO: anchors the windowed paths cannot reach ------------
    # (a) globally: |anchor - out| > GWIN_MARGIN breaks the windowed-gather
    # variant's bound (ops/msconv.py); (b) per tile: outside the selector
    # kernel's window (ops/onehot_conv.py). Routed entries are guarded in
    # the anchors array, so every path adds the ov term exactly once. dW
    # pairs are partitioned independently: inv_anchors (kernel) + dwov
    # (COO) also cover every pair exactly once.
    rows32 = np.arange(cap, dtype=np.int32)
    far_all = (anchors < cap) & (
        np.abs(anchors - rows32[None, :]) > GWIN_MARGIN)
    ov_entries = _route_bad(anchors, far_all)

    ov_cap = max(128, (cap // 16 + 127) // 128 * 128)
    wstart = np.zeros(0, np.int32)
    inv_wstart = np.zeros(0, np.int32)
    dwov_entries = _EMPTY_ENTRIES
    tile = win = 0
    sort_cache_f: dict = {}
    sort_cache_i: dict = {}
    # pin_tilewin (jit-signature stabilization, data/batching.py): restrict
    # the menu to the suffix starting at the pinned geometry so repeated
    # builds of similar batches converge on one window choice (= one
    # wstart length = one jit signature) while denser batches may still
    # upgrade it monotonically.
    for t_, w_ in _menu_from_pin(_WINDOW_MENU, pin_tilewin):
        if cap % t_ or cap < max(2 * t_, w_):
            continue
        ws_f, bad_f = _percol_windows(anchors, cap, t_, w_,
                                      sort_cache=sort_cache_f)
        ws_i, bad_i = _percol_windows(inv_anchors, cap, t_, w_,
                                      sort_cache=sort_cache_i)
        if (len(ov_entries[0]) + bad_f.sum() <= ov_cap
                and bad_i.sum() <= ov_cap):
            ov_entries = _cat_entries(ov_entries, _route_bad(anchors, bad_f))
            # dwov pairs in _ov_dw_pieces orientation: in = T3 row (the
            # anchor r), out = the gradient row (the output o)
            dwov_entries = _route_bad(inv_anchors, bad_i)
            wstart = ws_f.T.reshape(-1)  # tile-major (t * n_cols + gi)
            inv_wstart = ws_i.T.reshape(-1)
            tile, win = t_, w_
            break
    if len(ov_entries[0]) > ov_cap:
        return None  # pathological outlier count: flat fallback

    ov_in, ov_out, ov_off, ov_seg = _pack_ov(ov_entries, n_cols, ov_cap, cap)
    dwov_out, dwov_in, dwov_off, dwov_seg = _pack_ov(
        dwov_entries, n_cols, ov_cap, cap)

    if not validate:
        # Production builds ship a 0-width inv_anchors: it is a pure
        # function of (anchors, ov, dwov) and the device rebuilds it with
        # two scatters (ops/onehot_conv.py:_inv_from_anchors). At bench
        # shapes this drops ~30% of the batch's H2D bytes — material when
        # the host<->device link is the e2e bottleneck. validate=True
        # (tests/debug) keeps the host-built array so invariant tests can
        # inspect it.
        inv_anchors = np.zeros((n_cols, 0), np.int32)
        # ... and anchors as int16 row deltas: every kept anchor satisfies
        # |anchor - out| <= GWIN_MARGIN (= 16384, ops/msconv.py — the rest
        # was routed to the ov COO above), so the delta fits int16 with
        # -32768 reserved for the guard. Decoded on device at op entry
        # (ops/msconv.py:_abs_anchors). Halves the anchors' H2D bytes.
        delta = anchors.astype(np.int64) - np.arange(cap, dtype=np.int64)
        anchors = np.where(anchors == cap, -32768, delta).astype(np.int16)

    return MaskedShiftMap(
        # {0,1} masks ship (and stream on device) as uint8; every consumer
        # casts into the compute dtype (ops/msconv.py _t3)
        mp=mp.astype(np.uint8), mn=mn.astype(np.uint8),
        mc=mc.astype(np.uint8), anchors=anchors,
        ov_in=ov_in, ov_out=ov_out, ov_off=ov_off,
        wstart=wstart,
        inv_anchors=inv_anchors, inv_wstart=inv_wstart,
        dwov_in=dwov_in, dwov_out=dwov_out, dwov_off=dwov_off,
        cols=tuple([center_col] + cols),
        mirror_perm=tuple(int(v) for v in mirror_perm),
        ov_seg=int(ov_seg), dwov_seg=int(dwov_seg),
        tile=int(tile), win=int(win),
        companion=companion,
    )

def dataclasses_replace_pm(pm: ParentMap, companion) -> ParentMap:
    return ParentMap(parent=pm.parent, kslot=pm.kslot, num_slots=pm.num_slots, companion=companion)


def _try_parent_map(idx: np.ndarray) -> Optional[ParentMap]:
    """Fuse a map where every output row has <= 1 contributor (k2s2
    transpose convs: one coarse parent per fine voxel)."""
    k = idx.shape[0]
    valid = idx >= 0
    if valid.sum(axis=0).max(initial=0) > 1:
        return None
    kslot = np.where(valid.any(axis=0), valid.argmax(axis=0), k).astype(np.uint8)
    parent = np.take_along_axis(idx, np.minimum(kslot, k - 1)[None, :], axis=0)[0]
    parent = np.maximum(parent, 0).astype(np.int32)
    return ParentMap(parent=parent, kslot=kslot, num_slots=k)

# (n_groups, tile, win) in ascending selector-FLOP order (cost scales with
# n_groups * win; DMA with n_groups * win / tile). Split entries (n_groups
# = 2, slots halved by the offset's leading axis) engage when the whole
# map's children interleave two far-apart input bands (the L0->L1 down
# conv: fine x = 2X and 2X+1 planes) — per-group windows are ~5x tighter.
_CS_MENU = (
    (1, 128, 512),
    (1, 128, 1024), (1, 256, 1024),
    (1, 256, 2048), (1, 512, 2048),
    (2, 128, 1024),
    (1, 512, 4096),
    (2, 128, 2048), (2, 256, 2048),
    (2, 256, 4096),
    (1, 256, 8192), (1, 512, 8192),
)


def _try_child_sum_map(idx: np.ndarray, cap_in: int,
                       companion=None,
                       compact: bool = False,
                       pin_tilewin: Optional[Tuple[int, int]] = None,
                       ) -> "Optional[ChildSumMap]":
    """Child-sum annotation for a strided (down) conv map
    (ops/onehot_conv.py:child_sum_conv).

    Derives the down map's input partition (parent/kslot: every input row
    contributes to exactly one (output, slot) pair) and, per output tile,
    ONE window over the input rows covering the tile's children (sorted
    keys keep children of consecutive outputs local). Children outside
    their tile's window ride the slot-major ov COO; the kernel can never
    double count them (a foreign window's compare parent[i] == o only
    scans o outside parent[i]'s tile). The partition also makes dX a
    ParentMap conv and dW a set of masked contractions — gather-only.
    Returns None when the partition property fails or no window config
    fits (flat path stays)."""
    k, cap_out = idx.shape
    # partition property required for kernel + cheap backward: each input
    # row appears at most once across the whole table
    v = idx >= 0
    ins = idx[v].astype(np.int64)
    if len(ins) != len(np.unique(ins)):
        return None
    parent = np.full(cap_in, cap_out, np.int32)
    # slot ids are tiny (k <= 27 incl. the guard k): uint8 quarters the
    # shipped bytes; every device consumer only compares or masks on it
    kslot = np.full(cap_in, k, np.uint8)
    outs_grid = np.broadcast_to(np.arange(cap_out, dtype=np.int32), idx.shape)
    slots_grid = np.broadcast_to(
        np.arange(k, dtype=np.int32)[:, None], idx.shape)
    parent[ins] = outs_grid[v]
    kslot[ins] = slots_grid[v]
    child_out = outs_grid[v].astype(np.int64)
    child_slot = slots_grid[v].astype(np.int64)

    # ov budget is generous: each COO entry costs ~3x a kernel-summed pair,
    # so up to ~12% of pairs may overflow before the kernel loses.
    ov_cap = max(128, (cap_out // 8 + 127) // 128 * 128)
    wstart = np.zeros(0, np.int32)
    ov_entries = _EMPTY_ENTRIES
    tile = win = 0
    n_groups = 1
    # pinned (n_groups, tile, win): see _menu_from_pin — monotone
    # menu-suffix restriction; (0, 0, 0) pins the scatter fallback.
    for g_, t_, w_ in _menu_from_pin(_CS_MENU, pin_tilewin):
        if cap_out % t_ or cap_out < 2 * t_ or cap_in < w_:
            continue
        if k % g_:
            continue
        n_tiles = cap_out // t_
        tid = child_out // t_
        gsz = k // g_
        grp = child_slot // gsz
        # all-empty tiles get a proportional default position
        default = (np.arange(n_tiles, dtype=np.int64) * t_
                   * max(cap_in // cap_out, 1))
        ws_all = np.zeros((n_tiles, g_), np.int64)
        bad = np.zeros(len(ins), bool)
        for gi in range(g_):
            sel = grp == gi if g_ > 1 else slice(None)
            tid_g, ins_g = tid[sel], ins[sel]
            lo = np.full(n_tiles, np.int64(cap_in))
            hi = np.full(n_tiles, np.int64(-1))
            np.minimum.at(lo, tid_g, ins_g)
            np.maximum.at(hi, tid_g, ins_g)
            mid = np.where(hi >= 0, (lo + hi) // 2, default)
            # 128-aligned starts: Mosaic lane slices of the (n_groups,
            # cap_in) parent rows need lane-tile alignment
            ws = np.clip(mid - w_ // 2, 0, cap_in - w_) & ~np.int64(127)
            ws_all[:, gi] = ws
            bad[sel] = (ins_g < ws[tid_g]) | (ins_g >= ws[tid_g] + w_)
        if bad.sum() <= ov_cap:
            ov_entries = (child_slot[bad], child_out[bad], ins[bad])
            wstart = ws_all.reshape(-1).astype(np.int32)  # tile-major
            tile, win, n_groups = t_, w_, g_
            break
    # tile == 0 (no window config fits) still returns a map: the (parent,
    # kslot) partition alone is complete — the conv runs the scatter
    # fallback (ops/onehot_conv.py:_cs_scatter_impl) and the backward is
    # gather-only either way, so the flat table stays droppable.
    ov_in, ov_out, ov_off, ov_seg = _pack_ov(
        ov_entries, k, ov_cap, cap_out, guard_in=cap_in, guard_out=cap_out)
    parent_base = np.zeros(0, np.int32)
    if compact:
        # Block-delta wire encoding: sorted keys make parents near-monotone
        # over input rows, so parent - min(parent over the row's 128-block)
        # fits uint16 (halves the shipped bytes of the biggest remaining
        # int32 array). Guard rows (kslot == k) decode via kslot, not the
        # delta (ops/onehot_conv.py:_abs_parent). Kept int32 if any block's
        # spread overflows (pathological ordering).
        blk = 128
        n_blk = -(-cap_in // blk)
        pad = n_blk * blk - cap_in
        pv = np.concatenate([parent, np.full(pad, cap_out, np.int32)])
        kv = np.concatenate([kslot, np.full(pad, k, np.uint8)])
        pb = pv.reshape(n_blk, blk).astype(np.int64)
        real = kv.reshape(n_blk, blk) != k
        base = np.where(real, pb, np.int64(1) << 40).min(axis=1)
        base = np.where(real.any(axis=1), base, 0)
        off = pb - base[:, None]
        off[~real] = 0
        if off.max(initial=0) <= 65535:
            parent = off.reshape(-1)[:cap_in].astype(np.uint16)
            parent_base = base.astype(np.int32)
    return ChildSumMap(
        wstart=wstart, parent=parent, kslot=kslot,
        parent_base=parent_base,
        ov_in=ov_in, ov_out=ov_out, ov_off=ov_off,
        num_slots=k, out_capacity_s=int(cap_out),
        ov_seg=int(ov_seg), tile=int(tile), win=int(win),
        in_capacity=int(cap_in), companion=companion,
        n_groups=int(n_groups),
    )


def _axis_stride(level: int, d: int):
    """Per-axis tensor stride: the temporal axis (d=4) always has stride 1."""
    s = 1 << level
    return s if d == 3 else (s,) * 3 + (1,)


def _map_offsets(ms: "MapSpec", spec: "GraphSpec") -> np.ndarray:
    if ms.kind.transpose:
        return -region_offsets(
            ms.kind.region, ms.kind.kernel_size, ms.kind.dilation,
            _axis_stride(ms.level_out, spec.d), spec.d,
        )
    return region_offsets(
        ms.kind.region, ms.kind.kernel_size, ms.kind.dilation,
        _axis_stride(ms.level_in, spec.d), spec.d,
    )


def finalize_graph(
    spec: "GraphSpec",
    capacities: Sequence[int],
    kept_coords: list,
    nums: list,
    maps_idx: Dict[str, np.ndarray],
    fuse: bool = True,
    fuse_grouped: bool = True,
    drop_redundant: bool = True,
    layout_out: Optional[dict] = None,
    flex: bool = False,
    validate: bool = True,
    ship_coords: bool = True,
    min_caps: Optional[Sequence[int]] = None,
    pin_windows: Optional[Dict[str, Tuple[int, int]]] = None,
) -> ConvGraph:
    """Shared back half of both graph builders (numpy and native): sentinel
    expansion, fused-map construction, and redundant-flat-map dropping over
    already-built flat kernel maps.

    ship_coords=False builds a compact batch: levels carry per-scene row
    boundaries (``batch_starts``) instead of the (cap, 4) coords array —
    the device compute path only ever reads the batch column, and rows are
    batch-major by construction (packed keys sort the batch id first).
    Saves the coords' share of the batch H2D bytes; CRF wrappers and
    device-side visualization need ship_coords=True.

    kept_coords / nums / maps_idx are the raw (unexpanded) per-level coords,
    valid counts, and flat (K, cap_out) index tables; they are mutated by the
    expansion pass. layout_out, if given, receives {'pos0': expanded
    positions of level-0 real rows, 'sent_counts': per-level sentinel rows}.

    flex: re-derive each level's capacity as flex_bucket(num + sentinel
    demand) — growing a level so sentinel fusion never fails for lack of
    headroom, and tightening levels whose initial (truncation-policy)
    capacity was loose. The given ``capacities`` stay the truncation policy;
    callers needing static shapes across batches (multi-device stacking,
    parallel/dp.py:stack_batches) leave flex off.

    min_caps / pin_windows (jit-signature stabilization, data/batching.py
    BatchBuilder.stabilize): flex capacities are floored at min_caps[l]
    (monotone running max across builds -> capacity growth events decay),
    and each named map's window geometry is pinned to its first-seen
    (tile, win) so the fused maps' array shapes stop tracking per-batch
    density.
    """
    sent_info = [None] * spec.num_levels
    if fuse and fuse_grouped:
        plans = plan_sentinels(spec, nums, maps_idx)
        if flex:
            capacities = list(capacities)
            for l in range(spec.num_levels):
                need = nums[l] + (len(plans[l][1][0]) if l in plans else 0)
                new_cap = flex_bucket(need)
                if min_caps is not None:
                    new_cap = max(new_cap, int(min_caps[l]))
                if new_cap == capacities[l]:
                    continue
                capacities[l] = new_cap
                for name, ms in spec.maps.items():
                    if ms.level_out != l:
                        continue
                    idx = maps_idx[name]
                    if idx.shape[1] == 1:
                        continue  # build-time dummy: stays 1-wide
                    if new_cap < idx.shape[1]:
                        # view, not copy: every downstream consumer either
                        # rewrites (expand_sentinels) or re-packs the table
                        maps_idx[name] = idx[:, :new_cap]
                    else:
                        maps_idx[name] = np.concatenate(
                            [idx, np.full((idx.shape[0], new_cap - idx.shape[1]),
                                          -1, idx.dtype)], axis=1)
        sent_info = expand_sentinels(spec, capacities, kept_coords, nums,
                                     maps_idx, plans=plans)
    if layout_out is not None:
        layout_out["pos0"] = (
            sent_info[0]["new_pos"] if sent_info[0] is not None
            else np.arange(nums[0], dtype=np.int32)
        )
        layout_out["sent_counts"] = [
            int(si["is_sent"].sum()) if si is not None else 0 for si in sent_info
        ]

    def _ship_coords(c):
        # Production builds ship coords int16 when the range fits (room-
        # scale scenes at cm voxels stay well inside +-32767): on-device
        # consumers only read the batch column (segment ids) or cast
        # (models/crf.py); host consumers are numpy. Halves the coords'
        # share of the batch H2D bytes.
        if (not validate and c.size
                and -32768 <= c.min() and c.max() <= 32767):
            return c.astype(np.int16)
        return c

    def _batch_starts(l):
        # per-scene row boundaries over the (expanded) valid prefix:
        # rows are batch-major (packed keys sort b first) and sentinel
        # rows inherit their left real row's coords, so the batch column
        # is monotone over [0, num)
        bcol = kept_coords[l][: nums[l], 0]
        n_scenes = int(bcol[-1]) + 1 if nums[l] else 1
        return np.searchsorted(
            bcol, np.arange(n_scenes + 1, dtype=np.int32)
        ).astype(np.int32)

    # valid is always materialized (even when it is just the prefix mask) so
    # the batch pytree structure is identical whether or not a level was
    # sentinel-expanded — device stacking and jit caching rely on that.
    levels = tuple(
        SparseLevel(
            coords=(
                _ship_coords(
                    _pad_rows(kept_coords[l][: nums[l]], capacities[l], 0))
                if ship_coords else None
            ),
            num=np.int32(nums[l]),
            stride=1 << l,
            valid=(
                sent_info[l]["valid"].astype(np.uint8)
                if sent_info[l] is not None
                else (np.arange(capacities[l]) < nums[l]).astype(np.uint8)
            ),
            batch_starts=None if ship_coords else _batch_starts(l),
        )
        for l in range(spec.num_levels)
    )

    maps, gmaps = {}, {}
    # Transpose maps run in a second pass so their companion (down) map's
    # ChildSumMap already exists: a transpose map fully served by it needs
    # no fusion of its own (models/layers.py routes through the companion).
    ordered = sorted(spec.maps.items(), key=lambda kv: kv[1].kind.transpose)
    for name, ms in ordered:
        idx = maps_idx[name]
        offs = _map_offsets(ms, spec)
        ks_scalar = ms.kind.kernel_size if isinstance(ms.kind.kernel_size, int) else max(ms.kind.kernel_size)
        center = -1
        mirror = None
        stride1_same = (
            not ms.kind.transpose and ms.kind.stride == 1
            and ms.level_in == ms.level_out and ks_scalar % 2 == 1
            and ks_scalar > 1
        )
        if stride1_same:
            zero_rows = np.flatnonzero((offs == 0).all(axis=1))
            if zero_rows.size == 1:
                center = int(zero_rows[0])
            mirror = _mirror_permutation(offs)
        maps[name] = KernelMap(
            idx=idx, center_slot=center, mirror_perm=mirror,
            companion=ms.companion, droppable=not ms.keep_flat,
        )
        if idx.shape[1] == 1 and capacities[ms.level_out] > 1:
            continue  # dummied at build time (native up-map skip): no fusion

        if fuse and ks_scalar > 1:
            if ms.kind.transpose:
                if isinstance(gmaps.get(ms.companion), ChildSumMap):
                    continue  # served through the companion's partition
                pm = _try_parent_map(idx)
                if pm is not None:
                    gmaps[name] = dataclasses_replace_pm(pm, ms.companion)
                    continue
            if not ms.kind.transpose and ms.kind.stride > 1 and fuse_grouped:
                sw = _try_child_sum_map(
                    idx, capacities[ms.level_in], companion=ms.companion,
                    compact=not validate and flex,
                    pin_tilewin=(pin_windows or {}).get(name))
                if sw is not None:
                    gmaps[name] = sw
                continue
            if not fuse_grouped or ms.fuse_width < 2 or not stride1_same:
                continue
            z_step = (1 << ms.level_in) if spec.d == 3 else 1
            gm = _try_masked_shift_map(
                idx, offs, z_step=z_step, width=ms.fuse_width,
                n_in=capacities[ms.level_in],
                mirror_perm=mirror, companion=ms.companion,
                sent=sent_info[ms.level_in],
                validate=validate,
                pin_tilewin=(pin_windows or {}).get(name),
            )
            if gm is not None:
                gmaps[name] = gm

    if drop_redundant:
        droppable = {n for n, ms in spec.maps.items() if not ms.keep_flat}
        _drop_redundant_flat_maps(maps, gmaps, droppable)
    return ConvGraph(levels=levels, maps=maps, gmaps=gmaps)


def build_graph(
    coords0: np.ndarray,
    spec: GraphSpec,
    capacities: Sequence[int],
    as_numpy: bool = False,
    fuse: bool = True,
    fuse_grouped: bool = True,
    drop_redundant: bool = True,
    layout_out: Optional[dict] = None,
    flex: bool = False,
    validate: bool = True,
    ship_coords: bool = True,
    min_caps: Optional[Sequence[int]] = None,
    pin_windows: Optional[Dict[str, Tuple[int, int]]] = None,
) -> ConvGraph:
    """Build the full ConvGraph for one batch.

    coords0: (N, 4) int32 batched, already-quantized stride-1 coordinates.
    capacities: per-level static capacities (len == spec.num_levels).
        Overflowing levels are truncated (drop-overflow policy).
    as_numpy: keep numpy arrays (for tests / host pipelines); otherwise the
        pytree leaves are numpy anyway and become device arrays on first use.
    """
    assert len(capacities) == spec.num_levels
    coords_levels, keys_levels = build_pyramid(coords0, spec.num_levels, spec.d)

    # Truncate overflow and build lookups over the *kept* rows only.
    nums, lookups, kept_coords = [], [], []
    for l in range(spec.num_levels):
        cap = capacities[l]
        c = coords_levels[l]
        n = min(c.shape[0], cap)
        c = c[:n]
        nums.append(n)
        kept_coords.append(c)
        lookups.append(_Lookup(keys_levels[l][:n]))

    maps_idx = {}
    for name, ms in spec.maps.items():
        maps_idx[name] = _kernel_map(
            out_coords=kept_coords[ms.level_out],
            in_lookup=lookups[ms.level_in],
            kind=ms.kind,
            stride_in=_axis_stride(ms.level_in, spec.d),
            stride_out=_axis_stride(ms.level_out, spec.d),
            out_capacity=capacities[ms.level_out],
            d=spec.d,
        )

    return finalize_graph(
        spec, capacities, kept_coords, nums, maps_idx,
        fuse=fuse, fuse_grouped=fuse_grouped, drop_redundant=drop_redundant,
        layout_out=layout_out, flex=flex, validate=validate,
        ship_coords=ship_coords, min_caps=min_caps, pin_windows=pin_windows,
    )

def pad_ms_overflow_to(m: "MaskedShiftMap", ov_seg: int, n_ov: int,
                       dwov_seg: int, n_dwov: int) -> "MaskedShiftMap":
    """Pad a MaskedShiftMap's overflow COO arrays to shared static bounds
    (cross-shard harmonization, parallel/dp.py). Guard entries (in = out =
    cap) are semantic no-ops: they gather the zero row and scatter past the
    output range."""
    cap = m.out_capacity

    def pad(a, n):
        if a.shape[0] >= n:
            return a
        return np.concatenate([a, np.full(n - a.shape[0], cap, a.dtype)])

    return m.replace(
        ov_in=pad(m.ov_in, n_ov), ov_out=pad(m.ov_out, n_ov),
        dwov_in=pad(m.dwov_in, n_dwov), dwov_out=pad(m.dwov_out, n_dwov),
        ov_seg=int(ov_seg), dwov_seg=int(dwov_seg))


def pad_cs_overflow_to(m: "ChildSumMap", ov_seg: int, n_ov: int) -> "ChildSumMap":
    """Pad a ChildSumMap's overflow COO arrays to shared static bounds
    (cross-shard harmonization, parallel/dp.py). Guard entries (in =
    in_capacity, out = out_capacity) are semantic no-ops."""

    def pad(a, n, guard):
        if a.shape[0] >= n:
            return a
        return np.concatenate([a, np.full(n - a.shape[0], guard, a.dtype)])

    return m.replace(
        ov_in=pad(m.ov_in, n_ov, m.in_capacity),
        ov_out=pad(m.ov_out, n_ov, m.out_capacity_s),
        ov_seg=int(ov_seg))


def drop_covered_flat_maps(graph: ConvGraph) -> ConvGraph:
    """Return a graph whose flat tables are dummied wherever a fused map
    covers them (same rule as the build-time drop). Multi-device builds
    keep flats per shard (batching.py pinned mode) so that this decision —
    which must be IDENTICAL across shards to stack — runs after the shard
    harmonization intersected the fused maps (parallel/dp.py)."""
    maps = dict(graph.maps)
    gmaps = dict(graph.gmaps)
    _drop_redundant_flat_maps(maps, gmaps)
    return ConvGraph(levels=graph.levels, maps=maps, gmaps=gmaps)


def _drop_redundant_flat_maps(maps: dict, gmaps: dict, droppable=None) -> None:
    """Replace flat (K, cap) tables with 1-wide dummies wherever the device
    path is fully served by a fused map — saves ~K x cap x 4 B of host->device
    traffic per map. A fused map only replaces the flat path when its
    backward is gather-only (mirror or companion ParentMap) and either the
    spec declares no wide-channel consumers (MapSpec.keep_flat) or the
    selector-kernel window annotation covers any plausible channel width
    (ops/onehot_conv.py VMEM guard checked at c_out = 512, above every
    model-zoo head)."""
    for name in maps:
        gm = gmaps.get(name)
        can_drop = maps[name].droppable or (
            droppable is not None and name in droppable)
        if isinstance(gm, ParentMap):
            served = True
        elif isinstance(gm, ChildSumMap):
            # child-sum serves fwd (kernel or scatter fallback) and a
            # gather-only backward from (parent, kslot) alone — but only
            # conv consumers; pooling layers read the flat idx, so the
            # spec must opt in via keep_flat=False
            served = can_drop
        elif isinstance(gm, MaskedShiftMap):
            # masked-shift serves fwd+bwd itself, but wide-channel consumers
            # run the selector kernel — droppable once window-annotated
            served = can_drop or (
                gm.tile > 0
                and _vmem_estimate(
                    gm.anchors.shape[0], gm.tile, gm.win, 512)
                <= VMEM_BUDGET
            )
        elif gm is None and maps[name].companion:
            # transpose maps fully served by the companion down map's
            # ChildSumMap (models/layers.py routes through it)
            served = can_drop and isinstance(
                gmaps.get(maps[name].companion), ChildSumMap)
        else:
            served = False
        if served and maps[name].idx.shape[1] > 1:
            old = maps[name]
            maps[name] = KernelMap(
                idx=np.full((old.idx.shape[0], 1), -1, np.int32),
                center_slot=old.center_slot,
                mirror_perm=old.mirror_perm,
                companion=old.companion,
                droppable=old.droppable,
            )
