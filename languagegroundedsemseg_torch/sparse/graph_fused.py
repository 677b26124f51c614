"""Fully-native production graph build: C++ fused-map emission.

The per-batch host graph build bounds end-to-end throughput on a 1-CPU
host (the device step is faster than the build — PERF.md round 4). The
standard native path (graph_native.build_graph_native) still materializes
every stride-1 k3 map as a (27, cap) flat probe table that production
immediately re-derives into a MaskedShiftMap and then DROPS
(graph_host._drop_redundant_flat_maps); this module emits the fused arrays
directly from hash probes (csrc/fused_builder.cpp):

  pass 1  per-(row, column) dz probes + sentinel demand plan
  pass 2  expanded-layout anchors/masks + far-overflow COO
  pass 3  selector-kernel window menu over anchors and their inverse

Down/up maps and any non-fusable map still go through the flat probe +
one-pass remap; ChildSumMap analysis stays numpy (small row counts).

Applicability: 3D specs, flex capacities, drop_redundant, validate=False
(the production loader). Everything else — and any per-level bail-out
(plan conflict, pathological overflow) — falls back to the oracle path,
whose outputs tests assert this module reproduces array-exactly.

Reference analog: MinkowskiEngine's C++/CUDA coordinate manager + kernel
maps (consumed at reference models/modules/common.py:179-236).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from languagegroundedsemseg_torch import BUILD_DIR
from languagegroundedsemseg_torch.sparse import graph_host as gh
from languagegroundedsemseg_torch.sparse import graph_native as gn
from languagegroundedsemseg_torch.sparse.graph_host import (
    _EMPTY_ENTRIES,
    _k3_column_layout,
    _map_offsets,
    _mirror_permutation,
    _pack_ov,
    _try_child_sum_map,
    flex_bucket,
)
from languagegroundedsemseg_torch.sparse.offsets import region_offsets
from languagegroundedsemseg_torch.sparse.types import (
    ConvGraph,
    KernelMap,
    MaskedShiftMap,
    SparseLevel,
)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "fused_builder.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libfused_builder.so")
_lib = None
_tried = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i16p = ctypes.POINTER(ctypes.c_int16)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _compile() -> bool:
    # Compile to a private temp file and os.replace() into place: concurrent
    # first use from loader threads/processes must never CDLL a half-written
    # .so (a failed load would set _tried and silently disable the fast path
    # for the whole process — ADVICE r4).
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
             "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


_lib_lock = threading.Lock()


def get_lib() -> Optional[ctypes.CDLL]:
    with _lib_lock:
        return _get_lib_locked()


def _get_lib_locked() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if (not os.path.isfile(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
        if not _compile():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.lgs_k3_analyze.restype = ctypes.c_int64
    lib.lgs_k3_analyze.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int32, _i32p,
        _i32p, _u8p, _u8p, _u8p, _i32p, _u8p, _u8p, ctypes.c_int64,
    ]
    lib.lgs_k3_emit.restype = ctypes.c_int64
    lib.lgs_k3_emit.argtypes = [
        _i32p, _u8p, _u8p, _u8p, ctypes.c_int64,
        _i32p, _i32p, _u8p, _u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32,
        _i32p, _u8p, _u8p, _u8p, _i32p, _i32p, _i32p, ctypes.c_int64,
    ]
    lib.lgs_k3_windows.restype = ctypes.c_int
    lib.lgs_k3_windows.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i32p, _i32p, ctypes.c_int,
        _i32p, _i32p, _i32p, _i32p, _i32p, _i64p,
        _i32p, _i32p, _i32p, _i64p, ctypes.c_int64,
    ]
    lib.lgs_delta_encode.restype = ctypes.c_int
    lib.lgs_delta_encode.argtypes = [_i32p, ctypes.c_int64, _i16p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None and gn.get_lib() is not None


def _p32(a):
    return a.ctypes.data_as(_i32p)


def _p16(a):
    return a.ctypes.data_as(_i16p)


def _pu8(a):
    return a.ctypes.data_as(_u8p)


class _Bail(Exception):
    """Internal: fall back to the oracle path for this batch."""


def _k3_map_per_level(spec) -> dict:
    """{level: (name, MapSpec)} of the fusable stride-1 k3 maps (same
    selection as graph_host.plan_sentinels)."""
    out = {}
    for name, ms in spec.maps.items():
        ks = (ms.kind.kernel_size if isinstance(ms.kind.kernel_size, int)
              else max(ms.kind.kernel_size))
        if (not ms.kind.transpose and ms.kind.stride == 1
                and ms.level_in == ms.level_out and ms.fuse_width >= 2
                and ks % 2 == 1 and ks == 3):
            out.setdefault(ms.level_in, (name, ms))
    return out


def _col_layout(ms, spec, level):
    offs = _map_offsets(ms, spec)
    zs = 1 << level
    layout = _k3_column_layout(offs, zs)
    if layout is None:
        raise _Bail
    center_col, cols, _ = layout
    # (dx, dy) per non-center column in layout order, in units of zs
    dxdy = []
    for kA, kB, kC in cols:
        o = offs[kB]
        dxdy.append((int(o[0]) // zs, int(o[1]) // zs))
    mirror = _mirror_permutation(offs)
    if mirror is None:
        raise _Bail
    return offs, zs, center_col, cols, np.asarray(dxdy, np.int32), mirror


def build_graph_fused(
    coords0: np.ndarray,
    spec,
    capacities: Sequence[int],
    layout_out=None,
    ship_coords: bool = True,
    min_caps: Optional[Sequence[int]] = None,
    pin_windows=None,
) -> Optional[ConvGraph]:
    """Production fast path. Returns None when unavailable or the batch
    hits a bail-out — the caller then runs the standard path.

    min_caps / pin_windows: jit-signature stabilization knobs, same
    semantics as graph_host.finalize_graph."""
    lib = get_lib()
    nlib = gn.get_lib()
    if lib is None or nlib is None or spec.d != 3:
        return None
    try:
        return _build(lib, nlib, coords0, spec, capacities, layout_out,
                      ship_coords, min_caps, pin_windows)
    except _Bail:
        return None


def _build(lib, nlib, coords0, spec, capacities, layout_out, ship_coords,
           min_caps=None, pin_windows=None):
    L = spec.num_levels
    coords0 = np.ascontiguousarray(coords0, dtype=np.int32)

    # ---- pyramid (existing native) ----------------------------------------
    caps_in = np.asarray(capacities, dtype=np.int64)
    level_arrays = [np.zeros((capacities[l], 4), np.int32) for l in range(L)]
    nums = np.zeros(L, np.int32)
    ptrs = (_i32p * L)(*[gn._ptr(a) for a in level_arrays])
    rc = nlib.lgs_build_pyramid(
        gn._ptr(coords0), coords0.shape[0], L,
        caps_in.ctypes.data_as(_i64p), ptrs, gn._ptr(nums))
    assert rc == 0
    nums = [int(n) for n in nums]

    # ---- pass 1: analyze + sentinel plans ---------------------------------
    k3_maps = _k3_map_per_level(spec)
    plans = {}   # level -> dict of analysis outputs
    for l, (name, ms) in k3_maps.items():
        n = nums[l]
        offs, zs, center_col, cols, dxdy, mirror = _col_layout(ms, spec, l)
        anchors_old = np.empty((8, max(n, 1)), np.int32)
        flags = np.empty((8, max(n, 1)), np.uint8)
        mpz = np.empty(max(n, 1), np.uint8)
        mnz = np.empty(max(n, 1), np.uint8)
        max_dem = 2 * max(n, 1)  # <= 2 sentinel rows per boundary
        ins_pos = np.empty(max_dem, np.int32)
        ins_mp = np.empty(max_dem, np.uint8)
        ins_mn = np.empty(max_dem, np.uint8)
        nd = lib.lgs_k3_analyze(
            _p32(level_arrays[l]), n, zs, _p32(np.ascontiguousarray(dxdy)),
            _p32(anchors_old), _pu8(flags), _pu8(mpz), _pu8(mnz),
            _p32(ins_pos), _pu8(ins_mp), _pu8(ins_mn), max_dem)
        if nd < 0:
            raise _Bail
        plans[l] = dict(
            name=name, ms=ms, offs=offs, zs=zs, center_col=center_col,
            cols=cols, mirror=mirror, anchors_old=anchors_old, flags=flags,
            mpz=mpz, mnz=mnz, ins_pos=ins_pos[:nd].copy(),
            ins_mp=ins_mp[:nd].copy(), ins_mn=ins_mn[:nd].copy(),
        )

    # ---- flex capacities + expansion layout --------------------------------
    caps = [flex_bucket(nums[l] + (len(plans[l]["ins_pos"]) if l in plans
                                   else 0))
            for l in range(L)]
    if min_caps is not None:
        # signature stabilization: floor at the running max across builds
        caps = [max(c, int(m)) for c, m in zip(caps, min_caps)]
    new_pos = []
    sent = []
    new_nums = []
    for l in range(L):
        n = nums[l]
        if l in plans and len(plans[l]["ins_pos"]):
            ip = plans[l]["ins_pos"].astype(np.int64)
            npos = (np.arange(n, dtype=np.int64)
                    + np.searchsorted(ip, np.arange(n, dtype=np.int64)))
            srows = ip + 1 + np.arange(len(ip), dtype=np.int64)
            new_pos.append(npos.astype(np.int32))
            sent.append(srows.astype(np.int32))
            new_nums.append(n + len(ip))
        else:
            new_pos.append(np.arange(n, dtype=np.int32))
            sent.append(np.zeros(0, np.int32))
            new_nums.append(n)
        if new_nums[l] > caps[l]:
            raise _Bail  # flex_bucket always fits; belt and braces

    if layout_out is not None:
        layout_out["pos0"] = new_pos[0]
        layout_out["sent_counts"] = [len(s) for s in sent]

    # ---- pass 2 + 3 per fused level ----------------------------------------
    gmaps = {}
    maps = {}
    levels_mc = [None] * L
    need_flat = set()  # fused maps whose flat table must still ship
    for l, pl in plans.items():
        n, cap = nums[l], caps[l]
        anchors_abs = np.empty((8, cap), np.int32)
        mp = np.empty(cap, np.uint8)
        mn = np.empty(cap, np.uint8)
        mc = np.empty(cap, np.uint8)
        ov_cap = max(128, (cap // 16 + 127) // 128 * 128)
        max_ov = 2 * ov_cap  # far + window misses share the array
        ovc = np.empty(max_ov, np.int32)
        ovo = np.empty(max_ov, np.int32)
        ovi = np.empty(max_ov, np.int32)
        smp = np.ascontiguousarray(pl["ins_mp"])
        smn = np.ascontiguousarray(pl["ins_mn"])
        n_far = lib.lgs_k3_emit(
            _p32(pl["anchors_old"]), _pu8(pl["flags"]), _pu8(pl["mpz"]),
            _pu8(pl["mnz"]), n, _p32(new_pos[l]), _p32(sent[l]),
            _pu8(smp), _pu8(smn), len(sent[l]), cap,
            np.int32(gh.GWIN_MARGIN),
            _p32(anchors_abs), _pu8(mp), _pu8(mn), _pu8(mc),
            _p32(ovc), _p32(ovo), _p32(ovi), ov_cap)
        if n_far < 0 or n_far > ov_cap:
            raise _Bail
        levels_mc[l] = mc

        pin = (pin_windows or {}).get(pl["name"])
        if pin is not None:
            # pinned geometry (signature stabilization): 1-row menu, or an
            # empty pick when the pin is (0, 0) = gather path
            menu = (np.asarray([pin], np.int32) if pin[0]
                    else np.zeros((0, 2), np.int32))
        else:
            menu = np.asarray(gh._WINDOW_MENU, np.int32)
        max_tiles = cap // int(menu[:, 0].min()) if len(menu) else 1
        wstart = np.empty(max_tiles * 8, np.int32)
        inv_wstart = np.empty(max_tiles * 8, np.int32)
        dwc = np.empty(max_ov, np.int32)
        dwo = np.empty(max_ov, np.int32)
        dwi = np.empty(max_ov, np.int32)
        n_ovf = np.zeros(1, np.int64)
        n_dw = np.zeros(1, np.int64)
        mi = -1
        if len(menu):
            mi = lib.lgs_k3_windows(
                _p32(anchors_abs), cap, n_far, ov_cap,
                _p32(np.ascontiguousarray(menu[:, 0])),
                _p32(np.ascontiguousarray(menu[:, 1])), len(menu),
                _p32(wstart), _p32(inv_wstart),
                _p32(ovc), _p32(ovo), _p32(ovi),
                n_ovf.ctypes.data_as(_i64p),
                _p32(dwc), _p32(dwo), _p32(dwi),
                n_dw.ctypes.data_as(_i64p), max_ov)
        tile = win = 0
        n_tiles = 0
        if mi >= 0:
            tile, win = int(menu[mi, 0]), int(menu[mi, 1])
            n_tiles = cap // tile
        n_ov_total = n_far + int(n_ovf[0])
        ov_entries = (
            (ovc[:n_ov_total].astype(np.int64),
             ovo[:n_ov_total].astype(np.int64),
             ovi[:n_ov_total].astype(np.int64))
            if n_ov_total else _EMPTY_ENTRIES
        )
        dw_entries = (
            (dwc[: int(n_dw[0])].astype(np.int64),
             dwo[: int(n_dw[0])].astype(np.int64),
             dwi[: int(n_dw[0])].astype(np.int64))
            if int(n_dw[0]) else _EMPTY_ENTRIES
        )
        ov_in, ov_out, ov_off, ov_seg = _pack_ov(ov_entries, 8, ov_cap, cap)
        dwov_out, dwov_in, dwov_off, dwov_seg = _pack_ov(
            dw_entries, 8, ov_cap, cap)

        anchors16 = np.empty((8, cap), np.int16)
        lib.lgs_delta_encode(_p32(anchors_abs), cap, _p16(anchors16))

        name = pl["name"]
        gmaps[name] = MaskedShiftMap(
            mp=mp, mn=mn, mc=mc, anchors=anchors16,
            ov_in=ov_in, ov_out=ov_out, ov_off=ov_off,
            wstart=(wstart[: n_tiles * 8].copy() if tile
                    else np.zeros(0, np.int32)),
            inv_anchors=np.zeros((8, 0), np.int32),
            inv_wstart=(inv_wstart[: n_tiles * 8].copy() if tile
                        else np.zeros(0, np.int32)),
            dwov_in=dwov_in, dwov_out=dwov_out, dwov_off=dwov_off,
            cols=tuple([pl["center_col"]] + pl["cols"]),
            mirror_perm=tuple(int(v) for v in pl["mirror"]),
            ov_seg=int(ov_seg), dwov_seg=int(dwov_seg),
            tile=tile, win=win, companion=pl["ms"].companion,
        )
        # flat still needed when the window annotation can't serve every
        # plausible channel width (_drop_redundant_flat_maps predicate)
        ms = pl["ms"]
        droppable = not ms.keep_flat
        if not (droppable or (
                tile > 0
                and gh._vmem_estimate(8, tile, win, 512) <= gh.VMEM_BUDGET)):
            need_flat.add(name)

    # ---- remaining maps: flat probes + one-pass remap ----------------------
    for name, ms in spec.maps.items():
        offs = np.ascontiguousarray(_map_offsets(ms, spec), np.int32)
        k = offs.shape[0]
        fused = name in gmaps
        if fused and name not in need_flat:
            maps[name] = KernelMap(
                idx=np.full((k, 1), -1, np.int32),
                center_slot=int(np.flatnonzero((offs == 0).all(axis=1))[0]),
                mirror_perm=gmaps[name].mirror_perm,
                companion=ms.companion, droppable=not ms.keep_flat,
            )
            continue
        if gn._up_map_skippable(spec, ms, True, True, True):
            maps[name] = KernelMap(
                idx=np.full((k, 1), -1, np.int32), center_slot=-1,
                mirror_perm=None, companion=ms.companion,
                droppable=not ms.keep_flat,
            )
            continue
        # probe on the unexpanded levels (full final width), then remap
        # rows/columns into the expanded space in one native pass
        li, lo = ms.level_in, ms.level_out
        idx = np.empty((k, caps[lo]), np.int32)
        rc = nlib.lgs_kernel_map(
            _p32(level_arrays[li]), nums[li],
            _p32(level_arrays[lo]), nums[lo],
            _p32(offs), k, caps[lo], _p32(idx))
        assert rc == 0
        if len(sent[li]) or len(sent[lo]):
            colmap = np.full(caps[lo], nums[lo], np.int32)
            colmap[new_pos[lo]] = np.arange(nums[lo], dtype=np.int32)
            out = np.empty((k, caps[lo]), np.int32)
            rc = nlib.lgs_remap_map(
                _p32(idx), _p32(out), k, caps[lo], nums[lo],
                _p32(np.ascontiguousarray(new_pos[li])), _p32(colmap))
            assert rc == 0
            idx = out

        stride1_same = (not ms.kind.transpose and ms.kind.stride == 1
                        and ms.level_in == ms.level_out)
        center = -1
        mirror = None
        if stride1_same:
            zr = np.flatnonzero((offs == 0).all(axis=1))
            if zr.size == 1:
                center = int(zr[0])
            mirror = _mirror_permutation(offs)
        maps[name] = KernelMap(
            idx=idx, center_slot=center, mirror_perm=mirror,
            companion=ms.companion, droppable=not ms.keep_flat,
        )
        if (not fused and not ms.kind.transpose and ms.kind.stride > 1):
            cs = _try_child_sum_map(idx, caps[li], companion=ms.companion,
                                    compact=True,
                                    pin_tilewin=(pin_windows or {}).get(name))
            if cs is not None:
                gmaps[name] = cs
                if not ms.keep_flat:
                    maps[name] = KernelMap(
                        idx=np.full((k, 1), -1, np.int32), center_slot=-1,
                        mirror_perm=None, companion=ms.companion,
                        droppable=True,
                    )

    # ---- levels -------------------------------------------------------------
    levels = []
    for l in range(L):
        n, cap = nums[l], caps[l]
        valid = levels_mc[l]
        if valid is None:
            valid = (np.arange(cap) < new_nums[l]).astype(np.uint8)
        coords_ship = None
        if ship_coords:
            ce = np.zeros((cap, 4), np.int32)
            ce[new_pos[l]] = level_arrays[l][:n]
            if len(sent[l]):
                src = np.clip(plans[l]["ins_pos"], 0, max(n - 1, 0))
                ce[sent[l]] = level_arrays[l][src]
            if ce.size and -32768 <= ce.min() and ce.max() <= 32767:
                ce = ce.astype(np.int16)
            coords_ship = ce
        bcol = level_arrays[l][:n, 0]
        if len(sent[l]):
            # sentinel rows inherit their left real row's scene — the
            # expanded batch column is monotone, and scene starts map
            # through new_pos
            n_scenes = int(bcol[-1]) + 1 if n else 1
            starts_old = np.searchsorted(bcol, np.arange(n_scenes + 1))
            starts = np.where(
                starts_old < n,
                new_pos[l][np.minimum(starts_old, max(n - 1, 0))],
                new_nums[l],
            ).astype(np.int32)
            # a sentinel inserted before row 0 (ins_pos = -1) inherits row
            # 0's coords, i.e. scene 0 — the first scene always starts at 0
            starts[0] = 0
        else:
            n_scenes = int(bcol[-1]) + 1 if n else 1
            starts = np.searchsorted(
                bcol, np.arange(n_scenes + 1)).astype(np.int32)
        levels.append(SparseLevel(
            coords=coords_ship,
            num=np.int32(new_nums[l]),
            stride=1 << l,
            valid=valid,
            batch_starts=None if ship_coords else starts,
        ))

    return ConvGraph(levels=tuple(levels), maps=maps, gmaps=gmaps)
