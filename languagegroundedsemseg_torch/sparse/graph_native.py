"""ctypes bridge to the native C++ graph builder (csrc/graph_builder.cpp).

Compiled on first use (g++, no pip install needed); every public entry falls
back to the numpy builder if the toolchain or the .so is unavailable. The
numpy builder is the correctness oracle — tests assert exact equality.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from languagegroundedsemseg_torch.sparse import graph_host as gh
from languagegroundedsemseg_torch.sparse.graph_host import GraphSpec, _pad_rows
from languagegroundedsemseg_torch.sparse.offsets import region_offsets
from languagegroundedsemseg_torch.sparse.types import ConvGraph, KernelMap, SparseLevel

from languagegroundedsemseg_torch import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "graph_builder.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libgraph_builder.so")
_lib = None
_tried = False


def _compile() -> bool:
    # temp-file + atomic rename: a concurrent first use must never CDLL a
    # half-written .so (same hardening as sparse/graph_fused.py).
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp],
            check=True,
            capture_output=True,
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
    if not os.path.isfile(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
        if not _compile():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.lgs_build_pyramid.restype = ctypes.c_int
    lib.lgs_build_pyramid.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(i32p), i32p,
    ]
    lib.lgs_kernel_map.restype = ctypes.c_int
    lib.lgs_kernel_map.argtypes = [
        i32p, ctypes.c_int64, i32p, ctypes.c_int64,
        i32p, ctypes.c_int, ctypes.c_int64, i32p,
    ]
    lib.lgs_quantize.restype = ctypes.c_int64
    lib.lgs_quantize.argtypes = [i32p, ctypes.c_int64, i32p]
    lib.lgs_remap_map.restype = ctypes.c_int
    lib.lgs_remap_map.argtypes = [
        i32p, i32p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, i32p, i32p,
    ]
    _lib = lib
    return _lib


def remap_map_native(idx, n_out_old, table=None, colmap=None):
    """One-pass sentinel remap of a flat kernel map (expand_sentinels):
    input rows through ``table`` and/or columns through ``colmap``.
    Returns the remapped (k, cap_out) array (in-place when colmap is None),
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    null = ctypes.POINTER(ctypes.c_int32)()
    tp = _ptr(np.ascontiguousarray(table, np.int32)) if table is not None else null
    if colmap is None:
        out = idx
        cp = null
    else:
        out = np.empty_like(idx)
        cp = _ptr(np.ascontiguousarray(colmap, np.int32))
    rc = lib.lgs_remap_map(
        _ptr(idx), _ptr(out), idx.shape[0], idx.shape[1], int(n_out_old),
        tp, cp,
    )
    assert rc == 0
    return out


def native_available() -> bool:
    return get_lib() is not None


def _up_map_skippable(spec, ms, fuse, fuse_grouped, drop_redundant) -> bool:
    """True when a transpose map's flat table would be dropped as redundant
    anyway: its companion is a strided non-transpose map in the spec, whose
    ChildSumMap partition serves the up conv (fwd + bwd) completely. Only
    in drop_redundant mode — pinned (multi-device) builds keep every flat
    so the cross-shard harmonization can fall back per map."""
    if not (fuse and fuse_grouped and drop_redundant and ms.kind.transpose
            and not ms.keep_flat):
        return False
    comp = spec.maps.get(ms.companion) if ms.companion else None
    # kernel_size == stride is what guarantees _try_child_sum_map's input
    # partition holds (each input row has exactly one parent), so only then
    # is the companion's ChildSumMap guaranteed to exist and serve the up
    # conv. A k3s2 companion would pass a looser predicate but fail the
    # partition, leaving the up conv a 1-wide dummy table (ADVICE r4).
    return (comp is not None and not comp.kind.transpose
            and comp.kind.stride > 1
            and comp.kind.kernel_size == comp.kind.stride
            and comp.level_in == ms.level_out
            and comp.level_out == ms.level_in)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_graph_native(
    coords0: np.ndarray,
    spec: GraphSpec,
    capacities: Sequence[int],
    fuse: bool = True,
    fuse_grouped: bool = True,
    drop_redundant: bool = True,
    layout_out=None,
    flex: bool = False,
    validate: bool = True,
    ship_coords: bool = True,
    min_caps: Optional[Sequence[int]] = None,
    pin_windows=None,
) -> ConvGraph:
    """Native-path equivalent of graph_host.build_graph (same outputs):
    the C++ library builds the pyramid and flat kernel maps; the shared
    finalize pass (sentinel expansion + fused maps) runs in numpy.

    Production builds (flex + drop_redundant + validate=False) route
    through the fully-native fused builder first (sparse/graph_fused.py —
    2.3x faster: no flat k3 tables, C++ fusion passes); any bail-out falls
    back here. LGS_NO_FUSED_BUILDER=1 disables the fast path."""
    if (not validate and flex and drop_redundant and fuse and fuse_grouped
            and spec.d == 3
            and not os.environ.get("LGS_NO_FUSED_BUILDER")):
        from languagegroundedsemseg_torch.sparse.graph_fused import (
            build_graph_fused,
        )

        g = build_graph_fused(coords0, spec, capacities,
                              layout_out=layout_out, ship_coords=ship_coords,
                              min_caps=min_caps, pin_windows=pin_windows)
        if g is not None:
            return g
    lib = get_lib()
    if lib is None or spec.d != 3:  # native builder is 3D; 4D uses numpy
        return gh.build_graph(
            coords0, spec, capacities, fuse=fuse, fuse_grouped=fuse_grouped,
            drop_redundant=drop_redundant, layout_out=layout_out, flex=flex,
            validate=validate, ship_coords=ship_coords,
            min_caps=min_caps, pin_windows=pin_windows,
        )

    coords0 = np.ascontiguousarray(coords0, dtype=np.int32)
    L = spec.num_levels
    caps = np.asarray(capacities, dtype=np.int64)
    level_arrays = [np.zeros((capacities[l], 4), dtype=np.int32) for l in range(L)]
    nums = np.zeros(L, dtype=np.int32)
    ptrs = (ctypes.POINTER(ctypes.c_int32) * L)(*[_ptr(a) for a in level_arrays])
    rc = lib.lgs_build_pyramid(
        _ptr(coords0), coords0.shape[0], L,
        caps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ptrs,
        _ptr(nums),
    )
    assert rc == 0

    maps_idx = {}
    for name, ms in spec.maps.items():
        offs = np.ascontiguousarray(gh._map_offsets(ms, spec), dtype=np.int32)
        k = offs.shape[0]
        if _up_map_skippable(spec, ms, fuse, fuse_grouped, drop_redundant):
            # transpose maps fully served by the companion down map's
            # ChildSumMap partition (models/layers.py): skip the k probes
            # per fine row AND the (k, cap) table entirely — the finalize
            # pass recognizes the 1-wide dummy.
            maps_idx[name] = np.full((k, 1), -1, dtype=np.int32)
            continue
        cap_out = capacities[ms.level_out]
        idx = np.empty((k, cap_out), dtype=np.int32)
        rc = lib.lgs_kernel_map(
            _ptr(level_arrays[ms.level_in]), int(nums[ms.level_in]),
            _ptr(level_arrays[ms.level_out]), int(nums[ms.level_out]),
            _ptr(offs), k, cap_out, _ptr(idx),
        )
        assert rc == 0
        maps_idx[name] = idx

    kept_coords = [level_arrays[l][: int(nums[l])] for l in range(L)]
    return gh.finalize_graph(
        spec, capacities, kept_coords, [int(n) for n in nums], maps_idx,
        fuse=fuse, fuse_grouped=fuse_grouped, drop_redundant=drop_redundant,
        layout_out=layout_out, flex=flex, validate=validate,
        ship_coords=ship_coords, min_caps=min_caps, pin_windows=pin_windows,
    )


def quantize_native(coords: np.ndarray) -> np.ndarray:
    """First-occurrence dedup indices (input order), native path."""
    lib = get_lib()
    c = np.ascontiguousarray(coords, dtype=np.int32)
    if c.shape[1] == 3:
        c = np.concatenate([np.zeros((len(c), 1), np.int32), c], axis=1)
    if lib is None:
        return np.sort(gh.quantize(c))
    keep = np.empty(len(c), dtype=np.int32)
    m = lib.lgs_quantize(_ptr(c), len(c), _ptr(keep))
    return keep[:m]
