"""Selector and child-sum sparse convs, and their Hopper kernels.

Counterpart of ``languagegroundedsemseg_tpu/ops/onehot_conv.py``. Around the
three kernels this module computes exactly what the reference computes
outside its Pallas kernels:

* ``onehot_window_conv`` (stride-1 k3 convs with a window annotation): the
  bf16 masked-shift table T3, ONE bf16 projection GEMM
  ``P = T3 @ [W_center | W_col1..8]``, the selector kernel ``sel_fwd``, and
  the overflow COO served from P (``_ov_from_pall``). Backward (``_oh_bwd``):
  dX is the same forward over T3(g) with mirrored, transposed weights (a
  second ``sel_fwd``); dW is the center contraction, the fused dW kernel
  ``dw`` for the 8 anchored columns through the inverse tiling, and the dwov
  COO.
* ``child_sum_conv`` (down convs): ``P[i] = x[i] @ W[kslot[i]]`` from one
  bf16 GEMM over the one-hot slot stack, the child-sum kernel ``csum``, and
  the f32 overflow COO (``_ov_fwd_plain``); without a window annotation the
  exact scatter form (``_cs_scatter_impl``). Backward (``_cs_bwd``):
  gather-only through the (parent, kslot) partition.
* ``transpose_child_sum_conv`` (up convs): a gather through the companion
  down map's (parent, kslot) partition. Backward (``_tcs_bwd``): dX is the
  child-sum direction (``csum`` when windowed), dW masked contractions.

The routing is the same on every device: the window annotation decides the
path. Inside a kernel wrapper a CUDA tensor launches the hand-written
kernel (``csrc/sel_fwd.cu``, ``csrc/csum.cu``, ``csrc/dw.cu``) and a CPU
tensor runs the plain PyTorch version beside it (``sel_fwd_reference``,
``csum_reference``, ``dw_fused_reference``). There is no fallback from one
to the other. The reference's TPU probe and VMEM budget checks have no
counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from languagegroundedsemseg_torch.ops import cuda_kernels
from languagegroundedsemseg_torch.ops.msconv import (
    _abs_anchors,
    _entry_cols,
    _ov_dw_pieces,
    _put_cols,
    _t3,
    _wstack,
)
from languagegroundedsemseg_torch.ops.spconv import (
    _parent_fwd_impl,
    _slot_dw,
    _wt,
)
from languagegroundedsemseg_torch.sparse.types import MaskedShiftMap

# Launches of each kernel: a wrapper adds one where it launches its kernel
# on the card and nowhere else (the CPU path runs the plain version).
launch_counts = {"sel_fwd": 0, "csum": 0, "dw": 0}

# sel_fwd's launch plan (csrc/sel_fwd.cu, checked against the kernel's own by
# ``sel_config``): at most _SEL_THREADS threads a block, at most 64 registers
# a thread so that _SEL_BLOCKS_PER_SM blocks share an SM, and at most
# _SEL_SMEM_LIMIT bytes of staged anchors a block. A block owns a run of rows
# inside one tile: the most rows (a multiple of 4 dividing the tile) that
# keep the block at SEL_MAX_ITEMS (row, 8-channel vector) items, one a
# thread, and the launch at SEL_MIN_BLOCKS blocks (two an SM of an H100
# SXM). Channels are split over blocks only where even 4-row blocks are too
# few, never below SEL_MIN_SPLIT channels a block.
_SEL_THREADS, _SEL_BLOCKS_PER_SM, _SEL_SMEM_LIMIT = 256, 4, 48 * 1024
SEL_MAX_ITEMS = 256
SEL_MIN_BLOCKS = 132 * 2
SEL_MIN_SPLIT = 32

# csum's launch plan (csrc/csum.cu, checked against the kernel's own by
# ``csum_config``): _CS_THREADS threads (_CS_WARPS warps) a block, one block
# per output tile and channel split; a block stages at most CSUM_HIT_CAP
# window entries (n_groups * win) and loads _CS_BATCH children at once.
# Channels are split over blocks only while the tiles alone give fewer than
# CSUM_MIN_BLOCKS blocks (two an SM of an H100 SXM), never below
# CSUM_MIN_SPLIT channels a block.
_CS_THREADS, _CS_WARPS, _CS_BATCH = 256, 8, 4
CSUM_HIT_CAP = 8192
CSUM_MIN_BLOCKS = 132 * 2
CSUM_MIN_SPLIT = 32
# the dynamic shared memory a block may use on Hopper (227 KB)
SMEM_LIMIT_BYTES = 232448

# dw's launch geometry (csrc/dw.cu, checked against the kernel's own by
# ``dw_config``): a block owns a (_DW_BM rows of 3C) x (_DW_BN columns of
# n_cols * c_out) output tile and walks one split of the rows _DW_BK at a
# time. DW_RESIDENT_BLOCKS blocks run at once on an H100 SXM (132 SMs x 2
# blocks); a split is at least DW_MIN_CHUNKS chunks where cap allows.
_DW_BM, _DW_BN, _DW_BK = 96, 128, 64
DW_RESIDENT_BLOCKS = 132 * 2
DW_MIN_CHUNKS = 8
# ceiling on a dw launch's f32 split partials (n_split x 3C x n_cols *
# c_out): at the wide variants' shapes (34D's (1536, 512) at L0) the
# waves alone would ask for 512 splits, 12.9 GB written and read back
DW_PART_BYTES = 256 << 20


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check(t: torch.Tensor, name, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


# ---- selector forward: the stride-1 k3 convs ---------------------------------


def sel_fwd_reference(wstart, anchors, mc, pall, n_cols, tile, win):
    """Plain version of the ``sel_fwd`` kernel: for output row o of tile
    t = o // tile,

        out[o] = mc[o] * (P[o, block 0]
                 + sum_c [ws[t*n_cols+c] <= a_c(o) < ws[...] + win] * P[a_c(o), block c+1])

    in f32, columns added in order. ``pall`` (cap, (n_cols+1)*c_run) bf16;
    ``anchors`` (n_cols, cap) int32 with guard cap (never inside a window);
    ``mc`` (cap,) {0, 1}. Returns (cap, c_run) f32."""
    cap = pall.shape[0]
    c_run = pall.shape[1] // (n_cols + 1)
    out = pall[:, :c_run].to(torch.float32)
    t = torch.arange(cap, device=pall.device) // tile
    for c in range(n_cols):
        a = anchors[c].long()
        ws = wstart[t * n_cols + c].long()
        hit = (a >= ws) & (a < ws + win)
        rows = torch.where(hit, a, torch.zeros_like(a))
        g = pall[rows, (c + 1) * c_run:(c + 2) * c_run].to(torch.float32)
        out = out + torch.where(hit[:, None], g, torch.zeros((), device=g.device))
    return out * mc[:, None].to(torch.float32)


def _sel_smem_bytes(n_cols: int, rows: int) -> int:
    """csrc/sel_fwd.cu's smem_bytes: the staged anchor row of every
    (column, row) of a block, int32, rounded up to 16 bytes."""
    return -(-(n_cols * rows * 4) // 16) * 16


@functools.lru_cache(maxsize=None)
def _sel_plan(cap: int, c_run: int, tile: int, win: int, n_cols: int) -> tuple:
    """(rows a block, channels a block, channel splits, threads, shared
    bytes) of a sel_fwd launch; raises ValueError for shapes the kernel does
    not take (not cached). A function of the shapes alone; neither split
    changes a sum's order."""
    if c_run <= 0 or c_run % 8:
        raise ValueError(f"sel_fwd: c_run {c_run} is not a multiple of 8")
    if tile <= 0 or cap % tile or tile % 4:
        raise ValueError(f"sel_fwd: tile {tile} must be a multiple of 4 "
                         f"that divides cap {cap}")
    if win <= 0 or win > cap or n_cols <= 0:
        raise ValueError(f"sel_fwd: win {win} (cap {cap}), n_cols {n_cols}")
    vecs = c_run // 8
    # divisors of the tile that are whole 16-byte anchor loads, largest first
    cands = [r for r in range(tile, 3, -4) if tile % r == 0]
    fits = [r for r in cands if r * vecs <= SEL_MAX_ITEMS] or cands[-1:]
    rows = next((r for r in fits if cap // r >= SEL_MIN_BLOCKS), fits[-1])
    per = vecs
    if cap // rows < SEL_MIN_BLOCKS:
        want = -(-SEL_MIN_BLOCKS // (cap // rows))
        per = max(-(-vecs // want), min(vecs, SEL_MIN_SPLIT // 8))
    threads = min(_SEL_THREADS, -(-rows * per // 32) * 32)
    smem = _sel_smem_bytes(n_cols, rows)
    if smem > _SEL_SMEM_LIMIT:
        raise ValueError(f"sel_fwd: {smem} bytes of staged anchors exceed "
                         f"{_SEL_SMEM_LIMIT}")
    return rows, per * 8, -(-vecs // per), threads, smem


def sel_geometry(cap: int, c_run: int, tile: int, win: int,
                 n_cols: int = 8) -> dict:
    """The launch of ``sel_fwd`` at these shapes: grid (row blocks, channel
    splits), threads, rows and channels a block, dynamic shared memory.
    Raises ValueError for shapes the kernel does not take: c_run not a
    multiple of 8 (16-byte row loads), a tile that does not divide cap or is
    not a multiple of 4 (16-byte anchor loads), a window wider than cap, or
    more staged anchors than a block's static shared memory holds."""
    rows, chunk, splits, threads, smem = _sel_plan(cap, c_run, tile, win,
                                                   n_cols)
    return {"grid": [cap // rows, splits], "blocks": cap // rows * splits,
            "threads": threads, "rows_per_block": rows, "chunk": chunk,
            "splits": splits, "smem_bytes": smem,
            "items_per_thread": -(-rows * chunk // 8 // threads)}


def sel_config(n_cols: int = 8, rows: int = 64, threads: int = 256) -> dict:
    """The constants compiled into csrc/sel_fwd.cu, its shared memory at
    (n_cols, rows) and the blocks an SM holds there at ``threads`` threads,
    from the card's runtime; raises if they differ from this module's copy.
    Builds and loads the kernel; needs a CUDA device."""
    cfg = (ctypes.c_int * 5)()
    rc = cuda_kernels.function(
        "sel_fwd", "lgs_sel_fwd_config",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int])(
            ctypes.addressof(cfg), n_cols, rows, threads)
    if rc != 0:
        raise RuntimeError(f"sel_fwd occupancy query failed: CUDA error {rc}")
    keys = ("threads", "min_blocks_per_sm", "smem_limit_bytes",
            "dynamic_smem_bytes", "blocks_per_sm")
    out = dict(zip(keys, cfg))
    want = {"threads": _SEL_THREADS, "min_blocks_per_sm": _SEL_BLOCKS_PER_SM,
            "smem_limit_bytes": _SEL_SMEM_LIMIT,
            "dynamic_smem_bytes": _sel_smem_bytes(n_cols, rows)}
    if any(out[k] != v for k, v in want.items()):
        raise RuntimeError(f"csrc/sel_fwd.cu constants {out} differ from {want}")
    return out


def sel_fwd(wstart, anchors, mc, pall, n_cols, tile, win):
    """Selector forward; contract as ``sel_fwd_reference``. A CUDA input
    launches the Hopper kernel (``csrc/sel_fwd.cu``) or raises (see
    ``sel_geometry``); a CPU input runs the plain version."""
    if pall.device.type == "cpu":
        return sel_fwd_reference(wstart, anchors, mc, pall, n_cols, tile, win)
    if pall.device.type != "cuda":
        raise ValueError(f"sel_fwd: unsupported device {pall.device}")
    cap, width = pall.shape
    c_run = width // (n_cols + 1)
    if width != (n_cols + 1) * c_run:
        raise ValueError(f"sel_fwd: P width {width} is not {n_cols + 1} "
                         "blocks")
    rows, chunk, _, threads, smem = _sel_plan(cap, c_run, tile, win, n_cols)
    dev = pall.device
    _check(pall, "pall", torch.bfloat16, device=dev)
    _check(anchors, "anchors", torch.int32, (n_cols, cap), dev)
    _check(wstart, "wstart", torch.int32, (cap // tile * n_cols,), dev)
    _check(mc, "mc", torch.uint8, (cap,), dev)
    for t, name in ((pall, "pall"), (anchors, "anchors")):
        if t.data_ptr() % 16:
            raise ValueError(f"sel_fwd: {name} is not 16-byte aligned")
    out = torch.empty((cap, c_run), dtype=torch.float32, device=dev)
    # the raw stream handle: torch.cuda.current_stream() builds a Stream
    # object, which costs more host time than a small launch; so does
    # entering the device's context, needed only when it is not current
    args = (wstart.data_ptr(), anchors.data_ptr(), mc.data_ptr(),
            pall.data_ptr(), out.data_ptr(), cap, n_cols, c_run, tile, win,
            rows, chunk, threads, smem)
    fn = cuda_kernels.function("sel_fwd")
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"sel_fwd kernel launch failed: CUDA error {rc}")
    launch_counts["sel_fwd"] += 1
    return out


# ---- child sum: the strided (down) convs -------------------------------------


def csum_reference(wstart, parent_g, pall, cap_out, tile, win, n_groups):
    """Plain version of the ``csum`` kernel: for output row o of tile
    t = o // tile,

        out[o] = sum_g sum_{i in [ws[t*n_groups+g], ... + win)} [parent_g[g, i] == o] * P[i]

    in f32. ``pall`` (cap_in, c_run) bf16; ``parent_g`` (n_groups, cap_in)
    int32 whose non-members hold cap_out. A row counts only in its parent's
    tile, and only when it lies inside that tile's window for its group.
    Returns (cap_out, c_run) f32."""
    cap_in, c_run = pall.shape
    n_tiles = cap_out // tile
    rows = torch.arange(cap_in, device=pall.device)
    p32 = pall.to(torch.float32)
    out = torch.zeros((cap_out + 1, c_run), dtype=torch.float32,
                      device=pall.device)
    for g in range(n_groups):
        p = parent_g[g].long()
        member = p < cap_out
        t = torch.clamp(p // tile, max=n_tiles - 1)
        ws = wstart[t * n_groups + g].long()
        take = member & (rows >= ws) & (rows < ws + win)
        dst = torch.where(take, p, torch.full_like(p, cap_out))
        out.index_add_(0, dst, torch.where(take[:, None], p32,
                                           torch.zeros((), device=p32.device)))
    return out[:cap_out]


def _csum_smem_bytes(tile: int, entries: int) -> int:
    """csrc/csum.cu's smem_bytes: the hit list (int32 a window entry), the
    (warp, row) offsets and row starts (int32), the staged local rows
    (int16 an entry), rounded up to 16 bytes."""
    raw = entries * 4 + (_CS_WARPS * tile + tile + 1) * 4 + entries * 2
    return -(-raw // 16) * 16


def _csum_splits(n_tiles: int, c_run: int) -> tuple:
    """(channels per block, split count) of a csum launch: all of c_run in
    one block per tile where the tiles give CSUM_MIN_BLOCKS blocks, else
    enough whole 8-channel vectors per split to get there, but no fewer than
    CSUM_MIN_SPLIT channels (or c_run). A function of the shapes alone; a
    split changes no sum's order."""
    vecs = c_run // 8
    want = -(-CSUM_MIN_BLOCKS // n_tiles)
    per = max(-(-vecs // want), min(vecs, CSUM_MIN_SPLIT // 8))
    return per * 8, -(-vecs // per)


@functools.lru_cache(maxsize=None)
def _csum_plan(cap_in: int, cap_out: int, c_run: int, tile: int, win: int,
               n_groups: int) -> tuple:
    """(channels per split, split count, shared bytes) of a csum launch;
    raises ValueError for shapes the kernel does not take (not cached)."""
    if c_run <= 0 or c_run % 8:
        raise ValueError(f"csum: c_run {c_run} is not a multiple of 8")
    if (tile <= 0 or cap_out % tile or win <= 0 or win > cap_in
            or n_groups <= 0):
        raise ValueError(f"csum: cap_in {cap_in}, cap_out {cap_out}, "
                         f"tile {tile}, win {win}, n_groups {n_groups}")
    entries = n_groups * win
    if entries > CSUM_HIT_CAP:
        raise ValueError(f"csum: {n_groups} x {win} window entries exceed "
                         f"the hit list's {CSUM_HIT_CAP}")
    smem = _csum_smem_bytes(tile, entries)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"csum: {smem} bytes of shared memory exceed "
                         f"{SMEM_LIMIT_BYTES}")
    return (*_csum_splits(cap_out // tile, c_run), smem)


def csum_geometry(cap_in: int, cap_out: int, c_run: int, tile: int, win: int,
                  n_groups: int) -> dict:
    """The launch of ``csum`` at these shapes: grid (tiles, channel splits),
    threads, dynamic shared memory, channels per split. Raises ValueError
    for shapes the kernel does not take: c_run not a multiple of 8 (16-byte
    row loads), a tile that does not divide cap_out, a window wider than
    cap_in, more window entries than the hit list holds, or more shared
    memory than a block may use."""
    chunk, splits, smem = _csum_plan(cap_in, cap_out, c_run, tile, win,
                                     n_groups)
    n_tiles = cap_out // tile
    return {"grid": [n_tiles, splits], "blocks": n_tiles * splits,
            "threads": _CS_THREADS, "smem_bytes": smem, "splits": splits,
            "chunk": chunk, "entries": n_groups * win,
            "hit_capacity": CSUM_HIT_CAP}


def csum_config(tile: int = 128, entries: int = 4096) -> dict:
    """The constants compiled into csrc/csum.cu, its shared memory at
    (tile, entries) window entries and the blocks an SM holds there, from
    the card's runtime (the defaults are the main path's L0->L1 map); raises
    if they differ from this module's copy. Builds and loads the kernel;
    needs a CUDA device."""
    cfg = (ctypes.c_int * 5)()
    rc = cuda_kernels.function(
        "csum", "lgs_csum_config",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int])(
            ctypes.addressof(cfg), tile, entries)
    if rc != 0:
        raise RuntimeError(f"csum occupancy query failed: CUDA error {rc}")
    keys = ("threads", "hit_capacity", "batch", "dynamic_smem_bytes",
            "blocks_per_sm")
    out = dict(zip(keys, cfg))
    want = {"threads": _CS_THREADS, "hit_capacity": CSUM_HIT_CAP,
            "batch": _CS_BATCH,
            "dynamic_smem_bytes": _csum_smem_bytes(tile, entries)}
    if any(out[k] != v for k, v in want.items()):
        raise RuntimeError(f"csrc/csum.cu constants {out} differ from {want}")
    return out


def csum(wstart, parent_g, pall, cap_out, tile, win, n_groups):
    """Windowed child sum; contract as ``csum_reference``. A CUDA input
    launches the Hopper kernel (``csrc/csum.cu``) or raises (see
    ``csum_geometry``); a CPU input runs the plain version."""
    if pall.device.type == "cpu":
        return csum_reference(wstart, parent_g, pall, cap_out, tile, win,
                              n_groups)
    if pall.device.type != "cuda":
        raise ValueError(f"csum: unsupported device {pall.device}")
    cap_in, c_run = pall.shape
    chunk, _, smem = _csum_plan(cap_in, cap_out, c_run, tile, win, n_groups)
    dev = pall.device
    _check(pall, "pall", torch.bfloat16, device=dev)
    _check(parent_g, "parent_g", torch.int32, (n_groups, cap_in), dev)
    _check(wstart, "wstart", torch.int32, (cap_out // tile * n_groups,), dev)
    if pall.data_ptr() % 16:
        raise ValueError("csum: pall is not 16-byte aligned")
    out = torch.empty((cap_out, c_run), dtype=torch.float32, device=dev)
    fn = cuda_kernels.function("csum")
    with torch.cuda.device(dev):
        # the raw stream handle: torch.cuda.current_stream() builds a Stream
        # object, which costs more host time than this launch's kernel
        rc = fn(wstart.data_ptr(), parent_g.data_ptr(), pall.data_ptr(),
                out.data_ptr(), cap_in, cap_out, c_run, tile, win, n_groups,
                chunk, smem, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"csum kernel launch failed: CUDA error {rc}")
    launch_counts["csum"] += 1
    return out


# ---- fused dW: the stride-1 k3 convs' anchored columns ------------------------


def dw_fused_reference(inv_wstart, inv_anchors, t3b, g, tile, win):
    """Plain version of the ``dw`` kernel: for column c and T3 row i of
    tile t = i // tile, with o = inv_anchors[c, i] and
    ws = inv_wstart[t * n_cols + c],

        out[c] = sum_i T3[i]^T (x) (g[o] if ws <= o < ws + win else 0)

    ``t3b`` (cap, 3C) bf16, ``g`` (cap, c_out) bf16, ``inv_anchors``
    (n_cols, cap) int32 with guard cap. bf16 products summed in f32.
    Returns (n_cols, 3C, c_out) f32."""
    n_cols, cap = inv_anchors.shape
    t = torch.arange(cap, device=g.device) // tile
    t3f = t3b.to(torch.float32).t()
    zero = torch.zeros((), device=g.device)
    out = []
    for c in range(n_cols):
        o = inv_anchors[c].long()
        ws = inv_wstart[t * n_cols + c].long()
        hit = (o >= ws) & (o < ws + win) & (o < cap)
        gc = g[torch.where(hit, o, torch.zeros_like(o))].to(torch.float32)
        out.append(t3f @ torch.where(hit[:, None], gc, zero))
    return torch.stack(out)


@functools.lru_cache(maxsize=None)
def _dw_splits(cap: int, cw: int, n_total: int) -> tuple:
    """(rows per split, split count) of a dw launch. A split is a whole
    number of _DW_BK-row chunks. The count minimises waves x rows per
    split, the time of an SM when every resident block walks one split,
    and takes the fewest splits among equals (less for the second pass to
    add), among the counts whose partials fit DW_PART_BYTES (one split
    always does). A function of the shapes alone, so the sum order is
    fixed."""
    tiles = -(-cw // _DW_BM) * -(-n_total // _DW_BN)
    chunks = -(-cap // _DW_BK)
    best = None
    for want in range(1, max(1, chunks // DW_MIN_CHUNKS) + 1):
        rows = -(-chunks // want) * _DW_BK
        n_split = -(-cap // rows)
        if n_split > 1 and n_split * cw * n_total * 4 > DW_PART_BYTES:
            break  # n_split grows with want
        cost = -(-tiles * n_split // DW_RESIDENT_BLOCKS) * rows
        if best is None or cost < best[0]:
            best = (cost, rows, n_split)
    return best[1], best[2]


def dw_geometry(cap: int, cw: int, c_out: int, n_cols: int) -> dict:
    """The launch of ``dw_fused`` at these shapes: 3C as the kernel sees
    it (padded to a multiple of 8), rows per split, split count and grid."""
    cw_k = cw + (-cw) % 8
    rows, n_split = _dw_splits(cap, cw_k, n_cols * c_out)
    grid = (-(-cw_k // _DW_BM), -(-(n_cols * c_out) // _DW_BN), n_split)
    return {"cw_kernel": cw_k, "rows_per_split": rows, "splits": n_split,
            "grid": list(grid), "blocks": grid[0] * grid[1] * grid[2]}


def dw_config() -> dict:
    """The geometry compiled into csrc/dw.cu and the blocks an SM holds,
    from the card's runtime; raises if the tile differs from this module's
    copy. Builds and loads the kernel; needs a CUDA device."""
    cfg = (ctypes.c_int * 7)()
    rc = cuda_kernels.function("dw", "lgs_dw_config",
                               [ctypes.c_void_p])(ctypes.addressof(cfg))
    if rc != 0:
        raise RuntimeError(f"dw occupancy query failed: CUDA error {rc}")
    keys = ("bm", "bn", "bk", "stages", "threads", "dynamic_smem_bytes",
            "blocks_per_sm")
    out = dict(zip(keys, cfg))
    if (out["bm"], out["bn"], out["bk"]) != (_DW_BM, _DW_BN, _DW_BK):
        raise RuntimeError(f"csrc/dw.cu tiles {out} differ from "
                           f"{(_DW_BM, _DW_BN, _DW_BK)}")
    return out


def _dw_pad_cols(t3b):
    """T3 with its columns zero-padded to a multiple of 8 (conv0: 9 -> 16):
    the kernel copies 8 bf16 at a time. The padded columns add zero rows to
    dW, which the wrapper slices off."""
    pad = (-t3b.shape[1]) % 8
    return F.pad(t3b, (0, pad)) if pad else t3b


def dw_fused(inv_wstart, inv_anchors, t3b, g, tile, win):
    """Fused dW of the anchored columns; contract as ``dw_fused_reference``.
    A CUDA input launches the Hopper kernel (``csrc/dw.cu``); a CPU input
    runs the plain version."""
    if g.device.type == "cpu":
        return dw_fused_reference(inv_wstart, inv_anchors, t3b, g, tile, win)
    out = _dw_launch(inv_wstart, inv_anchors, t3b, g, tile, win, None)
    launch_counts["dw"] += 1
    return out


# dw's ablation modes (csrc/dw.cu): the kernel, G rows read contiguously
# (no gather), the ring filled with no product, the product with nothing
# copied. Only "full" computes dW.
DW_ABLATION_MODES = ("full", "no_sel", "no_mma", "no_load")


def dw_ablation(inv_wstart, inv_anchors, t3b, g, tile, win, mode: str):
    """``dw_fused``'s launch in one of DW_ABLATION_MODES, for timing the
    kernel's load side apart from its product. Card only; counts no
    launch (it is not on the model's path)."""
    if g.device.type != "cuda":
        raise ValueError("dw_ablation: the modes run on a CUDA device only")
    return _dw_launch(inv_wstart, inv_anchors, t3b, g, tile, win,
                      DW_ABLATION_MODES.index(mode))


def _dw_launch(inv_wstart, inv_anchors, t3b, g, tile, win, mode):
    if g.device.type != "cuda":
        raise ValueError(f"dw_fused: unsupported device {g.device}")
    n_cols, cap = inv_anchors.shape
    cw, c_out = t3b.shape[1], g.shape[1]
    if c_out % 8:
        raise ValueError(f"dw_fused: c_out {c_out} is not a multiple of 8")
    if tile <= 0 or cap % tile or win > cap:
        raise ValueError(f"dw_fused: cap {cap}, tile {tile}, win {win}")
    dev = g.device
    _check(t3b, "t3b", torch.bfloat16, (cap, cw), dev)
    _check(g, "g", torch.bfloat16, (cap, c_out), dev)
    _check(inv_anchors, "inv_anchors", torch.int32, (n_cols, cap), dev)
    _check(inv_wstart, "inv_wstart", torch.int32, (cap // tile * n_cols,), dev)
    t3k = _dw_pad_cols(t3b)
    for t, name in ((t3k, "t3b"), (g, "g")):
        if t.data_ptr() % 16:
            raise ValueError(f"dw_fused: {name} is not 16-byte aligned")
    geo = dw_geometry(cap, cw, c_out, n_cols)
    cw_k, n_split = geo["cw_kernel"], geo["splits"]
    part = torch.empty((n_split, cw_k, n_cols * c_out), dtype=torch.float32,
                       device=dev)
    out = torch.empty((n_cols, cw_k, c_out), dtype=torch.float32, device=dev)
    args = [inv_wstart.data_ptr(), inv_anchors.data_ptr(), t3k.data_ptr(),
            g.data_ptr(), part.data_ptr(), out.data_ptr(), cap, cw_k, c_out,
            n_cols, tile, win, geo["rows_per_split"], n_split]
    if mode is None:
        fn = cuda_kernels.function("dw")
    else:
        fn = cuda_kernels.function(
            "dw", "lgs_dw_ablation",
            cuda_kernels.KERNELS["dw"][2][:-1] + [ctypes.c_int,
                                                   ctypes.c_void_p])
        args.append(mode)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dw kernel launch failed: CUDA error {rc}")
    return out if cw_k == cw else out[:, :cw].contiguous()


def _inv_from_anchors(anchors, ov_in, ov_out, ov_off, dwov_in, dwov_off):
    """Rebuild the dW inverse tiling on the device (production builds ship
    a 0-width ``inv_anchors``). The pre-routing anchors are the final ones
    with the ov entries put back; the inverse is their per-column scatter
    (injective per column over the complete pair set); the dwov positions
    are guarded again, as the host's routing did. Guard indices (cap) land
    in an extra column that is sliced off."""
    n_cols, cap = anchors.shape
    dev = anchors.device
    a_full = torch.cat([anchors.long(),
                        torch.full((n_cols, 1), cap, device=dev,
                                   dtype=torch.long)], dim=1)
    if ov_in.shape[0]:
        ci = _entry_cols(ov_off, ov_in.shape[0])
        a_full[ci, ov_out.long()] = ov_in.long()
    o = torch.arange(cap + 1, dtype=torch.int32, device=dev).expand(n_cols, -1)
    inv = torch.full((n_cols, cap + 1), cap, dtype=torch.int32, device=dev)
    inv.scatter_(1, a_full, o)
    if dwov_in.shape[0]:
        cj = _entry_cols(dwov_off, dwov_in.shape[0])
        inv[cj, dwov_in.long()] = cap
    return inv[:, :cap].contiguous()


def with_inverse_anchors(graph):
    """``graph`` with every windowed MaskedShiftMap's ``inv_anchors``
    rebuilt where the wire format left it 0-wide: once per map and batch,
    for the 47 convs that share 5 maps."""
    gmaps = dict(graph.gmaps or {})
    for name, m in gmaps.items():
        if (isinstance(m, MaskedShiftMap) and m.inv_wstart.numel()
                and m.inv_anchors.shape[1] == 0):
            gmaps[name] = m.replace(inv_anchors=_inv_from_anchors(
                _abs_anchors(m.anchors), m.ov_in, m.ov_out, m.ov_off,
                m.dwov_in, m.dwov_off))
    return graph.replace(gmaps=gmaps)


# ---- stride-1 k3 conv through the selector ----------------------------------


def _ov_from_pall(pall, n_cols, ov_in, ov_out, ov_off, cap):
    """Overflow COO served from the projection table: entry (col, o, i)
    contributes exactly P_col[i]. Guard entries (in = cap) add zero and land
    in the dropped row cap."""
    if ov_in.shape[0] == 0:
        return 0.0
    c_run = pall.shape[1] // (n_cols + 1)
    col = _entry_cols(ov_off, ov_in.shape[0])
    valid = ov_in < cap
    flat = torch.where(valid, ov_in.long() * (n_cols + 1) + col + 1,
                       torch.zeros_like(col))
    g = pall.reshape(cap * (n_cols + 1), c_run)[flat].to(torch.float32)
    g = torch.where(valid[:, None], g, torch.zeros((), device=g.device))
    out = torch.zeros((cap + 1, c_run), dtype=torch.float32, device=pall.device)
    return out.index_add_(0, ov_out.long(), g)[:-1]


def _oh_fwd_impl(x, w, mp, mn, mc, anchors, wstart, ov_in, ov_out, ov_off,
                 cols, tile, win):
    cap = x.shape[0]
    wstk = _wstack(w, cols)  # (G, 3C, c_out)
    n_cols = wstk.shape[0] - 1
    # bf16 T3 straight from bf16 x: the masks are {0, 1}, so this equals
    # the f32 table rounded to bf16. The guard row is not needed: P has
    # exactly cap rows and the kernel never reads a guard anchor.
    t3b = _t3(x.to(torch.bfloat16), mp, mn, mc)[:-1]
    wall = torch.cat(list(wstk), dim=1).to(torch.bfloat16)
    pall = t3b @ wall  # (cap, 9 * c_out) bf16, f32 accumulate
    acc = sel_fwd(wstart, anchors, mc, pall, n_cols, tile, win)
    # ov entries only target mc = 1 rows, so no mask after the kernel's
    # fused epilogue multiply
    return acc + _ov_from_pall(pall, n_cols, ov_in, ov_out, ov_off, cap)


def _oh_dw_impl(x, g32, m, inv_anchors, k_num):
    """dW of a selector conv (reference :415-443): the center column's
    contraction, the fused kernel for the 8 anchored columns, the dwov COO.
    ``g32`` is the output gradient already masked by mc."""
    c = x.shape[1]
    cols = tuple(m.cols)
    dw = [None] * k_num
    # bf16 T3 and g for the center contraction too, with f32 products and
    # sums, as the kernel does for the other 8 columns
    t3b = _t3(x.to(torch.bfloat16), m.mp, m.mn, m.mc)[:-1]
    gb = g32.to(torch.bfloat16)
    _put_cols(dw, cols[0], c,
              t3b.to(torch.float32).t() @ gb.to(torch.float32))
    dwcols = dw_fused(m.inv_wstart, inv_anchors, t3b, gb, int(m.tile),
                      int(m.win))
    for gi, col in enumerate(cols[1:]):
        _put_cols(dw, col, c, dwcols[gi])
    for gi, dcol in _ov_dw_pieces(x, m.mp, m.mn, m.mc, g32, m.dwov_in,
                                  m.dwov_out, m.dwov_off, len(cols) - 1):
        _put_cols(dw, cols[gi + 1], c, dcol)
    zero = g32.new_zeros((c, g32.shape[1]))
    return torch.stack([zero if d is None else d for d in dw])


class _OnehotWindowConv(torch.autograd.Function):
    """The reference's ``_oh_core`` custom VJP (:446-519). Saves x and w
    (not the projection table: 102 MB per conv at L0, c = 96); the backward
    rebuilds T3."""

    @staticmethod
    def forward(ctx, x, w, msmap, anchors):
        m = msmap
        out = _oh_fwd_impl(x, w, m.mp, m.mn, m.mc, anchors, m.wstart,
                           m.ov_in, m.ov_out, m.ov_off, tuple(m.cols),
                           int(m.tile), int(m.win))
        ctx.save_for_backward(x, w, anchors)
        ctx.msmap = msmap
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g_out):
        x, w, anchors = ctx.saved_tensors
        m = ctx.msmap
        g32 = g_out.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dX: the same pair structure with mirrored, transposed weights.
            # sel_fwd's width is c_in: pad it to a multiple of 8, slice back
            c_in = x.shape[1]
            wt = _wt(w, m.mirror_perm)
            ci_pad = (-c_in) % 8
            if ci_pad:
                wt = F.pad(wt, (0, ci_pad))
            dx = _oh_fwd_impl(g32, wt, m.mp, m.mn, m.mc, anchors, m.wstart,
                              m.ov_in, m.ov_out, m.ov_off, tuple(m.cols),
                              int(m.tile), int(m.win))
            dx = dx[:, :c_in].to(x.dtype)
        if ctx.needs_input_grad[1]:
            inv = m.inv_anchors
            if inv.shape[1] == 0:
                inv = _inv_from_anchors(anchors, m.ov_in, m.ov_out, m.ov_off,
                                        m.dwov_in, m.dwov_off)
            gm = g32 * m.mc[:, None].to(torch.float32)
            dw = _oh_dw_impl(x, gm, m, inv, w.shape[0]).to(w.dtype)
        return dx, dw, None, None


def onehot_window_conv(x, w, msmap, bias=None):
    """Apply a stride-1 k3 conv through a window-annotated MaskedShiftMap:
    bf16 projection, selector kernel, f32 accumulation; differentiable in
    x, w and bias.

    Returns None when the map has no window annotation (or its shapes do
    not divide); the caller then takes the f32 masked-shift gather."""
    tile, win = int(msmap.tile), int(msmap.win)
    if tile <= 0 or msmap.wstart.numel() == 0 or msmap.inv_wstart.numel() == 0:
        return None
    cap = x.shape[0]
    if cap % tile or cap < win:
        return None
    # 16-byte vector loads in the kernels take 8 bf16 channels at a time:
    # pad the output channels to a multiple of 8 and slice back
    c_out = w.shape[2]
    c_pad = (-c_out) % 8
    wp = F.pad(w, (0, c_pad)) if c_pad else w
    out = _OnehotWindowConv.apply(x, wp, msmap, _abs_anchors(msmap.anchors))
    if c_pad:
        out = out[:, :c_out]
    if bias is not None:
        out = out + bias * msmap.mc[:, None].to(out.dtype)
    return out


# ---- child-sum conv: strided (down) convs ------------------------------------


def _ov_fwd_plain(x, w, ov_in, ov_out, ov_off, n_out):
    """Out-of-window COO of the slot-window convs: out[o] += x[i] @ w[slot],
    in x's dtype (f32), slot-major segments, guards in = cap_in /
    out = n_out."""
    if ov_in.shape[0] == 0:
        return 0.0
    cap_in = x.shape[0]
    valid = ov_in < cap_in
    g = x[torch.where(valid, ov_in, torch.zeros_like(ov_in)).long()]
    g = g * valid[:, None].to(x.dtype)
    col = _entry_cols(ov_off, ov_in.shape[0])
    contrib = torch.zeros((g.shape[0], w.shape[2]), dtype=torch.float32,
                          device=x.device)
    for k in range(w.shape[0]):
        contrib = torch.where((col == k)[:, None],
                              g.to(torch.float32) @ w[k].to(torch.float32),
                              contrib)
    out = torch.zeros((n_out + 1, w.shape[2]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, ov_out.long(), contrib)[:-1]


def _parent_groups(parent, kslot, n_slots, n_groups, cap_out):
    """(n_groups, cap_in) per-group parent rows: group g keeps the rows
    whose slot lies in its contiguous slot range; every other row (guards
    included) reads the never-matching cap_out."""
    cap_in = parent.shape[0]
    if n_groups == 1:
        return parent.reshape(1, cap_in).contiguous()
    gsz = n_slots // n_groups
    grp = kslot.to(torch.int32) // gsz  # guards land at n_groups
    gids = torch.arange(n_groups, dtype=torch.int32, device=parent.device)[:, None]
    return torch.where(grp[None, :] == gids, parent[None, :],
                       torch.full((), cap_out, dtype=torch.int32,
                                  device=parent.device)).contiguous()


def _cs_fwd_impl(x, w, wstart, parent, kslot, ov_in, ov_out, ov_off, cap_out,
                 tile, win, n_groups):
    k = w.shape[0]
    xb = x.to(torch.bfloat16)
    ks = kslot.long()
    # one-hot slot stack: row i holds x[i] in block kslot[i] only, so ONE
    # GEMM computes P[i] = x[i] @ W[kslot[i]] for every row
    xk = torch.cat([xb * (ks == j)[:, None].to(torch.bfloat16)
                    for j in range(k)], dim=1)
    wflat = torch.cat([w[j] for j in range(k)], dim=0).to(torch.bfloat16)
    pall = xk @ wflat  # (cap_in, c_out) bf16, f32 accumulate
    parent_g = _parent_groups(parent, kslot, k, n_groups, cap_out)
    acc = csum(wstart, parent_g, pall, cap_out, tile, win, n_groups)
    return acc + _ov_fwd_plain(x, w, ov_in, ov_out, ov_off, cap_out)


def _cs_scatter_impl(x, w, parent, kslot, cap_out):
    """Scatter form of the child sum, exact over the full (parent, kslot)
    partition, in f32: maps without a window annotation. Guard rows
    (kslot == K) match no slot and land in the dropped row cap_out."""
    x32 = x.to(torch.float32)
    ks = kslot.long()
    p = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                    device=x.device)
    zero = torch.zeros((), device=x.device)
    for j in range(w.shape[0]):
        p = p + torch.where((ks == j)[:, None], x32, zero) @ w[j].to(torch.float32)
    dst = torch.clamp(parent.long(), max=cap_out)
    out = torch.zeros((cap_out + 1, w.shape[2]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, dst, p)[:cap_out]


def _abs_parent(csmap):
    """Absolute int32 parents. A non-empty ``parent_base`` marks the
    block-delta wire format: parent[i] is a delta against the base of its
    128-row block, and guard rows (kslot == num_slots) decode to
    out_capacity."""
    p = csmap.parent
    if csmap.parent_base.numel() == 0:
        return p.to(torch.int32)
    n = p.shape[0]
    blk = csmap.parent_base[torch.arange(n, device=p.device) >> 7]
    dec = blk + p.to(torch.int32)
    guard = torch.full_like(dec, csmap.out_capacity)
    return torch.where(csmap.kslot.to(torch.int32) == csmap.num_slots, guard,
                       dec)


def _cs_window(csmap, cap_in):
    """(tile, win, n_groups) of the windowed kernel, or tile 0 for the
    scatter form."""
    tile, win = int(csmap.tile), int(csmap.win)
    if (tile <= 0 or csmap.wstart.numel() == 0
            or csmap.out_capacity % tile or cap_in < win):
        return 0, 0, 1
    return tile, win, int(csmap.n_groups)


class _ChildSumConv(torch.autograd.Function):
    """The reference's ``_cs_core`` custom VJP (:767-810): windowed kernel
    or scatter forward; gather-only backward through the down map's input
    partition (every input row belongs to exactly one (parent, slot) pair),
    exact over all pairs, the forward's overflow COO included."""

    @staticmethod
    def forward(ctx, x, w, csmap, parent, window):
        tile, win, n_groups = window
        cap_out = csmap.out_capacity
        if tile:
            out = _cs_fwd_impl(x, w, csmap.wstart, parent, csmap.kslot,
                               csmap.ov_in, csmap.ov_out, csmap.ov_off,
                               cap_out, tile, win, n_groups)
        else:
            out = _cs_scatter_impl(x, w, parent, csmap.kslot, cap_out)
        ctx.save_for_backward(x, w, parent, csmap.kslot)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g_out):
        x, w, parent, kslot = ctx.saved_tensors
        g32 = g_out.to(torch.float32)
        # guard rows carry parent = cap_out: clip so the (discarded, their
        # slot matches nothing) gather stays in bounds
        pclip = torch.clamp(parent, 0, g32.shape[0] - 1)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _parent_fwd_impl(g32, _wt(w), pclip, kslot).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _slot_dw(x.to(torch.float32), g32[pclip.long()], kslot,
                        w.shape[0]).to(w.dtype)
        return dx, dw, None, None, None


def child_sum_conv(x, w, csmap, bias=None):
    """Apply a strided (down) conv through a ChildSumMap: the windowed
    child-sum kernel when the map carries a (tile, win) annotation, the
    exact f32 scatter form otherwise; differentiable in x, w and bias."""
    window = _cs_window(csmap, x.shape[0])
    out = _ChildSumConv.apply(x, w, csmap, _abs_parent(csmap), window)
    if bias is not None:
        out = out + bias
    return out


class _TransposeChildSumConv(torch.autograd.Function):
    """The reference's ``_tcs_core`` custom VJP (:901-940): a gather
    forward; dX through the child-sum direction (the ``csum`` kernel when
    the companion map is windowed), dW as K masked contractions against
    x gathered at the parents."""

    @staticmethod
    def forward(ctx, x, w, csmap, parent, window):
        pclip = torch.clamp(parent, 0, x.shape[0] - 1)
        out = _parent_fwd_impl(x, w, pclip, csmap.kslot)
        ctx.save_for_backward(x, w, parent, pclip, csmap.kslot)
        ctx.csmap, ctx.window = csmap, window
        return out

    @staticmethod
    def backward(ctx, g_out):
        x, w, parent, pclip, kslot = ctx.saved_tensors
        m = ctx.csmap
        tile, win, n_groups = ctx.window
        g32 = g_out.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = _wt(w)  # (K, c_out, c_in)
            if tile:
                dx = _cs_fwd_impl(g32, wt, m.wstart, parent, kslot, m.ov_in,
                                  m.ov_out, m.ov_off, m.out_capacity, tile,
                                  win, n_groups)
            else:
                dx = _cs_scatter_impl(g32, wt, parent, kslot, m.out_capacity)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _slot_dw(x[pclip.long()].to(torch.float32), g32, kslot,
                        w.shape[0]).to(w.dtype)
        return dx, dw, None, None, None


def transpose_child_sum_conv(x, w, csmap, bias=None):
    """Apply a k2s2 transpose (up) conv through the companion DOWN map's
    ChildSumMap: out_fine[o] = x_coarse[parent[o]] @ W[kslot[o]]. The up
    map's offsets are the down map's negated in the same order, so the slot
    order matches. x: (coarse cap, Cin); returns (in_capacity, Cout).
    The backward's dX runs the child-sum direction at the fine capacity,
    so the window is checked there."""
    window = _cs_window(csmap, int(csmap.in_capacity))
    out = _TransposeChildSumConv.apply(x, w, csmap, _abs_parent(csmap),
                                       window)
    if bias is not None:
        out = out + bias
    return out
