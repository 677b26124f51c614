"""The one-hot gather-GEMM microbenchmarks and their Hopper kernels.

Counterpart of the two ablation scripts of the JAX package,
``scripts/bench_onehot_pallas.py`` (one column: a windowed row gather
followed by a projection GEMM) and ``scripts/bench_onehot_variants.py``
(nine columns in three window groups, in four modes that take one stage out
each). On the TPU both select rows with one-hot matmuls over a window held
in VMEM; on the card the same functions are a direct row gather feeding a
GEMM, in ``csrc/onehot_gemm.cu`` and ``csrc/onehot_variants.cu``.

Each kernel has a plain PyTorch version beside its wrapper
(``onehot_gemm_reference``, ``onehot_variants_reference``). A CUDA input
launches the kernel, a CPU input runs the plain version; there is no
fallback from one to the other. The input builders copy the scripts'
constants and seeded construction (numpy ``default_rng``, same draw order),
so the same seed gives the same arrays as the scripts.

Nothing on the model's path calls these: their launches are counted in this
module's ``launch_counts``, apart from ``onehot_conv.launch_counts``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.ops import cuda_kernels
from languagegroundedsemseg_torch.ops.onehot_conv import _check

# Launches of each kernel: a wrapper adds one where it launches its kernel
# on the card and nowhere else (the CPU path runs the plain version).
launch_counts = {"onehot_gemm": 0, "onehot_variants": 0}

# scripts/bench_onehot_pallas.py:17-22 (B, W, CW, COUT, N, M)
GEMM_SHAPES = dict(n=262144, b=1024, w=2048, cw=384, c_out=96, margin=768)
# scripts/bench_onehot_variants.py:18-23 (TILE, WIN, NG, CWP, COUT, CAP)
VARIANTS_SHAPES = dict(cap=262144, tile=1024, win=1536, n_groups=3, cw=384,
                       c_out=96)
# the variants script's anchor spread and window lead (:93, :95)
VARIANTS_SPREAD, VARIANTS_LEAD = 400, 256
COLS_PER_GROUP = 3

# full: gather, projection, bf16 rounding of each column's product;
# no_dma: the gather's loads replaced by a zero fill (output all zeros);
# no_sel: contiguous window rows instead of the anchored gather;
# no_proj: the first c_out gathered channels instead of the projection
MODES = ("full", "no_dma", "no_sel", "no_proj")

# output widths the kernels are built for: the scripts' 96 and the card
# tests' 16 and 32 (csrc/onehot_gemm.cu, csrc/onehot_variants.cu)
KERNEL_C_OUT = (16, 32, 96)

# csrc/onehot_gemm.cu's launch constants: output rows a block, channels a
# step, ring stages, threads (8 warps), bf16 parts of W, prepass threads
_G_BM, _G_BK, _G_STAGES, _G_THREADS, _G_PARTS, _G_SPLIT_THREADS = (
    256, 32, 4, 256, 3, 256)
# csrc/onehot_variants.cu's launch constants: output rows a block, channels
# a step, ring stages, threads (16 warps), most columns
_V_BM, _V_BK, _V_STAGES, _V_THREADS, _V_MAX_COLS = 256, 32, 4, 512, 16


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---- single-column gather-GEMM (bench_onehot_pallas.py) ---------------------


def gemm_inputs(n, b, w, cw, c_out, margin, seed=0, device="cuda"):
    """The script's inputs (bench_onehot_pallas.py:84-100): t3 f32 (n, cw),
    W f32 (cw, c_out), one anchor per output row near its own row, one
    8-aligned window start per tile of b rows, every anchor clipped into
    its tile's window. Returns torch tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_tiles = n // b
    t3 = rng.normal(size=(n, cw)).astype(np.float32)
    wmat = (rng.normal(size=(cw, c_out)) * 0.05).astype(np.float32)
    anchors = np.clip(np.arange(n) + rng.integers(-margin, margin, n), 0,
                      n - 1).astype(np.int32)
    wstart = np.clip(np.arange(n_tiles) * b - (w - b) // 2, 0,
                     n - w).astype(np.int32)
    wstart &= ~7
    lo = np.repeat(wstart, b)
    anchors = np.clip(anchors, lo, lo + w - 1).astype(np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in
            (("wstart", wstart), ("anchors", anchors), ("t3", t3),
             ("w", wmat))}


def _gemm_hits(wstart, anchors, n_rows, tile, win):
    """(in-window mask, clamped rows) of the single-column gather."""
    a = anchors.long()
    ws = wstart.long().repeat_interleave(tile)
    hit = (a >= ws) & (a < ws + win) & (a >= 0) & (a < n_rows)
    return hit, torch.where(hit, a, torch.zeros_like(a))


def onehot_gemm_reference(wstart, anchors, t3, w, tile, win):
    """Plain version of the ``onehot_gemm`` kernel: for output row r of
    tile t = r // tile, with a = anchors[r] and ws = wstart[t],

        out[r] = [ws <= a < ws + win] * f32(bf16(t3[a])) @ W

    in f32 (t3 and W f32; only the gathered t3 values are rounded to bf16,
    as the one-hot product on the TPU rounds them). Returns (n, c_out)
    f32."""
    hit, rows = _gemm_hits(wstart, anchors, t3.shape[0], tile, win)
    g = t3[rows].to(torch.bfloat16).to(torch.float32)
    g = torch.where(hit[:, None], g, torch.zeros((), device=g.device))
    return g @ w


def split_bf16x3(w):
    """W f32 split into three bf16 parts, (3, cw, c_out): Wh = bf16(W), Wm =
    bf16(W - Wh), Wl = bf16(W - Wh - Wm), each rounded to nearest, the
    residuals exact f32 differences. Wh + Wm + Wl == W exactly for every
    finite W with 2^-110 <= |W| < 2^127 (2 - 2^-8), or W = 0. The plain
    version of the prepass of ``csrc/onehot_gemm.cu``, for tests and the
    card's check of that prepass; no path calls it."""
    h = w.to(torch.bfloat16)
    r1 = w - h.to(torch.float32)
    m = r1.to(torch.bfloat16)
    low = (r1 - m.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([h, m, low])


def _gemm_smem_bytes(c_out: int) -> int:
    """csrc/onehot_gemm.cu's smem_bytes: the ring's f32 t3 stages
    (unpadded, chunks swizzled) and the three W parts' stages (bf16, rows
    padded by 8), and the resolved rows (int32 a row)."""
    return (_G_STAGES * (_G_BM * _G_BK * 4
                         + _G_PARTS * _G_BK * (c_out + 8) * 2)
            + _G_BM * 4)


def gemm_geometry(n: int, cw: int, c_out: int) -> dict:
    """The launch of ``onehot_gemm`` at these shapes: the prepass (one
    thread per element of the (3, cw_pad, c_out) split, cw_pad = cw rounded
    up to 32), then one block of 256 output rows (8 warps) per grid entry,
    the last one ragged; each warp's tile; the 32-channel steps each block
    walks; ring stages; dynamic shared memory (at most 227 KB: the kernel
    source asserts it). Raises ValueError for shapes the kernel does not
    take: c_out other than 16, 32 or 96 (the widths built), cw not a
    positive multiple of 4 (16-byte copies of f32 rows), n below 1."""
    if c_out not in KERNEL_C_OUT:
        raise ValueError(f"onehot_gemm: c_out {c_out} is not one of "
                         f"{KERNEL_C_OUT}")
    if cw <= 0 or cw % 4:
        raise ValueError(f"onehot_gemm: cw {cw} must be a positive multiple "
                         "of 4")
    if n <= 0:
        raise ValueError(f"onehot_gemm: n {n}")
    blocks = -(-n // _G_BM)
    cw_pad = -(-cw // _G_BK) * _G_BK
    split_blocks = -(-cw_pad * c_out // _G_SPLIT_THREADS)
    # csrc/onehot_gemm.cu's Tiling: 4 x 2 warps for an even number of
    # 16-column blocks, else 8 x 1
    warps_n = 2 if (c_out // 16) % 2 == 0 else 1
    return {"grid": [blocks], "blocks": blocks, "threads": _G_THREADS,
            "rows_per_block": _G_BM,
            "warp_tile": [_G_BM * warps_n // (_G_THREADS // 32),
                          c_out // warps_n],
            "channels_per_step": _G_BK, "steps": cw_pad // _G_BK,
            "stages": _G_STAGES, "cw_pad": cw_pad,
            "split_shape": [_G_PARTS, cw_pad, c_out],
            "split_grid": [split_blocks],
            "split_threads": _G_SPLIT_THREADS,
            "smem_bytes": _gemm_smem_bytes(c_out)}


def gemm_config(c_out: int = 96) -> dict:
    """The constants compiled into csrc/onehot_gemm.cu, its shared memory
    at c_out and the blocks an SM holds there, from the card's runtime (the
    default is the script's width); raises if they differ from this
    module's copy. Builds and loads the kernel; needs a CUDA device."""
    cfg = (ctypes.c_int * 8)()
    rc = cuda_kernels.function(
        "onehot_gemm", "lgs_onehot_gemm_config",
        [ctypes.c_void_p, ctypes.c_int])(ctypes.addressof(cfg), c_out)
    if rc != 0:
        raise RuntimeError(
            f"onehot_gemm occupancy query failed: CUDA error {rc}")
    keys = ("rows_per_block", "channels_per_step", "stages", "threads",
            "parts", "split_threads", "dynamic_smem_bytes", "blocks_per_sm")
    out = dict(zip(keys, cfg))
    want = {"rows_per_block": _G_BM, "channels_per_step": _G_BK,
            "stages": _G_STAGES, "threads": _G_THREADS, "parts": _G_PARTS,
            "split_threads": _G_SPLIT_THREADS,
            "dynamic_smem_bytes": _gemm_smem_bytes(c_out)}
    if any(out[k] != v for k, v in want.items()):
        raise RuntimeError(f"csrc/onehot_gemm.cu constants {out} differ "
                           f"from {want}")
    return out


def _raw_stream(dev):
    return torch._C._cuda_getCurrentRawStream(dev.index)


def gemm_split(w):
    """W's three bf16 parts as ``onehot_gemm``'s prepass writes them:
    (3, cw_pad, c_out), rows past cw zero. A CUDA input launches the
    prepass alone (not counted: it is a check of the onehot_gemm launch's
    first kernel, not that launch); a CPU input runs ``split_bf16x3``."""
    cw, c_out = w.shape
    geo = gemm_geometry(1, cw, c_out)
    if w.device.type == "cpu":
        parts = torch.zeros(geo["split_shape"], dtype=torch.bfloat16)
        parts[:, :cw] = split_bf16x3(w)
        return parts
    if w.device.type != "cuda":
        raise ValueError(f"gemm_split: unsupported device {w.device}")
    _check(w, "w", torch.float32, (cw, c_out), w.device)
    parts = torch.empty(geo["split_shape"], dtype=torch.bfloat16,
                        device=w.device)
    fn = cuda_kernels.function(
        "onehot_gemm", "lgs_onehot_gemm_split",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(w.device):
        rc = fn(w.data_ptr(), parts.data_ptr(), cw, c_out,
                _raw_stream(w.device))
    if rc != 0:
        raise RuntimeError(f"onehot_gemm prepass failed: CUDA error {rc}")
    return parts


def onehot_gemm(wstart, anchors, t3, w, tile, win):
    """Windowed row gather and f32 projection; contract as
    ``onehot_gemm_reference``. A CUDA input launches the Hopper kernels
    (``csrc/onehot_gemm.cu``: the prepass splitting W into three bf16 parts
    into scratch allocated here, then the product on the tensor cores; one
    count) or raises (see ``gemm_geometry``); a CPU input runs the plain
    version."""
    if t3.device.type == "cpu":
        return onehot_gemm_reference(wstart, anchors, t3, w, tile, win)
    if t3.device.type != "cuda":
        raise ValueError(f"onehot_gemm: unsupported device {t3.device}")
    n = anchors.shape[0]
    n_rows, cw = t3.shape
    c_out = w.shape[1]
    geo = gemm_geometry(n, cw, c_out)
    if tile <= 0 or n % tile or win <= 0:
        raise ValueError(f"onehot_gemm: n {n}, tile {tile}, win {win}")
    dev = t3.device
    _check(t3, "t3", torch.float32, device=dev)
    _check(w, "w", torch.float32, (cw, c_out), dev)
    _check(anchors, "anchors", torch.int32, (n,), dev)
    _check(wstart, "wstart", torch.int32, (n // tile,), dev)
    if t3.data_ptr() % 16:
        raise ValueError("onehot_gemm: t3 is not 16-byte aligned")
    wsplit = torch.empty(geo["split_shape"], dtype=torch.bfloat16,
                         device=dev)
    out = torch.empty((n, c_out), dtype=torch.float32, device=dev)
    args = (wstart.data_ptr(), anchors.data_ptr(), t3.data_ptr(),
            w.data_ptr(), wsplit.data_ptr(), out.data_ptr(), n, n_rows, cw,
            c_out, tile, win)
    fn = cuda_kernels.function("onehot_gemm")
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, _raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, _raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"onehot_gemm kernel launch failed: CUDA error {rc}")
    launch_counts["onehot_gemm"] += 1
    return out


# ---- nine-column cost ablation (bench_onehot_variants.py) -------------------


def variants_inputs(cap, tile, win, n_groups, cw, c_out, seed=0,
                    device="cuda"):
    """The script's inputs (bench_onehot_variants.py:89-96): t3 bf16
    (cap + win, cw), W bf16 (3 * n_groups, cw, c_out), anchors int32
    (8, cap) within +-400 of their row, window starts int32
    (cap / tile * n_groups,) 256 rows before each tile, 8-aligned. Returns
    torch tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_tiles = cap // tile
    t3 = rng.normal(size=(cap + win, cw)).astype(np.float32)
    wmat = (rng.normal(size=(COLS_PER_GROUP * n_groups, cw, c_out))
            * 0.05).astype(np.float32)
    anchors = np.clip(np.arange(cap)[None, :] + rng.integers(
        -VARIANTS_SPREAD, VARIANTS_SPREAD, (8, cap)), 0,
        cap - 1).astype(np.int32)
    wstart = np.clip(np.repeat(np.arange(n_tiles) * tile, n_groups)
                     - VARIANTS_LEAD, 0, cap) & ~7
    return {"wstart": torch.from_numpy(wstart.astype(np.int32)).to(dev),
            "anchors": torch.from_numpy(anchors).to(dev),
            "t3": torch.from_numpy(t3).to(dev, torch.bfloat16),
            "w": torch.from_numpy(wmat).to(dev, torch.bfloat16)}


def variants_rows(mode, col, wstart, anchors, n_rows, tile, win, n_groups):
    """(valid mask, clamped t3 rows) that column ``col`` reads for every
    output row o of tile t = o // tile: the anchor of anchors row
    min(col, 7) when it lies in the window of group col // 3 (full,
    no_proj), or row ws + o - t * tile of that window (no_sel)."""
    cap = anchors.shape[1]
    o = torch.arange(cap, device=anchors.device)
    t = o // tile
    ws = wstart[t * n_groups + col // COLS_PER_GROUP].long()
    if mode == "no_sel":
        r = ws + o - t * tile
        ok = (r >= 0) & (r < n_rows)
    else:
        r = anchors[min(col, anchors.shape[0] - 1)].long()
        ok = (r >= ws) & (r < ws + win) & (r >= 0) & (r < n_rows)
    return ok, torch.where(ok, r, torch.zeros_like(r))


def onehot_variants_reference(mode, wstart, anchors, t3, w, tile, win,
                              n_groups):
    """Plain version of the ``onehot_variants`` kernel, for output row o
    (columns col = 0 .. 3 * n_groups - 1 added in order, in f32):

        full:    out[o] = sum_col [hit] * f32(bf16(t3[a] @ W[col]))
        no_sel:  out[o] = sum_col t3[ws + o - t * tile] @ W[col]
        no_proj: out[o] = sum_col [hit] * t3[a][:c_out]
        no_dma:  out[o] = 0

    with a = anchors[min(col, 7), o], ws = wstart[t * n_groups + col // 3],
    hit = ws <= a < ws + win, t = o // tile. t3 and W bf16; products of
    bf16 values summed in f32. Returns (cap, c_out) f32."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    cap = anchors.shape[1]
    c_out = w.shape[2]
    out = torch.zeros((cap, c_out), dtype=torch.float32, device=t3.device)
    if mode == "no_dma":
        return out
    zero = torch.zeros((), device=t3.device)
    for col in range(w.shape[0]):
        ok, rows = variants_rows(mode, col, wstart, anchors, t3.shape[0],
                                 tile, win, n_groups)
        x = t3[rows].to(torch.float32)
        if mode == "no_proj":
            y = x[:, :c_out]
        else:
            y = x @ w[col].to(torch.float32)
            if mode == "full":
                y = y.to(torch.bfloat16).to(torch.float32)
        out = out + torch.where(ok[:, None], y, zero)
    return out


def _variants_smem_bytes(c_out: int, n_cols: int) -> int:
    """csrc/onehot_variants.cu's smem_bytes: the ring's t3 and W stages
    (bf16, rows padded by 8), the running sum (f32, rows padded by 8) and
    the resolved rows (int32 a column and row)."""
    ring = _V_STAGES * (_V_BM * (_V_BK + 8) + _V_BK * (c_out + 8)) * 2
    return ring + _V_BM * (c_out + 8) * 4 + n_cols * _V_BM * 4


def variants_geometry(cap: int, cw: int, c_out: int, n_cols: int) -> dict:
    """The launch of ``onehot_variants`` at these shapes: one block of 256
    output rows (16 warps) per grid entry, the last one ragged; each warp's
    tile; the (column, 32-channel chunk) steps each block walks; ring
    stages; dynamic shared memory (at most 227 KB: the kernel source
    asserts it for the widest plan). Raises ValueError for shapes the
    kernel does not take:
    c_out other than 16, 32 or 96 (the widths built) or above cw, cw not a
    positive multiple of 8 (16-byte copies), n_cols not 3, 6, .. 15 (three
    columns a group, at most 16), a cap below 1."""
    if c_out not in KERNEL_C_OUT:
        raise ValueError(f"onehot_variants: c_out {c_out} is not one of "
                         f"{KERNEL_C_OUT}")
    if cw <= 0 or cw % 8 or c_out > cw:
        raise ValueError(f"onehot_variants: cw {cw} must be a multiple of 8 "
                         f"and at least c_out {c_out}")
    if (n_cols <= 0 or n_cols % COLS_PER_GROUP or n_cols > _V_MAX_COLS):
        raise ValueError(f"onehot_variants: {n_cols} weight columns (3 per "
                         f"group, at most {_V_MAX_COLS})")
    if cap <= 0:
        raise ValueError(f"onehot_variants: cap {cap}")
    blocks = -(-cap // _V_BM)
    chunks = -(-cw // _V_BK)
    # csrc/onehot_variants.cu's Tiling: 8 x 2 warps for an even number of
    # 16-column blocks, else 16 x 1
    warps_n = 2 if (c_out // 16) % 2 == 0 else 1
    return {"grid": [blocks], "blocks": blocks, "threads": _V_THREADS,
            "rows_per_block": _V_BM,
            "warp_tile": [_V_BM * warps_n // (_V_THREADS // 32),
                          c_out // warps_n],
            "channels_per_step": _V_BK, "steps": n_cols * chunks,
            "stages": _V_STAGES,
            "smem_bytes": _variants_smem_bytes(c_out, n_cols)}


def variants_config(c_out: int = 96, n_cols: int = 9) -> dict:
    """The constants compiled into csrc/onehot_variants.cu, its shared
    memory at (c_out, n_cols) and the blocks an SM holds there, from the
    card's runtime (the defaults are the ablation script's); raises if they
    differ from this module's copy. Builds and loads the kernel; needs a
    CUDA device."""
    cfg = (ctypes.c_int * 7)()
    rc = cuda_kernels.function(
        "onehot_variants", "lgs_onehot_variants_config",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int])(
            ctypes.addressof(cfg), c_out, n_cols)
    if rc != 0:
        raise RuntimeError(
            f"onehot_variants occupancy query failed: CUDA error {rc}")
    keys = ("rows_per_block", "channels_per_step", "stages", "threads",
            "max_cols", "dynamic_smem_bytes", "blocks_per_sm")
    out = dict(zip(keys, cfg))
    want = {"rows_per_block": _V_BM, "channels_per_step": _V_BK,
            "stages": _V_STAGES, "threads": _V_THREADS,
            "max_cols": _V_MAX_COLS,
            "dynamic_smem_bytes": _variants_smem_bytes(c_out, n_cols)}
    if any(out[k] != v for k, v in want.items()):
        raise RuntimeError(f"csrc/onehot_variants.cu constants {out} differ "
                           f"from {want}")
    return out


def onehot_variants(mode, wstart, anchors, t3, w, tile, win, n_groups):
    """The nine-column gather-GEMM in one of ``MODES``; contract as
    ``onehot_variants_reference``. A CUDA input launches the Hopper kernel
    (``csrc/onehot_variants.cu``) or raises (see ``variants_geometry``); a
    CPU input runs the plain version."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if t3.device.type == "cpu":
        return onehot_variants_reference(mode, wstart, anchors, t3, w, tile,
                                         win, n_groups)
    if t3.device.type != "cuda":
        raise ValueError(f"onehot_variants: unsupported device {t3.device}")
    n_arows, cap = anchors.shape
    n_rows, cw = t3.shape
    n_cols, _, c_out = w.shape
    variants_geometry(cap, cw, c_out, n_cols)
    if n_cols != COLS_PER_GROUP * n_groups:
        raise ValueError(f"onehot_variants: {n_cols} weight columns for "
                         f"{n_groups} groups (3 per group)")
    if tile <= 0 or cap % tile or not tile <= win:
        raise ValueError(f"onehot_variants: cap {cap}, tile {tile}, win {win}")
    dev = t3.device
    _check(t3, "t3", torch.bfloat16, device=dev)
    _check(w, "w", torch.bfloat16, (n_cols, cw, c_out), dev)
    _check(anchors, "anchors", torch.int32, (n_arows, cap), dev)
    _check(wstart, "wstart", torch.int32, (cap // tile * n_groups,), dev)
    for t, name in ((t3, "t3"), (w, "w")):
        if t.data_ptr() % 16:
            raise ValueError(f"onehot_variants: {name} is not 16-byte aligned")
    out = torch.empty((cap, c_out), dtype=torch.float32, device=dev)
    args = (wstart.data_ptr(), anchors.data_ptr(), t3.data_ptr(),
            w.data_ptr(), out.data_ptr(), MODES.index(mode), cap, n_rows, cw,
            c_out, tile, win, n_groups, n_arows)
    fn = cuda_kernels.function("onehot_variants")
    # the raw stream handle, as sel_fwd passes it; the device's context is
    # entered only when the tensor is not on the current device
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, _raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, _raw_stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"onehot_variants kernel launch failed: CUDA error {rc}")
    launch_counts["onehot_variants"] += 1
    return out
