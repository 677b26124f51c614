"""Selector and child-sum sparse convs (forward), and their Hopper kernels.

Counterpart of ``languagegroundedsemseg_tpu/ops/onehot_conv.py``. Around the
two kernels this module computes exactly what the reference computes
outside its Pallas kernels:

* ``onehot_window_conv`` (stride-1 k3 convs with a window annotation): the
  bf16 masked-shift table T3, ONE bf16 projection GEMM
  ``P = T3 @ [W_center | W_col1..8]``, the selector kernel ``sel_fwd``, and
  the overflow COO served from P (``_ov_from_pall``).
* ``child_sum_conv`` (down convs): ``P[i] = x[i] @ W[kslot[i]]`` from one
  bf16 GEMM over the one-hot slot stack, the child-sum kernel ``csum``, and
  the f32 overflow COO (``_ov_fwd_plain``); without a window annotation the
  exact scatter form (``_cs_scatter_impl``).
* ``transpose_child_sum_conv`` (up convs): a gather through the companion
  down map's (parent, kslot) partition.

The routing is the same on every device: the window annotation decides the
path. Inside a kernel wrapper a CUDA tensor launches the hand-written
kernel (``csrc/sel_fwd.cu``, ``csrc/csum.cu``) and a CPU tensor runs the
plain PyTorch version beside it (``sel_fwd_reference``,
``csum_reference``). There is no fallback from one to the other. The
reference's TPU probe and VMEM budget checks have no counterpart here.

This slice is forward only: a wrapper given an input that requires grad
while grad mode is on raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from languagegroundedsemseg_torch.ops import cuda_kernels
from languagegroundedsemseg_torch.ops.msconv import (
    _abs_anchors,
    _entry_cols,
    _t3,
    _wstack,
)
from languagegroundedsemseg_torch.ops.spconv import _parent_fwd_impl

# Launches of each kernel: a wrapper adds one where it launches its kernel
# on the card and nowhere else (the CPU path runs the plain version).
launch_counts = {"sel_fwd": 0, "csum": 0}

# csum keeps a (tile, chunk) f32 accumulator in shared memory; the chunk of
# channels per block is sized to this budget (below the 227 KB a block may
# use, so two blocks can share an SM).
CSUM_SMEM_BUDGET = 96 * 1024


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the Hopper conv kernels are forward only in this slice; their "
            "backward (dX, dW) is ported with the train step in slice B — "
            "run the forward under torch.no_grad() or torch.inference_mode()")


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


def sel_fwd(wstart, anchors, mc, pall, n_cols, tile, win):
    """Selector forward; contract as ``sel_fwd_reference``. A CUDA input
    launches the Hopper kernel (``csrc/sel_fwd.cu``); a CPU input runs the
    plain version."""
    _forward_only(pall)
    if pall.device.type == "cpu":
        return sel_fwd_reference(wstart, anchors, mc, pall, n_cols, tile, win)
    if pall.device.type != "cuda":
        raise ValueError(f"sel_fwd: unsupported device {pall.device}")
    cap, width = pall.shape
    c_run = width // (n_cols + 1)
    if width != (n_cols + 1) * c_run or c_run % 8:
        raise ValueError(f"sel_fwd: P width {width} is not {n_cols + 1} "
                         "blocks of a multiple of 8 channels")
    if tile <= 0 or cap % tile or win > cap:
        raise ValueError(f"sel_fwd: cap {cap}, tile {tile}, win {win}")
    dev = pall.device
    _check(pall, "pall", torch.bfloat16, device=dev)
    _check(anchors, "anchors", torch.int32, (n_cols, cap), dev)
    _check(wstart, "wstart", torch.int32, (cap // tile * n_cols,), dev)
    _check(mc, "mc", torch.uint8, (cap,), dev)
    out = torch.empty((cap, c_run), dtype=torch.float32, device=dev)
    fn = cuda_kernels.function("sel_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(wstart.data_ptr(), anchors.data_ptr(), mc.data_ptr(),
                pall.data_ptr(), out.data_ptr(), cap, n_cols, c_run, tile,
                win, stream)
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


def _csum_chunk(tile: int, c_run: int) -> int:
    """Channels per csum block: all of c_run when the (tile, c_run) f32
    accumulator fits the budget, else the largest multiple of 32 that
    does."""
    fit = max(32, CSUM_SMEM_BUDGET // (tile * 4) // 32 * 32)
    return min(c_run, fit)


def csum(wstart, parent_g, pall, cap_out, tile, win, n_groups):
    """Windowed child sum; contract as ``csum_reference``. A CUDA input
    launches the Hopper kernel (``csrc/csum.cu``); a CPU input runs the
    plain version."""
    _forward_only(pall)
    if pall.device.type == "cpu":
        return csum_reference(wstart, parent_g, pall, cap_out, tile, win,
                              n_groups)
    if pall.device.type != "cuda":
        raise ValueError(f"csum: unsupported device {pall.device}")
    cap_in, c_run = pall.shape
    if tile <= 0 or cap_out % tile or win > cap_in:
        raise ValueError(f"csum: cap_in {cap_in}, cap_out {cap_out}, "
                         f"tile {tile}, win {win}")
    dev = pall.device
    _check(pall, "pall", torch.bfloat16, device=dev)
    _check(parent_g, "parent_g", torch.int32, (n_groups, cap_in), dev)
    _check(wstart, "wstart", torch.int32, (cap_out // tile * n_groups,), dev)
    chunk = _csum_chunk(tile, c_run)
    smem = tile * chunk * 4
    out = torch.empty((cap_out, c_run), dtype=torch.float32, device=dev)
    fn = cuda_kernels.function("csum")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(wstart.data_ptr(), parent_g.data_ptr(), pall.data_ptr(),
                out.data_ptr(), cap_in, cap_out, c_run, tile, win, n_groups,
                chunk, smem, stream)
    if rc != 0:
        raise RuntimeError(f"csum kernel launch failed: CUDA error {rc}")
    launch_counts["csum"] += 1
    return out


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


def onehot_window_conv(x, w, msmap, bias=None):
    """Apply a stride-1 k3 conv through a window-annotated MaskedShiftMap:
    bf16 projection, selector kernel, f32 accumulation.

    Returns None when the map has no window annotation (or its shapes do
    not divide); the caller then takes the f32 masked-shift gather."""
    tile, win = int(msmap.tile), int(msmap.win)
    if tile <= 0 or msmap.wstart.numel() == 0 or msmap.inv_wstart.numel() == 0:
        return None
    cap = x.shape[0]
    if cap % tile or cap < win:
        return None
    # 16-byte vector loads in the kernel take 8 bf16 channels at a time:
    # pad the output channels to a multiple of 8 and slice back
    c_out = w.shape[2]
    c_pad = (-c_out) % 8
    wp = torch.nn.functional.pad(w, (0, c_pad)) if c_pad else w
    out = _oh_fwd_impl(
        x, wp, msmap.mp, msmap.mn, msmap.mc, _abs_anchors(msmap.anchors),
        msmap.wstart, msmap.ov_in, msmap.ov_out, msmap.ov_off,
        tuple(msmap.cols), tile, win).to(x.dtype)
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


def child_sum_conv(x, w, csmap, bias=None):
    """Apply a strided (down) conv through a ChildSumMap: the windowed
    child-sum kernel when the map carries a (tile, win) annotation, the
    exact f32 scatter form otherwise."""
    tile, win, n_groups = _cs_window(csmap, x.shape[0])
    cap_out = csmap.out_capacity
    parent = _abs_parent(csmap)
    if tile:
        out = _cs_fwd_impl(x, w, csmap.wstart, parent, csmap.kslot,
                           csmap.ov_in, csmap.ov_out, csmap.ov_off, cap_out,
                           tile, win, n_groups)
    else:
        out = _cs_scatter_impl(x, w, parent, csmap.kslot, cap_out)
    out = out.to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


def transpose_child_sum_conv(x, w, csmap, bias=None):
    """Apply a k2s2 transpose (up) conv through the companion DOWN map's
    ChildSumMap: out_fine[o] = x_coarse[parent[o]] @ W[kslot[o]]. The up
    map's offsets are the down map's negated in the same order, so the slot
    order matches. x: (coarse cap, Cin); returns (in_capacity, Cout)."""
    parent = _abs_parent(csmap)
    pclip = torch.clamp(parent, 0, x.shape[0] - 1)
    out = _parent_fwd_impl(x, w, pclip, csmap.kslot)
    if bias is not None:
        out = out + bias
    return out
