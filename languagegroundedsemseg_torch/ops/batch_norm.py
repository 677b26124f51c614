"""The masked batch norm of ``models.layers.SparseBatchNorm`` as one autograd
node on hand-written kernels (``csrc/bn.cu``).

Statistics cover the rows whose mask is nonzero; every row is normalised.
With n = max(sum m, 1), mu = sum m*x / n, var = max(sum m*x^2 / n - mu^2, 0),
r = rsqrt(var + eps) and xhat = (x - mu) * r:

* forward, training: ``bn_stats`` (a statistics kernel writing per-block
  partials of (sum m, sum m*x, sum m*x^2), then a fixed-order combine into
  the packed (2C + 1) vector), under SyncBN an all-reduce of that vector,
  then ``bn_apply``: y = xhat * gamma + beta in the layer's dtype, the
  node's saved statistics, and the running statistics moved (not inside a
  checkpointed block's recompute). Eval: ``bn_apply`` alone on the running
  statistics.
* backward: ``bn_bwd_reduce`` (sum g and sum g*xhat over EVERY row, padding
  included, since a padding row's output depends on mu and var; partials,
  then the combine), under SyncBN the sums all-reduced for dx while
  d(gamma), d(beta) stay the rank's own, then ``bn_bwd_apply``:
  dx = r*gamma * (g - m * (sum g + xhat * keep * sum g*xhat) / n), keep = 0
  where the clamp of var at 0 was active (clamp's gradient). In eval mode
  dx = r*gamma * g.

The node saves x, the mask and a (3C + 1) f32 vector [mu, r, keep, n]:
nothing the size of x but x. x is f32 or bf16, statistics f32, y in the
layer's dtype, dx in x's. Each wrapper launches its kernels for a CUDA
tensor and runs its plain PyTorch version for a CPU one (``*_reference``,
the closed forms above in f32, or f64 for an f64 input); there is no
fallback from one to the other. ``models.layers.SparseBatchNorm`` takes
this node on the card only: on the CPU it runs its eager arithmetic.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from languagegroundedsemseg_torch.ops import cuda_kernels
from languagegroundedsemseg_torch.parallel.collectives import group_size

# Launches of each kernel: a wrapper adds one where it launches its kernel
# on the card and nowhere else. A training norm's forward and backward are
# six launches: stats, combine, apply; bwd_reduce, combine, bwd_apply.
launch_counts = {"bn_stats": 0, "bn_combine": 0, "bn_apply": 0,
                 "bn_bwd_reduce": 0, "bn_bwd_apply": 0}
LAUNCHES_PER_TRAIN_NORM = 6

# The launch plan (csrc/bn.cu, checked against the kernel's own constants
# by ``bn_config``): a thread owns BN_VEC channels, a block at most
# BN_THREADS threads as whole row lanes of at most BN_MAX_VECS channel
# vectors (wider rows split their channels over grid.y); the row blocks aim
# at BN_TARGET_BLOCKS blocks in all (8 of 256 threads an SM of an H100 SXM)
# and give each lane at least BN_MIN_LANE_ROWS rows.
BN_THREADS, BN_VEC, BN_UNROLL = 256, 4, 4
BN_MAX_VECS = 64
BN_TARGET_BLOCKS = 132 * 8
BN_MIN_LANE_ROWS = 8
BN_MAX_CHANNELS = 8192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the modes of ``bn_apply``
EVAL, TRAIN, RECOMPUTE = 0, 1, 2


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=None)
def _bn_plan(rows: int, channels: int, dtype: torch.dtype) -> tuple:
    """(row blocks, rows a block, channel vectors a block, channel splits,
    threads) of every kernel of one norm; raises ValueError for what the
    kernels do not take (not cached). A function of the shape and dtype
    alone: neither split changes a sum's order."""
    if dtype not in _DTYPES:
        raise ValueError(f"batch norm kernels: dtype {dtype} is not f32 or bf16")
    if channels < 1 or channels > BN_MAX_CHANNELS:
        raise ValueError(f"batch norm kernels: {channels} channels, not 1 to "
                         f"{BN_MAX_CHANNELS}")
    if rows < 0 or rows >= 2 ** 31:
        raise ValueError(f"batch norm kernels: {rows} rows, not 0 to 2**31 - 1")
    vecs = -(-channels // BN_VEC)
    splits = -(-vecs // BN_MAX_VECS)
    tx = -(-vecs // splits)
    lanes = BN_THREADS // tx
    blocks = max(1, min(BN_TARGET_BLOCKS // splits,
                        -(-rows // (lanes * BN_MIN_LANE_ROWS))))
    rpb = max(1, -(-rows // blocks))
    return max(1, -(-rows // rpb)), rpb, tx, splits, tx * lanes


def bn_geometry(rows: int, channels: int, dtype=torch.float32) -> dict:
    """The launch of the norm's kernels at these shapes: grid (row blocks,
    channel splits), threads, rows a block, channel vectors a block and row
    lanes. Raises ValueError for a dtype other than f32 / bf16, a width
    outside 1..BN_MAX_CHANNELS, or rows outside 0..2**31 - 1."""
    blocks, rpb, tx, splits, threads = _bn_plan(rows, channels, dtype)
    return {"grid": [blocks, splits], "blocks": blocks * splits,
            "threads": threads, "rows_per_block": rpb, "vecs_per_block": tx,
            "lanes": threads // tx, "splits": splits,
            "rows_per_lane": -(-rpb // (threads // tx))}


def bn_config(threads: int = 240) -> dict:
    """The constants compiled into csrc/bn.cu and the blocks an SM holds of
    the f32 statistics and apply kernels at ``threads`` threads, from the
    card's runtime; raises if they differ from this module's copy. Builds
    and loads the kernels; needs a CUDA device."""
    cfg = (ctypes.c_int * 5)()
    rc = cuda_kernels.function(
        "bn", "lgs_bn_config", [ctypes.c_void_p, ctypes.c_int])(
            ctypes.addressof(cfg), threads)
    if rc != 0:
        raise RuntimeError(f"bn occupancy query failed: CUDA error {rc}")
    keys = ("threads", "vec", "unroll", "stats_blocks_per_sm",
            "apply_blocks_per_sm")
    out = dict(zip(keys, cfg))
    want = {"threads": BN_THREADS, "vec": BN_VEC, "unroll": BN_UNROLL}
    if any(out[k] != v for k, v in want.items()):
        raise RuntimeError(f"csrc/bn.cu constants {out} differ from {want}")
    return out


# ---- plain versions ------------------------------------------------------


def _acc(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def bn_stats_reference(x, mask):
    """Plain version of the statistics kernel and its combine: the packed
    (2C + 1) vector [sum m, sum m*x, sum m*x^2] in f32 (f64 for f64 x)."""
    xf = x.to(_acc(x))
    m = mask.to(xf.dtype)[:, None]
    return torch.cat([m.sum()[None], (xf * m).sum(0), (xf * xf * m).sum(0)])


def bn_apply_reference(x, packed, weight, bias, running_mean, running_var,
                       eps, momentum, mode, out_dtype):
    """Plain version of the apply kernel: (y, stat). TRAIN and RECOMPUTE
    normalise with the statistics of ``packed``; TRAIN also moves the
    running statistics in place; EVAL takes them. stat = [mu, r, keep, n]."""
    acc = _acc(x)
    xf = x.to(acc)
    if mode == EVAL:
        mean, var = running_mean.to(acc), running_var.to(acc)
        n = torch.ones((), dtype=acc, device=x.device)
        keep = torch.zeros_like(mean)
    else:
        c = x.shape[1]
        n = torch.clamp(packed[0].to(acc), min=1.0)
        mean = packed[1:c + 1].to(acc) / n
        raw = packed[c + 1:].to(acc) / n - mean * mean
        var = torch.clamp(raw, min=0.0)
        keep = (raw >= 0).to(acc)
        if mode == TRAIN:
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                running_mean.mul_(1 - momentum).add_(momentum * mean)
                running_var.mul_(1 - momentum).add_(momentum * unbiased)
    r = torch.rsqrt(var + eps)
    y = ((xf - mean) * (r * weight.to(acc)) + bias.to(acc)).to(out_dtype)
    return y, torch.cat([mean, r, keep, n[None]])


def _unpack(stat, c):
    return stat[:c], stat[c:2 * c], stat[2 * c:3 * c], stat[3 * c]


def bn_bwd_reduce_reference(g, x, stat):
    """Plain version of the backward's reduce kernel and its combine:
    [sum g, sum g*xhat] (2C,) over every row."""
    acc = _acc(x)
    mean, r, _, _ = _unpack(stat.to(acc), x.shape[1])
    gf = g.to(acc)
    return torch.cat([gf.sum(0), (gf * ((x.to(acc) - mean) * r)).sum(0)])


def bn_bwd_apply_reference(g, x, mask, weight, stat, sums, train: bool):
    """Plain version of the backward's apply kernel: dx in x's dtype."""
    acc = _acc(x)
    c = x.shape[1]
    mean, r, keep, n = _unpack(stat.to(acc), c)
    s = r * weight.to(acc)
    gf = g.to(acc)
    if not train:
        return (s * gf).to(x.dtype)
    sums = sums.to(acc)
    xhat = (x.to(acc) - mean) * r
    m = mask.to(acc)[:, None]
    t = gf - m * (sums[:c] / n + xhat * (keep * sums[c:] / n))
    return (s * t).to(x.dtype)


# ---- kernel wrappers -----------------------------------------------------


def _operand(t: torch.Tensor, name: str, dev) -> torch.Tensor:
    t = t.contiguous()
    if t.device != dev:
        raise ValueError(f"batch norm: {name} is on {t.device}, expected {dev}")
    if t.data_ptr() % 16:
        t = t.clone()  # an offset view: the vector loads want 16 bytes
    return t


def _f32(t: torch.Tensor, name: str, dev, numel: int) -> torch.Tensor:
    if t.dtype != torch.float32 or t.numel() != numel:
        raise ValueError(f"batch norm: {name} must be {numel} f32 values, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return _operand(t, name, dev)


def _grad(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if g.dtype not in _DTYPES or g.shape != x.shape:
        raise ValueError(f"batch norm: g {g.dtype} {tuple(g.shape)} for x "
                         f"{tuple(x.shape)}: f32 or bf16 of x's shape")
    return _operand(g, "g", x.device)


def _device(t: torch.Tensor, what: str):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device


def _combine(part: torch.Tensor, dev) -> torch.Tensor:
    nb, w = part.shape
    out = torch.empty(w, dtype=torch.float32, device=dev)
    cuda_kernels.launch(
        launch_counts, "bn_combine",
        cuda_kernels.function("bn", "lgs_bn_combine", _COMBINE_ARGS), dev,
        (part.data_ptr(), out.data_ptr(), nb, w))
    return out


_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_COMBINE_ARGS = [_vp, _vp, _i, _i, _vp]
_APPLY_ARGS = [_vp] * 8 + [_i] * 8 + [_f] * 3 + [_i, _vp]
_REDUCE_ARGS = [_vp] * 4 + [_i] * 8 + [_vp]
_BWD_APPLY_ARGS = [_vp] * 7 + [_i] * 9 + [_vp]


def bn_stats(x, mask):
    """The packed (2C + 1) f32 vector [sum m, sum m*x, sum m*x^2] of x
    (rows, C) under mask (rows,). A CUDA input launches the statistics
    kernel and the combine (or raises, see ``bn_geometry``); a CPU input
    runs the plain version."""
    dev = _device(x, "bn_stats")
    if dev.type == "cpu":
        return bn_stats_reference(x, mask)
    rows, c = x.shape
    blocks, rpb, tx, splits, threads = _bn_plan(rows, c, x.dtype)
    x = _operand(x, "x", dev)
    mask = _f32(mask, "mask", dev, rows)
    part = torch.empty((blocks, 2 * c + 1), dtype=torch.float32, device=dev)
    cuda_kernels.launch(
        launch_counts, "bn_stats", cuda_kernels.function("bn"), dev,
        (x.data_ptr(), mask.data_ptr(), part.data_ptr(), rows, c,
         _DTYPES[x.dtype], rpb, tx, splits, threads))
    return _combine(part, dev)


def bn_apply(x, packed, weight, bias, running_mean, running_var, eps,
             momentum, mode, out_dtype):
    """(y, stat): x normalised with the statistics of ``packed`` (TRAIN,
    RECOMPUTE) or the running statistics (EVAL), in ``out_dtype``; TRAIN
    moves the running statistics in place. A CUDA input launches the apply
    kernel; a CPU input runs the plain version."""
    dev = _device(x, "bn_apply")
    if dev.type == "cpu":
        return bn_apply_reference(x, packed, weight, bias, running_mean,
                                  running_var, eps, momentum, mode, out_dtype)
    rows, c = x.shape
    blocks, rpb, tx, splits, threads = _bn_plan(rows, c, x.dtype)
    if out_dtype not in _DTYPES:
        raise ValueError(f"bn_apply: output dtype {out_dtype} is not f32 or bf16")
    x = _operand(x, "x", dev)
    weight, bias = _f32(weight, "weight", dev, c), _f32(bias, "bias", dev, c)
    for t, name in ((running_mean, "running_mean"), (running_var, "running_var")):
        if (t.dtype != torch.float32 or t.numel() != c or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"bn_apply: {name} must be {c} contiguous f32 "
                             f"values on {dev}")
    if mode != EVAL:
        packed = _f32(packed, "packed", dev, 2 * c + 1)
    y = torch.empty((rows, c), dtype=out_dtype, device=dev)
    stat = torch.empty(3 * c + 1, dtype=torch.float32, device=dev)
    cuda_kernels.launch(
        launch_counts, "bn_apply",
        cuda_kernels.function("bn", "lgs_bn_apply", _APPLY_ARGS), dev,
        (x.data_ptr(), y.data_ptr(), 0 if mode == EVAL else packed.data_ptr(),
         running_mean.data_ptr(), running_var.data_ptr(), weight.data_ptr(),
         bias.data_ptr(), stat.data_ptr(), rows, c, _DTYPES[x.dtype],
         _DTYPES[out_dtype], rpb, tx, splits, threads, eps, 1 - momentum,
         momentum, mode))
    return y, stat


def bn_bwd_reduce(g, x, stat):
    """[sum g, sum g*xhat] (2C,) f32 over every row. A CUDA input launches
    the reduce kernel and the combine; a CPU input runs the plain version."""
    dev = _device(x, "bn_bwd_reduce")
    if dev.type == "cpu":
        return bn_bwd_reduce_reference(g, x, stat)
    rows, c = x.shape
    blocks, rpb, tx, splits, threads = _bn_plan(rows, c, x.dtype)
    x, g = _operand(x, "x", dev), _grad(g, x)
    stat = _f32(stat, "stat", dev, 3 * c + 1)
    part = torch.empty((blocks, 2 * c), dtype=torch.float32, device=dev)
    cuda_kernels.launch(
        launch_counts, "bn_bwd_reduce",
        cuda_kernels.function("bn", "lgs_bn_bwd_reduce", _REDUCE_ARGS), dev,
        (g.data_ptr(), x.data_ptr(), stat.data_ptr(), part.data_ptr(), rows,
         c, _DTYPES[x.dtype], _DTYPES[g.dtype], rpb, tx, splits, threads))
    return _combine(part, dev)


def bn_bwd_apply(g, x, mask, weight, stat, sums, train: bool):
    """dx in x's dtype from the combined sums ``sums`` (2C,). A CUDA input
    launches the backward's apply kernel; a CPU input runs the plain
    version."""
    dev = _device(x, "bn_bwd_apply")
    if dev.type == "cpu":
        return bn_bwd_apply_reference(g, x, mask, weight, stat, sums, train)
    rows, c = x.shape
    blocks, rpb, tx, splits, threads = _bn_plan(rows, c, x.dtype)
    x, g = _operand(x, "x", dev), _grad(g, x)
    mask = _f32(mask, "mask", dev, rows)
    weight = _f32(weight, "weight", dev, c)
    stat = _f32(stat, "stat", dev, 3 * c + 1)
    sums = _f32(sums, "sums", dev, 2 * c)
    dx = torch.empty_like(x)
    cuda_kernels.launch(
        launch_counts, "bn_bwd_apply",
        cuda_kernels.function("bn", "lgs_bn_bwd_apply", _BWD_APPLY_ARGS), dev,
        (g.data_ptr(), x.data_ptr(), mask.data_ptr(), weight.data_ptr(),
         stat.data_ptr(), sums.data_ptr(), dx.data_ptr(), rows, c,
         _DTYPES[x.dtype], _DTYPES[g.dtype], rpb, tx, splits, threads,
         int(train)))
    return dx


# ---- the autograd node ---------------------------------------------------


class _SparseBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mask, weight, bias, running, eps, momentum, mode,
                group, out_dtype):
        running_mean, running_var = running
        packed = None
        if mode != EVAL:
            packed = bn_stats(x, mask)
            if group_size(group) > 1:
                dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
        y, stat = bn_apply(x, packed, weight, bias, running_mean, running_var,
                           eps, momentum, mode, out_dtype)
        ctx.save_for_backward(x, mask, weight, stat)
        ctx.train, ctx.group = mode != EVAL, group
        return y

    @staticmethod
    def backward(ctx, g):
        x, mask, weight, stat = ctx.saved_tensors
        c = x.shape[1]
        sums = bn_bwd_reduce(g, x, stat)
        total = sums
        if ctx.train and group_size(ctx.group) > 1:
            # dx reads every rank's rows through the statistics; d(gamma)
            # and d(beta) stay this rank's own, as the eager graph's
            total = sums.clone()
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.group)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = bn_bwd_apply(g, x, mask, weight, stat, total, ctx.train)
        return (dx, None, sums[c:] if ctx.needs_input_grad[2] else None,
                sums[:c] if ctx.needs_input_grad[3] else None,
                None, None, None, None, None, None)


def sparse_batch_norm(x, mask, weight, bias, running_mean, running_var, *,
                      eps: float, momentum: float, mode: int, group=None,
                      out_dtype=torch.float32):
    """The masked batch norm of x (rows, C) under ``mask`` (rows,), any
    dtype, as one autograd node: y in ``out_dtype``; ``mode`` TRAIN (batch statistics, running statistics
    moved), RECOMPUTE (batch statistics, running statistics left) or EVAL
    (running statistics); ``group`` of more than one rank syncs the
    statistics (SyncBN). Kernels on a CUDA input, the plain versions on a
    CPU one."""
    if mode not in (EVAL, TRAIN, RECOMPUTE):
        raise ValueError(f"sparse_batch_norm: unknown mode {mode}")
    return _SparseBatchNorm.apply(x, mask.to(torch.float32), weight, bias,
                                  (running_mean, running_var), eps, momentum,
                                  mode, group, out_dtype)
