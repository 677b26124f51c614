"""The batch norm's kernels (``ops/batch_norm.py``, ``csrc/bn.cu``) on the
CPU: their launch plan, their plain versions against eager autograd, and
the C interface the wrappers declare against the source.

The plain versions are the kernels' arithmetic in closed form (the
backward's dx = r*gamma * (g - m * (sum g + xhat * keep * sum g*xhat) / n)).
In float64 they are held to autograd through ``SparseBatchNorm``'s eager
formula at 1e-10; in float32 and bf16 to the module's own CPU path, which
is that eager formula, at a few units of f32 rounding. The kernels
themselves run on the card only (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from languagegroundedsemseg_torch.models.layers import SparseBatchNorm, recomputing
from languagegroundedsemseg_torch.ops import batch_norm as bn
from languagegroundedsemseg_torch.ops import cuda_kernels
from languagegroundedsemseg_torch.ops import onehot_conv as oc

SRC = Path(cuda_kernels.CSRC_DIR) / "bn.cu"
F64_RTOL = 1e-10
F32_RTOL = 1e-5

# the capacity envelope of the benchmark's res16unet34c cell, levels 0-4
ENVELOPE = (2359296, 655360, 212992, 73728, 13312)
# Res16UNet34C's 62 norms: their widths summed by level, as the model's
# own modules give them (test_34c_norm_widths_by_level)
WIDTHS_34C = {0: 608, 1: 736, 2: 1248, 3: 2752, 4: 3456}
ZOO_WIDTHS = (32, 64, 96, 100, 128, 192, 200, 256, 384, 512, 1024, 1536)


def _eager(x, mask, weight, bias, rm, rv, training, momentum=0.02, eps=1e-5,
           update=True):
    """``SparseBatchNorm``'s eager formula in x's dtype (the module casts
    to f32 first; here float64 keeps autograd exact)."""
    if training:
        m = mask.to(x.dtype)[:, None]
        cnt = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum(0) / cnt
        var = torch.clamp((x * x * m).sum(0) / cnt - mean * mean, min=0.0)
        if update:
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                rm.mul_(1 - momentum).add_(momentum * mean)
                rv.mul_(1 - momentum).add_(momentum * unbiased)
    else:
        mean, var = rm, rv
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


def _case(rows=300, c=12, seed=0, dtype=torch.float64, fill=0.6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, c)) * rng.uniform(0.5, 3, c) + rng.normal(size=c)
    mask = (rng.random(rows) < fill).astype(np.float64)
    g = rng.normal(size=(rows, c))  # nonzero on padding rows too
    w = rng.uniform(0.5, 1.5, c)
    b = rng.normal(size=c)
    rm, rv = 0.1 * rng.normal(size=c), rng.uniform(0.6, 1.4, c)
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return t(x), t(mask), t(g), t(w), t(b), t(rm), t(rv)


def _grads(fn, x, g, w, b):
    x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = fn(x, w, b)
    dx, dw, db = torch.autograd.grad(y, (x, w, b), g.to(y.dtype))
    return y.detach(), dx, dw, db


def _rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-300))


def _both(x, mask, g, w, b, rm, rv, mode):
    """(outputs and gradients, running stats after) of the plain node and
    of eager autograd, each from its own copy of the running stats."""
    rm_p, rv_p, rm_e, rv_e = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    plain = _grads(lambda x_, w_, b_: bn.sparse_batch_norm(
        x_, mask, w_, b_, rm_p, rv_p, eps=1e-5, momentum=0.02, mode=mode,
        out_dtype=x.dtype), x, g, w, b)
    eager = _grads(lambda x_, w_, b_: _eager(
        x_, mask, w_, b_, rm_e, rv_e, mode != bn.EVAL,
        update=mode == bn.TRAIN), x, g, w, b)
    return plain, eager, (rm_p, rv_p), (rm_e, rv_e)


def _assert_close(plain, eager, stats_p, stats_e, rtol):
    for name, p, e in zip(("y", "dx", "dweight", "dbias"), plain, eager):
        assert _rel(p, e) <= rtol, name
    for p, e in zip(stats_p, stats_e):
        assert _rel(p, e) <= rtol


# ---- the launch plan -------------------------------------------------------


def _check_plan(rows, c, dtype):
    geo = bn.bn_geometry(rows, c, dtype)
    blocks, splits = geo["grid"]
    tx, threads, rpb = geo["vecs_per_block"], geo["threads"], geo["rows_per_block"]
    assert threads <= bn.BN_THREADS and threads % tx == 0 and geo["lanes"] >= 4
    assert splits * tx * bn.BN_VEC >= c > (splits - 1) * tx * bn.BN_VEC
    assert tx <= bn.BN_MAX_VECS and splits <= 65535
    assert blocks * rpb >= rows and (blocks - 1) * rpb < max(rows, 1)
    assert blocks * splits <= bn.BN_TARGET_BLOCKS
    return geo


def test_34c_norm_widths_by_level():
    """Res16UNet34C's norms, seen by hooks on a small forward: 62 of them,
    whose widths at each level sum to WIDTHS_34C; the plan takes each at
    the envelope's capacity of its level, in f32 and bf16, and fills the
    card at level 0."""
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.models.res16unet import (
        Res16UNet34C,
        res16unet_graph_spec,
    )

    batch = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=1024).build(
        [voxelize_scene(np.random.default_rng(1), 600)], device="cpu")
    levels = {(lv.capacity, int(lv.mask().sum())): i
              for i, lv in enumerate(batch.graph.levels)}
    assert len(levels) == len(ENVELOPE)
    model = Res16UNet34C(out_channels=20, device="cpu").eval()
    seen = []
    for mod in model.modules():
        if isinstance(mod, SparseBatchNorm):
            mod.register_forward_hook(lambda _m, inp, _o: seen.append(
                (levels[(inp[0].shape[0], int(inp[1].sum()))], inp[0].shape[1])))
    with torch.no_grad():
        model(batch.feats, batch.graph)
    assert len(seen) == 62
    widths = {lvl: sum(c for l, c in seen if l == lvl) for lvl in WIDTHS_34C}
    assert widths == WIDTHS_34C
    for lvl, c in sorted(set(seen)):
        for dtype in (torch.float32, torch.bfloat16):
            geo = _check_plan(ENVELOPE[lvl], c, dtype)
            if lvl == 0:
                assert geo["blocks"] == bn.BN_TARGET_BLOCKS


@pytest.mark.parametrize("c", ZOO_WIDTHS)
@pytest.mark.parametrize("rows", [0, 1, 777, 13312, 73728, 2359296])
def test_plan_covers_the_zoo_widths(rows, c):
    for dtype in (torch.float32, torch.bfloat16):
        _check_plan(rows, c, dtype)


def test_plan_at_the_named_shapes():
    """One wave of BN_TARGET_BLOCKS at 34C's level-0 norm; channel splits
    at 1,536; 25 vectors (no channel tail) at 100."""
    geo = bn.bn_geometry(2359296, 96)
    assert geo["grid"] == [bn.BN_TARGET_BLOCKS, 1] and geo["threads"] == 240
    assert bn.bn_geometry(13312, 1536)["splits"] == 6
    assert bn.bn_geometry(100, 100)["vecs_per_block"] == 25


@pytest.mark.parametrize("rows,c,dtype", [
    (100, 0, torch.float32), (100, bn.BN_MAX_CHANNELS + 1, torch.float32),
    (-1, 32, torch.float32), (2 ** 31, 32, torch.float32),
    (100, 32, torch.float64), (100, 32, torch.float16)])
def test_plan_raises_on_what_the_kernels_do_not_take(rows, c, dtype):
    with pytest.raises(ValueError):
        bn.bn_geometry(rows, c, dtype)


# ---- plain versions against eager autograd, float64 -------------------------


@pytest.mark.parametrize("mode", [bn.TRAIN, bn.RECOMPUTE, bn.EVAL])
@pytest.mark.parametrize("c", [12, 7])
def test_plain_node_matches_eager_autograd(mode, c):
    """Output, dx, d(weight), d(bias) and the running statistics, with a
    nonzero cotangent on the padding rows (their outputs read mu and var)."""
    case = _case(c=c)
    plain, eager, sp, se = _both(*case, mode)
    _assert_close(plain, eager, sp, se, F64_RTOL)
    rm, rv = case[5], case[6]
    moved = not torch.equal(sp[0], rm) and not torch.equal(sp[1], rv)
    assert moved == (mode == bn.TRAIN)


def test_plain_node_with_no_valid_row():
    """An all-padding batch: n clamps to 1, mu = var = 0, and dx = r*gamma*g."""
    x, mask, g, w, b, rm, rv = _case()
    mask = torch.zeros_like(mask)
    plain, eager, sp, se = _both(x, mask, g, w, b, rm, rv, bn.TRAIN)
    _assert_close(plain, eager, sp, se, F64_RTOL)
    assert _rel(plain[1], g * w * 1e-5 ** -0.5) <= F64_RTOL


def _clamp_below_zero(x, mask, j):
    """Fill channel j with a constant whose one-pass variance rounds below 0
    at this mask (so the clamp at 0 is active and its gradient 0)."""
    n = float(mask.sum())
    for v in np.linspace(0.1, 3.3, 200):
        x[:, j] = v
        packed = bn.bn_stats_reference(x, mask)
        mean = packed[1 + j] / n
        if float(packed[1 + x.shape[1] + j] / n - mean * mean) < 0:
            return
    raise AssertionError("no constant rounds below 0")


def test_plain_node_at_the_variance_clamp():
    """Two constant channels on the valid rows: one whose one-pass variance
    is exactly 0 (the clamp passes its gradient) and one where it rounds
    below 0 (the clamp is active: no variance term)."""
    x, mask, g, w, b, rm, rv = _case(c=4)
    x[:, 1] = 2.0
    _clamp_below_zero(x, mask, 3)
    packed = bn.bn_stats_reference(x, mask)
    n = float(mask.sum())
    raw = packed[5:] / n - (packed[1:5] / n) ** 2
    assert float(raw[1]) == 0.0 and float(raw[3]) < 0.0
    _, stat = bn.bn_apply_reference(x, packed, w, b, rm.clone(), rv.clone(),
                                    1e-5, 0.02, bn.TRAIN, torch.float64)
    assert stat[8:12].tolist() == [1.0, 1.0, 1.0, 0.0]
    plain, eager, sp, se = _both(x, mask, g, w, b, rm, rv, bn.TRAIN)
    _assert_close(plain, eager, sp, se, F64_RTOL)


def test_each_plain_kernel_against_its_eager_parts():
    """The plain kernels one by one: the packed sums, the saved statistics,
    the backward's two sums over every row and dx from them."""
    x, mask, g, w, b, rm, rv = _case()
    c = x.shape[1]
    packed = bn.bn_stats_reference(x, mask)
    m = mask[:, None]
    assert _rel(packed, torch.cat([mask.sum()[None], (x * m).sum(0),
                                   (x * x * m).sum(0)])) <= F64_RTOL
    y, stat = bn.bn_apply_reference(x, packed, w, b, rm, rv, 1e-5, 0.02,
                                    bn.RECOMPUTE, torch.float64)
    n = mask.sum()
    mean = (x * m).sum(0) / n
    var = ((x - mean) ** 2 * m).sum(0) / n
    assert _rel(stat[:c], mean) <= F64_RTOL
    assert _rel(stat[c:2 * c], torch.rsqrt(var + 1e-5)) <= 1e-9
    assert float(stat[-1]) == float(n)
    xhat = (x - mean) * torch.rsqrt(var + 1e-5)
    sums = bn.bn_bwd_reduce_reference(g, x, stat)
    assert _rel(sums, torch.cat([g.sum(0), (g * xhat).sum(0)])) <= 1e-9
    dx = bn.bn_bwd_apply_reference(g, x, mask, w, stat, sums, True)
    _, want, _, _ = _grads(lambda x_, w_, b_: _eager(
        x_, mask, w_, b_, rm.clone(), rv.clone(), True), x, g, w, b)
    assert _rel(dx, want) <= F64_RTOL
    assert _rel(bn.bn_bwd_apply_reference(g, x, mask, w, stat, sums, False),
                g * w * stat[c:2 * c]) <= F64_RTOL


# ---- the module on the CPU ---------------------------------------------------


def _module(case, dtype):
    x, mask, g, w, b, rm, rv = (t.float() for t in case)
    mod = SparseBatchNorm(x.shape[1], device="cpu", dtype=dtype)
    with torch.no_grad():
        for p, v in ((mod.weight, w), (mod.bias, b), (mod.running_mean, rm),
                     (mod.running_var, rv)):
            p.copy_(v)
    return mod, x, mask, g


@pytest.mark.parametrize("training", [True, False])
def test_plain_node_matches_the_modules_cpu_path_in_f32(training):
    """The module's CPU forward (its eager arithmetic, f32) against the
    plain node on the same f32 inputs: outputs, gradients and running
    statistics within f32 rounding; and the CPU path launches nothing."""
    mod, x, mask, g = _module(_case(), torch.float32)
    mod.train(training)
    before = dict(bn.launch_counts), dict(oc.launch_counts)
    got = _grads(lambda x_, w_, b_: bn.sparse_batch_norm(
        x_, mask, w_, b_, mod.running_mean.clone(), mod.running_var.clone(),
        eps=mod.eps, momentum=mod.momentum,
        mode=bn.TRAIN if training else bn.EVAL), x, g, mod.weight.detach(),
        mod.bias.detach())
    x_ = x.clone().requires_grad_(True)
    y = mod(x_, mask)
    y.backward(g)
    want = (y.detach(), x_.grad, mod.weight.grad, mod.bias.grad)
    for name, p, e in zip(("y", "dx", "dweight", "dbias"), got, want):
        assert _rel(p, e) <= F32_RTOL, name
    assert (dict(bn.launch_counts), dict(oc.launch_counts)) == before
    assert set(oc.launch_counts) == {"sel_fwd", "csum", "dw"}


def test_recompute_leaves_the_running_statistics():
    """Under ``recomputing()`` the module's batch statistics still
    normalise, and the running statistics stay; the plain node's RECOMPUTE
    mode is the same."""
    mod, x, mask, _ = _module(_case(), torch.float32)
    rm, rv = mod.running_mean.clone(), mod.running_var.clone()
    with recomputing():
        y = mod(x, mask)
    assert torch.equal(mod.running_mean, rm) and torch.equal(mod.running_var, rv)
    y_plain = bn.sparse_batch_norm(x, mask, mod.weight, mod.bias, rm, rv,
                                   eps=mod.eps, momentum=mod.momentum,
                                   mode=bn.RECOMPUTE)
    assert torch.equal(mod.running_mean, rm)
    assert _rel(y_plain.detach(), y.detach()) <= F32_RTOL


def test_plain_node_takes_bf16():
    """A bf16 input (the bf16 compute path): statistics in f32, y and dx in
    bf16, each within one bf16 unit of the module's CPU path."""
    mod, x, mask, g = _module(_case(), torch.bfloat16)
    xb, gb = x.bfloat16(), g.bfloat16()
    got = _grads(lambda x_, w_, b_: bn.sparse_batch_norm(
        x_, mask, w_, b_, mod.running_mean.clone(), mod.running_var.clone(),
        eps=mod.eps, momentum=mod.momentum, mode=bn.TRAIN,
        out_dtype=torch.bfloat16), xb, gb, mod.weight.detach(), mod.bias.detach())
    x_ = xb.clone().requires_grad_(True)
    y = mod(x_, mask)
    y.backward(gb)
    assert got[0].dtype == got[1].dtype == torch.bfloat16 == y.dtype
    assert _rel(got[0], y) <= 2 ** -8 and _rel(got[1], x_.grad) <= 2 ** -7
    for p, e in zip(got[2:], (mod.weight.grad, mod.bias.grad)):
        assert p.dtype == torch.float32 and _rel(p, e) <= 1e-4


def test_unknown_mode_raises():
    x, mask, _, w, b, rm, rv = _case()
    with pytest.raises(ValueError):
        bn.sparse_batch_norm(x, mask, w, b, rm, rv, eps=1e-5, momentum=0.02,
                             mode=3)


# ---- the C interface against the source -------------------------------------


_CTYPE = {"void*": "c_void_p", "int": "c_int", "float": "c_float"}


def _c_params(symbol):
    text = SRC.read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, symbol
    kinds = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        kinds.append("void*" if "*" in p else p.rsplit(" ", 1)[0])
    return [_CTYPE[k] for k in kinds]


@pytest.mark.parametrize("symbol,argtypes", [
    ("lgs_bn_stats", cuda_kernels.KERNELS["bn"][2]),
    ("lgs_bn_combine", bn._COMBINE_ARGS),
    ("lgs_bn_apply", bn._APPLY_ARGS),
    ("lgs_bn_bwd_reduce", bn._REDUCE_ARGS),
    ("lgs_bn_bwd_apply", bn._BWD_APPLY_ARGS)])
def test_declared_argtypes_match_the_c_entry_points(symbol, argtypes):
    assert [t.__name__ for t in argtypes] == _c_params(symbol)


def test_plan_constants_match_the_source():
    text = SRC.read_text()
    for name, want in (("THREADS", bn.BN_THREADS), ("VEC", bn.BN_VEC),
                       ("UNROLL", bn.BN_UNROLL)):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m and int(m.group(1)) == want, name
    for name, want in (("EVAL", bn.EVAL), ("TRAIN", bn.TRAIN),
                       ("RECOMPUTE", bn.RECOMPUTE)):
        assert re.search(rf"\b{name} = {want}\b", text), name
