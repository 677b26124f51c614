"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a Hopper GPU (capability 9.0; the kernels are
built for sm_90a) they skip (a CUDA kernel has no CPU mode). This file imports neither jax nor the JAX package, so it also runs on
a GPU machine without them; tests/conftest.py imports jax, hence:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Inputs are the graphs of tests/test_torch_kernels.py built by the port's own
builder; tolerance 1e-5 of max |ref| (same bf16 values summed in f32, only
the order differs), and a second launch of csum or dw bit-equal to the
first. The one-hot ablation kernels take their microbenchmarks' seeded
inputs at small and odd sizes, with the same 1e-5 except the
variants kernel's full mode, which rounds each column's product to bf16
(1e-2). The autograd test compares a conv's gradients on the
card with the CPU's plain path: both run bf16 projection GEMMs, whose bf16
rounding of P may differ by one unit between the two backends, so it holds
them to 1e-2 of max |ref|. The instance segmentation tests hold
InstanceRes16UNet14A's eval forward and one train step on the card to the
CPU's, and the point and cluster ops to the CPU's bit for bit; the zoo
tests hold a narrowed Res16UNet50, MinkUNetHyper14INBN and a CRF-wrapped
Res16UNet14A the same way, and the kernels at the widths Res16UNet50 adds.
A traced train step shows one ``lgs.kernel.*`` span per launch, whose
images on the device's timeline the benchmark's trace reader does not keep
as device operations. The batch norm's kernels (``ops/batch_norm.py``) are
held to their plain versions computed in float64 at the 34C step's level-0
and level-4 shapes, f32 and bf16: sums and f32 outputs to 1e-5 of their
scale (f32 sums over up to 2.4M rows in another order), bf16 outputs to one
bf16 unit; a second launch bit-equal; one 34C train step takes 62 x 6 of
their launches; and SyncBN on two gloo ranks of one card equals the eager
norm on the same card. The contrastive loss's two kernels
(``ops/contrastive.py``) are held to their plain versions computed in
float64 at the 34D pretraining cell's level-0 shape and at (13,312, 100),
f32 and bf16 features, to 1e-5 of each quantity's scale (a bf16 df to one
bf16 unit), a second launch bit-equal; a 34D representation step launches
each once; and a 34D pretraining step at batch 8 through the node agrees
with the same step through the eager loss on the card within the
benchmark cell's ``loss_gap`` limit and res16unet34c's ``grad_gap``. The
masked-shift table's kernel (``ops/shift_table.py``) is held bit for bit
to its plain version (the eager expression it replaces) at the cells'
level-0 shapes and small and odd ones, with negatives, signed zeros,
subnormals, infinities and NaNs (NaN where the plain version has NaN) and
every mask pattern, the wraparound rows unmasked; a second launch
bit-equal; a 34C train step launches it once for each selector conv's
forward, dX and dW, and gives the same loss and gradients as the step
with the table forced onto its eager path.
"""

import collections
import copy
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from languagegroundedsemseg_torch.ops import batch_norm as bno
from languagegroundedsemseg_torch.ops import onehot_ablation as oa
from languagegroundedsemseg_torch.ops import onehot_conv as oc
from languagegroundedsemseg_torch.ops import shift_table as sto
from languagegroundedsemseg_torch.sparse import graph_host as gh
from languagegroundedsemseg_torch.sparse.offsets import ConvKind
from oracles import make_cloud

RTOL = 1e-5
CARD_VS_CPU_RTOL = 1e-2
VARIANTS_FULL_RTOL = 1e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper GPU: the kernels are built for sm_90a")
    return torch.device("cuda")


def _graph(seed, n, caps, down):
    rng = np.random.default_rng(seed)
    coords = make_cloud(rng, n=n, extent=40)
    coords = coords[np.argsort(gh.pack_keys(coords), kind="stable")]
    maps = {"k3": gh.MapSpec(0, 0, ConvKind(3), fuse_width=3)}
    if down:
        maps["down0"] = gh.MapSpec(0, 1, ConvKind(kernel_size=2, stride=2))
    g = gh.build_graph(coords, gh.GraphSpec(len(caps), maps), caps,
                       drop_redundant=False)
    return rng, g


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _sel_check(args):
    """One sel_fwd launch equal to its plain version bit for bit (the same
    adds in the same order), and a second launch equal to the first."""
    n0 = oc.launch_counts["sel_fwd"]
    got = oc.sel_fwd(*args)
    torch.cuda.synchronize()
    assert oc.launch_counts["sel_fwd"] == n0 + 1
    assert torch.equal(got, oc.sel_fwd_reference(*args))
    assert torch.equal(oc.sel_fwd(*args), got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("c_run", [96, 32, 8, 384, 256])
def test_sel_fwd_kernel_matches_plain_version(c_run):
    """A 4,096-row k3 map as the builder makes it, with 10% of the anchors
    scrambled (the guard cap included) so the window test decides."""
    dev = _card()
    rng, g = _graph(4, 3000, (4096,), down=False)
    m = g.gmaps["k3"].to(dev)
    assert m.tile > 0
    pall = torch.from_numpy(rng.normal(size=(4096, 9 * c_run)).astype(
        np.float32)).to(dev, torch.bfloat16)
    anchors = m.anchors.clone()
    pick = torch.from_numpy(rng.random(tuple(anchors.shape)) < 0.1).to(dev)
    anchors[pick] = torch.randint(0, 4097, (int(pick.sum()),), device=dev,
                                  dtype=torch.int32)
    _sel_check([m.wstart, anchors, m.mc, pall, 8, m.tile, m.win])


def _sel_synthetic(cap, c_run, tile, win, n_cols, dev, seed):
    """Seeded sel_fwd inputs: window starts anywhere in [0, cap - win],
    anchors within 3 windows of their row, 5% of them anywhere in [-8,
    cap + 8] (negative, guard and past-the-table values included), a
    quarter of the rows with mc = 0."""
    rng = np.random.default_rng(seed)
    ws = rng.integers(0, cap - win + 1, size=(cap // tile) * n_cols)
    a = np.arange(cap)[None, :] + rng.integers(-3 * win, 3 * win + 1,
                                               size=(n_cols, cap))
    wild = rng.random(a.shape) < 0.05
    a = np.where(wild, rng.integers(-8, cap + 9, size=a.shape), a)
    mc = (rng.random(cap) < 0.75).astype(np.uint8)
    pall = rng.normal(size=(cap, (n_cols + 1) * c_run)).astype(np.float32)
    return [torch.from_numpy(ws.astype(np.int32)).to(dev),
            torch.from_numpy(a.astype(np.int32)).to(dev),
            torch.from_numpy(mc).to(dev),
            torch.from_numpy(pall).to(dev, torch.bfloat16), n_cols, tile, win]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,c_run,tile,win,n_cols", [
    (4096, 256, 256, 512, 8), (4096, 128, 256, 512, 8),
    (18432, 384, 256, 512, 8), (1024, 384, 256, 512, 8),
    (8192, 64, 1024, 2048, 8), (16384, 8, 512, 1024, 8),
    (4096, 96, 256, 512, 4), (2048, 40, 512, 1024, 13)])
def test_sel_fwd_kernel_scrambled_synthetic(cap, c_run, tile, win, n_cols):
    """L4's 4,096 rows in 8-row blocks, L3's 18,432 at block5's dX width,
    a cap small enough to split the channels, the window menu's larger
    tiles, and the generic path (column counts other than 8); anchors
    scrambled so the window test, the guard and the bounds check decide."""
    dev = _card()
    args = _sel_synthetic(cap, c_run, tile, win, n_cols, dev, seed=cap + c_run)
    geo = oc.sel_geometry(cap, c_run, tile, win, n_cols)
    if cap >= 4096:
        assert geo["blocks"] >= oc.SEL_MIN_BLOCKS
    got = _sel_check(args)
    assert got.shape == (cap, c_run)
    assert bool((got[args[2] == 0] == 0).all())
    bad = list(args)
    bad[3] = torch.zeros((cap, (n_cols + 1) * 12), dtype=torch.bfloat16,
                         device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        oc.sel_fwd(*bad)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols,rows,threads", [(8, 256, 256), (8, 64, 256),
                                                 (8, 8, 256), (8, 8, 128),
                                                 (4, 16, 96)])
def test_sel_config_matches_plan(n_cols, rows, threads):
    """The constants compiled into csrc/sel_fwd.cu are the wrapper's, its
    shared memory at the main path's block sizes is the plan's, and at
    least two blocks share an SM there (SEL_MIN_BLOCKS counts two)."""
    _card()
    cfg = oc.sel_config(n_cols, rows, threads)
    assert cfg["dynamic_smem_bytes"] == oc._sel_smem_bytes(n_cols, rows)
    assert cfg["threads"] == 256 and cfg["smem_limit_bytes"] == 48 * 1024
    assert cfg["blocks_per_sm"] >= max(2, cfg["min_blocks_per_sm"])


def _csum_case(n_groups, c_run, variant, dev):
    """csum inputs on the test graph's L0->L1 down map. ``variant``:
    "map" as built (1 group, or pinned to 2 groups at tile 128 / win 1024);
    "scrambled" with 15% of the group parents moved anywhere in [0,
    cap_out] (other tiles, non-members) and 40 window rows of tile 0 given
    one parent (more than 8 children); "tile512" pinned to tile 512 / win
    2048; "cut" with the last tile's windows running past cap_in and tile
    1's starts moved off a multiple of 4 (scalar head and tail)."""
    rng, g = _graph(7 if n_groups == 1 else 11, 2600, (4096, 2048), down=True)
    pin = {"tile512": (1, 512, 2048)}.get(
        variant, None if n_groups == 1 else (2, 128, 1024))
    m = g.gmaps["down0"] if pin is None else gh._try_child_sum_map(
        g.maps["down0"].idx, 4096, pin_tilewin=pin)
    m = m.to(dev)
    assert m.tile > 0 and m.n_groups == n_groups
    assert m.tile == (512 if variant == "tile512" else 128)
    pg = oc._parent_groups(oc._abs_parent(m), m.kslot, m.num_slots,
                           n_groups, m.out_capacity)
    ws = m.wstart.clone()
    cap_in, cap_out, win = 4096, m.out_capacity, m.win
    if variant == "scrambled":
        pick = rng.random(tuple(pg.shape)) < 0.15
        vals = rng.integers(0, cap_out + 1, size=tuple(pg.shape))
        pgn = np.where(pick, vals, pg.cpu().numpy())
        for gi in range(n_groups):
            w0 = int(ws[gi])
            pgn[gi, w0 + 16:w0 + 56] = 5
        pg = torch.from_numpy(pgn.astype(np.int32)).to(dev)
    elif variant == "cut":
        n_tiles = cap_out // m.tile
        ws = ws.reshape(n_tiles, n_groups)
        ws[-1] = cap_in - win // 2
        ws[1] = ws[1] + 1
        ws = ws.reshape(-1).contiguous()
    pall = torch.from_numpy(rng.normal(size=(cap_in, c_run)).astype(
        np.float32)).to(dev, torch.bfloat16)
    return [ws, pg, pall, cap_out, m.tile, win, n_groups]


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups,c_run,variant", [
    (1, 32, "map"), (2, 32, "map"), (2, 256, "map"), (1, 8, "map"),
    (2, 96, "map"), (1, 128, "map"), (2, 32, "scrambled"),
    (2, 128, "scrambled"), (1, 96, "tile512"), (1, 256, "tile512"),
    (2, 64, "cut"), (1, 8, "cut")])
def test_csum_kernel_matches_plain_version(n_groups, c_run, variant):
    """One launch against the plain version, a second launch bit-equal to
    the first (a fixed sum order, no atomics), and the wrapper raising on
    a width its 16-byte row loads cannot take."""
    dev = _card()
    args = _csum_case(n_groups, c_run, variant, dev)
    n0 = oc.launch_counts["csum"]
    got = oc.csum(*args)
    torch.cuda.synchronize()
    assert oc.launch_counts["csum"] == n0 + 1
    assert got.shape == (args[3], c_run)
    want = oc.csum_reference(*args)
    assert _rel(got, want) <= RTOL
    assert torch.equal(oc.csum(*args), got)
    if variant == "scrambled":
        # the 40-child parent of tile 0 is summed whole
        assert float(want[5].abs().max()) > 0
    bad = list(args)
    bad[2] = torch.zeros((args[2].shape[0], 12), dtype=torch.bfloat16,
                         device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        oc.csum(*bad)
    assert oc.launch_counts["csum"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("tile,entries", [(128, 4096), (128, 2048),
                                          (256, 2048), (128, 1024),
                                          (512, 8192)])
def test_csum_config_matches_plan(tile, entries):
    """The constants compiled into csrc/csum.cu are the wrapper's, its
    shared memory at the main path's windows and the menu's largest is the
    plan's, and at least two blocks share an SM there."""
    _card()
    cfg = oc.csum_config(tile, entries)
    geo = oc.csum_geometry(589824, 2048 * tile, 256, tile, entries, 1)
    assert cfg["dynamic_smem_bytes"] == geo["smem_bytes"]
    assert cfg["threads"] == geo["threads"]
    assert cfg["hit_capacity"] == geo["hit_capacity"] >= entries
    assert cfg["blocks_per_sm"] >= 2


def _dw_check(args, cw, c_out):
    """One dw launch against its plain version, and a second launch
    bit-equal to the first (no atomics: the same sum order)."""
    n0 = oc.launch_counts["dw"]
    got = oc.dw_fused(*args)
    torch.cuda.synchronize()
    assert oc.launch_counts["dw"] == n0 + 1
    assert got.shape == (args[1].shape[0], cw, c_out)
    assert _rel(got, oc.dw_fused_reference(*args)) <= RTOL
    assert torch.equal(oc.dw_fused(*args), got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cw,c_out", [(9, 32), (96, 32), (288, 96),
                                      (384, 96), (576, 128), (1152, 256)])
def test_dw_kernel_matches_plain_version(cw, c_out):
    """3C from conv0's 9 (padded to 16 columns by the wrapper) to block5's
    1152; 10% of the inverse anchors scrambled so the window test
    decides."""
    dev = _card()
    rng, g = _graph(4, 3000, (4096,), down=False)
    m = g.gmaps["k3"].to(dev)
    assert m.tile > 0 and m.inv_anchors.shape[1] == 4096
    inv = m.inv_anchors.clone()
    pick = torch.from_numpy(rng.random(tuple(inv.shape)) < 0.1).to(dev)
    inv[pick] = torch.randint(0, 4097, (int(pick.sum()),), device=dev,
                              dtype=torch.int32)
    t3b = torch.from_numpy(rng.normal(size=(4096, cw)).astype(
        np.float32)).to(dev, torch.bfloat16)
    gb = torch.from_numpy(rng.normal(size=(4096, c_out)).astype(
        np.float32)).to(dev, torch.bfloat16)
    _dw_check([m.inv_wstart, inv, t3b, gb, m.tile, m.win], cw, c_out)


def _dw_synthetic(cap, cw, c_out, dev, seed, spread):
    """Seeded dw inputs at tile 256 / window 512: window starts anywhere,
    inverse anchors within ``spread`` rows of their row (the guard cap
    where that leaves the table)."""
    rng = np.random.default_rng(seed)
    tile, win, n_cols = 256, 512, 8
    ws = rng.integers(0, cap - win + 1, size=(cap // tile) * n_cols) // 8 * 8
    inv = np.arange(cap)[None, :] + rng.integers(-spread, spread + 1,
                                                 size=(n_cols, cap))
    inv = np.where((inv < 0) | (inv >= cap), cap, inv)
    t3b = rng.normal(size=(cap, cw)).astype(np.float32)
    gb = rng.normal(size=(cap, c_out)).astype(np.float32)
    return [torch.from_numpy(ws.astype(np.int32)).to(dev),
            torch.from_numpy(inv.astype(np.int32)).to(dev),
            torch.from_numpy(t3b).to(dev, torch.bfloat16),
            torch.from_numpy(gb).to(dev, torch.bfloat16), tile, win]


@pytest.mark.cuda
@pytest.mark.parametrize("cw,c_out", [(9, 32), (288, 96)])
def test_dw_kernel_ragged_last_split(cw, c_out):
    """A cap (23 tiles) that is not a multiple of the rows per split: the
    last split ends inside a chunk."""
    dev = _card()
    cap = 5888
    geo = oc.dw_geometry(cap, cw, c_out, 8)
    assert cap % geo["rows_per_split"] and cap % oc._DW_BK == 0
    args = _dw_synthetic(cap, cw, c_out, dev, seed=cw, spread=400)
    _dw_check(args, cw, c_out)


# (3C, c_out) of the variants' widest and odd convs: 14D / 18D block5's
# first conv (384 + 128 inputs) and its second; 34C200 block8's two convs;
# 34C100 block8's, whose 100 outputs onehot_window_conv pads to 104 and
# whose T3 widths (396, 300) _dw_pad_cols pads to multiples of 8; 34D's
# block8 (512 + 32 inputs, 512 outputs) and block7 (256 + 64, 256)
VARIANT_DW_SHAPES = [(1536, 384), (1152, 384), (696, 200), (600, 200),
                     (396, 104), (300, 104), (1632, 512), (1536, 512),
                     (960, 256), (768, 256)]
# sel_fwd widths the variants add: 34C100's forward (104) and block8 dX
# (132 -> 136), 34C200's forward (200) and block8 dX (232), 34D's block8
# forward (512) and dX (544)
VARIANT_SEL_WIDTHS = [104, 136, 200, 232, 512, 544]


@pytest.mark.cuda
@pytest.mark.parametrize("cw,c_out", VARIANT_DW_SHAPES)
def test_dw_kernel_at_the_variants_widths(cw, c_out):
    """dw at the Res16UNet variants' widths on the 4,096-row builder map,
    10% of the inverse anchors scrambled, held to its plain version."""
    test_dw_kernel_matches_plain_version(cw, c_out)


@pytest.mark.cuda
@pytest.mark.parametrize("c_run", VARIANT_SEL_WIDTHS)
def test_sel_fwd_kernel_at_the_variants_widths(c_run):
    """sel_fwd at the widths the variants add, bit for bit, on the builder
    map and on seeded L0-sized inputs (18,432 rows)."""
    test_sel_fwd_kernel_matches_plain_version(c_run)
    _sel_check(_sel_synthetic(18432, c_run, 256, 512, 8, _card(), seed=c_run))


# the widths the rest of the zoo adds: Res16UNet50's bottleneck k3 convs at
# L2 / L3 (its L0 / L4 (768, 256) is a variant shape above) and its csum
# widths (the down convs' 512 input channels, the up convs' dX at 1024)
ZOO_DW_SHAPES = [(192, 64), (384, 128)]
ZOO_SEL_WIDTHS = [64, 128]
ZOO_CSUM_CASES = [(1, 512), (2, 512), (1, 1024), (2, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("cw,c_out", ZOO_DW_SHAPES)
def test_dw_kernel_at_the_zoo_widths(cw, c_out):
    test_dw_kernel_matches_plain_version(cw, c_out)


@pytest.mark.cuda
@pytest.mark.parametrize("c_run", ZOO_SEL_WIDTHS)
def test_sel_fwd_kernel_at_the_zoo_widths(c_run):
    test_sel_fwd_kernel_at_the_variants_widths(c_run)


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups,c_run", ZOO_CSUM_CASES)
def test_csum_kernel_at_the_zoo_widths(n_groups, c_run):
    test_csum_kernel_matches_plain_version(n_groups, c_run, "map")


@pytest.mark.cuda
def test_dw_kernel_all_out_of_window_gives_zeros():
    """Every inverse anchor outside its window (starts at the far end of
    the table, anchors near their row or the guard): dW is exactly 0."""
    dev = _card()
    cap, cw, c_out = 4096, 288, 96
    args = _dw_synthetic(cap, cw, c_out, dev, seed=1, spread=100)
    args[0] = torch.full_like(args[0], cap - 512)
    args[1] = torch.where(args[1] < cap - 512 - 1, args[1],
                          torch.full_like(args[1], cap))
    got = oc.dw_fused(*args)
    torch.cuda.synchronize()
    assert got.shape == (8, cw, c_out)
    assert bool((got == 0).all())


@pytest.mark.cuda
def test_dw_config_matches_wrapper_and_fits_two_blocks():
    """The tile compiled into csrc/dw.cu is the wrapper's, and two blocks
    share an SM (the waves _dw_splits sizes the grid to)."""
    _card()
    cfg = oc.dw_config()
    assert cfg["blocks_per_sm"] * 132 == oc.DW_RESIDENT_BLOCKS
    assert cfg["dynamic_smem_bytes"] > 48 * 1024


@pytest.mark.cuda
def test_dw_ablation_modes_launch_and_full_is_the_kernel():
    """Every ablation mode launches at a ragged cap; "full" is dw_fused bit
    for bit, no_sel on an identity tiling (every row its own anchor, in
    window) is too, and no mode counts a model launch."""
    dev = _card()
    cap, cw, c_out = 5888, 288, 96
    args = _dw_synthetic(cap, cw, c_out, dev, seed=2, spread=300)
    want = oc.dw_fused(*args)
    n0 = oc.launch_counts["dw"]
    outs = {m: oc.dw_ablation(*args, mode=m) for m in oc.DW_ABLATION_MODES}
    torch.cuda.synchronize()
    assert oc.launch_counts["dw"] == n0
    assert all(o.shape == (8, cw, c_out) for o in outs.values())
    assert torch.equal(outs["full"], want)
    ident = list(args)
    ident[0] = (torch.arange(cap // 256, device=dev, dtype=torch.int32)
                .clamp(max=(cap - 512) // 256) * 256).repeat_interleave(8)
    ident[1] = torch.arange(cap, device=dev,
                            dtype=torch.int32).repeat(8, 1).contiguous()
    assert torch.equal(oc.dw_ablation(*ident, mode="no_sel"),
                       oc.dw_fused(*ident))


def _gemm_check(args):
    """One onehot_gemm launch (prepass and product, one count) against its
    plain version (1e-5 of max |ref|: three exact bf16 products a term,
    summed in f32 in another order) and a second launch bit-equal to the
    first (a fixed sum order)."""
    n, c_out = args[1].shape[0], args[3].shape[1]
    n0 = oa.launch_counts["onehot_gemm"]
    got = oa.onehot_gemm(*args)
    torch.cuda.synchronize()
    assert oa.launch_counts["onehot_gemm"] == n0 + 1
    assert got.shape == (n, c_out)
    assert torch.equal(oa.onehot_gemm(*args), got)
    want = oa.onehot_gemm_reference(*args)
    if not bool(want.any()):
        assert bool((got == 0).all())
        return got
    assert _rel(got, want) <= RTOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile,win,cw,c_out", [
    (4096, 256, 512, 384, 96), (1000, 40, 200, 132, 32),
    (2048, 512, 1024, 64, 16), (1000, 200, 400, 4, 96),
    (4097, 241, 482, 132, 16)])
def test_onehot_gemm_kernel_matches_plain_version(n, tile, win, cw, c_out):
    """Row counts that are not a multiple of the block's 256 rows (1,000;
    4,097 = 17 x 241 tiles, ragged by one row past 16 blocks), a cw ragged
    against the 32-channel step and the 16-deep mma (132, 4); 10% of the
    anchors moved anywhere (negative and past the table included), so the
    window test decides; a bit-equal relaunch."""
    dev = _card()
    a = oa.gemm_inputs(n, tile, win, cw, c_out, 3 * win // 8, seed=n,
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    pick = torch.rand(n, generator=gen, device=dev) < 0.1
    a["anchors"][pick] = torch.randint(-5, n + 5, (int(pick.sum()),),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)
    args = [a["wstart"], a["anchors"], a["t3"], a["w"], tile, win]
    geo = oa.gemm_geometry(n, cw, c_out)
    assert geo["blocks"] * geo["rows_per_block"] >= n
    got = _gemm_check(args)
    # out-of-window rows are exact zeros
    hit, _ = oa._gemm_hits(a["wstart"], a["anchors"], n, tile, win)
    assert not bool(hit.all())
    assert bool((got[~hit] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c_out", oa.KERNEL_C_OUT)
def test_onehot_gemm_all_out_of_window_gives_zeros(c_out):
    """Every window starts past the table, so no anchor is in one: every
    row copy takes the zero-fill form and the output is exactly 0."""
    dev = _card()
    n, tile, win = 2048, 256, 512
    a = oa.gemm_inputs(n, tile, win, 132, c_out, 192, seed=5, device=dev)
    ws = torch.full_like(a["wstart"], n + win)
    got = _gemm_check([ws, a["anchors"], a["t3"], a["w"], tile, win])
    assert bool((got == 0).all())


def _wide_w(cw, c_out, seed):
    """W with exponents spread over 2^-60 .. 2^60 and random signs."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, (cw, c_out))
    exp = rng.integers(-60, 61, (cw, c_out))
    sign = rng.choice([-1.0, 1.0], (cw, c_out))
    return torch.from_numpy((sign * np.ldexp(mant, exp)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("cw,c_out", [(384, 96), (132, 32)])
def test_onehot_gemm_wide_exponent_w(cw, c_out):
    """A W whose exponents span 2^-60 .. 2^60 (the split's three parts
    carry every bit of it), held within 1e-5 of max |ref|."""
    dev = _card()
    n, tile, win = 2048, 256, 512
    a = oa.gemm_inputs(n, tile, win, cw, c_out, 192, seed=cw, device=dev)
    w = _wide_w(cw, c_out, seed=cw).to(dev)
    _gemm_check([a["wstart"], a["anchors"], a["t3"], w, tile, win])


@pytest.mark.cuda
@pytest.mark.parametrize("cw,c_out,wide", [(384, 96, False), (132, 32, True),
                                           (4, 16, True), (100, 96, True)])
def test_onehot_gemm_prepass_matches_plain_split(cw, c_out, wide):
    """The prepass's (3, cw_pad, c_out) parts are bit-equal to
    split_bf16x3 with zero rows past cw, and add back to W exactly."""
    dev = _card()
    if wide:
        w = _wide_w(cw, c_out, seed=cw + 1)
    else:
        w = oa.gemm_inputs(256, 256, 256, cw, c_out, 64, seed=0,
                           device="cpu")["w"]
    got = oa.gemm_split(w.to(dev))
    torch.cuda.synchronize()
    want = oa.gemm_split(w)  # the CPU's plain split, zero-padded
    assert got.shape == (3, oa.gemm_geometry(1, cw, c_out)["cw_pad"], c_out)
    assert torch.equal(got.cpu(), want)
    assert not bool(got[:, cw:].any())
    total = got[:, :cw].cpu().double().sum(0)
    assert torch.equal(total, w.double())


@pytest.mark.cuda
@pytest.mark.parametrize("c_out", oa.KERNEL_C_OUT)
def test_gemm_config_matches_geometry(c_out):
    """The constants compiled into csrc/onehot_gemm.cu are the wrapper's,
    its shared memory is the plan's, and a block fits an SM."""
    _card()
    cfg = oa.gemm_config(c_out)
    geo = oa.gemm_geometry(4096, 384, c_out)
    assert cfg["dynamic_smem_bytes"] == geo["smem_bytes"]
    assert cfg["threads"] == geo["threads"]
    assert cfg["rows_per_block"] == geo["rows_per_block"]
    assert cfg["stages"] == geo["stages"] >= 3
    assert cfg["parts"] == 3
    assert cfg["blocks_per_sm"] >= 1


def _variants_check(mode, args):
    """One onehot_variants launch against its plain version (full: 1e-2 of
    max |ref|; no_sel, no_proj: 1e-5; no_dma exactly zero) and a second
    launch bit-equal to the first (a fixed sum order)."""
    cap, c_out = args[1].shape[1], args[3].shape[2]
    n0 = oa.launch_counts["onehot_variants"]
    got = oa.onehot_variants(mode, *args)
    torch.cuda.synchronize()
    assert oa.launch_counts["onehot_variants"] == n0 + 1
    assert got.shape == (cap, c_out)
    assert torch.equal(oa.onehot_variants(mode, *args), got)
    want = oa.onehot_variants_reference(mode, *args)
    if mode == "no_dma" or not bool(want.any()):
        assert bool((got == 0).all()) and not bool(want.any())
        return got
    assert _rel(got, want) <= (VARIANTS_FULL_RTOL if mode == "full" else RTOL)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("mode", oa.MODES)
@pytest.mark.parametrize("cap,tile,win,cw,c_out", [
    (2048, 256, 384, 128, 32), (1000, 200, 320, 136, 96),
    (3072, 1024, 1536, 384, 96)])
def test_onehot_variants_kernel_matches_plain_version(mode, cap, tile, win,
                                                      cw, c_out):
    """All four modes; a cap that is not a multiple of the block's 256 rows
    and a cw that leaves a ragged 32-channel chunk. full rounds each
    column's product to bf16, which a different sum order can flip by one
    unit: 1e-2 of max |ref| (trouble spot of the contract); the other
    modes sum the same values in f32: 1e-5; no_dma is exactly zero. A
    second launch is bit-equal to the first."""
    dev = _card()
    a = oa.variants_inputs(cap, tile, win, 3, cw, c_out, seed=cap,
                           device=dev)
    _variants_check(mode, [a["wstart"], a["anchors"], a["t3"], a["w"], tile,
                           win, 3])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", oa.MODES)
@pytest.mark.parametrize("cap,tile,win,n_groups,cw,c_out", [
    (2048, 256, 384, 3, 64, 16), (4097, 241, 384, 3, 96, 32),
    (2048, 512, 768, 1, 136, 96), (3072, 512, 768, 5, 128, 96)])
def test_onehot_variants_kernel_other_shapes(mode, cap, tile, win, n_groups,
                                             cw, c_out):
    """c_out 16; a cap ragged by one row past 16 blocks (4,097 = 17 x 241
    tiles); one group (3 columns, each its own anchor row) and five (15
    columns, the last eight sharing anchor row 7); bit-equal relaunch."""
    dev = _card()
    a = oa.variants_inputs(cap, tile, win, n_groups, cw, c_out, seed=cap + cw,
                           device=dev)
    geo = oa.variants_geometry(cap, cw, c_out, 3 * n_groups)
    assert (geo["blocks"] - 1) * geo["rows_per_block"] < cap
    _variants_check(mode, [a["wstart"], a["anchors"], a["t3"], a["w"], tile,
                           win, n_groups])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "no_proj"])
def test_onehot_variants_all_out_of_window_gives_zeros(mode):
    """Every window starts past the table, so no anchor is in one: every
    copy takes the zero-fill form and the output is exactly 0."""
    dev = _card()
    cap, tile, win = 2048, 256, 384
    a = oa.variants_inputs(cap, tile, win, 3, 128, 96, seed=5, device=dev)
    ws = torch.full_like(a["wstart"], cap + win)
    got = _variants_check(mode, [ws, a["anchors"], a["t3"], a["w"], tile, win,
                                 3])
    assert bool((got == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c_out,n_cols", [(96, 9), (96, 15), (32, 9),
                                          (16, 3)])
def test_variants_config_matches_geometry(c_out, n_cols):
    """The constants compiled into csrc/onehot_variants.cu are the
    wrapper's, its shared memory is the plan's, and a block fits an SM."""
    _card()
    cfg = oa.variants_config(c_out, n_cols)
    geo = oa.variants_geometry(4096, 384, c_out, n_cols)
    assert cfg["dynamic_smem_bytes"] == geo["smem_bytes"]
    assert cfg["threads"] == geo["threads"]
    assert cfg["rows_per_block"] == geo["rows_per_block"]
    assert cfg["stages"] == geo["stages"] >= 3
    assert cfg["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_onehot_window_conv_autograd_on_card():
    """One forward and backward of a selector conv on CUDA tensors: two
    sel_fwd launches (forward, dX) and one dw launch, and the card's
    output, dX and dW agree with the CPU's plain path."""
    dev = _card()
    rng, g = _graph(5, 3000, (4096,), down=False)
    m = g.gmaps["k3"]
    assert m.tile > 0
    x = np.zeros((4096, 16), np.float32)
    n = int(g.levels[0].num)
    x[:n] = rng.normal(size=(n, 16))
    w = (rng.normal(size=(27, 16, 20)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(4096, 20)).astype(np.float32)

    def run(device):
        xt = torch.from_numpy(x).to(device).requires_grad_(True)
        wt = torch.from_numpy(w).to(device).requires_grad_(True)
        out = oc.onehot_window_conv(xt, wt, m.to(device))
        (out * torch.from_numpy(ct).to(device)).sum().backward()
        return [t.detach().cpu() for t in (out, xt.grad, wt.grad)]

    before = dict(oc.launch_counts)
    got = run(dev)
    torch.cuda.synchronize()
    assert oc.launch_counts["sel_fwd"] == before["sel_fwd"] + 2
    assert oc.launch_counts["dw"] == before["dw"] + 1
    want = run("cpu")
    for a, b in zip(got, want):
        assert _rel(a, b) <= CARD_VS_CPU_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out", [(132, 100), (232, 200), (544, 512)])
def test_onehot_window_conv_autograd_at_the_variants_widths(c_in, c_out):
    """34C100's, 34C200's and 34D's block8 first conv through the autograd
    Function on the card (widths padded to multiples of 8 and sliced back
    by the wrapper) against the CPU's plain path."""
    dev = _card()
    rng, g = _graph(6, 3000, (4096,), down=False)
    m = g.gmaps["k3"]
    assert m.tile > 0
    x = np.zeros((4096, c_in), np.float32)
    n = int(g.levels[0].num)
    x[:n] = rng.normal(size=(n, c_in))
    w = (rng.normal(size=(27, c_in, c_out)) * 0.05).astype(np.float32)
    ct = rng.normal(size=(4096, c_out)).astype(np.float32)

    def run(device):
        xt = torch.from_numpy(x).to(device).requires_grad_(True)
        wt = torch.from_numpy(w).to(device).requires_grad_(True)
        out = oc.onehot_window_conv(xt, wt, m.to(device))
        (out * torch.from_numpy(ct).to(device)).sum().backward()
        return [t.detach().cpu() for t in (out, xt.grad, wt.grad)]

    got = run(dev)
    torch.cuda.synchronize()
    want = run("cpu")
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel(a, b) <= CARD_VS_CPU_RTOL


@pytest.mark.cuda
def test_loader_batches_on_the_card_equal_the_cpu_loaders():
    """The loader's transfer (pinned host arrays, non_blocking copies on
    its side stream, an event the consumer's stream waits on): a card
    loader and a CPU loader with the same seed and one worker each yield
    equal batches, every tensor of the card's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.data.loader import (
        batch_tensors,
        initialize_data_loader,
    )
    from languagegroundedsemseg_torch.data.synthetic_dataset import (
        SyntheticTiny20Dataset,
    )

    loaders = [initialize_data_loader(
        SyntheticTiny20Dataset, Config(batch_size=2, ignore_label=255),
        "train", 1, True, True, True, 2, 10_000_000, ship_coords=False,
        device=device) for device in ("cuda", "cpu")]
    its = [iter(loader) for loader in loaders]
    try:
        for _ in range(4):
            got, want = next(its[0]), next(its[1])
            pairs = list(zip(batch_tensors(got), batch_tensors(want)))
            assert pairs and len(pairs) == len(list(batch_tensors(want)))
            for g, w in pairs:
                assert g.is_cuda and torch.equal(g.cpu(), w)
    finally:
        for it in its:
            it.close()
    assert loaders[0]._copy_stream is not None


def _insseg_batch(device):
    """One val scene of the synthetic instance dataset (4,000 points, no
    augmentation) at capacity 4,096, with the instance extras."""
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.insseg.dataset import SyntheticInstanceDataset
    from languagegroundedsemseg_torch.insseg.trainer import insseg_extras
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec

    ds = SyntheticInstanceDataset(Config(ignore_label=255), phase="val", augment_data=False)
    item = ds.get_item(0, np.random.default_rng(0))
    builder = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=4096)
    return builder.build([(item["coords"], item["feats"] / 255.0 - 0.5, item["labels"])],
                         [insseg_extras(item)], device=device)


def _insseg_run(model, device, noise_seed=None):
    """(eval offsets, eval probs, confusion counts, step losses) of one
    eval forward and one insseg SGD step; ``noise_seed`` moves the input
    features by 1e-6, relative."""
    from languagegroundedsemseg_torch.insseg.trainer import (
        make_insseg_eval_step,
        make_insseg_objective,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_train_step

    batch = _insseg_batch(device)
    if noise_seed is not None:
        gen = torch.Generator(device=device).manual_seed(noise_seed)
        noise = torch.randn(batch.feats.shape, generator=gen, device=device)
        batch = batch.replace(feats=batch.feats * (1 + 1e-6 * noise))
    offsets, probs, hist = make_insseg_eval_step(model, 20, device=device)(batch)
    opt = sgd_torch(model.parameters(), 0.02)
    _, parts = make_train_step(model, opt, make_insseg_objective(0.02), device=device)(
        TrainState(model, opt), batch)
    valid = batch.graph.levels[0].valid.cpu() > 0
    return (offsets.cpu()[valid], probs.cpu()[valid], hist.cpu(),
            {k: float(v) for k, v in parts.items()})


@pytest.mark.cuda
def test_insseg_forward_and_train_step_on_card_match_cpu():
    """InstanceRes16UNet14A on the card against the CPU's plain path, same
    weights and batch: the eval forward's offsets and probabilities within
    1e-2 relative L2 and its confusion counts' total equal; each loss of
    one train step within 1e-4, or within twice what a 1e-6 relative
    input change (three draws) moves it on the card where that is more:
    batch statistics make the train-mode forward chaotic at random
    weights (PERF.md §6)."""
    from languagegroundedsemseg_torch.insseg.model import InstanceRes16UNet14A

    dev = _card()
    base = InstanceRes16UNet14A(out_channels=20, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    go, gp, gh_, gl = _insseg_run(copy.deepcopy(base).to(dev), dev)
    wo, wp, wh, wl = _insseg_run(copy.deepcopy(base), torch.device("cpu"))
    for got, want in ((go, wo), (gp, wp)):
        assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-2
    assert int(gh_.sum()) == int(wh.sum())
    noisy = [_insseg_run(copy.deepcopy(base).to(dev), dev, s)[3] for s in range(3)]
    for k in ("semantic_loss", "offset_norm_loss", "offset_dir_loss", "loss"):
        noise = max(abs(n[k] - gl[k]) for n in noisy)
        assert abs(gl[k] - wl[k]) <= max(1e-4 * abs(wl[k]), 2 * noise), (k, gl[k], wl[k])


@pytest.mark.cuda
def test_cluster_ops_on_card_equal_cpu():
    """FPS, ball query, radius_graph_device (under TF32) and
    connected_components (a radius graph, and a reversed chain the
    64-sweep cap leaves unconverged) give the CPU's results bit for bit;
    kNN its indices, and its distances within 1e-6."""
    from languagegroundedsemseg_torch.ops import cluster as pc
    from languagegroundedsemseg_torch.ops.points import ball_query, furthest_point_sample, knn

    dev = _card()
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(0, 0.3, (2000, 3)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 3, 2000))
    assert torch.equal(furthest_point_sample(pts.to(dev), 200).cpu(),
                       furthest_point_sample(pts, 200))
    (gd, gi), (wd, wi) = knn(pts[:100].to(dev), pts.to(dev), 8), knn(pts[:100], pts, 8)
    assert torch.equal(gi.cpu(), wi)
    assert float((gd.cpu() - wd).abs().max()) <= 1e-6  # the CPU-vs-JAX bound
    assert torch.equal(ball_query(pts[:100].to(dev), pts.to(dev), 0.05, 16).cpu(),
                       ball_query(pts[:100], pts, 0.05, 16))
    # TF32 on: the squared distances do not go through a matmul
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        table = pc.radius_graph_device(pts.to(dev), lab.to(dev), None, 32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want = pc.radius_graph_device(pts, lab, None, 32)
    assert torch.equal(table.cpu(), want)
    valid = torch.ones(2000, dtype=torch.int32)
    assert torch.equal(pc.connected_components(table, valid.to(dev)).cpu(),
                       pc.connected_components(want, valid))
    perm = np.r_[0, np.arange(399, 0, -1)]
    chain = np.full((400, 2), -1, np.int32)
    chain[perm[1:], 0], chain[perm[:-1], 1] = perm[:-1], perm[1:]
    chain = torch.from_numpy(chain)
    v = torch.ones(400, dtype=torch.int32)
    got = pc.connected_components(chain.to(dev), v.to(dev)).cpu()
    assert torch.equal(got, pc.connected_components(chain, v))
    assert len(torch.unique(got)) > 1
    comp = pc.connected_components(table, valid.to(dev))
    assert torch.equal(pc.component_sizes(comp, valid.to(dev), 2000).cpu(),
                       pc.component_sizes(comp.cpu(), valid, 2000))


def _conditioned(model, seed: int = 1):
    """``model`` with well-conditioned random weights (chip_smoke.py's
    scaled_model): kernels N(0, 0.36 / fan_in), BN scales and running
    variances in [0.6, 1.4], biases and running means 0.1 * N(0, 1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(("running_var", "bn.weight")):
            v = rng.uniform(0.6, 1.4, size=shape)
        elif name.endswith(("bias", "running_mean")):
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) * (0.6 / np.sqrt(np.prod(shape[:-1])))
        sd[name] = torch.tensor(v, dtype=torch.float32)
    model.load_state_dict(sd)
    return model


def _dp_objective(logits, _features, batch, _generator, row_mask):
    from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss

    return cross_entropy_loss(logits, batch.labels, 255, row_mask=row_mask), {}


def _card_dp_rank(rank, _out, bn_data, shards):
    """On one gloo group, both ranks on cuda:0: SyncBN's forward and
    backward, then one two-rank SGD step of a ReLU-free Res16UNet14A with
    conditioned weights, first on the card and then on the CPU."""
    from unittest import mock

    import torch.distributed as dist

    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.models.layers import convert_sync_batchnorm
    from languagegroundedsemseg_torch.models.res16unet import (
        Res16UNet14A,
        res16unet_graph_spec,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_train_step
    from test_torch_parallel import _bn_forward_backward

    group = dist.group.WORLD
    out = {}
    x, mask, cot, scale, bias = bn_data
    base = _conditioned(Res16UNet14A(out_channels=20, device="cpu"))
    for dev in ("cuda:0", "cpu"):
        bn = _bn_forward_backward(x[rank], mask[rank], cot[rank], scale, bias, group,
                                  device=dev)
        batch = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=2048).build(
            shards[rank], device=dev)
        model = copy.deepcopy(base).to(dev)
        convert_sync_batchnorm(model, group)
        opt = sgd_torch(model.parameters(), 0.01)
        launches = sum(oc.launch_counts.values())
        with mock.patch.object(torch, "relu", lambda v: v):
            _, metrics = make_train_step(model, opt, _dp_objective, device=dev,
                                         group=group)(TrainState(model, opt), batch)
        out[dev] = {"bn": {k: v.cpu() for k, v in bn.items()},
                    "loss": float(metrics["loss"]),
                    "launches": sum(oc.launch_counts.values()) - launches,
                    "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
                    "after": {n: t.cpu() for n, t in model.state_dict().items()}}
    return out


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_the_cpu(tmp_path):
    """Two gloo ranks, both on cuda:0 (NCCL refuses two ranks on one
    device): SyncBN within 1e-5 of the same two ranks on the CPU; one
    two-rank train step of a ReLU-free Res16UNet14A (its convs through the
    card's kernels) within chip_smoke.py's train-parity tolerances: loss,
    parameters and BN statistics 1e-4, gradients 1e-2 relative L2. Both
    ranks end with the same parameters."""
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from test_torch_parallel import _bn_data, spawn

    _card()
    cuda_kernels.build()  # once, before the ranks load the libraries
    rng = np.random.default_rng(0)
    shards = [[voxelize_scene(rng, 1500) for _ in range(2)] for _ in range(2)]
    shards = [[(c, f, np.where(lab == 255, 255, lab % 20).astype(np.int32))
               for c, f, lab in s] for s in shards]
    got = spawn(_card_dp_rank, tmp_path, _bn_data(), shards)

    def rel_l2(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    for g in got:
        card, cpu = g["cuda:0"], g["cpu"]
        for name, want in cpu["bn"].items():
            assert _rel(card["bn"][name], want) <= RTOL, name
        assert card["launches"] > 0 and cpu["launches"] == 0
        assert abs(card["loss"] - cpu["loss"]) <= 1e-4 * abs(cpu["loss"])
        names = sorted(cpu["grads"])
        assert rel_l2(torch.cat([card["grads"][n].ravel() for n in names]),
                      torch.cat([cpu["grads"][n].ravel() for n in names])) <= 1e-2
        for stats in (False, True):
            keys = [n for n in sorted(cpu["after"]) if ("running" in n) == stats]
            assert rel_l2(torch.cat([card["after"][n].ravel() for n in keys]),
                          torch.cat([cpu["after"][n].ravel() for n in keys])) <= 1e-4
    for n, t in got[0]["cuda:0"]["after"].items():
        assert torch.equal(t, got[1]["cuda:0"]["after"][n]), n


def _zoo_run(model, device, noise_seed=None):
    """(eval output, loss) of one eval forward and one SGD step (CE, ignore
    label 255) on a 3,000-point scene at capacity 4,096, coords shipped
    (the CRF reads them); ``noise_seed`` moves the input features by 1e-6,
    relative."""
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_eval_step, make_train_step

    scenes = [voxelize_scene(np.random.default_rng(0), 3000)]
    batch = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=4096).build(
        scenes, device=device)
    if noise_seed is not None:
        gen = torch.Generator(device=device).manual_seed(noise_seed)
        noise = torch.randn(batch.feats.shape, generator=gen, device=device)
        batch = batch.replace(feats=batch.feats * (1 + 1e-6 * noise))
    out = make_eval_step(model, device=device)(batch)[0]
    opt = sgd_torch(model.parameters(), 0.01)

    def objective(logits, _f, b, _g, row_mask):
        return cross_entropy_loss(logits, b.labels, 255, row_mask=row_mask), {}

    _, m = make_train_step(model, opt, objective, device=device)(TrainState(model, opt), batch)
    valid = batch.graph.levels[0].mask().cpu() > 0
    return out.cpu()[valid], float(m["loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Res16UNet50", "MinkUNetHyper14INBN", "BilateralCRF"])
def test_zoo_forward_and_train_step_on_card_match_cpu(name):
    """Narrowed Res16UNet50 (bottleneck), MinkUNetHyper14INBN (instance +
    batch norms, the Hyper broadcast) and Res16UNet14A under BilateralCRF
    on the card against the CPU's plain path, same weights and batch, the
    kernels on the card: the eval output within 1e-2 relative L2 and one
    train step's loss within 1e-4. In a model with an instance norm, which
    normalizes by the batch's own statistics in eval mode too, each is
    held instead within twice what a 1e-6 relative input change (three
    draws) moves it on the card where that is more: such a change moves
    MinkUNetHyper14INBN's eval output by ~1e-2 here (PERF.md §6). The
    gaps print, with the CPU's own move under one such change."""
    from languagegroundedsemseg_torch.models import load_model, load_wrapper
    from languagegroundedsemseg_torch.models.layers import SparseInstanceNorm

    dev = _card()
    gen = torch.Generator().manual_seed(0)
    if name == "BilateralCRF":
        base = load_wrapper(name)(load_model("Res16UNet14A")(
            out_channels=20, device="cpu", generator=gen), 20, device="cpu")
    else:
        cls = type(name, (load_model(name),), {"LAYERS": (1,) * len(load_model(name).LAYERS)})
        base = cls(out_channels=20, device="cpu", generator=gen)
    n0 = sum(oc.launch_counts.values())
    got, loss = _zoo_run(copy.deepcopy(base).to(dev), dev)
    assert sum(oc.launch_counts.values()) > n0
    want, want_loss = _zoo_run(copy.deepcopy(base), torch.device("cpu"))
    def rel_l2(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    noisy = [_zoo_run(copy.deepcopy(base).to(dev), dev, s) for s in range(3)]
    out_noise = max(rel_l2(o, got) for o, _ in noisy)
    loss_noise = max(abs(n_loss - loss) for _, n_loss in noisy)
    cpu_out, _ = _zoo_run(copy.deepcopy(base), torch.device("cpu"), 0)
    err = rel_l2(got, want)
    inorm = any(isinstance(m, SparseInstanceNorm) for m in base.modules())
    print(json.dumps({"family": name, "instance_norm": inorm, "eval_rel_l2": err,
                      "loss_rel": abs(loss - want_loss) / abs(want_loss),
                      "card_input_noise_1e-6": out_noise,
                      "cpu_input_noise_1e-6": rel_l2(cpu_out, want)}))
    out_limit = max(CARD_VS_CPU_RTOL, 2 * out_noise) if inorm else CARD_VS_CPU_RTOL
    loss_limit = (max(1e-4 * abs(want_loss), 2 * loss_noise) if inorm
                  else 1e-4 * abs(want_loss))
    assert err <= out_limit, (err, out_noise)
    assert abs(loss - want_loss) <= loss_limit, (loss, want_loss)


def _trace_reader():
    """``benchmark/lgsb/trace.py``, the benchmark's reader of a profile."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "lgsb", "trace.py")
    spec = importlib.util.spec_from_file_location("lgsb_trace", path)
    mod = importlib.util.module_from_spec(spec)
    # its dataclass looks its module up while the class is made
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_kernel_spans_match_launches_and_stay_off_the_device_ops():
    """One Res16UNet14A train step on a 3,000-point scene at capacity
    4,096, traced (CPU and CUDA activity): each kernel's ``lgs.kernel.*``
    host ranges, on whichever thread launched it (the backward's on
    autograd's), number its ``launch_counts`` increments; their images on
    the device's timeline are there, and no device operation that
    ``read_profile`` keeps carries an ``lgs.`` name, so the spans add
    nothing to ``busy_s``."""
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss
    from languagegroundedsemseg_torch.models.res16unet import (
        Res16UNet14A,
        res16unet_graph_spec,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_train_step

    dev = _card()
    batch = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=4096).build(
        [voxelize_scene(np.random.default_rng(0), 3000)], device=dev)
    model = Res16UNet14A(out_channels=20, device=dev,
                         generator=torch.Generator().manual_seed(0))
    opt = sgd_torch(model.parameters(), 0.01)

    def objective(logits, _f, b, _g, row_mask):
        return cross_entropy_loss(logits, b.labels, 255, row_mask=row_mask), {}

    step = make_train_step(model, opt, objective, device=dev)
    state = TrainState(model, opt)
    step(state, batch)  # builds or loads the kernels
    torch.cuda.synchronize()
    before = dict(oc.launch_counts)
    before_bn = dict(bno.launch_counts)
    before_t3 = dict(sto.launch_counts)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("lgs.test.window"):
            step(state, batch)
            torch.cuda.synchronize()
    launched = {k: oc.launch_counts[k] - n for k, n in before.items()}
    launched.update({k: bno.launch_counts[k] - n for k, n in before_bn.items()})
    launched.update({k: sto.launch_counts[k] - n for k, n in before_t3.items()})
    events = list(prof.profiler.kineto_results.events())
    on_host = collections.Counter(
        e.name() for e in events
        if e.device_type() != torch.autograd.DeviceType.CUDA)
    images = collections.Counter(
        e.name() for e in events
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and e.name().startswith("lgs."))
    print(launched, images)  # shown by pytest -rP
    assert launched["sel_fwd"] > 0 and launched["dw"] > 0
    assert launched["bn_stats"] > 0 and launched["bn_bwd_apply"] > 0
    assert launched["t3"] == launched["sel_fwd"] + launched["dw"]
    for k, n in launched.items():
        assert on_host[f"lgs.kernel.{k}"] == n, k
    assert images["lgs.kernel.sel_fwd"] > 0 and images["lgs.kernel.bn_apply"] > 0
    assert images["lgs.kernel.t3"] > 0
    tr = _trace_reader().read_profile(prof, "lgs.test.window")
    assert tr.device and tr.busy_s() > 0
    assert not [n for n, _, _ in tr.device if "lgs." in n]


# ---- the batch norm's kernels ------------------------------------------------

BN_SHAPES = [(2359296, 96), (13312, 256), (13312, 100), (4099, 7)]
BF16_UNIT = 2.0 ** -8


def _bn_inputs(rows, c, dtype, dev, seed=0):
    """x with per-channel offsets and scales, a mask of ~51% valid rows
    spread over the rows (sentinels and padding interleaved), a cotangent
    nonzero on every row, the parameters and running statistics."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.rand(c, device=dev, generator=gen) * 2.5 + 0.5
    shift = torch.randn(c, device=dev, generator=gen)
    x = (torch.randn((rows, c), device=dev, generator=gen) * scale + shift).to(dtype)
    mask = (torch.rand(rows, device=dev, generator=gen) < 0.51).float()
    g = torch.randn((rows, c), device=dev, generator=gen).to(dtype)
    w = torch.rand(c, device=dev, generator=gen) + 0.5
    b = torch.randn(c, device=dev, generator=gen)
    rm = 0.1 * torch.randn(c, device=dev, generator=gen)
    rv = torch.rand(c, device=dev, generator=gen) * 0.8 + 0.6
    return x, mask, g, w, b, rm, rv


def _gap(got, want, scale):
    """Largest gap over the largest scale, in float64."""
    return float((got.double() - want).abs().max() / scale.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", BN_SHAPES)
def test_bn_kernels_match_plain_versions(rows, c, dtype):
    """Each kernel against its plain version in float64 on the same inputs,
    and a second launch bit-equal to the first."""
    dev = _card()
    x, mask, g, w, b, rm, rv = _bn_inputs(rows, c, dtype, dev)
    xd, gd, md = x.double(), g.double(), mask.double()
    n0 = dict(bno.launch_counts)
    packed = bno.bn_stats(x, mask)
    assert bno.launch_counts["bn_stats"] == n0["bn_stats"] + 1
    assert bno.launch_counts["bn_combine"] == n0["bn_combine"] + 1
    want = bno.bn_stats_reference(xd, md)
    assert float(packed[0]) == float(want[0]) == float(mask.sum())
    m = md[:, None]
    assert _gap(packed[1:c + 1], want[1:c + 1], (xd.abs() * m).sum(0)) <= RTOL
    assert _gap(packed[c + 1:], want[c + 1:], want[c + 1:]) <= RTOL
    assert torch.equal(bno.bn_stats(x, mask), packed)

    out_tol = RTOL if dtype == torch.float32 else BF16_UNIT
    for mode in (bno.TRAIN, bno.EVAL):
        rm_k, rv_k, rm_r, rv_r = rm.clone(), rv.clone(), rm.double(), rv.double()
        y, stat = bno.bn_apply(x, packed, w, b, rm_k, rv_k, 1e-5, 0.02, mode, dtype)
        y_r, stat_r = bno.bn_apply_reference(xd, packed.double(), w.double(),
                                             b.double(), rm_r, rv_r, 1e-5, 0.02,
                                             mode, torch.float64)
        assert y.dtype == dtype and _gap(y, y_r, y_r) <= out_tol, mode
        assert _gap(stat, stat_r, stat_r) <= RTOL, mode
        assert _gap(rm_k, rm_r, rm_r) <= RTOL and _gap(rv_k, rv_r, rv_r) <= RTOL
        y2, stat2 = bno.bn_apply(x, packed, w, b, rm.clone(), rv.clone(), 1e-5,
                                 0.02, mode, dtype)
        assert torch.equal(y2, y) and torch.equal(stat2, stat)

    _, stat = bno.bn_apply(x, packed, w, b, rm.clone(), rv.clone(), 1e-5, 0.02,
                           bno.RECOMPUTE, dtype)
    sums = bno.bn_bwd_reduce(g, x, stat)
    sd = stat.double()
    want = bno.bn_bwd_reduce_reference(gd, xd, sd)
    xhat = (xd - sd[:c]) * sd[c:2 * c]
    assert _gap(sums[:c], want[:c], gd.abs().sum(0)) <= RTOL
    assert _gap(sums[c:], want[c:], (gd * xhat).abs().sum(0)) <= RTOL
    assert torch.equal(bno.bn_bwd_reduce(g, x, stat), sums)
    for train in (True, False):
        dx = bno.bn_bwd_apply(g, x, mask, w, stat, sums, train)
        dx_r = bno.bn_bwd_apply_reference(gd, xd, md, w.double(), sd,
                                          sums.double(), train)
        assert dx.dtype == dtype and _gap(dx, dx_r, dx_r) <= out_tol, train
        assert torch.equal(bno.bn_bwd_apply(g, x, mask, w, stat, sums, train), dx)


@pytest.mark.cuda
def test_bn_config_matches_plan():
    _card()
    geo = bno.bn_geometry(2359296, 96)
    cfg = bno.bn_config(geo["threads"])
    assert cfg["stats_blocks_per_sm"] >= 4 and cfg["apply_blocks_per_sm"] >= 4


@pytest.mark.cuda
def test_bn_launches_of_a_34c_train_step():
    """One Res16UNet34C train step on the card: every one of its 62 norms
    takes the six launches of the kernels, and nothing else launches them."""
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss
    from languagegroundedsemseg_torch.models.res16unet import (
        Res16UNet34C,
        res16unet_graph_spec,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_train_step

    dev = _card()
    batch = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=4096).build(
        [voxelize_scene(np.random.default_rng(0), 3000)], device=dev)
    model = Res16UNet34C(out_channels=20, device=dev,
                         generator=torch.Generator().manual_seed(0))
    opt = sgd_torch(model.parameters(), 0.01)

    def objective(logits, _f, b, _g, row_mask):
        return cross_entropy_loss(logits, b.labels, 255, row_mask=row_mask), {}

    step = make_train_step(model, opt, objective, device=dev)
    bno.reset_launch_counts()
    step(TrainState(model, opt), batch)
    torch.cuda.synchronize()
    per = {"bn_stats": 1, "bn_combine": 2, "bn_apply": 1, "bn_bwd_reduce": 1,
           "bn_bwd_apply": 1}
    assert sum(per.values()) == bno.LAUNCHES_PER_TRAIN_NORM
    assert bno.launch_counts == {k: 62 * v for k, v in per.items()}
    assert set(oc.launch_counts) == {"sel_fwd", "csum", "dw"}


def _bn_sync_rank(rank, _out, data):
    """Both ranks on cuda:0, one gloo group: SyncBN through the kernels
    and through the eager ops on the same card."""
    import torch.distributed as dist

    from languagegroundedsemseg_torch.models.layers import SparseBatchNorm

    x, mask, cot, scale, bias = data
    out = {}
    for path in ("kernels", "eager"):
        bn = SparseBatchNorm(x.shape[-1], device="cuda:0",
                             process_group=dist.group.WORLD)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x[rank]).cuda().requires_grad_(True)
        mt = torch.from_numpy(mask[rank]).cuda()
        launches = sum(bno.launch_counts.values())
        y = bn(xt, mt) if path == "kernels" else bn.eager(xt, mt)
        (y * torch.from_numpy(cot[rank]).cuda()).sum().backward()
        torch.cuda.synchronize()
        out[path] = {"y": y.detach().cpu(), "dx": xt.grad.cpu(),
                     "dw": bn.weight.grad.cpu(), "db": bn.bias.grad.cpu(),
                     "mean": bn.running_mean.cpu(), "var": bn.running_var.cpu(),
                     "launches": sum(bno.launch_counts.values()) - launches}
    return out


@pytest.mark.cuda
def test_sync_bn_on_two_ranks_matches_the_eager_norm(tmp_path):
    """Two gloo ranks on cuda:0 whose valid counts differ: the kernels'
    SyncBN (statistics and the backward's sums all-reduced, d(weight) and
    d(bias) each rank's own) against the eager SyncBN on the same card,
    within 1e-5 of each quantity's scale."""
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from test_torch_parallel import _bn_data, spawn

    _card()
    cuda_kernels.build()  # once, before the ranks load the libraries
    got = spawn(_bn_sync_rank, tmp_path, _bn_data(n=300, c=100))
    for g in got:
        assert g["kernels"]["launches"] == bno.LAUNCHES_PER_TRAIN_NORM
        assert g["eager"]["launches"] == 0
        for name, want in g["eager"].items():
            if name != "launches":
                assert _rel(g["kernels"][name], want) <= RTOL, name
    assert not torch.equal(got[0]["kernels"]["dw"], got[1]["kernels"]["dw"])
    assert torch.equal(got[0]["kernels"]["mean"], got[1]["kernels"]["mean"])


# ---- the contrastive loss's kernels -----------------------------------------

CONTRAST_SHAPES = [(800_000, 512), (13_312, 100)]


def _contrast_inputs(rows, dim, dtype, dev, classes=200, samples=3, seed=0):
    """Features leaning toward the label's anchor and the negatives' mean
    direction by random amounts (the negative hinge on both sides of its
    margin), ~10%
    ignored labels, ~35% padding rows, the negatives ``sample_negatives``
    draws, unit anchors, cotangents nonzero on every row."""
    from languagegroundedsemseg_torch.losses.contrastive import sample_negatives

    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((classes, dim), device=dev, generator=gen)
    unit = a / torch.linalg.vector_norm(a, dim=1, keepdim=True)
    labels = torch.randint(0, classes, (rows,), device=dev, generator=gen)
    negatives = sample_negatives(gen, labels, classes, samples)
    neg_dir = unit[negatives].sum(1)
    neg_dir = neg_dir / torch.linalg.vector_norm(neg_dir, dim=1, keepdim=True)
    toward = torch.rand((rows, 2), device=dev, generator=gen) * 1.5
    f = (toward[:, :1] * unit[labels] + toward[:, 1:] * neg_dir
         + 0.3 / dim ** 0.5 * torch.randn((rows, dim), device=dev, generator=gen))
    labels = torch.where(torch.rand(rows, device=dev, generator=gen) < 0.1,
                         torch.full_like(labels, 255), labels).to(torch.int32)
    row_mask = (torch.rand(rows, device=dev, generator=gen) < 0.65).float()
    gp = torch.randn(rows, device=dev, generator=gen)
    gn = torch.randn(rows, device=dev, generator=gen)
    return f.to(dtype), labels, row_mask, negatives, unit, gp, gn


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,dim", CONTRAST_SHAPES)
def test_contrast_kernels_match_plain_versions(rows, dim, dtype):
    """Both kernels against their plain versions in float64 on the same
    inputs (f32 sums over D in another order: 1e-5 of each quantity's
    scale; a bf16 df to one bf16 unit), and a second launch bit-equal."""
    from languagegroundedsemseg_torch.ops import contrastive as ocn

    dev = _card()
    f, labels, row_mask, negatives, unit, gp, gn = _contrast_inputs(rows, dim,
                                                                    dtype, dev)
    n0 = dict(ocn.launch_counts)
    pos, negl, stat = ocn.contrast_fwd(f, labels, row_mask, negatives, unit, 255,
                                       0.0, 0.6)
    assert ocn.launch_counts["contrast_fwd"] == n0["contrast_fwd"] + 1
    fd, ud = f.double(), unit.double()
    pos_r, negl_r, stat_r = ocn.contrast_fwd_reference(fd, labels, row_mask,
                                                       negatives, ud, 255, 0.0, 0.6)
    assert int((negl_r > 0).sum()) > rows // 10 and int((negl_r == 0).sum()) > rows // 10
    assert _gap(pos, pos_r, pos_r) <= RTOL and _gap(negl, negl_r, negl_r) <= RTOL
    for k in range(3):
        assert _gap(stat[:, k], stat_r[:, k], stat_r[:, k]) <= RTOL, k
    again = ocn.contrast_fwd(f, labels, row_mask, negatives, unit, 255, 0.0, 0.6)
    assert all(torch.equal(x, y) for x, y in zip(again, (pos, negl, stat)))

    df = ocn.contrast_bwd(f, labels, negatives, unit, stat, pos, negl, gp, gn)
    assert ocn.launch_counts["contrast_bwd"] == n0["contrast_bwd"] + 1
    df_r = ocn.contrast_bwd_reference(fd, labels, negatives, ud, stat.double(), pos,
                                      negl, gp.double(), gn.double())
    out_tol = RTOL if dtype == torch.float32 else BF16_UNIT
    assert df.dtype == dtype and _gap(df, df_r, df_r) <= out_tol
    assert torch.equal(ocn.contrast_bwd(f, labels, negatives, unit, stat, pos, negl,
                                        gp, gn), df)


@pytest.mark.cuda
def test_contrast_config_matches_plan():
    """The kernels' own launch covers every row count of the step shapes
    once, and an SM holds two blocks or more of each."""
    from languagegroundedsemseg_torch.ops import contrastive as ocn

    _card()
    for rows in (1, 63, 64, 65, 13_312, 800_000, 917_504, 2_359_296, 2_400_000):
        geo = ocn.contrast_geometry(rows, 512, 3, 200)
        per_block = geo["threads"] // 32 * geo["rows_per_warp"]
        assert geo["blocks"] * per_block >= rows > (geo["blocks"] - 1) * per_block
    assert geo["fwd_blocks_per_sm"] >= 2 and geo["bwd_blocks_per_sm"] >= 2


def _34d_step(dev, scenes, monkeypatch, node: bool, seed: int = 0):
    """One Res16UNet34D representation step (200 unit anchors of width 512,
    3 negatives, the contrastive objective) on ``scenes``; ``node`` False
    sends the loss through its eager arithmetic on the card. Returns the
    loss, every leaf's gradient and the node's launches."""
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.losses import contrastive as lcn
    from languagegroundedsemseg_torch.models import load_model
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec
    from languagegroundedsemseg_torch.ops import contrastive as ocn
    from languagegroundedsemseg_torch.train.objectives import (
        make_representation_objective,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_train_step

    monkeypatch.setattr(lcn, "_takes_node", lambda f, d, a: node and f.is_cuda)
    batch = BatchBuilder(spec=res16unet_graph_spec()).build(scenes, device=dev)
    model = load_model("Res16UNet34D")(in_channels=3, out_channels=200, device=dev,
                                       generator=torch.Generator().manual_seed(seed))
    anchors = np.random.default_rng(seed).normal(size=(200, 1, 512))
    anchors /= np.linalg.norm(anchors, axis=-1, keepdims=True)
    cfg = Config(use_embedding_loss="contrastive", embedding_loss_type="contrast",
                 num_negative_samples=3, ignore_label=255)
    objective = make_representation_objective(cfg, anchors.astype(np.float32),
                                               device=dev)
    opt = sgd_torch(model.parameters(), 0.05, momentum=0.9, dampening=0.1,
                    weight_decay=1e-4)
    step = make_train_step(model, opt, objective, representation_only=True,
                           device=dev)
    ocn.reset_launch_counts()
    _, metrics = step(TrainState(model, opt),
                      batch, torch.Generator(device=dev).manual_seed(seed + 1))
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(metrics["loss"]), grads, dict(ocn.launch_counts)


@pytest.mark.cuda
def test_contrast_launches_of_a_34d_representation_step(monkeypatch):
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene

    dev = _card()
    scenes = [voxelize_scene(np.random.default_rng(0), 3000)]
    _, grads, launches = _34d_step(dev, scenes, monkeypatch, node=True)
    assert launches == {"contrast_fwd": 1, "contrast_bwd": 1}
    assert "final.kernel" not in grads  # representation_only: no classifier


@pytest.mark.cuda
def test_34d_pretraining_step_on_the_node_within_the_judges_limits(monkeypatch):
    """One 34D pretraining step at batch 8 (scenes of 30,000 points) through
    the node against the same step through the eager loss on the card: the
    loss within the benchmark cell's ``loss_gap``
    (benchmark/configs/res16unet34d_lg.json) and the median leaf's gradient
    within res16unet34c's ``grad_gap`` (the 34D cell holds none: no fault
    reads far enough above its sound runs), as the judge holds the program
    to the plain reference."""
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene

    dev = _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "res16unet34d_lg.json")) as f:
        limits = json.load(f)["limits"]
    with open(os.path.join(root, "benchmark", "configs", "res16unet34c.json")) as f:
        grad_limit = json.load(f)["limits"]["grad_gap"]
    rng = np.random.default_rng(8)
    scenes = [voxelize_scene(rng, 30_000) for _ in range(8)]
    loss, grads, launches = _34d_step(dev, scenes, monkeypatch, node=True)
    want_loss, want, eager = _34d_step(dev, scenes, monkeypatch, node=False)
    assert launches == {"contrast_fwd": 1, "contrast_bwd": 1}
    assert eager == {"contrast_fwd": 0, "contrast_bwd": 0}
    assert set(grads) == set(want)
    loss_gap = abs(loss - want_loss) / abs(want_loss)
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in want.items()}
    med = float(np.median(list(norms.values())))
    gaps = [abs(float(torch.linalg.vector_norm(grads[n])) - v) / max(v, med)
            for n, v in norms.items()]
    print(json.dumps({"loss_gap": loss_gap, "grad_gap": float(np.median(gaps)),
                      "grad_worst": max(gaps)}))
    assert loss_gap <= limits["loss_gap"]
    assert float(np.median(gaps)) <= grad_limit


# ---- the masked-shift table's kernel -----------------------------------------

# the 34C cell's level 0 (f32 forward and dW at 96), the 34D cell's widest
# level-0 conv (f32, 544 = 512 + 32) and a bf16 configuration's 512-wide one,
# a level-4 width, and the stem's 3 channels on an odd row count
T3_SHAPES = [(2_359_296, 96, torch.float32), (1_048_576, 544, torch.float32),
             (917_504, 512, torch.bfloat16), (13_312, 256, torch.float32),
             (4_099, 3, torch.float32)]
# 60,000-point scenes, 4 a batch: every one of 34C's 47 selector convs has a
# windowed map (93 sel_fwd, 47 dw a train step)
T3_STEP_SCENES, T3_STEP_POINTS = 4, 60_000
T3_SELECTOR_CONVS = 47


def _t3_inputs(rows, c, dtype, dev, seed=0):
    """x of normal values mixed with negatives' and positives' edge cases
    (signed zeros, f32 and bf16 subnormals, +-inf, NaN, ties of the bf16
    rounding, a value that rounds to inf) and masks of all eight (mp, mn,
    mc) patterns, rows 0 and rows - 1 unmasked so that the wraparound
    shows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 4 * torch.randn((rows, c), generator=gen, device=dev)
    special = torch.tensor(
        [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-40, -1e-40,
         1.5e-45, 9.2e-41, -3e-39, 1.00390625, -1.01171875, 3.4028235e38],
        device=dev)
    pick = torch.randint(0, 4 * special.numel(), (rows, c), generator=gen,
                         device=dev)
    x = torch.where(pick < special.numel(),
                    special[pick.clamp(max=special.numel() - 1)], x).to(dtype)
    pattern = torch.randint(0, 8, (rows,), generator=gen, device=dev)
    pattern[0] = pattern[-1] = 7
    masks = [((pattern >> k) & 1).to(torch.uint8) for k in range(3)]
    return x, *masks


def _bits(t):
    """t's bf16 bit patterns, NaNs as 0 (NaN payloads are not the
    contract), and where t is NaN."""
    nan = torch.isnan(t)
    return torch.where(nan, 0, t.view(torch.int16)), nan


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,dtype", T3_SHAPES)
def test_t3_kernel_bit_equal_to_plain_version(rows, c, dtype):
    dev = _card()
    x, mp, mn, mc = _t3_inputs(rows, c, dtype, dev)
    before = sto.launch_counts["t3"]
    got = sto.masked_shift_table_bf16(x, mp, mn, mc)
    want = sto.masked_shift_table_reference(x, mp, mn, mc)
    assert sto.launch_counts["t3"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (rows, 3 * c)
    got_bits, got_nan = _bits(got)
    want_bits, want_nan = _bits(want)
    assert bool(want_nan.any())
    assert torch.equal(got_nan, want_nan)
    assert torch.equal(got_bits, want_bits)
    again = sto.masked_shift_table_bf16(x, mp, mn, mc)
    assert torch.equal(again.view(torch.int16), got.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,dtype", T3_SHAPES)
def test_t3_plan_covers_the_shapes(rows, c, dtype):
    _card()
    geo = sto.t3_geometry(rows, c, dtype)
    assert geo["vec"] == (8 if c % 8 == 0 else 1)
    assert geo["vec"] * geo["vecs"] == c
    items = -(-rows // geo["rows_per_thread"]) * geo["vecs"]
    assert (geo["blocks"] - 1) * geo["threads"] < items <= geo["blocks"] * geo["threads"]
    assert geo["blocks_per_sm"] >= 4


def _34c_t3_step(dev, batch, monkeypatch, kernel: bool):
    """One Res16UNet34C train step on ``batch``; ``kernel`` False sends the
    masked-shift table through its eager expression on the card. Returns
    the loss, every leaf's gradient, and the table's and the selector
    kernels' launches."""
    from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss
    from languagegroundedsemseg_torch.models.res16unet import Res16UNet34C
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_train_step

    monkeypatch.setattr(oc, "masked_shift_table_bf16",
                        sto.masked_shift_table_bf16 if kernel
                        else sto.masked_shift_table_reference)
    model = Res16UNet34C(out_channels=20, device=dev,
                         generator=torch.Generator().manual_seed(0))
    opt = sgd_torch(model.parameters(), 0.01)

    def objective(logits, _f, b, _g, row_mask):
        return cross_entropy_loss(logits, b.labels, 255, row_mask=row_mask), {}

    step = make_train_step(model, opt, objective, device=dev)
    sto.reset_launch_counts()
    oc.reset_launch_counts()
    _, metrics = step(TrainState(model, opt), batch)
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return (float(metrics["loss"]), grads, dict(sto.launch_counts),
            dict(oc.launch_counts))


@pytest.mark.cuda
def test_34c_train_step_on_the_t3_kernel_matches_the_eager_table(monkeypatch):
    """A 34C train step on a batch where all 47 selector convs are
    windowed launches the table's kernel 47 times for the forwards, 46 for
    the dXs (the stem's input gets no gradient) and 47 for the dWs: 140,
    one beside each sel_fwd and dw launch. Its loss and gradients equal
    the same step's with the table on its eager path, as two eager steps
    equal each other: with deterministic algorithms on, ``index_add_``
    takes no atomics, so the gap two eager steps show is 0 and the kernel's
    step has to match bit for bit."""
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec

    dev = _card()
    rng = np.random.default_rng(23)
    batch = BatchBuilder(spec=res16unet_graph_spec()).build(
        [voxelize_scene(rng, T3_STEP_POINTS) for _ in range(T3_STEP_SCENES)],
        device=dev)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = [_34c_t3_step(dev, batch, monkeypatch, kernel)
                for kernel in (False, True, False, True)]
    finally:
        torch.use_deterministic_algorithms(was)
    (e_loss, e_grads, e_t3, e_oc), (k_loss, k_grads, k_t3, k_oc) = runs[:2]
    assert e_t3 == {"t3": 0}
    assert k_oc == e_oc == {"sel_fwd": 2 * T3_SELECTOR_CONVS - 1, "csum": 8,
                            "dw": T3_SELECTOR_CONVS}
    assert k_t3 == {"t3": 3 * T3_SELECTOR_CONVS - 1}
    assert k_t3["t3"] == k_oc["sel_fwd"] + k_oc["dw"]

    def gaps(a, b):
        return [abs(a[0] - b[0])] + [
            float((a[1][n] - b[1][n]).abs().max()) for n in sorted(a[1])]

    eager_gap = max(gaps(runs[0], runs[2]))
    kernel_gaps = gaps(runs[1], runs[0]) + gaps(runs[3], runs[2])
    print(json.dumps({"eager_gap": eager_gap, "kernel_gap": max(kernel_gaps),
                      "loss": k_loss}))
    assert set(k_grads) == set(e_grads)
    assert max(kernel_gaps) <= eager_gap
