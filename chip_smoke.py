"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Builds the port's CUDA kernels and native graph builders from the sources in
this checkout and holds each kernel against its plain PyTorch version at the
shapes of the main path (the forward's and the backward's widths), and the
two one-hot ablation kernels at their microbenchmarks' full shapes. Then it
drives Res16UNet34C (200 classes) on a 4-scene synthetic batch through the
entry points a user calls: the eval forward (``make_eval_step``) and the SGD
train step (``make_train_step``), each run with the launch counts set to 0
just before it and checked against the counts the graph and the model
imply. Then it compares the card with the CPU's plain path on a small batch:
the forward's logits, and one train step's loss, gradients, parameters and
BN statistics. Then it drives the production path end to end: the port's
``initialize_data_loader`` (augmented synthetic scenes, two worker threads,
batches copied to the card on the loader's side stream) feeding the SGD
train step, with the launches of every step checked against its batch and
the card loader's batches held equal to a CPU loader's. Then the training
program a user runs: ``cli.main.main`` with the flags of
outputs/learning_curve_r5/config.json, two epochs in the baseline and in
the language-grounded mode and a resume one epoch on, each run's launches
checked against every train step and eval forward it made. Then instance
segmentation as a user runs it: ``cli.main.main`` with the flags of
scripts/train_insseg.sh (InstanceRes16UNet, a 200-class synthetic
stand-in for the Scannet200 instance scenes), 12 steps and the
validation of every val scene, launches checked the same way, one insseg
train step card vs CPU and the device cluster ops against the host. Then
data parallelism: the CLI as rank 0 of a world of one over NCCL against
the baseline run, then two spawned ranks sharing the card over gloo (the
baseline's flags and the insseg flags with ``--num_devices 2``; parameters
bit-equal across ranks, launches checked per rank, the all-reduced
validation against one process's) and one two-rank train step card vs
CPU. Then the rest of the model zoo: ``cli.main.main`` with the same
flags and ``--model Res16UNet50`` (Bottleneck blocks), then with
``--wrapper_type BilateralCRF`` around Res16UNet34C at the size its
brute-force kNN allows (one 10,000-point scene a batch), launches checked
the same way, the CRF's coins and compatibility recorded; and one eval
forward and train step card vs CPU for each family (Res16UNet50,
ResUNet14, MinkUNetHyper14INBN, Res16UNet34Dv3, Res16UNet34CR_Proj, an SE
Res16UNet, ResNet14, STRes16UNet14A on a 4-D cloud). The kernels phase
also holds sel_fwd, dw and csum at the widths Res16UNet50 adds. Then the
classifier stage: ``cli.main.main`` with ``--model ClassifierNet
--classifier_resample_features true`` (no kernel runs), then
``Trainer(mode="classifier")`` on Res16UNet34C (the features are its eval
forwards over both loaders), each writing the classifier's checkpoint and
history; the pooled features and the classifier card vs CPU. Then the
paired SimSiam step: ``build_paired_batch`` over the trainer's dataset,
SGD steps of Res16UNet34DPaired at full width, one step card vs CPU. Then
bf16 compute and per-block recomputation: ``cli.main.main`` with
``--compute_dtype bfloat16`` (Res16UNet34C), ``--model Res16UNet50 --remat
true`` and both, launches counted with the recompute, peak memory beside
Res16UNet50's without remat; the insseg CLI in bf16; each configuration's
logits and step card vs CPU. Each phase prints one JSON line; the last
line is
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero without that line. It needs a CUDA device and imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

from typing import Optional

import numpy as np
import torch

# csum compared with its plain version: both add the same bf16 values in
# f32, only the order of the sum differs. sel_fwd adds them in the plain
# version's order, so it is held bit for bit.
KERNEL_RTOL = 1e-5
# dw against its plain version: the same bf16 products summed in f32 in
# another order, over up to 589,824 rows
DW_RTOL = 1e-4
# the ablation kernels against their plain versions: onehot_gemm and the
# no_sel / no_proj modes sum the same f32 products in another order; the
# full mode rounds each column's product to bf16, which another sum order
# can flip by one bf16 unit
ABLATION_RTOL, VARIANTS_FULL_RTOL = 1e-5, 1e-2
# card vs CPU logits on the small batch: both run bf16 projections; only sum
# order and GEMM rounding differ
PARITY_RTOL = 1e-2
# card vs CPU train step on the small batch: loss; concatenated gradients;
# parameters after the SGD step and BN running statistics
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_STATE_RTOL = 1e-4, 1e-2, 1e-4
# dense peaks of the card model nvidia-smi names (NVIDIA data sheets)
_HBM_BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                    ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM
BF16_TC_OPS_PER_S = 989e12  # bf16 dense tensor cores, H100 SXM
# L2 -> shared-memory fill rate for a gather into a cp.async ring, as the
# dw kernel's loads-only mode measured it on an H100 SXM (PERF.md §6):
# the rate behind onehot_variants' second floor, the rows it gathers
L2_FILL_BYTES_PER_S = 5e12
# onehot_gemm's f32 W times bf16 t3, the fastest exact route on this card:
# W split into three bf16 parts, three bf16 tensor-core products
# (csrc/onehot_gemm.cu), so a third of the bf16 rate
GEMM_ARITHMETIC = "f32 x bf16 as three exact bf16 tensor-core products"
GEMM_OPS_PER_S = BF16_TC_OPS_PER_S / 3

SCENES, POINTS = 4, 180_000          # the bench.py batch
# dw in phase kernels: (3C, c_out, k3 map) of block8's convs and conv0 at
# L0, and of block1's four convs, which run on the L1 map
DW_SHAPES = ((288, 96, "l0.k3"), (9, 32, "l0.k3"), (96, 32, "l1.k3"))
# sel_fwd in phase kernels: (c_run, k3 map) of block8's convs, conv0 and
# block5's dX at L0, and of block4's convs at L4 (4,096 rows)
SEL_SHAPES = ((96, "l0.k3"), (32, "l0.k3"), (384, "l0.k3"), (256, "l4.k3"))
# the rest of the model zoo's new kernel widths (phase kernels, held and
# timed on the main-path batch's maps): Res16UNet50's L0 bottleneck k3
# convs run sel_fwd at 256 channels (forward and dX) and dw at (3 x 256,
# 256); its up convs' dX runs csum at 1024 (every decoder input is 4 x 256)
ZOO_SEL_SHAPES = ((256, "l0.k3"),)
ZOO_DW_SHAPES = ((768, 256, "l0.k3"),)
ZOO_CSUM_WIDTHS = (1024,)
# the batch norm's kernels in phase kernels: Res16UNet34C's level-0 norms at
# the benchmark's capacity envelope (2,359,296 rows, 96 channels), the
# level filled as the resident cell fills it (51%, valid rows first)
BN_ROWS, BN_CHANNELS, BN_FILL = 2_359_296, 96, 0.51
# the contrastive loss's node at the res16unet34d_lg.resident cell's level 0:
# its capacity envelope's rows and fill, the decoder's width (3 negatives, 200
# anchors)
CONTRAST_ROWS, CONTRAST_DIM, CONTRAST_FILL = 917_504, 512, 0.67
# the selector convs' masked-shift table in phase kernels: the widest f32
# level-0 table of each benchmark cell, 34C's (its capacity envelope's rows,
# 96 channels) and 34D's (its largest level-0 capacity, 512 channels)
T3_SHAPES = ((2_359_296, 96), (1_048_576, 512))
PARITY_POINTS, PARITY_CAP = 40_000, 32768
TIMED_KERNEL_RUNS, TIMED_FWD_RUNS, TIMED_TRAIN_STEPS = 20, 5, 5
TRAIN_LR = 0.01  # bench.py:163, sgd_torch(0.01)
# phase e2e_path: bench.py's end-to-end section (bench.py:197-208)
E2E_SCENES, E2E_BATCH, E2E_WORKERS = 8, 4, 2
E2E_WARMUP, E2E_STEPS = 4, 20
TRANSFER_CHECK_BATCHES = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def hbm_bytes_per_s(name: str) -> float:
    for key, bw in _HBM_BYTES_PER_S:
        if key in name:
            return bw
    raise RuntimeError(f"no memory bandwidth on record for {name!r}")


def cuda_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---- phases -------------------------------------------------------------


def set_numerics() -> None:
    """f32 GEMMs in f32 (no TF32, no reduced-precision bf16 sums), in this
    process and in every rank it spawns."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def phase_device() -> dict:
    import scipy  # the data layer's transforms, voxelizer and datasets

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    set_numerics()
    info = {
        "phase": "device", "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "scipy": scipy.__version__,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
    }
    emit(info)
    return info


def phase_build() -> None:
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from languagegroundedsemseg_torch.sparse import graph_fused, graph_native

    t0 = time.perf_counter()
    # one nvcc per kernel source and both g++ builders, all at once
    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = [ex.submit(cuda_kernels.build), ex.submit(graph_native.get_lib),
                ex.submit(graph_fused.get_lib)]
        for f in futs:
            f.result()
    seconds = time.perf_counter() - t0
    if not graph_fused.available():
        raise RuntimeError("the native fused graph builder did not load")
    for name in cuda_kernels.KERNELS:
        cuda_kernels.function(name)  # load now, so no phase below builds
    # each entry function's (mangled) name, then its registers and spills
    ptxas = {n: [l.strip() for l in log.splitlines()
                 if "entry function" in l or "Used" in l or "spill" in l]
             for n, log in cuda_kernels.build_log.items()}
    emit({"phase": "build", "seconds": seconds, "native_fused_builder": True,
          "nvcc_flags": " ".join(cuda_kernels.NVCC_FLAGS), "ptxas": ptxas})


def main_path_scenes(seed: int = 0):
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene

    rng = np.random.default_rng(seed)
    return [voxelize_scene(rng, POINTS, raw_color=True) for _ in range(SCENES)]


def seeded_model(device, seed: int = 0):
    """Res16UNet34C (200 classes) with the bench's seeded weights: BN
    scales and running variances 1, every other tensor 0.05 * N(0, 1)."""
    from languagegroundedsemseg_torch.models.res16unet import Res16UNet34C

    model = Res16UNet34C(out_channels=200, device=device)
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith(("running_var", "bn.weight")):
            v = np.ones(tuple(t.shape), np.float32)
        else:
            v = 0.05 * rng.standard_normal(tuple(t.shape)).astype(np.float32)
        sd[name] = torch.from_numpy(v)
    model.load_state_dict(sd)
    return model


def ms_windowed(gm) -> bool:
    """A k3 map whose window annotation the kernels can use: its convs run
    sel_fwd (and, in a train step, dw)."""
    cap = gm.out_capacity
    return bool(gm.tile > 0 and gm.wstart.numel() and gm.inv_wstart.numel()
                and cap % gm.tile == 0 and cap >= gm.win)


def expected_launches(model, graph, train: bool = False) -> dict:
    """Launches the routing must make in one forward (or, with ``train``,
    one train step): per k3 conv whose map carries a usable window
    annotation, one sel_fwd (train: another for its dX, except the conv
    that takes the input features, whose dX is never asked for, and one
    dw); per down conv on a windowed map, one csum (train: another for the
    dX of its up conv, which runs the child-sum direction of the same
    map). With ``remat`` on, a train step runs each checkpointed block's
    forward again in the backward: its convs' forward launches count
    twice. A wrapper is seen through to its ``base``, a paired model to
    its ``backbone`` (one view: ``graph``'s); a down map's input level is
    read from the model's graph spec. A model without sparse convs
    (ClassifierNet) launches nothing."""
    from languagegroundedsemseg_torch.models.layers import SparseConv
    from languagegroundedsemseg_torch.ops.onehot_conv import _cs_window
    from languagegroundedsemseg_torch.sparse.types import (
        ChildSumMap,
        MaskedShiftMap,
    )

    while hasattr(model, "base") or hasattr(model, "backbone"):
        model = getattr(model, "base", None) or model.backbone
    want = {"sel_fwd": 0, "csum": 0, "dw": 0}
    if not hasattr(model, "input_conv"):
        return want
    first = model.input_conv()
    spec = type(model).graph_spec()
    recomputed = set()
    if train and getattr(model, "remat", False):
        recomputed = {id(m) for blk in model.stage_blocks() for m in blk.modules()}
    for mod in model.modules():
        if not isinstance(mod, SparseConv) or mod.map_name is None:
            continue
        again = id(mod) in recomputed
        gm = graph.gmaps.get(mod.map_name)
        if isinstance(gm, MaskedShiftMap):
            if ms_windowed(gm):
                want["sel_fwd"] += 1 + again
                if train:
                    want["dw"] += 1
                    want["sel_fwd"] += mod is not first
        elif isinstance(gm, ChildSumMap):
            cap_in = graph.levels[spec.maps[mod.map_name].level_in].capacity
            if _cs_window(gm, cap_in)[0]:
                want["csum"] += 1 + again
        elif train and gm is None:
            cgm = graph.gmaps.get(graph.maps[mod.map_name].companion)
            if (isinstance(cgm, ChildSumMap)
                    and _cs_window(cgm, cgm.in_capacity)[0]):
                want["csum"] += 1
    return want


def sel_inputs(graph, c_run: int, gen, map_name: str = "l0.k3"):
    """A k3 map's anchors, window starts and center mask (the L0 map's by
    default) and random bf16 P of 9 blocks of c_run channels."""
    from languagegroundedsemseg_torch.ops.msconv import _abs_anchors

    m = graph.gmaps[map_name]
    if not ms_windowed(m):
        raise RuntimeError(f"the {map_name} map of the main-path batch has "
                           "no window")
    anchors = _abs_anchors(m.anchors).contiguous()
    cap = anchors.shape[1]
    pall = torch.randn((cap, 9 * c_run), generator=gen, device=anchors.device)
    return dict(wstart=m.wstart, anchors=anchors, mc=m.mc,
                pall=pall.to(torch.bfloat16), n_cols=8, tile=m.tile,
                win=m.win)


def sel_hits(a) -> torch.Tensor:
    """(8, cap) bool: the anchors inside their tile's window, the ones the
    kernel adds."""
    cap = a["anchors"].shape[1]
    t = torch.arange(cap, device=a["anchors"].device) // a["tile"]
    ws = a["wstart"].long().view(-1, 8)[t].t()
    an = a["anchors"].long()
    return (an >= ws) & (an < ws + a["win"])


def csum_inputs(graph, c_run: int, gen, map_name: str = "down0"):
    """A down map's group parents and window starts (the L0->L1 map's by
    default) and random bf16 P of width c_run."""
    from languagegroundedsemseg_torch.ops.onehot_conv import (
        _abs_parent,
        _parent_groups,
    )

    m = graph.gmaps[map_name]
    if m.tile <= 0:
        raise RuntimeError(f"the {map_name} map of the main-path batch has "
                           "no window")
    parent = _abs_parent(m)
    pg = _parent_groups(parent, m.kslot, m.num_slots, m.n_groups,
                        m.out_capacity)
    cap_in = parent.shape[0]
    pall = torch.randn((cap_in, c_run), generator=gen, device=parent.device)
    return dict(wstart=m.wstart, parent_g=pg, pall=pall.to(torch.bfloat16),
                cap_out=m.out_capacity, tile=m.tile, win=m.win,
                n_groups=m.n_groups)


def sel_work(a) -> tuple:
    """(bytes, operations) the selector forward needs on these inputs:
    every center block, each in-window anchored block once, the anchors,
    starts and mask, and the f32 output."""
    cap = a["anchors"].shape[1]
    c_run = a["pall"].shape[1] // 9
    hits = int(sel_hits(a).sum())
    nbytes = (cap * c_run * 2 + hits * c_run * 2 + a["anchors"].numel() * 4
              + a["wstart"].numel() * 4 + cap + cap * c_run * 4)
    return nbytes, (hits + cap) * c_run, hits


def sel_shape_record(a, map_name: str) -> dict:
    """The fields of a sel_fwd record that need no card: the map, width and
    window, the anchored rows the kernel adds, the launch plan
    (``sel_geometry``), and the bytes and operations of the bound."""
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    cap = a["anchors"].shape[1]
    c_run = a["pall"].shape[1] // 9
    nbytes, ops, hits = sel_work(a)
    return {
        "name": "sel_fwd", "map": map_name, "c_run": c_run, "cap": cap,
        "tile": a["tile"], "win": a["win"], "anchored_rows": hits,
        **oc.sel_geometry(cap, c_run, a["tile"], a["win"]),
        "library_call": ("F.embedding_bag(idx, P.float().view(9*cap, c_run),"
                         " per_sample_weights=w, mode='sum'): idx[o] = [9o,"
                         " 9a_c(o)+c+1], w = mc x hit; f32 table, idx and w "
                         "built outside the timing"),
        "bytes": nbytes, "operations": ops, "peak_ops_per_s": F32_OPS_PER_S}


def sel_library(a):
    """The selector forward as ONE library call: ``F.embedding_bag`` in sum
    mode over P's (row, block) pieces as rows of an f32 table, each output
    row a bag of its center piece and its 8 anchored pieces, weighted by
    mc x hit (a miss points at piece 0 with weight 0)."""
    import torch.nn.functional as F

    cap = a["anchors"].shape[1]
    c_run = a["pall"].shape[1] // 9
    hit = sel_hits(a)
    rows = torch.arange(cap, device=hit.device)
    cols = torch.arange(1, 9, device=hit.device)[:, None]
    idx = torch.cat([rows[None] * 9,
                     torch.where(hit, a["anchors"].long() * 9 + cols, 0)])
    mc = a["mc"].to(torch.float32)
    w = torch.cat([mc[None], hit.to(torch.float32) * mc])
    idx, w = idx.t().contiguous(), w.t().contiguous()
    table = a["pall"].to(torch.float32).view(cap * 9, c_run)
    return lambda: F.embedding_bag(idx, table, per_sample_weights=w,
                                   mode="sum")


def csum_rows(a):
    """(target row, input row) of every child the kernel sums: in its
    parent's tile window for its group."""
    cap_in = a["pall"].shape[0]
    n_tiles = a["cap_out"] // a["tile"]
    rows = torch.arange(cap_in, device=a["pall"].device)
    dst, src = [], []
    for g in range(a["n_groups"]):
        p = a["parent_g"][g].long()
        t = torch.clamp(p // a["tile"], max=n_tiles - 1)
        ws = a["wstart"][t * a["n_groups"] + g].long()
        take = (p < a["cap_out"]) & (rows >= ws) & (rows < ws + a["win"])
        dst.append(p[take])
        src.append(rows[take])
    return torch.cat(dst), torch.cat(src)


def csum_work(a, n_summed: int) -> tuple:
    c_run = a["pall"].shape[1]
    cap_in = a["pall"].shape[0]
    nbytes = (n_summed * c_run * 2 + a["n_groups"] * cap_in * 4
              + a["wstart"].numel() * 4 + a["cap_out"] * c_run * 4)
    return nbytes, n_summed * c_run


def csum_shape_record(a, map_name: str) -> dict:
    """The fields of a csum record that need no card: the map, widths and
    window, the rows the kernel sums, the launch plan
    (``csum_geometry``), and the bytes and operations of the bound."""
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    cap_in, c_run = a["pall"].shape
    dst, _ = csum_rows(a)
    nbytes, ops = csum_work(a, int(dst.numel()))
    return {
        "name": "csum", "map": map_name, "c_run": c_run, "cap_in": cap_in,
        "cap_out": a["cap_out"], "tile": a["tile"], "win": a["win"],
        "n_groups": a["n_groups"], "summed_rows": int(dst.numel()),
        **oc.csum_geometry(cap_in, a["cap_out"], c_run, a["tile"], a["win"],
                           a["n_groups"]),
        "library_call": "index_add_ of the summed rows (f32)",
        "bytes": nbytes, "operations": ops, "peak_ops_per_s": F32_OPS_PER_S}


def queued_ms(fn, runs: int, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``: ``runs`` calls enqueued
    behind a ~10 ms device sleep, so they run back to back whatever the
    host's time per call, between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def host_ms(fn, runs: int, warmup: int = 3) -> float:
    """Host milliseconds per call of ``fn``: ``runs`` calls on the host's
    clock with no synchronisation inside, so the device runs behind and
    only the host's share (checks, allocation, the launch) is timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * seconds / runs


def csum_record(graph, c_run: int, gen, map_name: str = "down0") -> dict:
    """csum against its plain version at width c_run on a down map of the
    main-path batch, a second launch bit-equal to the first, timed beside
    the plain version and ``index_add_`` of the summed rows: per call with
    its host time (``ms``, as every kernel row) and back to back on the
    device (``device_ms``); with its launch plan, the compiled constants
    and blocks an SM holds (``csum_config``) and what ptxas reported."""
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    a = csum_inputs(graph, c_run, gen, map_name)
    args = [a[k] for k in ("wstart", "parent_g", "pall", "cap_out", "tile",
                           "win", "n_groups")]
    name = f"csum {map_name} c={c_run}"
    got = oc.csum(*args)
    err, scale = _hold(name, got, oc.csum_reference(*args), KERNEL_RTOL)
    if not torch.equal(oc.csum(*args), got):
        raise AssertionError(f"{name}: a second launch differs from the first")
    dst, src = csum_rows(a)
    p32 = a["pall"][src].to(torch.float32)
    lib_out = torch.zeros((a["cap_out"], c_run), device="cuda")
    rec = csum_shape_record(a, map_name)
    cfg = oc.csum_config(a["tile"], rec["entries"])

    def kernel():
        oc.csum(*args)

    def library():
        lib_out.index_add_(0, dst, p32)

    rec.update({
        "config": cfg, "blocks_per_sm": cfg["blocks_per_sm"],
        "ptxas": cuda_kernels.ptxas_usage("csum", "csum_kernel"),
        "max_abs_err": err, "max_abs_ref": scale, "bit_equal_relaunch": True,
        "ms": cuda_ms(kernel, TIMED_KERNEL_RUNS),
        "plain_ms": cuda_ms(lambda: oc.csum_reference(*args),
                            TIMED_KERNEL_RUNS),
        "library_ms": cuda_ms(library, TIMED_KERNEL_RUNS),
        "device_ms": queued_ms(kernel, TIMED_KERNEL_RUNS),
        "library_device_ms": queued_ms(library, TIMED_KERNEL_RUNS)})
    return rec


def sel_record(graph, c_run: int, gen, map_name: str = "l0.k3") -> dict:
    """sel_fwd against its plain version at width c_run on a k3 map of the
    main-path batch, held bit for bit (the same adds in the same order),
    and a second launch bit-equal to the first; timed beside the plain
    version and ``F.embedding_bag`` (``sel_library``): per call with its
    host time (``ms``, as every kernel row), back to back on the device
    (``device_ms``), and the wrapper's host time alone (``host_ms``); with
    its launch plan, the compiled constants and blocks an SM holds
    (``sel_config``) and what ptxas reported."""
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    a = sel_inputs(graph, c_run, gen, map_name)
    args = [a[k] for k in ("wstart", "anchors", "mc", "pall", "n_cols",
                           "tile", "win")]
    name = f"sel_fwd {map_name} c={c_run}"
    got = oc.sel_fwd(*args)
    ref = oc.sel_fwd_reference(*args)
    err, scale = _hold(name, got, ref, 0.0)
    if not torch.equal(oc.sel_fwd(*args), got):
        raise AssertionError(f"{name}: a second launch differs from the first")
    rec = sel_shape_record(a, map_name)
    library = sel_library(a)
    lib_err = float((library() - ref).abs().max())
    del ref
    cfg = oc.sel_config(8, rec["rows_per_block"], rec["threads"])

    def kernel():
        oc.sel_fwd(*args)

    rec.update({
        "config": cfg, "blocks_per_sm": cfg["blocks_per_sm"],
        "ptxas": cuda_kernels.ptxas_usage("sel_fwd", "sel_fwd_kernelILi8"),
        "max_abs_err": err, "max_abs_ref": scale, "bit_equal_relaunch": True,
        "library_max_abs_err": lib_err,
        "ms": cuda_ms(kernel, TIMED_KERNEL_RUNS),
        "plain_ms": cuda_ms(lambda: oc.sel_fwd_reference(*args),
                            TIMED_KERNEL_RUNS),
        "library_ms": cuda_ms(library, TIMED_KERNEL_RUNS),
        "device_ms": queued_ms(kernel, TIMED_KERNEL_RUNS),
        "library_device_ms": queued_ms(library, TIMED_KERNEL_RUNS),
        "host_ms": host_ms(kernel, 5 * TIMED_KERNEL_RUNS)})
    return rec


def dw_inputs(graph, cw: int, c_out: int, gen, map_name: str = "l0.k3"):
    """A k3 map's inverse tiling (the L0 map's by default), rebuilt from
    the production wire format as the train step does, and random bf16 T3
    and g."""
    from languagegroundedsemseg_torch.ops.msconv import _abs_anchors
    from languagegroundedsemseg_torch.ops.onehot_conv import _inv_from_anchors

    m = graph.gmaps[map_name]
    if m.tile <= 0 or m.inv_anchors.shape[1]:
        raise RuntimeError(f"the {map_name} map of the main-path batch has "
                           "no window, or ships its inverse anchors")
    inv = _inv_from_anchors(_abs_anchors(m.anchors), m.ov_in, m.ov_out,
                            m.ov_off, m.dwov_in, m.dwov_off)
    cap = inv.shape[1]
    t3b = torch.randn((cap, cw), generator=gen, device=inv.device)
    g = torch.randn((cap, c_out), generator=gen, device=inv.device)
    return dict(inv_wstart=m.inv_wstart, inv_anchors=inv,
                t3b=t3b.to(torch.bfloat16), g=g.to(torch.bfloat16),
                tile=m.tile, win=m.win)


def dw_gathered(a) -> tuple:
    """(G_all, in-window pairs): the in-window g rows of every column side
    by side, (cap, 8 * c_out) bf16, zeros elsewhere."""
    n_cols, cap = a["inv_anchors"].shape
    t = torch.arange(cap, device=a["g"].device) // a["tile"]
    zero = torch.zeros((), dtype=a["g"].dtype, device=a["g"].device)
    cols, hits = [], 0
    for c in range(n_cols):
        o = a["inv_anchors"][c].long()
        ws = a["inv_wstart"][t * n_cols + c].long()
        hit = (o >= ws) & (o < ws + a["win"]) & (o < cap)
        hits += int(hit.sum())
        cols.append(torch.where(hit[:, None],
                                a["g"][torch.where(hit, o, torch.zeros_like(o))],
                                zero))
    return torch.cat(cols, dim=1).contiguous(), hits


def dw_work(a, hits: int) -> tuple:
    """(bytes, operations) of the fused dW on these inputs: T3 and g read
    once, the inverse tiling, the f32 output; a multiply-add per in-window
    pair and (3C, c_out) element."""
    n_cols, cap = a["inv_anchors"].shape
    cw, c_out = a["t3b"].shape[1], a["g"].shape[1]
    nbytes = (cap * cw * 2 + cap * c_out * 2 + n_cols * cap * 4
              + a["inv_wstart"].numel() * 4 + n_cols * cw * c_out * 4)
    return nbytes, 2 * hits * cw * c_out


def dw_record(graph, cw: int, c_out: int, gen, map_name: str) -> dict:
    """dw against its plain version at (3C, c_out) on a k3 map of the
    main-path batch, timed beside the plain version and the library
    product, with its launch geometry, the blocks an SM holds and what
    ptxas reported (registers a thread, static shared memory, spills)."""
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    a = dw_inputs(graph, cw, c_out, gen, map_name)
    args = [a[k] for k in ("inv_wstart", "inv_anchors", "t3b", "g", "tile",
                           "win")]
    err, scale = _hold(f"dw {cw}x{c_out} at {map_name}", oc.dw_fused(*args),
                       oc.dw_fused_reference(*args), DW_RTOL)
    g_all, hits = dw_gathered(a)
    t3t = a["t3b"].t()
    nbytes, ops = dw_work(a, hits)
    n_cols, cap = a["inv_anchors"].shape
    cfg = oc.dw_config()
    return {
        "name": "dw", "map": map_name, "cw": cw, "c_out": c_out, "cap": cap,
        "tile": a["tile"], "win": a["win"], "inverse_pairs": hits,
        **oc.dw_geometry(cap, cw, c_out, n_cols),
        "stages": cfg["stages"], "blocks_per_sm": cfg["blocks_per_sm"],
        "dynamic_smem_bytes": cfg["dynamic_smem_bytes"],
        "ptxas": cuda_kernels.ptxas_usage("dw", "dw_kernel"),
        "max_abs_err": err, "max_abs_ref": scale,
        "ms": cuda_ms(lambda: oc.dw_fused(*args), TIMED_KERNEL_RUNS),
        "plain_ms": cuda_ms(lambda: oc.dw_fused_reference(*args),
                            TIMED_KERNEL_RUNS),
        "library_ms": cuda_ms(lambda: torch.matmul(t3t, g_all),
                              TIMED_KERNEL_RUNS),
        "library_call": ("torch.matmul(t3b.t(), G) on a pre-gathered bf16 G "
                         "(cap, 8*c_out): the product alone, without the "
                         "gather, bf16 output"),
        "bytes": nbytes, "operations": ops,
        "peak_ops_per_s": BF16_TC_OPS_PER_S}


def _hold(name, got, ref, rtol):
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= rtol * scale:
        raise AssertionError(f"{name}: max abs err {err} vs max |ref| {scale}")
    return err, scale


def phase_kernels(graph, bw: float) -> dict:
    """Each kernel against its plain version on the main-path batch's maps,
    at the widths the main path gives it: sel_fwd at 96 / 32 (forward) and
    384 (block5's dX) on the L0 map and 256 on the L4 map (4,096 rows);
    csum at 32 / 96 (forward) and 256 (up-conv dX); dw at DW_SHAPES. Then
    the widths Res16UNet50 (phase zoo_path) adds: ZOO_SEL_SHAPES,
    ZOO_CSUM_WIDTHS, ZOO_DW_SHAPES; and the batch norm's four kernels at
    BN_ROWS x BN_CHANNELS (``bn_records``); the contrastive loss's two
    kernels at CONTRAST_ROWS x CONTRAST_DIM (``contrast_records``); the
    masked-shift table's kernel at T3_SHAPES (``t3_records``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for c_run, map_name in SEL_SHAPES:
        results[("sel_fwd", c_run)] = sel_record(graph, c_run, gen, map_name)

    for c_run in (32, 96, 256):
        results[("csum", c_run)] = csum_record(graph, c_run, gen)

    for cw, c_out, map_name in DW_SHAPES:
        results[("dw", cw)] = dw_record(graph, cw, c_out, gen, map_name)

    # the widths the rest of the zoo adds (phase zoo_path's Res16UNet50)
    for c_run, map_name in ZOO_SEL_SHAPES:
        results[("sel_fwd", "zoo", c_run)] = sel_record(graph, c_run, gen, map_name)
    for c_run in ZOO_CSUM_WIDTHS:
        results[("csum", "zoo", c_run)] = csum_record(graph, c_run, gen)
    for cw, c_out, map_name in ZOO_DW_SHAPES:
        results[("dw", "zoo", cw)] = dw_record(graph, cw, c_out, gen, map_name)

    results.update(bn_records(gen))
    results.update(contrast_records(gen))
    results.update(t3_records(gen))

    for key, rec in results.items():
        _bound(rec, bw)
        emit({"phase": "kernels", **rec,
              **({"shape_of": "zoo_path"} if "zoo" in key else {})})
    return results


def bn_records(gen) -> dict:
    """The batch norm's kernels (``ops/batch_norm.py``) at BN_ROWS x
    BN_CHANNELS in f32, each held to its plain version on the card (f32,
    another sum order: KERNEL_RTOL of max |ref|) and relaunched bit-equal,
    then timed beside its plain version and the library's batch norm over
    the valid rows (``native_batch_norm`` and its backward, which the port
    never calls). ``bn_stats`` and ``bn_bwd_reduce`` include their combine
    launch. Bytes: each (row, channel) the kernel reads or writes once
    (``bn_stats`` and ``bn_bwd_apply`` read x on valid rows only), the
    mask, and the per-block partials."""
    from languagegroundedsemseg_torch.ops import batch_norm as bno
    from languagegroundedsemseg_torch.ops import cuda_kernels

    rows, c, s = BN_ROWS, BN_CHANNELS, 4
    n_valid = int(rows * BN_FILL)
    x = torch.randn((rows, c), device="cuda", generator=gen) * 1.5 + 0.3
    g = torch.randn((rows, c), device="cuda", generator=gen)
    mask = (torch.arange(rows, device="cuda") < n_valid).float()
    w = torch.rand(c, device="cuda", generator=gen) + 0.5
    b = torch.randn(c, device="cuda", generator=gen)
    rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
    geo = bno.bn_geometry(rows, c)
    part = geo["grid"][0] * (2 * c + 1) * 4
    packed = bno.bn_stats(x, mask)
    _, stat = bno.bn_apply(x, packed, w, b, rm.clone(), rv.clone(), 1e-5, 0.02,
                           bno.RECOMPUTE, torch.float32)
    sums = bno.bn_bwd_reduce(g, x, stat)
    xv, gv = x[:n_valid], g[:n_valid]
    fwd = torch.ops.aten.native_batch_norm(xv, w, b, rm.clone(), rv.clone(),
                                           True, 0.02, 1e-5)
    lib_fwd = ("aten native_batch_norm over the valid rows: statistics and "
               "output", lambda: torch.ops.aten.native_batch_norm(
                   xv, w, b, rm.clone(), rv.clone(), True, 0.02, 1e-5))
    lib_bwd = ("aten native_batch_norm_backward over the valid rows: dx and "
               "both sums", lambda: torch.ops.aten.native_batch_norm_backward(
                   gv, xv, w, rm, rv, fwd[1], fwd[2], True, 1e-5,
                   [True, True, True]))
    # name -> (kernel, plain version, bytes, library yardstick or None)
    calls = {
        "bn_stats": (lambda: bno.bn_stats(x, mask),
                     lambda: bno.bn_stats_reference(x, mask),
                     n_valid * c * s + rows * 4 + 2 * part, lib_fwd),
        "bn_apply": (lambda: bno.bn_apply(x, packed, w, b, rm.clone(), rv.clone(),
                                          1e-5, 0.02, bno.RECOMPUTE,
                                          torch.float32)[0],
                     lambda: bno.bn_apply_reference(
                         x, packed, w, b, rm.clone(), rv.clone(), 1e-5, 0.02,
                         bno.RECOMPUTE, torch.float32)[0],
                     2 * rows * c * s, None),
        "bn_bwd_reduce": (lambda: bno.bn_bwd_reduce(g, x, stat),
                          lambda: bno.bn_bwd_reduce_reference(g, x, stat),
                          2 * rows * c * s + 2 * part, lib_bwd),
        "bn_bwd_apply": (lambda: bno.bn_bwd_apply(g, x, mask, w, stat, sums, True),
                         lambda: bno.bn_bwd_apply_reference(g, x, mask, w, stat,
                                                            sums, True),
                         (2 * rows + n_valid) * c * s + rows * 4, None),
    }
    cfg = bno.bn_config(geo["threads"])
    out = {}
    for name, (kernel, plain, nbytes, library) in calls.items():
        got = kernel()
        err, scale = _hold(f"{name} rows={rows} c={c}", got, plain(), KERNEL_RTOL)
        if not torch.equal(kernel(), got):
            raise AssertionError(f"{name}: a second launch differs from the first")
        rec = {"kernel": name, "rows": rows, "channels": c, "dtype": "float32",
               "valid_rows": n_valid, "geometry": geo, "config": cfg,
               "ptxas": cuda_kernels.ptxas_usage("bn", f"{name}_kernel"),
               "max_abs_err": err, "max_abs_ref": scale,
               "bit_equal_relaunch": True, "bytes": nbytes, "operations": 0,
               "peak_ops_per_s": F32_OPS_PER_S,
               "ms": cuda_ms(kernel, TIMED_KERNEL_RUNS),
               "device_ms": queued_ms(kernel, TIMED_KERNEL_RUNS),
               "host_ms": host_ms(kernel, 5 * TIMED_KERNEL_RUNS),
               "plain_ms": cuda_ms(plain, TIMED_KERNEL_RUNS)}
        if library is not None:
            rec["library_call"] = library[0]
            rec["library_ms"] = cuda_ms(library[1], TIMED_KERNEL_RUNS)
        out[(name, c)] = rec
    return out


def contrast_records(gen) -> dict:
    """The contrastive loss's kernels (``ops/contrastive.py``) at
    CONTRAST_ROWS x CONTRAST_DIM in f32, 3 negatives, 200 unit anchors,
    CONTRAST_FILL of the rows real (the rest padding, label 255), each held
    to its plain version on the card (f32, another sum order: KERNEL_RTOL
    of max |ref|) and relaunched bit-equal, then timed beside its plain
    version; then the node's forward and backward through autograd
    (``contrast_step``) beside the eager loss it replaces on the card
    (``contrastive_language_loss``'s eager arithmetic), with the memory
    each adds to the peak. Bytes: f read once by the forward, read again
    and df written by the backward; the labels, negatives, mask and per-row
    values."""
    from unittest import mock

    from languagegroundedsemseg_torch.losses import contrastive as lcn
    from languagegroundedsemseg_torch.ops import contrastive as ocn
    from languagegroundedsemseg_torch.ops import cuda_kernels

    rows, d, s, classes = CONTRAST_ROWS, CONTRAST_DIM, 3, 200
    a = torch.randn((classes, d), device="cuda", generator=gen)
    unit = a / torch.linalg.vector_norm(a, dim=1, keepdim=True)
    real = torch.arange(rows, device="cuda") < int(rows * CONTRAST_FILL)
    labels = torch.randint(0, classes, (rows,), device="cuda", generator=gen)
    labels = torch.where(real, labels, torch.full_like(labels, 255)).to(torch.int32)
    row_mask = real.float()
    negatives = lcn.sample_negatives(gen, labels.long().clamp(0, classes - 1),
                                     classes, s)
    f = (0.8 * unit[labels.long().clamp(0, classes - 1)]
         + 0.5 * torch.randn((rows, d), device="cuda", generator=gen))
    gp = torch.full((rows,), 1.0 / rows, device="cuda")
    gn = gp.clone()
    pos, negl, stat = ocn.contrast_fwd(f, labels, row_mask, negatives, unit, 255,
                                       0.0, 0.6)
    per_row = rows * (4 + 8 * s + 4)  # labels, negatives, mask or cotangent
    geo = ocn.contrast_geometry(rows, d, s, classes)
    calls = {
        "contrast_fwd": (
            lambda: ocn.contrast_fwd(f, labels, row_mask, negatives, unit, 255,
                                     0.0, 0.6),
            lambda: ocn.contrast_fwd_reference(f, labels, row_mask, negatives,
                                               unit, 255, 0.0, 0.6),
            rows * d * 4 + per_row + rows * 20),
        "contrast_bwd": (
            lambda: (ocn.contrast_bwd(f, labels, negatives, unit, stat, pos,
                                      negl, gp, gn),),
            lambda: (ocn.contrast_bwd_reference(f, labels, negatives, unit, stat,
                                                pos, negl, gp, gn),),
            rows * d * 8 + per_row + rows * 24),
    }
    out = {}
    for name, (kernel, plain, nbytes) in calls.items():
        got = kernel()
        for k, (g, w) in enumerate(zip(got, plain())):
            _hold(f"{name}[{k}] rows={rows} d={d}", g, w, KERNEL_RTOL)
        if not all(torch.equal(x, y) for x, y in zip(kernel(), got)):
            raise AssertionError(f"{name}: a second launch differs from the first")
        out[(name, d)] = {
            "kernel": name, "rows": rows, "channels": d, "negatives": s,
            "classes": classes, "dtype": "float32", "valid_rows": int(real.sum()),
            "geometry": geo,
            "ptxas": cuda_kernels.ptxas_usage("contrast", f"{name}_kernel"),
            "bit_equal_relaunch": True, "bytes": nbytes, "operations": 0,
            "peak_ops_per_s": F32_OPS_PER_S,
            "ms": cuda_ms(kernel, TIMED_KERNEL_RUNS),
            "device_ms": queued_ms(kernel, TIMED_KERNEL_RUNS),
            "host_ms": host_ms(kernel, 5 * TIMED_KERNEL_RUNS),
            "plain_ms": cuda_ms(plain, TIMED_KERNEL_RUNS)}
    del pos, negl, stat

    def step(node: bool):
        with mock.patch.object(lcn, "_takes_node", lambda *args: node):
            x = f.detach().requires_grad_(True)
            loss, _, _ = lcn.contrastive_language_loss(
                None, x, labels, unit[:, None, :], row_mask=row_mask,
                negatives=negatives)
            loss.backward()
            return x.grad

    def extra_gib(node: bool) -> float:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(node)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    g_node, g_eager = step(True), step(False)
    err, scale = _hold(f"contrast_step rows={rows} d={d}", g_node, g_eager,
                       KERNEL_RTOL)
    out[("contrast_step", d)] = {
        "kernel": "contrast_step", "rows": rows, "channels": d, "negatives": s,
        "what": "the node's forward and backward through autograd, the loss "
                "and df; library: the eager loss's, on the card",
        "max_abs_err_vs_eager": err, "max_abs_ref": scale,
        "bytes": sum(c[2] for c in calls.values()), "operations": 0,
        "peak_ops_per_s": F32_OPS_PER_S,
        "ms": cuda_ms(lambda: step(True), TIMED_FWD_RUNS),
        "peak_extra_gib": extra_gib(True),
        "library_call": "contrastive_language_loss's eager arithmetic, "
                        "forward and backward",
        "library_ms": cuda_ms(lambda: step(False), TIMED_FWD_RUNS),
        "library_peak_extra_gib": extra_gib(False)}
    return out


def t3_records(gen) -> dict:
    """The masked-shift table's kernel (``ops/shift_table.py``) at each of
    T3_SHAPES from f32 x and masks of random patterns, held bit for bit to
    its plain version (the eager expression it replaces), relaunched
    bit-equal, then timed beside it. Bytes: x read once, the masks, the
    (rows, 3c) bf16 table written once."""
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from languagegroundedsemseg_torch.ops import shift_table as sto

    out = {}
    for rows, c in T3_SHAPES:
        x = torch.randn((rows, c), device="cuda", generator=gen)
        pattern = torch.randint(0, 8, (rows,), device="cuda", generator=gen)
        mp, mn, mc = (((pattern >> k) & 1).to(torch.uint8) for k in range(3))

        def kernel():
            return sto.masked_shift_table_bf16(x, mp, mn, mc)

        def plain():
            return sto.masked_shift_table_reference(x, mp, mn, mc)

        got = kernel()
        if not torch.equal(got.view(torch.int16), plain().view(torch.int16)):
            raise AssertionError(f"t3 rows={rows} c={c}: differs from the plain "
                                 "version")
        if not torch.equal(kernel().view(torch.int16), got.view(torch.int16)):
            raise AssertionError("t3: a second launch differs from the first")
        del got
        out[("t3", c)] = {
            "kernel": "t3", "rows": rows, "channels": c, "dtype": "float32",
            "geometry": sto.t3_geometry(rows, c),
            "ptxas": cuda_kernels.ptxas_usage("t3", "t3_kernelILi8EfE"),
            "bit_equal_to_plain": True, "bit_equal_relaunch": True,
            "bytes": rows * c * 4 + 3 * rows + rows * 3 * c * 2,
            "operations": 0, "peak_ops_per_s": F32_OPS_PER_S,
            "ms": cuda_ms(kernel, TIMED_KERNEL_RUNS),
            "device_ms": queued_ms(kernel, TIMED_KERNEL_RUNS),
            "host_ms": host_ms(kernel, 5 * TIMED_KERNEL_RUNS),
            "plain_ms": cuda_ms(plain, TIMED_KERNEL_RUNS),
            "plain_device_ms": queued_ms(plain, TIMED_KERNEL_RUNS)}
        del x, pattern, mp, mn, mc
    return out


def _bound(rec, bw: float) -> None:
    """Add the least time the card could take for ``rec``'s work: the
    larger of its bytes over the memory rate and its operations over the
    peak rate of their type."""
    t_bytes = rec["bytes"] / bw
    t_ops = rec["operations"] / rec["peak_ops_per_s"]
    rec["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def gemm_work(a, tile: int, win: int) -> tuple:
    """(bytes, operations, in-window rows) of the single-column
    gather-GEMM on these inputs: each distinct in-window t3 row read once
    (f32), the anchors, starts and W, the f32 output; a multiply-add per
    in-window row and (cw, c_out) element."""
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    n_rows, cw = a["t3"].shape
    n, c_out = a["anchors"].shape[0], a["w"].shape[1]
    hit, rows = oa._gemm_hits(a["wstart"], a["anchors"], n_rows, tile, win)
    distinct = int(torch.unique(rows[hit]).numel())
    hits = int(hit.sum())
    nbytes = (distinct * cw * 4 + n * 4 + a["wstart"].numel() * 4
              + cw * c_out * 4 + n * c_out * 4)
    return nbytes, 2 * hits * cw * c_out, hits


def gemm_shape_record(a, shapes: dict) -> dict:
    """The fields of an onehot_gemm record that need no card: the shapes,
    the in-window rows, the launch plan (``gemm_geometry``), the bytes and
    operations of the bound (the operations at the rate of three bf16
    tensor-core products, ``GEMM_ARITHMETIC``), and the bytes the kernel
    copies from L2 into shared memory: the rows it gathers (cw f32
    channels each; a miss copies nothing) and W's three parts every block
    stages."""
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    n, tile, win = shapes["n"], shapes["b"], shapes["w"]
    cw, c_out = shapes["cw"], shapes["c_out"]
    nbytes, ops, hits = gemm_work(a, tile, win)
    geo = oa.gemm_geometry(n, cw, c_out)
    return {
        "name": "onehot_gemm", "n": n, "tile": tile, "win": win, "cw": cw,
        "c_out": c_out, "in_window_rows": hits, "gemm_geometry": geo,
        "l2_gather_bytes": hits * cw * 4,
        "l2_w_bytes": geo["blocks"] * 3 * geo["cw_pad"] * c_out * 2,
        "l2_fill_bytes_per_s": L2_FILL_BYTES_PER_S,
        "arithmetic": GEMM_ARITHMETIC,
        "library_call": ("t3.index_select(0, anchors) @ W (f32, TF32 off): "
                         "two calls, no bf16 rounding of t3 and no window "
                         "test (every anchor of the script is in window)"),
        "bytes": nbytes, "operations": ops, "peak_ops_per_s": GEMM_OPS_PER_S}


def gemm_times(a, shapes: dict, got) -> dict:
    """onehot_gemm: ``got`` (one launch's output) held against the plain
    version (ABLATION_RTOL of max |ref|), a second launch bit-equal to it,
    then the kernel timed per call with its host time (``ms``), back to
    back on the device (``device_ms``) and on the host alone, no sync
    (``host_ms``: the wrapper's checks, allocations and two launches),
    and on the device with every row out of its window
    (``no_gather_device_ms``: the gather taken out), beside the plain
    version and the library's two calls. Uses only the wrapper's call, so
    it also times another checkout's kernel
    (``scripts/bench_onehot_gemm_torch.py --root``)."""
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    args = [a["wstart"], a["anchors"], a["t3"], a["w"], shapes["b"],
            shapes["w"]]
    err, scale = _hold("onehot_gemm", got, oa.onehot_gemm_reference(*args),
                       ABLATION_RTOL)
    if not torch.equal(oa.onehot_gemm(*args), got):
        raise AssertionError("onehot_gemm: a second launch differs from the "
                             "first")
    a_long = a["anchors"].long()
    # every window moved past the table: the same launch with no row in its
    # window, so every row copy zero-fills and gathers nothing, while W's
    # staging, the products and the stores all run
    miss = [torch.full_like(a["wstart"], a["t3"].shape[0] + shapes["w"]),
            *args[1:]]

    def kernel():
        oa.onehot_gemm(*args)

    return {
        "max_abs_err": err, "max_abs_ref": scale, "bit_equal_relaunch": True,
        "ms": cuda_ms(kernel, TIMED_KERNEL_RUNS),
        "device_ms": queued_ms(kernel, TIMED_KERNEL_RUNS),
        "host_ms": host_ms(kernel, TIMED_KERNEL_RUNS),
        "no_gather_device_ms": queued_ms(lambda: oa.onehot_gemm(*miss),
                                         TIMED_KERNEL_RUNS),
        "plain_ms": cuda_ms(lambda: oa.onehot_gemm_reference(*args),
                            TIMED_KERNEL_RUNS),
        "library_ms": cuda_ms(lambda: a["t3"].index_select(0, a_long)
                              @ a["w"], TIMED_KERNEL_RUNS)}


def gemm_record(a, shapes: dict, got) -> dict:
    """The full onehot_gemm record: ``gemm_shape_record`` and
    ``gemm_times``, the prepass's three parts bit-equal to the plain split
    (``split_bf16x3``, zero rows past cw), the compiled constants and
    blocks an SM holds (``gemm_config``), what ptxas reported for the
    product and the prepass, the L2 gather floor (the gathered rows over
    ``L2_FILL_BYTES_PER_S``) and the f32 CUDA-core time of the same
    operations (the bound before the split)."""
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    rec = gemm_shape_record(a, shapes)
    rec.update(gemm_times(a, shapes, got))
    cw = shapes["cw"]
    want = torch.zeros(rec["gemm_geometry"]["split_shape"],
                       dtype=torch.bfloat16, device=a["w"].device)
    want[:, :cw] = oa.split_bf16x3(a["w"])
    if not torch.equal(oa.gemm_split(a["w"]), want):
        raise AssertionError("onehot_gemm: the prepass's parts differ from "
                             "split_bf16x3")
    cfg = oa.gemm_config(shapes["c_out"])
    rec.update({
        "config": cfg, "blocks_per_sm": cfg["blocks_per_sm"],
        "ptxas": {"product": cuda_kernels.ptxas_usage(
                      "onehot_gemm",
                      f"onehot_gemm_kernelILi{shapes['c_out'] // 16}E"),
                  "split": cuda_kernels.ptxas_usage(
                      "onehot_gemm", "split_bf16x3_kernel")},
        "split_bit_equal": True,
        "l2_floor_ms": 1e3 * rec["l2_gather_bytes"] / L2_FILL_BYTES_PER_S,
        "f32_cuda_core_ms": 1e3 * rec["operations"] / F32_OPS_PER_S})
    return rec


def variants_work(mode: str, a, tile: int, win: int, n_groups: int) -> tuple:
    """(bytes, operations, peak rate, rows read) of one onehot_variants
    mode on these inputs. Each distinct t3 row the mode reads is counted
    once (bf16; no_proj reads only its first c_out channels), plus the
    anchors where the mode reads them, the starts, W where it projects,
    and the f32 output. Operations: a bf16 multiply-add per row read and
    (cw, c_out) element (full, no_sel), an f32 add per row read and output
    channel (no_proj); no_dma's function is the zero output alone."""
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    n_rows, cw = a["t3"].shape
    n_cols, _, c_out = a["w"].shape
    cap = a["anchors"].shape[1]
    out_bytes = cap * c_out * 4
    if mode == "no_dma":
        return out_bytes, 0, F32_OPS_PER_S, 0
    used, reads = [], 0
    for col in range(n_cols):
        ok, rows = oa.variants_rows(mode, col, a["wstart"], a["anchors"],
                                    n_rows, tile, win, n_groups)
        used.append(rows[ok])
        reads += int(ok.sum())
    distinct = int(torch.unique(torch.cat(used)).numel())
    nbytes = out_bytes + a["wstart"].numel() * 4
    if mode != "no_sel":
        nbytes += a["anchors"].numel() * 4
    if mode == "no_proj":
        nbytes += distinct * c_out * 2
        return nbytes, reads * c_out, F32_OPS_PER_S, reads
    nbytes += distinct * cw * 2 + n_cols * cw * c_out * 2
    return nbytes, 2 * reads * cw * c_out, BF16_TC_OPS_PER_S, reads


def variants_library(a, tile: int, win: int, n_groups: int):
    """The full mode through library calls: the in-window rows of every
    column pre-gathered into a (n_cols, cap, cw) bf16 stack (zeros out of
    window), then ``torch.bmm(stack, W).float().sum(0)`` — a batched bf16
    GEMM whose bf16 output rounds each column's product, a cast and an f32
    sum: three calls, not one."""
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    zero = torch.zeros((), dtype=a["t3"].dtype, device=a["t3"].device)
    stack = []
    for col in range(a["w"].shape[0]):
        ok, rows = oa.variants_rows("full", col, a["wstart"], a["anchors"],
                                    a["t3"].shape[0], tile, win, n_groups)
        stack.append(torch.where(ok[:, None], a["t3"][rows], zero))
    stack = torch.stack(stack)
    return lambda: torch.bmm(stack, a["w"]).float().sum(0)


def variants_shape_record(mode: str, a, shapes: dict) -> dict:
    """The fields of an onehot_variants record that need no card: the
    shapes, the rows the mode reads, the launch plan
    (``variants_geometry``), the bytes and operations of the bound, and the
    bytes the kernel copies from L2 into shared memory: the rows it
    gathers (cw channels each; a miss copies nothing) and the W chunks
    every block stages."""
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    n_cols, cw, c_out = a["w"].shape
    cap = a["anchors"].shape[1]
    nbytes, ops, peak, reads = variants_work(
        mode, a, shapes["tile"], shapes["win"], shapes["n_groups"])
    geo = oa.variants_geometry(cap, cw, c_out, n_cols)
    return {
        "name": "onehot_variants", "mode": mode, **shapes,
        "rows_read": reads, "variants_geometry": geo,
        "l2_gather_bytes": 0 if mode == "no_dma" else reads * cw * 2,
        "l2_w_bytes": (0 if mode == "no_proj"
                       else geo["blocks"] * n_cols * cw * c_out * 2),
        "l2_fill_bytes_per_s": L2_FILL_BYTES_PER_S,
        "library_call": ("torch.bmm(stack, W).float().sum(0) on a "
                         "pre-gathered (9, cap, cw) bf16 stack: three "
                         "calls, the gather not timed"
                         if mode == "full" else None),
        "bytes": nbytes, "operations": ops, "peak_ops_per_s": peak}


def variants_record(mode: str, a, shapes: dict, got, library) -> dict:
    """onehot_variants in ``mode``: ``got`` (one launch's output) held
    against the plain version (full: VARIANTS_FULL_RTOL of max |ref|;
    no_sel, no_proj: ABLATION_RTOL; no_dma: exactly zero), a second launch
    bit-equal to it, then timed beside the plain version and, for full, the
    library calls (``library``): per call with its host time (``ms``) and
    back to back on the device (``device_ms``); with the launch plan, the
    compiled constants and blocks an SM holds (``variants_config``), what
    ptxas reported for the mode's kernel, and the L2 gather floor."""
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    args = [a["wstart"], a["anchors"], a["t3"], a["w"], shapes["tile"],
            shapes["win"], shapes["n_groups"]]
    name = f"onehot_variants {mode}"
    if mode == "no_dma":
        torch.cuda.synchronize()
        if bool(got.any()):
            raise AssertionError(f"{name}: non-zero output")
        err, scale = 0.0, 0.0
    else:
        rtol = VARIANTS_FULL_RTOL if mode == "full" else ABLATION_RTOL
        err, scale = _hold(name, got, oa.onehot_variants_reference(mode, *args),
                           rtol)
    if not torch.equal(oa.onehot_variants(mode, *args), got):
        raise AssertionError(f"{name}: a second launch differs from the first")
    rec = variants_shape_record(mode, a, shapes)
    n_cols, _, c_out = a["w"].shape
    cfg = oa.variants_config(c_out, n_cols)
    nb = c_out // 16

    def kernel():
        oa.onehot_variants(mode, *args)

    rec.update({
        "config": cfg, "blocks_per_sm": cfg["blocks_per_sm"],
        "ptxas": cuda_kernels.ptxas_usage(
            "onehot_variants",
            f"onehot_variants_kernelILi{oa.MODES.index(mode)}ELi{nb}E"),
        "max_abs_err": err, "max_abs_ref": scale, "bit_equal_relaunch": True,
        "ms": cuda_ms(kernel, TIMED_KERNEL_RUNS),
        "device_ms": queued_ms(kernel, TIMED_KERNEL_RUNS),
        "plain_ms": cuda_ms(lambda: oa.onehot_variants_reference(mode, *args),
                            TIMED_KERNEL_RUNS),
        "library_ms": (cuda_ms(library, TIMED_KERNEL_RUNS)
                       if mode == "full" else None),
        "l2_floor_ms": 1e3 * rec["l2_gather_bytes"] / L2_FILL_BYTES_PER_S})
    return rec


def phase_ablation(bw: float) -> dict:
    """The one-hot ablation kernels at their microbenchmarks' full shapes
    and seeds (those of scripts/bench_onehot_gemm_torch.py and
    scripts/bench_onehot_variants_torch.py): one onehot_gemm launch and one
    onehot_variants launch per mode, with the ablation launch counts set to
    0 just before and read just after; then each output held against its
    plain version, a second launch of each bit-equal to the first, and the
    kernel, plain and library calls timed (``gemm_record``,
    ``variants_record``)."""
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    gs, vs = oa.GEMM_SHAPES, oa.VARIANTS_SHAPES
    g = oa.gemm_inputs(**gs, seed=0)
    gargs = [g["wstart"], g["anchors"], g["t3"], g["w"], gs["b"], gs["w"]]
    v = oa.variants_inputs(**vs, seed=0)
    vgeo = (vs["tile"], vs["win"], vs["n_groups"])
    vargs = [v["wstart"], v["anchors"], v["t3"], v["w"], *vgeo]
    torch.cuda.synchronize()
    oa.reset_launch_counts()
    outs = {"onehot_gemm": oa.onehot_gemm(*gargs)}
    for mode in oa.MODES:
        outs[mode] = oa.onehot_variants(mode, *vargs)
    torch.cuda.synchronize()
    launches = dict(oa.launch_counts)
    want = {"onehot_gemm": 1, "onehot_variants": len(oa.MODES)}
    if launches != want:
        raise AssertionError(f"ablation launches {launches}, expected {want}")

    results = {"onehot_gemm": gemm_record(g, gs, outs.pop("onehot_gemm"))}
    del g, gargs

    library = variants_library(v, *vgeo)
    for mode in oa.MODES:
        results[("onehot_variants", mode)] = variants_record(
            mode, v, vs, outs.pop(mode), library)
    del library, v, vargs
    torch.cuda.empty_cache()
    for rec in results.values():
        _bound(rec, bw)
        emit({"phase": "ablation", **rec})
    emit({"phase": "ablation", "launches": launches,
          "variants_ms_by_mode": {m: results[("onehot_variants", m)]["ms"]
                                  for m in oa.MODES},
          "variants_device_ms_by_mode": {
              m: results[("onehot_variants", m)]["device_ms"]
              for m in oa.MODES}})
    results["launches"] = launches
    return results


def phase_main_path(builder, scenes, batch, cold_build_s, model) -> dict:
    """The eval forward on the 4-scene batch: launch accounting, output
    checks, forward time. ``batch`` is the first (cold) build of
    ``scenes``, already on the card."""
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa
    from languagegroundedsemseg_torch.ops import onehot_conv as oc
    from languagegroundedsemseg_torch.train.step import make_eval_step

    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        builder.build_host(scenes)
        warm.append(time.perf_counter() - t0)
    graph = batch.graph
    n_voxels = int(graph.levels[0].valid.sum())
    step = make_eval_step(model)
    want = expected_launches(model, graph)

    step(batch)  # warm-up
    torch.cuda.synchronize()
    oc.reset_launch_counts()
    oa.reset_launch_counts()
    logits, _ = step(batch)
    torch.cuda.synchronize()
    launches = dict(oc.launch_counts)
    ablation_launches = dict(oa.launch_counts)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if any(ablation_launches.values()):
        raise AssertionError(
            f"ablation kernels on the forward: {ablation_launches}")
    if launches["sel_fwd"] == 0 or launches["csum"] == 0:
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
    if logits.shape != (graph.levels[0].capacity, 200):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_FWD_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    fwd_s = statistics.median(times)
    rec = {"phase": "main_path", "scenes": SCENES, "points_per_scene": POINTS,
           "n_voxels": n_voxels,
           "level_capacities": [l.capacity for l in graph.levels],
           "windows": {k: [m.tile, m.win] + ([m.n_groups] if k.startswith("down") else [])
                       for k, m in graph.gmaps.items()},
           "host_build_cold_s": cold_build_s, "host_build_warm_s": min(warm),
           "fwd_ms": fwd_s * 1e3, "fwd_ms_runs": [t * 1e3 for t in times],
           "voxels_per_s": n_voxels / fwd_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "expected_launches": want,
           "ablation_launches": ablation_launches}
    emit(rec)
    return rec


def parity_batch(device, seed: int = 1):
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec

    rng = np.random.default_rng(seed)
    builder = BatchBuilder(spec=res16unet_graph_spec(),
                           fixed_capacity=PARITY_CAP)
    return builder.build([voxelize_scene(rng, PARITY_POINTS)], device=device)


def scaled_model(device, seed: int = 1, model_cls=None, **kwargs):
    """Res16UNet34C (200 classes; or ``model_cls``, any model of the zoo,
    built with ``kwargs`` too) with well-conditioned random weights:
    kernels and linear weights
    N(0, 0.36 / fan_in), norm scales and running variances in [0.6, 1.4],
    biases and running means 0.1 * N(0, 1). Activations stay
    O(1) through the depth. (The bench's weights make the net chaotic —
    logits near 1e10, and a 1e-6 input perturbation moves them by about
    1e-2 — so a comparison under them measures the weights, not the
    port.)"""
    from languagegroundedsemseg_torch.models.res16unet import Res16UNet34C

    model = (model_cls or Res16UNet34C)(out_channels=200, device=device, **kwargs)
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(("running_var", "bn.weight")) or (
                name.endswith("weight") and len(shape) == 1):  # any norm
            v = rng.uniform(0.6, 1.4, size=shape)
        elif name.endswith(("bias", "running_mean")):
            v = 0.1 * rng.standard_normal(shape)
        elif name.endswith("weight"):  # nn.Linear: (out, in)
            v = rng.standard_normal(shape) * (0.6 / np.sqrt(shape[-1]))
        else:
            v = rng.standard_normal(shape) * (0.6 / np.sqrt(np.prod(shape[:-1])))
        sd[name] = torch.tensor(v, dtype=torch.float32)
    model.load_state_dict(sd)
    return model


def card_vs_cpu(model) -> tuple:
    """(relative L2, max |logit|, CPU seconds) of the card's logits against
    the CPU's plain path, same model and weights, on the parity batch."""
    from languagegroundedsemseg_torch.train.step import make_eval_step

    gpu_batch = parity_batch("cuda")
    got, _ = make_eval_step(model)(gpu_batch)
    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    want, _ = make_eval_step(cpu_model, device="cpu")(parity_batch("cpu"))
    cpu_s = time.perf_counter() - t0
    valid = gpu_batch.graph.levels[0].valid.cpu() > 0
    got, want = got.cpu()[valid], want[valid]
    err = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    return err, float(want.abs().max()), cpu_s, int(valid.sum())


def input_sensitivity(model, rel_noise: float = 1e-6) -> float:
    """Relative L2 change of the card's logits on the parity batch when
    the input features move by ``rel_noise`` (relative, seeded): how much
    any rounding difference is amplified by these weights."""
    from languagegroundedsemseg_torch.train.step import make_eval_step

    step = make_eval_step(model)
    batch = parity_batch("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    noise = torch.randn(batch.feats.shape, generator=gen, device="cuda")
    y0, _ = step(batch)
    y1, _ = step(batch.replace(feats=batch.feats * (1 + rel_noise * noise)))
    valid = batch.graph.levels[0].valid > 0
    y0, y1 = y0[valid], y1[valid]
    return float(torch.linalg.norm(y1 - y0) / torch.linalg.norm(y0))


def phase_parity(bench_model) -> dict:
    """Card vs CPU on one small batch. Held to PARITY_RTOL with
    well-conditioned weights; the bench-weight model's gap is reported
    beside how far a 1e-6 input perturbation alone moves each model."""
    model = scaled_model("cuda")
    err, scale, cpu_s, n = card_vs_cpu(model)
    b_err, b_scale, _, _ = card_vs_cpu(bench_model)
    rec = {"phase": "parity", "n_voxels": n, "capacity": PARITY_CAP,
           "rel_l2": err, "max_abs_logit": scale, "tolerance": PARITY_RTOL,
           "input_noise_1e-6_rel_l2": input_sensitivity(model),
           "bench_weights_rel_l2": b_err,
           "bench_weights_max_abs_logit": b_scale,
           "bench_weights_input_noise_1e-6_rel_l2":
               input_sensitivity(bench_model),
           "cpu_forward_s": cpu_s}
    emit(rec)
    if not err <= PARITY_RTOL:
        raise AssertionError(f"card vs CPU logits: relative L2 {err}")
    return rec


def train_objective(logits, _features, batch, _generator, row_mask):
    """bench.py:166-170: CE with ignore label 255 over the level-0 rows."""
    from languagegroundedsemseg_torch.losses.classification import (
        cross_entropy_loss,
    )

    return cross_entropy_loss(logits, batch.labels, 255,
                              row_mask=row_mask), {}


def _train_setup(model, device="cuda"):
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_train_step

    opt = sgd_torch(model.parameters(), TRAIN_LR)
    step = make_train_step(model, opt, train_objective, device=device)
    return step, TrainState(model, opt)


def phase_train_path(batch) -> dict:
    """SGD train steps on the 4-scene batch (well-conditioned weights: the
    bench's seeding puts logits near 1e10, where CE means nothing): one
    warm-up, one step with launch accounting (the selector, batch-norm
    and masked-shift-table kernels), TIMED_TRAIN_STEPS timed steps. Loss and grad norm finite on every step, BN statistics moved,
    and the last step's loss below the first's (the gradient's sign)."""
    from languagegroundedsemseg_torch.models.layers import SparseBatchNorm
    from languagegroundedsemseg_torch.ops import batch_norm as bno
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa
    from languagegroundedsemseg_torch.ops import onehot_conv as oc
    from languagegroundedsemseg_torch.ops import shift_table as sto

    model = scaled_model("cuda")
    step, state = _train_setup(model)
    want = expected_launches(model, batch.graph, train=True)
    # the masked-shift table: one beside each sel_fwd (forward, dX) and dw
    want_t3 = {"t3": want["sel_fwd"] + want["dw"]}
    # every norm's forward and backward: stats, combine, apply; reduce,
    # combine, apply
    norms = sum(isinstance(m, SparseBatchNorm) for m in model.modules())
    want_bn = {"bn_stats": norms, "bn_combine": 2 * norms, "bn_apply": norms,
               "bn_bwd_reduce": norms, "bn_bwd_apply": norms}
    stats0 = [b.clone() for b in model.buffers()]
    losses, norms, times = [], [], []

    def run():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))

    torch.cuda.reset_peak_memory_stats()
    run()  # warm-up
    oc.reset_launch_counts()
    oa.reset_launch_counts()
    bno.reset_launch_counts()
    sto.reset_launch_counts()
    run()
    launches = dict(oc.launch_counts)
    ablation_launches = dict(oa.launch_counts)
    bn_launches = dict(bno.launch_counts)
    t3_launches = dict(sto.launch_counts)
    if launches != want:
        raise AssertionError(f"train-step launches {launches}, expected {want}")
    if bn_launches != want_bn:
        raise AssertionError(f"train-step batch norm launches {bn_launches}, "
                             f"expected {want_bn}")
    if t3_launches != want_t3:
        raise AssertionError(f"train-step masked-shift table launches "
                             f"{t3_launches}, expected {want_t3}")
    if any(ablation_launches.values()):
        raise AssertionError(
            f"ablation kernels on the train step: {ablation_launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the train step never ran: {launches}")
    for _ in range(TIMED_TRAIN_STEPS):
        run()
    timed = times[-TIMED_TRAIN_STEPS:]
    step_s = statistics.median(timed)
    n_voxels = int(batch.graph.levels[0].valid.sum())
    moved = any(not torch.equal(a, b) for a, b in zip(stats0, model.buffers()))
    rec = {"phase": "train_path", "n_voxels": n_voxels, "lr": TRAIN_LR,
           "step_ms": step_s * 1e3, "step_ms_runs": [t * 1e3 for t in timed],
           "warmup_step_ms": times[0] * 1e3,
           "voxels_per_s": n_voxels / step_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "losses": losses, "grad_norms": norms, "steps": state.step,
           "bn_stats_moved": moved, "launches": launches,
           "expected_launches": want, "ablation_launches": ablation_launches,
           "bn_launches": bn_launches, "t3_launches": t3_launches}
    emit(rec)
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {norms}")
    if not moved:
        raise AssertionError("the BN running statistics did not move")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over {len(losses)} steps: "
                             f"{losses}")
    return rec


def _one_train_step(model, device, feats_noise: float = 0.0):
    """(loss, grads, state_dict after) of one SGD step on the parity batch;
    ``feats_noise`` moves the input features by that relative amount."""
    step, state = _train_setup(model, device)
    batch = parity_batch(device)
    if feats_noise:
        gen = torch.Generator(device=device).manual_seed(0)
        noise = torch.randn(batch.feats.shape, generator=gen, device=device)
        batch = batch.replace(feats=batch.feats * (1 + feats_noise * noise))
    state, m = step(state, batch)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    after = {n: t.detach().cpu() for n, t in model.state_dict().items()}
    return float(m["loss"]), grads, after


def _rel_l2(got, want) -> float:
    """Relative L2 gap, in f32 (a bf16 difference would round)."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def _step_gap(a, b) -> dict:
    """Relative gaps between two train-step results (loss, grads, state)."""
    (loss, grads, after), (w_loss, w_grads, w_after) = a, b
    names = sorted(grads)
    gap = {"loss": abs(loss - w_loss) / abs(w_loss),
           "grads": _rel_l2(torch.cat([grads[n].ravel() for n in names]),
                            torch.cat([w_grads[n].ravel() for n in names])),
           "worst_grad": max(((n, _rel_l2(grads[n], w_grads[n]))
                              for n in names), key=lambda kv: kv[1])}
    for kind in ("params", "stats"):
        keys = [n for n in sorted(after) if ("running" in n) == (kind == "stats")]
        gap[kind] = _rel_l2(torch.cat([after[n].ravel() for n in keys]),
                            torch.cat([w_after[n].ravel() for n in keys]))
    return gap


def phase_train_parity() -> dict:
    """One train step on the card against the CPU's plain path, same
    conditioned weights, on the parity batch.

    The step's gradient is not a continuous function of the rounding: the
    bf16 rounding of the projections is a step function, and a ReLU whose
    input sits near zero flips. So the card's gradients can differ from
    the CPU's by as much as a 1e-6 relative change of the input features
    moves them on the card, which the phase also measures. For the model
    as it is, the phase holds the loss and the BN statistics (forward
    quantities) and reports the gradient and parameter gaps; with every
    ReLU replaced by the identity on both sides, where the step is smooth,
    it holds all of them."""
    base = scaled_model("cuda")
    t0 = time.perf_counter()
    out = {}
    for tag, relu in (("model", torch.relu), ("relu_free", lambda x: x)):
        with mock.patch.object(torch, "relu", relu):
            card = _one_train_step(copy.deepcopy(base), "cuda")
            cpu = _one_train_step(copy.deepcopy(base).to("cpu"), "cpu")
            moved = _one_train_step(copy.deepcopy(base), "cuda", 1e-6)
        out[tag] = {"card_vs_cpu": _step_gap(card, cpu),
                    "card_input_noise_1e-6": _step_gap(moved, card)}
    rec = {"phase": "train_parity", "capacity": PARITY_CAP,
           "loss": card[0], **out,
           "tolerances": {"loss": TRAIN_LOSS_RTOL, "grads": TRAIN_GRAD_RTOL,
                          "params_and_stats": TRAIN_STATE_RTOL},
           "seconds": time.perf_counter() - t0}
    emit(rec)
    m, f = out["model"]["card_vs_cpu"], out["relu_free"]["card_vs_cpu"]
    held = [m["loss"] <= TRAIN_LOSS_RTOL, m["stats"] <= TRAIN_STATE_RTOL,
            f["loss"] <= TRAIN_LOSS_RTOL, f["grads"] <= TRAIN_GRAD_RTOL,
            f["params"] <= TRAIN_STATE_RTOL, f["stats"] <= TRAIN_STATE_RTOL]
    if not all(held):
        raise AssertionError(f"card vs CPU train step out of tolerance: {rec}")
    return rec


def e2e_dataset():
    """bench.py's end-to-end dataset (bench.py:197-200): 8 synthetic
    scenes of POINTS points, 200 classes."""
    from languagegroundedsemseg_torch.data.synthetic_dataset import (
        SyntheticDatasetBase,
    )

    class BenchSynthetic200Dataset(SyntheticDatasetBase):
        NUM_SCENES = E2E_SCENES
        POINTS_PER_SCENE = POINTS
        NUM_CLASSES = 200

    return BenchSynthetic200Dataset


def e2e_loader(device, num_workers: int = E2E_WORKERS):
    """The production loader as bench.py builds it (bench.py:202-207):
    shuffled, repeating, augmented 4-scene batches in the compact wire
    format, on ``device``."""
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.data.loader import initialize_data_loader

    cfg = Config(batch_size=E2E_BATCH, num_workers=num_workers,
                 ignore_label=255)
    return initialize_data_loader(
        e2e_dataset(), cfg, phase="train", num_workers=num_workers,
        shuffle=True, repeat=True, augment_data=True, batch_size=E2E_BATCH,
        limit_numpoints=cfg.train_limit_numpoints, ship_coords=False,
        device=device)


class _Timed:
    """Wraps a callable the loader's workers call and keeps each call's
    host seconds (thread-safe)."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds = []
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        with self._lock:
            self.seconds.append(dt)
        return out

    def summary(self) -> dict:
        xs = self.seconds
        return {"n": len(xs), "median_s": statistics.median(xs),
                "max_s": max(xs), "sum_s": sum(xs)} if xs else {"n": 0}


def _host_bytes(obj) -> int:
    """Bytes of every numpy array of a host batch: what crosses to the
    card."""
    import dataclasses

    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if dataclasses.is_dataclass(obj):
        return sum(_host_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return sum(_host_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_host_bytes(v) for v in obj)
    return 0


def _spread(times) -> float:
    """bench.py's spread: (max - min) / min."""
    lo, hi = min(times), max(times)
    return (hi - lo) / lo if lo > 0 else 0.0


def _check_step_launches(launches: dict, want: dict, i: int) -> None:
    if launches != want:
        raise AssertionError(
            f"e2e step {i}: launches {launches}, expected {want}")
    missing = [k for k in ("sel_fwd", "dw", "csum") if not launches[k]]
    if missing:
        raise AssertionError(f"e2e step {i}: {missing} did not run")


def _idle_step_ms(step, state, batch, runs: int = 3) -> list:
    """Host ms of ``runs`` synced train steps on ``batch`` once the
    loader's worker threads have finished their last build: the same
    step without the workers' competition for the host."""
    deadline = time.perf_counter() + 120
    while any(t.name.startswith("lgs-loader") for t in threading.enumerate()):
        if time.perf_counter() > deadline:
            raise AssertionError("the loader's workers did not stop")
        time.sleep(0.05)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])  # syncs
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def transfer_check(step, state) -> dict:
    """Two loaders with one worker and the same seed, one on the card and
    one on the CPU. Their batches are taken in turn with a train step on
    each card batch between them, so every copy after the first overlaps a
    step, as in the timed run. Every tensor of every card batch equals the
    CPU batch's after ``.cpu()``. Also the H2D cost of one worker's copy:
    the host time of the loader's transfer (pinning and queueing) and the
    side stream's span from before the first copy to after the last."""
    from languagegroundedsemseg_torch.data.loader import batch_tensors

    card, host = e2e_loader("cuda", 1), e2e_loader("cpu", 1)
    copies = []
    to_device = card._to_device

    def timed_to_device(b):
        stream = card._copy_stream
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        t0 = time.perf_counter()
        out = to_device(b)
        host_s = time.perf_counter() - t0
        end.record(stream)
        copies.append((start, end, host_s, _host_bytes(b)))
        return out

    card._to_device = timed_to_device
    it_card, it_host = iter(card), iter(host)
    n_tensors = 0
    try:
        for i in range(TRANSFER_CHECK_BATCHES):
            got, want = next(it_card), next(it_host)
            pairs = list(zip(batch_tensors(got), batch_tensors(want)))
            if len(pairs) != len(list(batch_tensors(want))) or not pairs:
                raise AssertionError(f"transfer check batch {i}: the card "
                                     "and CPU batches differ in structure")
            for j, (g, w) in enumerate(pairs):
                if not (g.device.type == card.device.type
                        and torch.equal(g.cpu(), w)):
                    raise AssertionError(
                        f"transfer check batch {i}: tensor {j} differs")
            n_tensors += len(pairs)
            state, m = step(state, got)
            if not np.isfinite(float(m["loss"])):
                raise AssertionError(f"transfer check batch {i}: loss "
                                     f"{float(m['loss'])}")
    finally:
        it_card.close()
        it_host.close()
    torch.cuda.synchronize()
    return {"batches": TRANSFER_CHECK_BATCHES, "tensors_equal": n_tensors,
            "h2d_host_ms": [c[2] * 1e3 for c in copies],
            "h2d_stream_ms": [c[0].elapsed_time(c[1]) for c in copies],
            "h2d_mb": [c[3] / 1e6 for c in copies]}


def phase_e2e_path() -> dict:
    """The production path end to end (bench.py:186-262): the port's
    loader (dataset get_item with elastic distortion, voxelization and
    chromatic augmentations, then the fused graph build, in two worker
    threads; batches copied to the card on the loader's side stream)
    feeding the SGD train step of Res16UNet34C (200 classes, conditioned
    weights). E2E_WARMUP steps, then E2E_STEPS timed steps, each synced.
    Every timed step's launches equal ``expected_launches`` of its batch
    (counts set to 0 just before the step and read just after); loss and
    grad norm finite; the masked-shift table's launches equal its
    sel_fwd and dw launches. Then the transfer check. The workers' get_item and
    graph-build times come from wrapping those two calls here."""
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa
    from languagegroundedsemseg_torch.ops import onehot_conv as oc
    from languagegroundedsemseg_torch.ops import shift_table as sto

    model = scaled_model("cuda")
    step, state = _train_setup(model)
    loader = e2e_loader("cuda")
    get_item = loader.dataset.get_item = _Timed(loader.dataset.get_item)
    build = loader.builder.build_host = _Timed(loader.builder.build_host)
    to_device, h2d_bytes = loader._to_device, []

    def counted_to_device(b):
        h2d_bytes.append(_host_bytes(b))
        return to_device(b)

    transfer = loader._to_device = _Timed(counted_to_device)

    t_first = time.perf_counter()
    it = iter(loader)
    first_batch_s = None
    for _ in range(E2E_WARMUP):
        b = next(it)
        if first_batch_s is None:
            first_batch_s = time.perf_counter() - t_first
        state, m = step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    iter_s, wait_s, step_s, losses, norms = [], [], [], [], []
    per_step_launches, voxels, caps = [], [], []
    totals = {"sel_fwd": 0, "csum": 0, "dw": 0}
    oa.reset_launch_counts()
    sto.reset_launch_counts()
    for i in range(E2E_STEPS):
        t0 = time.perf_counter()
        b = next(it)  # the workers build and copy ahead
        t1 = time.perf_counter()
        want = expected_launches(model, b.graph, train=True)
        oc.reset_launch_counts()
        state, m = step(state, b)
        loss, norm = float(m["loss"]), float(m["grad_norm"])  # syncs
        t2 = time.perf_counter()
        launches = dict(oc.launch_counts)
        _check_step_launches(launches, want, i)
        for k in totals:
            totals[k] += launches[k]
        iter_s.append(t2 - t0)
        wait_s.append(t1 - t0)
        step_s.append(t2 - t1)
        losses.append(loss)
        norms.append(norm)
        per_step_launches.append([launches["sel_fwd"], launches["csum"],
                                  launches["dw"]])
        voxels.append(int(b.graph.levels[0].valid.sum()))
        caps.append(b.graph.levels[0].capacity)
    peak = torch.cuda.max_memory_allocated()
    ablation_launches = dict(oa.launch_counts)
    t3_launches = dict(sto.launch_counts)
    if t3_launches != {"t3": totals["sel_fwd"] + totals["dw"]}:
        raise AssertionError(f"e2e masked-shift table launches {t3_launches}, "
                             f"expected sel_fwd + dw of {totals}")
    counters = loader.counters.snapshot()
    built = max(loader.counters.batches, 1)
    avg_scene_voxels = loader.counters.level_num_sum.get(0, 0) / built / E2E_BATCH
    it.close()  # stops the feeder and cancels the queued builds
    idle_ms = _idle_step_ms(step, state, b)
    if any(ablation_launches.values()):
        raise AssertionError(f"ablation kernels on the e2e path: "
                             f"{ablation_launches}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {norms}")

    check = transfer_check(step, state)
    q = E2E_STEPS // 4
    quarters = [sum(iter_s[j * q:(j + 1) * q]) for j in range(4)]
    rec = {"phase": "e2e_path", "scenes": E2E_SCENES,
           "points_per_scene": POINTS, "batch_size": E2E_BATCH,
           "num_workers": E2E_WORKERS, "warmup_steps": E2E_WARMUP,
           "steps": E2E_STEPS, "lr": TRAIN_LR,
           "e2e_scenes_per_sec": E2E_BATCH * E2E_STEPS / sum(iter_s),
           "e2e_spread": _spread(quarters),
           "e2e_avg_scene_voxels": avg_scene_voxels,
           "h2d_mb_per_batch": statistics.mean(h2d_bytes) / 1e6,
           "iter_ms_median": statistics.median(iter_s) * 1e3,
           "step_ms_median": statistics.median(step_s) * 1e3,
           "step_ms_runs": [t * 1e3 for t in step_s],
           "step_ms_loader_idle": idle_ms,
           "wait_ms_median": statistics.median(wait_s) * 1e3,
           "wait_ms_max": max(wait_s) * 1e3,
           "wait_ms_runs": [t * 1e3 for t in wait_s],
           "first_batch_s": first_batch_s,
           "worker_get_item": get_item.summary(),
           "worker_build": build.summary(),
           "worker_transfer_host": transfer.summary(),
           "loader_counters": counters,
           "max_memory_allocated": peak,
           "voxels": voxels, "level0_capacities": caps,
           "launches_per_step": per_step_launches,
           "launch_order": ["sel_fwd", "csum", "dw"],
           "launches": totals, "ablation_launches": ablation_launches,
           "t3_launches": t3_launches,
           "losses": losses, "grad_norms": norms,
           "transfer_check": check}
    emit(rec)
    return rec

# phase trainer_path: the flags of outputs/learning_curve_r5/config.json
# (Res16UNet34C, Synthetic200Voxelization2cmDataset: 16 scenes x 60,000
# points, 200 classes; batch 4, lr 0.05, SGD, MultiStepLR, 2 workers, seed
# 42) through the port's command line
LEARNING_CURVE_ARGV = [
    "--model", "Res16UNet34C", "--dataset", "Synthetic200Voxelization2cmDataset",
    "--batch_size", "4", "--val_batch_size", "4", "--lr", "0.05",
    "--optimizer", "SGD", "--scheduler", "MultiStepLR", "--num_workers", "2",
    "--num_val_workers", "2", "--seed", "42", "--stat_freq", "4"]
TRAINER_EPOCHS = 2


def _recording_trainer():
    """A ``Trainer`` that keeps, for each of its train and eval steps, the
    launches ``expected_launches`` gives for that step's batch, the step's
    loss and the times the steps, validations and checkpoint saves end
    (each train step synced), without changing what runs."""
    from languagegroundedsemseg_torch.train.trainer import Trainer

    class RecordingTrainer(Trainer):
        instances = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            RecordingTrainer.instances.append(self)
            self.want = {"sel_fwd": 0, "csum": 0, "dw": 0}
            self.n_train = self.n_eval = self.n_eval_metrics = 0
            self.losses, self.step_s, self.val_s, self.coins = [], [], [], []
            self._mark = None
            train, evaluate, save = self.p_train_step, self.p_eval_step, self.ckpt.save

            def train_step(state, batch, gen):
                for k, v in expected_launches(self.model, batch.graph, True).items():
                    self.want[k] += v
                out = train(state, batch, gen)
                self.last_batch = batch
                self.losses.append(float(out[1]["loss"]))  # syncs
                now = time.perf_counter()
                self.step_s.append(now - self._mark)
                self._mark = now
                self.n_train += 1
                return out

            def eval_step(batch):
                for k, v in expected_launches(self.model, batch.graph).items():
                    self.want[k] += v
                self.n_eval += 1
                return evaluate(batch)

            def ckpt_save(*args, **kwargs):
                save(*args, **kwargs)
                self._mark = time.perf_counter()

            self.raw_train_step = train
            self.p_train_step, self.p_eval_step = train_step, eval_step
            self.ckpt.save = ckpt_save
            draw = getattr(self.model, "draw_coin", None)
            if draw is not None:
                def draw_coin(gen):
                    coin = draw(gen)
                    self.coins.append(coin)
                    return coin

                self.model.draw_coin = draw_coin
            crf = getattr(self.model, "crf", None)
            self.crf0 = (None if crf is None
                         else crf.compatibility.detach().clone())

        def _eval_metrics_fn(self, *args, **kwargs):
            self.n_eval_metrics += 1
            return super()._eval_metrics_fn(*args, **kwargs)

        def validate(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().validate(*args, **kwargs)
            torch.cuda.synchronize()
            self._mark = time.perf_counter()
            self.val_s.append(self._mark - t0)
            return out

        def fit(self, *args, **kwargs):
            t0 = self._mark = time.perf_counter()
            out = super().fit(*args, **kwargs)
            torch.cuda.synchronize()
            self.fit_s = time.perf_counter() - t0
            return out

    return RecordingTrainer


def _checked_restore(restore, log):
    """``restore_checkpoint`` that then holds the restored model and
    optimizer to the checkpoint's tensors (``torch.equal``)."""

    def checked(path, template):
        state = restore(path, template)
        blob = torch.load(path, map_location=next(state.model.parameters()).device,
                          weights_only=True)
        for k, v in blob["model"].items():
            if not torch.equal(state.model.state_dict()[k], v):
                raise AssertionError(f"resume: model tensor {k} differs")
        got = state.optimizer.inner.state_dict()["state"]
        for i, st in blob["optimizer"]["state"].items():
            for k, v in st.items():
                if not torch.equal(got[i][k], v):
                    raise AssertionError(f"resume: optimizer {i}.{k} differs")
        log.update(path=os.path.basename(path), step=state.step,
                   updates=state.optimizer.updates,
                   tensors_equal=len(blob["model"]) + sum(
                       len(st) for st in blob["optimizer"]["state"].values()))
        return state

    return checked


def _trainer_run(name: str, argv: list, epochs: int, monitors: tuple,
                 resumed: dict = None, keep_state: bool = False,
                 patches: tuple = (), extra=None) -> dict:
    """One ``cli.main.main(argv)`` on the card with every launch count set
    to 0 just before it, checked just after against the launches of every
    train step and eval forward it ran (the contrastive loss's node: one
    forward and one backward a representation train step, one forward a
    validation batch's loss, none in another mode; the masked-shift table:
    one beside each sel_fwd and dw). ``argv`` trains to epoch
    ``epochs``: the state must end at ``epochs`` x len(train_loader)
    steps, with a record for each epoch this run trained. ``keep_state``
    adds the final state dict (on the CPU) under ``"state"``; ``patches``
    are entered around the run; ``extra(trainer)`` adds its fields."""
    from languagegroundedsemseg_torch.cli.main import main as cli_main
    from languagegroundedsemseg_torch.ops import contrastive as ocn
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa
    from languagegroundedsemseg_torch.ops import onehot_conv as oc
    from languagegroundedsemseg_torch.ops import shift_table as sto
    from languagegroundedsemseg_torch.train import trainer as trainer_mod

    recording = _recording_trainer()
    patches = [mock.patch.object(trainer_mod, "Trainer", recording), *patches]
    if resumed is not None:
        patches.append(mock.patch.object(
            trainer_mod, "restore_checkpoint",
            _checked_restore(trainer_mod.restore_checkpoint, resumed)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    oc.reset_launch_counts()
    oa.reset_launch_counts()
    ocn.reset_launch_counts()
    sto.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        test_metrics = cli_main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, ablation = dict(oc.launch_counts), dict(oa.launch_counts)
    contrast = dict(ocn.launch_counts)
    t3 = dict(sto.launch_counts)
    (tr,) = recording.instances
    log_dir = tr.log_dir
    per_epoch = len(tr.train_loader)
    want_step = epochs * per_epoch
    first_epoch = 0
    if resumed is not None:
        if "step" not in resumed:
            raise AssertionError(f"{name}: no checkpoint was restored")
        first_epoch = resumed["step"] // per_epoch

    if launches != tr.want:
        raise AssertionError(f"{name}: launches {launches}, expected {tr.want} "
                             f"({tr.n_train} train steps, {tr.n_eval} eval forwards)")
    if min(launches.values()) == 0 or any(ablation.values()):
        raise AssertionError(f"{name}: launches {launches}, ablation {ablation}")
    node = tr.mode == "representation"
    want_contrast = {"contrast_fwd": tr.n_train + tr.n_eval_metrics if node else 0,
                     "contrast_bwd": tr.n_train if node else 0}
    if contrast != want_contrast:
        raise AssertionError(f"{name}: contrastive launches {contrast}, expected "
                             f"{want_contrast} ({tr.n_train} train steps, "
                             f"{tr.n_eval_metrics} validation losses)")
    if t3 != {"t3": launches["sel_fwd"] + launches["dw"]}:
        raise AssertionError(f"{name}: masked-shift table launches {t3}, "
                             f"expected sel_fwd + dw of {launches}")
    if tr.state.step != want_step:
        raise AssertionError(f"{name}: step {tr.state.step}, expected {want_step}")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epoch_recs = [r for r in recs if r["phase"] == "epoch"]
    logged = [r["loss"] for r in recs if r["phase"] == "train"]
    if [r["epoch"] for r in epoch_recs] != list(range(first_epoch, epochs)):
        raise AssertionError(f"{name}: epoch records {epoch_recs}")
    for r in epoch_recs:
        if not (0.0 <= r["val_miou"] <= 1.0 and np.isfinite(r["val_loss"])
                and np.isfinite(r["train_loss"])):
            raise AssertionError(f"{name}: epoch record {r}")
    if not (logged and np.isfinite(logged + tr.losses).all()):
        raise AssertionError(f"{name}: losses {tr.losses}, logged {logged}")
    files = sorted(os.listdir(log_dir))
    for prefix in (f"last_step={want_step}.ckpt",) + tuple(
            f"best_{m}=" for m in monitors):
        if not any(f.startswith(prefix) and f.endswith(".ckpt") for f in files):
            raise AssertionError(f"{name}: no {prefix}* checkpoint in {files}")
    if not 0.0 <= test_metrics["val_miou"] <= 1.0:
        raise AssertionError(f"{name}: test pass {test_metrics}")

    batch = tr.config.batch_size
    after_first = tr.step_s[1:]
    return {"run": name, "mode": tr.mode, "steps": tr.n_train,
            "state_step": tr.state.step, "epochs": len(epoch_recs),
            "steps_per_epoch": per_epoch,
            "eval_forwards": tr.n_eval, "main_s": main_s, "fit_s": tr.fit_s,
            "scenes_per_s": batch * len(after_first) / sum(after_first),
            "step_s": tr.step_s, "val_s": tr.val_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "loader_counters": tr.train_loader.counters.snapshot(),
            "first_loss": tr.losses[0], "last_loss": tr.losses[-1],
            "losses": tr.losses,
            "epoch_records": [{k: r[k] for k in ("epoch", "step", "train_loss",
                                                 "val_miou", "val_loss", "time_s")}
                              for r in epoch_recs],
            "test_metrics": {k: test_metrics[k] for k in ("val_miou", "val_loss")},
            "checkpoints": [f for f in files if f.endswith(".ckpt")],
            "launches": launches, "expected_launches": tr.want,
            "ablation_launches": ablation, "contrast_launches": contrast,
            "t3_launches": t3,
            **({"resumed": resumed} if resumed is not None else {}),
            **(extra(tr) if extra is not None else {}),
            **({"state": {k: v.detach().cpu().clone()
                          for k, v in tr.model.state_dict().items()}}
               if keep_state else {})}


def phase_trainer_path() -> dict:
    """The training program a user runs, on the card: ``cli.main.main``
    parses the learning-curve flags into the port's Trainer, which trains
    TRAINER_EPOCHS epochs from the production loader, validates each
    epoch (mIoU, mAP), writes checkpoints, then runs the test pass.
    (a) the baseline: CE with the config's balanced category sampling;
    (b) the language-grounded pretraining: the same flags plus
    ``--use_embedding_loss contrastive`` against the dataset's seeded
    512-d anchors, on the reference's pretraining model, Res16UNet34D
    (PLANES[-1] = 512: 34C's 96-d features cannot meet the anchors; the
    reference's scripts/text_representation_train.sh pairs the two);
    (c) ``--resume`` of (a) one epoch further, its restored
    tensors held equal to the checkpoint's. Each run's launches equal the
    sum over its train steps and eval forwards of ``expected_launches``;
    (b)'s contrastive loss takes the node of ``ops/contrastive.py``."""
    with tempfile.TemporaryDirectory(prefix="lgs_trainer_path_") as tmp:
        a_dir, b_dir, c_dir = (os.path.join(tmp, n) for n in "abc")
        n = TRAINER_EPOCHS
        runs = [
            _trainer_run("baseline", LEARNING_CURVE_ARGV + [
                "--max_epoch", str(n), "--log_dir", a_dir], n, ("val_miou",),
                keep_state=True),
            _trainer_run("language_grounded", LEARNING_CURVE_ARGV + [
                "--max_epoch", str(n), "--model", "Res16UNet34D",
                "--use_embedding_loss", "contrastive", "--log_dir", b_dir],
                n, ("val_miou", "val_loss")),
            _trainer_run("resume", LEARNING_CURVE_ARGV + [
                "--max_epoch", str(n + 1), "--resume", a_dir,
                "--log_dir", c_dir], n + 1, ("val_miou",), resumed={}),
        ]
    if runs[1]["mode"] != "representation" or runs[0]["mode"] != "baseline":
        raise AssertionError(f"modes {[r['mode'] for r in runs]}")
    baseline_state = runs[0].pop("state")
    totals = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    rec = {"phase": "trainer_path", "argv": LEARNING_CURVE_ARGV, "runs": runs,
           "launches": totals,
           "ablation_launches": {k: sum(r["ablation_launches"][k] for r in runs)
                                 for k in runs[0]["ablation_launches"]},
           "contrast_launches": {k: sum(r["contrast_launches"][k] for r in runs)
                                 for k in runs[0]["contrast_launches"]},
           "t3_launches": {"t3": sum(r["t3_launches"]["t3"] for r in runs)}}
    emit(rec)
    rec["baseline_state"] = baseline_state  # for phase ddp_path; not printed
    return rec


# phase insseg_path: the flags of scripts/train_insseg.sh through the
# port's command line (InstanceRes16UNet = Res16UNet34C + the offset head,
# the Scannet200 head, batch 4, lr 0.02, SGD, 2 workers, seed 42),
# INSSEG_STEPS steps, then the CLI's validation of every val scene
INSSEG_ARGV = [
    "--dataset", "Scannet200Instance2cmDataset", "--model", "InstanceRes16UNet",
    "--batch_size", "4", "--lr", "0.02", "--optimizer", "SGD",
    "--num_workers", "2", "--seed", "42"]
INSSEG_STEPS = 12  # --max_iter
# the synthetic stand-in for the ScanNet200 .pth scenes: trainer_path's
# scene count and size
INSSEG_SCENES, INSSEG_POINTS = 8, 60_000
INSSEG_LOSSES = ("semantic_loss", "offset_norm_loss", "offset_dir_loss")
# radius_graph_device on the card: at most this many of a scene's voxels
RADIUS_GRAPH_POINTS = 4096


def insseg_dataset(points: int = None):
    """The port's SyntheticInstanceDataset at the Scannet200 head (200
    classes), INSSEG_SCENES scenes of ``points`` (INSSEG_POINTS) points."""
    from languagegroundedsemseg_torch.insseg.dataset import SyntheticInstanceDataset

    class Synthetic200Instance(SyntheticInstanceDataset):
        NUM_CLASSES = 200
        NUM_SCENES = INSSEG_SCENES
        POINTS_PER_SCENE = points or INSSEG_POINTS

    return Synthetic200Instance


def _recording_insseg_trainer():
    """An ``InssegTrainer`` that keeps, for each of its train steps and
    eval forwards, the launches ``expected_launches`` gives for that
    batch, each step's losses and time (from the previous step's or the
    fit's start to the step's synced end), and each validation's split:
    the card (eval forward, synced), the host clustering, the instance
    evaluation, and the rest (scene load, graph build, back-projection).
    The CLI's fit never validates (its ``val_every`` is 0, as in the JAX
    CLI); this fit validates once, at its last step, so the dual-monitor
    checkpoints are written. Nothing else changes what runs."""
    from languagegroundedsemseg_torch.insseg import trainer as insseg_trainer

    class RecordingInssegTrainer(insseg_trainer.InssegTrainer):
        instances = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            RecordingInssegTrainer.instances.append(self)
            self.want = {"sel_fwd": 0, "csum": 0, "dw": 0}
            self.step_want, self.eval_want = [], []  # each batch's share
            self.n_train = self.n_eval = 0
            self.losses = {}  # the step's metrics: the losses and grad_norm
            self.step_s, self.val_records = [], []
            self._mark, self._split = None, None
            train, evaluate = self.p_train_step, self.p_eval
            cluster = self.clusterer.get_instances

            def train_step(state, batch):
                want = expected_launches(self.model, batch.graph, True)
                for k, v in want.items():
                    self.want[k] += v
                self.step_want.append(want)
                out = train(state, batch)
                for k, v in out[1].items():
                    self.losses.setdefault(k, []).append(float(v))  # syncs
                now = time.perf_counter()
                self.step_s.append(now - self._mark)
                self._mark = now
                self.n_train += 1
                return out

            def eval_step(batch):
                t0 = time.perf_counter()
                batch = batch.to(self.device)
                want = expected_launches(self.model, batch.graph)
                for k, v in want.items():
                    self.want[k] += v
                self.eval_want.append(want)
                out = evaluate(batch)
                torch.cuda.synchronize()
                self._split["card_s"] += time.perf_counter() - t0
                self.n_eval += 1
                return out

            def get_instances(vertices, scores):
                t0 = time.perf_counter()
                out = cluster(vertices, scores)
                self._split["cluster_s"] += time.perf_counter() - t0
                self._split["proposals"].append(len(out))
                self._split["voxels"].append(len(vertices))
                return out

            self.p_train_step, self.p_eval = train_step, eval_step
            self.clusterer.get_instances = get_instances

        def validate(self, *args, **kwargs):
            self._split = {"card_s": 0.0, "cluster_s": 0.0, "evaluate_s": 0.0,
                           "proposals": [], "voxels": []}
            evaluate = insseg_trainer.InstanceEvaluator.evaluate

            def timed(ev):
                t0 = time.perf_counter()
                out = evaluate(ev)
                self._split["evaluate_s"] += time.perf_counter() - t0
                return out

            t0 = time.perf_counter()
            with mock.patch.object(insseg_trainer.InstanceEvaluator, "evaluate", timed):
                out = super().validate(*args, **kwargs)
            total = time.perf_counter() - t0
            sp = self._split
            host = total - sp["card_s"]
            self.val_records.append({
                "metrics": out, "s": total, "card_s": sp["card_s"],
                "host_s": host, "host_share": host / total,
                "cluster_s": sp["cluster_s"], "evaluate_s": sp["evaluate_s"],
                "load_build_backproject_s": host - sp["cluster_s"] - sp["evaluate_s"],
                "scenes": len(sp["voxels"]), "voxels": sp["voxels"],
                "proposals": sp["proposals"],
                "proposals_per_scene": (float(np.mean(sp["proposals"]))
                                        if sp["proposals"] else 0.0)})
            self._mark = time.perf_counter()
            return out

        def fit(self, max_steps: int = 100, log_every: int = 10, val_every: int = 0,
                max_val_scenes=None):
            t0 = self._mark = time.perf_counter()
            out = super().fit(max_steps, log_every, val_every or max_steps, max_val_scenes)
            torch.cuda.synchronize()
            self.fit_s = time.perf_counter() - t0
            return out

    return RecordingInssegTrainer


def insseg_parity_batch(device):
    """One val scene of INSSEG's synthetic dataset at PARITY_POINTS points
    (no augmentation), built at PARITY_CAP with the instance extras."""
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.insseg.trainer import insseg_extras
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec

    ds = insseg_dataset(PARITY_POINTS)(Config(ignore_label=255), phase="val",
                                       augment_data=False)
    item = ds.get_item(0, np.random.default_rng(1))
    feats = item["feats"] / 255.0 - 0.5
    builder = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=PARITY_CAP)
    batch = builder.build([(item["coords"], feats, item["labels"])],
                          [insseg_extras(item)], device=device)
    return batch, ds.VOXEL_SIZE


def _insseg_step(model, device, noise_seed=None):
    """Outputs and losses of the parity batch through ``model``: the eval
    forward's (offsets, logits), then one insseg SGD step's train-mode
    forward (caught by a hook) and losses. ``noise_seed`` moves the input
    features by 1e-6, relative, drawn from that seed."""
    from languagegroundedsemseg_torch.insseg.trainer import (
        make_insseg_eval_step,
        make_insseg_objective,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_train_step

    batch, voxel_size = insseg_parity_batch(device)
    if noise_seed is not None:
        dev = batch.feats.device
        gen = torch.Generator(device=dev).manual_seed(noise_seed)
        noise = torch.randn(batch.feats.shape, generator=gen, device=dev)
        batch = batch.replace(feats=batch.feats * (1 + 1e-6 * noise))
    valid = batch.graph.levels[0].valid.cpu() > 0
    offsets, probs, _ = make_insseg_eval_step(model, 200, device=device)(batch)
    out = {"eval_offsets": offsets.cpu()[valid], "eval_probs": probs.cpu()[valid]}
    opt = sgd_torch(model.parameters(), 0.02)
    step = make_train_step(model, opt, make_insseg_objective(voxel_size), device=device)
    caught = []
    hook = model.register_forward_hook(lambda _m, _i, o: caught.append(o))
    try:
        _, parts = step(TrainState(model, opt), batch)
    finally:
        hook.remove()
    (train_offsets, train_logits, _), = caught
    out.update(train_offsets=train_offsets.detach().cpu()[valid],
               train_logits=train_logits.detach().cpu()[valid],
               **{k: float(v) for k, v in parts.items()})
    return out


def _insseg_gap(a, b) -> dict:
    """Relative gaps of ``a`` against ``b``: L2 for the outputs, |Δ| / |b|
    for the losses."""
    return {k: (_rel_l2(a[k], b[k]) if torch.is_tensor(b[k])
                else abs(a[k] - b[k]) / abs(b[k])) for k in b}


def insseg_card_vs_cpu() -> dict:
    """One insseg train step on the card against the CPU's plain path:
    InstanceRes16UNet with conditioned weights, the parity batch.

    The train-mode forward of these weights is chaotic: batch statistics
    renormalize every layer, so a rounding difference grows with depth,
    and a 1e-6 relative change of the input features moves the card's
    train-mode offsets and logits by ~2e-2 and its offset losses by
    ~1e-4 (the semantic Res16UNet34C does the same; PERF.md §6).
    So the phase holds to the parity tolerances what these weights let
    one hold: the eval forward's offsets and softmax probabilities, and
    the step's semantic and total losses. The step's train-mode offsets
    and logits and its offset-norm and direction losses are held to twice
    the largest gap that 1e-6 input noise (three draws) makes on the card
    itself, or the tolerance where that is larger."""
    from languagegroundedsemseg_torch.insseg.model import InstanceRes16UNet

    base = scaled_model("cuda", model_cls=InstanceRes16UNet)
    t0 = time.perf_counter()
    card = _insseg_step(copy.deepcopy(base), "cuda")
    cpu = _insseg_step(copy.deepcopy(base).to("cpu"), "cpu")
    gaps = [_insseg_gap(_insseg_step(copy.deepcopy(base), "cuda", seed), card)
            for seed in range(3)]
    noise = {k: max(g[k] for g in gaps) for k in gaps[0]}
    gap = _insseg_gap(card, cpu)
    limit = {"eval_offsets": PARITY_RTOL, "eval_probs": PARITY_RTOL,
             "semantic_loss": TRAIN_LOSS_RTOL, "loss": TRAIN_LOSS_RTOL}
    for k in ("train_offsets", "train_logits"):
        limit[k] = max(PARITY_RTOL, 2 * noise[k])
    for k in ("offset_norm_loss", "offset_dir_loss"):
        limit[k] = max(TRAIN_LOSS_RTOL, 2 * noise[k])
    rec = {"capacity": PARITY_CAP, "n_voxels": int(card["eval_offsets"].shape[0]),
           "losses": {k: card[k] for k in INSSEG_LOSSES + ("loss",)},
           "card_vs_cpu": gap, "card_input_noise_1e-6": noise, "limits": limit,
           "seconds": time.perf_counter() - t0}
    if not all(gap[k] <= limit[k] for k in limit):
        raise AssertionError(f"insseg card vs CPU out of tolerance: {rec}")
    return rec


def cluster_ops_on_card(ds) -> dict:
    """The device cluster ops on the card, on val scene 0 (no
    augmentation): connected_components over its radius_graph_host table
    (as wide as its largest neighborhood, so nothing is truncated) gives
    scipy's partition; radius_graph_device on RADIUS_GRAPH_POINTS of its
    voxels equals its CPU run; FPS over its largest instance equals the
    CPU's."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as scipy_components

    from languagegroundedsemseg_torch.ops import cluster as oc_cluster
    from languagegroundedsemseg_torch.ops.points import furthest_point_sample

    item = ds.get_item(0, np.random.default_rng((999, 0)))
    pts = item["coords"].astype(np.float32) * ds.VOXEL_SIZE
    lab = item["labels"]
    n = len(pts)
    edges = oc_cluster.radius_edges_host(pts, 0.03, lab)
    degree = int(np.bincount(edges.ravel(), minlength=n).max())
    table = oc_cluster.radius_graph_host(pts, 0.03, degree, lab)
    t0 = time.perf_counter()
    comp = oc_cluster.connected_components(
        torch.from_numpy(table).cuda(), torch.ones(n, dtype=torch.int32).cuda())
    torch.cuda.synchronize()
    cc_s = time.perf_counter() - t0
    _, sc = scipy_components(coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                                        shape=(n, n)), directed=False)
    root = np.full(sc.max() + 1, n)
    np.minimum.at(root, sc, np.arange(n))  # each component's lowest row
    comp = comp.cpu().numpy()
    partition_equal = bool((comp == root[sc]).all())

    sub = torch.from_numpy(pts[:RADIUS_GRAPH_POINTS])
    sub_lab = torch.from_numpy(lab[:RADIUS_GRAPH_POINTS].astype(np.int64))
    rg_card = oc_cluster.radius_graph_device(sub.cuda(), sub_lab.cuda(), None, 32)
    rg_cpu = oc_cluster.radius_graph_device(sub, sub_lab, None, 32)
    rg_equal = bool(torch.equal(rg_card.cpu(), rg_cpu))

    inst = item["original"]["instance"]
    ids, counts = np.unique(inst[inst >= 0], return_counts=True)
    obj = item["original"]["xyz"][inst == ids[np.argmax(counts)]]
    k = max(len(obj) // 10, 1)
    fps_card = furthest_point_sample(torch.from_numpy(obj).cuda(), k)
    fps_cpu = furthest_point_sample(torch.from_numpy(obj), k)
    fps_equal = bool(torch.equal(fps_card.cpu(), fps_cpu))
    rec = {"voxels": n, "edges": len(edges), "max_degree": degree,
           "components": int(sc.max() + 1), "connected_components_s": cc_s,
           "partition_equal_scipy": partition_equal,
           "radius_graph_points": len(sub), "radius_graph_equal_cpu": rg_equal,
           "radius_graph_edges": int((rg_cpu >= 0).sum()),
           "fps_points": len(obj), "fps_samples": k, "fps_equal_cpu": fps_equal}
    if not (partition_equal and rg_equal and fps_equal):
        raise AssertionError(f"device cluster ops disagree with the host: {rec}")
    return rec


def phase_insseg_path() -> dict:
    """Instance segmentation as a user runs it, on the card:
    ``cli.main.main`` with scripts/train_insseg.sh's flags routes the
    Scannet200 instance dataset (here its synthetic stand-in, patched into
    the port's registry) to ``InssegTrainer``: INSSEG_STEPS SGD steps of
    InstanceRes16UNet from the production loader, then validation of
    every val scene (eval forward on the card; vote shift, clustering and
    the ScanNet instance evaluator on the host). Launches equal the sum of
    ``expected_launches`` over every train step and eval forward; losses
    finite; both best checkpoints load with ``weights_only=True``. Then
    one insseg train step card vs CPU, and the device cluster ops against
    the host."""
    from languagegroundedsemseg_torch.config import Config

    synthetic = insseg_dataset()
    rec = {"phase": "insseg_path", "argv": INSSEG_ARGV,
           "dataset": {"scenes": INSSEG_SCENES, "points_per_scene": INSSEG_POINTS,
                       "classes": 200},
           **_insseg_cli_run(INSSEG_ARGV, INSSEG_STEPS, synthetic)}
    rec["card_vs_cpu"] = insseg_card_vs_cpu()
    rec["cluster_ops"] = cluster_ops_on_card(
        synthetic(Config(ignore_label=255), phase="val", augment_data=False))
    emit(rec)
    return rec


def _insseg_cli_run(argv: list, steps: int, synthetic=None) -> dict:
    """``cli.main.main(argv)`` for ``steps`` steps on the instance dataset
    (``synthetic``, insseg_dataset() when None, patched in as the
    Scannet200 instance dataset) with the recording InssegTrainer: the
    launches of every train step and eval forward checked, the losses
    finite, the two validations (the fit's at its last step and the
    CLI's) over every val scene, both best checkpoints written."""
    from languagegroundedsemseg_torch.cli.main import main as cli_main
    from languagegroundedsemseg_torch.insseg import dataset as insseg_dataset_mod
    from languagegroundedsemseg_torch.insseg import trainer as insseg_trainer
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    recording = _recording_insseg_trainer()
    synthetic = synthetic or insseg_dataset()
    with tempfile.TemporaryDirectory(prefix="lgs_insseg_path_") as tmp:
        argv = argv + ["--max_iter", str(steps), "--log_dir", tmp]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        oc.reset_launch_counts()
        oa.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(insseg_trainer, "InssegTrainer", recording), \
                mock.patch.dict(insseg_dataset_mod._INSTANCE_DATASETS,
                                {"Scannet200Instance2cmDataset": synthetic}):
            metrics = cli_main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches, ablation = dict(oc.launch_counts), dict(oa.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        (tr,) = recording.instances
        files = sorted(os.listdir(tmp))
        best = {}
        for monitor in ("val_miou", "val_map05"):
            found = [f for f in files if f.startswith(f"best_{monitor}=")
                     and f.endswith(".ckpt")]
            if not found:
                raise AssertionError(f"insseg: no best_{monitor} checkpoint in {files}")
            blob = torch.load(os.path.join(tmp, found[0]), map_location="cpu",
                              weights_only=True)
            best[monitor] = {"file": found[0], "step": int(blob["step"]),
                             "tensors": len(blob["model"])}

    if launches != tr.want:
        raise AssertionError(f"insseg: launches {launches}, expected {tr.want} "
                             f"({tr.n_train} train steps, {tr.n_eval} eval forwards)")
    if min(launches.values()) == 0 or any(ablation.values()):
        raise AssertionError(f"insseg: launches {launches}, ablation {ablation}")
    if tr.state.step != steps or tr.n_train != steps:
        raise AssertionError(f"insseg: step {tr.state.step}, {tr.n_train} train steps")
    if not all(np.isfinite(v).all() for v in tr.losses.values()):
        raise AssertionError(f"insseg: losses {tr.losses}")
    n_val = len(tr.val_dataset)
    if [r["scenes"] for r in tr.val_records] != [n_val, n_val]:
        raise AssertionError(f"insseg: validations {tr.val_records}")
    if not 0.0 <= metrics["val_miou"] <= 1.0:
        raise AssertionError(f"insseg: metrics {metrics}")

    after_first = tr.step_s[1:]
    return {"dtype": str(tr.model.dtype),
            "steps": tr.n_train, "eval_forwards": tr.n_eval, "main_s": main_s,
            "fit_s": tr.fit_s,
            "scenes_per_s": tr.config.batch_size * len(after_first) / sum(after_first),
            "step_s": tr.step_s, "validations": tr.val_records,
            "validate_s": tr.val_records[-1]["s"],
            "validate_host_share": tr.val_records[-1]["host_share"],
            "fit_validation_equals_cli": all(
                np.isclose(v, metrics[k], rtol=0, atol=0, equal_nan=True)
                for k, v in tr.val_records[0]["metrics"].items()),
            "max_memory_allocated": peak,
            "first_losses": {k: v[0] for k, v in tr.losses.items()},
            "last_losses": {k: v[-1] for k, v in tr.losses.items()},
            "metrics": metrics, "best_checkpoints": best,
            "loader_counters": tr.train_loader.counters.snapshot(),
            "launches": launches, "expected_launches": tr.want,
            "expected_per_train_step": tr.step_want,
            "expected_per_eval_forward": tr.eval_want,
            "ablation_launches": ablation}


# ---- phase ddp_path: data parallelism ------------------------------------
# One H100: NCCL refuses two ranks on one device, so (a) runs the CLI as
# rank 0 of a world of 1 over NCCL, and (b)-(d) run two ranks on cuda:0
# over gloo. They check correctness and measure the overhead of the ranks'
# traffic; two ranks sharing one card say nothing of scaling across cards.
DDP_WORLD = 2
DDP_INSSEG_STEPS = 4
# the ranks' gloo group gives up on a collective after this long
DDP_TIMEOUT_S = 600
# the all-reduced validation against one process's (argmax ties can flip
# where the two runs' capacities route a conv through another path)
DDP_MIOU_ATOL = 1e-3
# threads a rank's CPU half of (c) takes: two ranks share the cores
DDP_CPU_THREADS = 4


def _state_gap(a: dict, b: dict) -> dict:
    """Bit-equality and the largest |a - b| over two state dicts."""
    diff = max(float((a[k].double() - b[k].double()).abs().max()) for k in b)
    return {"bit_equal": all(torch.equal(a[k], b[k]) for k in b),
            "max_abs_diff": diff, "tensors": len(b)}


def _ddp_world_one(trainer_rec: dict) -> dict:
    """(a) ``cli.main`` as rank 0 of a world of one over NCCL, with
    torchrun's environment, the group on a ``file://`` store: trainer_path
    run (a)'s flags. Held against that run: launches (as every run), the
    first step's loss; the later losses, val_miou and final parameters are
    reported with their gaps. (The port's scatter sums run through
    ``index_add_``, whose float atomics add in another order on each run,
    so two runs of the same program need not agree bit for bit; 16 SGD
    steps at lr 0.05 can grow such a difference.)"""
    import torch.distributed as dist

    base = trainer_rec["runs"][0]
    with tempfile.TemporaryDirectory(prefix="lgs_ddp_a_") as tmp, \
            mock.patch.dict(os.environ, {"RANK": "0", "WORLD_SIZE": "1",
                                         "LOCAL_RANK": "0"}):
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            probe = torch.ones(4, device="cuda")
            dist.all_reduce(probe)
            torch.cuda.synchronize()
            run = _trainer_run("world1_nccl", LEARNING_CURVE_ARGV + [
                "--max_epoch", str(TRAINER_EPOCHS), "--log_dir", f"{tmp}/log"],
                TRAINER_EPOCHS, ("val_miou",), keep_state=True)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    state = run.pop("state")
    gap = _state_gap(state, trainer_rec["baseline_state"])
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(run["losses"], base["losses"])]
    rec = {"backend": backend, "nccl_all_reduce": probe.tolist(),
           "steps": run["steps"], "scenes_per_s": run["scenes_per_s"],
           "trainer_path_scenes_per_s": base["scenes_per_s"], "fit_s": run["fit_s"],
           "max_memory_allocated": run["max_memory_allocated"],
           "losses": run["losses"], "loss_rel_gaps": loss_gaps,
           "val_miou": run["test_metrics"]["val_miou"],
           "trainer_path_val_miou": base["test_metrics"]["val_miou"],
           "params_vs_trainer_path": gap,
           "bit_equal": gap["bit_equal"] and run["losses"] == base["losses"],
           "launches": run["launches"]}
    if probe.tolist() != [1.0] * 4 or backend != "nccl":
        raise AssertionError(f"ddp (a): NCCL group of one {rec}")
    if run["steps"] != base["steps"] or loss_gaps[0] > TRAIN_LOSS_RTOL:
        raise AssertionError(f"ddp (a): against trainer_path (a) {rec}")
    return rec


def parity_shards():
    """The parity scene (``parity_batch``'s) split at its median x into
    two shards, one for each rank."""
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene

    coords, feats, labels = voxelize_scene(np.random.default_rng(1), PARITY_POINTS)
    left = coords[:, 0] < np.median(coords[:, 0])
    return [(coords[m], feats[m], labels[m]) for m in (left, ~left)]


def _ddp_parity_step(rank, group, device, relu) -> tuple:
    """(loss, grads, state after) of one two-rank SGD step of the
    conditioned Res16UNet34C on this rank's parity shard, BN synced."""
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.models.layers import convert_sync_batchnorm
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_train_step

    model = convert_sync_batchnorm(scaled_model(device), group)
    opt = sgd_torch(model.parameters(), TRAIN_LR)
    batch = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=PARITY_CAP).build(
        [parity_shards()[rank]], device=device)
    with mock.patch.object(torch, "relu", relu):
        _, m = make_train_step(model, opt, train_objective, device=device,
                               group=group)(TrainState(model, opt), batch)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    after = {n: t.detach().cpu() for n, t in model.state_dict().items()}
    return float(m["loss"]), grads, after


def _ddp_cli_run(argv, recording, patches=()) -> tuple:
    """``cli.main.main(argv)`` on cuda:0 in this rank with ``recording``
    patched in (launch counts set to 0 just before, read just after):
    (the trainer, its metrics, launches, seconds, peak memory)."""
    from languagegroundedsemseg_torch.cli.main import main as cli_main
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    oc.reset_launch_counts()
    oa.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        metrics = cli_main(argv, device="cuda:0")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    (tr,) = recording.instances
    launches = dict(oc.launch_counts)
    if any(oa.launch_counts.values()):
        raise AssertionError(f"ablation kernels in a DDP run: {dict(oa.launch_counts)}")
    return tr, metrics, launches, seconds, torch.cuda.max_memory_allocated()


def _ddp_rank(rank: int, tmp: str) -> None:
    """One of the DDP_WORLD ranks of (b)-(d), on cuda:0 over gloo; writes
    its records to ``tmp``/rank<k>.pt (states as CPU tensors)."""
    import datetime

    import torch.distributed as dist

    from languagegroundedsemseg_torch.insseg import dataset as insseg_dataset_mod
    from languagegroundedsemseg_torch.insseg import trainer as insseg_trainer
    from languagegroundedsemseg_torch.train import trainer as trainer_mod

    set_numerics()
    torch.set_num_threads(DDP_CPU_THREADS)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DDP_WORLD), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=DDP_WORLD,
                            timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S))
    out = {}
    try:
        group = dist.group.WORLD
        # (b) the learning-curve flags across two ranks
        recording = _recording_trainer()
        tr, metrics, launches, seconds, peak = _ddp_cli_run(
            LEARNING_CURVE_ARGV + ["--max_epoch", str(TRAINER_EPOCHS),
                                   "--num_devices", str(DDP_WORLD),
                                   "--log_dir", f"{tmp}/b"],
            recording, [mock.patch.object(trainer_mod, "Trainer", recording)])
        after_first = tr.step_s[1:]
        out["b"] = {
            "rank": tr.rank, "world": tr.world, "steps": tr.n_train,
            "eval_forwards": tr.n_eval, "main_s": seconds, "fit_s": tr.fit_s,
            "val_s": tr.val_s, "step_s": tr.step_s,
            "scenes_per_s": tr.config.batch_size * len(after_first) / sum(after_first),
            "max_memory_allocated": peak, "losses": tr.losses,
            "first_loss": tr.losses[0], "last_loss": tr.losses[-1],
            "val_miou": metrics["val_miou"], "val_loss": metrics["val_loss"],
            "steps_per_epoch": len(tr.train_loader),
            "launches": launches, "expected_launches": tr.want,
            "state": {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}}
        del tr
        # (c) one two-rank step on the card and on the CPU, same group
        for tag, relu in (("model", torch.relu), ("relu_free", lambda x: x)):
            out.setdefault("c", {})[tag] = {
                dev: _ddp_parity_step(rank, group, dev, relu) for dev in ("cuda", "cpu")}
        # (d) instance segmentation: train_insseg.sh's flags, DDP_INSSEG_STEPS
        # steps across the ranks, then rank 0 validates
        recording = _recording_insseg_trainer()
        tr, metrics, launches, seconds, peak = _ddp_cli_run(
            INSSEG_ARGV + ["--max_iter", str(DDP_INSSEG_STEPS),
                           "--num_devices", str(DDP_WORLD), "--log_dir", f"{tmp}/d"],
            recording,
            [mock.patch.object(insseg_trainer, "InssegTrainer", recording),
             mock.patch.dict(insseg_dataset_mod._INSTANCE_DATASETS,
                             {"Scannet200Instance2cmDataset": insseg_dataset()})])
        after_first = tr.step_s[1:]
        out["d"] = {
            "rank": tr.rank, "steps": tr.n_train, "eval_forwards": tr.n_eval,
            "main_s": seconds, "fit_s": tr.fit_s,
            "scenes_per_s": tr.config.batch_size * len(after_first) / sum(after_first),
            "max_memory_allocated": peak,
            "first_losses": {k: v[0] for k, v in tr.losses.items()},
            "last_losses": {k: v[-1] for k, v in tr.losses.items()},
            "validated_scenes": [r["scenes"] for r in tr.val_records],
            "validate_s": [r["s"] for r in tr.val_records],
            "metrics": metrics, "launches": launches, "expected_launches": tr.want,
            "state": {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _one_process_validation(argv: list, state: dict) -> dict:
    """``Trainer.validate`` of ``state`` in this process (one rank) over
    the val scenes of ``argv``."""
    from languagegroundedsemseg_torch.config import get_config
    from languagegroundedsemseg_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory(prefix="lgs_ddp_val_") as tmp:
        tr = Trainer(get_config(argv + ["--log_dir", tmp]), device="cuda")
        try:
            tr.model.load_state_dict(state)
            return tr.validate()
        finally:
            tr.close()


def phase_ddp_path(trainer_rec: dict) -> dict:
    """Data parallelism through the entry points a user calls. (a) the
    CLI as a world of one over NCCL, against trainer_path run (a). (b) the
    same flags on two ranks sharing cuda:0 over gloo (spawned processes,
    each entering ``cli.main.main`` with ``--num_devices 2``): parameters
    and BN buffers bit-equal across the ranks, each rank's launches equal
    to ``expected_launches`` over its train steps and eval forwards, and
    the all-reduced val_miou equal to one process's validation of rank
    0's weights. (c) one two-rank step on the card against the same two
    ranks on the CPU, on the parity scene split in two, within
    train_parity's tolerances. (d) instance segmentation on two ranks:
    DDP_INSSEG_STEPS steps, then rank 0 validates; parameters bit-equal,
    launches equal ``expected_launches``."""
    t0 = time.perf_counter()
    a = _ddp_world_one(trainer_rec)
    with tempfile.TemporaryDirectory(prefix="lgs_ddp_") as tmp:
        t1 = time.perf_counter()
        torch.multiprocessing.spawn(_ddp_rank, args=(tmp,), nprocs=DDP_WORLD, join=True)
        spawn_s = time.perf_counter() - t1
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                 for r in range(DDP_WORLD)]
    b = [r["b"] for r in ranks]
    d = [r["d"] for r in ranks]
    checks = {}
    for tag, runs in (("b", b), ("d", d)):
        gaps = [_state_gap(r["state"], runs[0]["state"]) for r in runs[1:]]
        checks[f"{tag}_ranks_bit_equal"] = all(g["bit_equal"] for g in gaps)
        checks[f"{tag}_launches_equal_expected"] = all(
            r["launches"] == r["expected_launches"] and min(r["launches"].values()) > 0
            for r in runs)
    one = _one_process_validation(LEARNING_CURVE_ARGV, b[0]["state"])
    checks["b_val_miou_all_ranks_equal"] = len({r["val_miou"] for r in b}) == 1
    checks["b_val_miou_vs_one_process"] = abs(b[0]["val_miou"] - one["val_miou"])
    n_val = d[0]["validated_scenes"][0] if d[0]["validated_scenes"] else 0
    checks["d_rank0_validated"] = n_val > 0 and all(
        r["validated_scenes"] == ([n_val] * 2 if r["rank"] == 0 else [0, 0]) for r in d)
    c = ranks[0]["c"]
    parity = {tag: _step_gap(c[tag]["cuda"], c[tag]["cpu"]) for tag in c}
    m, f = parity["model"], parity["relu_free"]
    held_c = [m["loss"] <= TRAIN_LOSS_RTOL, m["stats"] <= TRAIN_STATE_RTOL,
              f["loss"] <= TRAIN_LOSS_RTOL, f["grads"] <= TRAIN_GRAD_RTOL,
              f["params"] <= TRAIN_STATE_RTOL, f["stats"] <= TRAIN_STATE_RTOL]
    c_ranks_equal = _state_gap(ranks[1]["c"]["relu_free"]["cuda"][2],
                               c["relu_free"]["cuda"][2])["bit_equal"]
    for r in b + d:
        r.pop("state")
    launches = {k: a["launches"][k] + sum(r["launches"][k] for r in b + d)
                for k in a["launches"]}
    rec = {"phase": "ddp_path", "world_one_nccl": a, "world": DDP_WORLD,
           "two_ranks_one_card": {"backend": "gloo", "device": "cuda:0",
                                  "trainer": b, "insseg": d},
           "one_process_validation": one,
           "parity": {"shards_voxels": [len(s[0]) for s in parity_shards()],
                      "card_vs_cpu": parity, "loss": c["model"]["cuda"][0],
                      "ranks_equal_after_step": c_ranks_equal,
                      "tolerances": {"loss": TRAIN_LOSS_RTOL, "grads": TRAIN_GRAD_RTOL,
                                     "params_and_stats": TRAIN_STATE_RTOL}},
           "checks": checks, "launches": launches, "spawn_s": spawn_s,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    failed = [k for k, v in checks.items()
              if v is False or (k == "b_val_miou_vs_one_process" and v > DDP_MIOU_ATOL)]
    if not all(held_c):
        failed.append("c_card_vs_cpu")
    if not c_ranks_equal:
        failed.append("c_ranks_equal_after_step")
    if failed:
        raise AssertionError(f"ddp_path: {failed}")
    return rec


# phase zoo_path: the rest of the model zoo through the entry points
# (a) Res16UNet50 with trainer_path (a)'s flags; (b) the bilateral CRF
# around Res16UNet34C at the size its O(N^2) kNN allows: one scene of
# CRF_POINTS points a batch at a level-0 capacity of CRF_CAP (trainer_path's
# 16 scenes, 2 epochs); (c) one eval forward and one train step per family
# card vs CPU on the parity batch
ZOO_EPOCHS = 2
CRF_POINTS, CRF_CAP = 10_000, 16384
CRF_ARGV = ["--model", "Res16UNet34C", "--wrapper_type", "BilateralCRF",
            "--batch_size", "1", "--val_batch_size", "1",
            "--fixed_capacity", str(CRF_CAP), "--meanfield_iterations", "10"]
# (c)'s families: (registered class, class attributes that narrow it (the
# CPU half of a full-width one takes too long), 4-D cloud?)
ZOO_FAMILIES = (
    ("Res16UNet50", {"LAYERS": (1,) * 8}, False),
    ("ResUNet14", {}, False),
    ("MinkUNetHyper14INBN", {}, False),
    ("Res16UNet34Dv3", {"LAYERS": (1,) * 8,
                        "PLANES": (32, 64, 128, 256, 128, 128, 96, 96)}, False),
    ("Res16UNet34CR_Proj", {}, False),
    ("Res16UNet14", {"BLOCK": "se_basic"}, False),
    ("ResNet14", {}, False),
    ("STRes16UNet14A", {}, True),
)
ST_FRAMES = 3


def crf_dataset():
    """trainer_path's dataset at CRF_POINTS points a scene."""
    from languagegroundedsemseg_torch.data.synthetic_dataset import (
        Synthetic200Voxelization2cmDataset,
    )

    class SyntheticCRF(Synthetic200Voxelization2cmDataset):
        POINTS_PER_SCENE = CRF_POINTS

    return SyntheticCRF


def _step_alone(tr) -> dict:
    """Host ms of three synced train steps on the run's last batch once
    its loaders are idle (what a step costs without the loader's wait),
    and that batch's level-0 rows."""
    ms = _idle_step_ms(lambda st, b: tr.raw_train_step(st, b, tr.generator),
                       tr.state, tr.last_batch)
    return {"step_alone_ms": ms,
            "last_batch_rows_l0": int(tr.last_batch.graph.levels[0].mask().sum())}


def _crf_extra(tr) -> dict:
    """The CRF's coins, its compatibility's change over the run, its
    parameter group's lr against the rest's, a step alone, and the CRF's
    own cost on the last batch: the blocked kNN, and the mean-field
    forward + backward (random unaries, CUDA events, median of 3)."""
    from languagegroundedsemseg_torch.ops.points import knn

    crf_mod = tr.model.crf
    b = tr.last_batch.decompact()
    lvl0 = b.graph.levels[0]
    cap = lvl0.capacity
    xyz, colors = lvl0.coords[:, 1:4], (b.feats[:, :3] + 0.5) * 255.0
    feat = torch.cat([xyz.float() / crf_mod.spatial_sigma,
                      colors / crf_mod.chromatic_sigma], dim=1)
    k = crf_mod.num_neighbors + 1
    unaries = torch.randn((cap, crf_mod.compatibility.shape[0]),
                          device=feat.device, requires_grad=True)

    def mean_field():
        crf_mod(unaries, xyz, colors, lvl0.mask()).sum().backward()

    crf = crf_mod.compatibility.detach()
    groups = tr.state.optimizer.inner.param_groups
    d = crf - tr.crf0.to(crf.device)
    coins = [bool(c) for c in tr.coins]
    return {**_step_alone(tr), "crf_capacity": cap,
            "knn_ms": cuda_ms(lambda: knn(feat, feat, k, lvl0.mask()), 3, 1),
            "mean_field_fwd_bwd_ms": cuda_ms(mean_field, 3, 1),
            "coins": coins, "coins_true": sum(coins),
            "compat_max_abs_change": float(d.abs().max()),
            "compat_rel_change": float(torch.linalg.norm(d) / torch.linalg.norm(tr.crf0)),
            "lr_groups": [g["lr"] for g in groups],
            "lr_factor": groups[1].get("lr_factor")}


def zoo_parity_batch(model_cls, four_d: bool, device):
    """The parity scene (PARITY_POINTS points) in ``model_cls``'s graph at
    PARITY_CAP; a 4-D family gets it as ST_FRAMES frames, every third
    voxel in each (frame t = the voxels whose index is t mod ST_FRAMES)."""
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.sparse import graph_host as gh
    from languagegroundedsemseg_torch.train.step import TrainBatch

    coords, feats, labels = voxelize_scene(np.random.default_rng(1), PARITY_POINTS)
    spec = model_cls.graph_spec(3)
    if not four_d:
        return BatchBuilder(spec=spec, fixed_capacity=PARITY_CAP).build(
            [(coords, feats, labels)], device=device)
    n = len(coords)
    c4 = np.concatenate([np.zeros((n, 1), np.int32), coords.astype(np.int32),
                         (np.arange(n) % ST_FRAMES)[:, None].astype(np.int32)], 1)
    order = np.argsort(gh.pack_keys(c4), kind="stable")
    caps = gh.default_capacities(PARITY_CAP, spec.num_levels)
    graph = gh.build_graph(c4[order], spec, caps)
    f = np.zeros((caps[0], 3), np.float32)
    f[:n] = feats[order]
    lab = np.full(caps[0], 255, np.int32)
    lab[:n] = labels[order]
    return TrainBatch(f, lab, graph).to(device)


def _zoo_outputs(model, batch, device, noise_seed=None) -> dict:
    """The eval forward's output, then one SGD step (CE with ignore label
    255 over the level-0 rows; a ResNet's stride-32 output has no labels,
    so its loss is the mean square of its valid rows) with the train-mode
    output caught in the objective. ``noise_seed`` moves the input
    features by 1e-6, relative."""
    from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss
    from languagegroundedsemseg_torch.models.resnet import ResNetBase
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_eval_step, make_train_step

    if noise_seed is not None:
        gen = torch.Generator(device=batch.feats.device).manual_seed(noise_seed)
        noise = torch.randn(batch.feats.shape, generator=gen, device=batch.feats.device)
        batch = batch.replace(feats=batch.feats * (1 + 1e-6 * noise))
    rows = batch.graph.levels[-1 if isinstance(model, ResNetBase) else 0]
    valid = rows.mask().cpu() > 0
    eval_out = make_eval_step(model, device=device)(batch)[0]
    caught = []

    def objective(out, _features, b, _gen, row_mask):
        caught.append(out.detach())
        if out.shape[0] != row_mask.shape[0]:
            m = rows.mask()
            return ((out ** 2).sum(-1) * m).sum() / m.sum(), {}
        return cross_entropy_loss(out, b.labels, 255, row_mask=row_mask), {}

    opt = sgd_torch(model.parameters(), TRAIN_LR)
    step = make_train_step(model, opt, objective, device=device)
    _, m = step(TrainState(model, opt), batch)
    return {"eval": eval_out.cpu()[valid], "train": caught[0].cpu()[valid],
            "loss": float(m["loss"])}


def zoo_card_vs_cpu() -> list:
    """(c) per family: the card's eval output, train-mode output and loss
    against the CPU's plain path, same conditioned weights (scaled_model),
    the parity batch. Held as insseg_path holds them: the loss to
    TRAIN_LOSS_RTOL, the train-mode output to twice the largest gap 1e-6
    input noise (three draws) makes on the card itself, or PARITY_RTOL
    where that is larger (PERF.md §6); the eval output to
    PARITY_RTOL, or by the train-mode rule in a family with an instance
    norm, which normalizes by the batch's own statistics in eval mode too
    (a 1e-6 input change moves MinkUNetHyper14INBN's eval output by
    ~9e-3 on the card); the
    launches of the card's forward and step equal ``expected_launches``:
    all three kernels on the Res16UNet-spec families, none on ResNet, at
    most csum (the down / up maps) on the ST variant."""
    from languagegroundedsemseg_torch.models import load_model
    from languagegroundedsemseg_torch.models.layers import SparseInstanceNorm
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    out = []
    for name, narrow, four_d in ZOO_FAMILIES:
        cls = load_model(name)
        if narrow:
            cls = type(name, (cls,), dict(narrow))
        base = scaled_model("cuda", model_cls=cls)
        t0 = time.perf_counter()
        batch = zoo_parity_batch(cls, four_d, "cuda")
        want = {k: a + b for k, a, b in (
            (k, expected_launches(base, batch.graph)[k],
             expected_launches(base, batch.graph, train=True)[k])
            for k in ("sel_fwd", "csum", "dw"))}
        oc.reset_launch_counts()
        card = _zoo_outputs(copy.deepcopy(base), batch, "cuda")
        launches = dict(oc.launch_counts)
        noise = [_zoo_outputs(copy.deepcopy(base), batch, "cuda", seed)
                 for seed in range(3)]
        card_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        cpu = _zoo_outputs(copy.deepcopy(base).to("cpu"),
                           zoo_parity_batch(cls, four_d, "cpu"), "cpu")
        cpu_s = time.perf_counter() - t1
        gap = {"eval": _rel_l2(card["eval"], cpu["eval"]),
               "train": _rel_l2(card["train"], cpu["train"]),
               "loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])}
        noise_gap = {k: max(_rel_l2(n[k], card[k]) for n in noise)
                     for k in ("eval", "train")}
        inorm = any(isinstance(m, SparseInstanceNorm) for m in base.modules())
        limit = {"eval": (max(PARITY_RTOL, 2 * noise_gap["eval"]) if inorm
                          else PARITY_RTOL),
                 "loss": TRAIN_LOSS_RTOL,
                 "train": max(PARITY_RTOL, 2 * noise_gap["train"])}
        rec = {"family": name, "narrowed": narrow or "full width",
               "four_d": four_d, "instance_norm": inorm,
               "n_rows": int(card["eval"].shape[0]),
               "loss": card["loss"], "card_vs_cpu": gap,
               "card_input_noise_1e-6": noise_gap, "limits": limit,
               "launches": launches, "expected_launches": want,
               "card_s": card_s, "cpu_s": cpu_s}
        out.append(rec)
        if launches != want or not all(gap[k] <= limit[k] for k in limit):
            raise AssertionError(f"zoo_path (c) {name}: {rec}")
        # ResNet's maps carry no annotation; the ST k3 maps neither, but
        # their down maps' child-sum partition runs csum when windowed
        ran = {k for k, v in launches.items() if v}
        if ran != ({"csum"} & ran if four_d else set()
                   if name.startswith("ResNet") else {"sel_fwd", "csum", "dw"}):
            raise AssertionError(f"zoo_path (c) {name}: launches {launches}")
    return out


def phase_zoo_path() -> dict:
    """The rest of the model zoo on the card. (a) ``cli.main`` with
    trainer_path (a)'s flags and ``--model Res16UNet50`` (Bottleneck
    blocks, a decoder 1,024 channels wide at every level), ZOO_EPOCHS
    epochs: launches equal Σ ``expected_launches``, the loss falls, peak
    memory recorded. (b) ``--wrapper_type BilateralCRF`` around
    Res16UNet34C at CRF_POINTS points a scene, batch 1, capacity CRF_CAP:
    the coins drawn, the compatibility's change, its group's lr
    (wrapper_lr), launches equal Σ ``expected_launches`` of the base
    model. (c) card vs CPU per family (``zoo_card_vs_cpu``)."""
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.data import loader as loader_mod

    name = "Synthetic200Voxelization2cmDataset"
    loader_mod.load_dataset(name)  # the registry filled
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lgs_zoo_path_") as tmp:
        a = _trainer_run("res16unet50", LEARNING_CURVE_ARGV + [
            "--max_epoch", str(ZOO_EPOCHS), "--model", "Res16UNet50",
            "--log_dir", os.path.join(tmp, "a")], ZOO_EPOCHS, ("val_miou",),
            extra=_step_alone)
        if not a["last_loss"] < a["first_loss"]:
            raise AssertionError(f"zoo_path (a): the loss did not fall {a['losses']}")
        b = _trainer_run("bilateral_crf", LEARNING_CURVE_ARGV + CRF_ARGV + [
            "--max_epoch", str(ZOO_EPOCHS), "--log_dir", os.path.join(tmp, "b")],
            ZOO_EPOCHS, ("val_miou",),
            patches=(mock.patch.dict(loader_mod._DATASETS, {name: crf_dataset()}),),
            extra=_crf_extra)
    ab_s = time.perf_counter() - t0
    b.pop("state", None)
    lr = float(LEARNING_CURVE_ARGV[LEARNING_CURVE_ARGV.index("--lr") + 1])
    if not (b["coins"] and len(b["coins"]) == b["steps"]
            and b["compat_max_abs_change"] > 0
            and abs(b["lr_factor"] - Config().wrapper_lr / lr) < 1e-12):
        raise AssertionError(f"zoo_path (b): {b}")
    t1 = time.perf_counter()
    c = zoo_card_vs_cpu()
    rec = {"phase": "zoo_path", "argv": LEARNING_CURVE_ARGV, "runs": [a, b],
           "families": c,
           "launches": {k: a["launches"][k] + b["launches"][k]
                        + sum(f["launches"][k] for f in c) for k in a["launches"]},
           "ab_s": ab_s, "c_s": time.perf_counter() - t1,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec



# ---- phase classifier_path: the classifier stage ---------------------------
CLASSIFIER_EPOCHS = 2
CLASSIFIER_ARGV = ["--classifier_resample_features", "true",
                   "--max_epoch", str(CLASSIFIER_EPOCHS)]
# the classifier's history card vs CPU on the same features: the same f32
# SGD updates, sums in another order, over the epochs
CLASSIFIER_RTOL = 1e-4
# val accuracy card vs CPU: an argmax tie among near-equal logits can flip
# a row
CLASSIFIER_ACC_ATOL = 1e-3


def _timed_extraction(log: list):
    """A patch of ``extract_features`` that records each call's seconds
    (synced), pooled rows and feature width, changing nothing it does."""
    from languagegroundedsemseg_torch.data import feature_dataset as fd

    real = fd.extract_features

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, labels = real(*args, **kwargs)
        log.append({"s": time.perf_counter() - t0, "rows": int(len(labels)),
                    "width": int(feats.shape[1])})
        return feats, labels

    return mock.patch.object(fd, "extract_features", timed)


def _classifier_files(log_dir: str, epochs: int, name: str) -> dict:
    """The stage's ``classifier_features.ckpt`` (tensors only) and its
    history: one record per epoch, finite loss, accuracy in [0, 1]."""
    path = os.path.join(log_dir, "classifier_features.ckpt")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    with open(path + ".json") as f:
        history = json.load(f)["history"]
    if [r["epoch"] for r in history] != list(range(epochs)) or not all(
            np.isfinite(r["loss"]) and 0.0 <= r["val_acc"] <= 1.0 for r in history):
        raise AssertionError(f"{name}: history {history}")
    return {"history": history,
            "tensors": {k: list(v.shape) for k, v in blob.items()}}


def classifier_card_vs_cpu() -> dict:
    """The stage's two parts card vs CPU on the parity batch: the pooled
    features of Res16UNet34C's eval forward (conditioned weights), and the
    classifier trained on the card's features on each device (two epochs,
    seed 0)."""
    from languagegroundedsemseg_torch.data.feature_dataset import (
        ResampledFeatureDataset,
        extract_features,
    )
    from languagegroundedsemseg_torch.train.classifier import (
        train_classifier_on_features,
    )
    from languagegroundedsemseg_torch.train.step import make_eval_step

    model = scaled_model("cuda")
    pooled = {}
    for dev, m in (("cuda", model), ("cpu", copy.deepcopy(model).to("cpu"))):
        pooled[dev] = extract_features(make_eval_step(m, device=dev),
                                       [parity_batch(dev)])
    (fc, lc), (fp, lp) = pooled["cuda"], pooled["cpu"]
    if not np.array_equal(lc, lp):
        raise AssertionError("classifier_path: pooled labels differ card vs CPU")
    feat_gap = float(np.linalg.norm(fc - fp) / np.linalg.norm(fp))
    hist = {}
    for dev in ("cuda", "cpu"):
        ds = ResampledFeatureDataset(fc, lc, num_classes=200, seed=0)
        val = ResampledFeatureDataset(fc, lc, num_classes=200, seed=1)
        hist[dev] = train_classifier_on_features(
            ds, 200, epochs=CLASSIFIER_EPOCHS, seed=0, val=val, device=dev)[1]
    loss_gap = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(hist["cuda"], hist["cpu"]))
    acc_gap = max(abs(a["val_acc"] - b["val_acc"])
                  for a, b in zip(hist["cuda"], hist["cpu"]))
    rec = {"pooled_rows": int(len(lc)), "features_rel_l2": feat_gap,
           "history_card": hist["cuda"], "history_cpu": hist["cpu"],
           "loss_rel_gap": loss_gap, "val_acc_gap": acc_gap,
           "limits": {"features": PARITY_RTOL, "loss": CLASSIFIER_RTOL,
                      "val_acc": CLASSIFIER_ACC_ATOL}}
    if not (feat_gap <= PARITY_RTOL and loss_gap <= CLASSIFIER_RTOL
            and acc_gap <= CLASSIFIER_ACC_ATOL):
        raise AssertionError(f"classifier_path card vs CPU: {rec}")
    return rec


def phase_classifier_path() -> dict:
    """The classifier stage on the card. (a) ``cli.main`` with
    trainer_path (a)'s flags, ``--model ClassifierNet
    --classifier_resample_features true``: ClassifierNet is the model, so
    the pooled features are the voxel features and nothing launches a
    kernel; the stage writes its checkpoint and history, then the test
    pass runs. (b) ``Trainer(cfg, mode="classifier")`` on Res16UNet34C at
    full width with the same flags: the features are the backbone's eval
    forwards over both loaders (launches = Σ ``expected_launches`` of
    those forwards), then CLASSIFIER_EPOCHS epochs of the classifier.
    Then card vs CPU (``classifier_card_vs_cpu``)."""
    from languagegroundedsemseg_torch.cli.main import main as cli_main
    from languagegroundedsemseg_torch.config import get_config
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa
    from languagegroundedsemseg_torch.ops import onehot_conv as oc
    from languagegroundedsemseg_torch.train import trainer as trainer_mod

    t0 = time.perf_counter()
    runs = []
    with tempfile.TemporaryDirectory(prefix="lgs_classifier_path_") as tmp:
        for name, model in (("classifier_net", "ClassifierNet"),
                            ("res16unet34c_backbone", "Res16UNet34C")):
            log_dir = os.path.join(tmp, name)
            argv = LEARNING_CURVE_ARGV + CLASSIFIER_ARGV + [
                "--model", model, "--log_dir", log_dir]
            recording, extraction = _recording_trainer(), []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            oc.reset_launch_counts()
            oa.reset_launch_counts()
            t1 = time.perf_counter()
            with _timed_extraction(extraction), \
                    mock.patch.object(trainer_mod, "Trainer", recording):
                if model == "ClassifierNet":
                    test_metrics = cli_main(argv)
                else:
                    tr = recording(get_config(argv), mode="classifier")
                    tr.fit()
                    tr.close()
                    test_metrics = None
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t1
            launches, ablation = dict(oc.launch_counts), dict(oa.launch_counts)
            (tr,) = recording.instances
            # Σ expected_launches over the extraction's (and the test
            # pass's) eval forwards: no dw, no ablation kernel
            if launches != tr.want or launches["dw"] or any(ablation.values()):
                raise AssertionError(f"{name}: launches {launches}, expected "
                                     f"{tr.want}, ablation {ablation}")
            if tr.mode != "classifier" or tr.state.step != 0:
                raise AssertionError(f"{name}: mode {tr.mode}, step {tr.state.step}")
            if model == "ClassifierNet" and any(launches.values()):
                raise AssertionError(f"{name}: ClassifierNet launched {launches}")
            if model != "ClassifierNet" and not (launches["sel_fwd"] and launches["csum"]):
                raise AssertionError(f"{name}: the backbone's kernels never ran {launches}")
            files = _classifier_files(log_dir, CLASSIFIER_EPOCHS, name)
            if test_metrics is not None and not 0.0 <= test_metrics["val_miou"] <= 1.0:
                raise AssertionError(f"{name}: test pass {test_metrics}")
            runs.append({"run": name, "model": model, "classes": tr.num_labels,
                         "run_s": run_s,
                         "extraction": extraction,
                         "extraction_s": sum(e["s"] for e in extraction),
                         "pool_rows": {"train": extraction[0]["rows"],
                                       "val": extraction[1]["rows"]},
                         "feature_width": extraction[0]["width"],
                         "eval_forwards": tr.n_eval,
                         "max_memory_allocated": torch.cuda.max_memory_allocated(),
                         **files, "launches": launches, "expected_launches": tr.want,
                         "ablation_launches": ablation,
                         **({"test_metrics": {k: test_metrics[k] for k in
                                              ("val_miou", "val_loss")}}
                            if test_metrics is not None else {})})
    # ClassifierNet pools the 3 input channels, Res16UNet34C its 96-wide
    # last decoder block
    widths = [r["feature_width"] for r in runs]
    if widths != [3, 96] or [r["tensors"]["classifier.weight"] for r in runs] != [
            [r["classes"], w] for r, w in zip(runs, widths)]:
        raise AssertionError(f"classifier_path: widths {widths}, {runs}")
    t2 = time.perf_counter()
    rec = {"phase": "classifier_path", "argv": LEARNING_CURVE_ARGV + CLASSIFIER_ARGV,
           "runs": runs, "card_vs_cpu": classifier_card_vs_cpu(),
           "card_vs_cpu_s": time.perf_counter() - t2,
           "launches": {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]},
           "ablation_launches": {k: sum(r["ablation_launches"][k] for r in runs)
                                 for k in runs[0]["ablation_launches"]},
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


# ---- phase simsiam_path: the paired SimSiam step ---------------------------
# trainer_path's dataset and scene size, 4-scene paired batches: two batches
# (scenes 0-3 and 4-7), stepped alternately
SIMSIAM_STEPS = 8
SIMSIAM_LR = 0.05
SIMSIAM_BATCHES = ((0, 1, 2, 3), (4, 5, 6, 7))


def _paired_setup(points=None, cap=None):
    """(config, dataset, builder) of trainer_path's flags; the dataset at
    ``points`` points a scene and the builder at capacity ``cap`` when
    given."""
    from languagegroundedsemseg_torch.config import get_config
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.loader import load_dataset
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec

    cfg = get_config(LEARNING_CURVE_ARGV)
    cls = load_dataset(cfg.dataset)
    if points:
        cls = type(cls.__name__, (cls,), {"POINTS_PER_SCENE": points})
    ds = cls(cfg, phase="train", augment_data=True)
    builder = BatchBuilder(spec=res16unet_graph_spec(), ignore_index=cfg.ignore_label,
                           limit_numpoints=cfg.train_limit_numpoints,
                           fixed_capacity=cap or cfg.fixed_capacity or None,
                           level_ratios=cfg.level_capacity_ratios)
    return cfg, ds, builder


def _paired_want(model, b1, b2) -> dict:
    """One SimSiam step's launches: a train step's on each view's graph."""
    w1 = expected_launches(model, b1.graph, train=True)
    w2 = expected_launches(model, b2.graph, train=True)
    return {k: w1[k] + w2[k] for k in w1}


def simsiam_card_vs_cpu() -> dict:
    """One SimSiam step card vs CPU: Res16UNet34DPaired with one block a
    stage (the CPU half of the full depth takes too long), conditioned
    weights, on a paired batch of one PARITY_POINTS scene at PARITY_CAP.
    The loss and its terms to TRAIN_LOSS_RTOL, the BN statistics (moved
    once per view) to TRAIN_STATE_RTOL; the card's launches equal
    ``_paired_want``."""
    from languagegroundedsemseg_torch.models.clip_models import Res16UNet34DPaired
    from languagegroundedsemseg_torch.ops import onehot_conv as oc
    from languagegroundedsemseg_torch.train.simsiam import (
        build_paired_batch,
        make_simsiam_train_step,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState

    cfg, ds, builder = _paired_setup(PARITY_POINTS, PARITY_CAP)
    cls = type("Res16UNet34DPaired", (Res16UNet34DPaired,), {"LAYERS": (1,) * 8})
    base = scaled_model("cuda", model_cls=cls)
    anchors = ds.loaded_text_features[:, 0, :]
    out = {}
    for dev in ("cuda", "cpu"):
        b1, b2, c1, c2 = build_paired_batch(builder, ds, [0], np.random.default_rng(0),
                                            device=dev)
        model = copy.deepcopy(base) if dev == "cuda" else copy.deepcopy(base).to("cpu")
        opt = sgd_torch(model.parameters(), SIMSIAM_LR)
        step = make_simsiam_train_step(model, opt, cfg, anchors,
                                       ds.frequency_organized_cats, device=dev)
        want = _paired_want(model, b1, b2)
        oc.reset_launch_counts()
        t0 = time.perf_counter()
        _, m = step(TrainState(model, opt), b1, b2, c1, c2,
                    torch.Generator(device=dev).manual_seed(0))
        out[dev] = {"metrics": {k: float(v) for k, v in m.items()},
                    "stats": torch.cat([t.detach().cpu().ravel() for n, t in
                                        model.state_dict().items() if "running" in n]),
                    "launches": dict(oc.launch_counts), "want": want,
                    "s": time.perf_counter() - t0}
    card, cpu = out["cuda"], out["cpu"]
    gap = {k: abs(card["metrics"][k] - v) / abs(v) for k, v in cpu["metrics"].items()}
    gap["stats"] = _rel_l2(card["stats"], cpu["stats"])
    rec = {"pairs_rows": [int(b1.graph.levels[0].mask().sum()),
                          int(b2.graph.levels[0].mask().sum())],
           "metrics": card["metrics"], "card_vs_cpu": gap,
           "limits": {"metrics": TRAIN_LOSS_RTOL, "stats": TRAIN_STATE_RTOL},
           "launches": card["launches"], "expected_launches": card["want"],
           "card_s": card["s"], "cpu_s": cpu["s"]}
    if (card["launches"] != card["want"] or gap["stats"] > TRAIN_STATE_RTOL
            or max(v for k, v in gap.items() if k != "stats") > TRAIN_LOSS_RTOL):
        raise AssertionError(f"simsiam_path card vs CPU: {rec}")
    return rec


def phase_simsiam_path() -> dict:
    """The paired SimSiam step on the card: ``build_paired_batch`` over
    trainer_path's dataset (two augmented views a scene, their
    correspondences), 4-scene batches, then SIMSIAM_STEPS SGD steps of
    ``make_simsiam_train_step`` on Res16UNet34DPaired at full width (the
    backbone's own seeded init, the dataset's 512-d anchors). Launches
    equal Σ over the steps of both views' train-step launches; losses
    finite; the loss of each batch falls between its first and last step.
    Then one step card vs CPU (``simsiam_card_vs_cpu``)."""
    from languagegroundedsemseg_torch.models.clip_models import Res16UNet34DPaired
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa
    from languagegroundedsemseg_torch.ops import onehot_conv as oc
    from languagegroundedsemseg_torch.train.simsiam import (
        build_paired_batch,
        make_simsiam_train_step,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState

    t0 = time.perf_counter()
    cfg, ds, builder = _paired_setup()
    rng = np.random.default_rng(cfg.seed)
    pairs, build_s, corr_ok = [], [], []
    for idx in SIMSIAM_BATCHES:
        t1 = time.perf_counter()
        b1, b2, c1, c2 = build_paired_batch(builder, ds, list(idx), rng)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t1)
        valid = b1.graph.levels[0].mask().cpu().numpy() > 0
        corr_ok.append(float(((c1 >= 0) & valid).sum() / valid.sum()))
        pairs.append((b1, b2, c1, c2))
    model = Res16UNet34DPaired(in_channels=3, out_channels=200, device="cuda",
                               generator=torch.Generator().manual_seed(cfg.seed),
                               max_batch=len(SIMSIAM_BATCHES[0]) + 1)
    opt = sgd_torch(model.parameters(), SIMSIAM_LR)
    step = make_simsiam_train_step(model, opt, cfg, ds.loaded_text_features[:, 0, :],
                                   ds.frequency_organized_cats)
    state = TrainState(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    want = {"sel_fwd": 0, "csum": 0, "dw": 0}
    for i in range(SIMSIAM_STEPS):
        for k, v in _paired_want(model, *pairs[i % 2][:2]).items():
            want[k] += v
    metrics, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    oc.reset_launch_counts()
    oa.reset_launch_counts()
    for i in range(SIMSIAM_STEPS):
        t1 = time.perf_counter()
        state, m = step(state, *pairs[i % 2], gen)
        metrics.append({k: float(v) for k, v in m.items()})  # syncs
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches, ablation = dict(oc.launch_counts), dict(oa.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    anchor = [r["anchor_loss1"] + r["anchor_loss2"] for r in metrics]
    rec = {"phase": "simsiam_path", "argv": LEARNING_CURVE_ARGV,
           "batches": [list(b) for b in SIMSIAM_BATCHES],
           "rows_l0": [[int(p[0].graph.levels[0].mask().sum()),
                        int(p[1].graph.levels[0].mask().sum())] for p in pairs],
           "paired_build_s": build_s, "corr_valid_share": corr_ok,
           "steps": state.step, "lr": SIMSIAM_LR, "step_ms": step_ms,
           "step_ms_after_first": statistics.median(step_ms[1:]),
           "max_memory_allocated": peak, "metrics": metrics,
           "anchor_losses": anchor,
           "launches": launches, "expected_launches": want,
           "ablation_launches": ablation}
    if launches != want or min(launches.values()) == 0 or any(ablation.values()):
        raise AssertionError(f"simsiam_path: {rec}")
    if not np.isfinite([v for r in metrics for v in r.values()]).all():
        raise AssertionError(f"simsiam_path: metrics {metrics}")
    for b in range(2):
        if not anchor[-2 + b] < anchor[b]:
            raise AssertionError(f"simsiam_path: batch {b}'s anchor loss did not "
                                 f"fall: {anchor}")
    t1 = time.perf_counter()
    rec["card_vs_cpu"] = simsiam_card_vs_cpu()
    rec["card_vs_cpu_s"] = time.perf_counter() - t1
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


# ---- phase precision_path: bf16 compute and per-block recomputation ------
PRECISION_EPOCHS = 2
PRECISION_RUNS = (
    ("bf16_res16unet34c", ["--compute_dtype", "bfloat16"]),
    ("remat_res16unet50", ["--model", "Res16UNet50", "--remat", "true"]),
    ("remat_bf16_res16unet50", ["--model", "Res16UNet50", "--remat", "true",
                                "--compute_dtype", "bfloat16"]),
)
PRECISION_INSSEG_STEPS = 4
# card bf16 vs CPU bf16 (the parity batch): the same casts, but cuBLAS's and
# the CPU's bf16 GEMMs may round a result's last bit differently (one flip
# is 2^-8 relative), spread through the layers (tests/test_torch_precision.py
# holds the CPU against JAX to the same limit)
BF16_CARD_RTOL = 3e-2


def _precision_extra(tr) -> dict:
    """A step alone, the model's dtype and remat, and the launches a
    train step on the last batch adds for the recompute."""
    model = tr.model
    g = tr.last_batch.graph
    with_remat = expected_launches(model, g, train=True)
    remat, model.remat = model.remat, False
    try:
        without = expected_launches(model, g, train=True)
    finally:
        model.remat = remat
    return {**_step_alone(tr), "dtype": str(model.dtype), "remat": model.remat,
            "recompute_launches_per_step": {k: with_remat[k] - without[k]
                                            for k in with_remat}}


def precision_card_vs_cpu() -> list:
    """Per configuration, card vs CPU on the parity batch (conditioned
    weights): the eval logits and one SGD step's loss and BN statistics;
    the card step's launches equal ``expected_launches`` (with the
    recompute); with remat, the card's step against its own step without
    (the same forward, so the same loss and statistics up to the card's
    atomics). bf16 is held to BF16_CARD_RTOL, f32 to the train-parity
    limits. Res16UNet50 runs with one block a stage (the CPU half of the
    full depth takes too long)."""
    from languagegroundedsemseg_torch.models.res16unet import Res16UNet34C, Res16UNet50
    from languagegroundedsemseg_torch.ops import onehot_conv as oc
    from languagegroundedsemseg_torch.train.step import make_eval_step

    narrow50 = type("Res16UNet50", (Res16UNet50,), {"LAYERS": (1,) * 8})
    out = []
    for name, cls, dtype, remat in (
            ("bf16_res16unet34c", Res16UNet34C, torch.bfloat16, False),
            ("remat_res16unet50", narrow50, torch.float32, True),
            ("remat_bf16_res16unet50", narrow50, torch.bfloat16, True)):
        base = scaled_model("cuda", model_cls=cls, dtype=dtype, remat=remat)
        batch = parity_batch("cuda")
        valid = batch.graph.levels[0].mask().cpu() > 0
        t0 = time.perf_counter()
        logits = make_eval_step(copy.deepcopy(base))(batch)[0].cpu()[valid]
        want = expected_launches(base, batch.graph, train=True)
        oc.reset_launch_counts()
        card = _one_train_step(copy.deepcopy(base), "cuda")
        launches = dict(oc.launch_counts)
        card_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        cpu_model = copy.deepcopy(base).to("cpu")
        cpu_logits = make_eval_step(cpu_model, device="cpu")(parity_batch("cpu"))[0][valid]
        cpu = _one_train_step(copy.deepcopy(base).to("cpu"), "cpu")
        cpu_s = time.perf_counter() - t1
        rtol = BF16_CARD_RTOL if dtype == torch.bfloat16 else None
        gap = {"logits": _rel_l2(logits, cpu_logits),
               "loss": abs(card[0] - cpu[0]) / abs(cpu[0]),
               "stats": _step_gap(card, cpu)["stats"]}
        limit = {"logits": rtol or PARITY_RTOL, "loss": rtol or TRAIN_LOSS_RTOL,
                 "stats": rtol or TRAIN_STATE_RTOL}
        rec = {"config": name, "dtype": str(dtype), "remat": remat,
               "narrowed": cls is narrow50, "logits_dtype": str(logits.dtype),
               "loss": card[0], "card_vs_cpu": gap, "limits": limit,
               "launches": launches, "expected_launches": want,
               "card_s": card_s, "cpu_s": cpu_s}
        if remat:
            plain = copy.deepcopy(base)
            plain.remat = False
            alone = _one_train_step(plain, "cuda")
            rec["remat_vs_plain_on_card"] = {
                "loss": abs(card[0] - alone[0]) / abs(alone[0]),
                "stats": _step_gap(card, alone)["stats"]}
            if not (rec["remat_vs_plain_on_card"]["loss"] <= TRAIN_LOSS_RTOL
                    and rec["remat_vs_plain_on_card"]["stats"] <= TRAIN_STATE_RTOL):
                raise AssertionError(f"precision_path (c) {name}: {rec}")
        out.append(rec)
        if launches != want or not all(gap[k] <= limit[k] for k in limit):
            raise AssertionError(f"precision_path (c) {name}: {rec}")
        if dtype == torch.bfloat16 and logits.dtype != torch.bfloat16:
            raise AssertionError(f"precision_path (c) {name}: logits {logits.dtype}")
    return out


def phase_precision_path(zoo: Optional[dict] = None) -> dict:
    """bf16 compute and per-block recomputation on the card: (a)
    ``cli.main`` with trainer_path (a)'s flags three times: ``--compute_dtype
    bfloat16`` on Res16UNet34C, ``--model Res16UNet50 --remat true`` (f32)
    and both; launches (the recompute included) equal Σ
    ``expected_launches``, the loss falls, peak memory beside zoo_path
    (a)'s Res16UNet50 without remat (``zoo``, that phase's record, when
    it ran). (b) insseg_path's CLI with
    ``--compute_dtype bfloat16`` for PRECISION_INSSEG_STEPS steps and its
    validation. (c) card vs CPU (``precision_card_vs_cpu``)."""
    t0 = time.perf_counter()
    runs = []
    with tempfile.TemporaryDirectory(prefix="lgs_precision_path_") as tmp:
        for name, flags in PRECISION_RUNS:
            r = _trainer_run(name, LEARNING_CURVE_ARGV + flags + [
                "--max_epoch", str(PRECISION_EPOCHS), "--log_dir", os.path.join(tmp, name)],
                PRECISION_EPOCHS, ("val_miou",), extra=_precision_extra)
            runs.append(r)
            if not r["last_loss"] < r["first_loss"]:
                raise AssertionError(f"precision_path {name}: the loss did not fall "
                                     f"{r['losses']}")
    if ([r["dtype"] for r in runs] != ["torch.bfloat16", "torch.float32", "torch.bfloat16"]
            or [r["remat"] for r in runs] != [False, True, True]
            or runs[0]["recompute_launches_per_step"]["sel_fwd"] != 0
            or min(r["recompute_launches_per_step"]["sel_fwd"] for r in runs[1:]) == 0):
        raise AssertionError(f"precision_path: {runs}")
    t1 = time.perf_counter()
    insseg = _insseg_cli_run(INSSEG_ARGV + ["--compute_dtype", "bfloat16"],
                             PRECISION_INSSEG_STEPS)
    insseg_s = time.perf_counter() - t1
    if insseg["dtype"] != "torch.bfloat16":
        raise AssertionError(f"precision_path (b): {insseg}")
    t2 = time.perf_counter()
    c = precision_card_vs_cpu()
    zoo_a = zoo["runs"][0] if zoo else None
    rec = {"phase": "precision_path", "argv": LEARNING_CURVE_ARGV, "runs": runs,
           "res16unet50_without_remat": zoo_a and {
               k: zoo_a[k] for k in ("max_memory_allocated", "scenes_per_s",
                                     "step_alone_ms")},
           "insseg_bf16": insseg, "insseg_s": insseg_s,
           "card_vs_cpu": c, "c_s": time.perf_counter() - t2,
           "launches": {k: sum(r["launches"][k] for r in runs) + insseg["launches"][k]
                        + sum(x["launches"][k] for x in c) for k in runs[0]["launches"]},
           "ablation_launches": {k: sum(r["ablation_launches"][k] for r in runs)
                                 + insseg["ablation_launches"][k]
                                 for k in runs[0]["ablation_launches"]},
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec




_REPLACES = {
    "sel_fwd": ("languagegroundedsemseg_tpu/ops/onehot_conv.py:77", 96),
    "csum": ("languagegroundedsemseg_tpu/ops/onehot_conv.py:618", 32),
    "dw": ("languagegroundedsemseg_tpu/ops/onehot_conv.py:135", 288),
}
# the ablation kernels' rows: onehot_variants at its full mode
_ABLATION_REPLACES = {
    "onehot_gemm": ("scripts/bench_onehot_pallas.py:31", "onehot_gemm"),
    "onehot_variants": ("scripts/bench_onehot_variants.py:35",
                        ("onehot_variants", "full")),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port sits beside this script; without it nothing below can run
    import languagegroundedsemseg_torch  # noqa: F401

    info = phase_device()
    bw = hbm_bytes_per_s(info["kind"])
    phase_build()

    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec

    # the main-path batch; its L0 and L4 k3 maps and L0->L1 down map give
    # the kernel phase its shapes
    scenes = main_path_scenes()
    builder = BatchBuilder(spec=res16unet_graph_spec(), ship_coords=False,
                           compact_feats=True)
    t0 = time.perf_counter()
    host = builder.build_host(scenes)
    cold_build_s = time.perf_counter() - t0
    batch = host.to("cuda")
    kernels = phase_kernels(batch.graph, bw)
    ablation = phase_ablation(bw)

    model = seeded_model("cuda")
    main = phase_main_path(builder, scenes, batch, cold_build_s, model)
    phase_parity(model)
    del model
    train = phase_train_path(batch)
    phase_train_parity()
    e2e = phase_e2e_path()
    trainer = phase_trainer_path()
    insseg = phase_insseg_path()
    ddp = phase_ddp_path(trainer)
    zoo = phase_zoo_path()
    classifier = phase_classifier_path()
    simsiam = phase_simsiam_path()
    precision = phase_precision_path(zoo)

    # one row per kernel, at its main forward width (dw: block8's convs);
    # launches per train step, beside the forward's
    rows = []
    for name, (replaces, width) in _REPLACES.items():
        rec = kernels[(name, width)]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"languagegroundedsemseg_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": train["launches"][name],
            "launches_per_forward": main["launches"][name],
            "launches_e2e": e2e["launches"][name],
            "launches_trainer": trainer["launches"][name],
            "launches_insseg": insseg["launches"][name],
            "launches_ddp": ddp["launches"][name],
            "launches_zoo": zoo["launches"][name],
            "launches_classifier": classifier["launches"][name],
            "launches_simsiam": simsiam["launches"][name],
            "launches_precision": precision["launches"][name],
            "width": width, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "library_call": rec.get("library_call")})
    # the ablation kernels: launched by their microbenchmarks, never by the
    # forward or the train step (both read 0 above)
    for name, (replaces, key) in _ABLATION_REPLACES.items():
        rec = ablation[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"languagegroundedsemseg_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": train["ablation_launches"][name],
            "launches_per_forward": main["ablation_launches"][name],
            "launches_e2e": e2e["ablation_launches"][name],
            "launches_trainer": trainer["ablation_launches"][name],
            "launches_insseg": insseg["ablation_launches"][name],
            "launches_ddp": 0, "launches_zoo": 0,
            "launches_classifier": classifier["ablation_launches"][name],
            "launches_simsiam": simsiam["ablation_launches"][name],
            "launches_precision": precision["ablation_launches"][name],
            "launches_per_ablation": ablation["launches"][name],
            "mode": rec.get("mode"), "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "library_call": rec["library_call"]})
    # the batch norm's kernels: replace no Pallas kernel (XLA fuses the
    # norm); timed at Res16UNet34C's level-0 shape
    for name in train["bn_launches"]:
        if name == "bn_combine":
            continue  # timed inside bn_stats and bn_bwd_reduce
        rec = kernels[(name, BN_CHANNELS)]
        rows.append({
            "name": name, "route": "cuda",
            "source": "languagegroundedsemseg_torch/csrc/bn.cu",
            "replaces": "none: SparseBatchNorm's eager ops (models/layers.py)",
            "launches": train["bn_launches"][name], "width": BN_CHANNELS,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
            "library_call": rec.get("library_call")})
    # the contrastive loss's kernels: replace no Pallas kernel (XLA fuses
    # the loss); timed at the res16unet34d_lg.resident cell's level 0, and
    # launched by trainer_path (b) alone
    for name in trainer["contrast_launches"]:
        rec = kernels[(name, CONTRAST_DIM)]
        rows.append({
            "name": name, "route": "cuda",
            "source": "languagegroundedsemseg_torch/csrc/contrast.cu",
            "replaces": "none: contrastive_language_loss's eager cosine "
                        "arithmetic (losses/contrastive.py)",
            "launches_trainer": trainer["contrast_launches"][name],
            "width": CONTRAST_DIM, "rows": rec["rows"], "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"]})
    # the masked-shift table's kernel: replaces no Pallas kernel (XLA fuses
    # the table); timed at each cell's widest level-0 table
    for rows_t3, c in T3_SHAPES:
        rec = kernels[("t3", c)]
        rows.append({
            "name": "t3", "route": "cuda",
            "source": "languagegroundedsemseg_torch/csrc/t3.cu",
            "replaces": "none: the selector convs' eager masked-shift table "
                        "_t3 (ops/msconv.py)",
            "launches": train["t3_launches"]["t3"],
            "launches_e2e": e2e["t3_launches"]["t3"],
            "launches_trainer": trainer["t3_launches"]["t3"],
            "width": c, "rows": rows_t3, "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
