"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Builds the port's CUDA kernels and native graph builders from the sources in
this checkout, holds each kernel against its plain PyTorch version at the
shapes of the main path, drives the Res16UNet34C (200 classes) eval forward
through ``make_eval_step`` on a 4-scene synthetic batch, checks that every
annotated conv went through its kernel, and compares the card's logits with
the CPU's plain path on a small batch. Each phase prints one JSON line; the
last line is ``{"ok": true, "device": {...}}``. Any failed phase raises and
the script exits non-zero without that line. It needs a CUDA device and
imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# sel_fwd / csum compared with their plain versions: both add the same bf16
# values in f32, only the order of the sum differs
KERNEL_RTOL = 1e-5
# card vs CPU logits on the small batch: both run bf16 projections; only sum
# order and GEMM rounding differ
PARITY_RTOL = 1e-2
# dense peaks of the card model nvidia-smi names (NVIDIA data sheets)
_HBM_BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                    ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM

SCENES, POINTS = 4, 180_000          # the bench.py batch
PARITY_POINTS, PARITY_CAP = 40_000, 32768
TIMED_KERNEL_RUNS, TIMED_FWD_RUNS = 20, 5


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


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    info = {
        "phase": "device", "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
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
    ptxas = {n: [l.strip() for l in log.splitlines() if "Used" in l or "spill" in l]
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


def expected_launches(model, graph) -> dict:
    """Launches the routing must make in one forward: one sel_fwd per k3
    conv whose map carries a usable window annotation, one csum per such
    down conv."""
    from languagegroundedsemseg_torch.models.layers import SparseConv
    from languagegroundedsemseg_torch.ops.onehot_conv import _cs_window
    from languagegroundedsemseg_torch.sparse.types import (
        ChildSumMap,
        MaskedShiftMap,
    )

    want = {"sel_fwd": 0, "csum": 0}
    for mod in model.modules():
        if not isinstance(mod, SparseConv) or mod.map_name is None:
            continue
        gm = graph.gmaps.get(mod.map_name)
        if isinstance(gm, MaskedShiftMap):
            cap = gm.out_capacity
            if (gm.tile > 0 and gm.wstart.numel() and gm.inv_wstart.numel()
                    and cap % gm.tile == 0 and cap >= gm.win):
                want["sel_fwd"] += 1
        elif isinstance(gm, ChildSumMap):
            if _cs_window(gm, graph.levels[int(mod.map_name[4:])].capacity)[0]:
                want["csum"] += 1
    return want


def sel_inputs(graph, c_run: int, gen):
    from languagegroundedsemseg_torch.ops.msconv import _abs_anchors

    m = graph.gmaps["l0.k3"]
    if m.tile <= 0:
        raise RuntimeError("the L0 k3 map of the main-path batch has no window")
    anchors = _abs_anchors(m.anchors).contiguous()
    cap = anchors.shape[1]
    pall = torch.randn((cap, 9 * c_run), generator=gen, device=anchors.device)
    return dict(wstart=m.wstart, anchors=anchors, mc=m.mc,
                pall=pall.to(torch.bfloat16), n_cols=8, tile=m.tile,
                win=m.win)


def csum_inputs(graph, c_run: int, gen):
    from languagegroundedsemseg_torch.ops.onehot_conv import (
        _abs_parent,
        _parent_groups,
    )

    m = graph.gmaps["down0"]
    if m.tile <= 0:
        raise RuntimeError("the L0->L1 down map of the main-path batch has "
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
    t = torch.arange(cap, device=a["anchors"].device) // a["tile"]
    hits = 0
    for c in range(8):
        ws = a["wstart"][t * 8 + c].long()
        an = a["anchors"][c].long()
        hits += int(((an >= ws) & (an < ws + a["win"])).sum())
    nbytes = (cap * c_run * 2 + hits * c_run * 2 + a["anchors"].numel() * 4
              + a["wstart"].numel() * 4 + cap + cap * c_run * 4)
    return nbytes, (hits + cap) * c_run, hits


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


def phase_kernels(graph, bw: float) -> dict:
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for c_run in (96, 32):
        # sel_fwd at the L0 k3 map
        a = sel_inputs(graph, c_run, gen)
        args = [a[k] for k in ("wstart", "anchors", "mc", "pall", "n_cols",
                               "tile", "win")]
        got = oc.sel_fwd(*args)
        ref = oc.sel_fwd_reference(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not err <= KERNEL_RTOL * scale:
            raise AssertionError(f"sel_fwd c={c_run}: max abs err {err} vs "
                                 f"max |ref| {scale}")
        nbytes, ops, hits = sel_work(a)
        rec = {"name": "sel_fwd", "c_run": c_run, "cap": a["anchors"].shape[1],
               "tile": a["tile"], "win": a["win"], "anchored_rows": hits,
               "max_abs_err": err, "max_abs_ref": scale,
               "ms": cuda_ms(lambda: oc.sel_fwd(*args), TIMED_KERNEL_RUNS),
               "plain_ms": cuda_ms(lambda: oc.sel_fwd_reference(*args),
                                   TIMED_KERNEL_RUNS),
               "library_ms": None, "bytes": nbytes, "operations": ops}
        results[("sel_fwd", c_run)] = rec

        # csum at the L0 -> L1 down map
        a = csum_inputs(graph, c_run, gen)
        args = [a[k] for k in ("wstart", "parent_g", "pall", "cap_out", "tile",
                               "win", "n_groups")]
        got = oc.csum(*args)
        ref = oc.csum_reference(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not err <= KERNEL_RTOL * scale:
            raise AssertionError(f"csum c={c_run}: max abs err {err} vs "
                                 f"max |ref| {scale}")
        dst, src = csum_rows(a)
        p32 = a["pall"][src].to(torch.float32)
        lib_out = torch.zeros((a["cap_out"], c_run), device="cuda")
        nbytes, ops = csum_work(a, int(dst.numel()))
        rec = {"name": "csum", "c_run": c_run, "cap_in": a["pall"].shape[0],
               "cap_out": a["cap_out"], "tile": a["tile"], "win": a["win"],
               "n_groups": a["n_groups"], "summed_rows": int(dst.numel()),
               "max_abs_err": err, "max_abs_ref": scale,
               "ms": cuda_ms(lambda: oc.csum(*args), TIMED_KERNEL_RUNS),
               "plain_ms": cuda_ms(lambda: oc.csum_reference(*args),
                                   TIMED_KERNEL_RUNS),
               "library_ms": cuda_ms(lambda: lib_out.index_add_(0, dst, p32),
                                     TIMED_KERNEL_RUNS),
               "bytes": nbytes, "operations": ops}
        results[("csum", c_run)] = rec
    for rec in results.values():
        rec["bound_ms"] = 1e3 * max(rec["bytes"] / bw,
                                    rec["operations"] / F32_OPS_PER_S)
        rec["bound_by"] = ("bytes" if rec["bytes"] / bw
                           >= rec["operations"] / F32_OPS_PER_S
                           else "operations")
        emit({"phase": "kernels", **rec})
    return results


def phase_main_path(builder, scenes, batch, cold_build_s, model) -> dict:
    """The eval forward on the 4-scene batch: launch accounting, output
    checks, forward time. ``batch`` is the first (cold) build of
    ``scenes``, already on the card."""
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
    logits, _ = step(batch)
    torch.cuda.synchronize()
    launches = dict(oc.launch_counts)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
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
           "launches": launches, "expected_launches": want}
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


def scaled_model(device, seed: int = 1):
    """Res16UNet34C (200 classes) with well-conditioned random weights:
    kernels N(0, 0.36 / fan_in), BN scales and running variances in
    [0.6, 1.4], biases and running means 0.1 * N(0, 1). Activations stay
    O(1) through the depth. (The bench's weights make the net chaotic —
    logits near 1e10, and a 1e-6 input perturbation moves them by about
    1e-2 — so a comparison under them measures the weights, not the
    port.)"""
    from languagegroundedsemseg_torch.models.res16unet import Res16UNet34C

    model = Res16UNet34C(out_channels=200, device=device)
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

    # the main-path batch; its L0 k3 and L0->L1 down maps give the kernel
    # phase its shapes
    scenes = main_path_scenes()
    builder = BatchBuilder(spec=res16unet_graph_spec(), ship_coords=False,
                           compact_feats=True)
    t0 = time.perf_counter()
    host = builder.build_host(scenes)
    cold_build_s = time.perf_counter() - t0
    batch = host.to("cuda")
    kernels = phase_kernels(batch.graph, bw)

    model = seeded_model("cuda")
    main = phase_main_path(builder, scenes, batch, cold_build_s, model)
    phase_parity(model)

    rows = []
    for (name, c_run), rec in kernels.items():
        if c_run != 96 and name == "sel_fwd":
            continue  # one row per kernel: sel at c=96, csum at c=32
        if c_run != 32 and name == "csum":
            continue
        rows.append({
            "name": name, "route": "cuda",
            "source": f"languagegroundedsemseg_torch/csrc/{name}.cu",
            "replaces": ("languagegroundedsemseg_tpu/ops/onehot_conv.py:77"
                         if name == "sel_fwd"
                         else "languagegroundedsemseg_tpu/ops/onehot_conv.py:618"),
            "launches": main["launches"][name], "c_run": c_run,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "kernel_ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
