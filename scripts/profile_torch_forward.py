"""Where the PyTorch port's eval forward or train step spends its device
time (one GPU).

    python scripts/profile_torch_forward.py [--runs 3] [--train]

Builds chip_smoke.py's main-path batch (4 synthetic scenes x 180,000
points, compact wire format) and runs, under ``torch.profiler``, the
Res16UNet34C (200 classes) eval forward with the bench's seeded weights, or
with ``--train`` chip_smoke.py's SGD train step (conditioned weights, CE
with ignore label 255). Prints one JSON line: the card's name and power
limit, wall time per run, the device busy share (kernel time / wall time),
device time by category (the three hand-written kernels, GEMMs,
gathers/scatters, elementwise), each hand-written kernel's own time (the
dw kernel apart from its reduce pass) and the top kernels by device time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# kernel-name substrings -> category (first match wins)
CATEGORIES = (
    ("sel_fwd", ("sel_fwd_kernel",)),
    ("csum", ("csum_kernel",)),
    ("dw", ("dw_kernel", "dw_reduce_kernel")),
    ("batch_norm", ("bn_stats_kernel", "bn_combine_kernel", "bn_apply_kernel",
                    "bn_bwd_reduce_kernel", "bn_bwd_apply_kernel")),
    ("t3", ("t3_kernel",)),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "splitK")),
    ("gather_scatter", ("index", "gather", "scatter", "roll")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "cat")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the forward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_forward: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec
    from languagegroundedsemseg_torch.train.step import make_eval_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    builder = BatchBuilder(spec=res16unet_graph_spec(), ship_coords=False,
                           compact_feats=True)
    batch = builder.build(cs.main_path_scenes())
    if args.train:
        train_step, state = cs._train_setup(cs.scaled_model("cuda"))

        def step(b):
            train_step(state, b)
    else:
        step = make_eval_step(cs.seeded_model("cuda"))
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.runs

    by_kernel = defaultdict(float)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        by_kernel[ev.key] += us / 1e3 / args.runs
    device_ms = sum(by_kernel.values())
    by_cat = defaultdict(float)
    for name, ms in by_kernel.items():
        by_cat[category(name)] += ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    print(json.dumps({
        "nvidia_smi": smi, "runs": args.runs,
        "what": "train_step" if args.train else "eval_forward",
        "n_voxels": int(batch.graph.levels[0].valid.sum()),
        "wall_ms_per_run": wall * 1e3,
        "device_ms_per_run": device_ms,
        "device_busy_share": device_ms / (wall * 1e3) if wall else None,
        "device_ms_by_category": dict(sorted(by_cat.items(),
                                             key=lambda kv: -kv[1])),
        "hand_written_kernels_ms": {
            n[:120]: ms for n, ms in sorted(by_kernel.items())
            if category(n) in ("sel_fwd", "csum", "dw")},
        "top_kernels_ms": [[n[:120], ms] for n, ms in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
