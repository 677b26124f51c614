"""Split the nine-column one-hot gather-GEMM's cost on a Hopper card: the
PyTorch port's counterpart of scripts/bench_onehot_variants.py.

    python3 scripts/bench_onehot_variants_torch.py
    python3 scripts/bench_onehot_variants_torch.py --cpu

Builds that script's inputs from the same seed (t3 bf16 (262144 + 1536,
384), W bf16 (9, 384, 96), anchors (8, 262144) within 400 rows of their
row, three 1536-row windows per 1024-row tile) and runs the
``onehot_variants`` kernel
(``languagegroundedsemseg_torch/csrc/onehot_variants.cu``) in each mode:

    full    : gather + projection on the tensor cores + bf16 rounding
    no_dma  : the gather's loads replaced by a zero fill (output zeros)
    no_sel  : contiguous window rows instead of the anchored gather
    no_proj : the gathered channels added instead of the projection

On the card (``chip_smoke.variants_record``) each mode is held to the plain
PyTorch version (full to 1e-2 of max |ref|, no_sel and no_proj to 1e-5,
no_dma all zeros), a second launch must be bit-equal, and the kernel, the
plain version and, for full, the library calls (``torch.bmm`` on a
pre-gathered stack) are timed: ``ms`` per call with the host's time and
``device_ms`` back to back on the device (CUDA events, median of 20 /
mean of 20). Prints the card's name and power limit, the compiled
constants (``variants_config``) and ptxas usage of every mode's kernel,
then one JSON line per mode with its launch plan (``variants_geometry``),
bound, and L2 gather floor (the rows it gathers over
``chip_smoke.L2_FILL_BYTES_PER_S``). ``--cpu`` runs the plain version at
CAP = 2048 with null device fields: a CPU run gives no device time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU_SHAPES = dict(cap=2048, tile=256, win=384, n_groups=3, cw=384, c_out=96)
# the fields a record gets only from the card (null under --cpu)
CARD_FIELDS = ("config", "blocks_per_sm", "ptxas", "max_abs_err",
               "max_abs_ref", "bit_equal_relaunch", "ms", "device_ms",
               "plain_ms", "library_ms", "l2_floor_ms", "bound_ms",
               "bound_by")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="plain version at a small size, no timing")
    args = ap.parse_args()
    import chip_smoke as cs
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    if args.cpu:
        shapes, device = CPU_SHAPES, "cpu"
    elif not torch.cuda.is_available():
        print("bench_onehot_variants_torch: no CUDA device (--cpu runs the "
              "plain version)", file=sys.stderr)
        return 1
    else:
        shapes, device = oa.VARIANTS_SHAPES, "cuda"
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip(),
            flush=True)
        bw = cs.hbm_bytes_per_s(torch.cuda.get_device_name(0))
        cuda_kernels.build()
        nb = shapes["c_out"] // 16
        cs.emit({"variants_config": oa.variants_config(
                     shapes["c_out"], 3 * shapes["n_groups"]),
                 "ptxas": {m: cuda_kernels.ptxas_usage(
                     "onehot_variants",
                     f"onehot_variants_kernelILi{i}ELi{nb}E")
                     for i, m in enumerate(oa.MODES)}})
    a = oa.variants_inputs(**shapes, seed=0, device=device)
    call = [a["wstart"], a["anchors"], a["t3"], a["w"], shapes["tile"],
            shapes["win"], shapes["n_groups"]]
    library = None if args.cpu else cs.variants_library(
        a, shapes["tile"], shapes["win"], shapes["n_groups"])
    by_mode = {}
    for mode in oa.MODES:
        out = oa.onehot_variants(mode, *call)
        if args.cpu:
            if out.shape != (shapes["cap"], shapes["c_out"]) or not bool(
                    torch.isfinite(out).all()):
                raise AssertionError(f"onehot_variants {mode}: "
                                     f"{tuple(out.shape)}")
            rec = {**cs.variants_shape_record(mode, a, shapes),
                   **{k: None for k in CARD_FIELDS},
                   "max_abs_out": float(out.abs().max())}
        else:
            rec = cs.variants_record(mode, a, shapes, out, library)
            cs._bound(rec, bw)
        by_mode[mode] = {k: rec[k] for k in ("ms", "device_ms", "bound_ms",
                                             "l2_floor_ms")}
        cs.emit(rec)
    cs.emit({"by_mode": by_mode, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
