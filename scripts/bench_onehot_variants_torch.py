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

Prints the card's name and power limit, then per mode a correctness line
against the plain PyTorch version (max abs error and max |ref|; full is
held to 1e-2 of max |ref|, no_sel and no_proj to 1e-5, no_dma must be all
zeros) and the kernel's ms (CUDA events, median of 20). ``--cpu``
runs the plain version at CAP = 2048 and prints each mode's max |out|: a
CPU run gives no device time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU_SHAPES = dict(cap=2048, tile=256, win=384, n_groups=3, cw=384, c_out=96)
FULL_RTOL, RTOL = 1e-2, 1e-5
RUNS = 20  # CUDA-event timed calls per median


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="plain version at a small size, no timing")
    args = ap.parse_args()
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    if args.cpu:
        shapes, device = CPU_SHAPES, "cpu"
    elif not torch.cuda.is_available():
        print("bench_onehot_variants_torch: no CUDA device (--cpu runs the "
              "plain version)", file=sys.stderr)
        return 1
    else:
        from chip_smoke import cuda_ms

        shapes, device = oa.VARIANTS_SHAPES, "cuda"
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip())
    a = oa.variants_inputs(**shapes, seed=0, device=device)
    call = [a["wstart"], a["anchors"], a["t3"], a["w"], shapes["tile"],
            shapes["win"], shapes["n_groups"]]
    ok = True
    for mode in oa.MODES:
        out = oa.onehot_variants(mode, *call)
        if args.cpu:
            print(f"{mode:8s}: plain version, max |out| "
                  f"{float(out.abs().max()):.4e}")
            continue
        ref = oa.onehot_variants_reference(mode, *call)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        held = err <= (FULL_RTOL if mode == "full" else RTOL) * scale
        ok &= held
        print(f"{mode:8s}: vs plain version max abs err {err:.3e} "
              f"(max |ref| {scale:.3e}) {'ok' if held else 'FAIL'}")
        t = cuda_ms(lambda: oa.onehot_variants(mode, *call), RUNS)
        print(f"{mode:8s}: {t:7.3f} ms")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
