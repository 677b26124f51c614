"""Hopper one-hot gather-GEMM microbenchmark (single column): the PyTorch
port's counterpart of scripts/bench_onehot_pallas.py.

    python3 scripts/bench_onehot_gemm_torch.py
    python3 scripts/bench_onehot_gemm_torch.py --cpu

Builds that script's inputs from the same seed (t3 f32 (262144, 384), W f32
(384, 96), one anchor per row within 768 rows of it, clipped into the
2048-row window of its 1024-row tile) and runs the ``onehot_gemm`` kernel
(``languagegroundedsemseg_torch/csrc/onehot_gemm.cu``). Prints the card's
name and power limit, then the JAX script's two kinds of line: the
correctness line against a gather oracle (``t3[anchors] @ W`` in f32; the
kernel rounds the gathered t3 to bf16, so ~1e-2 is expected), and the
kernel's ms and ns per row beside the library's ``index_select`` +
``matmul`` (CUDA events, median of 20). A third line holds the
kernel against its plain PyTorch version. ``--cpu`` runs the plain version
at N = 4096 and prints the correctness line only: a CPU run gives no
device time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU_SHAPES = dict(n=4096, b=256, w=512, cw=384, c_out=96, margin=192)
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
        print("bench_onehot_gemm_torch: no CUDA device (--cpu runs the "
              "plain version)", file=sys.stderr)
        return 1
    else:
        from chip_smoke import cuda_ms

        shapes, device = oa.GEMM_SHAPES, "cuda"
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip())
    a = oa.gemm_inputs(**shapes, seed=0, device=device)
    n = shapes["n"]
    call = [a["wstart"], a["anchors"], a["t3"], a["w"], shapes["b"],
            shapes["w"]]
    out = oa.onehot_gemm(*call)
    anchors = a["anchors"].long()
    ref = a["t3"][anchors] @ a["w"]
    err = float((out - ref).abs().max() / (ref.abs().max() + 1e-9))
    print(f"correctness vs gather oracle: rel err {err:.2e} "
          "(bf16 expected ~1e-2)")
    if args.cpu:
        return 0
    plain = oa.onehot_gemm_reference(*call)
    print(f"kernel vs plain version: max abs err "
          f"{float((out - plain).abs().max()):.3e} "
          f"(max |ref| {float(plain.abs().max()):.3e})")
    t_kernel = cuda_ms(lambda: oa.onehot_gemm(*call), RUNS)
    t_lib = cuda_ms(lambda: a["t3"].index_select(0, anchors) @ a["w"],
                    RUNS)
    print(f"hopper onehot_gemm     : {t_kernel:7.3f} ms "
          f"({t_kernel * 1e6 / n:5.2f} ns/row)")
    print(f"torch index_select+mm  : {t_lib:7.3f} ms "
          f"({t_lib * 1e6 / n:5.2f} ns/row)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
