"""Hopper one-hot gather-GEMM microbenchmark (single column): the PyTorch
port's counterpart of scripts/bench_onehot_pallas.py.

    python3 scripts/bench_onehot_gemm_torch.py
    python3 scripts/bench_onehot_gemm_torch.py --cpu
    python3 scripts/bench_onehot_gemm_torch.py --root build/parent

Builds that script's inputs from the same seed (t3 f32 (262144, 384), W f32
(384, 96), one anchor per row within 768 rows of it, clipped into the
2048-row window of its 1024-row tile) and runs the ``onehot_gemm`` kernel
(``languagegroundedsemseg_torch/csrc/onehot_gemm.cu``: W split into three
bf16 parts by a prepass, the product on the bf16 tensor cores). Prints the
card's name and power limit, one JSON line of the compiled constants
(``gemm_config``) and the ptxas usage of both kernels (product and
prepass), then the kernel's record (``chip_smoke.gemm_record``): error
against the plain version (1e-5 of max |ref|), bit-equal relaunch, the
prepass's parts bit-equal to ``split_bf16x3``, ``ms`` per call with the
host's time, ``device_ms`` back to back on the device and ``host_ms`` on
the host's clock alone (CUDA events, median of 20 / mean of 20 / mean of
20), ``no_gather_device_ms`` on the device with every window moved past
the table (no row gathered; W's staging and the products still run), the
plain version and the library's ``index_select`` + ``matmul``,
the launch plan (``gemm_geometry``), the bound (``bound_ms``,
``bound_by``), the L2 gather floor (``l2_floor_ms``) and the f32
CUDA-core time of the same operations (``f32_cuda_core_ms``), and the
relative error against the JAX script's gather oracle (``t3[anchors] @
W`` in f32; the kernel rounds the gathered t3 to bf16, so ~1e-2). A last
line sums up.

``--root DIR`` runs the kernel of another checkout of this repository
(e.g. the parent commit unpacked with ``git archive`` into a git-ignored
directory) through the same wrapper call, with this checkout's timing:
where that checkout predates ``gemm_geometry`` only the times, the checks
and the product's ptxas usage are printed. ``--cpu`` runs the plain
version at N = 4096 with null device fields: a CPU run gives no device
time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CPU_SHAPES = dict(n=4096, b=256, w=512, cw=384, c_out=96, margin=192)
# the fields a record gets only from the card (null under --cpu)
CARD_FIELDS = ("config", "blocks_per_sm", "ptxas", "max_abs_err",
               "max_abs_ref", "bit_equal_relaunch", "split_bit_equal", "ms",
               "device_ms", "host_ms", "no_gather_device_ms", "plain_ms",
               "library_ms", "l2_floor_ms", "f32_cuda_core_ms", "bound_ms",
               "bound_by")
SUMMARY = ("ms", "device_ms", "host_ms", "no_gather_device_ms", "bound_ms",
           "bound_by", "l2_floor_ms", "f32_cuda_core_ms", "library_ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="plain version at a small size, no timing")
    ap.add_argument("--root", default=None,
                    help="time the onehot_gemm of the checkout in this "
                         "directory instead of this one's")
    args = ap.parse_args()
    import chip_smoke as cs

    if args.root is not None:
        # the port is imported from there; chip_smoke (timing, bound) stays
        # this checkout's
        sys.path.insert(0, os.path.abspath(args.root))
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from languagegroundedsemseg_torch.ops import onehot_ablation as oa

    if args.cpu:
        shapes, device = CPU_SHAPES, "cpu"
    elif not torch.cuda.is_available():
        print("bench_onehot_gemm_torch: no CUDA device (--cpu runs the "
              "plain version)", file=sys.stderr)
        return 1
    else:
        shapes, device = oa.GEMM_SHAPES, "cuda"
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip(),
            flush=True)
    # a checkout from before the three-part split (--root) has no
    # gemm_geometry: only its times, checks and ptxas usage are printed
    split_kernel = hasattr(oa, "gemm_geometry")
    product_entry = f"onehot_gemm_kernelILi{shapes['c_out'] // 16}E"
    if device == "cuda":
        cuda_kernels.function("onehot_gemm")  # build before anything is timed
        if split_kernel:
            cs.emit({"gemm_config": oa.gemm_config(shapes["c_out"]),
                     "ptxas": {"product": cuda_kernels.ptxas_usage(
                                   "onehot_gemm", product_entry),
                               "split": cuda_kernels.ptxas_usage(
                                   "onehot_gemm", "split_bf16x3_kernel")}})
    a = oa.gemm_inputs(**shapes, seed=0, device=device)
    call = [a["wstart"], a["anchors"], a["t3"], a["w"], shapes["b"],
            shapes["w"]]
    out = oa.onehot_gemm(*call)
    oracle = a["t3"][a["anchors"].long()] @ a["w"]
    oracle_err = float((out - oracle).abs().max()
                       / (oracle.abs().max() + 1e-9))
    if args.cpu:
        if out.shape != (shapes["n"], shapes["c_out"]) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"onehot_gemm: {tuple(out.shape)}")
        rec = {**cs.gemm_shape_record(a, shapes),
               **{k: None for k in CARD_FIELDS},
               "max_abs_out": float(out.abs().max())}
    elif split_kernel:
        rec = cs.gemm_record(a, shapes, out)
        cs._bound(rec, cs.hbm_bytes_per_s(torch.cuda.get_device_name(0)))
    else:
        rec = {"name": "onehot_gemm", **shapes,
               **cs.gemm_times(a, shapes, out),
               "ptxas": {"product": cuda_kernels.ptxas_usage(
                   "onehot_gemm", product_entry)}}
    rec.update({"oracle_rel_err": oracle_err, "root": args.root})
    cs.emit(rec)
    cs.emit({"summary": {k: rec.get(k) for k in SUMMARY}, "device": device,
             "root": args.root})
    return 0


if __name__ == "__main__":
    sys.exit(main())
