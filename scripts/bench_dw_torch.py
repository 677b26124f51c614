"""The fused dW kernel at every shape the Res16UNet34C train step gives it.

    python3 scripts/bench_dw_torch.py
    python3 scripts/bench_dw_torch.py --cpu

Builds chip_smoke.py's main-path batch (4 synthetic scenes x 180,000
points, compact wire format), lists the ``dw`` launches one SGD train step
of Res16UNet34C (200 classes) makes (47 over the five k3 maps), and for
each distinct (map, 3C, c_out) runs ``dw_fused`` on that map's inverse
tiling with seeded bf16 T3 and g (``chip_smoke.dw_inputs``). On the card it
holds the kernel to its plain version (``chip_smoke.DW_RTOL`` of max |ref|)
and times it, the plain version and the library product
``torch.matmul(t3b.t(), G)`` on a pre-gathered G (CUDA events, median of
20), beside the bound. Prints the card's name and power limit, the kernel's
compiled geometry, one JSON line per shape, then a total: launches x ms
summed over the step. ``--ablate`` adds, per shape, the time of each of
the kernel's ablation modes (``onehot_conv.DW_ABLATION_MODES``: the full
kernel, G rows read contiguously, loads without the product, the product
without loads). ``--cpu`` runs the plain version at a few thousand points
per scene with null times: a CPU run gives no device time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU_POINTS = 3000  # per scene, for --cpu


def dw_launches(model, graph) -> Counter:
    """(k3 map, 3C, c_out as the kernel gets it) -> dw launches in one
    train step: one per k3 conv whose map carries a usable window
    (``chip_smoke.ms_windowed``). c_out is padded to a multiple of 8 as
    ``onehot_window_conv`` pads it."""
    import chip_smoke as cs
    from languagegroundedsemseg_torch.models.layers import SparseConv
    from languagegroundedsemseg_torch.sparse.types import MaskedShiftMap

    shapes = Counter()
    for mod in model.modules():
        if not isinstance(mod, SparseConv) or mod.map_name is None:
            continue
        gm = graph.gmaps.get(mod.map_name)
        if isinstance(gm, MaskedShiftMap) and cs.ms_windowed(gm):
            _, c_in, c_out = mod.kernel.shape
            shapes[(mod.map_name, 3 * c_in, c_out + (-c_out) % 8)] += 1
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="plain version at a small size, no timing")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the kernel's ablation modes")
    args = ap.parse_args()
    import chip_smoke as cs
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.models.res16unet import (
        Res16UNet34C,
        res16unet_graph_spec,
    )
    from languagegroundedsemseg_torch.ops import cuda_kernels
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    if args.cpu:
        device, points = "cpu", CPU_POINTS
    elif not torch.cuda.is_available():
        print("bench_dw_torch: no CUDA device (--cpu runs the plain version)",
              file=sys.stderr)
        return 1
    else:
        device, points = "cuda", cs.POINTS
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip(),
            flush=True)
        bw = cs.hbm_bytes_per_s(torch.cuda.get_device_name(0))
        cuda_kernels.build()
        cs.emit({"dw_config": oc.dw_config(),
                 "ptxas": cuda_kernels.ptxas_usage("dw", "dw_kernel")})

    rng = np.random.default_rng(0)
    scenes = [voxelize_scene(rng, points, raw_color=True)
              for _ in range(cs.SCENES)]
    builder = BatchBuilder(spec=res16unet_graph_spec(), ship_coords=False,
                           compact_feats=True)
    graph = builder.build_host(scenes).to(device).graph
    model = Res16UNet34C(out_channels=200, device=device)
    shapes = dw_launches(model, graph)
    want = cs.expected_launches(model, graph, train=True)["dw"]
    if sum(shapes.values()) != want:
        raise AssertionError(f"dw shapes count {sum(shapes.values())} "
                             f"launches, the train step makes {want}")
    gen = torch.Generator(device=device).manual_seed(0)
    total = {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "bound_ms": 0.0}
    for (map_name, cw, c_out), launches in sorted(shapes.items()):
        if args.cpu:
            a = cs.dw_inputs(graph, cw, c_out, gen, map_name)
            out = oc.dw_fused(*[a[k] for k in ("inv_wstart", "inv_anchors",
                                               "t3b", "g", "tile", "win")])
            n_cols, cap = a["inv_anchors"].shape
            if out.shape != (n_cols, cw, c_out) or not bool(
                    torch.isfinite(out).all()):
                raise AssertionError(f"dw {map_name} {cw}x{c_out}: "
                                     f"{tuple(out.shape)}")
            rec = {"name": "dw", "map": map_name, "cw": cw, "c_out": c_out,
                   "cap": cap, **oc.dw_geometry(cap, cw, c_out, n_cols),
                   "max_abs_err": None, "ms": None, "plain_ms": None,
                   "library_ms": None, "bound_ms": None, "bound_by": None}
        else:
            rec = cs.dw_record(graph, cw, c_out, gen, map_name)
            cs._bound(rec, bw)
            if args.ablate:
                a = cs.dw_inputs(graph, cw, c_out, gen, map_name)
                kargs = [a[k] for k in ("inv_wstart", "inv_anchors", "t3b",
                                        "g", "tile", "win")]
                rec["ablation_ms"] = {
                    m: cs.cuda_ms(lambda m=m: oc.dw_ablation(*kargs, mode=m),
                                  cs.TIMED_KERNEL_RUNS)
                    for m in oc.DW_ABLATION_MODES}
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                total[k] += launches * rec[k]
        rec["launches"] = launches
        total["launches"] += launches
        cs.emit(rec)
    if args.cpu:
        total.update(ms=None, plain_ms=None, library_ms=None, bound_ms=None)
    cs.emit({"total_per_train_step": total, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
