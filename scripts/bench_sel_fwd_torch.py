"""The selector kernel at every shape the Res16UNet34C train step gives it.

    python3 scripts/bench_sel_fwd_torch.py
    python3 scripts/bench_sel_fwd_torch.py --cpu

Builds chip_smoke.py's main-path batch (4 synthetic scenes x 180,000
points, compact wire format) and lists the ``sel_fwd`` launches one SGD
train step of Res16UNet34C (200 classes) makes: one per k3 conv on a
windowed map (the forward, c_run = the conv's c_out padded to 8) and one
more for its dX (c_run = its c_in padded to 8; conv0's input takes no
gradient), 93 in all, checked against ``chip_smoke.expected_launches``. For
each (k3 map, c_run, pass) it runs ``sel_fwd`` on that map's anchors and
window starts with seeded bf16 P (``chip_smoke.sel_record``): on the card it
holds the kernel to its plain version bit for bit, checks that a second
launch is bit-equal, and times the kernel, the plain version and
``F.embedding_bag`` of the same pieces (CUDA events, median of 20, per call
with the host's time; and back to back on the device), beside the bound,
and the wrapper's host time per call alone.
Prints the card's name and power limit, one JSON line per shape with its
launch plan, compiled constants and ptxas usage, then the totals per train
step (launches x ms). A width that two passes share is measured once.
``--cpu`` runs the plain version at 20,000 points per scene (the fewest at
which all five k3 maps carry a window) with null device fields: a CPU run
gives no device time.
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

CPU_POINTS = 20_000  # per scene, for --cpu: every k3 map windowed
# the fields a record gets only from the card (null under --cpu)
CARD_FIELDS = ("config", "blocks_per_sm", "ptxas", "max_abs_err",
               "max_abs_ref", "bit_equal_relaunch", "library_max_abs_err",
               "ms", "plain_ms", "library_ms", "device_ms",
               "library_device_ms", "host_ms", "bound_ms", "bound_by")
TIMES = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms",
         "host_ms", "bound_ms")


def sel_launches(model, graph) -> Counter:
    """(k3 map, c_run, pass) -> sel_fwd launches in one train step:
    "forward" at the conv's c_out and "dx" at its c_in, each padded to a
    multiple of 8 as ``onehot_window_conv`` and its backward pad them."""
    import chip_smoke as cs
    from languagegroundedsemseg_torch.models.layers import SparseConv
    from languagegroundedsemseg_torch.sparse.types import MaskedShiftMap

    shapes = Counter()
    for mod in model.modules():
        if not isinstance(mod, SparseConv) or mod.map_name is None:
            continue
        gm = graph.gmaps.get(mod.map_name)
        if not isinstance(gm, MaskedShiftMap) or not cs.ms_windowed(gm):
            continue
        _, c_in, c_out = mod.kernel.shape
        shapes[(mod.map_name, c_out + (-c_out) % 8, "forward")] += 1
        if mod is not model.input_conv():
            shapes[(mod.map_name, c_in + (-c_in) % 8, "dx")] += 1
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="plain version at a small size, no timing")
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
        print("bench_sel_fwd_torch: no CUDA device (--cpu runs the plain "
              "version)", file=sys.stderr)
        return 1
    else:
        device, points = "cuda", cs.POINTS
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip(),
            flush=True)
        bw = cs.hbm_bytes_per_s(torch.cuda.get_device_name(0))
        cuda_kernels.build()
        cs.emit({"sel_config": oc.sel_config(),
                 "ptxas": {k: cuda_kernels.ptxas_usage("sel_fwd", k)
                           for k in ("sel_fwd_kernelILi8",
                                     "sel_fwd_kernelILi0")}})

    rng = np.random.default_rng(0)
    scenes = [voxelize_scene(rng, points, raw_color=True)
              for _ in range(cs.SCENES)]
    builder = BatchBuilder(spec=res16unet_graph_spec(), ship_coords=False,
                           compact_feats=True)
    graph = builder.build_host(scenes).to(device).graph
    model = Res16UNet34C(out_channels=200, device=device)
    shapes = sel_launches(model, graph)
    want = cs.expected_launches(model, graph, train=True)["sel_fwd"]
    if sum(shapes.values()) != want:
        raise AssertionError(f"sel_fwd shapes count {sum(shapes.values())} "
                             f"launches, the train step makes {want}")
    gen = torch.Generator(device=device).manual_seed(0)
    total = {"launches": 0, **{k: 0.0 for k in TIMES}}
    measured = {}
    for (map_name, c_run, kind), launches in sorted(shapes.items()):
        if (map_name, c_run) in measured:
            rec = dict(measured[(map_name, c_run)])
        elif args.cpu:
            a = cs.sel_inputs(graph, c_run, gen, map_name)
            out = oc.sel_fwd(*[a[k] for k in ("wstart", "anchors", "mc",
                                              "pall", "n_cols", "tile",
                                              "win")])
            cap = a["anchors"].shape[1]
            if out.shape != (cap, c_run) or not bool(
                    torch.isfinite(out).all()):
                raise AssertionError(f"sel_fwd {map_name} c={c_run}: "
                                     f"{tuple(out.shape)}")
            rec = {**cs.sel_shape_record(a, map_name),
                   **{k: None for k in CARD_FIELDS}}
        else:
            rec = cs.sel_record(graph, c_run, gen, map_name)
            cs._bound(rec, bw)
            torch.cuda.empty_cache()
        measured[(map_name, c_run)] = dict(rec)
        if not args.cpu:
            for k in TIMES:
                total[k] += launches * rec[k]
        rec["pass"] = kind
        rec["launches"] = launches
        total["launches"] += launches
        cs.emit(rec)
    if args.cpu:
        total.update({k: None for k in TIMES})
    cs.emit({"total_per_train_step": total, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
