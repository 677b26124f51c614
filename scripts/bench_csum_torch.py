"""The child-sum kernel at every shape the Res16UNet34C train step gives it.

    python3 scripts/bench_csum_torch.py
    python3 scripts/bench_csum_torch.py --cpu

Builds chip_smoke.py's main-path batch (4 synthetic scenes x 180,000
points, compact wire format) and lists the ``csum`` launches one SGD train
step of Res16UNet34C (200 classes) makes: one per down conv on a windowed
down map (the forward, c_run = the conv's c_out) and one per up conv whose
companion down map is windowed (its dX, c_run = the up conv's c_in), 8 in
all, checked against ``chip_smoke.expected_launches``. For each (map,
c_run) it runs ``csum`` on that map's group parents and window starts with
seeded bf16 P (``chip_smoke.csum_record``): on the card it holds the kernel
to its plain version (``chip_smoke.KERNEL_RTOL`` of max |ref|), checks that
a second launch is bit-equal, and times the kernel, the plain version and
``index_add_`` of the summed rows (CUDA events, median of 20, per call with
the host's time; and back to back on the device), beside the bound. Prints
the card's name and power limit, one JSON line per shape with its launch
plan, compiled constants and ptxas usage, then the totals per train step
(launches x ms). ``--cpu`` runs the plain version at a few thousand points
per scene with null device fields: a CPU run gives no device time.
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

CPU_POINTS = 6000  # per scene, for --cpu: every down map windowed
# the fields a record gets only from the card (null under --cpu)
CARD_FIELDS = ("config", "blocks_per_sm", "ptxas", "max_abs_err",
               "max_abs_ref", "bit_equal_relaunch", "ms", "plain_ms",
               "library_ms", "device_ms", "library_device_ms", "bound_ms",
               "bound_by")
TIMES = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms",
         "bound_ms")


def csum_launches(model, graph) -> Counter:
    """(down map, c_run, pass) -> csum launches in one train step: "forward"
    for a down conv on a windowed ChildSumMap, "up_dx" for an up conv whose
    companion down map is windowed (``onehot_conv._cs_window``)."""
    from languagegroundedsemseg_torch.models.layers import SparseConv
    from languagegroundedsemseg_torch.ops.onehot_conv import _cs_window
    from languagegroundedsemseg_torch.sparse.types import ChildSumMap

    shapes = Counter()
    for mod in model.modules():
        if not isinstance(mod, SparseConv) or mod.map_name is None:
            continue
        _, c_in, c_out = mod.kernel.shape
        gm = graph.gmaps.get(mod.map_name)
        if isinstance(gm, ChildSumMap):
            level = graph.levels[int(mod.map_name[4:])].capacity
            if _cs_window(gm, level)[0]:
                shapes[(mod.map_name, c_out, "forward")] += 1
        elif gm is None:
            name = graph.maps[mod.map_name].companion
            cgm = graph.gmaps.get(name)
            if (isinstance(cgm, ChildSumMap)
                    and _cs_window(cgm, cgm.in_capacity)[0]):
                shapes[(name, c_in, "up_dx")] += 1
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
        print("bench_csum_torch: no CUDA device (--cpu runs the plain "
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
        cs.emit({"csum_config": oc.csum_config(),
                 "ptxas": cuda_kernels.ptxas_usage("csum", "csum_kernel")})

    rng = np.random.default_rng(0)
    scenes = [voxelize_scene(rng, points, raw_color=True)
              for _ in range(cs.SCENES)]
    builder = BatchBuilder(spec=res16unet_graph_spec(), ship_coords=False,
                           compact_feats=True)
    graph = builder.build_host(scenes).to(device).graph
    model = Res16UNet34C(out_channels=200, device=device)
    shapes = csum_launches(model, graph)
    want = cs.expected_launches(model, graph, train=True)["csum"]
    if sum(shapes.values()) != want:
        raise AssertionError(f"csum shapes count {sum(shapes.values())} "
                             f"launches, the train step makes {want}")
    gen = torch.Generator(device=device).manual_seed(0)
    total = {"launches": 0, **{k: 0.0 for k in TIMES}}
    for (map_name, c_run, kind), launches in sorted(shapes.items()):
        if args.cpu:
            a = cs.csum_inputs(graph, c_run, gen, map_name)
            out = oc.csum(*[a[k] for k in ("wstart", "parent_g", "pall",
                                           "cap_out", "tile", "win",
                                           "n_groups")])
            if out.shape != (a["cap_out"], c_run) or not bool(
                    torch.isfinite(out).all()):
                raise AssertionError(f"csum {map_name} c={c_run}: "
                                     f"{tuple(out.shape)}")
            rec = {**cs.csum_shape_record(a, map_name),
                   **{k: None for k in CARD_FIELDS}}
        else:
            rec = cs.csum_record(graph, c_run, gen, map_name)
            cs._bound(rec, bw)
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
