"""Readings that set the limits of ``correct``: one cell's numbers on a
list of seeds for the sound program, its bf16 path (the control) and the
planted faults, in one process. The benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 \
        --variants sound bf16 half_batch altered [--out chiprun_out/calib]

Each (seed, variant) runs the cell's set-up, its three proof steps, a
window of ``--seconds`` and the reference, and appends one JSON line (the
numbers compared) to ``<out>/<cell>.jsonl``. Variants: ``sound``, ``bf16``
(the program with ``compute_dtype bfloat16``), ``half_batch`` (the
objective over half the real rows), ``altered`` (one output of the first
voxel moved by 10), ``frozen`` (the update skipped). Needs CUDA.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["sound"])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "calib"))
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]
    import torch

    from lgsb import harness
    from lgsb.judge import NUMBERS

    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 3
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.workload}.jsonl")
    for seed in args.seeds:
        for variant in args.variants:
            t0 = time.perf_counter()
            r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                                 t0, variant=None if variant == "sound" else variant,
                                 warmup=False)
            line = {"workload": args.workload, "seed": seed, "variant": variant,
                    "numbers": {**{k: v["value"] for k, v in r["compared"].items()},
                                **{k: r["detail"][k] for k in NUMBERS
                                   if k in r["detail"]}},
                    "detail": r["detail"], "run_s": time.perf_counter() - t0,
                    "kind": r["device"]["kind"]}
            with open(path, "a") as f:
                f.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
