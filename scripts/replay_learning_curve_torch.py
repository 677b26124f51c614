"""Replay the recorded learning curve through the port's command line.

    python3 scripts/replay_learning_curve_torch.py [--epochs 20] [--out DIR]
    python3 scripts/replay_learning_curve_torch.py --cpu --epochs 2

Reads ``outputs/learning_curve_r5/config.json`` (the JAX package's recorded
run: Res16UNet34C on Synthetic200Voxelization2cmDataset, 16 scenes x 60,000
points, batch 4, 4 steps an epoch, SGD lr 0.05, MultiStepLR, seed 42),
turns every field that differs from the port's ``Config`` defaults into a
flag, and trains with ``languagegroundedsemseg_torch.cli.main.main`` on the
card for ``--epochs`` epochs (20 in the record), validating every epoch.
Prints one JSON line per epoch (the port's train_loss / val_miou / val_loss
beside the record's for the same epoch, from
``outputs/learning_curve_r5/metrics.jsonl``), then a summary line with the
trend of each, the wall seconds and, on the card, its name and power
limit. The trainer's own output goes to stderr. Checkpoints go to a
temporary log dir (``--out`` keeps its metrics.jsonl and config.json).
``--cpu`` runs on the CPU at ``SyntheticTiny20Dataset`` size (Res16UNet14A,
capacity 2048, one worker).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RECORD = os.path.join(ROOT, "outputs", "learning_curve_r5")
CPU_FLAGS = {"dataset": "SyntheticTiny20Dataset", "model": "Res16UNet14A",
             "fixed_capacity": 2048, "num_workers": 1, "num_val_workers": 1,
             "batch_size": 2, "val_batch_size": 2}


def _flag(v) -> str:
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v)
    return str(v)


def replay_argv(config_path: str, log_dir: str, epochs: int, cpu: bool) -> list:
    """The record's non-default fields as flags, with ``log_dir`` and
    ``max_epoch`` replaced (and, with ``cpu``, the tiny sizes)."""
    from languagegroundedsemseg_torch.config import Config

    with open(config_path) as f:
        fields = json.load(f)
    fields.update(log_dir=log_dir, max_epoch=epochs, tensorboard=False)
    if cpu:
        fields.update(CPU_FLAGS)
    defaults = dataclasses.asdict(Config())
    argv = []
    for k, v in fields.items():
        d = defaults[k]
        if (list(d) if isinstance(d, tuple) else d) != v:
            argv += [f"--{k}", _flag(v)]
    return argv


def _epochs(path: str) -> list:
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("phase") == "epoch"]


def _card() -> dict:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None, help="keep metrics.jsonl and config.json here")
    args = ap.parse_args(argv)

    from languagegroundedsemseg_torch.cli.main import main as cli_main

    device = "cpu" if args.cpu else "cuda"
    reference = _epochs(os.path.join(RECORD, "metrics.jsonl"))
    with tempfile.TemporaryDirectory(prefix="lgs_replay_") as log_dir:
        run_argv = replay_argv(os.path.join(RECORD, "config.json"), log_dir,
                               args.epochs, args.cpu)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            test_metrics = cli_main(run_argv, device=device)
        seconds = time.perf_counter() - t0
        epochs = _epochs(os.path.join(log_dir, "metrics.jsonl"))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            for name in ("metrics.jsonl", "config.json"):
                shutil.copy(os.path.join(log_dir, name), os.path.join(args.out, name))

    keys = ("train_loss", "val_miou", "val_loss")
    for i, r in enumerate(epochs):
        line = {"epoch": int(r["epoch"]), "step": int(r["step"]),
                "time_s": r["time_s"], **{k: r[k] for k in keys}}
        if not args.cpu and i < len(reference):
            line.update({f"reference_{k}": reference[i][k] for k in keys})
        print(json.dumps(line), flush=True)
    summary = {"summary": True, "device": device, "epochs": len(epochs),
               "steps": int(epochs[-1]["step"]) if epochs else 0,
               "seconds": seconds, "argv": run_argv,
               **{f"{k}_first": epochs[0][k] for k in keys},
               **{f"{k}_last": epochs[-1][k] for k in keys},
               "test_val_miou": test_metrics["val_miou"]}
    if not args.cpu:
        summary.update(_card())
        summary.update({f"reference_{k}_{end}": reference[i][k] for k in keys
                        for end, i in (("first", 0), ("last", -1))})
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
