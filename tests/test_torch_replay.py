"""scripts/replay_learning_curve_torch.py's CPU mode: the recorded run's
flags through the port's CLI at SyntheticTiny20Dataset size, one JSON line
per epoch and a summary."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH_KEYS = {"epoch", "step", "time_s", "train_loss", "val_miou", "val_loss"}
SUMMARY_KEYS = {"summary", "device", "epochs", "steps", "seconds", "argv",
                "train_loss_first", "train_loss_last", "val_miou_first",
                "val_miou_last", "val_loss_first", "val_loss_last",
                "test_val_miou"}


def test_replay_cpu_prints_epochs_and_summary():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "PYTHON"))}
    env["PYTHONPATH"] = REPO
    # one intra-op thread: see tests/test_torch_trainer.py:one_torch_thread
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "scripts/replay_learning_curve_torch.py",
                          "--cpu", "--epochs", "2"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(l) for l in res.stdout.splitlines()]
    epochs, summary = lines[:-1], lines[-1]
    assert [e["epoch"] for e in epochs] == [0, 1]
    assert [e["step"] for e in epochs] == [2, 4]
    for e in epochs:
        assert set(e) == EPOCH_KEYS
        assert np.isfinite(e["train_loss"]) and 0.0 <= e["val_miou"] <= 1.0
    assert set(summary) == SUMMARY_KEYS
    assert summary["device"] == "cpu" and summary["steps"] == 4
    argv = summary["argv"]
    # the record's flags that differ from the defaults, and the CPU sizes
    for flag, value in (("--stat_freq", "4"), ("--max_epoch", "2"),
                        ("--dataset", "SyntheticTiny20Dataset")):
        assert argv[argv.index(flag) + 1] == value
