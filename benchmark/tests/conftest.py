"""Fixtures of the benchmark's CPU tests: a checkout-like root holding the
benchmark with a tiny cell (Res16UNet14A, 20 classes, scenes of about
1,500 points) beside the program, so a whole run fits a test."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "benchmark")
sys.path[:0] = [BENCH, REPO]

TINY_LAW = {"median": 1500, "log_sigma": 0.6, "min": 800, "max": 4000}
# limits of the tiny cell, read off CPU runs of the sound program, its bf16
# path and the planted faults at this size (benchmark/tests/test_bench_faults.py)
TINY_LIMITS = {"batch_mismatch": 0.0, "output_gap": 0.3, "loss_gap": 0.005,
               "grad_gap": 0.05, "change_gap": 0.3, "stage_gap": 1e-4}


def make_root(dst: str) -> str:
    """``dst`` laid out as a checkout: BENCHMARK.json with the tiny cells,
    a copy of the benchmark with their files, the program beside it."""
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "languagegroundedsemseg_torch"),
               os.path.join(dst, "languagegroundedsemseg_torch"))
    with open(os.path.join(BENCH, "configs", "res16unet34c.json")) as f:
        cfg = json.load(f)
    cfg.update(model="Res16UNet14A", planes=[32, 64, 128, 256, 128, 128, 96, 96],
               layers=[1] * 8, num_classes=20, batch_size=2,
               train_limit_numpoints=100000, limits=TINY_LIMITS)
    with open(os.path.join(dst, "benchmark", "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    for mix, extra in (("resident", dict(ring_batches=3, num_workers=2,
                                         warmup_steps=3, trace_steps=2)),
                       ("loader", dict(pool_scenes=6, num_workers=2,
                                       warmup_steps=4, trace_steps=2))):
        with open(os.path.join(BENCH, "traffic", f"{mix}.json")) as f:
            t = json.load(f)
        t.update(extra, scene_points=TINY_LAW)
        with open(os.path.join(dst, "benchmark", "traffic", f"tiny_{mix}.json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": "tests",
                         "file": "benchmark/configs/tiny.json", "reduced": [],
                         "why": "a size a test can hold"}]
    bench["workloads"] = [
        {"name": "tiny.resident", "config": "tiny", "traffic": "tiny_resident",
         "chips": 1, "why": "resident ring"},
        {"name": "tiny.loader", "config": "tiny", "traffic": "tiny_loader",
         "chips": 1, "why": "loader-fed"}]
    for m in bench["per_layer"] + bench["end_to_end"]:
        m.pop("workloads", None)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("checkout")))


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
