"""A contrastive cell through the harness on the CPU: the representation
step (Res16UNet14A's features against 20 seeded unit anchors of width 96,
3 negatives, the final ReLU stripped) is proved against the plain
reference's forward and contrastive loss, correct when sound, and not
correct when half of the batch is left out. The root is built here: a
checkout-like copy of the benchmark with one tiny contrastive cell beside
the program."""

import json
import os
import shutil
import time

import pytest

from lgsb import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "benchmark")
SEED = 2 ** 31 + 2222
# read off CPU runs of this cell, as the tiny cross-entropy cell's limits
LIMITS = {"batch_mismatch": 0.0, "output_gap": 0.3, "loss_gap": 0.005,
          "grad_gap": 0.05, "change_gap": 0.3, "stage_gap": 1e-4}


@pytest.fixture(scope="module")
def contrastive_root(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("contrastive_checkout"))
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "languagegroundedsemseg_torch"),
               os.path.join(dst, "languagegroundedsemseg_torch"))
    with open(os.path.join(BENCH, "configs", "res16unet34d_lg.json")) as f:
        cfg = json.load(f)
    cfg.update(model="Res16UNet14A", planes=[32, 64, 128, 256, 128, 128, 96, 96],
               layers=[1] * 8, num_classes=20, anchor_dim=96, batch_size=2,
               train_limit_numpoints=100000, limits=LIMITS)
    with open(os.path.join(dst, "benchmark", "configs", "tiny_lg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(BENCH, "traffic", "resident.json")) as f:
        traffic = json.load(f)
    traffic.update(ring_batches=3, num_workers=2, warmup_steps=3, trace_steps=2,
                   scene_points={"median": 1500, "log_sigma": 0.6, "min": 800,
                                 "max": 4000})
    with open(os.path.join(dst, "benchmark", "traffic", "tiny_resident.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny_lg", "source": "tests",
                         "file": "benchmark/configs/tiny_lg.json", "reduced": [],
                         "why": "a size a test can hold"}]
    bench["workloads"] = [{"name": "tiny_lg.resident", "config": "tiny_lg",
                           "traffic": "tiny_resident", "chips": 1,
                           "why": "resident ring"}]
    for m in bench["per_layer"] + bench["end_to_end"]:
        m.pop("workloads", None)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


def run(root, variant):
    return harness.run_cell(root, "tiny_lg.resident", SEED, 0.2, False,
                            time.perf_counter(), device="cpu", variant=variant,
                            warmup=False)


def test_sound_contrastive_run_is_correct(contrastive_root):
    r = run(contrastive_root, None)
    got = {k: v["value"] for k, v in r["compared"].items()}
    print(json.dumps(got))  # shown by pytest -rP
    assert got["batch_mismatch"] == 0
    assert r["correct"], got
    # the classifier gets no gradient in a representation step
    assert any(n.startswith("final.") for n in r["detail"]["leaves_left_out"])


def test_half_batch_contrastive_run_is_not_correct(contrastive_root):
    r = run(contrastive_root, "half_batch")
    print(json.dumps({k: v["value"] for k, v in r["compared"].items()}))
    assert not r["correct"]
    c = r["compared"]["loss_gap"]
    assert c["value"] > c["limit"]
