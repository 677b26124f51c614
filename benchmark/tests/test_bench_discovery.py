"""A configuration, a traffic mix and a metric dropped in as new files
(and entries of BENCHMARK.json) are found by name; no file that is there
changes."""

import json
import os
import time

from lgsb import harness

from conftest import make_root


def test_new_files_are_found(tmp_path):
    root = make_root(str(tmp_path))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["batch_size"] = 1
    with open(os.path.join(b, "configs", "tiny_b1.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "tiny_resident.json")) as f:
        mix = json.load(f)
    mix["ring_batches"] = 4
    with open(os.path.join(b, "traffic", "ring4.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(b, "metrics", "steps_in_window.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.window.steps\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_b1", "source": "tests",
                             "file": "benchmark/configs/tiny_b1.json",
                             "reduced": [], "why": "one scene a batch"})
    bench["workloads"].append({"name": "tiny_b1.ring4", "config": "tiny_b1",
                               "traffic": "ring4", "chips": 1, "why": "new"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "train_scenes_per_s",
                               "workloads": ["tiny_b1.ring4"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    spec = harness.cell_spec(root, "tiny_b1.ring4")
    assert spec.cfg["batch_size"] == 1 and spec.traffic["ring_batches"] == 4
    assert "steps_in_window" in spec.per_layer
    r = harness.run_cell(root, "tiny_b1.ring4", 7, 0.3, True, time.perf_counter(),
                         device="cpu", warmup=False)
    assert r["metrics"]["steps_in_window"]["value"] >= 1
    assert r["correct"]
