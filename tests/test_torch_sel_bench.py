"""scripts/bench_sel_fwd_torch.py's CPU mode: the plain sel_fwd version at
every shape a small main-path batch's train step gives it (all five k3 maps
windowed at 20,000 points a scene), one JSON line each and a total of 93
launches, with null device fields."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import bench_sel_fwd_torch  # noqa: E402

# every key a card run prints for a shape: the shape's own fields, the
# launch plan (sel_geometry), and the card-only fields
SHAPE_KEYS = {"name", "map", "c_run", "pass", "launches", "cap", "tile", "win",
              "anchored_rows", "grid", "blocks", "threads", "rows_per_block",
              "chunk", "splits", "smem_bytes", "items_per_thread",
              "library_call", "bytes", "operations", "peak_ops_per_s",
              *bench_sel_fwd_torch.CARD_FIELDS}
# Res16UNet34C's k3 convs per level: (c_run, pass) -> launches in one train
# step; forward at c_out, dX at c_in (conv0's input takes no gradient)
TRAIN_SHAPES = {
    ("l0.k3", 32, "forward"): 1, ("l0.k3", 96, "forward"): 4,
    ("l0.k3", 128, "dx"): 1, ("l0.k3", 96, "dx"): 3,
    ("l1.k3", 32, "forward"): 4, ("l1.k3", 96, "forward"): 4,
    ("l1.k3", 32, "dx"): 4, ("l1.k3", 128, "dx"): 1, ("l1.k3", 96, "dx"): 3,
    ("l2.k3", 64, "forward"): 6, ("l2.k3", 128, "forward"): 4,
    ("l2.k3", 32, "dx"): 1, ("l2.k3", 64, "dx"): 5, ("l2.k3", 192, "dx"): 1,
    ("l2.k3", 128, "dx"): 3,
    ("l3.k3", 128, "forward"): 8, ("l3.k3", 256, "forward"): 4,
    ("l3.k3", 64, "dx"): 1, ("l3.k3", 128, "dx"): 7, ("l3.k3", 384, "dx"): 1,
    ("l3.k3", 256, "dx"): 3,
    ("l4.k3", 256, "forward"): 12, ("l4.k3", 128, "dx"): 1,
    ("l4.k3", 256, "dx"): 11}


def test_bench_sel_fwd_cpu_prints_the_train_steps_shapes():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "PYTHON"))}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "scripts/bench_sel_fwd_torch.py",
                          "--cpu"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(l) for l in res.stdout.splitlines()]
    shapes, total = lines[:-1], lines[-1]
    assert total["device"] == "cpu"
    for rec in shapes:
        assert set(rec) == SHAPE_KEYS, set(rec) ^ SHAPE_KEYS
        assert rec["name"] == "sel_fwd"
        assert rec["ms"] is None and rec["device_ms"] is None
        assert rec["grid"][0] * rec["rows_per_block"] == rec["cap"]
        assert rec["anchored_rows"] > 0
    got = {(r["map"], r["c_run"], r["pass"]): r["launches"] for r in shapes}
    assert got == TRAIN_SHAPES
    assert total["total_per_train_step"]["launches"] == 93 == sum(got.values())
    assert total["total_per_train_step"]["ms"] is None
