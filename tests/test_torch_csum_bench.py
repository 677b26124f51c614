"""scripts/bench_csum_torch.py's CPU mode: the plain csum version at every
shape a small main-path batch's train step gives it (every down map
windowed at 6,000 points a scene), one JSON line each and a total, with
null device fields."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import bench_csum_torch  # noqa: E402

# every key a card run prints for a shape: the shape's own fields, the
# launch plan (csum_geometry), and the card-only fields
SHAPE_KEYS = {"name", "map", "c_run", "pass", "launches", "cap_in", "cap_out",
              "tile", "win", "n_groups", "summed_rows", "grid", "blocks",
              "threads", "smem_bytes", "splits", "chunk", "entries",
              "hit_capacity", "library_call", "bytes", "operations",
              "peak_ops_per_s", *bench_csum_torch.CARD_FIELDS}
# the Res16UNet34C train step's csum launches: the down convs' forward at
# their c_out, the up convs' dX at their c_in
TRAIN_SHAPES = {("down0", 32, "forward"), ("down1", 32, "forward"),
                ("down2", 64, "forward"), ("down3", 128, "forward"),
                ("down0", 96, "up_dx"), ("down1", 128, "up_dx"),
                ("down2", 256, "up_dx"), ("down3", 256, "up_dx")}


def test_bench_csum_cpu_prints_the_train_steps_shapes():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "PYTHON"))}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "scripts/bench_csum_torch.py",
                          "--cpu"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(l) for l in res.stdout.splitlines()]
    shapes, total = lines[:-1], lines[-1]
    assert total["device"] == "cpu"
    for rec in shapes:
        assert set(rec) == SHAPE_KEYS, set(rec) ^ SHAPE_KEYS
        assert rec["name"] == "csum" and rec["launches"] == 1
        assert rec["ms"] is None and rec["device_ms"] is None
        assert rec["chunk"] * (rec["splits"] - 1) < rec["c_run"] <= (
            rec["chunk"] * rec["splits"])
        assert rec["summed_rows"] > 0
    got = {(r["map"], r["c_run"], r["pass"]) for r in shapes}
    assert got == TRAIN_SHAPES
    assert sum(r["pass"] == "forward" for r in shapes) == 4
    assert total["total_per_train_step"]["launches"] == 8
    assert total["total_per_train_step"]["ms"] is None
