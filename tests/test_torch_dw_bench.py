"""scripts/bench_dw_torch.py's CPU mode: the plain dw version at every
shape a small main-path batch's train step gives it, one JSON line each and
a total, with null device times."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE_KEYS = {"name", "map", "cw", "c_out", "cap", "launches", "cw_kernel",
              "rows_per_split", "splits", "grid", "blocks", "max_abs_err",
              "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"}


def test_bench_dw_cpu_prints_shapes_and_total():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "PYTHON"))}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "scripts/bench_dw_torch.py", "--cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(l) for l in res.stdout.splitlines()]
    shapes, total = lines[:-1], lines[-1]
    assert shapes and total["device"] == "cpu"
    for rec in shapes:
        assert SHAPE_KEYS <= set(rec), SHAPE_KEYS - set(rec)
        assert rec["name"] == "dw" and rec["launches"] >= 1
        assert rec["cw_kernel"] % 8 == 0 and rec["cw_kernel"] >= rec["cw"]
        assert rec["ms"] is None and rec["library_ms"] is None
    # conv0 (3C = 9) and block1's convs (3C = 96 on the L1 map) are there
    assert {(r["map"], r["cw"], r["c_out"]) for r in shapes} >= {
        ("l0.k3", 9, 32), ("l1.k3", 96, 32)}
    assert total["total_per_train_step"]["launches"] == sum(
        r["launches"] for r in shapes)
    assert total["total_per_train_step"]["ms"] is None
