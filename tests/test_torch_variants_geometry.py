"""The onehot_variants kernel's launch plan and its microbenchmark's CPU
mode, on the CPU.

``variants_geometry`` decides the grid (one block per 256 output rows, the
last one ragged), the threads, the ring's stages and the dynamic shared
memory a block asks for. None of it needs the card or JAX; the card checks
the compiled constants against it (``variants_config``).
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from languagegroundedsemseg_torch.ops import onehot_ablation as oa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "languagegroundedsemseg_torch", "csrc",
                   "onehot_variants.cu")
SMEM_LIMIT = 227 * 1024  # a Hopper block's dynamic shared memory
# (cap, cw, c_out, n_cols): the script's shapes, the card tests' and the
# widest plan (c_out 96 at 15 columns)
PLANS = [(262144, 384, 96, 9), (1000, 136, 96, 9), (2048, 128, 32, 9),
         (3072, 384, 96, 9), (4097, 96, 32, 9), (2048, 64, 16, 9),
         (2048, 136, 96, 3), (3072, 128, 96, 15)]


@pytest.mark.parametrize("cap", [1000, 2048, 3072, 262144])
def test_plan_covers_every_row_once(cap):
    """Block b owns rows [b * rows, (b + 1) * rows) cut at cap: every row
    of cap in exactly one block, and no block empty."""
    geo = oa.variants_geometry(cap, 384, 96, 9)
    rows = geo["rows_per_block"]
    assert geo["grid"] == [geo["blocks"]]
    owner = torch.arange(cap) // rows
    counts = torch.bincount(owner, minlength=geo["blocks"])
    assert counts.numel() == geo["blocks"]
    assert int(counts.sum()) == cap and bool((counts > 0).all())
    assert bool((counts[:-1] == rows).all())


@pytest.mark.parametrize("cap,cw,c_out,n_cols", PLANS)
def test_shared_memory_fits_and_threads_match_rows(cap, cw, c_out, n_cols):
    geo = oa.variants_geometry(cap, cw, c_out, n_cols)
    assert geo["smem_bytes"] <= SMEM_LIMIT
    assert geo["smem_bytes"] == oa._variants_smem_bytes(c_out, n_cols)
    # two threads a row: 16 warps over 256 rows
    assert geo["threads"] == 2 * geo["rows_per_block"] == 512
    # the warps tile the block's rows x c_out once
    rows, cols = geo["warp_tile"]
    assert rows % 16 == 0 and cols % 16 == 0
    assert rows * cols * geo["threads"] // 32 == geo["rows_per_block"] * c_out
    assert geo["stages"] >= 3
    assert geo["steps"] == n_cols * -(-cw // geo["channels_per_step"])


def test_script_plan_reads_half_the_w_bytes_of_128_row_blocks():
    """At the ablation script's shapes W is staged once per 256-row block:
    1,024 blocks x 9 x 384 x 96 x 2 B, at most 0.7 GB from L2."""
    geo = oa.variants_geometry(262144, 384, 96, 9)
    assert geo["blocks"] == 1024
    w_bytes = geo["blocks"] * 9 * 384 * 96 * 2
    assert w_bytes <= 0.7e9
    assert w_bytes * 2 == (262144 // 128) * 9 * 384 * 96 * 2


@pytest.mark.parametrize("bad,match", [
    (dict(c_out=48), "c_out 48"), (dict(c_out=8), "c_out 8"),
    (dict(cw=100), "multiple of 8"), (dict(cw=0), "multiple of 8"),
    (dict(cw=64, c_out=96), "at least c_out"),
    (dict(n_cols=18), "at most 16"), (dict(n_cols=8), "3 per group"),
    (dict(n_cols=0), "weight columns"), (dict(cap=0), "cap")])
def test_geometry_raises_for_shapes_the_kernel_does_not_take(bad, match):
    kw = dict(cap=2048, cw=384, c_out=96, n_cols=9)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        oa.variants_geometry(**kw)


def test_python_copy_matches_the_kernel_source():
    """The constants variants_geometry copies are those csrc/onehot_variants.cu
    compiles (the card checks them again through variants_config)."""
    with open(SRC) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("BM"), const("BK"), const("STAGES"), const("THREADS"),
            const("MAX_COLS")) == (oa._V_BM, oa._V_BK, oa._V_STAGES,
                                   oa._V_THREADS, oa._V_MAX_COLS)
    assert "cp.async.cg.shared.global" in src


def test_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor CUDA is refused before any launch."""
    a = oa.variants_inputs(1024, 256, 384, 3, 64, 16, seed=0, device="cpu")
    args = [a["wstart"], a["anchors"], a["t3"].to("meta"), a["w"], 256, 384,
            3]
    with pytest.raises(ValueError, match="unsupported device"):
        oa.onehot_variants("full", *args)


# every key a card run prints for a mode: the shapes, the launch plan, the
# work and L2 bytes, and the card-only fields
MODE_KEYS = {"name", "mode", "cap", "tile", "win", "n_groups", "cw", "c_out",
             "rows_read", "variants_geometry", "l2_gather_bytes",
             "l2_w_bytes", "l2_fill_bytes_per_s", "library_call", "bytes",
             "operations", "peak_ops_per_s"}


def test_bench_cpu_prints_its_keys():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_onehot_variants_torch as bench

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "PYTHON"))}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable,
                          "scripts/bench_onehot_variants_torch.py", "--cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(l) for l in res.stdout.splitlines()]
    modes, last = lines[:-1], lines[-1]
    assert [r["mode"] for r in modes] == list(oa.MODES)
    want = MODE_KEYS | set(bench.CARD_FIELDS) | {"max_abs_out"}
    for rec in modes:
        assert set(rec) == want, set(rec) ^ want
        assert rec["ms"] is None and rec["device_ms"] is None
        assert rec["variants_geometry"] == oa.variants_geometry(
            rec["cap"], rec["cw"], rec["c_out"], 3 * rec["n_groups"])
    full = modes[0]
    assert full["rows_read"] > 0 and full["max_abs_out"] > 0
    assert full["l2_gather_bytes"] == full["rows_read"] * full["cw"] * 2
    assert modes[1]["max_abs_out"] == 0 and modes[1]["l2_gather_bytes"] == 0
    assert modes[3]["l2_w_bytes"] == 0
    assert last == {"device": "cpu", "by_mode": {
        m: {"ms": None, "device_ms": None, "bound_ms": None,
            "l2_floor_ms": None} for m in oa.MODES}}
