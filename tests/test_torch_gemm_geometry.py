"""The onehot_gemm kernel's launch plan, its exact three-part split of W and
its microbenchmark's CPU mode, on the CPU.

``gemm_geometry`` decides the prepass's grid, the product's grid (one block
per 256 output rows, the last one ragged), the threads, the ring's stages
and the dynamic shared memory a block asks for; ``split_bf16x3`` is the
plain version of the prepass that splits the f32 W into three bf16 parts
for the tensor cores. None of it needs the card or JAX; the card checks the
compiled constants (``gemm_config``) and the prepass's parts against these.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from languagegroundedsemseg_torch.ops import onehot_ablation as oa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "languagegroundedsemseg_torch", "csrc",
                   "onehot_gemm.cu")
SMEM_LIMIT = 227 * 1024  # a Hopper block's dynamic shared memory
RTOL = 1e-5  # the kernel's tolerance against its plain version
# (n, cw, c_out): the script's shapes and the card tests'
PLANS = [(262144, 384, 96), (4096, 384, 96), (1000, 132, 32),
         (2048, 64, 16), (1000, 4, 96), (4097, 132, 16), (2048, 132, 96)]
# (n, b, w, cw, c_out, margin): the bench's --cpu shapes and a ragged cw
CPU_SHAPES = [(4096, 256, 512, 384, 96, 192), (1000, 40, 200, 132, 32, 75)]


def _wide_w(cw, c_out, seed):
    """W with exponents spread over 2^-60 .. 2^60 and random signs."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, (cw, c_out))
    exp = rng.integers(-60, 61, (cw, c_out))
    sign = rng.choice([-1.0, 1.0], (cw, c_out))
    return torch.from_numpy((sign * np.ldexp(mant, exp)).astype(np.float32))


@pytest.mark.parametrize("n", [1000, 2048, 4097, 262144])
def test_plan_covers_every_row_once(n):
    """Block b owns rows [b * rows, (b + 1) * rows) cut at n: every row of n
    in exactly one block, and no block empty."""
    geo = oa.gemm_geometry(n, 384, 96)
    rows = geo["rows_per_block"]
    assert geo["grid"] == [geo["blocks"]]
    counts = torch.bincount(torch.arange(n) // rows, minlength=geo["blocks"])
    assert counts.numel() == geo["blocks"]
    assert int(counts.sum()) == n and bool((counts > 0).all())
    assert bool((counts[:-1] == rows).all())


@pytest.mark.parametrize("n,cw,c_out", PLANS)
def test_shared_memory_fits_and_threads_match_rows(n, cw, c_out):
    geo = oa.gemm_geometry(n, cw, c_out)
    assert geo["smem_bytes"] <= SMEM_LIMIT
    assert geo["smem_bytes"] == oa._gemm_smem_bytes(c_out)
    # one thread a row: 8 warps over 256 rows
    assert geo["threads"] == geo["rows_per_block"] == 256
    # the warps tile the block's rows x c_out once
    rows, cols = geo["warp_tile"]
    assert rows % 16 == 0 and cols % 16 == 0
    assert rows * cols * geo["threads"] // 32 == geo["rows_per_block"] * c_out
    assert geo["stages"] >= 3
    # cw padded to whole steps, at most one step of padding
    cw_pad = geo["cw_pad"]
    assert cw_pad % geo["channels_per_step"] == 0
    assert cw <= cw_pad < cw + geo["channels_per_step"]
    assert geo["steps"] * geo["channels_per_step"] == cw_pad
    # the prepass: one thread per element of a part
    assert geo["split_shape"] == [3, cw_pad, c_out]
    threads = geo["split_grid"][0] * geo["split_threads"]
    assert cw_pad * c_out <= threads < cw_pad * c_out + geo["split_threads"]


def test_script_plan_halves_w_rereads_and_fits_one_block():
    """At the script's shapes W's parts are staged once per 256-row block:
    1,024 blocks x 221 KB = 226 MB from L2, half of 128-row blocks'; four
    stages of 52,736 B and the resolved rows fill 211,968 B, one block an
    SM (7.8 waves on 132 SMs)."""
    geo = oa.gemm_geometry(262144, 384, 96)
    assert geo["blocks"] == 1024 and geo["steps"] == 12
    split_bytes = 3 * 384 * 96 * 2
    assert split_bytes == 221184
    assert geo["blocks"] * split_bytes * 2 == (262144 // 128) * split_bytes
    assert geo["smem_bytes"] == 4 * (256 * 32 * 4 + 3 * 32 * 104 * 2) + 1024
    assert SMEM_LIMIT // 2 < geo["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("bad,match", [
    (dict(c_out=48), "c_out 48"), (dict(c_out=8), "c_out 8"),
    (dict(cw=130), "multiple of 4"), (dict(cw=0), "multiple of 4"),
    (dict(n=0), "n 0")])
def test_geometry_raises_for_shapes_the_kernel_does_not_take(bad, match):
    kw = dict(n=2048, cw=384, c_out=96)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        oa.gemm_geometry(**kw)


def test_python_copy_matches_the_kernel_source():
    """The constants gemm_geometry copies are those csrc/onehot_gemm.cu
    compiles (the card checks them again through gemm_config), and the
    product runs on bf16 mma.sync fed by cp.async copies and cvt.rn of
    the gathered f32 rows."""
    with open(SRC) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("BM"), const("BK"), const("STAGES"), const("THREADS"),
            const("PARTS"), const("SPLIT_THREADS")) == (
        oa._G_BM, oa._G_BK, oa._G_STAGES, oa._G_THREADS, oa._G_PARTS,
        oa._G_SPLIT_THREADS)
    for needle in ("cp.async.cg.shared.global",
                   "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "cvt.rn.bf16x2.f32", "ldmatrix.sync.aligned.m8n8.x4.trans",
                   "__float2bfloat16_rn"):
        assert needle in src, needle
    assert "fmaf" not in src


def _script_w():
    """The script's seeded W (gemm_inputs at GEMM_SHAPES, seed 0): the
    generator's draws of t3 skipped in chunks of rows (the same stream as
    one draw), so the (262144, 384) table is never held."""
    n, cw, c_out = (oa.GEMM_SHAPES[k] for k in ("n", "cw", "c_out"))
    rng = np.random.default_rng(0)
    for _ in range(n // 4096):
        rng.normal(size=(4096, cw))
    return torch.from_numpy(
        (rng.normal(size=(cw, c_out)) * 0.05).astype(np.float32))


@pytest.mark.parametrize("which", ["script", "wide", "edges"])
def test_split_adds_back_to_w_exactly(which):
    """Wh + Wm + Wl == W in float64 for the script's seeded W, for a W whose
    exponents span 2^-60 .. 2^60, and at the ends of the stated range
    (2^-110, just under 2^127 (2 - 2^-8)), with every bit of the
    significand set; Wh is W rounded to nearest bf16."""
    if which == "script":
        w = _script_w()
    elif which == "wide":
        w = _wide_w(384, 96, seed=3)
    else:
        full = 2.0 - 2.0 ** -23  # every significand bit set
        vals = [0.0, 2.0 ** -110, -full * 2.0 ** -110, full * 2.0 ** -100,
                1.0, -full, full * 2.0 ** 60, 2.0 ** 127 * (2 - 2.0 ** -8)
                - 2.0 ** 104, -(2.0 ** 127) * 1.5]
        w = torch.tensor(vals, dtype=torch.float32).reshape(-1, 1)
    parts = oa.split_bf16x3(w)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, *w.shape)
    assert torch.equal(parts[0], w.to(torch.bfloat16))
    assert bool(torch.isfinite(parts.float()).all())
    assert torch.equal(parts.double().sum(0), w.double())


def test_gemm_split_on_cpu_pads_zero_rows():
    """The CPU input runs the plain split, padded with zero rows to
    cw_pad as the prepass writes it."""
    w = _wide_w(100, 16, seed=4)
    parts = oa.gemm_split(w)
    assert parts.shape == (3, 128, 16) and parts.dtype == torch.bfloat16
    assert torch.equal(parts[:, :100], oa.split_bf16x3(w))
    assert not bool(parts[:, 100:].any())


def _three_part_product(g, parts):
    """The kernel's arithmetic emulated in f32: for each 16-channel slice,
    the slice's product with Wh, then Wm, then Wl added to one f32 sum
    (each product of bf16 values exact in f32)."""
    n, cw = g.shape
    acc = torch.zeros((n, parts.shape[2]), dtype=torch.float32)
    for k0 in range(0, cw, 16):
        a = g[:, k0:k0 + 16]
        for p in range(3):
            acc = acc + a @ parts[p, k0:k0 + 16].float()
    return acc


@pytest.mark.parametrize("shapes", CPU_SHAPES)
@pytest.mark.parametrize("wide", [False, True])
def test_three_part_product_matches_plain_version(shapes, wide):
    """The three-part product, emulated in f32, lies within the kernel's
    1e-5 of max |ref| of onehot_gemm_reference, with the script's W and
    with a wide-exponent W."""
    n, b, win, cw, c_out, margin = shapes
    a = oa.gemm_inputs(n, b, win, cw, c_out, margin, seed=n, device="cpu")
    w = _wide_w(cw, c_out, seed=n) if wide else a["w"]
    hit, rows = oa._gemm_hits(a["wstart"], a["anchors"], n, b, win)
    g = a["t3"][rows].to(torch.bfloat16).float() * hit[:, None]
    got = _three_part_product(g, oa.split_bf16x3(w))
    want = oa.onehot_gemm_reference(a["wstart"], a["anchors"], a["t3"], w, b,
                                    win)
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    print(f"three-part product {shapes} wide={wide}: {err / scale:.3e}")
    assert err <= RTOL * scale


def test_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor CUDA is refused before any launch."""
    a = oa.gemm_inputs(1024, 256, 512, 64, 16, 128, seed=0, device="cpu")
    args = [a["wstart"], a["anchors"], a["t3"].to("meta"), a["w"], 256, 512]
    with pytest.raises(ValueError, match="unsupported device"):
        oa.onehot_gemm(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        oa.gemm_split(a["w"].to("meta"))


# every key the bench prints for the kernel under --cpu: the shapes, the
# launch plan, the work and L2 bytes, and the card-only fields (null)
RECORD_KEYS = {"name", "n", "tile", "win", "cw", "c_out", "in_window_rows",
               "gemm_geometry", "l2_gather_bytes", "l2_w_bytes",
               "l2_fill_bytes_per_s", "arithmetic", "library_call", "bytes",
               "operations", "peak_ops_per_s", "max_abs_out",
               "oracle_rel_err", "root"}


def test_bench_cpu_prints_its_keys():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_onehot_gemm_torch as bench

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "PYTHON"))}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "scripts/bench_onehot_gemm_torch.py",
                          "--cpu"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    rec, last = [json.loads(l) for l in res.stdout.splitlines()]
    want = RECORD_KEYS | set(bench.CARD_FIELDS)
    assert set(rec) == want, set(rec) ^ want
    assert all(rec[k] is None for k in bench.CARD_FIELDS)
    n, cw, c_out = rec["n"], rec["cw"], rec["c_out"]
    geo = oa.gemm_geometry(n, cw, c_out)
    assert rec["gemm_geometry"] == geo
    assert rec["in_window_rows"] == n  # the script's anchors all hit
    assert rec["l2_gather_bytes"] == n * cw * 4
    assert rec["l2_w_bytes"] == geo["blocks"] * 3 * geo["cw_pad"] * c_out * 2
    assert rec["operations"] == 2 * n * cw * c_out
    assert rec["peak_ops_per_s"] == 989e12 / 3
    assert 0 < rec["oracle_rel_err"] < 1e-2 and rec["max_abs_out"] > 0
    assert last == {"device": "cpu", "root": None,
                    "summary": {k: None for k in bench.SUMMARY}}
