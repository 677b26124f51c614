"""The dw kernel's launch geometry and its conv0 padding, on the CPU.

``_dw_splits`` decides how the rows of a dw launch are cut over blocks, and
with it the order of the f32 sum; ``_dw_pad_cols`` widens conv0's 9-column
T3 to the kernel's 16-byte copies. Neither needs the card or JAX.
"""

import numpy as np
import pytest
import torch

from languagegroundedsemseg_torch.ops import onehot_conv as oc

R = oc.DW_RESIDENT_BLOCKS
# (cap, 3C, n_cols * c_out): the main path's launches at full size (L0 ..
# L4 capacities of chip_smoke's batch), small caps, and a cap that is not a
# multiple of the chunk
SHAPES = [(589824, 288, 768), (589824, 384, 768), (589824, 96, 256),
          (589824, 16, 256), (180224, 192, 512), (180224, 96, 256),
          (57344, 384, 1024), (57344, 576, 1024), (18432, 1152, 2048),
          (18432, 768, 2048), (4096, 384, 768), (4096, 16, 256),
          (5888, 288, 768), (1000, 96, 256), (64, 96, 256)]


def _tiles(cw, n_total):
    return -(-cw // oc._DW_BM) * -(-n_total // oc._DW_BN)


@pytest.mark.parametrize("cap,cw,n_total", SHAPES)
def test_every_row_in_exactly_one_split(cap, cw, n_total):
    rows, n_split = oc._dw_splits(cap, cw, n_total)
    owner = np.full(cap, -1)
    for s in range(n_split):
        lo, hi = s * rows, min((s + 1) * rows, cap)
        assert lo < hi, f"split {s} is empty"
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
    assert (owner >= 0).all()


@pytest.mark.parametrize("cap,cw,n_total", SHAPES)
def test_rows_per_split_are_whole_chunks(cap, cw, n_total):
    rows, n_split = oc._dw_splits(cap, cw, n_total)
    assert rows % oc._DW_BK == 0
    chunks = -(-cap // oc._DW_BK)
    assert rows >= oc._DW_BK * min(chunks, oc.DW_MIN_CHUNKS)


@pytest.mark.parametrize("cap,cw,n_total", SHAPES)
def test_splits_are_a_function_of_the_shapes(cap, cw, n_total):
    """The sum order is fixed by the split count: the same shapes give the
    same answer, cached or computed afresh."""
    first = oc._dw_splits(cap, cw, n_total)
    assert oc._dw_splits.__wrapped__(cap, cw, n_total) == first
    assert oc._dw_splits(cap, cw, n_total) == first


@pytest.mark.parametrize("cw,n_total", [(288, 768), (384, 768), (96, 256),
                                        (16, 256)])
def test_l0_grid_is_whole_waves(cw, n_total):
    """At L0 (589,824 rows) the rows allow a grid of whole waves of the
    resident blocks."""
    _, n_split = oc._dw_splits(589824, cw, n_total)
    assert _tiles(cw, n_total) * n_split % R == 0


@pytest.mark.parametrize("cap,cw,n_total", [s for s in SHAPES
                                            if s[0] >= 18432])
def test_waves_keep_resident_blocks_busy(cap, cw, n_total):
    """Where a split holds many chunks, the resident block slots are at
    least 90% busy over the waves the grid takes."""
    rows, n_split = oc._dw_splits(cap, cw, n_total)
    tiles = _tiles(cw, n_total)
    waves = -(-tiles * n_split // R)
    assert tiles * cap >= 0.9 * waves * R * rows


def test_geometry_pads_conv0_and_matches_splits():
    geo = oc.dw_geometry(589824, 9, 32, 8)
    assert geo["cw_kernel"] == 16
    rows, n_split = oc._dw_splits(589824, 16, 256)
    assert (geo["rows_per_split"], geo["splits"]) == (rows, n_split)
    assert geo["grid"] == [1, 2, n_split]
    assert geo["blocks"] == 2 * n_split
    assert oc.dw_geometry(589824, 288, 96, 8)["grid"] == [3, 6, 44]


def test_padded_reference_sliced_equals_unpadded():
    """conv0's T3 (3C = 9) zero-padded to 16 columns gives the same dW in
    its first 9 rows and zeros in the rest."""
    rng = np.random.default_rng(3)
    cap, tile, win, n_cols = 2048, 256, 512, 8
    wstart = rng.integers(0, cap - win + 1, size=(cap // tile) * n_cols)
    wstart = torch.from_numpy((wstart // 8 * 8).astype(np.int32))
    rows = np.arange(cap)
    inv = rows[None, :] + rng.integers(-300, 300, size=(n_cols, cap))
    inv = np.where((inv < 0) | (inv >= cap), cap, inv)
    inv = torch.from_numpy(inv.astype(np.int32))
    t3b = torch.from_numpy(rng.normal(size=(cap, 9)).astype(np.float32)
                           ).to(torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(cap, 32)).astype(np.float32)
                         ).to(torch.bfloat16)
    padded = oc._dw_pad_cols(t3b)
    assert padded.shape == (cap, 16) and torch.equal(padded[:, :9], t3b)
    assert oc._dw_pad_cols(padded) is padded
    want = oc.dw_fused_reference(wstart, inv, t3b, g, tile, win)
    got = oc.dw_fused_reference(wstart, inv, padded, g, tile, win)
    assert bool((got[:, 9:] == 0).all())
    torch.testing.assert_close(got[:, :9], want, rtol=1e-6, atol=1e-6)
    assert float(want.abs().max()) > 1.0


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN35_GLOBAL__N__12656e83_5_dw_cu_lgs_dw16dw_reduce_kernelEPKfPfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN35_GLOBAL__N__12656e83_5_dw_cu_lgs_dw16dw_reduce_kernelEPKfPfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN35_GLOBAL__N__12656e83_5_dw_cu_lgs_dw9dw_kernelILi0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN35_GLOBAL__N__12656e83_5_dw_cu_lgs_dw9dw_kernelILi0EEEvNS_4ArgsE
    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers, 16 bytes smem
"""


def test_ptxas_usage_reads_the_named_entry(tmp_path, monkeypatch):
    """Registers, static shared memory and spills of one entry function,
    from this process's build or from the log kept beside the library."""
    from languagegroundedsemseg_torch.ops import cuda_kernels as ck

    monkeypatch.setitem(ck.build_log, "dw", PTXAS_LOG)
    want = {"registers": 122, "static_smem_bytes": 16,
            "spill_stores_bytes": 4, "spill_loads_bytes": 8}
    assert ck.ptxas_usage("dw", "dw_kernelILi0") == want
    assert ck.ptxas_usage("dw", "dw_reduce_kernel")["registers"] == 32
    assert ck.ptxas_usage("dw", "no_such_kernel") == {}
    monkeypatch.delitem(ck.build_log, "dw")
    monkeypatch.setattr(ck, "BUILD_DIR", str(tmp_path))
    assert ck.ptxas_usage("dw", "dw_kernelILi0") == {}
    (tmp_path / "libdw.so.log").write_text(PTXAS_LOG)
    assert ck.ptxas_usage("dw", "dw_kernelILi0") == want


def test_dw_ablation_refuses_cpu_tensors():
    """The ablation modes exist on the card only; the CPU has no plain
    version of a mode that computes no dW."""
    args = [torch.zeros(8, dtype=torch.int32),
            torch.zeros((8, 256), dtype=torch.int32),
            torch.zeros((256, 16), dtype=torch.bfloat16),
            torch.zeros((256, 32), dtype=torch.bfloat16), 256, 256]
    with pytest.raises(ValueError, match="CUDA"):
        oc.dw_ablation(*args, mode="no_mma")
    assert oc.DW_ABLATION_MODES[0] == "full"
