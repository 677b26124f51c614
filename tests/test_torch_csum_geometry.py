"""The csum kernel's launch plan, on the CPU.

``csum_geometry`` decides the grid (one block per output tile and channel
split), the shared memory a block asks for and the hit list it holds;
``_csum_splits`` cuts the channels. Neither needs the card or JAX.
"""

import pytest
import torch

from languagegroundedsemseg_torch.ops import onehot_conv as oc

SM_BYTES = 233472  # an H100 SM's shared memory (228 KB), 1 KB a block reserved
# (cap_in, cap_out, tile, win, n_groups, c_run): the train step's 8 csum
# launches on chip_smoke's batch (down0 .. down3), then the menu's
# extremes (sparse/graph_host.py:_CS_MENU)
MAIN = [(589824, 180224, 128, 2048, 2, 32), (589824, 180224, 128, 2048, 2, 96),
        (180224, 57344, 128, 1024, 2, 32), (180224, 57344, 128, 1024, 2, 128),
        (57344, 18432, 256, 2048, 1, 64), (57344, 18432, 256, 2048, 1, 256),
        (18432, 4096, 128, 1024, 1, 128), (18432, 4096, 128, 1024, 1, 256)]
EXTREMES = [(65536, 16384, 512, 8192, 1, 256), (65536, 16384, 512, 8192, 1, 8),
            (8192, 2048, 128, 1024, 2, 384), (8192, 2048, 128, 1024, 2, 8)]


@pytest.mark.parametrize("shape", MAIN + EXTREMES)
def test_shared_memory_fits_and_hit_list_holds_the_window(shape):
    cap_in, cap_out, tile, win, n_groups, c_run = shape
    geo = oc.csum_geometry(*shape[:2], c_run, tile, win, n_groups)
    assert geo["smem_bytes"] <= oc.SMEM_LIMIT_BYTES
    assert geo["smem_bytes"] == oc._csum_smem_bytes(tile, n_groups * win)
    assert geo["entries"] == n_groups * win <= geo["hit_capacity"]
    assert geo["threads"] == 256
    assert geo["grid"][0] == cap_out // tile


@pytest.mark.parametrize("shape", MAIN)
def test_two_blocks_share_an_sm_on_the_main_path(shape):
    cap_in, cap_out, tile, win, n_groups, c_run = shape
    geo = oc.csum_geometry(cap_in, cap_out, c_run, tile, win, n_groups)
    assert 2 * (geo["smem_bytes"] + 1024) <= SM_BYTES


@pytest.mark.parametrize("shape", MAIN + EXTREMES)
def test_channel_splits_cover_c_run_exactly(shape):
    cap_in, cap_out, tile, win, n_groups, c_run = shape
    geo = oc.csum_geometry(cap_in, cap_out, c_run, tile, win, n_groups)
    chunk, splits = geo["chunk"], geo["splits"]
    assert chunk % 8 == 0 and geo["grid"][1] == splits
    owner = [s for s in range(splits) for _ in range(min(chunk, c_run - s * chunk))]
    assert len(owner) == c_run and all(c_run - s * chunk > 0
                                       for s in range(splits))
    # split only where the tiles alone are fewer than CSUM_MIN_BLOCKS
    if cap_out // tile >= oc.CSUM_MIN_BLOCKS:
        assert splits == 1


@pytest.mark.parametrize("shape", MAIN)
def test_splits_are_a_function_of_the_shapes(shape):
    """The channel split is fixed by the shapes: the same answer cached in
    the launch plan or computed afresh (a split changes no sum's order, but
    the plan must not drift between launches)."""
    cap_in, cap_out, tile, win, n_groups, c_run = shape
    first = oc._csum_splits(cap_out // tile, c_run)
    args = (cap_in, cap_out, c_run, tile, win, n_groups)
    assert oc._csum_plan(*args)[:2] == first
    assert oc._csum_plan.__wrapped__(*args)[:2] == first
    assert oc.csum_geometry(*args)["chunk"] == first[0]


def test_main_path_plans():
    """down0 and down1 need no split; down2 and down3 (72 and 32 tiles)
    split into 32- or 64-channel blocks."""
    plans = [oc.csum_geometry(ci, co, c, t, w, g)["grid"]
             for ci, co, t, w, g, c in MAIN]
    assert plans == [[1408, 1], [1408, 1], [448, 1], [448, 1], [72, 2],
                     [72, 4], [32, 4], [32, 8]]


@pytest.mark.parametrize("bad,match", [
    (dict(c_run=12), "multiple of 8"), (dict(c_run=4), "multiple of 8"),
    (dict(n_groups=2, win=8192), "exceed the hit list"),
    (dict(tile=8192, cap_out=16384), "shared memory"), (dict(tile=96), "tile"),
    (dict(win=70000), "win")])
def test_geometry_raises_for_shapes_the_kernel_does_not_take(bad, match):
    kw = dict(cap_in=65536, cap_out=16384, c_run=32, tile=128, win=2048,
              n_groups=1)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        oc.csum_geometry(**kw)


def test_wrapper_runs_plain_version_on_cpu_and_refuses_other_devices():
    """A tensor on neither the CPU nor CUDA is refused; the CPU path runs
    the plain version at any width (no 8-channel rule there)."""
    wstart = torch.zeros(8, dtype=torch.int32)
    pg = torch.full((1, 1024), 1024, dtype=torch.int32)
    pall = torch.ones((1024, 12), dtype=torch.bfloat16)
    out = oc.csum(wstart, pg, pall, 1024, 128, 512, 1)
    assert out.shape == (1024, 12) and bool((out == 0).all())
    with pytest.raises(ValueError, match="unsupported device"):
        oc.csum(wstart, pg, pall.to("meta"), 1024, 128, 512, 1)
