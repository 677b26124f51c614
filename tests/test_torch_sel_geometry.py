"""The sel_fwd kernel's launch plan, on the CPU.

``sel_geometry`` decides the grid (row blocks inside one tile, times channel
splits), the threads, and the shared memory a block stages its anchors in.
None of it needs the card or JAX.
"""

import pytest
import torch

from languagegroundedsemseg_torch.ops import onehot_conv as oc

# the main path's five k3 capacities (chip_smoke's batch, tile 256 / win
# 512 at every level) and the widths the train step gives each level
MAIN = {589824: (32, 96, 128), 180224: (32, 96, 128),
        57344: (32, 64, 128, 192), 18432: (64, 128, 256, 384),
        4096: (128, 256)}
MAIN_SHAPES = [(cap, c) for cap, cs in MAIN.items() for c in cs]
# the window menu's other tiles (sparse/graph_host.py:_WINDOW_MENU), small
# caps that need a channel split, and widths outside the model
OTHER = [(16384, 8, 512, 1024), (16384, 384, 1024, 2048), (2048, 256, 256, 512),
         (1024, 384, 256, 512), (4096, 8, 256, 512), (1536, 2048, 256, 512)]


def _plans():
    for cap, c in MAIN_SHAPES:
        yield cap, c, 256, 512
    yield from OTHER


@pytest.mark.parametrize("cap,c_run,tile,win", list(_plans()))
def test_plan_covers_every_row_and_channel_once_inside_one_tile(cap, c_run,
                                                                tile, win):
    geo = oc.sel_geometry(cap, c_run, tile, win)
    rows, chunk, splits = geo["rows_per_block"], geo["chunk"], geo["splits"]
    assert geo["grid"] == [cap // rows, splits]
    assert geo["blocks"] == cap // rows * splits
    # row blocks: whole 16-byte anchor loads, a divisor of the tile, so
    # block b's rows [b * rows, (b + 1) * rows) lie in tile b * rows // tile
    assert rows % 4 == 0 and tile % rows == 0
    owner = torch.arange(cap) // rows
    assert int(owner.max()) + 1 == geo["grid"][0]
    assert bool(((owner * rows) // tile == torch.arange(cap) // tile).all())
    # channel chunks: whole 8-channel vectors, each split non-empty, c_run
    # covered once
    assert chunk % 8 == 0
    widths = [min(chunk, c_run - s * chunk) for s in range(splits)]
    assert all(w > 0 for w in widths) and sum(widths) == c_run
    assert geo["threads"] % 32 == 0 and 32 <= geo["threads"] <= 256
    assert geo["threads"] * geo["items_per_thread"] >= rows * chunk // 8
    assert geo["smem_bytes"] == oc._sel_smem_bytes(8, rows) <= 48 * 1024


@pytest.mark.parametrize("cap,c_run", MAIN_SHAPES)
def test_main_path_fills_the_card_at_every_level(cap, c_run):
    """At least SEL_MIN_BLOCKS (two an SM of an H100 SXM) at each of the
    main path's five capacities, L3's 18,432 rows and L4's 4,096 included,
    with no more than SEL_MAX_ITEMS (row, vector) items a block."""
    geo = oc.sel_geometry(cap, c_run, 256, 512)
    assert geo["blocks"] >= oc.SEL_MIN_BLOCKS == 264
    assert geo["rows_per_block"] * geo["chunk"] // 8 <= oc.SEL_MAX_ITEMS
    # the tiles alone fill the card at L0-L3, rows of 8 do at L4: no split
    assert geo["splits"] == 1


def test_main_path_plans():
    """One (row, vector) item a thread, at most 256 a block: 64 rows at
    c=32, fewer as the width grows, 8-row blocks at L4's 4,096 rows."""
    got = {(cap, c): (oc.sel_geometry(cap, c, 256, 512)["rows_per_block"],
                      oc.sel_geometry(cap, c, 256, 512)["threads"])
           for cap, c in MAIN_SHAPES}
    assert got == {
        (589824, 32): (64, 256), (589824, 96): (16, 192),
        (589824, 128): (16, 256), (180224, 32): (64, 256),
        (180224, 96): (16, 192), (180224, 128): (16, 256),
        (57344, 32): (64, 256), (57344, 64): (32, 256),
        (57344, 128): (16, 256), (57344, 192): (8, 192),
        (18432, 64): (32, 256), (18432, 128): (16, 256),
        (18432, 256): (8, 256), (18432, 384): (4, 192),
        (4096, 128): (8, 128), (4096, 256): (8, 256)}
    assert all(oc.sel_geometry(cap, c, 256, 512)["items_per_thread"] == 1
               for cap, c in MAIN_SHAPES)


def test_small_caps_split_channels():
    """Where even 4-row blocks are too few, channels split into chunks of at
    least SEL_MIN_SPLIT, enough of them to reach SEL_MIN_BLOCKS."""
    geo = oc.sel_geometry(512, 256, 256, 512)
    assert geo["rows_per_block"] == 4 and geo["grid"][0] == 128
    assert geo["splits"] == 3 and geo["blocks"] >= oc.SEL_MIN_BLOCKS
    narrow = oc.sel_geometry(512, 32, 256, 512)
    assert narrow["splits"] == 1 and narrow["chunk"] == oc.SEL_MIN_SPLIT


@pytest.mark.parametrize("shape", MAIN_SHAPES[:4] + OTHER[:2])
def test_plan_is_a_function_of_the_shapes(shape):
    """The same plan cached or computed afresh: neither split changes a
    sum's order, but the plan must not drift between launches."""
    cap, c_run = shape[:2]
    tile, win = shape[2:] if len(shape) == 4 else (256, 512)
    args = (cap, c_run, tile, win, 8)
    assert oc._sel_plan(*args) == oc._sel_plan.__wrapped__(*args)


@pytest.mark.parametrize("bad,match", [
    (dict(c_run=12), "multiple of 8"), (dict(c_run=0), "multiple of 8"),
    (dict(tile=96), "tile"), (dict(cap=4000), "tile"), (dict(tile=0), "tile"),
    (dict(tile=250, cap=4000), "multiple of 4"),
    (dict(win=8192), "win"), (dict(win=0), "win"),
    (dict(n_cols=2048), "staged anchors")])
def test_geometry_raises_for_shapes_the_kernel_does_not_take(bad, match):
    kw = dict(cap=4096, c_run=32, tile=256, win=512, n_cols=8)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        oc.sel_geometry(**kw)


def test_wrapper_runs_plain_version_on_cpu_and_refuses_other_devices():
    """A tensor on neither the CPU nor CUDA is refused; the CPU path runs
    the plain version at any width (no 8-channel rule there)."""
    cap = 1024
    wstart = torch.zeros(cap // 256 * 8, dtype=torch.int32)
    anchors = torch.full((8, cap), cap, dtype=torch.int32)
    mc = torch.ones(cap, dtype=torch.uint8)
    pall = torch.ones((cap, 9 * 12), dtype=torch.bfloat16)
    out = oc.sel_fwd(wstart, anchors, mc, pall, 8, 256, 512)
    assert out.shape == (cap, 12) and bool((out == 1).all())
    with pytest.raises(ValueError, match="unsupported device"):
        oc.sel_fwd(wstart, anchors, mc, pall.to("meta"), 8, 256, 512)
