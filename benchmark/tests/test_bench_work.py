"""The FLOP counter and the kernel bound arithmetic against hand counts."""

import torch

from lgsb import work
from lgsb.reference import Arch, Geometry

# four voxels of one scene: a run of three along z and one beside the first
COORDS = [[0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2], [0, 0, 1, 0]]
TINY = Arch(planes=(2,) * 8, layers=(1,) * 8, init_dim=2, in_channels=3,
            out_channels=5)


def test_pyramid_and_pairs():
    geo = Geometry(torch.tensor(COORDS))
    # level 0: 3 + 4 + 2 + 3 neighbours present (each voxel counts itself)
    assert [geo.num(l) for l in range(5)] == [4, 2, 1, 1, 1]
    assert [geo.pairs(l) for l in range(5)] == [12, 4, 1, 1, 1]


def test_forward_flops_hand_count():
    geo = Geometry(torch.tensor(COORDS))
    # 2 * pairs_or_rows * c_in * c_out over every conv, by hand:
    hand = (12 * 3 * 2                                  # conv0, L0 k3
            + 4 * 2 * 2 + 2 * (4 * 2 * 2)               # down0, block1 (L1)
            + 2 * 2 * 2 + 2 * (1 * 2 * 2)               # down1, block2
            + 1 * 2 * 2 + 2 * (1 * 2 * 2)               # down2, block3
            + 1 * 2 * 2 + 2 * (1 * 2 * 2)               # down3, block4
            + 1 * 2 * 2 + (1 * 4 * 2 + 1 * 2 * 2 + 1 * 4 * 2)  # up to L3, block5
            + 1 * 2 * 2 + (1 * 4 * 2 + 1 * 2 * 2 + 1 * 4 * 2)  # up to L2, block6
            + 2 * 2 * 2 + (4 * 4 * 2 + 4 * 2 * 2 + 2 * 4 * 2)  # up to L1, block7
            + 4 * 2 * 2 + (12 * 4 * 2 + 12 * 2 * 2 + 4 * 4 * 2)  # up to L0, block8
            + 4 * 2 * 5)                                # the head
    assert work.forward_flops(TINY, geo, False) == 2 * hand
    assert work.step_flops(TINY, geo, False) == 6 * hand
    # without the head (representation mode)
    assert work.forward_flops(TINY, geo, True) == 2 * (hand - 4 * 2 * 5)


WORKS = {0: {"cap": 1024, "n_cols": 8, "anchors": 8192, "wstart": 64,
             "inv_wstart": 64, "sel_hits": 3000, "dw_hits": 2500},
         1: None, 2: None, 3: None, 4: None}


def test_sel_fwd_bounds_hand_count():
    # L0 k3 convs of TINY: conv0 (3 -> 2, no dX), block8 conv1 (4 -> 2),
    # conv2 (2 -> 2); every width pads to 8: five launches of c_run 8
    nbytes = 1024 * 8 * 2 + 3000 * 8 * 2 + 8192 * 4 + 64 * 4 + 1024 + 1024 * 8 * 4
    ops = (3000 + 1024) * 8
    got = work.sel_fwd_bounds(TINY, WORKS, 1.0, 1.0, False)
    assert got == [max(nbytes, ops)] * 5
    # memory-bound at the card's rates
    bw, _, f32 = work.peaks("NVIDIA H100 80GB HBM3")
    assert work.sel_fwd_bounds(TINY, WORKS, bw, f32, False)[0] == nbytes / bw


def test_dw_bounds_hand_count():
    def hand(cw, co):
        nbytes = (1024 * cw * 2 + 1024 * co * 2 + 8 * 1024 * 4 + 64 * 4
                  + 8 * cw * co * 4)
        return nbytes, 2 * 2500 * cw * co

    want = [hand(9, 8), hand(12, 8), hand(6, 8)]  # 3 c_in x c_out padded to 8
    assert work.dw_bounds(TINY, WORKS, 1.0, 1.0, False) == [max(b, o) for b, o in want]
    assert work.dw_bounds(TINY, WORKS, 1.0, 1e30, False) == [b for b, _ in want]


def test_peaks_table():
    assert work.peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 989e12, 67e12)
