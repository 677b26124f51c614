"""``--seed`` makes the inputs (rooms, augmentation, loader order,
weights), while the amount of work stays the same: the pool's scene sizes,
and the capacities the envelope sets, which every batch of the ring is
padded to."""

import json
import os

import numpy as np
import torch

from lgsb import scenes
from lgsb.workload import Cell


def cell(root, seed):
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(b, "traffic", "tiny_resident.json")) as f:
        traffic = json.load(f)
    c = Cell(cfg, traffic, seed, "cpu")
    c.fill()
    return c


def test_seed_makes_the_inputs_and_not_the_work(tiny_root):
    a, b = cell(tiny_root, 2 ** 31 + 5), cell(tiny_root, 6)
    try:
        pool = range(a.n_pool)
        # the same sizes, other rooms
        assert sorted(len(a.raw[i][0]) for i in pool) == \
            sorted(len(b.raw[i][0]) for i in pool)
        assert not any(np.array_equal(a.raw[i][0], b.raw[i][0]) for i in pool)
        assert a.loader_seed != b.loader_seed
        assert not torch.equal(a.weights["final.kernel"], b.weights["final.kernel"])
        # the envelope is the same in every run and sets the ring's capacities
        assert a.envelope_caps and a.envelope_caps == b.envelope_caps
        for c in (a, b):
            assert len(c.rec.caps) == len(c.ring)
            for caps in c.rec.caps.values():
                assert all(x >= e for x, e in zip(caps, c.envelope_caps))
    finally:
        a.close()
        b.close()


def test_envelope_takes_the_top_of_each_stratum():
    law = {"median": 100, "log_sigma": 0.5, "min": 10, "max": 1000}
    sizes = scenes.pool_sizes(12, law)
    env = scenes.envelope_sizes(12, 3, law, 1.5)
    assert list(env) == [round(s * 1.5) for s in sizes[[3, 7, 11]]]
