"""The plain reference against the port's CPU path at a few thousand
points: the data path to the bit, the train step within the CPU path's
bf16 products."""

import time

import numpy as np

from lgsb import harness, pipeline_ref, scenes


def test_data_path_matches_the_ports_get_item():
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.data.dataset import build_input_transforms
    from lgsb import program

    raw = {0: scenes.synthetic_scene(np.random.default_rng(5), 4000, num_classes=20)}
    cls = program.dataset_class(raw, 1, 20, 96)
    cfg = Config(ignore_label=255)
    prevoxel, input_t = build_input_transforms(cfg, cls, True)
    ds = cls(cfg, phase="train", augment_data=True, prevoxel_transform=prevoxel,
             input_transform=input_t)
    for seed in (1, 2, 3):
        got = ds.get_item(0, np.random.default_rng(seed))
        c, f, l = pipeline_ref.voxelized_scene(*raw[0], np.random.default_rng(seed))
        assert np.array_equal(got["coords"], c)
        assert np.array_equal(got["feats"], f)
        assert np.array_equal(got["labels"], l)


def test_reference_follows_the_ports_cpu_step(tiny_root):
    for cell in ("tiny.resident", "tiny.loader"):
        r = harness.run_cell(tiny_root, cell, 2 ** 31 + 17, 0.5, False,
                             time.perf_counter(), device="cpu")
        got = {k: v["value"] for k, v in r["compared"].items()}
        assert got["batch_mismatch"] == 0
        # the CPU path's sparse convs take bf16 operands: output and losses
        # agree to bf16 rounding, the float32 stages to float32 rounding
        assert got["output_gap"] < 0.1
        assert got["loss_gap"] < 3e-3
        assert got["stage_gap"] < 1e-5
        assert r["correct"], got
