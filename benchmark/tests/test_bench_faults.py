"""``correct`` comes out false when the timed path is broken underneath:
the bf16 path (the control), a step that leaves the state unchanged, half
of the batch left out with the mean over the rest, an answer altered
where it is produced. The harness's look for a card is skipped (the run
is on the CPU at the tiny cell's size)."""

import time

import pytest

from lgsb import harness

SEED = 424242


def run(root, variant):
    return harness.run_cell(root, "tiny.resident", SEED, 0.2, False,
                            time.perf_counter(), device="cpu", variant=variant,
                            warmup=False)


def test_sound_run_is_correct(tiny_root):
    assert run(tiny_root, None)["correct"]


@pytest.mark.parametrize("variant,number", [
    ("bf16", "stage_gap"),
    ("frozen", "change_gap"),
    ("half_batch", "grad_gap"),
    ("altered", "output_gap"),
])
def test_fault_is_not_correct(tiny_root, variant, number):
    r = run(tiny_root, variant)
    assert not r["correct"]
    c = r["compared"][number]
    assert c["value"] > c["limit"]
