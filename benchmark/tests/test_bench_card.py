"""On the card: the tiny cell through the port's CUDA kernels is correct,
and its bf16 path (the control) is not. Skips without a card."""

import time

import pytest

from lgsb import harness


@pytest.mark.cuda
@pytest.mark.parametrize("variant,correct", [(None, True), ("bf16", False)])
def test_tiny_cell_on_the_card(card, tiny_root, variant, correct):
    r = harness.run_cell(tiny_root, "tiny.resident", 99, 0.5, False,
                         time.perf_counter(), device=card, variant=variant,
                         warmup=False)
    assert r["correct"] is correct, r["compared"]
