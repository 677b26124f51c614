"""The port's device histograms against the JAX package's.

``fast_hist_torch`` and ``ap_histograms_torch`` get the same preds, labels,
probabilities and row mask (made from a seed with numpy; labels include the
ignore label and out-of-range ids, rows include padding) as
``fast_hist_jax`` and ``ap_histograms_jax``. The counts are integers, so they
must be exactly equal, and so must the AP that ``ap_from_histograms`` makes
of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.eval.miou import (
    ap_from_histograms as jax_ap_from_histograms,
    ap_histograms_jax,
    fast_hist_jax,
)
from languagegroundedsemseg_torch.eval.miou import (
    ap_from_histograms,
    ap_histograms_torch,
    fast_hist,
    fast_hist_torch,
)


def _inputs(n, c, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n).astype(np.int32)
    labels[rng.random(n) < 0.1] = 255
    labels[rng.random(n) < 0.02] = -1
    pred = rng.integers(0, c + 3, n).astype(np.int32)  # some beyond c: clipped
    logits = 3.0 * rng.normal(size=(n, c)).astype(np.float32)
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs = (probs / probs.sum(1, keepdims=True)).astype(np.float32)
    probs[:5, 0] = 1.0  # the top bin's edge
    row_mask = (rng.random(n) < 0.9).astype(np.float32)
    return pred, labels, probs, row_mask


@pytest.mark.parametrize("n,c", [(3000, 20), (1000, 200)])
@pytest.mark.parametrize("masked", [False, True])
def test_fast_hist_torch_equals_jax(n, c, masked):
    pred, labels, _, row_mask = _inputs(n, c, 0)
    m = row_mask if masked else None
    want = np.asarray(fast_hist_jax(jnp.asarray(pred), jnp.asarray(labels), c,
                                    None if m is None else jnp.asarray(m)))
    got = fast_hist_torch(torch.from_numpy(pred), torch.from_numpy(labels), c,
                          None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.int64 and got.shape == (c, c)
    np.testing.assert_array_equal(got.numpy(), want)
    if not masked:  # the numpy half agrees on the rows it keeps
        keep = pred < c
        np.testing.assert_array_equal(
            fast_hist_torch(torch.from_numpy(pred[keep]),
                            torch.from_numpy(labels[keep]), c).numpy(),
            fast_hist(pred[keep], labels[keep], c))


@pytest.mark.parametrize("n,c,bins", [(3000, 20, 2048), (1000, 200, 2048), (500, 7, 64)])
@pytest.mark.parametrize("masked", [False, True])
def test_ap_histograms_torch_equals_jax(n, c, bins, masked):
    _, labels, probs, row_mask = _inputs(n, c, 1)
    m = row_mask if masked else None
    tp_w, fp_w = ap_histograms_jax(jnp.asarray(probs), jnp.asarray(labels), c,
                                   num_bins=bins,
                                   row_mask=None if m is None else jnp.asarray(m))
    tp, fp = ap_histograms_torch(torch.from_numpy(probs), torch.from_numpy(labels),
                                 c, num_bins=bins,
                                 row_mask=None if m is None else torch.from_numpy(m))
    assert tp.shape == fp.shape == (c, bins) and tp.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tp_w))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fp_w))
    np.testing.assert_array_equal(
        ap_from_histograms(tp.numpy(), fp.numpy()),
        jax_ap_from_histograms(np.asarray(tp_w), np.asarray(fp_w)))


def test_default_bins_are_2048():
    _, labels, probs, _ = _inputs(100, 5, 2)
    tp, fp = ap_histograms_torch(torch.from_numpy(probs), torch.from_numpy(labels), 5)
    assert tp.shape == (5, 2048)
    valid = ((labels >= 0) & (labels < 5)).sum()
    assert float(tp.sum()) == valid and float(fp.sum()) == valid * 4
