"""One Res16UNet34C train step on a windowed batch: the PyTorch port
against the JAX package (harness: tests/test_torch_train_step_gather.py).

At capacity 1024 a synthetic scene gives the L1 k3 map and the first two
down maps window annotations, so the port's step runs its selector convs
(bf16 projections, ``sel_fwd`` forward and dX, the ``dw`` plain version and
the rebuilt inverse tiling), its windowed child sums and the up convs' dX
through ``csum``'s plain version, while JAX on the CPU routes around its
Pallas kernels to f32 gather paths.

On this batch the gradient is not a continuous function of the rounding:
the deep levels hold a few dozen voxels or fewer, and ReLUs whose inputs
sit near zero flip under a bf16-size change of the activations. The first
test prints the port's gradient drift beside JAX's own drift when its input
features move by 2^-8 relative (the size of one bf16 rounding); both are
of the same order, far above 2e-2. So that test holds the loss, the
parameters and the BN statistics after the step to 2e-2 and only prints
the gradient drift; the second holds the gradients to 2e-2 relative L2 on
the same model with every ReLU replaced by the identity in both packages,
where the step is smooth and the bf16 rounding is the only difference.
"""

from unittest import mock

import flax.linen
import numpy as np
import torch

from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
from test_torch_train_step_gather import _labelled, run_both

RTOL = 2e-2
BF16_EPS = 2.0 ** -8


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _cat(trees, names):
    return np.concatenate([trees[n].ravel() for n in names])


def _scenes():
    rng = np.random.default_rng(1)
    coords, feats, _ = voxelize_scene(rng, 600)
    return [_labelled(rng, coords, feats)]


def _check_step(j, want_after, loss, after, batch, tag):
    annotated = {k for k, m in batch.graph.gmaps.items() if m.tile > 0}
    assert {"l1.k3", "down0", "down1"} <= annotated
    assert abs(loss - j["loss"]) <= RTOL * abs(j["loss"])
    for kind in ("params", "stats"):
        keys = sorted(n for n in want_after
                      if ("running" in n) == (kind == "stats"))
        e = _rel_l2(_cat(after, keys), _cat(want_after, keys))
        print(f"{tag} {kind} after the step: relative L2 {e:.3e}")
        assert e <= RTOL


def _grad_drift(grads, want):
    names = sorted(want)
    worst = max(((n, _rel_l2(grads[n], want[n])) for n in names),
                key=lambda kv: kv[1])
    return _rel_l2(_cat(grads, names), _cat(want, names)), worst


def test_train_step_matches_jax_within_bf16():
    j, (loss, _, grads, after, batch), want = run_both(
        _scenes(), 1024, perturb=BF16_EPS)
    _check_step(j, want["after"], loss, after, batch, "(b)")
    err, worst = _grad_drift(grads, want["grads"])
    floor, _ = _grad_drift(want["grads_perturbed"], want["grads"])
    print(f"(b) grads relative L2 {err:.3e}, worst tensor {worst[0]} "
          f"{worst[1]:.3e}; JAX's own grads under a 2^-8 input "
          f"perturbation: {floor:.3e}")  # shown by pytest -rP


def test_relu_free_train_step_matches_jax_within_bf16():
    """The same step with every ReLU replaced by the identity in both
    packages: the gradients within 2e-2 relative L2."""
    identity = lambda x: x  # noqa: E731
    with mock.patch.object(flax.linen, "relu", identity), \
            mock.patch.object(torch, "relu", identity):
        j, (loss, _, grads, after, batch), want = run_both(_scenes(), 1024)
    _check_step(j, want["after"], loss, after, batch, "(b, no ReLU)")
    err, worst = _grad_drift(grads, want["grads"])
    print(f"(b, no ReLU) grads relative L2 {err:.3e}, worst tensor "
          f"{worst[0]} {worst[1]:.3e}")  # shown by pytest -rP
    assert err <= RTOL
