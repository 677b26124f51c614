"""The classifier stage: the port against the JAX package.

- ``ResampledFeatureDataset``: the pools, every epoch's redraw and the
  batches (the tail wrapped) array-equal to JAX's from the same features
  and seed (both draw from ``np.random.default_rng(seed)``).
- ``train_classifier_on_features``: the history (loss and val accuracy per
  epoch) on the same features and seed, the classifier's initial weights
  JAX's ``PRNGKey(seed)`` init carried across by ``convert``.
- ``extract_features`` over a two-batch loader of a narrowed Res16UNet14
  (the same weights in both packages; f32 gather paths).
- ``ClassifierNet`` in bf16 against JAX's.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.data import feature_dataset as jfd
from languagegroundedsemseg_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from languagegroundedsemseg_tpu.models import classifier as jclassifier
from languagegroundedsemseg_tpu.train import classifier as jtrain_classifier
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.data import feature_dataset as fd
from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.models import classifier
from languagegroundedsemseg_torch.train import classifier as train_classifier
from languagegroundedsemseg_torch.train.step import make_eval_step
from oracles import make_cloud
from test_torch_res16unet import _random_variables
from test_torch_trainer import gather_paths, one_torch_thread  # noqa: F401
from test_torch_zoo import NARROW, _narrowed

# the classifier's loss per epoch: the same f32 SGD steps, sums in another
# order, compounded over the epoch's updates
HISTORY_RTOL = 1e-4
# val accuracy: an argmax tie among near-equal logits can flip a row
ACC_ATOL = 1e-3
# the backbone's features: the gather paths' f32 sums in another order
FEATURE_RTOL = 1e-4
# ClassifierNet in bf16: one bf16 product and bias add, each rounded once in
# both packages; the CPU dots may round a last bit differently (2^-8)
BF16_RTOL = 1e-2


def _toy_features(seed=0, num_classes=6, dim=8):
    """A long-tailed pool: class c has 10 * 2^(num_classes - c) rows (the
    tail below the quota), around its own center (the same centers for
    every seed)."""
    centers = np.random.default_rng(99).normal(size=(num_classes, dim)) * 2
    rng = np.random.default_rng(seed)
    counts = [10 * 2 ** (num_classes - c) for c in range(num_classes)]
    labels = np.concatenate([np.full(n, c) for c, n in enumerate(counts)])
    rng.shuffle(labels)
    feats = (centers[labels] + rng.normal(size=(len(labels), dim))).astype(np.float32)
    return feats, labels.astype(np.int64)


@pytest.mark.parametrize("spc", [16, 100])
def test_resampled_dataset_equals_jax(spc):
    feats, labels = _toy_features()
    want = jfd.ResampledFeatureDataset(feats, labels, samples_per_class=spc,
                                       num_classes=7, seed=3)
    got = fd.ResampledFeatureDataset(feats, labels, samples_per_class=spc,
                                     num_classes=7, seed=3)
    assert got.feature_dim == want.feature_dim and got.num_classes == 7
    for a, b in zip(got._pools, want._pools):
        np.testing.assert_array_equal(a, b)
    for epoch in range(3):
        if epoch:
            got.resample_features()
            want.resample_features()
        np.testing.assert_array_equal(got._epoch_idx, want._epoch_idx)
        assert len(got) == len(want) == 6 * spc  # class 6 has no rows
        for (gf, gl), (wf, wl) in zip(got.batches(64), want.batches(64)):
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gl, wl)
            assert gl.dtype == np.int32 and len(gl) == 64


def _jax_init(num_classes, dim, seed, batch_size):
    """JAX's ClassifierNet init at PRNGKey(seed), as the port's state dict."""
    v = jclassifier.ClassifierNet(out_channels=num_classes).init(
        jax.random.PRNGKey(seed), jnp.zeros((batch_size, dim), jnp.float32))
    return state_dict_from_jax(v["params"], {})


def jax_initialized_classifier(batch_size=4096):
    """A patch of the port's ClassifierNet in ``train/classifier.py`` that
    starts from JAX's init for the seed the generator carries."""
    real = classifier.ClassifierNet

    def make(in_channels, out_channels, device="cuda", generator=None, **kw):
        model = real(in_channels, out_channels, device=device, **kw)
        model.load_state_dict(_jax_init(out_channels, in_channels,
                                        generator.initial_seed(), batch_size))
        return model

    return mock.patch.object(train_classifier, "ClassifierNet", make)


def test_classifier_history_equals_jax():
    feats, labels = _toy_features(1)
    vfeats, vlabels = _toy_features(2)
    kw = dict(num_classes=6, epochs=4, batch_size=64, lr=0.1, momentum=0.9, seed=5)

    def datasets(mod):
        return (mod.ResampledFeatureDataset(feats, labels, 32, 6, seed=5),
                mod.ResampledFeatureDataset(vfeats, vlabels, 32, 6, seed=6))

    ds, val = datasets(jfd)
    _, want = jtrain_classifier.train_classifier_on_features(ds, val=val, **kw)
    ds, val = datasets(fd)
    logged = []
    with jax_initialized_classifier(64):
        model, got = train_classifier.train_classifier_on_features(
            ds, val=val, log_fn=logged.append, device="cpu", **kw)
    print(got, want)
    assert logged == got and [r.keys() for r in got] == [r.keys() for r in want]
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        assert abs(g["loss"] - w["loss"]) <= HISTORY_RTOL * abs(w["loss"])
        assert abs(g["val_acc"] - w["val_acc"]) <= ACC_ATOL
    assert got[-1]["loss"] < got[0]["loss"] and got[-1]["val_acc"] > 0.5
    assert isinstance(model, classifier.ClassifierNet)


def test_extract_features_equals_jax():
    """Two batches of two scenes through a narrowed Res16UNet14's eval
    forward: the pooled features (valid, labelled rows, in order) and their
    labels."""
    jmodel, pcls = _narrowed("Res16UNet14", NARROW)
    rng = np.random.default_rng(0)
    batches_j, batches_p = [], []
    for _ in range(2):
        scenes = []
        for _ in range(2):
            coords = make_cloud(rng, n=150)[:, 1:]
            coords = np.unique(coords, axis=0)
            f = rng.normal(size=(len(coords), 3)).astype(np.float32)
            lab = rng.integers(0, 5, size=len(coords)).astype(np.int32)
            lab[rng.random(len(coords)) < 0.2] = 255
            scenes.append((coords.astype(np.int32), f, lab))
        batches_j.append(JaxBatchBuilder(spec=type(jmodel).graph_spec(3),
                                         fixed_capacity=512).build(scenes))
        batches_p.append(BatchBuilder(spec=pcls.graph_spec(3),
                                      fixed_capacity=512).build(scenes, device="cpu"))
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.PRNGKey(0), batches_j[0].feats, batches_j[0].graph)
    variables = _random_variables(shapes, 0)
    fwd = jax.jit(functools.partial(jmodel.apply, train=False))
    want = jfd.extract_features(lambda b: fwd(variables, b.feats, b.graph), batches_j)
    model = pcls(out_channels=7, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    with gather_paths():
        got = fd.extract_features(make_eval_step(model, device="cpu"), batches_p,
                                  max_batches=5)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int64
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[1]) > 300 and (got[1] != 255).all()
    err = np.abs(got[0] - want[0]).max() / np.abs(want[0]).max()
    assert err < FEATURE_RTOL, err
    one = fd.extract_features(make_eval_step(model, device="cpu"), batches_p,
                              max_batches=1)
    assert len(one[1]) < len(got[1])


def test_classifier_net_bf16_equals_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 24)).astype(np.float32)
    jm = jclassifier.ClassifierNet(out_channels=10, dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(1), x)
    want, feats = jm.apply(v, x)
    model = classifier.ClassifierNet(24, 10, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_jax(v["params"], {}))
    got, f = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert torch.equal(f, torch.from_numpy(x))
    err = (np.abs(got.float().detach().numpy() - np.asarray(want, np.float32)).max()
           / np.abs(np.asarray(want, np.float32)).max())
    assert err < BF16_RTOL, err
