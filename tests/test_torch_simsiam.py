"""The paired-view objectives and the SimSiam step: the port against the
JAX package.

- ``build_paired_batch``: both packages' builds of the same scenes from
  the same ``np.random.Generator`` give array-equal correspondences,
  features and labels.
- ``point_supcon_loss`` and every loss of ``losses/simsiam.py``, fed the
  draws JAX makes from its split keys: the loss and its per-point outputs.
- One ``make_simsiam_train_step`` on Res16UNet34DPaired (narrowed) from the
  same weights on the same paired batch, with JAX's balanced-masking draws:
  the loss and its terms, the BN statistics (moved once per view) and the
  parameters after the update. At capacity 2048 no k3 map carries a window
  annotation in JAX, and the port's window routes are turned off
  (``gather_paths``), so both run f32 gather paths.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.config import Config as JaxConfig
from languagegroundedsemseg_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from languagegroundedsemseg_tpu.data.loader import load_dataset as jax_load_dataset
from languagegroundedsemseg_tpu.losses import simsiam as jsimsiam
from languagegroundedsemseg_tpu.losses.supcon import point_supcon_loss as jax_supcon
from languagegroundedsemseg_tpu.models.clip_models import (
    Res16UNet34DPaired as JaxPaired,
)
from languagegroundedsemseg_tpu.models.res16unet import (
    res16unet_graph_spec as jax_graph_spec,
)
from languagegroundedsemseg_tpu.train import simsiam as jtrain_simsiam
from languagegroundedsemseg_tpu.train.solvers import sgd_torch as jax_sgd_torch
from languagegroundedsemseg_tpu.train.state import TrainState as JaxTrainState
from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.data.loader import load_dataset
from languagegroundedsemseg_torch.losses import simsiam
from languagegroundedsemseg_torch.losses.supcon import point_supcon_loss
from languagegroundedsemseg_torch.models.clip_models import Res16UNet34DPaired
from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec
from languagegroundedsemseg_torch.train.simsiam import (
    build_paired_batch,
    make_simsiam_train_step,
)
from languagegroundedsemseg_torch.train.solvers import sgd_torch
from languagegroundedsemseg_torch.train.state import TrainState
from test_torch_res16unet import _random_variables
from test_torch_trainer import gather_paths, one_torch_thread  # noqa: F401
from test_torch_zoo import FAST_COMPILE

# the losses: the same f32 arithmetic on the same draws, sums in another order
LOSS_RTOL = 1e-5
# one paired step from the same weights: the gather paths' f32 sums in
# another order through two forwards and a backward
STEP_RTOL = 1e-4
PLANES = (8, 8, 16, 16, 16, 16, 8, 8)
CAP = 2048


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---- the paired batch -------------------------------------------------------


def _paired(seed=0, indices=(0, 1), dropout_ratio=0.35):
    cfg = dict(ignore_label=255, fixed_capacity=CAP)
    jds = jax_load_dataset("SyntheticTiny20Dataset")(JaxConfig(**cfg), phase="train",
                                                     augment_data=True)
    pds = load_dataset("SyntheticTiny20Dataset")(Config(**cfg), phase="train",
                                                 augment_data=True)
    jb = JaxBatchBuilder(spec=jax_graph_spec(), ignore_index=255, fixed_capacity=CAP)
    pb = BatchBuilder(spec=res16unet_graph_spec(), ignore_index=255, fixed_capacity=CAP)
    want = jtrain_simsiam.build_paired_batch(
        jb, jds, list(indices), np.random.default_rng(seed), dropout_ratio=dropout_ratio)
    got = build_paired_batch(pb, pds, list(indices), np.random.default_rng(seed),
                             dropout_ratio=dropout_ratio, device="cpu")
    return want, got, pds


@pytest.fixture(scope="module")
def paired():
    return _paired()


def test_paired_batch_equals_jax(paired):
    """The correspondences (padded rows of the other view, -1 for none) and
    both views' feats, labels and level-0 coords are array-equal."""
    (jb1, jb2, jc1, jc2), (b1, b2, c1, c2), _ = paired
    assert c1.dtype == np.int32 and c2.dtype == np.int32
    np.testing.assert_array_equal(c1, np.asarray(jc1))
    np.testing.assert_array_equal(c2, np.asarray(jc2))
    for got, want in ((b1, jb1), (b2, jb2)):
        np.testing.assert_array_equal(got.feats.numpy(), np.asarray(want.feats))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        np.testing.assert_array_equal(got.graph.levels[0].mask().numpy(),
                                      np.asarray(want.graph.levels[0].mask()))
    # the pairs are real: valid rows of one view point at valid rows of the
    # other, mostly with the same label (augmentation moves the views)
    valid1 = b1.graph.levels[0].mask().numpy() > 0
    valid2 = b2.graph.levels[0].mask().numpy() > 0
    ok = (c1 >= 0) & valid1
    assert ok.mean() > 0.3 and valid2[c1[ok]].all()
    assert (b1.labels.numpy()[ok] == b2.labels.numpy()[c1[ok]]).mean() > 0.9


# ---- the losses -------------------------------------------------------------


def _supcon_inputs(seed, n=300, c=6, d=16):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n).astype(np.int32)
    labels[rng.random(n) < 0.1] = 255
    feats = rng.normal(size=(n, d)).astype(np.float32)
    hist = rng.integers(0, 50, size=(c, c)).astype(np.int64)
    row_mask = (rng.random(n) > 0.1).astype(np.float32)
    preds = np.where(rng.random(n) < 0.7, labels, rng.integers(0, c, n)).astype(np.int32)
    return feats, labels, hist, row_mask, preds


@pytest.mark.parametrize("distance,with_mask,with_preds", [
    ("cos", False, False), ("cos", True, True), ("l2", True, False)])
def test_supcon_loss_equals_jax(distance, with_mask, with_preds):
    """JAX's loss on its key; the port's on the draws JAX makes from the
    split keys (uniforms for the positives, Gumbels and uniforms for the
    negatives, a negative's two from the same key as in JAX)."""
    feats, labels, hist, row_mask, preds = _supcon_inputs(1)
    num_pos, num_neg = 2, 3
    n, c = len(labels), hist.shape[0]
    key = jax.random.PRNGKey(7)
    kw = dict(num_pos=num_pos, num_neg=num_neg, distance=distance,
              row_mask=row_mask if with_mask else None,
              preds=preds if with_preds else None)
    want = jax_supcon(key, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(hist),
                      **{k: (None if v is None else jnp.asarray(v)) if k in ("row_mask", "preds")
                         else v for k, v in kw.items()})
    keys = jax.random.split(key, num_pos + num_neg + 1)
    u_pos = np.stack([jax.random.uniform(keys[s], (n,)) for s in range(num_pos)])
    gumbel = np.stack([jax.random.gumbel(keys[num_pos + s], (n, c)) for s in range(num_neg)])
    u_neg = np.stack([jax.random.uniform(keys[num_pos + s], (n,)) for s in range(num_neg)])
    got = point_supcon_loss(
        None, _t(feats), _t(labels), _t(hist),
        **{k: (None if v is None else _t(v)) if k in ("row_mask", "preds") else v
           for k, v in kw.items()},
        u_pos=_t(u_pos), gumbel=_t(gumbel), u_neg=_t(u_neg))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= LOSS_RTOL
    assert float(got[0]) > 0.0


def test_supcon_loss_draws_from_a_generator():
    feats, labels, hist, _, _ = _supcon_inputs(2)
    gen = torch.Generator().manual_seed(0)
    loss, pos, neg = point_supcon_loss(gen, _t(feats), _t(labels), _t(hist))
    loss2, _, _ = point_supcon_loss(torch.Generator().manual_seed(0), _t(feats),
                                    _t(labels), _t(hist))
    assert torch.isfinite(loss) and torch.equal(loss, loss2)
    assert pos.shape == neg.shape == (len(labels),)


def _simsiam_inputs(seed, n=200, c=5, d=8):
    rng = np.random.default_rng(seed)
    z = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(4)]
    corrs = [np.where(rng.random(n) < 0.2, -1, rng.integers(0, n, n)).astype(np.int32)
             for _ in range(2)]
    labels = [np.where(rng.random(n) < 0.1, 255, rng.integers(0, c, n)).astype(np.int32)
              for _ in range(2)]
    masks = [(rng.random(n) > 0.1).astype(np.float32) for _ in range(2)]
    anchors = rng.normal(size=(c, d)).astype(np.float32)
    split = np.zeros((c, 3), bool)
    split[np.arange(c), np.arange(c) % 3] = True
    return z, corrs, labels, masks, anchors, split


@pytest.mark.parametrize("balanced", [False, True])
def test_simsiam_losses_equal_jax(balanced):
    """``cosine_loss``, ``point_simsiam_loss`` and
    ``supervised_simsiam_loss`` (balanced masking fed JAX's two draws, one
    per half of its split key)."""
    z, corrs, labels, masks, anchors, split = _simsiam_inputs(3)
    np.testing.assert_allclose(simsiam.cosine_loss(_t(z[0]), _t(z[1])).numpy(),
                               jsimsiam.cosine_loss(z[0], z[1]), rtol=LOSS_RTOL)
    for rm in (None, masks[0]):
        got = simsiam.point_simsiam_loss(_t(z[0]), _t(z[1]), _t(corrs[0]),
                                         None if rm is None else _t(rm))
        want = jsimsiam.point_simsiam_loss(z[0], z[1], corrs[0], rm)
        assert _rel(got.numpy(), want) <= LOSS_RTOL
    cfg = dict(ignore_label=255, balanced_category_sampling=balanced,
               balanced_sample_head_ratio=0.5, balanced_sample_common_ratio=0.3)
    key = jax.random.PRNGKey(4)
    want_loss, want = jsimsiam.supervised_simsiam_loss(
        key, JaxConfig(**cfg), *z, *corrs, *labels, anchors, split, *masks)
    k1, k2 = jax.random.split(key)
    n = len(labels[0])
    u1, u2 = (_t(jax.random.uniform(k, (n,))) for k in (k1, k2))
    got_loss, got = simsiam.supervised_simsiam_loss(
        None, Config(**cfg), *map(_t, z), *map(_t, corrs), *map(_t, labels),
        _t(anchors), split, *map(_t, masks), u1=u1, u2=u2)
    assert got.keys() == want.keys()
    assert _rel(got_loss.numpy(), want_loss) <= LOSS_RTOL
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= LOSS_RTOL, k


@pytest.mark.parametrize("with_mask", [False, True])
def test_soft_iou_and_recall_ce_equal_jax(with_mask):
    rng = np.random.default_rng(8)
    n, c = 300, 6
    logits = (rng.normal(size=(n, c)) * 2).astype(np.float32)
    labels = np.where(rng.random(n) < 0.1, 255, rng.integers(0, c, n)).astype(np.int32)
    rm = (rng.random(n) > 0.2).astype(np.float32) if with_mask else None
    trm = None if rm is None else _t(rm)
    for fn, jfn in ((simsiam.soft_iou_loss, jsimsiam.soft_iou_loss),
                    (simsiam.recall_cross_entropy, jsimsiam.recall_cross_entropy)):
        got = fn(_t(logits), _t(labels), c, row_mask=trm)
        want = jfn(jnp.asarray(logits), jnp.asarray(labels), c, row_mask=rm)
        assert _rel(got.numpy(), want) <= LOSS_RTOL, fn.__name__


# ---- the paired step --------------------------------------------------------


def test_simsiam_step_matches_jax(paired):
    """One SGD step (lr 0.5, no weight decay, as tests/test_simsiam.py)
    with balanced masking on both views (JAX's draws fed to the port)."""
    (jb1, jb2, jc1, jc2), (b1, b2, c1, c2), pds = paired
    cfg = dict(ignore_label=255, balanced_category_sampling=True,
               balanced_sample_head_ratio=0.5, balanced_sample_common_ratio=0.5)
    split = pds.frequency_organized_cats
    anchors = pds.loaded_text_features[:, 0, :][:, :PLANES[-1]]
    jmodel = JaxPaired(out_channels=20, LAYERS=(1,) * 8, PLANES=PLANES)
    variables = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jb1.feats, jb1.graph, train=False,
                            feats2=jb2.feats, graph2=jb2.graph))
    variables = _random_variables(variables, 0)
    tx = jax_sgd_torch(0.5, weight_decay=0.0)
    state = JaxTrainState.create(variables, tx)
    step = jax.jit(jtrain_simsiam.make_simsiam_train_step(
        jmodel, tx, JaxConfig(**cfg), anchors, split))
    key = jax.random.PRNGKey(3)
    args = (state, jb1, jb2, jnp.asarray(jc1), jnp.asarray(jc2), key)
    new, want = step.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    want_sd = state_dict_from_jax(jax.device_get(new.params),
                                  jax.device_get(new.batch_stats))

    pcls = type("Paired", (Res16UNet34DPaired,), {"PLANES": PLANES, "LAYERS": (1,) * 8})
    model = pcls(out_channels=20, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    opt = sgd_torch(model.parameters(), 0.5, weight_decay=0.0)
    pstep = make_simsiam_train_step(model, opt, Config(**cfg), anchors, split, device="cpu")
    k1, k2 = jax.random.split(key)
    u1 = _t(jax.random.uniform(k1, (b1.feats.shape[0],)))
    u2 = _t(jax.random.uniform(k2, (b2.feats.shape[0],)))
    with gather_paths():
        st, got = pstep(TrainState(model, opt), b1, b2, c1, c2, u1=u1, u2=u2)
    assert st.step == 1 and got.keys() == dict(want).keys()
    errs = {k: _rel(got[k].numpy(), want[k]) for k in want}
    after = model.state_dict()
    errs["stats"] = max(_rel(after[k].numpy(), v.numpy()) for k, v in want_sd.items()
                        if k.endswith(("running_mean", "running_var")))
    errs["params"] = max(_rel(after[k].numpy(), v.numpy()) for k, v in want_sd.items()
                         if not k.endswith(("running_mean", "running_var")))
    print(errs, {k: float(v) for k, v in got.items()})  # shown by -rP
    assert all(e <= STEP_RTOL for e in errs.values()), errs
    assert float(got["anchor_loss1"]) > 0.0 and float(got["simsiam_loss1"]) > 0.0
