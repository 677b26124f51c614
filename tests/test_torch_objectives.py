"""The port's losses and objectives against the JAX package's.

The same inputs, made from a seed with numpy (N = 2,000 rows, C = 20
classes, D = 32, with padding rows and ignored labels), go through each JAX
function and its counterpart in ``languagegroundedsemseg_torch``. The
port's random draws are split from the arithmetic, so every port call is
given the draws the JAX function made from its key (the negatives, the
balanced-masking uniform, the augmentation's coins and attributes), drawn
here with the JAX function's own key splits.

Tolerances: values within 1e-6 relative (to the largest magnitude of the
reference), gradients with respect to the features within 1e-5 relative,
against ``jax.grad``. An objective's logged terms are held on the scale of
the loss they are parts of: a term far below it (the negative hinge once
nearly every row clears its margin, ~3e-5 against a loss of ~1.1) ends in a
cancellation, relu(thresh - d), whose own relative error is the features'
rounding over its size.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.config import Config as JaxConfig
from languagegroundedsemseg_tpu.losses import balancing as jbal
from languagegroundedsemseg_tpu.losses import contrastive as jcon
from languagegroundedsemseg_tpu.train import objectives as jobj
from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.losses import balancing as pbal
from languagegroundedsemseg_torch.losses import contrastive as pcon
from languagegroundedsemseg_torch.train import objectives as pobj

N, C, D, A = 2000, 20, 32, 4
IGNORE = 255
VALUE_RTOL, GRAD_RTOL = 1e-6, 1e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, N).astype(np.int32)
    labels[rng.random(N) < 0.1] = IGNORE
    row_mask = (np.arange(N) < N - 150).astype(np.float32)  # padding tail
    return SimpleNamespace(
        labels=labels, row_mask=row_mask,
        feats=rng.normal(size=(N, D)).astype(np.float32),
        logits=(2.0 * rng.normal(size=(N, C))).astype(np.float32),
        anchors=_unit(rng.normal(size=(C, D))),
        attributed=_unit(rng.normal(size=(C, A + 1, D))),
        proj=(np.eye(D) + 0.1 * rng.normal(size=(A, D, D))).astype(np.float32),
        split=_split(rng),
        weights=rng.uniform(0.5, 2.0, C).astype(np.float32),
        loss=rng.uniform(0.0, 3.0, N).astype(np.float32),
    )


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _split(rng):
    m = np.zeros((C, 3), bool)
    m[np.arange(C), rng.integers(0, 3, C)] = True
    return m


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=VALUE_RTOL, scale=0.0):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), scale, 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"relative max error {err:.3e} > {rtol:.0e}"


# ---- balancing --------------------------------------------------------------


@pytest.mark.parametrize("ratios", [(-1.0, -1.0), (0.3, 0.6), (0.5, -1.0)])
def test_balanced_loss_masking(ratios):
    x = _inputs(1)
    key = jax.random.PRNGKey(3)
    kw = dict(head_ratio=ratios[0], common_ratio=ratios[1], ignore_index=IGNORE)
    want = jbal.balanced_loss_masking(
        key, jnp.asarray(x.loss), jnp.asarray(x.labels), jnp.asarray(x.split),
        row_mask=jnp.asarray(x.row_mask), **kw)
    u = np.asarray(jax.random.uniform(key, (N,)))
    got = pbal.balanced_loss_masking(
        None, _t(x.loss), _t(x.labels), _t(x.split), row_mask=_t(x.row_mask),
        u=_t(u), **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_split_masks_from_sets_equal():
    args = (10, [0, 1, 2], [3, 4], [5, 9])
    np.testing.assert_array_equal(pbal.split_masks_from_sets(*args),
                                  jbal.split_masks_from_sets(*args))


# ---- contrastive ------------------------------------------------------------


@pytest.mark.parametrize("attributed", [False, True])
@pytest.mark.parametrize("distance", ["cos", "l2", "l1"])
def test_contrastive_language_loss(distance, attributed):
    x = _inputs(2)
    key = jax.random.PRNGKey(5)
    anchors = x.attributed if attributed else x.anchors
    slot = (np.random.default_rng(4).integers(0, A + 1, N).astype(np.int32)
            if attributed else None)
    kw = dict(num_negatives=3, pos_thresh=0.1, neg_thresh=0.6, neg_weight=0.7,
              distance=distance, ignore_index=IGNORE)

    def jax_loss(f):
        return jcon.contrastive_language_loss(
            key, f, jnp.asarray(x.labels), jnp.asarray(anchors),
            row_mask=jnp.asarray(x.row_mask),
            pos_slot=None if slot is None else jnp.asarray(slot), **kw)

    want = jax_loss(jnp.asarray(x.feats))
    want_grad = jax.grad(lambda f: jax_loss(f)[0])(jnp.asarray(x.feats))
    neg = jcon.sample_negatives(key, jnp.clip(jnp.asarray(x.labels), 0, C - 1), C, 3)

    feats = _t(x.feats).requires_grad_(True)
    got = pcon.contrastive_language_loss(
        None, feats, _t(x.labels), _t(anchors), row_mask=_t(x.row_mask),
        pos_slot=None if slot is None else _t(slot), negatives=_t(np.asarray(neg)),
        **kw)
    for g, w in zip(got, want):
        _close(g, w)
    got[0].backward()
    _close(feats.grad, want_grad, GRAD_RTOL)


def test_latent_attribute_augmentation():
    x = _inputs(3)
    key = jax.random.PRNGKey(7)
    tail = jnp.asarray(x.split[:, 2])
    want_f, want_slot = jcon.latent_attribute_augmentation(
        key, jnp.asarray(x.feats), jnp.asarray(x.labels), jnp.asarray(x.proj),
        tail, 0.7, ignore_index=IGNORE)
    k1, k2 = jax.random.split(key)
    do_cat = (jax.random.uniform(k1, (C,)) < 0.7) & tail
    attr_cat = jax.random.randint(k2, (C,), 0, A)
    got_f, got_slot = pcon.latent_attribute_augmentation(
        None, _t(x.feats), _t(x.labels), _t(x.proj), _t(x.split[:, 2]), 0.7,
        ignore_index=IGNORE, do_cat=_t(np.asarray(do_cat)),
        attr_cat=_t(np.asarray(attr_cat)))
    assert int(np.asarray(want_slot).max()) > 0, "no row was augmented"
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(want_slot))
    _close(got_f, want_f)


@pytest.mark.parametrize("distance", ["cos", "l2", "l1"])
def test_l2_anchor_loss_feature_sim_and_norm_penalty(distance):
    x = _inputs(4)
    f = jnp.asarray(x.feats)
    feats = _t(x.feats).requires_grad_(True)

    want = jcon.l2_anchor_loss(f, jnp.asarray(x.labels), jnp.asarray(x.anchors),
                               IGNORE, jnp.asarray(x.row_mask))
    got = pcon.l2_anchor_loss(feats, _t(x.labels), _t(x.anchors), IGNORE,
                              _t(x.row_mask))
    _close(got, want)

    _close(pcon.feature_sim(feats, _t(x.attributed), distance),
           jcon.feature_sim(f, jnp.asarray(x.attributed), distance))

    for mask in (None, x.row_mask):
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else _t(mask)
        _close(pcon.feature_norm_penalty(feats / 5.0, tm, 0.2),
               jcon.feature_norm_penalty(f / 5.0, jm, 0.2))

    def jax_total(ff):
        return (jcon.l2_anchor_loss(ff, jnp.asarray(x.labels), jnp.asarray(x.anchors),
                                    IGNORE, jnp.asarray(x.row_mask)).sum()
                + jcon.feature_norm_penalty(ff / 5.0, jnp.asarray(x.row_mask), 0.2)
                + jcon.feature_sim(ff, jnp.asarray(x.anchors), distance).mean())

    total = (pcon.l2_anchor_loss(feats, _t(x.labels), _t(x.anchors), IGNORE,
                                 _t(x.row_mask)).sum()
             + pcon.feature_norm_penalty(feats / 5.0, _t(x.row_mask), 0.2)
             + pcon.feature_sim(feats, _t(x.anchors), distance).mean())
    total.backward()
    _close(feats.grad, jax.grad(jax_total)(f), GRAD_RTOL)


def test_contrastive_language_ce_loss():
    x = _inputs(5)
    want = jcon.contrastive_language_ce_loss(
        jnp.asarray(x.feats), jnp.asarray(x.labels), jnp.asarray(x.attributed),
        ignore_index=IGNORE, row_mask=jnp.asarray(x.row_mask))
    got = pcon.contrastive_language_ce_loss(
        _t(x.feats), _t(x.labels), _t(x.attributed), ignore_index=IGNORE,
        row_mask=_t(x.row_mask))
    _close(got, want)


def test_port_draws_have_the_right_support():
    """The port's own draws: no negative is the row's label, every
    attribute id is below A, and every coin falls on an eligible class."""
    gen = torch.Generator().manual_seed(0)
    labels = torch.randint(0, C, (N,), generator=gen)
    neg = pcon.sample_negatives(gen, labels, C, 5)
    assert neg.shape == (N, 5)
    assert not (neg == labels[:, None]).any()
    assert int(neg.min()) >= 0 and int(neg.max()) < C
    assert len(torch.unique(neg)) == C  # every class can be drawn

    x = _inputs(6)
    mask = _t(x.split[:, 2])
    _, slot = pcon.latent_attribute_augmentation(
        gen, _t(x.feats), _t(x.labels), _t(x.proj), mask, 1.0,
        ignore_index=IGNORE)
    slot = slot.numpy()
    assert slot.min() >= 0 and slot.max() <= A
    lab = x.labels
    augmented = slot > 0
    assert augmented.any()
    assert x.split[lab[augmented], 2].all()  # only tail classes
    assert (lab[augmented] != IGNORE).all()


# ---- objectives -------------------------------------------------------------


def _configs(**kw):
    kw.setdefault("ignore_label", IGNORE)
    kw.setdefault("num_negative_samples", 3)
    return JaxConfig(**kw), Config(**kw)


BASELINE = [
    dict(loss_type="cross_entropy", balanced_category_sampling=False),
    dict(loss_type="cross_entropy", balanced_category_sampling=True),
    dict(loss_type="weighted_ce", balanced_category_sampling=True,
         balanced_sample_head_ratio=0.4, balanced_sample_common_ratio=0.7),
    dict(loss_type="focal", focal_gamma=2.0, focal_alpha=0.5),
    dict(use_embedding_loss="both", balanced_category_sampling=True,
         balanced_sample_head_ratio=0.5, embedding_loss_lambda=0.3),
    dict(use_embedding_loss="both", embedding_loss_type="l2",
         balanced_category_sampling=False),
]


def _baseline_draws(cfg, key, labels):
    """The draws the JAX baseline objective makes from ``key``."""
    draws = {}
    if cfg.use_embedding_loss and cfg.embedding_loss_type != "l2":
        k_emb, key = jax.random.split(key)
        draws["negatives"] = jcon.sample_negatives(
            k_emb, jnp.clip(labels, 0, C - 1), C, cfg.num_negative_samples)
    elif cfg.use_embedding_loss:
        _, key = jax.random.split(key)
    draws["u"] = jax.random.uniform(key, (N,))
    return {k: _t(np.asarray(v)) for k, v in draws.items()}


@pytest.mark.parametrize("switches", BASELINE)
def test_baseline_objective(switches):
    x = _inputs(7)
    jcfg, cfg = _configs(**switches)
    key = jax.random.PRNGKey(11)
    jf = jobj.make_baseline_objective(jcfg, x.weights, x.split, x.anchors)
    pf = pobj.make_baseline_objective(cfg, x.weights, x.split, x.anchors, device="cpu")
    jbatch = SimpleNamespace(labels=jnp.asarray(x.labels))
    pbatch = SimpleNamespace(labels=_t(x.labels))

    def jax_loss(logits, feats):
        return jf(logits, feats, jbatch, key, jnp.asarray(x.row_mask))

    (want, want_m), (gl, gf) = (
        jax_loss(jnp.asarray(x.logits), jnp.asarray(x.feats)),
        jax.grad(lambda a, b: jax_loss(a, b)[0], argnums=(0, 1))(
            jnp.asarray(x.logits), jnp.asarray(x.feats)))
    logits = _t(x.logits).requires_grad_(True)
    feats = _t(x.feats).requires_grad_(True)
    got, got_m = pf(logits, feats, pbatch, None, _t(x.row_mask),
                    draws=_baseline_draws(jcfg, key, jnp.asarray(x.labels)))
    _close(got, want)
    assert set(got_m) == set(want_m)
    for k in want_m:
        _close(got_m[k], want_m[k], scale=abs(float(want)))
    got.backward()
    _close(logits.grad, gl, GRAD_RTOL)
    if switches.get("use_embedding_loss"):
        _close(feats.grad, gf, GRAD_RTOL)


REPRESENTATION = [
    dict(use_embedding_loss="contrastive"),
    dict(use_embedding_loss="contrastive", representation_distance_type="l2",
         normalize_features=True, balanced_category_sampling=True,
         balanced_sample_head_ratio=0.3, balanced_sample_common_ratio=0.5),
    dict(use_embedding_loss="contrastive", representation_distance_type="l1",
         balanced_category_sampling=False),
    dict(use_embedding_loss="contrastive", instance_augmentation="latent",
         instance_augmentation_color_aug_prob=0.8, normalize_features=True),
    dict(use_embedding_loss="l2", balanced_category_sampling=True,
         balanced_sample_head_ratio=0.5),
]


def _representation_draws(cfg, key, labels, tail, latent):
    """The draws the JAX representation objective makes from ``key``."""
    draws = {}
    k_emb, key = jax.random.split(key)
    if latent:
        k_aug, k_emb = jax.random.split(k_emb)
        k1, k2 = jax.random.split(k_aug)
        draws["do_cat"] = (jax.random.uniform(k1, (C,))
                           < cfg.instance_augmentation_color_aug_prob) & tail
        draws["attr_cat"] = jax.random.randint(k2, (C,), 0, A)
    if not (cfg.use_embedding_loss == "l2" or cfg.embedding_loss_type == "l2"):
        draws["negatives"] = jcon.sample_negatives(
            k_emb, jnp.clip(labels, 0, C - 1), C, cfg.num_negative_samples)
    draws["u"] = jax.random.uniform(key, (N,))
    return {k: _t(np.asarray(v)) for k, v in draws.items()}


@pytest.mark.parametrize("switches", REPRESENTATION)
def test_representation_objective(switches):
    x = _inputs(8)
    jcfg, cfg = _configs(**switches)
    latent = switches.get("instance_augmentation") == "latent"
    anchors = x.attributed if latent else x.anchors[:, None, :]
    proj = x.proj if latent else None
    key = jax.random.PRNGKey(13)
    jf = jobj.make_representation_objective(jcfg, anchors, x.split, projection_w=proj)
    pf = pobj.make_representation_objective(cfg, anchors, x.split, projection_w=proj,
                                            device="cpu")
    jbatch = SimpleNamespace(labels=jnp.asarray(x.labels))

    def jax_loss(feats):
        return jf(feats, feats, jbatch, key, jnp.asarray(x.row_mask))

    want, want_m = jax_loss(jnp.asarray(x.feats))
    want_grad = jax.grad(lambda f: jax_loss(f)[0])(jnp.asarray(x.feats))
    feats = _t(x.feats).requires_grad_(True)
    draws = _representation_draws(jcfg, key, jnp.asarray(x.labels),
                                  jnp.asarray(x.split[:, 2]), latent)
    got, got_m = pf(feats, feats, SimpleNamespace(labels=_t(x.labels)), None,
                    _t(x.row_mask), draws=draws)
    _close(got, want)
    assert set(got_m) == set(want_m)
    for k in want_m:
        _close(got_m[k], want_m[k], scale=abs(float(want)))
    got.backward()
    _close(feats.grad, want_grad, GRAD_RTOL)


def test_representation_predictions():
    x = _inputs(9)
    want = jobj.representation_predictions(jnp.asarray(x.feats), x.anchors, "cos")
    got = pobj.representation_predictions(_t(x.feats), x.anchors, "cos")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_objectives_draw_from_the_generator():
    """Without draws the objective draws from the generator it is given:
    the same seed gives the same loss, another seed another."""
    x = _inputs(10)
    _, cfg = _configs(use_embedding_loss="contrastive", balanced_category_sampling=True,
                      balanced_sample_head_ratio=0.5)
    pf = pobj.make_representation_objective(cfg, x.anchors[:, None, :], x.split,
                                            device="cpu")
    batch = SimpleNamespace(labels=_t(x.labels))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return float(pf(_t(x.feats), _t(x.feats), batch, gen, _t(x.row_mask))[0])

    assert run(0) == run(0)
    assert run(0) != run(1)
