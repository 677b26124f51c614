"""The port's trainer (slice D as a whole) on the CPU, against the JAX
package's.

``SyntheticTiny20Dataset`` and ``Res16UNet14A`` at ``fixed_capacity`` 2048,
as the JAX trainer tests run them; the port's trainer takes
``device="cpu"``. The JAX model routes around its Pallas kernels on the
CPU (the f32 gather paths); where the port's batches carry window
annotations its plain kernel versions would project in bf16, so the parity
checks turn its window routes off (as tests/test_torch_data_loader.py
does) and both packages run f32 gather paths. The JAX trainer's flax init
is replaced by random trees of the same shapes (``_random_variables``,
non-trivial BN statistics), which the port takes through
``convert.state_dict_from_jax``.
"""

import contextlib
import functools
import glob
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.config import Config as JaxConfig
from languagegroundedsemseg_tpu.train import solvers as jax_solvers
from languagegroundedsemseg_tpu.train import trainer as jax_trainer
from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.data import loader as port_loader
from languagegroundedsemseg_torch.data.loader import load_dataset, register_dataset
from languagegroundedsemseg_torch.data.synthetic_dataset import SyntheticTiny20Dataset
from languagegroundedsemseg_torch.insseg.dataset import load_instance_dataset
from languagegroundedsemseg_torch.insseg.trainer import InssegTrainer
from languagegroundedsemseg_torch.models import layers
from languagegroundedsemseg_torch.ops import onehot_conv
from languagegroundedsemseg_torch.train.trainer import Trainer, select_mode
from test_torch_res16unet import _random_variables

# val_loss on the f32 gather paths: the same sums in another order
VAL_LOSS_RTOL = 1e-5
# mIoU / mAcc: an argmax tie among near-equal logits can flip a row
MIOU_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: a step at these sizes is
    thousands of small ops, and with a pool each op's barrier waits on the
    threads other test workers keep off the cores (a tiny fit then takes
    minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**kw):
    kw.setdefault("ignore_label", 255)
    kw.setdefault("fixed_capacity", 2048)
    kw.setdefault("dataset", "SyntheticTiny20Dataset")
    kw.setdefault("model", "Res16UNet14A")
    kw.setdefault("batch_size", 2)
    kw.setdefault("val_batch_size", 2)
    kw.setdefault("num_workers", 1)
    kw.setdefault("num_val_workers", 1)
    kw.setdefault("num_devices", 1)
    kw.setdefault("lr", 0.1)
    kw.setdefault("tensorboard", False)
    return kw


def _port(tmp_path, name="run", **kw):
    return Trainer(Config(**_kw(log_dir=str(tmp_path / name), **kw)), device="cpu")


def gather_paths():
    """The port's selector and child-sum window routes declined: every conv
    takes its f32 gather path, as the JAX model does on the CPU."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(layers, "onehot_window_conv", lambda *a: None))
    stack.enter_context(mock.patch.object(onehot_conv, "_cs_window", lambda *a: (0, 0, 1)))
    return stack


def _jax_trainer(tmp_path, seed=0, **kw):
    """The JAX trainer with random weights of its model's shapes (no eager
    flax init)."""
    def init(init_fn, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(init_fn, **kwargs), *args)
        return _random_variables(shapes, seed)

    cfg = JaxConfig(**_kw(log_dir=str(tmp_path / "jax"), **kw))
    with mock.patch.object(jax_trainer, "init_on_cpu", init):
        return jax_trainer.Trainer(cfg)


def _copy_weights(tr_j, tr_p):
    tr_p.model.load_state_dict(state_dict_from_jax(tr_j.state.params,
                                                   tr_j.state.batch_stats))


@pytest.mark.parametrize("kw", [
    dict(), dict(use_embedding_loss="contrastive"), dict(use_embedding_loss="both"),
    dict(model="ClassifierNet"), dict(dataset="Scannet200Instance2cmDataset"),
    dict(use_embedding_loss="l2"),
])
def test_select_mode_equals_jax(kw):
    assert select_mode(Config(**_kw(**kw))) == jax_trainer.select_mode(JaxConfig(**_kw(**kw)))


@pytest.mark.parametrize("kw,exc,match", [
    (dict(dataset="SyntheticInstanceDataset", num_devices=2), RuntimeError, "torchrun"),
    (dict(model="ClassifierNet"), NotImplementedError, "item 7"),
    (dict(classifier_resample_features=True), NotImplementedError, "item 7"),
    (dict(model="ResNet14"), ValueError, "graph spec"),
    (dict(num_devices=2), RuntimeError, "torchrun"),
    (dict(remat=True), NotImplementedError, "item 9"),
], ids=["kw0-item 5", "kw1-item 7", "kw2-item 7", "kw3-graph spec", "kw4-item 5",
        "kw5-item 9"])
def test_unported_modes_raise(tmp_path, kw, exc, match):
    """Each mode's trainer as cli.main picks it: instance datasets go to
    InssegTrainer, the rest to Trainer. The unported modes raise naming
    their ROADMAP item; a model whose graph spec the loaders do not build
    raises; more than one device without a process group (one process per
    rank) raises naming torchrun."""
    cfg = Config(**_kw(log_dir=str(tmp_path / "run"), **kw))
    with pytest.raises(exc, match=match):
        if select_mode(cfg) == "insseg":
            InssegTrainer(cfg, dataset_cls=load_instance_dataset(cfg.dataset), device="cpu")
        else:
            Trainer(cfg, device="cpu")


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Config(**_kw(log_dir=str(tmp_path / "run"))))


@pytest.mark.parametrize("mode", ["baseline", "representation"])
def test_validation_matches_jax(tmp_path, mode):
    """One val batch through both trainers' ``validate`` with the same
    weights. Baseline: val_loss, mIoU and mAcc. Representation: mIoU only
    (the port draws its own negatives for val_loss)."""
    kw = {} if mode == "baseline" else dict(use_embedding_loss="contrastive")
    tr_j = _jax_trainer(tmp_path, **kw)
    tr_p = _port(tmp_path, **kw)
    assert tr_p.mode == tr_j.mode == mode
    _copy_weights(tr_j, tr_p)
    want = tr_j.validate(max_batches=1)
    with gather_paths():
        got = tr_p.validate(max_batches=1)
    print(f"{mode}: port {got}\njax  {want}")  # shown by pytest -rP
    assert got.keys() == want.keys()
    assert abs(got["val_miou"] - want["val_miou"]) <= MIOU_ATOL
    assert 0.0 < got["val_miou"] <= 1.0
    if mode == "baseline":
        assert abs(got["val_loss"] - want["val_loss"]) <= VAL_LOSS_RTOL * abs(want["val_loss"])
        assert abs(got["val_macc"] - want["val_macc"]) <= MIOU_ATOL
    assert np.isfinite(got["val_loss"]) and np.isfinite(got["val_map"])


def _records(log_dir, phase):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["phase"] == phase]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A baseline fit of 2 epochs x 2 steps, MultiStepLR stepping at epoch
    1, with the lr of every update recorded."""
    tmp = tmp_path_factory.mktemp("fit")
    tr = _port(tmp, scheduler="MultiStepLR", multi_step_milestones=(1,),
               step_gamma=0.3, stat_freq=1)
    lrs = []
    step = tr.p_train_step

    def recorded(state, batch, gen):
        out = step(state, batch, gen)
        lrs.append(state.optimizer.inner.param_groups[0]["lr"])
        return out

    tr.p_train_step = recorded
    tr.fit(max_epochs=2, max_steps_per_epoch=2)
    return tr, lrs


def test_fit_steps_records_checkpoints_and_schedule(fitted):
    tr, lrs = fitted
    assert tr.state.step == 4
    epochs = _records(tr.log_dir, "epoch")
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert [r["step"] for r in epochs] == [2, 4]
    for r in epochs:
        assert 0.0 <= r["val_miou"] <= 1.0 and np.isfinite(r["val_loss"])
        assert np.isfinite(r["train_loss"])
    assert len(_records(tr.log_dir, "train")) == 4
    assert os.path.isfile(os.path.join(tr.log_dir, "last_step=4.ckpt"))
    assert not glob.glob(os.path.join(tr.log_dir, "last_step=2.ckpt"))
    assert glob.glob(os.path.join(tr.log_dir, "best_val_miou=*.ckpt"))
    # the JAX trainer's epoch-stepped schedule (trainer.py:186-200)
    steps_per_epoch = len(tr.train_loader)
    assert steps_per_epoch == 2
    epoch_sched = jax_solvers.make_lr_schedule(
        "MultiStepLR", 0.1, step_gamma=0.3, multi_step_milestones=(1,))
    want = [float(epoch_sched(jnp.floor(s / steps_per_epoch))) for s in range(4)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    assert lrs[0] != lrs[-1]


def test_resume_restores_every_tensor(fitted, tmp_path):
    tr, _ = fitted
    tr2 = _port(tmp_path, resume=tr.log_dir)
    tr2.fit(max_epochs=2)  # epochs 0 and 1 are done: restore only
    assert tr2.state.step == 4
    assert tr2.state.optimizer.updates == 4
    for (n, a), b in zip(tr.model.state_dict().items(), tr2.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa = tr.state.optimizer.inner.state_dict()["state"]
    sb = tr2.state.optimizer.inner.state_dict()["state"]
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"])
    tr2.fit(max_epochs=3, max_steps_per_epoch=1)  # then trains on
    assert tr2.state.step == 5
    assert [r["epoch"] for r in _records(tr2.log_dir, "epoch")] == [2]


class _AttributedTiny20(SyntheticTiny20Dataset):
    """Tiny20 with attributed anchors (C, 1 + 8, D) and a tail split, so
    latent augmentation has tail classes to rotate."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        rng = np.random.default_rng(3)
        attrs = rng.normal(size=(self.NUM_CLASSES, 8, self.ANCHOR_DIM)).astype(np.float32)
        attrs /= np.linalg.norm(attrs, axis=-1, keepdims=True)
        self.loaded_text_features = np.concatenate([self.loaded_text_features, attrs], 1)
        self.frequency_organized_cats = np.zeros((self.NUM_CLASSES, 3), bool)
        self.frequency_organized_cats[np.arange(self.NUM_CLASSES), np.arange(self.NUM_CLASSES) % 3] = True


def test_representation_step_with_latent_augmentation(tmp_path):
    load_dataset("SyntheticTiny20Dataset")  # fill the registry before adding to it
    with mock.patch.dict(port_loader._DATASETS):  # the registry as it was after
        register_dataset(_AttributedTiny20)
        tr = _port(tmp_path, dataset="_AttributedTiny20", use_embedding_loss="contrastive",
                   instance_augmentation="latent", instance_augmentation_color_aug_prob=1.0,
                   normalize_features=True, stat_freq=1)
    assert tr.mode == "representation" and tr.representation_only
    tr.fit(max_epochs=1, max_steps_per_epoch=1)
    (rec,) = _records(tr.log_dir, "train")
    for k in ("loss", "pos_loss", "neg_loss", "feat_norm_penalty", "grad_norm"):
        assert np.isfinite(rec[k]), k
    assert rec["pos_loss"] > 0.0
    (ep,) = _records(tr.log_dir, "epoch")
    assert np.isfinite(ep["val_loss"]) and 0.0 <= ep["val_miou"] <= 1.0
    assert glob.glob(os.path.join(tr.log_dir, "best_val_loss=*.ckpt"))


def test_classifier_only_updates_the_head_only(tmp_path):
    tr = _port(tmp_path, classifier_only=True)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    stats = [b.clone() for b in tr.model.buffers()]
    tr.fit(max_epochs=1, max_steps_per_epoch=2)
    for n, p in tr.model.named_parameters():
        if n.startswith("final"):
            assert not torch.equal(p, before[n]), n
        else:
            assert torch.equal(p, before[n]), n
    assert any(not torch.equal(a, b) for a, b in zip(stats, tr.model.buffers()))


def test_weights_flag_loads_a_converted_checkpoint(fitted, tmp_path):
    tr, _ = fitted
    path = str(tmp_path / "w.ckpt")
    torch.save({"model": tr.model.state_dict()}, path)
    tr2 = _port(tmp_path, weights=path)
    for (n, a), b in zip(tr.model.state_dict().items(), tr2.model.state_dict().values()):
        assert torch.equal(a, b), n


def test_profiler_and_test_pass(tmp_path):
    tr = _port(tmp_path, profile=True, profile_start_step=1, profile_num_steps=1)
    tr.fit(max_epochs=1, max_steps_per_epoch=2)
    assert tr.profiler.captured
    assert glob.glob(os.path.join(tr.log_dir, "plugins", "profile", "*", "trace.json"))
    m = tr.test()
    assert 0.0 <= m["val_miou"] <= 1.0


@pytest.mark.slow
def test_two_fit_steps_track_jax(tmp_path):
    """Both trainers fit 2 steps from the same weights on the same batches
    (baseline, no balanced sampling): the first step's loss agrees within
    1e-5 relative and both losses fall. Later steps may drift apart: the
    gradient is not a continuous function of the rounding (PERF.md §6)."""
    kw = dict(balanced_category_sampling=False, stat_freq=1)
    tr_j = _jax_trainer(tmp_path, **kw)
    tr_p = _port(tmp_path, **kw)
    _copy_weights(tr_j, tr_p)
    tr_j.fit(max_epochs=1, max_steps_per_epoch=2)
    with gather_paths():
        tr_p.fit(max_epochs=1, max_steps_per_epoch=2)
    lj = [r["loss"] for r in _records(tr_j.log_dir, "train")]
    lp = [r["loss"] for r in _records(tr_p.log_dir, "train")]
    print(f"jax {lj}\nport {lp}")
    assert len(lp) == len(lj) == 2
    assert abs(lp[0] - lj[0]) <= 1e-5 * abs(lj[0])
    assert lp[1] < lp[0] and lj[1] < lj[0]
