"""The port's instance segmentation (``languagegroundedsemseg_torch/insseg``)
against the JAX package's, on the CPU.

The same seeded numpy inputs go through both: the offset losses, the
InstanceRes16UNet14A forward (JAX weights carried by
``convert.state_dict_from_jax``), the clustering and the evaluator, the
synthetic instance dataset, one train step's losses and one validation of
``InssegTrainer``. The JAX trainer's flax init is replaced by random trees
of its shapes (as tests/test_torch_trainer.py does); its model runs the
f32 gather paths on the CPU, and the port's window routes are declined
(``gather_paths``) so both packages run the same arithmetic. Models are
14A at ``fixed_capacity`` 2048; the port's trainer runs with one torch
thread.
"""

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
from languagegroundedsemseg_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from languagegroundedsemseg_tpu.data.dataset import build_input_transforms as jax_transforms
from languagegroundedsemseg_tpu.insseg import clustering as j_clustering
from languagegroundedsemseg_tpu.insseg import dataset as j_dataset
from languagegroundedsemseg_tpu.insseg import evaluation as j_evaluation
from languagegroundedsemseg_tpu.insseg import losses as j_losses
from languagegroundedsemseg_tpu.insseg import trainer as j_trainer
from languagegroundedsemseg_tpu.insseg.model import InstanceRes16UNet14A as JaxInstance14A
from languagegroundedsemseg_tpu.models.res16unet import res16unet_graph_spec as jax_graph_spec
from languagegroundedsemseg_tpu.train import trainer as jax_train_trainer
from languagegroundedsemseg_torch.cli.main import main
from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.data.dataset import build_input_transforms
from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
from languagegroundedsemseg_torch.insseg import Clustering, InstanceEvaluator, InstanceRes16UNet
from languagegroundedsemseg_torch.insseg import dataset as p_dataset
from languagegroundedsemseg_torch.insseg.losses import offset_losses
from languagegroundedsemseg_torch.insseg.model import InstanceRes16UNet14A
from languagegroundedsemseg_torch.insseg.trainer import INSSEG_MODELS, InssegTrainer
from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec
from languagegroundedsemseg_torch.train.trainer import Trainer
from test_torch_cli import FAST_COMPILE, _flax_shapes
from test_torch_res16unet import _random_variables
from test_torch_trainer import MIOU_ATOL, gather_paths, one_torch_thread  # noqa: F401 (autouse)

# the offset losses: the same f32 sums in another order
LOSS_RTOL = 1e-6
# the forward on the f32 gather paths (tests/test_torch_cli.py's bound)
FORWARD_RTOL = 1e-4
# one train step's losses from the same weights and batch
STEP_LOSS_RTOL = 1e-5

CLI_ARGS = ["--dataset", "SyntheticInstanceDataset", "--model", "InstanceRes16UNet14A",
            "--fixed_capacity", "2048", "--batch_size", "2", "--val_batch_size", "1",
            "--max_iter", "2", "--ignore_label", "255", "--num_workers", "1"]


def _kw(**kw):
    kw.setdefault("ignore_label", 255)
    kw.setdefault("fixed_capacity", 2048)
    kw.setdefault("dataset", "SyntheticInstanceDataset")
    kw.setdefault("model", "InstanceRes16UNet14A")
    kw.setdefault("batch_size", 2)
    kw.setdefault("val_batch_size", 1)
    kw.setdefault("num_workers", 1)
    kw.setdefault("lr", 0.05)
    return kw


def _port(tmp_path, name="port", **kw):
    return InssegTrainer(Config(**_kw(log_dir=str(tmp_path / name), **kw)), device="cpu")


def _jax_trainer(tmp_path, seed=0, **kw):
    """The JAX InssegTrainer with random weights of its model's shapes (no
    eager flax init)."""
    def init(init_fn, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(init_fn, **kwargs), *args)
        return _random_variables(shapes, seed)

    cfg = JaxConfig(**_kw(log_dir=str(tmp_path / "jax"), **kw))
    with mock.patch.object(jax_train_trainer, "init_on_cpu", init):
        return j_trainer.InssegTrainer(cfg)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX and a port InssegTrainer with the same weights."""
    tmp = tmp_path_factory.mktemp("pair")
    tr_j = _jax_trainer(tmp)
    tr_p = _port(tmp)
    tr_p.model.load_state_dict(state_dict_from_jax(tr_j.state.params,
                                                   tr_j.state.batch_stats))
    return tr_j, tr_p


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


# ---- losses -------------------------------------------------------------


@pytest.mark.parametrize("with_row_mask", [False, True])
def test_offset_losses_equal_jax(with_row_mask):
    """Rows with no instance (centers -1, instance_valid 0) and padding
    rows (zeros, row_mask 0) add nothing."""
    rng = np.random.default_rng(0)
    n = 400
    offsets = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    coords = rng.integers(0, 200, (n, 3)).astype(np.float32)
    centers = (coords + rng.normal(0, 5, (n, 3))).astype(np.float32)
    valid = (rng.random(n) > 0.3).astype(np.float32)
    centers[valid == 0] = -1.0
    row_mask = np.ones(n, np.float32)
    row_mask[-50:] = 0.0
    offsets[-50:] = coords[-50:] = centers[-50:] = valid[-50:] = 0.0
    rm = row_mask if with_row_mask else None
    want = j_losses.offset_losses(jnp.asarray(offsets), jnp.asarray(coords),
                                  jnp.asarray(centers), jnp.asarray(valid), 0.02,
                                  None if rm is None else jnp.asarray(rm))
    got = offset_losses(torch.from_numpy(offsets), torch.from_numpy(coords),
                        torch.from_numpy(centers), torch.from_numpy(valid), 0.02,
                        None if rm is None else torch.from_numpy(rm))
    for g, w in zip(got, want):
        assert _rel(g, w) <= LOSS_RTOL, (float(g), float(w))
    # the masked rows do not move the losses
    moved = offset_losses(torch.from_numpy(offsets + 10.0 * (valid == 0)[:, None]),
                          torch.from_numpy(coords), torch.from_numpy(centers),
                          torch.from_numpy(valid), 0.02)
    unmoved = offset_losses(torch.from_numpy(offsets), torch.from_numpy(coords),
                            torch.from_numpy(centers), torch.from_numpy(valid), 0.02)
    for a, b in zip(moved, unmoved):
        assert float(a) == float(b)


# ---- model --------------------------------------------------------------


def test_instance_model_forward_matches_jax():
    """InstanceRes16UNet14A's (offsets, logits, features) with the JAX
    weights carried across; every head tensor maps by name."""
    scenes = [voxelize_scene(np.random.default_rng(0), 3000)]
    jbatch = JaxBatchBuilder(spec=jax_graph_spec(), fixed_capacity=4096).build(scenes)
    batch = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=4096).build(
        scenes, device="cpu")
    model = InstanceRes16UNet14A(out_channels=20, device="cpu")
    variables = _random_variables(_flax_shapes(model), 0)
    args = (variables, jbatch.feats, jbatch.graph)
    want = JaxInstance14A(out_channels=20).apply
    want = jax.jit(functools.partial(want, train=False)).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert sd.keys() == model.state_dict().keys()
    assert {"offsets_pre.kernel", "offsets_pre.bias", "bntr_offset.bn.running_var",
            "offsets.kernel", "offsets.bias"} <= sd.keys()
    model.load_state_dict(sd)
    model.eval()
    with gather_paths(), torch.inference_mode():
        got = model(batch.feats.to(torch.float32), batch.graph)
    valid = np.asarray(jbatch.graph.levels[0].valid) > 0
    for name, g, w in zip(("offsets", "logits", "features"), got, want):
        g, w = g.numpy()[valid], np.asarray(w)[valid]
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < FORWARD_RTOL, f"{name}: relative max error {err}"
    assert got[0].shape[1] == 3


def test_registry_and_exports():
    assert INSSEG_MODELS == {"InstanceRes16UNet": InstanceRes16UNet,
                             "InstanceRes16UNet14A": InstanceRes16UNet14A}
    assert InstanceRes16UNet.PLANES == (32, 64, 128, 256, 256, 128, 96, 96)
    assert InstanceRes16UNet14A.LAYERS == JaxInstance14A.LAYERS
    assert InstanceRes16UNet14A.PLANES == JaxInstance14A.PLANES
    assert p_dataset.load_instance_dataset("Scannet200Instance2cmDataset").NUM_CLASSES == 200
    with pytest.raises(KeyError):
        p_dataset.load_instance_dataset("Nope")


# ---- clustering and evaluation ------------------------------------------


def _scored_blobs(seed, n_classes=4):
    """Vote-shifted vertices in well-separated blobs and softmax scores
    whose argmax labels each blob, with some stray points."""
    rng = np.random.default_rng(seed)
    parts, labels = [], []
    for b in range(6):
        k = int(rng.integers(60, 220))
        parts.append(rng.normal(0, 0.008, (k, 3)) + rng.random(3) * 3)
        labels.append(np.full(k, b % n_classes))
    parts.append(rng.random((40, 3)) * 3)
    labels.append(rng.integers(0, n_classes, 40))
    verts = np.concatenate(parts).astype(np.float32)
    lab = np.concatenate(labels)
    logits = rng.normal(0, 1, (len(lab), n_classes)) + 4.0 * np.eye(n_classes)[lab]
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return verts, scores.astype(np.float32)


def _same_proposals(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k]["label_id"] == want[k]["label_id"]
        assert got[k]["conf"] == want[k]["conf"]
        np.testing.assert_array_equal(got[k]["pred_mask"], want[k]["pred_mask"])


@pytest.mark.parametrize("seed,mapped", [(0, False), (1, True)])
def test_clustering_equals_jax(seed, mapped):
    verts, scores = _scored_blobs(seed)
    kw = dict(ignored_labels=[5] if mapped else [3],
              class_mapping=np.array([1, 3, 5, 7]) if mapped else None)
    got, want = Clustering(**kw), j_clustering.Clustering(**kw)
    a = got.get_instances(verts, scores)
    _same_proposals(a, want.get_instances(verts, scores))
    assert len(a) >= 3
    shifted = verts + np.float32(0.004)
    _same_proposals(got.get_instances_dual_set(shifted, verts, scores),
                    want.get_instances_dual_set(shifted, verts, scores))


def _eval_cases():
    """The fixtures of tests/test_insseg.py: (class ids, gt semantic, gt
    instance, predictions)."""
    def m(n, lo, hi):
        out = np.zeros(n, bool)
        out[lo:hi] = True
        return out

    perfect = ([1, 2], np.r_[np.full(250, 1), np.full(250, 2)], np.repeat(np.arange(4), 125),
               {i: {"conf": 0.9, "label_id": 1 if i < 2 else 2,
                    "pred_mask": m(500, i * 125, (i + 1) * 125)} for i in range(4)})
    bad = ([1], np.full(400, 1), np.repeat([0, 1], 200),
           {0: {"conf": 0.9, "label_id": 1, "pred_mask": m(400, 100, 300)}})
    dup = ([1], np.full(300, 1), np.repeat([0, 1], 150),
           {0: {"conf": 0.9, "label_id": 1, "pred_mask": m(300, 0, 150)},
            1: {"conf": 0.8, "label_id": 1, "pred_mask": m(300, 0, 150)},
            2: {"conf": 0.7, "label_id": 1, "pred_mask": m(300, 150, 300)}})
    void = ([1], np.r_[np.full(100, 1), np.zeros(100, int)], np.r_[np.zeros(100, int), np.full(100, -1)],
            {0: {"conf": 0.9, "label_id": 1, "pred_mask": m(200, 0, 100)},
             1: {"conf": 0.95, "label_id": 1, "pred_mask": m(200, 100, 160)},
             2: {"conf": 0.97, "label_id": 1, "pred_mask": m(200, 0, 30)}})
    small = ([1], np.full(200, 1), np.r_[np.zeros(195, int), np.ones(5, int)],
             {0: {"conf": 0.9, "label_id": 1, "pred_mask": m(200, 0, 195)},
              1: {"conf": 0.95, "label_id": 1, "pred_mask": m(200, 180, 200)}})
    hard_fn = ([1], np.full(300, 1), np.repeat([0, 1], 150),
               {0: {"conf": 0.9, "label_id": 1, "pred_mask": m(300, 0, 150)}})
    return {"perfect": perfect, "bad_masks": bad, "duplicate": dup, "void": void,
            "small_gt": small, "hard_false_negative": hard_fn}


def _nan_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _nan_equal(a[k], b[k])
    else:
        assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)


@pytest.mark.parametrize("case", sorted(_eval_cases()))
def test_instance_evaluator_equals_jax(case):
    ids, sem, inst, preds = _eval_cases()[case]
    out = []
    for cls in (InstanceEvaluator, j_evaluation.InstanceEvaluator):
        ev = cls(ids, [f"c{i}" for i in ids])
        ev.add_gt("s0", sem, inst)
        ev.add_prediction("s0", preds)
        ev.add_gt("s1", sem, inst)  # a second scene with no predictions
        out.append(ev.evaluate())
    _nan_equal(out[0], out[1])


def test_export_benchmark_equals_jax(tmp_path):
    _, _, _, preds = _eval_cases()["duplicate"]
    for name, cls in (("port", InstanceEvaluator), ("jax", j_evaluation.InstanceEvaluator)):
        cls([1]).export_benchmark(str(tmp_path / name), "scene0", preds)
    files = sorted(os.path.relpath(p, tmp_path / "jax")
                   for p in glob.glob(str(tmp_path / "jax" / "**" / "*.txt"), recursive=True))
    assert len(files) == 4
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


# ---- dataset ------------------------------------------------------------


def _assert_items_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if k == "original":
            for kk in w:
                np.testing.assert_array_equal(g[kk], w[kk])
        elif k == "transform":
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        elif k == "scene_name":
            assert g == w
        else:
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("phase,augment", [("train", True), ("val", False)])
def test_synthetic_instance_item_equals_jax(phase, augment):
    cfg, jcfg = Config(**_kw()), JaxConfig(**_kw())
    cls, jcls = p_dataset.SyntheticInstanceDataset, j_dataset.SyntheticInstanceDataset
    pre, inp = build_input_transforms(cfg, cls, augment)
    jpre, jinp = jax_transforms(jcfg, jcls, augment)
    ds = cls(cfg, phase=phase, augment_data=augment, prevoxel_transform=pre, input_transform=inp)
    jds = jcls(jcfg, phase=phase, augment_data=augment, prevoxel_transform=jpre,
               input_transform=jinp)
    assert len(ds) == len(jds) == 4 and ds.num_train_labels == jds.num_train_labels
    for i in range(2):
        got = ds.get_item(i, np.random.default_rng((5, i)))
        want = jds.get_item(i, np.random.default_rng((5, i)))
        _assert_items_equal(got, want)
    assert (got["centers"][got["instances"] < 0] == -1).all()


# ---- trainer ------------------------------------------------------------


def test_train_step_losses_match_jax(pair):
    """One port train step and the JAX trainer's losses (its train-mode
    ``_losses``, the values its step reports) on the same batch from the
    same weights."""
    tr_j, tr_p = pair
    jbatch = tr_j._make_batch([0, 1])
    # the same scenes and augmentation draws as the JAX trainer's batch
    batch = tr_p._host_batch([tr_p.dataset.get_item(i, np.random.default_rng((0, i)))
                              for i in (0, 1)])
    np.testing.assert_array_equal(batch.feats, np.asarray(jbatch.feats))
    for k in ("centers", "instance_valid", "instance_ids", "xyz"):
        np.testing.assert_array_equal(batch.extras[k], np.asarray(jbatch.extras[k]), err_msg=k)
    variables = {"params": tr_j.state.params, "batch_stats": tr_j.state.batch_stats}
    fn = jax.jit(lambda v, b: tr_j._losses(v, b, True)[:2])
    want_total, want = fn.lower(variables, jbatch).compile(
        compiler_options=FAST_COMPILE)(variables, jbatch)
    step0 = tr_p.state.step
    with gather_paths():
        tr_p.state, got = tr_p.p_train_step(tr_p.state, batch)
    assert tr_p.state.step == step0 + 1
    print({k: (float(got[k]), float(v)) for k, v in want.items()})  # shown by -rP
    for k in ("semantic_loss", "offset_norm_loss", "offset_dir_loss"):
        assert _rel(got[k], want[k]) <= STEP_LOSS_RTOL, k
    assert _rel(got["loss"], want_total) <= STEP_LOSS_RTOL


def test_validate_matches_jax(pair, tmp_path):
    """``validate(max_scenes=1)`` with the same weights (the train step
    above has not touched the JAX trainer's): val_miou equal; the instance
    APs reported beside JAX's."""
    tr_j, tr_p = pair
    tr_p2 = _port(tmp_path)
    tr_p2.model.load_state_dict(state_dict_from_jax(tr_j.state.params,
                                                    tr_j.state.batch_stats))
    want = tr_j.validate(max_scenes=1)
    with gather_paths():
        got = tr_p2.validate(max_scenes=1)
    tr_p2.close()
    print(f"port {got}\njax  {want}")  # shown by -rP
    assert got.keys() == want.keys() == {"val_miou", "val_map", "val_map05", "val_map25"}
    assert abs(got["val_miou"] - want["val_miou"]) <= MIOU_ATOL
    assert 0.0 < got["val_miou"] <= 1.0
    for k in ("val_map", "val_map05", "val_map25"):
        assert np.isnan(got[k]) or 0.0 <= got[k] <= 1.0


def test_fit_writes_both_best_checkpoints_and_resumes(tmp_path):
    tr = _port(tmp_path, name="a", batch_size=1)
    tr.fit(max_steps=2, log_every=1, val_every=2, max_val_scenes=1)
    tr.close()
    log = tmp_path / "a"
    for monitor in ("val_miou", "val_map05"):
        (path,) = glob.glob(str(log / f"best_{monitor}=*_step=2.ckpt"))
        blob = torch.load(path, weights_only=True)
        assert int(blob["step"]) == 2
    with open(log / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["phase"] for r in recs] == ["train", "train", "val"]
    assert all(np.isfinite(r["loss"]) for r in recs[:2])
    assert 0.0 <= recs[2]["val_miou"] <= 1.0

    tr2 = _port(tmp_path, name="b", batch_size=1, resume=str(log))
    tr2.fit(max_steps=3, log_every=10)
    tr2.close()
    assert tr2.state.step == 3 and tr2.state.optimizer.updates == 3
    assert glob.glob(str(tmp_path / "b" / "last_step=3.ckpt"))


def test_cli_routes_instance_datasets_to_insseg(tmp_path):
    metrics = main(CLI_ARGS + ["--log_dir", str(tmp_path / "cli")], device="cpu")
    assert set(metrics) == {"val_miou", "val_map", "val_map05", "val_map25"}
    assert 0.0 <= metrics["val_miou"] <= 1.0
    assert glob.glob(str(tmp_path / "cli" / "last_step=2.ckpt"))


def test_insseg_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(CLI_ARGS + ["--log_dir", str(tmp_path / "cli")])


@pytest.mark.parametrize("kw,exc,match", [
    (dict(num_devices=2), RuntimeError, "torchrun"),
], ids=["kw0-item 5"])
def test_unported_insseg_options_raise(tmp_path, kw, exc, match):
    """More than one device without a process group (one process per
    rank) raises naming torchrun."""
    with pytest.raises(exc, match=match):
        _port(tmp_path, **kw)


# one bf16 train step's losses against JAX's bf16 losses: the same casts,
# but a CPU bf16 dot may round a product's last bit differently (2^-8),
# spread through the layers (tests/test_torch_precision.py)
BF16_LOSS_RTOL = 3e-2


def test_bf16_train_step_losses_match_jax(tmp_path):
    """``compute_dtype="bfloat16"``: both trainers build the model in bf16
    (its outputs bf16, its parameters f32); one port train step's losses
    against the JAX trainer's train-mode losses on the same batch from the
    same weights."""
    tr_j = _jax_trainer(tmp_path, compute_dtype="bfloat16")
    tr_p = _port(tmp_path, compute_dtype="bfloat16")
    tr_p.model.load_state_dict(state_dict_from_jax(tr_j.state.params,
                                                   tr_j.state.batch_stats))
    assert tr_p.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tr_p.model.parameters())
    jbatch = tr_j._make_batch([0, 1])
    batch = tr_p._host_batch([tr_p.dataset.get_item(i, np.random.default_rng((0, i)))
                              for i in (0, 1)])
    variables = {"params": tr_j.state.params, "batch_stats": tr_j.state.batch_stats}
    fn = jax.jit(lambda v, b: tr_j._losses(v, b, True)[:2])
    want_total, want = fn.lower(variables, jbatch).compile(
        compiler_options=FAST_COMPILE)(variables, jbatch)
    with gather_paths():
        tr_p.state, got = tr_p.p_train_step(tr_p.state, batch)
    print({k: (float(got[k]), float(v)) for k, v in want.items()})  # shown by -rP
    for k in ("semantic_loss", "offset_norm_loss", "offset_dir_loss"):
        assert got[k].dtype == torch.float32
        assert _rel(got[k], want[k]) <= BF16_LOSS_RTOL, k
    assert _rel(got["loss"], want_total) <= BF16_LOSS_RTOL
    assert all(torch.isfinite(p).all() for p in tr_p.model.parameters())


def test_semseg_trainer_refuses_instance_datasets(tmp_path):
    with pytest.raises(ValueError, match="InssegTrainer"):
        Trainer(Config(**_kw(log_dir=str(tmp_path / "t"))), device="cpu")
