"""The port's data modules against the JAX package's, on the same inputs.

Config, constants, PLY IO, transforms, voxelizer, datasets and the numpy
mIoU metrics of ``languagegroundedsemseg_torch`` are copies of numpy/scipy
code in ``languagegroundedsemseg_tpu``; each is held array-equal to its
original under the same ``np.random.default_rng`` seeds. The last test
imports every module of the port in a fresh interpreter and checks that
none of them pulls in JAX or the JAX package.
"""

import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import languagegroundedsemseg_torch
from languagegroundedsemseg_tpu import config as jconfig
from languagegroundedsemseg_tpu import constants as jconst
from languagegroundedsemseg_tpu.data import dataset as jdataset
from languagegroundedsemseg_tpu.data import loader as jloader
from languagegroundedsemseg_tpu.data import transforms as jt
from languagegroundedsemseg_tpu.data import voxelizer as jvox
from languagegroundedsemseg_tpu.eval import miou as jmiou
from languagegroundedsemseg_tpu.utils import host_alloc as jhost_alloc
from languagegroundedsemseg_tpu.utils import ply as jply
from languagegroundedsemseg_tpu.utils import timer as jtimer
from languagegroundedsemseg_torch import config as pconfig
from languagegroundedsemseg_torch import constants as pconst
from languagegroundedsemseg_torch.data import dataset as pdataset
from languagegroundedsemseg_torch.data import loader as ploader
from languagegroundedsemseg_torch.data import transforms as pt
from languagegroundedsemseg_torch.data import voxelizer as pvox
from languagegroundedsemseg_torch.eval import miou as pmiou
from languagegroundedsemseg_torch.utils import host_alloc as phost_alloc
from languagegroundedsemseg_torch.utils import ply as pply
from languagegroundedsemseg_torch.utils import timer as ptimer


def _assert_same(got, want, path="out"):
    """Array-equal, recursively through tuples, lists and dicts."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


# ---- config ----------------------------------------------------------------


def test_config_fields_and_defaults_equal():
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(jconfig.Config)]
    pf = [(f.name, str(f.type)) for f in dataclasses.fields(pconfig.Config)]
    assert pf == jf
    assert dataclasses.asdict(pconfig.Config()) == dataclasses.asdict(
        jconfig.Config())


@pytest.mark.parametrize("argv", [
    [],
    ["--lr", "0.1", "--batch_size", "8", "--dilations", "1,2,1,1",
     "--use_embedding_loss", "None", "--train_augmentation", "false"],
    ["optimizer.lr=0.25", "data.num_workers=3", "--scheduler", "PolyLR",
     "--level_capacity_ratios", "1,0.5,0.25,0.125,0.0625"],
])
def test_get_config_equal(argv):
    assert dataclasses.asdict(pconfig.get_config(argv)) == dataclasses.asdict(
        jconfig.get_config(argv))


def test_yaml_overlay_and_dot_overrides_equal(tmp_path):
    path = tmp_path / "overlay.yaml"
    path.write_text("net:\n  model: Res16UNet34C\noptimizer:\n  lr: 0.02\n"
                    "  weight_decay: 0.001\ndata:\n  batch_size: 6\n"
                    "  dilations: [1, 1, 2, 2]\n  unknown_key: 3\n")
    assert pconfig.load_yaml_overlay(str(path)) == jconfig.load_yaml_overlay(
        str(path))
    with pytest.raises(KeyError):
        pconfig.load_yaml_overlay(str(path), strict=True)
    items = ["optimizer.lr=0.3", "seed=5", "nope.missing=1"]
    assert pconfig.parse_dot_overrides(items, strict=False) == \
        jconfig.parse_dot_overrides(items, strict=False)
    with pytest.raises(KeyError):
        pconfig.parse_dot_overrides(items)
    with pytest.raises(ValueError):
        pconfig.Config(point_lim=5)


# ---- constants -------------------------------------------------------------


@pytest.mark.parametrize("fn,args", [
    ("valid_class_ids", (20,)), ("valid_class_ids", (200,)),
    ("valid_class_ids", (549,)), ("class_labels", (20,)),
    ("class_labels", (200,)), ("class_labels", (549,)),
    ("color_map", (20,)), ("color_map", (200,)), ("color_map", (549,)),
    ("head_common_tail_names", ()), ("frequency_organized_cats", (200,)),
    ("train_scenes", ()), ("val_scenes", ()), ("label_map", (20,)),
    ("label_map", (200, 255)), ("label_map", (549, -1)),
])
def test_constants_equal(fn, args):
    _assert_same(getattr(pconst, fn)(*args), getattr(jconst, fn)(*args))


# ---- utils -----------------------------------------------------------------


@pytest.mark.parametrize("binary", [True, False])
def test_ply_roundtrip_equal(tmp_path, binary):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(257, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(257, 3)).astype(np.float32)
    labels = rng.integers(0, 40, size=257).astype(np.int32)
    ours, theirs = tmp_path / "port.ply", tmp_path / "jax.ply"
    pply.write_ply(str(ours), xyz, rgb, labels, binary=binary)
    jply.write_ply(str(theirs), xyz, rgb, labels, binary=binary)
    assert ours.read_bytes() == theirs.read_bytes()
    got = pply.read_ply(str(ours))
    _assert_same(got, jply.read_ply(str(ours)))
    np.testing.assert_array_equal(got["x"], xyz[:, 0])
    np.testing.assert_array_equal(got["label"], labels)
    _assert_same(pply.read_ply_cloud(str(ours)), jply.read_ply_cloud(str(ours)))


def test_timer_meter_and_host_alloc():
    meters = []
    for mod in (ptimer, jtimer):
        m = mod.AverageMeter()
        for v, c in ((1.0, 2), (4.0, 1), (2.5, 3)):
            m.update(v, c)
        meters.append(m.compute())
    assert meters[0] == meters[1]
    assert phost_alloc.tune() == jhost_alloc.tune()


# ---- transforms ------------------------------------------------------------


def _cloud(seed, n=1500):
    rng = np.random.default_rng(seed)
    coords = rng.random((n, 3)) * 3
    feats = (rng.random((n, 3)) * 255).astype(np.float32)
    labels = rng.integers(0, 20, n).astype(np.int32)
    return coords, feats, labels


_TRANSFORMS = {
    "ChromaticTranslation": lambda m: m.ChromaticTranslation(0.1),
    "ChromaticAutoContrast": lambda m: m.ChromaticAutoContrast(),
    "ChromaticAutoContrastFixed": lambda m: m.ChromaticAutoContrast(False, 0.3),
    "ChromaticJitter": lambda m: m.ChromaticJitter(0.05),
    "ChromaticScale": lambda m: m.ChromaticScale(1.3),
    "HueSaturationTranslation": lambda m: m.HueSaturationTranslation(0.5, 0.2),
    "RandomDropout": lambda m: m.RandomDropout(0.5),
    "RandomHorizontalFlip": lambda m: m.RandomHorizontalFlip("z", False),
    "RandomHorizontalFlipTemporal": lambda m: m.RandomHorizontalFlip("y", True),
    "ElasticDistortion": lambda m: m.ElasticDistortion(((0.2, 0.4), (0.8, 1.6))),
    "ElasticDistortionOff": lambda m: m.ElasticDistortion(None),
    "Compose": lambda m: m.Compose([
        m.RandomHorizontalFlip("z", False), m.ChromaticAutoContrast(),
        m.ChromaticTranslation(0.1), m.ChromaticJitter(0.05)]),
}


@pytest.mark.parametrize("name", sorted(_TRANSFORMS))
def test_transform_equal(name):
    """Eight seeds each, so the transforms' random gates both fire and
    pass."""
    for seed in range(8):
        coords, feats, labels = _cloud(seed)
        if name == "RandomHorizontalFlipTemporal":
            coords = np.hstack([coords, np.arange(len(coords))[:, None] % 3])
        got = _TRANSFORMS[name](pt)(np.random.default_rng(seed), coords,
                                    feats, labels)
        want = _TRANSFORMS[name](jt)(np.random.default_rng(seed), coords,
                                     feats, labels)
        _assert_same(got, want)


def test_hsv_roundtrip_equal():
    rgb = np.random.default_rng(0).random((500, 3)) * 255
    rgb[:10] = 128.0  # grey: zero saturation
    _assert_same(pt.rgb_to_hsv(rgb), jt.rgb_to_hsv(rgb))
    hsv = jt.rgb_to_hsv(rgb)
    _assert_same(pt.hsv_to_rgb(hsv), jt.hsv_to_rgb(hsv))


@pytest.mark.parametrize("method", ["shift_color", "shift_scale"])
def test_instance_augmentation_equal(method):
    for seed in range(8):
        coords, feats, labels = _cloud(seed, 300)
        labels2 = np.stack([labels, np.zeros_like(labels)], axis=1)
        outs = []
        for mod in (pt, jt):
            aug = mod.InstanceAugmentation()
            rng = np.random.default_rng(seed)
            if method == "shift_color":
                outs.append(aug.shift_color(rng, coords, feats, labels2))
            else:
                outs.append(aug.shift_scale(rng, coords, feats, labels2,
                                            np.array([4.0, 4.0, 2.5])))
        _assert_same(*outs)


# ---- voxelizer -------------------------------------------------------------


def _voxelizers(**kw):
    return pvox.Voxelizer(**kw), jvox.Voxelizer(**kw)


_VOX_SETTINGS = {
    "plain": dict(voxel_size=0.05),
    "augmented": dict(
        voxel_size=0.02, use_augmentation=True,
        scale_augmentation_bound=(0.9, 1.1),
        rotation_augmentation_bound=((-np.pi / 64, np.pi / 64),
                                     (-np.pi / 64, np.pi / 64),
                                     (-np.pi, np.pi)),
        translation_augmentation_ratio_bound=((-0.2, 0.2), (-0.2, 0.2),
                                              (0, 0))),
    "clipped": dict(
        voxel_size=0.05, clip_bound=1.0, use_augmentation=True,
        rotation_augmentation_bound=((-np.pi, np.pi), None, None),
        translation_augmentation_ratio_bound=((-0.2, 0.2), (-0.05, 0.05),
                                              (-0.2, 0.2))),
    "box_clipped": dict(
        voxel_size=0.05, clip_bound=((-1.0, 1.0), (-0.8, 0.8), (-2, 2))),
}


@pytest.mark.parametrize("setting", sorted(_VOX_SETTINGS))
def test_voxelize_equal(setting):
    ours, theirs = _voxelizers(**_VOX_SETTINGS[setting])
    for seed in range(3):
        coords, feats, labels = _cloud(seed, 4000)
        for augment in (True, False):
            got = ours.voxelize(np.random.default_rng(seed), coords, feats,
                                labels, augment=augment)
            want = theirs.voxelize(np.random.default_rng(seed), coords,
                                   feats, labels, augment=augment)
            _assert_same(got, want)
    assert pvox.rotation_matrix(np.zeros(3), 1.0).tolist() == np.eye(3).tolist()


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_voxelize_pair_equal(dropout):
    ours, theirs = _voxelizers(**_VOX_SETTINGS["augmented"])
    coords, feats, labels = _cloud(5, 3000)
    labels = labels % 3
    got = ours.voxelize_pair(np.random.default_rng(5), coords, feats, labels,
                             dropout_ratio=dropout)
    want = theirs.voxelize_pair(np.random.default_rng(5), coords, feats,
                                labels, dropout_ratio=dropout)
    _assert_same(got, want)


# ---- datasets --------------------------------------------------------------


def _cfg(mod, **kw):
    kw.setdefault("ignore_label", 255)
    return mod.Config(**kw)


def _dataset(loader_mod, config_mod, dataset_mod, name, augment=True, **kw):
    cls = loader_mod.load_dataset(name)
    cfg = _cfg(config_mod, **kw)
    prevoxel, input_t = dataset_mod.build_input_transforms(cfg, cls, augment)
    return cls(cfg, phase="train", augment_data=augment,
               prevoxel_transform=prevoxel, input_transform=input_t)


def test_registry_lists_the_same_datasets():
    jloader.load_dataset("SyntheticTiny20Dataset")
    ploader.load_dataset("SyntheticTiny20Dataset")
    assert sorted(ploader._DATASETS) == sorted(jloader._DATASETS)
    with pytest.raises(KeyError):
        ploader.load_dataset("NoSuchDataset")


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("overrides", [
    {}, {"data_aug_color_scaling_factor": 1.5,
         "data_aug_patch_dropout_ratio": 0.0}])
def test_synthetic_get_item_equal(augment, overrides):
    ours = _dataset(ploader, pconfig, pdataset, "SyntheticTiny20Dataset",
                    augment, **overrides)
    theirs = _dataset(jloader, jconfig, jdataset, "SyntheticTiny20Dataset",
                      augment, **overrides)
    assert len(ours) == len(theirs) == 4
    for idx in range(len(ours)):
        got = ours.get_item(idx, np.random.default_rng((3, idx)))
        want = theirs.get_item(idx, np.random.default_rng((3, idx)))
        _assert_same(got, want)
    _assert_same(ours.frequency_organized_cats, theirs.frequency_organized_cats)
    _assert_same(ours.loaded_text_features, theirs.loaded_text_features)


@pytest.mark.parametrize("name", [
    "ScannetVoxelizationDataset", "ScannetVoxelization2cmDataset",
    "Scannet200VoxelizationDataset", "Scannet200Voxelization2cmDataset",
    "Scannet200TextualDataset", "Scannet200Textual2cmDataset",
    "StanfordDataset", "StanfordArea5Dataset", "StanfordArea53cmDataset",
    "Synthetic200Voxelization2cmDataset"])
def test_dataset_attributes_equal(name):
    ours = _dataset(ploader, pconfig, pdataset, name)
    theirs = _dataset(jloader, jconfig, jdataset, name)
    for attr in ("label_map_array", "inverse_label_map", "num_train_labels",
                 "category_weights", "frequency_organized_cats",
                 "VOXEL_SIZE", "NUM_IN_CHANNEL", "IGNORE_LABELS",
                 "head_ids", "common_ids", "tail_ids", "id2cat_name",
                 "instance_sampling_weights", "loaded_text_features",
                 "VALID_CLASS_IDS", "CLASS_LABELS"):
        if hasattr(theirs, attr):
            _assert_same(getattr(ours, attr), getattr(theirs, attr), attr)
    labels = np.arange(-2, 600, dtype=np.int32)
    _assert_same(ours.map_labels(labels), theirs.map_labels(labels))


def _write_scenes(root, n=2, points=3000, mod=jply):
    from languagegroundedsemseg_tpu.data.synthetic import synthetic_scene

    raw_ids = jconst.valid_class_ids(200)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        rng = np.random.default_rng(50 + i)
        xyz, rgb, labels = synthetic_scene(rng, num_points=points,
                                           num_classes=len(raw_ids))
        mod.write_ply(os.path.join(root, f"scene{i:04d}_00.ply"), xyz, rgb,
                      raw_ids[labels])


@pytest.mark.parametrize("name,augment", [
    ("Scannet200Voxelization2cmDataset", True),
    ("ScannetVoxelizationDataset", False),
    ("StanfordArea5Dataset", True)])
def test_ply_dataset_get_item_equal(tmp_path, name, augment):
    """Datasets read from PLY files on disk (the glob fallback of
    ``_resolve_data_paths``), through ``load_cloud``, the augmentations and
    the raw-to-train label map."""
    _write_scenes(str(tmp_path))
    kw = dict(data_dir=str(tmp_path), cache_data=True)
    ours = _dataset(ploader, pconfig, pdataset, name, augment, **kw)
    theirs = _dataset(jloader, jconfig, jdataset, name, augment, **kw)
    assert len(ours) == len(theirs) == 2
    for idx in range(2):
        for _ in range(2):  # the second read comes from the cache
            got = ours.get_item(idx, np.random.default_rng(idx))
            want = theirs.get_item(idx, np.random.default_rng(idx))
            _assert_same(got, want)


def test_scannet_augment_instances_equal():
    name = "Scannet200Voxelization2cmDataset"
    kw = dict(instance_augmentation_color_aug_prob=0.4,
              instance_augmentation_scale_aug_prob=0.6)
    ours = _dataset(ploader, pconfig, pdataset, name, **kw)
    theirs = _dataset(jloader, jconfig, jdataset, name, **kw)
    rng = np.random.default_rng(0)
    n = 2000
    tail_raw = ours.VALID_CLASS_IDS[ours.frequency_organized_cats[
        ours.label_map_array[ours.VALID_CLASS_IDS], 2]]
    coords = rng.random((n, 3)) * 4
    feats = (rng.random((n, 3)) * 255).astype(np.float32)
    cats = np.where(rng.random(n) < 0.5, rng.choice(tail_raw[:6], n), 1)
    labels = np.stack([cats, np.zeros(n, np.int64)], axis=1)
    inst = rng.integers(0, 3, n).astype(np.int32)
    for seed in range(4):
        for ids in (inst, None):
            got = ours.augment_instances(np.random.default_rng(seed), coords,
                                         feats, labels, ids)
            want = theirs.augment_instances(np.random.default_rng(seed),
                                            coords, feats, labels, ids)
            _assert_same(got, want)


def test_scannet_test_pointcloud_equal(tmp_path):
    """Full-cloud evaluation: per-voxel predictions on disk, nearest-voxel
    lookup for every original point, mIoU through the numpy histograms."""
    _write_scenes(str(tmp_path / "data"))
    pred_root = tmp_path / "pred"
    pred_root.mkdir()
    rng = np.random.default_rng(3)
    raw_ids = jconst.valid_class_ids(200)
    for i in range(2):
        vox = rng.integers(0, 60, size=(400, 3)).astype(np.float64)
        pred = np.hstack([vox, raw_ids[rng.integers(0, 200, 400)][:, None]])
        np.save(pred_root / f"scene_pred_{i:04d}.npy", pred)
    results = []
    for lmod, cmod, dmod in ((ploader, pconfig, pdataset),
                             (jloader, jconfig, jdataset)):
        ds = _dataset(lmod, cmod, dmod, "Scannet200Voxelization2cmDataset",
                      False, data_dir=str(tmp_path / "data"))
        miou, ious = ds.test_pointcloud(str(pred_root), 200)
        txt = (pred_root / "fulleval" / "scene0000_00.txt").read_text()
        results.append((miou, ious, txt))
    assert results[0][0] == results[1][0] or (
        np.isnan(results[0][0]) and np.isnan(results[1][0]))
    np.testing.assert_array_equal(results[0][1], results[1][1])
    assert results[0][2] == results[1][2]


# ---- eval metrics ----------------------------------------------------------


def test_miou_numpy_half_equal():
    rng = np.random.default_rng(0)
    n = 20
    pred = rng.integers(0, n, 5000)
    label = rng.integers(0, n, 5000)
    label[rng.random(5000) < 0.1] = 255
    hist = pmiou.fast_hist(pred, label, n)
    _assert_same(hist, jmiou.fast_hist(pred, label, n))
    _assert_same(pmiou.per_class_iou(hist), jmiou.per_class_iou(hist))
    _assert_same(pmiou.per_class_accuracy(hist), jmiou.per_class_accuracy(hist))

    split = np.zeros((n, 3), bool)
    split[np.arange(n), np.arange(n) % 3] = True
    names = [f"c{i}" for i in range(n)]
    evs = [mod.IoUEvaluator(n, split, names) for mod in (pmiou, jmiou)]
    for ev in evs:
        ev.update(pred[:2500], label[:2500])
        ev.update_hist(jmiou.fast_hist(pred[2500:], label[2500:], n))
    _assert_same(evs[0].compute(), evs[1].compute())
    assert evs[0].summary_table() == evs[1].summary_table()
    evs[0].reset()
    assert evs[0].hist.sum() == 0

    probs = rng.random((3000, n))
    probs /= probs.sum(1, keepdims=True)
    labels = rng.integers(0, n, 3000)
    _assert_same(pmiou.average_precision_binned(probs, labels, n),
                 jmiou.average_precision_binned(probs, labels, n))
    tp = rng.integers(0, 50, size=(n, 64))
    fp = rng.integers(0, 50, size=(n, 64))
    tp[3] = 0
    _assert_same(pmiou.ap_from_histograms(tp, fp),
                 jmiou.ap_from_histograms(tp, fp))


# ---- the port imports no JAX ----------------------------------------------


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    no jax, flax, optax or JAX-package module in ``sys.modules``."""
    pkg = languagegroundedsemseg_torch
    names = [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    assert "languagegroundedsemseg_torch.data.loader" in names
    assert "languagegroundedsemseg_torch.eval.miou" in names
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'optax', 'languagegroundedsemseg_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
