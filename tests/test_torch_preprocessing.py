"""The port's preprocessing scripts (``languagegroundedsemseg_torch/data/
preprocessing``) against the JAX package's, on small synthetic scene
directories written here: the same ``.ply`` / ``.pth`` / split outputs,
byte for byte or array for array, and a ``.pth`` scene written by one
package loads in the other's instance dataset with equal items.

``data_efficient.sample_points_per_scene`` seeds each scene with
``abs(hash(name))``, which depends on ``PYTHONHASHSEED``: the two packages
are compared inside one process.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.config import Config as JaxConfig
from languagegroundedsemseg_tpu.data.preprocessing import data_efficient as j_de
from languagegroundedsemseg_tpu.data.preprocessing import scannet as j_scannet
from languagegroundedsemseg_tpu.data.preprocessing import stanford as j_stanford
from languagegroundedsemseg_tpu.insseg import dataset as j_dataset
from languagegroundedsemseg_tpu.utils.ply import write_ply
from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.data.preprocessing import data_efficient as p_de
from languagegroundedsemseg_torch.data.preprocessing import scannet as p_scannet
from languagegroundedsemseg_torch.data.preprocessing import stanford as p_stanford
from languagegroundedsemseg_torch.insseg import dataset as p_dataset

LABELS = {"chair": 5, "table": 7, "wall": 1, "floor": 2}


def _scene_dir(root, name, seed, n=600):
    """A ScanNet-layout scene: mesh vertices, over-segmentation, aggregated
    instances and an axis alignment."""
    rng = np.random.default_rng(seed)
    d = root / name
    d.mkdir(parents=True)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.float32)
    write_ply(str(d / f"{name}_vh_clean_2.ply"), xyz, rgb)
    with open(d / f"{name}_vh_clean_2.0.010000.segs.json", "w") as f:
        json.dump({"segIndices": [i // 20 for i in range(n)]}, f)
    groups = [{"id": g, "label": lab, "segments": [2 * g, 2 * g + 1]}
              for g, lab in enumerate(["chair", "table", "wall", "chair", "floor"])]
    with open(d / f"{name}.aggregation.json", "w") as f:
        json.dump({"segGroups": groups}, f)
    rot = np.eye(4)
    rot[:3, :3] = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    rot[:3, 3] = [1.0, 2.0, 0.5]
    with open(d / f"{name}.txt", "w") as f:
        f.write("axisAlignment = " + " ".join(f"{v:g}" for v in rot.ravel()) + "\n")
    return d


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("scans")
    return [_scene_dir(root, f"scene000{i}_00", i) for i in range(2)]


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_scene_helpers_equal_jax(scans):
    scene = str(scans[0])
    meta = os.path.join(scene, "scene0000_00.txt")
    np.testing.assert_array_equal(p_scannet.read_axis_align_matrix(meta),
                                  j_scannet.read_axis_align_matrix(meta))
    seg = np.repeat(np.arange(10), 3)
    group = {"segments": [1, 4]}
    np.testing.assert_array_equal(p_scannet.point_indices_from_group(seg, group),
                                  j_scannet.point_indices_from_group(seg, group))
    for a, b in zip(p_scannet.load_scene(scene, LABELS.get),
                    j_scannet.load_scene(scene, LABELS.get)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ratio", [1.0, 0.3])
def test_process_scene_semseg_equals_jax(scans, tmp_path, ratio):
    """Labeled .ply files (with ratio < 1 the limited-annotation mask, FPS
    over each instance) and the exported tail-instance library."""
    for name, mod in (("port", p_scannet), ("jax", j_scannet)):
        for s in scans:
            mod.process_scene_semseg(
                str(s), str(tmp_path / name / "out"), LABELS.get,
                ratio_of_annotated=ratio,
                export_instances_dir=str(tmp_path / name / "lib"), tail_raw_ids={5})
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    # two scenes; the library takes an instance whose majority label is a
    # tail id, which the limited mask's zeroed labels outvote
    assert got.keys() == want.keys() and len(want) == (2 + 4 if ratio == 1.0 else 2)
    for k in want:
        assert got[k] == want[k], k


def test_limited_annotation_mask_equals_jax():
    rng = np.random.default_rng(3)
    xyz = rng.random((500, 3)).astype(np.float32)
    inst = rng.integers(-1, 6, 500)
    got = p_scannet.limited_annotation_mask(xyz, inst, 0.2, None)
    want = j_scannet.limited_annotation_mask(xyz, inst, 0.2, None)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < (inst >= 0).sum()


def _write_pth(mod, scans, out):
    for s in scans:
        mod.process_scene_insseg(str(s), str(out), LABELS.get)


def test_process_scene_insseg_equals_jax(scans, tmp_path):
    _write_pth(p_scannet, scans, tmp_path / "port")
    _write_pth(j_scannet, scans, tmp_path / "jax")
    for s in scans:
        got = torch.load(str(tmp_path / "port" / f"{s.name}.pth"), weights_only=False)
        want = torch.load(str(tmp_path / "jax" / f"{s.name}.pth"), weights_only=False)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pth_loads_in_the_other_package(scans, tmp_path, writer):
    """Scenes one package's preprocessing wrote, read by both packages'
    ScanNet instance datasets (val phase, no augmentation): equal items,
    also with data-efficient sampled indices."""
    _write_pth(j_scannet if writer == "jax" else p_scannet, scans, tmp_path / "val")
    kw = dict(scannet_path=str(tmp_path), ignore_label=255)
    ds = p_dataset.ScannetInstance2cmDataset(Config(**kw), phase="val")
    jds = j_dataset.ScannetInstance2cmDataset(JaxConfig(**kw), phase="val")
    assert len(ds) == len(jds) == 2
    for sampled in (False, True):
        if sampled:
            for d in (ds, jds):
                d.sampled_inds = {scans[1].name: np.arange(0, 600, 9)}
        for i in range(2):
            got = ds.get_item(i, np.random.default_rng(i))
            want = jds.get_item(i, np.random.default_rng(i))
            assert got.keys() == want.keys()
            for k in ("coords", "feats", "labels", "instances", "centers"):
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            for k in want["original"]:
                np.testing.assert_array_equal(got["original"][k], want["original"][k])
            assert got["scene_name"] == want["scene_name"]
    # the sampled scene keeps labels on its sampled points only
    assert (got["original"]["instance"][np.setdiff1d(np.arange(600), np.arange(0, 600, 9))]
            == -1).all()


def _s3dis(root):
    rng = np.random.default_rng(4)
    for area, rooms in (("Area_1", ["office_1", "hallway_2"]), ("Area_5", ["office_3"])):
        for room in rooms:
            ann = root / area / room / "Annotations"
            ann.mkdir(parents=True)
            for k, cls in enumerate(["chair", "table", "stairs", "unknownthing"]):
                pts = np.hstack([rng.random((30, 3)) * 4, rng.integers(0, 256, (30, 3))])
                np.savetxt(ann / f"{cls}_{k}.txt", pts, fmt="%.4f")
            # a malformed line the slow path drops
            with open(ann / "clutter_9.txt", "w") as f:
                f.write("1 2 3 4 5 6\n1 2 x 4 5 6\n7 8 9 10 11 12\n")


def test_stanford_main_equals_jax(tmp_path):
    _s3dis(tmp_path / "raw")
    p_stanford.main(["--input", str(tmp_path / "raw"), "--output", str(tmp_path / "port")])
    j_stanford.main(["--input", str(tmp_path / "raw"), "--output", str(tmp_path / "jax")])
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got.keys() == want.keys() and "area5.txt" in want and len(want) == 3 + 6
    for k in want:
        assert got[k] == want[k], k
    assert p_stanford.CLASS_TO_ID == j_stanford.CLASS_TO_ID


def test_data_efficient_equals_jax(scans, tmp_path):
    _write_pth(j_scannet, scans, tmp_path / "pth")
    paths = sorted(str(p) for p in (tmp_path / "pth").glob("*.pth"))
    for use_fps in (True, False):
        got = p_de.sample_points_per_scene(paths, 50, seed=1, use_fps=use_fps)
        want = j_de.sample_points_per_scene(paths, 50, seed=1, use_fps=use_fps)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert len(np.unique(got[k])) == 50
    assert p_de.sample_scenes(paths, 0.5, 3) == j_de.sample_scenes(paths, 0.5, 3)
    for mode in ("by_points", "by_scenes"):
        for name, mod in (("port", p_de), ("jax", j_de)):
            mod.main(["--input", str(tmp_path / "pth"), "--output",
                      str(tmp_path / f"{name}_{mode}"), "--mode", mode, "--points", "40"])
        got = (tmp_path / f"port_{mode}").read_bytes()
        assert got == (tmp_path / f"jax_{mode}").read_bytes()
        if mode == "by_points":
            assert sorted(pickle.loads(got)) == [s.name for s in scans]
