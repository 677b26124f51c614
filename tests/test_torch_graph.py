"""Host graph build of the PyTorch port against the JAX package's.

The port keeps its own copy of the numpy graph builder and the two C++
builders; on the same scenes every leaf of the batch must be array-equal
(values and dtypes) to the JAX package's, on the production (fused native),
the native-without-fusion and the numpy paths. Also: the port imports no
JAX, and its device move keeps every leaf.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from languagegroundedsemseg_tpu.models.res16unet import (
    res16unet_graph_spec as jax_graph_spec,
)
from languagegroundedsemseg_tpu.sparse import graph_host as jax_gh
from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec
from languagegroundedsemseg_torch.sparse import graph_fused
from languagegroundedsemseg_torch.sparse import graph_host as gh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_tree_equal(jax_obj, port_obj, path="batch"):
    """Walk the port's dataclasses and compare every field with the JAX
    package's counterpart: arrays by value and dtype, statics by value."""
    if dataclasses.is_dataclass(port_obj):
        for f in dataclasses.fields(port_obj):
            assert_tree_equal(getattr(jax_obj, f.name),
                              getattr(port_obj, f.name), f"{path}.{f.name}")
    elif isinstance(port_obj, dict):
        assert set(port_obj) == set(jax_obj), path
        for k in port_obj:
            assert_tree_equal(jax_obj[k], port_obj[k], f"{path}[{k}]")
    elif isinstance(port_obj, tuple) and port_obj and dataclasses.is_dataclass(port_obj[0]):
        assert len(port_obj) == len(jax_obj), path
        for i, (a, b) in enumerate(zip(jax_obj, port_obj)):
            assert_tree_equal(a, b, f"{path}[{i}]")
    elif isinstance(port_obj, np.ndarray):
        a = np.asarray(jax_obj)
        assert a.dtype == port_obj.dtype, (path, a.dtype, port_obj.dtype)
        np.testing.assert_array_equal(port_obj, a, err_msg=path)
    elif port_obj is None:
        assert jax_obj is None, path
    else:
        assert port_obj == (int(jax_obj) if isinstance(port_obj, int)
                            and not isinstance(port_obj, bool) else jax_obj), (
            path, jax_obj, port_obj)


def _scenes(seed, n_scenes=2, points=6000):
    rng = np.random.default_rng(seed)
    return [voxelize_scene(rng, points, raw_color=True)
            for _ in range(n_scenes)]


@pytest.mark.parametrize("path", ["fused", "native", "numpy"])
def test_production_build_matches_jax(path, monkeypatch):
    """The production batch (flex capacities, compact wire format, no
    device coords) on two scenes, through each builder path."""
    if path == "fused":
        assert graph_fused.available()
    if path == "native":
        monkeypatch.setenv("LGS_NO_FUSED_BUILDER", "1")
    kw = dict(ship_coords=False, compact_feats=True)
    scenes = _scenes(0)
    if path == "numpy":
        coords = np.concatenate([
            np.concatenate([np.full((len(vc), 1), b, np.int32), vc], 1)
            for b, (vc, _, _) in enumerate(scenes)])
        coords = coords[np.argsort(gh.pack_keys(coords), kind="stable")]
        caps = gh.default_capacities(16384, 5)
        args = dict(flex=True, validate=False, ship_coords=False)
        got = gh.build_graph(coords, res16unet_graph_spec(), caps, **args)
        want = jax_gh.build_graph(coords, jax_graph_spec(), caps, **args)
        assert_tree_equal(want, got, "graph")
        return
    want = JaxBatchBuilder(spec=jax_graph_spec(), **kw).build(scenes)
    got = BatchBuilder(spec=res16unet_graph_spec(), **kw).build_host(scenes)
    assert_tree_equal(want, got)
    assert got.feats.dtype == np.uint8 and got.labels.dtype == np.uint8
    annotated = [k for k, m in got.graph.gmaps.items() if m.tile > 0]
    assert "l0.k3" in annotated and "down0" in annotated


def test_fixed_capacity_build_matches_jax():
    """A pinned build (fixed_capacity=4096: static shapes, every flat
    table kept, f32 feats, shipped coords)."""
    rng = np.random.default_rng(3)
    scenes = [voxelize_scene(rng, 3000) for _ in range(2)]
    want = JaxBatchBuilder(spec=jax_graph_spec(), fixed_capacity=4096).build(
        scenes, return_layout=True)
    got = BatchBuilder(spec=res16unet_graph_spec(),
                       fixed_capacity=4096).build_host(scenes,
                                                       return_layout=True)
    assert_tree_equal(want[0], got[0])
    for k in ("order", "pos0", "scene_offsets"):
        np.testing.assert_array_equal(got[1][k], want[1][k])
    assert got[0].graph.levels[0].capacity == 4096


def test_stabilized_builds_match_jax():
    """The stabilize contract (pinned windows, floored capacities, padded
    overflow COO) over a stream of alternating densities: each build of
    the stream is array-equal to the JAX builder's."""
    kw = dict(stabilize=True, ship_coords=False, compact_feats=True)
    jb = JaxBatchBuilder(spec=jax_graph_spec(), **kw)
    pb = BatchBuilder(spec=res16unet_graph_spec(), **kw)
    rng = np.random.default_rng(5)
    for i in range(4):
        pts = (1500, 6000, 3200)[i % 3]
        scenes = [voxelize_scene(rng, pts, raw_color=True) for _ in range(2)]
        assert_tree_equal(jb.build(scenes), pb.build_host(scenes),
                          f"build{i}")
    assert pb._sig_windows == jb._sig_windows
    assert pb._sig_caps == jb._sig_caps


def test_device_move_keeps_every_leaf():
    """``build(device="cpu")`` moves every array to torch with its wire
    dtype; the uint16 parent deltas arrive widened to int32 with the same
    values, and the compact batch index matches the JAX decoder's."""
    import jax.numpy as jnp

    scenes = _scenes(7)
    builder = BatchBuilder(spec=res16unet_graph_spec(), ship_coords=False,
                           compact_feats=True)
    host = builder.build_host(scenes)
    dev = host.to("cpu")
    jbatch = JaxBatchBuilder(spec=jax_graph_spec(), ship_coords=False,
                             compact_feats=True).build(scenes)
    for name, gm in host.graph.gmaps.items():
        moved = dev.graph.gmaps[name]
        for f in dataclasses.fields(gm):
            a = getattr(gm, f.name)
            if not isinstance(a, np.ndarray):
                assert getattr(moved, f.name) == a
                continue
            t = getattr(moved, f.name)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            if a.dtype == np.uint16:
                assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), a, err_msg=f"{name}.{f.name}")
    for lvl, jl in zip(dev.graph.levels, jbatch.graph.levels):
        np.testing.assert_array_equal(lvl.batch_idx.numpy(),
                                      np.asarray(jl.batch_idx))
        np.testing.assert_array_equal(
            lvl.mask().numpy(), np.asarray(jl.mask(jnp.float32)))


def test_entry_points_default_to_the_card():
    """Entry points default to device="cuda"; with no CUDA device they
    raise instead of running on the CPU."""
    from languagegroundedsemseg_torch.models.res16unet import Res16UNet34C

    scenes = _scenes(8, n_scenes=1, points=1500)
    builder = BatchBuilder(spec=res16unet_graph_spec())
    if torch.cuda.is_available():
        assert builder.build(scenes).feats.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        builder.build(scenes)
    with pytest.raises(RuntimeError, match="CUDA"):
        Res16UNet34C(out_channels=200)


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and the port's scripts
    import without jax or the JAX package. Checked in a fresh interpreter:
    this test process already holds jax (tests/conftest.py)."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import languagegroundedsemseg_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "for s in ('bench_onehot_gemm_torch', 'bench_onehot_variants_torch',\n"
        "          'bench_dw_torch', 'bench_csum_torch', 'bench_sel_fwd_torch',\n"
        "          'profile_torch_forward'):\n"
        "    spec = importlib.util.spec_from_file_location(s, f'scripts/{s}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'languagegroundedsemseg_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "PYTHON"))}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
