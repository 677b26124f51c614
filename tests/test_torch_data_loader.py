"""The port's threaded loader against the JAX package's.

Both packages' ``initialize_data_loader`` run the same synthetic dataset
with the same seed: the JAX loader with its device transfer turned off
(``loader.device_put = False``, as tests/test_data_pipeline.py does), the
port's with ``device="cpu"``, where batches are torch tensors over the
builder's numpy arrays. With one worker every leaf of every batch is equal;
with two, which batch finishes first moves a later batch's stabilized
capacities, so only what does not depend on capacity is compared. Then the
loader's machinery (worker exceptions, counters, epochs, concurrency), the
port of tests/test_signature_stability.py, and the slice as a whole: one
loader batch through the JAX eval step and the port's.
"""

import dataclasses
import sys
import threading
import time
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.config import Config as JaxConfig
from languagegroundedsemseg_tpu.data.loader import (
    initialize_data_loader as jax_initialize_data_loader,
)
from languagegroundedsemseg_tpu.data.synthetic_dataset import (
    SyntheticTiny20Dataset as JaxTiny20,
)
from languagegroundedsemseg_tpu.models.res16unet import (
    Res16UNet34C as JaxRes16UNet34C,
)
from languagegroundedsemseg_tpu.train.solvers import sgd_torch as jax_sgd_torch
from languagegroundedsemseg_tpu.train.state import TrainState as JaxTrainState
from languagegroundedsemseg_tpu.train.step import make_eval_step as jax_make_eval_step
from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.data.loader import (
    DataLoader,
    batch_tensors,
    initialize_data_loader,
)
from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
from languagegroundedsemseg_torch.data.synthetic_dataset import (
    SyntheticTiny20Dataset,
)
from languagegroundedsemseg_torch.models import layers
from languagegroundedsemseg_torch.models.res16unet import (
    Res16UNet34C,
    res16unet_graph_spec,
)
from languagegroundedsemseg_torch.ops import onehot_conv
from languagegroundedsemseg_torch.train.step import make_eval_step
from test_torch_res16unet import _random_variables, _shapes


def _loaders(jax_cls=JaxTiny20, port_cls=SyntheticTiny20Dataset,
             num_workers=1, batch_size=2, repeat=False, **cfg):
    """(JAX loader, port loader) over the same dataset and seed."""
    cfg.setdefault("ignore_label", 255)
    out = []
    for init, config, cls, kw in (
            (jax_initialize_data_loader, JaxConfig, jax_cls, {}),
            (initialize_data_loader, Config, port_cls, {"device": "cpu"})):
        c = config(batch_size=batch_size, **cfg)
        loader = init(cls, c, phase="train", num_workers=num_workers,
                      shuffle=True, repeat=repeat, augment_data=True,
                      batch_size=batch_size,
                      limit_numpoints=c.train_limit_numpoints,
                      ship_coords=False, **kw)
        out.append(loader)
    out[0].device_put = False
    return out


def _leaves(obj, path="batch"):
    """(path, value) of every field of a batch, walked through dataclasses,
    dicts and sequences of arrays or dataclasses; arrays as numpy."""
    if isinstance(obj, torch.Tensor):
        yield path, obj.numpy()
    elif isinstance(obj, (np.ndarray, jax.Array)):
        yield path, np.asarray(obj)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _leaves(obj[k], f"{path}[{k}]")
    elif isinstance(obj, (list, tuple)) and any(
            dataclasses.is_dataclass(v)
            or isinstance(v, (np.ndarray, torch.Tensor, jax.Array))
            for v in obj):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, obj


def _assert_batches_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for path, wv in w.items():
        gv = g[path]
        if path.endswith(".num"):
            # a 0-d array in the JAX tree, a Python int in the port's
            assert int(gv) == int(wv), path
        elif isinstance(wv, np.ndarray):
            assert isinstance(gv, np.ndarray), path
            if wv.dtype == np.uint16:
                # the port widens uint16 block deltas to int32 on the move
                assert gv.dtype == np.int32, path
            else:
                assert gv.dtype == wv.dtype, (path, gv.dtype, wv.dtype)
            np.testing.assert_array_equal(gv, wv, err_msg=path)
        else:
            assert gv == wv, (path, gv, wv)


def _valid(batch):
    return np.asarray(batch.graph.levels[0].valid) > 0


@pytest.mark.parametrize("cfg", [
    {},  # flex capacities, stabilized: the production loader
    {"fixed_capacity": 8192},
    {"data_aug_patch_dropout_ratio": 0.0},  # RandomDropout after voxelizing
])
def test_batches_equal_one_worker(cfg):
    jl, pl = _loaders(**cfg)
    want, got = list(jl), list(pl)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.feats.dtype == torch.uint8  # raw colors on the wire
        _assert_batches_equal(g, w)
    # JAX's keys as JAX's; beside them only the port's time and copy means
    snap, want = pl.counters.snapshot(), jl.counters.snapshot()
    assert {k: snap[k] for k in want} == want
    assert set(snap) - set(want) == {"loader_get_item_ms", "loader_build_ms",
                                     "loader_wait_ms", "loader_h2d_mb"}
    assert pl.counters.level_num_sum == jl.counters.level_num_sum


def test_f32_wire_path_equal():
    """Colors scaled past 255 by the chromatic scale: the whole batch takes
    the normalized float wire path (f16 with compact feats), and both
    packages' decompact give the same f32 feats."""
    jl, pl = _loaders(data_aug_color_scaling_factor=1.5)
    for g, w in zip(list(pl), list(jl)):
        assert g.feats.dtype == torch.float16
        _assert_batches_equal(g, w)
        gd, wd = g.decompact(), w.decompact()
        assert gd.feats.dtype == torch.float32
        np.testing.assert_array_equal(gd.feats.numpy(), np.asarray(wd.feats))
        np.testing.assert_array_equal(gd.labels.numpy(), np.asarray(wd.labels))
        m = _valid(g)
        assert np.abs(gd.feats.numpy()[m]).max() > 0.5  # past [0, 255]


def test_valid_rows_equal_two_workers():
    jl, pl = _loaders(num_workers=2, repeat=True)
    jit, pit = iter(jl), iter(pl)
    for _ in range(4):
        g, w = next(pit), next(jit)
        assert [l.num for l in g.graph.levels] == [
            int(l.num) for l in w.graph.levels]
        gm, wm = _valid(g), _valid(w)
        assert gm.sum() == wm.sum()
        np.testing.assert_array_equal(g.feats.numpy()[gm], np.asarray(w.feats)[wm])
        np.testing.assert_array_equal(g.labels.numpy()[gm], np.asarray(w.labels)[wm])
        np.testing.assert_array_equal(g.extras["scene_idx"].numpy()[gm],
                                      np.asarray(w.extras["scene_idx"])[wm])
        for gl, wl in zip(g.graph.levels, w.graph.levels):
            assert int(gl.valid.sum()) == int(np.asarray(wl.valid).sum())


def test_num_devices_raises():
    """A sharded loader needs its rank (no default shard for every rank),
    and a rank inside the world."""
    args = (SyntheticTiny20Dataset, Config(ignore_label=255),
            "train", 1, True, True, True, 1, 10_000_000)
    with pytest.raises(ValueError, match="rank"):
        initialize_data_loader(*args, num_devices=2, device="cpu")
    with pytest.raises(ValueError, match="rank 2"):
        initialize_data_loader(*args, num_devices=2, device="cpu", rank=2)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_data_loader(SyntheticTiny20Dataset, Config(ignore_label=255),
                               "train", 1, True, False, True, 2, 10_000_000)


# ---- loader machinery ------------------------------------------------------


class _ToyDataset:
    """Minimal dataset for loader-machinery tests."""

    class config:
        normalize_color = False

    def __init__(self, n=8, delay=0.0, raise_at=None):
        self.n = n
        self.delay = delay
        self.raise_at = raise_at
        self._lock = threading.Lock()
        self.active = 0
        self.max_active = 0

    def __len__(self):
        return self.n

    def get_item(self, idx, rng):
        with self._lock:
            self.active += 1
            self.max_active = max(self.max_active, self.active)
        try:
            if self.raise_at is not None and idx == self.raise_at:
                raise RuntimeError(f"bad scene {idx}")
            if self.delay:
                time.sleep(self.delay)
            coords = rng.integers(0, 20, size=(64, 3)).astype(np.int32)
            feats = rng.random((64, 3)).astype(np.float32)
            labels = np.zeros(64, np.int32)
            return {"coords": coords, "feats": feats, "labels": labels}
        finally:
            with self._lock:
                self.active -= 1


def _toy_loader(ds, **kw):
    builder = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=256,
                           limit_numpoints=10_000_000)
    kw.setdefault("batch_size", 1)
    return DataLoader(ds, builder, device="cpu", **kw)


def test_worker_exception_reaches_consumer():
    loader = _toy_loader(_ToyDataset(n=6, raise_at=3), shuffle=False,
                         num_workers=2)
    with pytest.raises(RuntimeError, match="bad scene 3"):
        list(loader)


def test_builds_overlap_and_epochs_vary():
    ds = _ToyDataset(n=8, delay=0.15)
    assert len(list(_toy_loader(ds, shuffle=False, num_workers=4))) == 8
    assert ds.max_active >= 2, "num_workers > 1 must overlap scene builds"
    loader = _toy_loader(_ToyDataset(n=4), shuffle=True, num_workers=1, seed=7)
    ep0 = [b.feats.clone() for b in loader]
    ep1 = [b.feats.clone() for b in loader]
    assert not all(torch.equal(a, b) for a, b in zip(ep0, ep1))
    assert loader.epoch == 2


def test_counters_under_many_workers():
    """More workers than cores and a short switch interval: every batch is
    counted once, and batches arrive in submission order."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ds = _ToyDataset(n=48)
        loader = _toy_loader(ds, shuffle=False, num_workers=16)
        out = []
        done = threading.Event()

        def consume():
            for b in loader:
                out.append(int(b.extras["scene_idx"][_valid(b)][0]))
            done.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(timeout=120)
        assert done.is_set() and not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert out == list(range(48))
    snap = loader.counters.snapshot()
    assert snap["loader_batches"] == 48 and snap["loader_scenes_dropped"] == 0
    assert 0 < snap["loader_fill_l0"] <= 1.0


def test_batch_tensors_walks_every_leaf():
    loader = _toy_loader(_ToyDataset(n=1), shuffle=False, num_workers=1)
    (b,) = list(loader)
    tensors = list(batch_tensors(b))
    paths = [p for p, v in _leaves(b) if isinstance(v, np.ndarray)]
    assert len(tensors) == len(paths) > 10


# ---- signature stability (port of tests/test_signature_stability.py) -------


def _signature(batch):
    """Array shapes and dtypes plus the static fields: what a compiled
    step would key on. ``num`` is a per-batch count, not a shape."""
    return tuple(
        (p, v.shape, v.dtype.str) if isinstance(v, np.ndarray) else (p, v)
        for p, v in _leaves(batch) if not p.endswith(".num"))


def _scene_cycle(i, rng):
    # alternating densities force flex-bucket / window / overflow variance
    pts = (1500, 6000, 3200)[i % 3]
    return [voxelize_scene(rng, pts, raw_color=True) for _ in range(2)]


def test_signatures_converge_across_density_cycle():
    rng = np.random.default_rng(0)
    builder = BatchBuilder(spec=res16unet_graph_spec(), stabilize=True,
                           ship_coords=False, compact_feats=True)
    sigs = [_signature(builder.build(_scene_cycle(i, rng), device="cpu"))
            for i in range(9)]
    tail = set(sigs[3:])
    assert len(tail) == 1, (
        f"signatures did not converge: {len(set(sigs))} distinct over 9 "
        f"builds, {len(tail)} distinct over the last 6")
    rng = np.random.default_rng(0)
    plain = BatchBuilder(spec=res16unet_graph_spec(), stabilize=False,
                         ship_coords=False, compact_feats=True)
    plain_sigs = {_signature(plain.build(_scene_cycle(i, rng), device="cpu"))
                  for i in range(3)}
    assert len(plain_sigs) > 1


def test_stabilized_batch_preserves_forward_semantics():
    """The stabilized build's padding and floors are a semantic no-op. On
    the f32 gather paths (the windowed selector and child-sum routes
    declined, as the JAX model declines its Pallas kernels on the CPU) the
    logits of the real rows agree to 1e-5; on the windowed routes the two
    builds' different window pins change which rows take the bf16
    projections, so they agree to the bf16 bound of
    tests/test_torch_res16unet.py (relative L2 <= 2e-2)."""
    rng = np.random.default_rng(1)
    scenes = [voxelize_scene(rng, 2500, raw_color=True) for _ in range(2)]
    stab = BatchBuilder(spec=res16unet_graph_spec(), stabilize=True,
                        ship_coords=False, compact_feats=True)
    # seed the contract with a denser stream so the stabilized build of
    # ``scenes`` is actually padded and floored
    big = [voxelize_scene(np.random.default_rng(2), 8000, raw_color=True)
           for _ in range(2)]
    stab.build_host(big)
    b_stab = stab.build(scenes, device="cpu")
    plain = BatchBuilder(spec=res16unet_graph_spec(), ship_coords=False,
                         compact_feats=True)
    b_ref = plain.build(scenes, device="cpu")
    assert b_stab.graph.levels[0].capacity > b_ref.graph.levels[0].capacity

    model = Res16UNet34C(out_channels=13, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    step = make_eval_step(model, device="cpu")
    vr, vs = _valid(b_ref), _valid(b_stab)
    assert vr.sum() == vs.sum()
    with mock.patch.object(layers, "onehot_window_conv", lambda *a: None), \
            mock.patch.object(onehot_conv, "_cs_window",
                              lambda *a: (0, 0, 1)):
        out_ref, _ = step(b_ref)
        out_stab, _ = step(b_stab)
    np.testing.assert_allclose(out_stab.numpy()[vs], out_ref.numpy()[vr],
                               rtol=1e-5, atol=1e-5)
    out_ref, _ = step(b_ref)
    out_stab, _ = step(b_stab)
    a, b = out_stab.numpy()[vs], out_ref.numpy()[vr]
    err = np.linalg.norm(a - b) / np.linalg.norm(b)
    print(f"stabilized vs plain, windowed routes: relative L2 {err:.3e}")
    assert err <= 2e-2


# ---- the slice as a whole --------------------------------------------------


class _JaxGatherTiny(JaxTiny20):
    # ~90 voxels a scene: below every window menu's minimum at capacity 256
    POINTS_PER_SCENE = 100


class _GatherTiny(SyntheticTiny20Dataset):
    POINTS_PER_SCENE = 100


def test_loader_batch_through_eval_steps_matches_jax():
    """One loader batch (augmented, uint8 wire colors) through the JAX
    package's eval step and the port's, on the f32 gather paths, with the
    weights carried by ``convert.state_dict_from_jax``: f32 to f32, up to
    sum order."""
    jl, pl = _loaders(_JaxGatherTiny, _GatherTiny, fixed_capacity=256)
    jbatch, batch = next(iter(jl)), next(iter(pl))
    _assert_batches_equal(batch, jbatch)
    assert all(m.tile == 0 for m in batch.graph.gmaps.values())

    jmodel = JaxRes16UNet34C(out_channels=20)
    variables = _random_variables(
        _shapes(jmodel, jbatch.decompact()), seed=0)
    state = JaxTrainState.create(variables, jax_sgd_torch(0.01))
    want, _ = jax.jit(jax_make_eval_step(jmodel))(state, jbatch)

    model = Res16UNet34C(out_channels=20, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    got, _ = make_eval_step(model, device="cpu")(batch)
    valid = _valid(batch)
    got, want = got.numpy()[valid], np.asarray(want)[valid]
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"loader batch, eval step: relative max error {err:.3e}")
    assert err < 1e-4, f"relative max error {err}"
