"""Res16UNet34C eval forward: the PyTorch port against the JAX package.

Same scenes, same graph, same weights (carried by
``languagegroundedsemseg_torch.convert.state_dict_from_jax``); the JAX model
runs ``model.apply(..., train=False)`` on the CPU and the port runs
``make_eval_step`` on the CPU, where its kernel wrappers take their plain
PyTorch versions.
"""

import functools

import numpy as np
import jax
import torch

from languagegroundedsemseg_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from languagegroundedsemseg_tpu.models.res16unet import (
    Res16UNet34C as JaxRes16UNet34C,
    res16unet_graph_spec as jax_graph_spec,
)
from languagegroundedsemseg_tpu.train.checkpoints import torch_to_flax_params
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
from languagegroundedsemseg_torch.models.res16unet import (
    Res16UNet34C,
    res16unet_graph_spec,
)
from languagegroundedsemseg_torch.train.step import make_eval_step
from oracles import make_cloud
from test_parity import _fixture_state_dict
from test_parity_dense_torch import C_OUT as FIXTURE_C_OUT


def _shapes(model, jbatch):
    """The flax trees' shapes, traced without running the init."""
    return jax.eval_shape(functools.partial(model.init, train=False),
                          jax.random.PRNGKey(0), jbatch.feats, jbatch.graph)


def _apply(model, variables, jbatch):
    """The JAX model's eval forward, jitted: one XLA compile on the CPU
    costs a fraction of running the net op by op."""
    fwd = jax.jit(functools.partial(model.apply, train=False))
    logits, _ = fwd(variables, jbatch.feats, jbatch.graph)
    return np.asarray(logits)


def _random_variables(shapes, seed):
    """Random flax trees with non-trivial BatchNorm statistics, so the
    carry exercises every tensor (init would leave BN at the identity)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        shape = np.shape(x)
        if name in ("scale", "var"):
            v = rng.uniform(0.6, 1.4, size=shape)
        elif name in ("bias", "mean"):
            v = 0.1 * rng.normal(size=shape)
        else:  # kernels: keep activations O(1) through the depth
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(size=shape) * (0.6 / np.sqrt(fan_in))
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _run_both(scenes, fixed_capacity, out_channels, seed=0):
    jb = JaxBatchBuilder(spec=jax_graph_spec(), fixed_capacity=fixed_capacity)
    jbatch = jb.build(scenes)
    jmodel = JaxRes16UNet34C(out_channels=out_channels)
    variables = _random_variables(_shapes(jmodel, jbatch), seed)
    want = _apply(jmodel, variables, jbatch)

    builder = BatchBuilder(spec=res16unet_graph_spec(),
                           fixed_capacity=fixed_capacity)
    batch = builder.build(scenes, device="cpu")
    model = Res16UNet34C(out_channels=out_channels, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    got, _ = make_eval_step(model, device="cpu")(batch)
    valid = np.asarray(jbatch.graph.levels[0].valid) > 0
    return got.numpy()[valid], want[valid], batch


def test_small_batch_matches_jax_on_gather_paths():
    """(a) ~150 voxels at capacity 256 sit below every window menu's
    minimum, so both packages run only their f32 gather paths (masked
    shift, child-sum scatter, parent gather): f32 to f32, up to sum order."""
    rng = np.random.default_rng(0)
    coords = make_cloud(rng, n=150, extent=8, batch=1)[:, 1:]
    scenes = [(coords, rng.normal(size=(len(coords), 3)).astype(np.float32),
               np.zeros(len(coords), np.int32))]
    got, want, batch = _run_both(scenes, 256, 200)
    g = batch.graph
    assert all(m.tile == 0 for m in g.gmaps.values())
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, f"relative max error {err}"


def test_windowed_batch_matches_jax_within_bf16():
    """(b) At capacity 1024 (as tests/test_parity.py builds it) a synthetic
    scene gives the L1 k3 map and the first two down maps window
    annotations, so the port runs its selector and child-sum paths in bf16
    (bf16 projection GEMMs, plain kernels on the CPU) while JAX on the CPU
    routes around its Pallas kernels to the f32 masked-shift and scatter
    paths. The difference is bf16 rounding of the projections, carried
    through the depth of the net: relative L2 <= 2e-2."""
    scenes = [voxelize_scene(np.random.default_rng(1), 600)]
    got, want, batch = _run_both(scenes, 1024, 200)
    annotated = {k for k, m in batch.graph.gmaps.items() if m.tile > 0}
    assert {"l1.k3", "down0", "down1"} <= annotated
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"(b) relative L2 {err:.3e}")  # shown by pytest -rP
    assert err < 2e-2, f"relative L2 error {err}"


def test_fixture_logits_through_the_carry():
    """(c) The committed fixture (tests/fixtures/parity_scene_34c.npz): the
    reference-format state_dict goes through the JAX package's importer
    (ME slot permutation) and then ``state_dict_from_jax``; the port's
    logits must match the recorded float64 oracle at the bf16 tolerance of
    (b). The carried names must be exactly the reference state_dict's."""
    sd0, fx = _fixture_state_dict()
    coords, feats, want = fx["coords"], fx["feats"], fx["logits"]
    scene = [(coords, feats, np.zeros(len(coords), np.int32))]

    jbatch = JaxBatchBuilder(spec=jax_graph_spec(),
                             fixed_capacity=1024).build(scene)
    jmodel = JaxRes16UNet34C(out_channels=FIXTURE_C_OUT)
    variables = _random_variables(_shapes(jmodel, jbatch), 0)
    params, stats, skipped = torch_to_flax_params(
        sd0, variables["params"], variables["batch_stats"])
    assert not skipped

    sd = state_dict_from_jax(params, stats)
    assert set(sd) == set(sd0)
    model = Res16UNet34C(out_channels=FIXTURE_C_OUT, device="cpu")
    model.load_state_dict(sd)
    batch, layout = BatchBuilder(spec=res16unet_graph_spec(),
                                 fixed_capacity=1024).build(
        scene, return_layout=True, device="cpu")
    logits, _ = make_eval_step(model, device="cpu")(batch)
    got = logits.numpy()[layout["pos0"]]
    want_kept = want[layout["order"]]
    err = np.linalg.norm(got - want_kept) / np.linalg.norm(want_kept)
    print(f"(c) relative L2 {err:.3e}")  # shown by pytest -rP
    assert err < 2e-2, f"relative L2 error {err}"
