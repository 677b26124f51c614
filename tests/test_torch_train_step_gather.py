"""One Res16UNet34C train step: the PyTorch port against the JAX package.

Same scenes, same graph, same weights (``state_dict_from_jax`` of the
weights of tests/test_torch_res16unet.py); the JAX package runs its jitted
``make_train_step`` with ``sgd_torch(0.01)`` and bench.py's objective (CE,
ignore label 255, level-0 row mask), the port runs its ``make_train_step``
on the CPU with the same optimizer and objective. Compared: the loss, every
parameter's gradient, every parameter after the SGD step, and the BN running
statistics after the step. JAX's gradients are read back from its momentum
buffer: after the first step it holds exactly grad + weight_decay * param.

This file holds the gather-path batch (a); the windowed batch (b) is in
tests/test_torch_train_step_windowed.py, which imports the harness below.
"""

import numpy as np
import jax

from languagegroundedsemseg_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from languagegroundedsemseg_tpu.losses.classification import (
    cross_entropy_loss as jax_cross_entropy_loss,
)
from languagegroundedsemseg_tpu.models.res16unet import (
    Res16UNet34C as JaxRes16UNet34C,
    res16unet_graph_spec as jax_graph_spec,
)
from languagegroundedsemseg_tpu.train.solvers import sgd_torch as jax_sgd_torch
from languagegroundedsemseg_tpu.train.state import TrainState as JaxTrainState
from languagegroundedsemseg_tpu.train.step import make_train_step as jax_make_train_step
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss
from languagegroundedsemseg_torch.models.res16unet import (
    Res16UNet34C,
    res16unet_graph_spec,
)
from languagegroundedsemseg_torch.train.solvers import sgd_torch
from languagegroundedsemseg_torch.train.state import TrainState
from languagegroundedsemseg_torch.train.step import make_train_step
from oracles import make_cloud
from test_torch_res16unet import _random_variables, _shapes

LR, WEIGHT_DECAY = 0.01, 1e-4


def _labelled(rng, coords, feats):
    """Labels in [0, 200) with 10% ignored (255)."""
    labels = rng.integers(0, 200, size=len(coords)).astype(np.int32)
    labels[rng.random(len(coords)) < 0.1] = 255
    return coords, feats, labels


def _jax_step(scenes, fixed_capacity, seed=0, perturb=0.0):
    """Loss, grads, params and BN stats after one JAX train step (flax
    trees of numpy arrays) and the weights it started from. With
    ``perturb`` > 0, also the grads of the same step on input features
    moved by that relative amount (seeded normal noise), as
    ``grads_perturbed``."""
    jbatch = JaxBatchBuilder(spec=jax_graph_spec(),
                             fixed_capacity=fixed_capacity).build(scenes)
    jmodel = JaxRes16UNet34C(out_channels=200)
    variables = _random_variables(_shapes(jmodel, jbatch), seed)
    tx = jax_sgd_torch(LR)
    state = JaxTrainState.create(variables, tx)

    def objective(logits, _feats, b, _key, row_mask):
        return jax_cross_entropy_loss(logits, b.labels, ignore_index=255,
                                      row_mask=row_mask), {}

    step = jax.jit(jax_make_train_step(jmodel, tx, objective))

    def grads_of(new):
        momentum = new.opt_state[1].momentum  # trace_with_dampening's buffer
        return jax.device_get(jax.tree_util.tree_map(
            lambda m, p: m - WEIGHT_DECAY * p, momentum, variables["params"]))

    new, metrics = step(state, jbatch, jax.random.PRNGKey(1))
    out = dict(loss=float(metrics["loss"]), grads=grads_of(new),
               params=jax.device_get(new.params),
               stats=jax.device_get(new.batch_stats), variables=variables)
    if perturb:
        noise = np.random.default_rng(2).normal(size=np.shape(jbatch.feats))
        moved = jbatch.replace(
            feats=np.asarray(jbatch.feats) * (1 + perturb * noise).astype(np.float32))
        out["grads_perturbed"] = grads_of(
            step(state, moved, jax.random.PRNGKey(1))[0])
    return out


def _port_step(scenes, fixed_capacity, variables):
    batch = BatchBuilder(spec=res16unet_graph_spec(),
                         fixed_capacity=fixed_capacity).build(scenes,
                                                              device="cpu")
    model = Res16UNet34C(out_channels=200, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    opt = sgd_torch(model.parameters(), LR)

    def objective(logits, _feats, b, _gen, row_mask):
        return cross_entropy_loss(logits, b.labels, 255,
                                  row_mask=row_mask), {}

    state, metrics = make_train_step(model, opt, objective, device="cpu")(
        TrainState(model, opt), batch)
    assert state.step == 1
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    after = {n: t.numpy() for n, t in model.state_dict().items()}
    return float(metrics["loss"]), float(metrics["grad_norm"]), grads, after, batch


def run_both(scenes, fixed_capacity, perturb=0.0):
    """Both steps on the same batch; returns the JAX record, the port's
    (loss, grad_norm, grads, state after, batch) and the JAX trees renamed
    to the port's state_dict names ("grads", "after" and, with
    ``perturb``, "grads_perturbed")."""
    j = _jax_step(scenes, fixed_capacity, perturb=perturb)
    p = _port_step(scenes, fixed_capacity, j["variables"])
    names = dict(grads=state_dict_from_jax(j["grads"], {}),
                 after=state_dict_from_jax(j["params"], j["stats"]))
    if perturb:
        names["grads_perturbed"] = state_dict_from_jax(j["grads_perturbed"],
                                                       {})
    assert set(names["grads"]) == set(p[2])
    assert set(names["after"]) == set(p[3])
    return j, p, {k: {n: t.numpy() for n, t in v.items()}
                  for k, v in names.items()}


def _rel_max(got, want):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return np.abs(np.asarray(got, np.float64) - want).max() / max(scale, 1e-30)


def test_train_step_matches_jax_on_gather_paths():
    """(a) ~150 voxels at capacity 256: every map is below the window menus,
    so both packages run f32 gather paths forward and backward (masked
    shift, flat, child-sum scatter, parent gather). f32 to f32, up to sum
    order: every tensor within 1e-4 relative max error."""
    rng = np.random.default_rng(0)
    coords = make_cloud(rng, n=150, extent=8, batch=1)[:, 1:]
    feats = rng.normal(size=(len(coords), 3)).astype(np.float32)
    scenes = [_labelled(rng, coords, feats)]
    j, (loss, gnorm, grads, after, batch), want = run_both(scenes, 256)
    assert all(m.tile == 0 for m in batch.graph.gmaps.values())
    assert abs(loss - j["loss"]) <= 1e-4 * abs(j["loss"])
    want_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                            for g in want["grads"].values()))
    assert abs(gnorm - want_norm) <= 1e-4 * want_norm
    for kind, got in (("grads", grads), ("after", after)):
        worst = max(((n, _rel_max(got[n], w)) for n, w in want[kind].items()),
                    key=lambda kv: kv[1])
        print(f"(a) {kind}: worst {worst[0]} {worst[1]:.3e}")
        assert worst[1] <= 1e-4, worst
