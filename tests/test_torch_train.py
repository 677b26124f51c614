"""Losses, optimizers, schedules and the train state of the PyTorch port
against the JAX package's (CPU).

Losses: CE, weighted CE and focal, every reduction, with ignore label 255
and a row mask (f32 log-softmax on both sides; only the order of the
reductions differs). Optimizers: ``sgd_torch`` and ``adam_torch`` over 3
steps on a random parameter tree, with a schedule, ``iter_size``
accumulation (against ``optax.MultiSteps``) and ``lr_scale`` (f32
elementwise updates in another order). Schedules: every name at several
steps (JAX computes them in f32). All to 1e-6 relative: max abs error <=
1e-6 * max |ref|.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from languagegroundedsemseg_tpu.config import Config
from languagegroundedsemseg_tpu.losses import classification as jax_cls
from languagegroundedsemseg_tpu.train import solvers as jax_solvers
from languagegroundedsemseg_torch.losses import classification as cls
from languagegroundedsemseg_torch.train import solvers
from languagegroundedsemseg_torch.train.state import TrainState
from languagegroundedsemseg_torch.train.step import fold_in, make_train_step

RTOL = 1e-6


def _assert_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= RTOL * max(np.abs(want).max(), 1e-30), err


def _loss_inputs(seed=0, n=500, c=20):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(n, c))).astype(np.float32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    labels[rng.random(n) < 0.15] = 255
    row_mask = (rng.random(n) < 0.8).astype(np.float32)
    weight = rng.uniform(0.2, 2.0, size=c).astype(np.float32)
    return logits, labels, row_mask, weight


@pytest.mark.parametrize("name", ["cross_entropy", "weighted_ce", "focal"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(name, reduction, masked):
    logits, labels, row_mask, weight = _loss_inputs()
    rm = row_mask if masked else None
    want = jax_cls.loss_by_name(name, 255, jnp.asarray(weight), 2.0, 0.5,
                                reduction)(
        jnp.asarray(logits), jnp.asarray(labels),
        row_mask=None if rm is None else jnp.asarray(rm))
    got = cls.loss_by_name(name, 255, torch.from_numpy(weight), 2.0, 0.5,
                           reduction)(
        torch.from_numpy(logits), torch.from_numpy(labels),
        row_mask=None if rm is None else torch.from_numpy(rm))
    _assert_rel(got.numpy(), np.asarray(want))


def test_loss_gradient_matches_jax():
    """d loss / d logits of CE with ignore 255 and the row mask."""
    logits, labels, row_mask, _ = _loss_inputs(1)
    want = jax.grad(lambda lg: jax_cls.cross_entropy_loss(
        lg, jnp.asarray(labels), row_mask=jnp.asarray(row_mask)))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    cls.cross_entropy_loss(lt, torch.from_numpy(labels),
                           row_mask=torch.from_numpy(row_mask)).backward()
    _assert_rel(lt.grad.numpy(), np.asarray(want))


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        cls.loss_by_name("hinge")
    with pytest.raises(ValueError):
        cls.loss_by_name("weighted_ce")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 4)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "c": rng.normal(size=(2, 3, 3)).astype(np.float32)}


def _run_jax(tx, params, grads_seq, lr_scale):
    state = tx.init(params)
    p = params
    for g in grads_seq:
        upd, state = tx.update(g, state, p)
        upd = jax.tree_util.tree_map(lambda u: u * lr_scale, upd)
        p = optax.apply_updates(p, upd)
    return jax.device_get(p)


def _run_port(make, params, grads_seq, lr_scale):
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make(list(ps.values()))
    for g in grads_seq:
        opt.zero_grad()
        for k, v in g.items():
            ps[k].grad = torch.from_numpy(v.copy())
        opt.step(lr_scale=lr_scale)
    return {k: v.detach().numpy() for k, v in ps.items()}


def _schedule(s):
    return 0.05 * 0.5 ** (s // 2)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("lr", ["const", "schedule"])
@pytest.mark.parametrize("iter_size,lr_scale", [(1, 1.0), (1, 0.5), (2, 1.0)])
def test_optimizers_match_optax(opt, lr, iter_size, lr_scale):
    """3 updates (6 micro-batches with iter_size 2) on a random tree:
    parameters after each run agree with the optax chain."""
    params = _tree(0)
    n_calls = 3 * iter_size
    grads_seq = [_tree(10 + i) for i in range(n_calls)]
    learning_rate = 0.05 if lr == "const" else _schedule
    jax_make = jax_solvers.sgd_torch if opt == "sgd" else jax_solvers.adam_torch
    tx = jax_make(learning_rate if lr == "const"
                  else (lambda s: 0.05 * 0.5 ** jnp.floor(s / 2)))
    if iter_size > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=iter_size)
    want = _run_jax(tx, params, grads_seq, lr_scale)
    port_make = solvers.sgd_torch if opt == "sgd" else solvers.adam_torch
    got = _run_port(lambda ps: port_make(ps, learning_rate,
                                         iter_size=iter_size),
                    params, grads_seq, lr_scale)
    for k in params:
        _assert_rel(got[k], np.asarray(want[k]))


def test_sgd_first_step_is_undampened():
    """torch's SGD sets the momentum buffer to the raw gradient on the first
    step (dampening applies from the second), as trace_with_dampening."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = solvers.sgd_torch([p], 1.0, momentum=0.9, dampening=0.5,
                            weight_decay=0.0)
    p.grad = torch.ones(3)
    opt.step()
    _assert_rel(p.detach().numpy(), -np.ones(3))
    p.grad = torch.ones(3)
    opt.step()
    _assert_rel(p.detach().numpy(), -(1 + 0.9 + 0.5) * np.ones(3))


@pytest.mark.parametrize("name", ["StepLR", "MultiStepLR", "PolyLR",
                                  "SquaredLR", "ExpLR", "ReduceLROnPlateau",
                                  "none", None])
def test_lr_schedules_match_jax(name):
    kw = dict(step_size=3, step_gamma=0.3, multi_step_milestones=(2, 5),
              poly_power=0.9, max_steps=10, exp_gamma=0.9, exp_step_size=4)
    want = jax_solvers.make_lr_schedule(name, 0.1, **kw)
    got = solvers.make_lr_schedule(name, 0.1, **kw)
    for s in (0, 1, 2, 3, 5, 7, 10, 11, 20):
        _assert_rel(float(got(s)), float(want(jnp.asarray(s))))
    with pytest.raises(ValueError):
        solvers.make_lr_schedule("CosineLR", 0.1)


@pytest.mark.parametrize("optimizer,iter_size", [("SGD", 1), ("Adam", 2)])
def test_initialize_optimizer_matches_jax(optimizer, iter_size):
    cfg = Config(optimizer=optimizer, lr=0.02, weight_decay=1e-3,
                 iter_size=iter_size)
    params = _tree(1)
    grads_seq = [_tree(20 + i) for i in range(2 * iter_size)]
    want = _run_jax(jax_solvers.initialize_optimizer(cfg), params,
                    grads_seq, 1.0)
    got = _run_port(lambda ps: solvers.initialize_optimizer(ps, cfg), params,
                    grads_seq, 1.0)
    for k in params:
        _assert_rel(got[k], np.asarray(want[k]))
    with pytest.raises(ValueError):
        solvers.initialize_optimizer([torch.nn.Parameter(torch.zeros(1))],
                                     Config(optimizer="RMSprop"))


def test_train_step_state_and_metrics():
    """make_train_step on a toy model: the step counter advances, lr_scale
    0 leaves the parameters alone, grad_norm is the global L2 norm of the
    gradients, and the objective sees the generator folded with the step.
    Without CUDA the default device raises."""
    from languagegroundedsemseg_torch.sparse.types import ConvGraph, SparseLevel
    from languagegroundedsemseg_torch.train.step import TrainBatch

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor([[1.0, -2.0], [0.5, 3.0]]))

        def forward(self, feats, graph, representation_only=False):
            out = feats @ self.w
            return out, out

    seen = []

    def objective(logits, _f, batch, gen, row_mask):
        seen.append(torch.rand((), generator=gen).item())
        return cls.cross_entropy_loss(logits, batch.labels,
                                      row_mask=row_mask), {"n": row_mask.sum()}

    model = Toy()
    opt = solvers.sgd_torch(model.parameters(), 0.1)
    state = TrainState(model, opt, lr_scale=0.0)
    level = SparseLevel(coords=None, num=3, stride=1,
                        valid=np.array([1, 1, 0], np.uint8))
    batch = TrainBatch(feats=np.array([[1, 0], [0, 1], [5, 5]], np.float32),
                       labels=np.array([0, 1, 255], np.uint8),
                       graph=ConvGraph(levels=(level,), maps={}))
    step = make_train_step(model, opt, objective, device="cpu")
    gen = torch.Generator().manual_seed(7)
    w0 = model.w.detach().clone()
    state, m = step(state, batch, gen)
    state, m = step(state, batch, gen)
    assert state.step == 2 and float(m["n"]) == 2.0
    torch.testing.assert_close(model.w.detach(), w0, rtol=0, atol=0)
    torch.testing.assert_close(m["grad_norm"], model.w.grad.norm())
    assert seen[0] != seen[1]
    assert seen[0] == torch.rand((), generator=fold_in(gen, 0)).item()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_train_step(model, opt, objective)
