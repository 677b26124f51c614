"""bf16 compute and per-block recomputation: the port against the JAX package.

Narrowed Res16UNet families on tests/test_torch_zoo.py's 250-voxel graphs
(no window annotation at these sizes, so both packages run their gather
paths), the same random flax weights carried by
``convert.state_dict_from_jax``.

- bf16 (``dtype=torch.bfloat16`` / ``dtype=jnp.bfloat16``): the forward in
  eval and train mode and one SGD step (loss, BN statistics, parameters)
  against JAX's in bf16, and against the port's own f32.
- ``remat``: one SGD step with each residual block checkpointed equals the
  step without, bit for bit (gradients, parameters, BN statistics, which
  move once although every block's forward runs twice), and matches JAX's
  ``nn.remat`` step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.losses.classification import (
    cross_entropy_loss as jax_cross_entropy_loss,
)
from languagegroundedsemseg_tpu.train.solvers import sgd_torch as jax_sgd_torch
from languagegroundedsemseg_tpu.train.state import TrainState as JaxTrainState
from languagegroundedsemseg_tpu.train.step import make_train_step as jax_make_train_step
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss
from languagegroundedsemseg_torch.models import layers
from languagegroundedsemseg_torch.train.solvers import sgd_torch
from languagegroundedsemseg_torch.train.state import TrainState
from languagegroundedsemseg_torch.train.step import TrainBatch, make_train_step
from test_torch_res16unet import _random_variables
from test_torch_trainer import one_torch_thread  # noqa: F401 (autouse)
from test_torch_zoo import C_OUT, FAST_COMPILE, NARROW, _graphs, _narrowed

# bf16 port vs bf16 JAX: the same casts, but XLA's CPU bf16 dot and
# sigmoid and torch's may round a result's last bit differently (the SE
# gate's sigmoid differs by one ulp), and one flip is 2^-8 relative;
# through a few layers that spreads to ~1e-2 of the outputs' scale
BF16_RTOL = 3e-2
# bf16 vs f32 of the same package: every layer rounds its output to 8 bits
# of mantissa; a cast in a wrong place (an f32 path left in bf16, or the
# reverse) moves this gap by an order of magnitude
BF16_VS_F32_RTOL = 6e-2
# parameters after one bf16 step vs the f32 step's: the gradients are not a
# continuous function of the rounding (ReLUs near zero, PERF.md §6), so
# bf16's gradients move a tensor's update by tens of percent of the
# update; this only catches an update of the wrong scale or sign
PARAMS_BF16_VS_F32_RTOL = 0.25
# f32 remat vs f32 JAX: the gather paths' sums in another order
F32_RTOL = 1e-4
LR = 0.05

FAMILIES = {
    "Res16UNet14": dict(NARROW),
    "Res16UNet50": dict(NARROW),
    # SE's bottleneck is channels // 16 wide: 32 channels at least
    "Res16UNet14_se": dict(NARROW, PLANES=(32,) * 8, BLOCK="se_basic"),
}


def _model(name, dtype=None, remat=False):
    """(JAX model, port class) of a narrowed family, in ``dtype`` (None:
    f32) and with ``remat``."""
    fields = dict(FAMILIES[name])
    jname = name.split("_")[0]
    jmodel, pcls = _narrowed(jname, fields)
    extra = {}
    if dtype is not None:
        extra["dtype"] = jnp.bfloat16
    if remat:
        extra["remat"] = True
    if extra:
        jmodel = jmodel.clone(**extra)
    return jmodel, pcls


@pytest.fixture(scope="module")
def setup():
    """The graphs, feats, labels and random flax weights of each family."""
    out = {}
    for name in FAMILIES:
        jmodel, pcls = _model(name)
        g_j, g_p, feats, coords = _graphs(type(jmodel).graph_spec(3),
                                          pcls.graph_spec(3), False)
        rng = np.random.default_rng(5)
        labels = np.full(len(feats), 255, np.int32)
        labels[:len(coords)] = rng.integers(0, C_OUT, size=len(coords))
        labels[:len(coords)][rng.random(len(coords)) < 0.1] = 255
        shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                                jax.random.PRNGKey(0), feats, g_j)
        out[name] = dict(g_j=g_j, g_p=g_p, feats=feats, labels=labels,
                         variables=_random_variables(shapes, 0),
                         valid=g_p.levels[0].mask().numpy() > 0)
    return out


def _port_model(name, s, dtype=torch.float32, remat=False):
    _, pcls = _model(name)
    model = pcls(out_channels=C_OUT, device="cpu", dtype=dtype, remat=remat)
    v = s["variables"]
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    return model


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _f32(t):
    return np.asarray(t.to(torch.float32) if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_bf16_forward_matches_jax_bf16(setup, name, train):
    """Logits and features in bf16 (both packages return bf16) against
    JAX's bf16 forward, and the gap to the port's own f32 forward."""
    s = setup[name]
    jmodel, _ = _model(name, dtype="bf16")
    fn = jax.jit(functools.partial(jmodel.apply, train=train, mutable=["batch_stats"])
                 if train else functools.partial(jmodel.apply, train=False))
    want = fn.lower(s["variables"], s["feats"], s["g_j"]).compile(
        compiler_options=FAST_COMPILE)(s["variables"], s["feats"], s["g_j"])
    if train:
        want = want[0]
    feats = torch.from_numpy(s["feats"])
    got, got32 = [], []
    for dtype, out in ((torch.bfloat16, got), (torch.float32, got32)):
        model = _port_model(name, s, dtype)
        model.train(train)
        with torch.no_grad():
            out.extend(model(feats, s["g_p"]))
    v = s["valid"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, i
        err, err32 = _rel(_f32(g)[v], _f32(w)[v]), _rel(_f32(g)[v], _f32(got32[i])[v])
        print(name, train, i, f"vs jax bf16 {err:.2e}, vs port f32 {err32:.2e}")
        assert err < BF16_RTOL, (i, err)
        assert err32 < BF16_VS_F32_RTOL, (i, err32)


def _jax_step(jmodel, s):
    """Loss, params and BN statistics after one jitted JAX train step (CE,
    ignore 255, SGD lr LR, torch semantics)."""
    tx = jax_sgd_torch(LR)
    state = JaxTrainState.create(s["variables"], tx)

    def objective(logits, _feats, b, _key, row_mask):
        return jax_cross_entropy_loss(logits, b.labels, ignore_index=255,
                                      row_mask=row_mask), {}

    from languagegroundedsemseg_tpu.train.step import TrainBatch as JaxTrainBatch

    batch = JaxTrainBatch(feats=s["feats"], labels=s["labels"], graph=s["g_j"])
    step = jax.jit(jax_make_train_step(jmodel, tx, objective))
    key = jax.random.PRNGKey(1)
    new, metrics = step.lower(state, batch, key).compile(
        compiler_options=FAST_COMPILE)(state, batch, key)
    sd = state_dict_from_jax(jax.device_get(new.params), jax.device_get(new.batch_stats))
    return float(metrics["loss"]), {k: v.numpy() for k, v in sd.items()}


def _port_step(model, s):
    """Loss, state dict and gradients after one port train step."""
    opt = sgd_torch(model.parameters(), LR)

    def objective(logits, _feats, b, _gen, row_mask):
        return cross_entropy_loss(logits, b.labels, 255, row_mask=row_mask), {}

    batch = TrainBatch(feats=torch.from_numpy(s["feats"]),
                       labels=torch.from_numpy(s["labels"]), graph=s["g_p"])
    state, metrics = make_train_step(model, opt, objective, device="cpu")(
        TrainState(model, opt), batch)
    assert state.step == 1
    return (metrics["loss"], {k: v.clone() for k, v in model.state_dict().items()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def _stats_and_params_gap(got, want):
    stats = max(_rel(got[k], want[k]) for k in want if k.endswith(("running_mean",
                                                                   "running_var")))
    params = max(_rel(got[k], want[k]) for k in want
                 if not k.endswith(("running_mean", "running_var")))
    return stats, params


@pytest.mark.parametrize("name", ["Res16UNet50"])
def test_bf16_train_step_matches_jax_bf16(setup, name):
    """One SGD step in bf16 from the same weights on the same batch: the
    loss, the BN running statistics and every parameter after the update
    (parameters are f32 in both: the casts' gradients come back f32)."""
    s = setup[name]
    jmodel, _ = _model(name, dtype="bf16")
    want_loss, want = _jax_step(jmodel, s)
    model = _port_model(name, s, torch.bfloat16)
    loss, got, grads = _port_step(model, s)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    loss32, got32, _ = _port_step(_port_model(name, s), s)
    stats, params = _stats_and_params_gap(got, want)
    stats32, params32 = _stats_and_params_gap(got, got32)
    print(name, f"loss {float(loss)} jax {want_loss} f32 {float(loss32)}; "
          f"stats {stats:.2e} ({stats32:.2e} vs f32), params {params:.2e} "
          f"({params32:.2e} vs f32)")
    assert abs(float(loss) - want_loss) <= BF16_RTOL * abs(want_loss)
    assert abs(float(loss) - float(loss32)) <= BF16_VS_F32_RTOL * abs(float(loss32))
    assert stats < BF16_RTOL and stats32 < BF16_VS_F32_RTOL
    assert params < BF16_RTOL and params32 < PARAMS_BF16_VS_F32_RTOL


def _counted(model):
    """Count each stage block's forward calls (the recompute calls it
    again)."""
    calls = [0]
    for blk in model.stage_blocks():
        fwd = blk.forward

        def counted(*a, _fwd=fwd, **kw):
            calls[0] += 1
            return _fwd(*a, **kw)

        blk.forward = counted
    return calls


@pytest.mark.parametrize("name", list(FAMILIES))
def test_remat_step_equals_the_step_without(setup, name):
    """The checkpointed step recomputes every stage block in the backward
    (each block's forward runs twice) and still gives the same loss,
    gradients, parameters and BN running statistics, bit for bit: the
    recompute leaves the running statistics alone."""
    s = setup[name]
    plain, remat = _port_model(name, s), _port_model(name, s, remat=True)
    n_blocks = len(remat.stage_blocks())
    calls_plain, calls_remat = _counted(plain), _counted(remat)
    loss0, sd0, g0 = _port_step(plain, s)
    loss1, sd1, g1 = _port_step(remat, s)
    assert calls_plain[0] == n_blocks and calls_remat[0] == 2 * n_blocks
    assert torch.equal(loss0, loss1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    # the statistics moved, and once: a second momentum step would differ
    before = _port_model(name, s).state_dict()
    assert any(not torch.equal(before[k], sd1[k]) for k in sd1
               if k.endswith("running_mean"))


def test_recomputing_leaves_running_statistics_alone():
    bn = layers.SparseBatchNorm(4, device="cpu")
    x, mask = torch.randn(10, 4), torch.ones(10)
    with layers.recomputing():
        y = bn(x, mask)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(bn.running_var, torch.ones(4))
    assert torch.equal(y, bn(x, mask))
    assert not torch.equal(bn.running_mean, torch.zeros(4))


@pytest.mark.parametrize("name", ["Res16UNet14"])
def test_remat_step_matches_jax_remat(setup, name):
    """The checkpointed f32 step against JAX's ``nn.remat`` step: loss, BN
    running statistics (moved once in both) and parameters."""
    s = setup[name]
    jmodel, _ = _model(name, remat=True)
    want_loss, want = _jax_step(jmodel, s)
    loss, got, _ = _port_step(_port_model(name, s, remat=True), s)
    stats, params = _stats_and_params_gap(got, want)
    print(name, f"loss {float(loss)} jax {want_loss}; stats {stats:.2e}, "
          f"params {params:.2e}")
    assert abs(float(loss) - want_loss) <= F32_RTOL * abs(want_loss)
    assert stats < F32_RTOL and params < F32_RTOL


def test_remat_off_without_grad(setup):
    """Under no_grad (eval forwards) nothing is checkpointed: each block
    runs once."""
    s = setup["Res16UNet14"]
    model = _port_model("Res16UNet14", s, remat=True)
    calls = _counted(model)
    with torch.no_grad():
        model(torch.from_numpy(s["feats"]), s["g_p"])
    assert calls[0] == len(model.stage_blocks())
