"""The port's data parallelism (two gloo ranks, spawned processes, on the
CPU) against the JAX package's two-device ``shard_map`` runs on the
conftest's virtual CPU devices (``make_mesh(2)``).

Rank bodies are top-level functions of this module, so the spawned ranks
import it; it imports torch and the port only, and every JAX import sits
inside a test function. Each spawn starts a gloo group on a ``file://``
store under the test's temporary directory (no port is opened), and every
rank writes its results to a torch file there. Held:
- SyncBN (``SparseBatchNorm`` with a process group): outputs, running
  statistics and the gradients of x, weight and bias against JAX's
  ``SparseBatchNorm(axis_name="data")`` within 1e-5 relative; and two
  ranks equal to one BN over the concatenated rows, which fails without
  the backward all-reduce;
- the collectives against tests/test_collectives_and_nms.py's JAX cases,
  values and gradients;
- the loader: rank k of 2 builds JAX's ``num_devices=2`` batch [k];
- the train step: Res16UNet14A at ``dryrun_multichip``'s shapes against
  JAX's ``shard_train_step``, both on f32 gather paths; and each rank's
  eval logits on its own graph against JAX's on its harmonized shard;
- ``Trainer`` and ``InssegTrainer`` across two ranks, and the CLI's
  refusals.
"""

import contextlib
import datetime
import functools
import glob
import json
import os
import uuid
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

WORLD = 2
# SyncBN and the collectives: f32 sums in another order
BN_RTOL = 1e-5
# the gather-path train step (tests/test_torch_train_step_gather.py)
STEP_RTOL = 1e-4
# eval logits on the gather paths (tests/test_torch_res16unet.py)
LOGITS_RTOL = 1e-4
# insseg losses after two steps from the same weights
INSSEG_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank_main(rank, body, store, out, args):
    """A spawned rank: join the gloo group, run ``body``, save its result."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=300))
    try:
        result = body(rank, out, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(body, out, *args, meanwhile=None):
    """Run ``body(rank, out, *args)`` on WORLD gloo ranks and return their
    results; with ``meanwhile``, also ``meanwhile()``'s, run in this
    process while the ranks run."""
    out = str(out)
    store = os.path.join(out, f"store-{uuid.uuid4().hex}")
    ctx = torch.multiprocessing.spawn(_rank_main, args=(body, store, out, args),
                                      nprocs=WORLD, join=False)
    try:
        mine = meanwhile() if meanwhile is not None else None
    finally:
        while not ctx.join():
            pass
    got = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
           for r in range(WORLD)]
    return got if meanwhile is None else (got, mine)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def gather_paths():
    """The port's window routes declined: every conv takes its f32 gather
    path, as the JAX model does on the CPU (tests/test_torch_trainer.py)."""
    from languagegroundedsemseg_torch.models import layers
    from languagegroundedsemseg_torch.ops import onehot_conv

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(layers, "onehot_window_conv", lambda *a: None))
    stack.enter_context(mock.patch.object(onehot_conv, "_cs_window", lambda *a: (0, 0, 1)))
    return stack


# ---- SyncBN -------------------------------------------------------------


def _bn_data(n=64, c=8):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(WORLD, n, c)) * 2 + 0.5).astype(np.float32)
    mask = (rng.random((WORLD, n)) < 0.8).astype(np.float32)
    mask[1, n // 2:] = 0  # the ranks hold different valid counts
    cot = rng.normal(size=(WORLD, n, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    return x, mask, cot, scale, bias


def _bn_forward_backward(x, mask, cot, scale, bias, group, device="cpu"):
    from languagegroundedsemseg_torch.models.layers import SparseBatchNorm

    bn = SparseBatchNorm(x.shape[-1], device=device, process_group=group)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(device).requires_grad_(True)
    y = bn(xt, torch.from_numpy(mask).to(device))
    (y * torch.from_numpy(cot).to(device)).sum().backward()
    return {"y": y.detach(), "dx": xt.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "mean": bn.running_mean, "var": bn.running_var}


def _bn_rank(rank, _out, data):
    x, mask, cot, scale, bias = data
    return _bn_forward_backward(x[rank], mask[rank], cot[rank], scale, bias,
                                dist.group.WORLD)


def _jax_sync_bn(data):
    """Per-device outputs, stats and gradients of JAX's SyncBN under
    shard_map (each device holds its own copy of scale and bias, so each
    device's gradient is its own contribution, as a rank's is)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from languagegroundedsemseg_tpu.models.layers import SparseBatchNorm as JaxBN
    from languagegroundedsemseg_tpu.parallel.dp import shard_map
    from languagegroundedsemseg_tpu.parallel.mesh import make_mesh

    x, mask, cot, scale, bias = data
    c = x.shape[-1]
    mesh = make_mesh(WORLD)
    bn = JaxBN(axis_name="data")

    def shard(x, m, cot, s, b):
        v = {"params": {"scale": s[0], "bias": b[0]},
             "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
        y, mut = bn.apply(v, x[0], m[0], True, mutable=["batch_stats"])
        st = mut["batch_stats"]
        return (y * cot[0]).sum()[None], y[None], st["mean"][None], st["var"][None]

    smap = shard_map(shard, mesh=mesh, in_specs=(P("data"),) * 5,
                     out_specs=(P("data"),) * 4, check_vma=False)
    s2, b2 = np.stack([scale] * WORLD), np.stack([bias] * WORLD)

    def total(x, s, b):
        return smap(x, mask, cot, s, b)[0].sum()

    _, y, mean, var = jax.jit(smap)(x, mask, cot, s2, b2)
    dx, ds, db = jax.jit(jax.grad(total, argnums=(0, 1, 2)))(x, s2, b2)
    return [{"y": y[k], "dx": dx[k], "dw": ds[k], "db": db[k], "mean": mean[k],
             "var": var[k]} for k in range(WORLD)]


def test_sync_batchnorm_matches_jax(tmp_path):
    data = _bn_data()
    got, want = spawn(_bn_rank, tmp_path, data, meanwhile=lambda: _jax_sync_bn(data))
    for k in range(WORLD):
        for name in ("y", "dx", "dw", "db", "mean", "var"):
            err = _rel(got[k][name].numpy(), np.asarray(want[k][name]))
            assert err <= BN_RTOL, (k, name, err)
    # the statistics are global: both ranks end with the same buffers
    assert torch.equal(got[0]["mean"], got[1]["mean"])
    assert torch.equal(got[0]["var"], got[1]["var"])

    # two ranks == one BN over the concatenated rows (the gradient of x
    # reads the other rank's rows through the statistics' backward)
    x, mask, cot, scale, bias = data
    cat = lambda a: np.concatenate(list(a))  # noqa: E731
    one = _bn_forward_backward(cat(x), cat(mask), cat(cot), scale, bias, None)
    for name in ("y", "dx"):
        err = _rel(torch.cat([g[name] for g in got]).numpy(), one[name].numpy())
        assert err <= BN_RTOL, (name, err)
    for name in ("dw", "db"):
        err = _rel((got[0][name] + got[1][name]).numpy(), one[name].numpy())
        assert err <= BN_RTOL, (name, err)
    for name in ("mean", "var"):
        assert _rel(got[0][name].numpy(), one[name].numpy()) <= BN_RTOL, name


# ---- collectives --------------------------------------------------------


def _collectives_rank(rank, _out, x, ragged):
    from languagegroundedsemseg_torch.parallel.collectives import (
        all_gather_features,
        all_reduce_mean,
        all_reduce_sum,
    )

    group = dist.group.WORLD
    out = {}
    # tests/test_collectives_and_nms.py: gather, and the gradient of the
    # gathered squares' sum (the same value on every rank, / n each)
    xs = torch.from_numpy(x[rank]).requires_grad_(True)
    rows, mask = all_gather_features(xs, group=group)
    ((rows * rows).sum() / WORLD).backward()
    out.update(rows=rows.detach(), mask=mask, gather_grad=xs.grad)
    # ragged: rank 1 holds fewer rows; the padding carries mask 0
    xr = torch.from_numpy(x[rank][:ragged[rank]])
    rows_r, mask_r = all_gather_features(xr, torch.ones(ragged[rank]), group=group)
    out.update(ragged_rows=rows_r, ragged_mask=mask_r)
    # pmean / psum of a per-rank scalar field, with psum's transpose
    v = torch.tensor([[float(rank)]], requires_grad=True)
    out["mean"] = all_reduce_mean(v, group).detach()
    tree = all_reduce_sum({"a": v, "b": v * 2}, group)
    out["sum"] = torch.stack([tree["a"], tree["b"]]).detach()
    (all_reduce_sum(v, group) * (rank + 1)).sum().backward()
    out["sum_grad"] = v.grad
    return out


def _jax_collectives(x):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from languagegroundedsemseg_tpu.parallel.collectives import (
        all_gather_features,
        all_reduce_mean,
        all_reduce_sum,
    )
    from languagegroundedsemseg_tpu.parallel.dp import shard_map
    from languagegroundedsemseg_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(WORLD)
    flat = x.reshape(-1, x.shape[-1])

    def smap(fn, out_specs=P("data")):
        return shard_map(fn, mesh=mesh, in_specs=P("data"), out_specs=out_specs,
                         check_vma=False)

    gathered = smap(lambda s: all_gather_features(s, "data")[None])(flat)

    def loss(x):
        return smap(lambda s: jnp.sum(all_gather_features(s, "data") ** 2)[None]
                    / WORLD)(x).sum()

    field = np.arange(WORLD, dtype=np.float32)[:, None]

    def psum_loss(v):
        def inner(s):
            r = jax.lax.axis_index("data")
            return (all_reduce_sum(s, "data") * (r + 1)).sum()[None]
        return smap(inner)(v).sum()

    return {"rows": np.asarray(gathered),
            "gather_grad": np.asarray(jax.grad(loss)(flat)),
            "mean": np.asarray(smap(lambda s: all_reduce_mean(s, "data"))(field)),
            "sum": np.asarray(smap(lambda s: all_reduce_sum(s, "data"))(field)),
            "sum_grad": np.asarray(jax.grad(psum_loss)(field))}


def test_collectives_match_jax(tmp_path):
    cap, f = 16, 4
    x = np.arange(WORLD * cap * f, dtype=np.float32).reshape(WORLD, cap, f)
    ragged = (cap, cap - 5)
    got, want = spawn(_collectives_rank, tmp_path, x, ragged,
                      meanwhile=lambda: _jax_collectives(x))
    for k, g in enumerate(got):
        np.testing.assert_array_equal(g["rows"].numpy(), want["rows"][k])
        assert g["mask"].tolist() == [1.0] * (WORLD * cap)
        np.testing.assert_allclose(g["gather_grad"].numpy(),
                                   want["gather_grad"][k * cap:(k + 1) * cap],
                                   rtol=BN_RTOL)
        np.testing.assert_array_equal(g["gather_grad"].numpy(), 2 * x[k])
        # ragged: padded to the largest count; dropping the padding gives
        # the ranks' rows in rank order
        m = g["ragged_mask"].numpy() > 0
        assert g["ragged_rows"].shape == (WORLD * cap, f)
        np.testing.assert_array_equal(
            g["ragged_rows"].numpy()[m],
            np.concatenate([x[r][:ragged[r]] for r in range(WORLD)]))
        assert not g["ragged_rows"].numpy()[~m].any()
        np.testing.assert_allclose(g["mean"].numpy(), want["mean"][k:k + 1])
        np.testing.assert_allclose(g["sum"].numpy()[0], want["sum"][k:k + 1])
        np.testing.assert_allclose(g["sum"].numpy()[1], 2 * want["sum"][k:k + 1])
        # psum's transpose is a psum: 1 + 2 = 3 on both ranks
        np.testing.assert_allclose(g["sum_grad"].numpy(), want["sum_grad"][k:k + 1])
        assert float(g["sum_grad"]) == 3.0


def _identity_rank(rank, _out):
    """Every collective is the identity with no group."""
    from languagegroundedsemseg_torch.parallel.collectives import (
        all_gather_features,
        all_reduce_mean,
        all_reduce_sum,
        barrier,
    )
    from languagegroundedsemseg_torch.parallel.mesh import make_mesh

    v = torch.arange(3.0)
    rows, mask = all_gather_features(v[:, None])
    barrier(None)
    mesh = make_mesh(0, "cpu")  # the existing group's world
    return {"same": bool(torch.equal(all_reduce_sum(v), v)
                         and torch.equal(all_reduce_mean({"v": v})["v"], v)
                         and torch.equal(rows[:, 0], v) and bool(mask.all())),
            "world": mesh.world, "rank": mesh.rank, "owns": mesh.owns_group}


def test_mesh_and_identity_collectives(tmp_path):
    from languagegroundedsemseg_torch.parallel.mesh import make_mesh

    got = spawn(_identity_rank, tmp_path)
    assert [g["same"] for g in got] == [True, True]
    assert [(g["world"], g["rank"], g["owns"]) for g in got] == [(2, 0, False), (2, 1, False)]
    mesh = make_mesh(0, "cpu")  # no torchrun, no group: one rank
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(2, "cpu")


# ---- loader -------------------------------------------------------------


def test_loader_rank_k_builds_jax_shard_k():
    """Rank k of 2 yields the JAX ``num_devices=2`` loader's batch [k],
    over two epochs; both report the same length."""
    from languagegroundedsemseg_tpu.config import Config as JaxConfig
    from languagegroundedsemseg_tpu.data.loader import (
        initialize_data_loader as jax_initialize_data_loader,
    )
    from languagegroundedsemseg_tpu.data.synthetic_dataset import (
        SyntheticTiny20Dataset as JaxTiny20,
    )
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.data.loader import initialize_data_loader
    from languagegroundedsemseg_torch.data.synthetic_dataset import SyntheticTiny20Dataset

    def loader(init, config, cls, **kw):
        c = config(batch_size=1, ignore_label=255, fixed_capacity=4096)
        return init(cls, c, phase="train", num_workers=1, shuffle=True, repeat=False,
                    augment_data=True, batch_size=1,
                    limit_numpoints=c.train_limit_numpoints, ship_coords=False,
                    num_devices=WORLD, **kw)

    jl = loader(jax_initialize_data_loader, JaxConfig, JaxTiny20)
    ranks = [loader(initialize_data_loader, Config, SyntheticTiny20Dataset,
                    device="cpu", rank=k) for k in range(WORLD)]
    assert len(jl) == len(ranks[0]) == len(ranks[1]) == 2
    for _epoch in range(2):
        want = list(jl)
        got = [list(r) for r in ranks]
        assert len(want) == len(got[0]) == len(got[1]) == 2
        for i, w in enumerate(want):
            for k in range(WORLD):
                g = got[k][i]
                np.testing.assert_array_equal(g.feats.numpy(), np.asarray(w.feats[k]))
                np.testing.assert_array_equal(g.labels.numpy(), np.asarray(w.labels[k]))
                np.testing.assert_array_equal(g.extras["scene_idx"].numpy(),
                                              np.asarray(w.extras["scene_idx"][k]))
    assert [r.epoch for r in ranks] == [jl.epoch] * WORLD == [2, 2]


# ---- the train step -----------------------------------------------------

N_CLASSES, LR = 20, 1e-2


def _dryrun_shards():
    """``dryrun_multichip``'s shards: 2 scenes x 1,500 points each, labels
    folded into its 20 classes (255 kept)."""
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene

    rng = np.random.default_rng(0)
    shards = []
    for _ in range(WORLD):
        scenes = []
        for _ in range(2):
            c, f, lab = voxelize_scene(rng, 1500)
            scenes.append((c, f, np.where(lab == 255, 255, lab % N_CLASSES).astype(np.int32)))
        shards.append(scenes)
    return shards


def _port_objective(logits, _features, batch, _generator, row_mask):
    from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss

    return cross_entropy_loss(logits, batch.labels, 255, row_mask=row_mask), {}


def _step_variant(rank, shards, state_dict, relu_free):
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.models.layers import convert_sync_batchnorm
    from languagegroundedsemseg_torch.models.res16unet import (
        Res16UNet14A,
        res16unet_graph_spec,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_eval_step, make_train_step

    group = dist.group.WORLD
    batch = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=2048).build(
        shards[rank], device="cpu")
    model = Res16UNet14A(out_channels=N_CLASSES, device="cpu")
    model.load_state_dict(state_dict)
    convert_sync_batchnorm(model, group)
    out = {}
    stack = contextlib.ExitStack()
    stack.enter_context(gather_paths())
    if relu_free:
        stack.enter_context(mock.patch.object(torch, "relu", lambda x: x))
    with stack:
        if not relu_free:
            logits, _ = make_eval_step(model, device="cpu")(batch)
            out["logits"] = logits.clone()
            out["valid"] = batch.graph.levels[0].valid.clone()
        opt = sgd_torch(model.parameters(), LR)
        state, metrics = make_train_step(model, opt, _port_objective, device="cpu",
                                         group=group)(TrainState(model, opt), batch)
    out.update(loss=metrics["loss"], grad_norm=metrics["grad_norm"], steps=state.step,
               grads={n: p.grad.clone() for n, p in model.named_parameters()},
               after={n: t.clone() for n, t in model.state_dict().items()})
    return out


def _step_rank(rank, _out, shards, state_dict):
    return {v: _step_variant(rank, shards, state_dict, v == "relu_free")
            for v in ("model", "relu_free")}



def _spans_rank(rank, _out, shards):
    """One data-parallel step of each rank under the profiler: the phase
    spans on the thread that ran ``lgs.step``, in order."""
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.models.layers import convert_sync_batchnorm
    from languagegroundedsemseg_torch.models.res16unet import (
        Res16UNet14A,
        res16unet_graph_spec,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_train_step

    group = dist.group.WORLD
    batch = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=2048).build(
        shards[rank], device="cpu")
    model = Res16UNet14A(out_channels=N_CLASSES, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    convert_sync_batchnorm(model, group)
    opt = sgd_torch(model.parameters(), LR)
    step = make_train_step(model, opt, _port_objective, device="cpu", group=group)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(TrainState(model, opt), batch)
    ranges = sorted((e.start_ns(), e.name(), e.start_thread_id())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("lgs.step"))
    (tid,) = [t for _, n, t in ranges if n == "lgs.step"]
    return [n for _, n, t in ranges if t == tid and n != "lgs.step"]


def test_dp_step_spans_the_allreduce_on_each_rank(tmp_path):
    got = spawn(_spans_rank, tmp_path, _dryrun_shards())
    assert got == [["lgs.step.prep", "lgs.step.forward", "lgs.step.loss",
                    "lgs.step.backward", "lgs.step.allreduce",
                    "lgs.step.update"]] * WORLD


def _jax_shards(shards):
    """JAX's batch of each shard and random weights of Res16UNet14A."""
    from languagegroundedsemseg_tpu.data.batching import BatchBuilder
    from languagegroundedsemseg_tpu.models.res16unet import Res16UNet14A, res16unet_graph_spec
    from test_torch_res16unet import _random_variables, _shapes

    builder = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=2048)
    batches = [builder.build(s) for s in shards]
    return batches, _random_variables(
        _shapes(Res16UNet14A(out_channels=N_CLASSES), batches[0]), 0)


def _jax_dp_steps(batches, variables):
    """JAX's two-device step (``dryrun_multichip``: Res16UNet14A,
    ``sgd_torch(1e-2)``, CE) from ``variables``, for the model as it is
    and for its ReLU-free copy, and the eval logits of each harmonized
    shard. The three programs compile at once, in threads."""
    from concurrent.futures import ThreadPoolExecutor

    import flax.linen
    import jax

    from languagegroundedsemseg_tpu.losses.classification import cross_entropy_loss
    from languagegroundedsemseg_tpu.models.res16unet import Res16UNet14A
    from languagegroundedsemseg_tpu.parallel.dp import (
        shard_eval_step,
        shard_train_step,
        stack_batches,
    )
    from languagegroundedsemseg_tpu.parallel.mesh import make_mesh
    from languagegroundedsemseg_tpu.train.solvers import sgd_torch
    from languagegroundedsemseg_tpu.train.state import TrainState
    from languagegroundedsemseg_tpu.train.step import make_train_step
    from test_torch_cli import FAST_COMPILE

    valid = [np.asarray(b.graph.levels[0].valid) for b in batches]
    stacked = stack_batches(batches)
    mesh = make_mesh(WORLD)
    model = Res16UNet14A(out_channels=N_CLASSES, axis_name="data")
    eval_model = Res16UNet14A(out_channels=N_CLASSES)
    tx = sgd_torch(LR)
    state = TrainState.create(variables, tx)
    key = jax.random.PRNGKey(1)

    def objective(logits, _feats, b, _key, row_mask):
        return cross_entropy_loss(logits, b.labels, ignore_index=255, row_mask=row_mask), {}

    p_step = shard_train_step(make_train_step(model, tx, objective, axis_name="data"), mesh)
    p_eval = shard_eval_step(lambda st, b: eval_model.apply(
        {"params": st.params, "batch_stats": st.batch_stats},
        b.feats, b.graph, train=False)[0], mesh)
    lowered = {"model": p_step.lower(state, stacked, key),
               "eval": p_eval.lower(state, stacked)}
    with mock.patch.object(flax.linen, "relu", lambda x: x):
        p_free = shard_train_step(make_train_step(model, tx, objective, axis_name="data"),
                                  mesh)
        lowered["relu_free"] = p_free.lower(state, stacked, key)
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(
            lambda low: low.compile(compiler_options=FAST_COMPILE), lowered.values())))
    out = {"logits": np.asarray(compiled["eval"](state, stacked)), "valid": valid}
    wd = 1e-4
    for v in ("model", "relu_free"):
        new, metrics = compiled[v](state, stacked, key)
        momentum = new.opt_state[1].momentum  # grad + weight_decay * param
        out[v] = dict(
            loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
            grads=jax.device_get(jax.tree_util.tree_map(
                lambda m, p: m - wd * p, momentum, variables["params"])),
            params=jax.device_get(new.params), stats=jax.device_get(new.batch_stats))
    return out


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """(JAX's results, each rank's results, JAX's gradients and state after
    the step by the port's names) for the model and its ReLU-free copy;
    the ranks run while JAX compiles."""
    from languagegroundedsemseg_torch.convert import state_dict_from_jax

    shards = _dryrun_shards()
    batches, variables = _jax_shards(shards)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    got, j = spawn(_step_rank, tmp_path_factory.mktemp("dp_step"), shards, sd,
                   meanwhile=lambda: _jax_dp_steps(batches, variables))
    names = {}
    for v in ("model", "relu_free"):
        names[v] = (
            {n: t.numpy() for n, t in state_dict_from_jax(j[v]["grads"], {}).items()},
            {n: t.numpy() for n, t in
             state_dict_from_jax(j[v]["params"], j[v]["stats"]).items()})
        for g in got:
            assert g[v]["steps"] == 1
            assert set(g[v]["grads"]) == set(names[v][0])
            assert set(g[v]["after"]) == set(names[v][1])
        # the ranks made the same update from the averaged gradients
        for n, t in got[0][v]["after"].items():
            assert torch.equal(t, got[1][v]["after"][n]), n
        assert float(got[0][v]["loss"]) == float(got[1][v]["loss"])
    return j, got, names


def _worst(got, want):
    return max(((n, _rel(got[n].numpy(), w)) for n, w in want.items()),
               key=lambda kv: kv[1])


def test_dp_train_step_matches_jax_shard_train_step(dp_steps):
    """The model as it is: loss, BN running statistics and parameters after
    the step (gather paths, f32 to f32: 1e-4, as the one-device step test);
    and each rank's eval logits on its own graph equal JAX's on its
    harmonized shard, so harmonizing (``stack_batches``) is not needed."""
    j, got, names = dp_steps
    want, have = j["model"], got[0]["model"]
    assert abs(float(have["loss"]) - want["loss"]) <= STEP_RTOL * abs(want["loss"])
    for kind in ("params", "stats"):
        w = {n: a for n, a in names["model"][1].items()
             if ("running" in n) == (kind == "stats")}
        worst = _worst(have["after"], w)
        print(f"dp step {kind} after: worst {worst}")  # shown by -rP
        assert worst[1] <= STEP_RTOL, worst
    for k in range(WORLD):
        valid = j["valid"][k] > 0
        assert np.array_equal(got[k]["model"]["valid"].numpy() > 0, valid)
        err = _rel(got[k]["model"]["logits"].numpy()[valid], j["logits"][k][valid])
        assert err <= LOGITS_RTOL, (k, err)


def test_dp_train_step_gradients_match_jax_relu_free(dp_steps):
    """The same step with every ReLU the identity in both packages: the
    averaged gradients and their norm, the loss and the parameters after
    the step within 1e-4."""
    j, got, names = dp_steps
    want, have = j["relu_free"], got[0]["relu_free"]
    worst = _worst(have["grads"], names["relu_free"][0])
    print(f"dp step grads (no ReLU): worst {worst}")  # shown by -rP
    assert worst[1] <= STEP_RTOL, worst
    assert abs(float(have["grad_norm"]) - want["grad_norm"]) <= STEP_RTOL * want["grad_norm"]
    assert abs(float(have["loss"]) - want["loss"]) <= STEP_RTOL * abs(want["loss"])
    worst = _worst(have["after"], names["relu_free"][1])
    assert worst[1] <= STEP_RTOL, worst


# ---- the trainers and the CLI -------------------------------------------


def _trainer_kw(log_dir, **kw):
    kw = dict(ignore_label=255, fixed_capacity=2048, dataset="SyntheticTiny20Dataset",
              model="Res16UNet14A", batch_size=1, val_batch_size=1, num_workers=1,
              num_val_workers=1, num_devices=WORLD, lr=0.1, tensorboard=False,
              log_dir=str(log_dir), **kw)
    return kw


def _trainer_rank(rank, out, log_dir):
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.train import checkpoints
    from languagegroundedsemseg_torch.train.trainer import Trainer

    saved = []
    real = checkpoints.save_checkpoint

    def recording(path, *a, **k):
        saved.append(os.path.basename(path))
        return real(path, *a, **k)

    with mock.patch.object(checkpoints, "save_checkpoint", recording):
        tr = Trainer(Config(**_trainer_kw(log_dir, max_epoch=1)), device="cpu")
        tr.fit()
        val = tr.validate()
        tr.close()
        res = {"world": tr.world, "rank": tr.rank, "steps": tr.state.step,
               "per_epoch": len(tr.train_loader), "val": val,
               "after": {n: t.clone() for n, t in tr.model.state_dict().items()},
               "wrote_log": tr._log_f is not None}
        tr2 = Trainer(Config(**_trainer_kw(str(log_dir) + "_resumed", max_epoch=2,
                                           resume=str(log_dir))), device="cpu")
        tr2.fit()
        tr2.close()
    res.update(saved=saved, resumed_steps=tr2.state.step,
               resumed_after={n: t.clone() for n, t in tr2.model.state_dict().items()})
    return res


def test_trainer_across_two_ranks(tmp_path):
    """One epoch of Trainer on two ranks: equal parameters and buffers on
    both, the same all-reduced validation, checkpoints and the log written
    by rank 0 only; then a resume on both ranks to epoch 2."""
    log_dir = tmp_path / "run"
    got = spawn(_trainer_rank, tmp_path, str(log_dir))
    assert [(g["world"], g["rank"]) for g in got] == [(2, 0), (2, 1)]
    assert got[0]["per_epoch"] == 2  # 4 scenes / (batch 1 x 2 ranks)
    assert [g["steps"] for g in got] == [2, 2]
    for n, t in got[0]["after"].items():
        assert torch.equal(t, got[1]["after"][n]), n
    for n, t in got[0]["resumed_after"].items():
        assert torch.equal(t, got[1]["resumed_after"][n]), n
    assert got[0]["val"].keys() == got[1]["val"].keys()
    for k, v in got[0]["val"].items():
        assert np.array_equal(v, got[1]["val"][k], equal_nan=True), k
    assert 0.0 <= got[0]["val"]["val_miou"] <= 1.0
    assert [g["resumed_steps"] for g in got] == [4, 4]
    assert got[0]["saved"] and not got[1]["saved"]
    assert [g["wrote_log"] for g in got] == [True, False]
    with open(log_dir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs if r["phase"] == "epoch"] == [0]
    assert glob.glob(str(log_dir / "last_step=2.ckpt"))
    assert glob.glob(str(tmp_path / "run_resumed" / "last_step=4.ckpt"))


def _insseg_rank(rank, out, kw, state_dict):
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.insseg.trainer import InssegTrainer

    tr = InssegTrainer(Config(**kw), device="cpu")
    tr.model.load_state_dict(state_dict)
    with gather_paths():
        tr.fit(max_steps=2, log_every=1)
    tr.close()
    return {"after": {n: t.clone() for n, t in tr.model.state_dict().items()},
            "steps": tr.state.step}


def test_insseg_trainer_across_two_ranks_matches_jax(tmp_path):
    """Two steps of InssegTrainer on two ranks against JAX's
    ``InssegTrainer(num_devices=2)`` from the same weights: each step's
    loss and parts (rank 0's log against JAX's); equal parameters on both
    ranks."""
    import jax

    from languagegroundedsemseg_tpu.config import Config as JaxConfig
    from languagegroundedsemseg_tpu.insseg import trainer as j_trainer
    from languagegroundedsemseg_tpu.train import trainer as jax_train_trainer
    from languagegroundedsemseg_torch.convert import state_dict_from_jax
    from test_torch_res16unet import _random_variables

    kw = dict(ignore_label=255, fixed_capacity=2048, dataset="SyntheticInstanceDataset",
              model="InstanceRes16UNet14A", batch_size=1, val_batch_size=1,
              num_workers=1, lr=0.05, num_devices=WORLD)

    def init(init_fn, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(init_fn, **kwargs), *args)
        return _random_variables(shapes, 0)

    with mock.patch.object(jax_train_trainer, "init_on_cpu", init):
        tr_j = j_trainer.InssegTrainer(JaxConfig(log_dir=str(tmp_path / "jax"), **kw))
    sd = state_dict_from_jax(tr_j.state.params, tr_j.state.batch_stats)
    got, _ = spawn(_insseg_rank, tmp_path, dict(log_dir=str(tmp_path / "port"), **kw), sd,
                   meanwhile=lambda: tr_j.fit(max_steps=2, log_every=1))
    assert [g["steps"] for g in got] == [2, 2]
    for n, t in got[0]["after"].items():
        assert torch.equal(t, got[1]["after"][n]), n

    def train_recs(path):
        with open(path / "metrics.jsonl") as f:
            return [r for r in map(json.loads, f) if r["phase"] == "train"]

    want, have = train_recs(tmp_path / "jax"), train_recs(tmp_path / "port")
    assert [r["step"] for r in have] == [r["step"] for r in want] == [1, 2]
    for h, w in zip(have, want):
        print({k: (h[k], w[k]) for k in w if k not in ("step", "phase")})  # -rP
        for k in ("semantic_loss", "offset_norm_loss", "offset_dir_loss", "loss"):
            assert abs(h[k] - w[k]) <= INSSEG_RTOL * abs(w[k]), (h["step"], k)


def test_cli_refuses_ranks_without_torchrun(tmp_path, monkeypatch):
    """``--num_devices 2`` without torchrun's environment raises naming
    torchrun; so does a value that differs from WORLD_SIZE."""
    from languagegroundedsemseg_torch.cli.main import main

    argv = ["--dataset", "SyntheticTiny20Dataset", "--model", "Res16UNet14A",
            "--log_dir", str(tmp_path / "cli")]
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        main(argv + ["--num_devices", "2"], device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="one of 2 rank"):
        main(argv + ["--num_devices", "3"], device="cpu")
    assert not dist.is_initialized()
