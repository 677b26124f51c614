"""The CRF wrappers and the sparse products: the PyTorch port against the
JAX package.

- ``MeanFieldCRF`` forward and its gradients (unaries, compatibility).
- ``BilateralCRF`` around a narrowed Res16UNet in train mode under both
  coin values (JAX's coin read from its output, the port's passed in), and
  ``TrilateralCRF``'s time column on a 4-D graph.
- ``sparse_mm_padded`` and the COO product, with gradients.
- Two SGD steps of ``cli.main`` with ``--wrapper_type BilateralCRF``
  against the JAX trainer from the same weights on the same batches, the
  port's coins set to the ones JAX drew (recorded by a callback in its
  jitted step): the losses and the CRF's compatibility after the steps.

Both packages run f32 gather paths (no map of these sizes carries a window
in JAX on the CPU; the port's window routes are declined in the trainer
run), so outputs agree up to the order of f32 sums.
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

from languagegroundedsemseg_tpu.models import crf as jcrf
from languagegroundedsemseg_tpu.models import load_model as jax_load_model
from languagegroundedsemseg_tpu.ops import sparse_mm as jsparse_mm
from languagegroundedsemseg_tpu.sparse import graph_host as jgh
from languagegroundedsemseg_torch.cli.main import main
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.models import crf, load_model, load_wrapper
from languagegroundedsemseg_torch.ops import sparse_mm
from languagegroundedsemseg_torch.sparse import graph_host as gh
from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.train.checkpoints import port_to_torch_state_dict
from languagegroundedsemseg_torch.train.trainer import Trainer
from test_torch_res16unet import _random_variables
from languagegroundedsemseg_tpu.config import Config as JaxConfig
from languagegroundedsemseg_tpu.train import trainer as jax_trainer
from test_torch_trainer import _kw, gather_paths, one_torch_thread  # noqa: F401
from test_torch_zoo import FAMILIES, _caps, _cloud, _rel_max

# relative L2: f32 sums in another order (a softmax and a gaussian per
# neighbor, 10 mean-field iterations; the compatibility's gradient sums
# N x 16 x 10 products)
RTOL = 1e-5


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)
C = 5


def _crf_inputs(seed=0, n=300):
    rng = np.random.default_rng(seed)
    unaries = rng.normal(size=(n, C)).astype(np.float32) * 2
    xyz = rng.integers(0, 12, size=(n, 3)).astype(np.float32)
    colors = rng.uniform(0, 255, size=(n, 3)).astype(np.float32)
    mask = (rng.random(n) > 0.1).astype(np.float32)
    time = rng.integers(0, 3, size=n).astype(np.float32)
    return unaries, xyz, colors, mask, time


@pytest.mark.parametrize("temporal", [False, True])
def test_mean_field_matches_jax_with_gradients(temporal):
    unaries, xyz, colors, mask, time = _crf_inputs()
    t = time if temporal else None
    jmod = jcrf.MeanFieldCRF(num_classes=C)
    compat = np.random.default_rng(1).normal(size=(C, C)).astype(np.float32) * 0.3
    params = {"compatibility": jnp.asarray(compat)}

    def f(u, p):
        return jmod.apply({"params": p}, u, xyz, colors, mask, time=t)

    want, vjp = jax.vjp(f, jnp.asarray(unaries), params)
    ct = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    gu_want, gp_want = vjp(jnp.asarray(ct))

    pmod = crf.MeanFieldCRF(C, device="cpu")
    pmod.load_state_dict({"compatibility": torch.from_numpy(compat)})
    u = torch.from_numpy(unaries).requires_grad_(True)
    tt = None if t is None else torch.from_numpy(t)
    got = pmod(u, torch.from_numpy(xyz), torch.from_numpy(colors),
               torch.from_numpy(mask), time=tt)
    got.backward(torch.from_numpy(ct))
    errs = (_rel_l2(got.detach().numpy(), want), _rel_l2(u.grad.numpy(), gu_want),
            _rel_l2(pmod.compatibility.grad.numpy(), gp_want["compatibility"]))
    print(errs)
    assert max(errs) < RTOL, errs


def test_knn_blocks_equal_the_whole(monkeypatch):
    """The CRF's blocked kNN ranks each query row exactly as one stable
    sort of the whole (M, N) distance matrix does (ties on these integer
    points to the lower index)."""
    from languagegroundedsemseg_torch.ops import points

    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.integers(0, 6, size=(500, 6)).astype(np.float32))
    mask = torch.from_numpy((rng.random(500) > 0.2).astype(np.float32))
    monkeypatch.setattr(points, "KNN_BLOCK_ROWS", 64)
    d1, i1 = points.knn(pts, pts, 17, mask)
    d2 = torch.where(mask[None, :] > 0, points._sq_dists(pts, pts),
                     torch.tensor(float("inf")))
    d2, i0 = torch.sort(d2, dim=1, stable=True)
    d0 = torch.sqrt(torch.clamp(d2[:, :17], min=0.0))
    assert torch.equal(d0, d1) and torch.equal(i0[:, :17].to(torch.int32), i1)


def _wrapper_pair(name, base, four_d, iterations=3):
    """A JAX wrapper around the narrowed ``base`` and the port's, on one
    cloud's graph (coords shipped), weights carried."""
    fields, _ = FAMILIES.get(base, ({"PLANES": (8, 8, 16, 16, 16, 16, 8, 8),
                                    "LAYERS": (1,) * 8}, False))
    jbase = jax_load_model(base)(out_channels=C, **fields)
    pcls = type(base, (load_model(base),), dict(fields))
    jw = getattr(jcrf, name)(base=jbase, num_classes=C, iterations=iterations)
    rng, coords = _cloud(four_d)
    spec_p = pcls.graph_spec(3)
    g_j = jgh.build_graph(coords, type(jbase).graph_spec(3), _caps(spec_p))
    g_p = gh.build_graph(coords, spec_p, _caps(spec_p)).to("cpu")
    feats = np.zeros((g_p.levels[0].capacity, 3), np.float32)
    feats[:len(coords)] = rng.uniform(-0.5, 0.5, size=(len(coords), 3))
    shapes = jax.eval_shape(functools.partial(jw.init, train=False),
                            jax.random.PRNGKey(0), feats, g_j)
    variables = _random_variables(shapes, 0)
    pw = load_wrapper(name)(pcls(out_channels=C, device="cpu"), C,
                            iterations=iterations, device="cpu")
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert sd.keys() == pw.state_dict().keys()
    pw.load_state_dict(sd)
    valid = g_p.levels[0].mask().numpy() > 0
    return jw, variables, g_j, pw, g_p, feats, valid


def test_bilateral_wrapper_under_both_coins():
    """Train mode: JAX draws its coin from the 'crf' rng; keys are tried
    until one coin of each value shows (the output is the base's logits
    or not), and the port, its coin passed in, must give that output."""
    jw, variables, g_j, pw, g_p, feats, valid = _wrapper_pair(
        "BilateralCRF", "Res16UNet14A", False)

    @jax.jit
    def train_fwd(v, f, g, key):
        (out, _), _ = jw.apply(v, f, g, train=True, mutable=["batch_stats"],
                               rngs={"crf": key})
        (plain, _), _ = jw.apply(v, f, g, train=True, apply_crf=False,
                                 mutable=["batch_stats"])
        return out, plain

    seen = {}
    for k in range(16):
        out, plain = map(np.asarray, train_fwd(variables, feats, g_j,
                                                jax.random.PRNGKey(k)))
        seen.setdefault(not np.array_equal(out, plain), out)
        if len(seen) == 2:
            break
    assert set(seen) == {True, False}
    pw.train()
    for coin, want in seen.items():
        pw.load_state_dict(state_dict_from_jax(variables["params"],
                                               variables["batch_stats"]))
        gen = torch.Generator().manual_seed(0)
        drawn = []

        def draw(_gen, c=coin):
            drawn.append(c)
            return torch.tensor(c)

        with mock.patch.object(crf.Wrapper, "draw_coin", staticmethod(draw)):
            with torch.no_grad():
                got, _ = pw(torch.from_numpy(feats), g_p, generator=gen)
        assert drawn == [coin]
        err = _rel_max(got.numpy()[valid], want[valid])
        print(coin, err)
        assert err < 1e-4, (coin, err)


def test_trilateral_wrapper_reads_the_time_column():
    """Eval mode (the coin is always on) of TrilateralCRF around the ST
    Res16UNet on a 4-D cloud: the kNN space takes coords[:, 4]."""
    jw, variables, g_j, pw, g_p, feats, valid = _wrapper_pair(
        "TrilateralCRF", "STRes16UNet14A", True)
    assert g_p.levels[0].coords.shape[1] == 5
    want, _ = jax.jit(functools.partial(jw.apply, train=False))(variables, feats, g_j)
    pw.eval()
    with torch.no_grad():
        got, _ = pw(torch.from_numpy(feats), g_p)
        # the time column changes the answer
        bi = crf.Wrapper.forward.__get__(pw)
        with mock.patch.object(type(pw), "USE_TEMPORAL", False):
            other, _ = bi(torch.from_numpy(feats), g_p)
    err = _rel_max(got.numpy()[valid], np.asarray(want)[valid])
    assert err < 1e-4, err
    assert not torch.equal(got, other)


def test_sparse_mm_matches_jax_with_gradients():
    rng = np.random.default_rng(4)
    nnz, n_rows, k, f = 60, 9, 11, 4
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    rows[::7] = -1  # padding
    cols = rng.integers(0, k, nnz).astype(np.int32)
    cols[::7] = -1
    vals = rng.normal(size=nnz).astype(np.float32)
    dense = rng.normal(size=(k, f)).astype(np.float32)
    ct = rng.normal(size=(n_rows, f)).astype(np.float32)

    want, vjp = jax.vjp(lambda v, d: jsparse_mm.sparse_mm_padded(rows, cols, v, n_rows, d),
                        jnp.asarray(vals), jnp.asarray(dense))
    gv_want, gd_want = vjp(jnp.asarray(ct))
    v = torch.from_numpy(vals).requires_grad_(True)
    d = torch.from_numpy(dense).requires_grad_(True)
    got = sparse_mm.sparse_mm_padded(torch.from_numpy(rows), torch.from_numpy(cols),
                                     v, n_rows, d)
    got.backward(torch.from_numpy(ct))
    assert _rel_l2(got.detach().numpy(), want) < RTOL
    assert _rel_l2(v.grad.numpy(), gv_want) < RTOL
    assert _rel_l2(d.grad.numpy(), gd_want) < RTOL

    keep = rows >= 0
    idx = np.stack([rows[keep], cols[keep]], 1)
    want = jsparse_mm.sparse_mm_bcoo(vals[keep], idx, (n_rows, k), dense)
    got = sparse_mm.sparse_mm_coo(torch.from_numpy(vals[keep]), torch.from_numpy(idx),
                                  (n_rows, k), torch.from_numpy(dense))
    assert _rel_l2(got.numpy(), want) < RTOL


# seed 4: JAX's coins at steps 0 and 1 are True, False
CLI_KW = dict(balanced_category_sampling=False, stat_freq=1, lr=0.05, seed=4,
              wrapper_type="BilateralCRF", wrapper_lr=0.5, meanfield_iterations=3)


def _argv(kw, log_dir, weights):
    argv = []
    for k, v in _kw(**kw).items():
        argv += [f"--{k}", str(v)]
    return argv + ["--max_epoch", "1", "--log_dir", log_dir, "--weights", weights]


def test_cli_with_the_crf_tracks_jax(tmp_path):
    """Two SGD steps of the JAX trainer and of the port's cli.main from the
    same weights on the same batches, the port's coins JAX's. The first
    step's loss agrees within 1e-5 relative; the second (after one update)
    within 1e-4; the compatibility after the two updates (the CRF's group at
    wrapper_lr = 10 x lr) within 1e-4 relative max error."""
    coins = []
    real = jax.random.bernoulli

    def recorded(key, *a, **k):
        c = real(key, *a, **k)
        jax.debug.callback(lambda v: coins.append(bool(v)), c)
        return c

    def init(init_fn, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(init_fn, **kwargs), *args)
        return _random_variables(shapes, 0)

    cfg = JaxConfig(**_kw(log_dir=str(tmp_path / "jax"), **CLI_KW))
    with mock.patch.object(jax_trainer, "init_on_cpu", init):
        tr_j = jax_trainer.Trainer(cfg)
    weights = str(tmp_path / "init.ckpt")
    torch.save({"model": state_dict_from_jax(tr_j.state.params,
                                             tr_j.state.batch_stats)}, weights)
    # the losses and the parameters are compared, JAX's validation is not
    with mock.patch.object(jax.random, "bernoulli", recorded), \
            mock.patch.object(tr_j, "validate", lambda **_: {"val_miou": 0.0}):
        tr_j.fit(max_epochs=1, max_steps_per_epoch=2)
    lj = [json.loads(line)["loss"] for line in open(os.path.join(tr_j.log_dir, "metrics.jsonl"))
          if json.loads(line)["phase"] == "train"]
    assert len(coins) == 2

    drawn = iter(coins)
    port_coins = []

    def draw(_gen):
        c = next(drawn)
        port_coins.append(c)
        return torch.tensor(c)

    log_dir = str(tmp_path / "port")
    with gather_paths(), mock.patch.object(crf.Wrapper, "draw_coin", staticmethod(draw)):
        main(_argv(CLI_KW, log_dir, weights), device="cpu")
    recs = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    lp = [r["loss"] for r in recs if r["phase"] == "train"]
    (ckpt,) = glob.glob(os.path.join(log_dir, "last_step=2.ckpt"))
    got = torch.load(ckpt, weights_only=True)["model"]["crf.compatibility"].numpy()
    want = np.asarray(tr_j.state.params["MeanFieldCRF_0"]["compatibility"])
    start = np.asarray(torch.load(weights, weights_only=True)["model"]["crf.compatibility"])
    print(f"coins {coins}\njax {lj}\nport {lp}\ncompat moved {np.abs(want - start).max()}")
    assert port_coins == coins == [True, False]
    assert abs(lp[0] - lj[0]) <= 1e-5 * abs(lj[0])
    assert abs(lp[1] - lj[1]) <= 1e-4 * abs(lj[1])
    assert np.abs(want - start).max() > 0
    assert _rel_max(got - start, want - start) < 1e-4


def test_weights_for_inner_model_load_into_the_base(tmp_path):
    """--weights_for_inner_model: a reference file of the bare model loads
    into the CRF wrapper's base (JAX targets the 'base' subtree); without
    the flag its names match nothing of the wrapper and every tensor is
    skipped."""
    src = load_model("Res16UNet14A")(out_channels=20, device="cpu",
                                     generator=torch.Generator().manual_seed(1234))
    template = {k: np.zeros(tuple(v.shape), np.float32)
                for k, v in src.state_dict().items()}
    template["final.kernel"] = template["final.kernel"][None]
    ref, missing = port_to_torch_state_dict(src.state_dict(), template)
    assert not missing
    path = str(tmp_path / "bare.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in ref.items()}}, path)

    kw = _kw(wrapper_type="BilateralCRF", weights=path)
    tr = Trainer(Config(**kw, weights_for_inner_model=True,
                        log_dir=str(tmp_path / "inner")), device="cpu")
    assert tr.num_labels == 20
    got = tr.model.base.state_dict()
    for k, v in src.state_dict().items():
        assert torch.equal(got[k], v), k
    tr.close()

    tr = Trainer(Config(**kw, log_dir=str(tmp_path / "outer")), device="cpu")
    assert not torch.equal(tr.model.base.state_dict()["conv0p1s1.kernel"],
                           src.state_dict()["conv0p1s1.kernel"])
    tr.close()
