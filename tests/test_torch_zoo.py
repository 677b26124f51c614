"""The rest of the model zoo: the PyTorch port against the JAX package.

Every family of the zoo on a few hundred voxels, at narrowed PLANES /
LAYERS so that each runs in a few seconds on the CPU: the same graph (the
numpy host build of both packages on the same coords), the same random
flax weights carried by ``convert.state_dict_from_jax`` (non-trivial norm
statistics), one eval-mode and one train-mode forward each. At these sizes
no map carries a window annotation, so both packages run their f32 gather
paths: the outputs agree up to the order of f32 sums, held to the
tolerance of tests/test_torch_cli.py's variant forwards (1e-4 relative
max error). The layers (norms, SE, pools) are held with their input and
weight gradients; also the registry, the 4D graph, the trainer's refusal
of the families whose graph spec its loaders do not build, and
``expected_launches`` of chip_smoke.py on a routed graph of each family.
"""

import contextlib
import functools
import inspect
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.models import available_models as jax_available
from languagegroundedsemseg_tpu.models import load_model as jax_load_model
from languagegroundedsemseg_tpu.models import blocks as jblocks
from languagegroundedsemseg_tpu.models import layers as jlayers
from languagegroundedsemseg_tpu.models import classifier as jclassifier
from languagegroundedsemseg_tpu.models import pointnet2 as jpointnet2
from languagegroundedsemseg_tpu.ops import segment as jsegment
from languagegroundedsemseg_tpu.ops import spconv as jspconv
from languagegroundedsemseg_tpu.sparse import graph_host as jgh
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.models import available_models, load_model
from languagegroundedsemseg_torch.models import blocks, classifier, layers, pointnet2
from languagegroundedsemseg_torch.ops import segment, spconv
from languagegroundedsemseg_torch.sparse import graph_host as gh
from oracles import make_cloud
from test_torch_graph import assert_tree_equal
from test_torch_res16unet import _random_variables
from test_torch_trainer import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# f32 gather paths on both sides: the same sums in another order
RTOL = 1e-4
# layer-level ops: a handful of f32 sums
LAYER_RTOL = 1e-5

NARROW = {"PLANES": (8, 8, 16, 16, 16, 16, 8, 8), "LAYERS": (1,) * 8}
# name -> (JAX field overrides = the port subclass's class attributes,
# 4-D cloud?)
FAMILIES = {
    "Res16UNet50": (dict(NARROW), False),
    "Res16UNet101": (dict(NARROW, LAYERS=(1, 1, 1, 2, 1, 1, 1, 1)), False),
    "ResUNet14": (dict(PLANES=(8, 16, 16, 16, 16, 8, 8), INIT_DIM=8), False),
    "MinkUNetHyper14INBN": (dict(PLANES=(8, 16, 16, 16, 16, 8, 8), INIT_DIM=8),
                            False),
    "ResNet14": (dict(PLANES=(8, 16, 16, 16), INIT_DIM=8), False),
    "ResNet50": (dict(PLANES=(4, 8, 8, 8), INIT_DIM=8, LAYERS=(1, 2, 1, 1)), False),
    "STRes16UNet14A": (dict(NARROW), True),
    "STResTesseract16UNet18A": (dict(NARROW), True),
    "Res16UNet34CR_Proj": (dict(NARROW), False),
    "Res16UNet34DPaired": (dict(NARROW), False),
    "Res16UNet34Dv2": (dict(NARROW), False),
    "Res16UNet34Dv3": (dict(NARROW), False),
    # SE's bottleneck is channels // 16 wide: 32 channels at least
    "Res16UNet14": (dict(NARROW, PLANES=(32,) * 8, BLOCK="se_basic"), False),
}
C_OUT = 7
CAP = 384


def _cloud_4d(rng, n=300, extent=10, frames=3, batch=2):
    pts = rng.integers(-extent, extent, size=(n * 2, 3))
    t = rng.integers(0, frames, size=(n * 2, 1))
    b = rng.integers(0, batch, size=(n * 2, 1))
    coords = np.concatenate([b, pts, t], axis=1).astype(np.int32)
    return np.unique(coords, axis=0)[:n]


def _cloud(four_d, seed=0):
    """(rng, sorted coords) of the test cloud: 250 voxels of two 3-D scenes
    or 300 of two 4-D (3-frame) ones."""
    rng = np.random.default_rng(seed)
    coords = _cloud_4d(rng) if four_d else make_cloud(rng, n=250)
    return rng, coords[np.argsort(gh.pack_keys(coords), kind="stable")]


def _caps(spec):
    return gh.default_capacities(CAP, spec.num_levels, ratios=[1.0] * spec.num_levels)


def _graphs(spec_j, spec_p, four_d, seed=0):
    """(JAX graph, port graph on the CPU, feats, coords) of one cloud."""
    rng, coords = _cloud(four_d, seed)
    g_j = jgh.build_graph(coords, spec_j, _caps(spec_p))
    g_p = gh.build_graph(coords, spec_p, _caps(spec_p))
    feats = np.zeros((CAP, 3), np.float32)
    feats[:len(coords)] = rng.normal(size=(len(coords), 3))
    return g_j, g_p.to("cpu"), feats, coords


def _narrowed(name, fields):
    """The JAX model with ``fields`` and the port class with them as class
    attributes (JAX's NORM_TYPE / HYPER fields are the port's norm_type /
    hyper, set by the registered class)."""
    jcls, pcls = jax_load_model(name), load_model(name)
    attrs = {k: v for k, v in fields.items()}
    return jcls(out_channels=C_OUT, **fields), type(name, (pcls,), attrs)


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _eval_and_train(model, variables, feats, graph, **kw):
    """JAX's eval-mode output and train-mode output and batch statistics,
    in one XLA compile (LLVM's expensive passes buy nothing for one call)."""
    def both(v, f, g):
        return (model.apply(v, f, g, train=False, **kw),
                model.apply(v, f, g, train=True, mutable=["batch_stats"], **kw))

    args = (variables, feats, graph)
    fn = jax.jit(both).lower(*args).compile(compiler_options=FAST_COMPILE)
    return fn(*args)


def _leaves(out):
    """Every array of a (possibly nested) model output, in order."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _leaves(o)]
    return [] if out is None else [out]


def _first(out):
    """The first array of a (possibly nested) model output."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


@pytest.fixture(scope="module")
def graphs():
    cache = {}

    def get(model_cls_j, model_cls_p, four_d):
        key = (model_cls_p.graph_spec.__func__, four_d)
        if key not in cache:
            cache[key] = _graphs(model_cls_j.graph_spec(3), model_cls_p.graph_spec(3),
                                 four_d)
        return cache[key]

    return get


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_matches_jax(graphs, name):
    """One eval-mode and one train-mode forward of each family: every array
    of the port's outputs (and, in train mode, its updated norm statistics)
    against
    JAX's, weights carried from the same random flax trees."""
    fields, four_d = FAMILIES[name]
    jmodel, pcls = _narrowed(name, fields)
    g_j, g_p, feats, _ = graphs(type(jmodel), pcls, four_d)
    kw, pkw, valid2 = {}, {}, None
    if name == "Res16UNet34CR_Proj":
        anchors = np.random.default_rng(3).normal(size=(C_OUT, 512)).astype(np.float32)
        kw, pkw = {"anchors": anchors}, {"anchors": torch.from_numpy(anchors)}
    elif name == "Res16UNet34DPaired":
        # the second view: another cloud through the shared backbone
        g_j2, g_p2, feats2, _ = _graphs(type(jmodel).graph_spec(3), pcls.graph_spec(3),
                                        four_d, seed=1)
        kw = {"feats2": feats2, "graph2": g_j2}
        pkw = {"feats2": torch.from_numpy(feats2), "graph2": g_p2}
        valid2 = g_p2.levels[0].mask().numpy() > 0
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False, **kw),
                            jax.random.PRNGKey(0), feats, g_j)
    variables = _random_variables(shapes, 0)
    model = pcls(out_channels=C_OUT, device="cpu")
    sd = state_dict_from_jax(variables["params"], variables.get("batch_stats", {}))
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    valid = g_p.levels[-1 if name.startswith("ResNet") else 0].mask().numpy() > 0

    want_eval, (want_train, mut) = _eval_and_train(jmodel, variables, feats, g_j,
                                                   **kw)
    model.eval()
    with torch.no_grad():
        got_eval = _leaves(model(torch.from_numpy(feats), g_p, **pkw))
    model.train()
    with torch.no_grad():
        got_train = _leaves(model(torch.from_numpy(feats), g_p, **pkw))
    errs = {}
    for mode, got, want in (("eval", got_eval, _leaves(want_eval)),
                            ("train", got_train, _leaves(want_train))):
        assert len(got) == len(want), (mode, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape, (mode, i, g.shape, w.shape)
            # rows of a level's capacity: only the valid ones hold voxels
            v = valid2 if valid2 is not None and i == 1 else valid
            rows = v if g.shape[0] == len(v) else slice(None)
            errs[f"{mode}{i}"] = _rel_max(g[rows], w[rows])
    if mut.get("batch_stats"):
        stats = state_dict_from_jax({}, mut["batch_stats"])
        after = model.state_dict()
        errs["stats"] = max(_rel_max(after[k].numpy(), v.numpy()) for k, v in stats.items())
    print(name, errs)
    assert all(e < RTOL for e in errs.values()), (name, errs)


# ---- layers and blocks, with their gradients -------------------------------

def _layer_inputs(seed=0, n=200, c=32, batch=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c)).astype(np.float32) * 2 + 0.5
    bidx = np.sort(rng.integers(0, batch, size=n)).astype(np.int32)
    mask = (rng.random(n) > 0.15).astype(np.float32)
    return x, bidx, mask


def _vjp_both(jmod, jargs, pmod, pargs, x, train=True, seed=1):
    """Forward and the input and weight gradients of ``jmod`` (flax, called
    as jmod(x, *jargs, train=train) where it takes ``train``) and ``pmod``
    (the port) on the same input ``x`` and random weights, under the same
    random cotangent. Returns each relative max error."""
    takes_train = "train" in inspect.signature(type(jmod).__call__).parameters
    jkw = {"train": train} if takes_train else {}
    jargs_x = lambda xx: (xx, *jargs)  # noqa: E731
    shapes = jax.eval_shape(functools.partial(jmod.init, **jkw),
                            jax.random.PRNGKey(0), *jargs_x(x))
    variables = _random_variables(shapes, seed)
    for k, v in state_dict_from_jax(variables["params"],
                                    variables.get("batch_stats", {})).items():
        assert k in pmod.state_dict(), k
    pmod.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables.get("batch_stats", {})))
    pmod.train(train)
    mutable = ["batch_stats"] if "batch_stats" in variables else False

    def f(xx, params):
        v = dict(variables, params=params)
        out = jmod.apply(v, *jargs_x(xx), mutable=mutable, **jkw)
        return out[0] if mutable else out

    def fwd_bwd(xx, params, ct):
        out, vjp = jax.vjp(f, xx, params)
        return (out, *vjp(ct))

    shape = jax.eval_shape(f, x, variables["params"]).shape
    ct = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    want, gx_want, gp_want = jax.jit(fwd_bwd)(x, variables["params"], ct)

    xt = torch.from_numpy(x).requires_grad_(True)
    got = pmod(xt, *pargs)
    got.backward(torch.from_numpy(ct))
    errs = {"out": _rel_max(got.detach().numpy(), want),
            "dx": _rel_max(xt.grad.numpy(), gx_want)}
    # the weight gradients against the largest of them: an instance norm
    # followed by a batch norm (instance_batch) has weight and bias
    # gradients that vanish (the batch norm undoes its shift and scale), so
    # both packages give rounding noise there
    grads = {n: p.grad.numpy() for n, p in pmod.named_parameters()}
    want_g = {k: v.numpy() for k, v in state_dict_from_jax(gp_want, {}).items()}
    assert want_g.keys() == grads.keys()
    scale = max(np.abs(v).max() for v in want_g.values())
    errs["dparams"] = max(np.abs(grads[k] - v).max() for k, v in want_g.items()) / scale
    return errs


def _norm_cases():
    x, bidx, mask = _layer_inputs()
    jb, jm = jnp.asarray(bidx), jnp.asarray(mask)
    tb, tm = torch.from_numpy(bidx), torch.from_numpy(mask)
    return x, {
        "instance": (jlayers.SparseInstanceNorm(max_batch=4), (jb, jm),
                     layers.SparseInstanceNorm(32, max_batch=4, device="cpu"), (tb, tm)),
        "layer": (jlayers.SparseLayerNorm(max_batch=4), (jb, jm),
                  layers.SparseLayerNorm(32, max_batch=4, device="cpu"), (tb, tm)),
        "se": (jlayers.SELayer(32, 16, 4), (jb, jm),
               layers.SELayer(32, 16, 4, device="cpu"), (tb, tm)),
        "norm_instance_batch": (
            jlayers.Norm("instance_batch", max_batch=4), (jb, jm),
            layers.Norm(32, device="cpu", norm_type="instance_batch", max_batch=4),
            (tm, tb)),
    }


@pytest.mark.parametrize("name", ["instance", "layer", "se", "norm_instance_batch"])
def test_norms_and_se_match_jax_with_gradients(name):
    x, cases = _norm_cases()
    jmod, jargs, pmod, pargs = cases[name]
    errs = _vjp_both(jmod, jargs, pmod, pargs, x)
    print(name, errs)
    assert all(e < LAYER_RTOL for e in errs.values()), errs


@pytest.mark.parametrize("block", ["bottleneck", "se_basic"])
def test_blocks_match_jax_with_gradients(graphs, block):
    """Bottleneck (expansion 4, a downsample shortcut) and SEBasicBlock on
    the L0 k3 map, train mode, instance + batch norms."""
    jcls = jax_load_model("Res16UNet14")
    g_j, g_p, _, _ = graphs(jcls, load_model("Res16UNet14"), False)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(CAP, 16)).astype(np.float32)
    mask, bidx = g_p.levels[0].mask(), g_p.levels[0].batch_idx
    jmod = jblocks.BLOCKS[block](planes=32, lvl=0, map_name="l0.k3",
                                 norm_type="instance_batch", max_batch=4)
    pmod = blocks.BLOCKS[block](16, 32, "l0.k3", 27, device="cpu",
                                norm_type="instance_batch", max_batch=4)
    errs = _vjp_both(jmod, (g_j,), pmod, (g_p, mask, bidx), x)
    print(block, errs)
    assert all(e < LAYER_RTOL for e in errs.values()), errs


@pytest.mark.parametrize("pool", ["avg", "sum", "max"])
def test_pools_match_jax_with_gradients(graphs, pool):
    """The pools over ResNet's L0 -> L1 k2 map, with the input gradient."""
    jcls, pcls = jax_load_model("ResNet14"), load_model("ResNet14")
    g_j, g_p, _, _ = graphs(jcls, pcls, False)
    idx = g_p.maps["down0"].idx
    x = np.random.default_rng(4).normal(size=(CAP, 5)).astype(np.float32)
    jfn = getattr(jspconv, f"sparse_{pool}_pool")
    pfn = getattr(spconv, f"sparse_{pool}_pool")
    want, vjp = jax.vjp(lambda xx: jfn(xx, jnp.asarray(idx.numpy())), jnp.asarray(x))
    ct = np.random.default_rng(5).normal(size=want.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pfn(xt, idx)
    got.backward(torch.from_numpy(ct))
    assert _rel_max(got.detach().numpy(), want) < LAYER_RTOL
    assert _rel_max(xt.grad.numpy(), vjp(jnp.asarray(ct))[0]) < LAYER_RTOL


def test_segment_ops_match_jax():
    x, bidx, mask = _layer_inputs(c=6)
    got = segment.batch_max(torch.from_numpy(x), torch.from_numpy(bidx),
                            torch.from_numpy(mask), 5)
    want = jsegment.batch_max(x, bidx, mask, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isinf(got[3:]).all()  # items without rows
    for g, w in zip(segment.masked_mean_var(torch.from_numpy(x), torch.from_numpy(mask)),
                    jsegment.masked_mean_var(x, mask)):
        assert _rel_max(g.numpy(), w) < LAYER_RTOL


def test_classifier_and_attribute_models_match_jax():
    x = np.random.default_rng(6).normal(size=(40, 24)).astype(np.float32)
    for jmod, pmod in ((jclassifier.ClassifierNet(out_channels=9),
                        classifier.ClassifierNet(24, 9, device="cpu")),
                       (jclassifier.AttributeFittingModel(feature_dim=24, num_attributes=3),
                        classifier.AttributeFittingModel(24, 3, device="cpu"))):
        variables = _random_variables(
            jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x), 0)
        pmod.load_state_dict(state_dict_from_jax(variables["params"], {}))
        want = _first(jmod.apply(variables, x))
        with torch.no_grad():
            got = _first(pmod(torch.from_numpy(x)))
        assert got.shape == want.shape
        assert _rel_max(got.numpy(), want) < LAYER_RTOL


def test_pointnet2_modules_match_jax():
    """SA (FPS, ball query, grouping, shared MLP, max pool) then FP
    (3-NN interpolation back to the dense set), masked input rows."""
    rng = np.random.default_rng(7)
    xyz = rng.random((300, 3)).astype(np.float32)
    feats = rng.normal(size=(300, 4)).astype(np.float32)
    mask = (rng.random(300) > 0.1).astype(np.float32)
    jsa = jpointnet2.SetAbstraction(npoint=32, radius=0.3, nsample=8, mlp=(16, 24))
    jfp = jpointnet2.FeaturePropagation(mlp=(12,))
    psa = pointnet2.SetAbstraction(32, 0.3, 8, (16, 24), in_channels=4, device="cpu")
    pfp = pointnet2.FeaturePropagation(24 + 4, (12,), device="cpu")

    v_sa = _random_variables(jax.eval_shape(jsa.init, jax.random.PRNGKey(0),
                                            xyz, feats, mask), 0)
    new_xyz, new_f, new_m = jsa.apply(v_sa, xyz, feats, mask)
    v_fp = _random_variables(jax.eval_shape(jfp.init, jax.random.PRNGKey(0), xyz, feats,
                                            new_xyz, new_f, new_m), 1)
    want = jfp.apply(v_fp, xyz, feats, new_xyz, new_f, new_m)
    psa.load_state_dict(state_dict_from_jax(v_sa["params"], {}))
    pfp.load_state_dict(state_dict_from_jax(v_fp["params"], {}))
    t = torch.from_numpy
    with torch.no_grad():
        p_xyz, p_f, p_m = psa(t(xyz), t(feats), t(mask))
        got = pfp(t(xyz), t(feats), p_xyz, p_f, p_m)
    np.testing.assert_array_equal(p_xyz.numpy(), np.asarray(new_xyz))
    np.testing.assert_array_equal(p_m.numpy(), np.asarray(new_m))
    assert _rel_max(p_f.numpy(), new_f) < LAYER_RTOL
    assert _rel_max(got.numpy(), want) < LAYER_RTOL


# ---- registry, 4D graph, trainer refusal -----------------------------------

def test_registry_equals_jax():
    """Every JAX name, with the widths its instances have (for the ST
    diamonds, STRes16UNetBase's: see models/res16unet.py)."""
    assert available_models() == jax_available()
    for name in available_models():
        jm = jax_load_model(name)()
        cls = load_model(name)
        for attr in ("BLOCK", "PLANES", "LAYERS", "INIT_DIM"):
            if hasattr(jm, attr):
                assert getattr(cls, attr) == getattr(jm, attr), (name, attr)
        if hasattr(jm, "norm_type"):
            assert cls.NORM_TYPE == jm.norm_type, name
        if hasattr(jm, "strip_final_relu"):
            assert cls.STRIP_FINAL_RELU == jm.strip_final_relu, name
        if hasattr(jm, "hyper"):
            assert cls.HYPER == jm.hyper, name
        if hasattr(type(jm), "graph_spec"):
            assert repr(cls.graph_spec(3)) == repr(type(jm).graph_spec(3)), name


def test_4d_host_graph_equals_jax():
    """The ST spec's 4-D graph (spatial-cube x temporal-cross maps, spatial
    striding), built by both packages' numpy builders: every leaf
    array-equal."""
    rng = np.random.default_rng(0)
    coords = _cloud_4d(rng)
    coords = coords[np.argsort(gh.pack_keys(coords), kind="stable")]
    for name in ("STRes16UNet14A", "STResTesseract16UNet18A"):
        spec = load_model(name).graph_spec(3)
        assert spec.d == 4
        caps = gh.default_capacities(CAP, 5, ratios=[1.0] * 5)
        want = jgh.build_graph(coords, jax_load_model(name).graph_spec(3), caps)
        got = gh.build_graph(coords, spec, caps)
        assert_tree_equal(want, got, name)


@pytest.mark.parametrize("model", ["ResNet14", "STRes16UNet14A"])
def test_trainer_refuses_other_graph_specs(tmp_path, model):
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.train.trainer import Trainer

    cfg = Config(dataset="SyntheticTiny20Dataset", model=model,
                 log_dir=str(tmp_path / "run"), num_devices=1)
    with pytest.raises(ValueError, match=model):
        Trainer(cfg, device="cpu")


# ---- chip_smoke.expected_launches on routed graphs --------------------------

LAUNCH_FAMILIES = ["Res16UNet50", "ResUNet14", "MinkUNetHyper14INBN",
                   "Res16UNet34Dv3", "Res16UNet34CR_Proj", "Res16UNet14",
                   "ResNet14", "STRes16UNet14A", "BilateralCRF"]


@contextlib.contextmanager
def _counted_plain_kernels():
    """Each kernel wrapper's plain version (what the wrapper runs on a CPU
    tensor) counted as a launch."""
    from languagegroundedsemseg_torch.ops import onehot_conv as oc

    counts = {"sel_fwd": 0, "csum": 0, "dw": 0}

    def counted(name, fn):
        def run(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return run

    with contextlib.ExitStack() as stack:
        for name, ref in (("sel_fwd", "sel_fwd_reference"),
                          ("csum", "csum_reference"), ("dw", "dw_fused_reference")):
            stack.enter_context(mock.patch.object(oc, ref, counted(name, getattr(oc, ref))))
        yield counts


def _routed_batch(pcls, four_d):
    """A batch whose k3 and down maps carry window annotations (3,000
    points at capacity 4,096, as tests/test_torch_cli.py builds it); the 4D
    cloud of the ST families through the numpy builder."""
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.train.step import TrainBatch

    if four_d:
        rng, coords = _cloud(True)
        spec = pcls.graph_spec(3)
        g = gh.build_graph(coords, spec, _caps(spec)).to("cpu")
        feats = torch.from_numpy(rng.normal(size=(CAP, 3)).astype(np.float32))
        return TrainBatch(feats, torch.zeros(CAP, dtype=torch.int32), g)
    scenes = [voxelize_scene(np.random.default_rng(0), 3000)]
    return BatchBuilder(spec=pcls.graph_spec(3), fixed_capacity=4096).build(
        scenes, device="cpu")


@pytest.mark.parametrize("name", LAUNCH_FAMILIES)
def test_expected_launches_on_routed_graphs(name):
    """An eval forward and an SGD train step of each family (narrowed),
    each kernel's plain version counted: the counts equal
    ``chip_smoke.expected_launches``; the Res16UNet-spec families reach
    all three kernels, ResNet and the ST variants none."""
    import chip_smoke
    from languagegroundedsemseg_torch.models import load_wrapper
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import make_eval_step, make_train_step

    base = "Res16UNet14A" if name == "BilateralCRF" else name
    fields, four_d = FAMILIES.get(base, ({}, False))
    pcls = type(base, (load_model(base),), dict(fields))
    model = pcls(out_channels=C_OUT, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    if name == "BilateralCRF":
        model = load_wrapper(name)(model, C_OUT, iterations=2, device="cpu")
    batch = _routed_batch(pcls, four_d)

    def objective(out, *_):
        return (_first(out) ** 2).mean(), {}

    want_eval = chip_smoke.expected_launches(model, batch.graph)
    want_train = chip_smoke.expected_launches(model, batch.graph, train=True)
    with _counted_plain_kernels() as counts:
        make_eval_step(model, device="cpu")(batch)
        got_eval = dict(counts)
        opt = sgd_torch(model.parameters(), 0.01)
        make_train_step(model, opt, objective, device="cpu")(TrainState(model, opt), batch)
        got_train = {k: counts[k] - got_eval[k] for k in counts}
    print(name, got_eval, got_train)
    assert got_eval == want_eval and got_train == want_train
    if name.startswith(("ResNet", "ST")):
        assert not any(got_train.values())
    else:
        assert min(got_train.values()) > 0


def test_reference_import_takes_what_jax_takes():
    """A reference-format state dict of Res16UNet50 (Bottleneck's norm3),
    MinkUNetHyper14INBN (instance + batch norms) and 34CR_Proj (the
    projection layer), named as the port names its tensors: the port's ME
    import (``torch_to_port_state_dict``) loads and skips the names the JAX
    package's (``torch_to_flax_params``) does."""
    from languagegroundedsemseg_tpu.train.checkpoints import torch_to_flax_params
    from languagegroundedsemseg_torch.train.checkpoints import torch_to_port_state_dict

    for name in ("Res16UNet50", "MinkUNetHyper14INBN", "Res16UNet34CR_Proj"):
        fields, _ = FAMILIES[name]
        jmodel, pcls = _narrowed(name, fields)
        g_j, _, feats, _ = _graphs(type(jmodel).graph_spec(3), pcls.graph_spec(3), False)
        kw = ({"anchors": np.zeros((C_OUT, 512), np.float32)}
              if name == "Res16UNet34CR_Proj" else {})
        shapes = jax.eval_shape(functools.partial(jmodel.init, train=False, **kw),
                                jax.random.PRNGKey(0), feats, g_j)
        variables = _random_variables(shapes, 0)
        model = pcls(out_channels=C_OUT, device="cpu")
        ref = {k: v.numpy() + 1.0 for k, v in model.state_dict().items()}
        _, _, skipped_j = torch_to_flax_params(ref, variables["params"],
                                               variables["batch_stats"])
        _, skipped_p = torch_to_port_state_dict(ref, model.state_dict())
        assert sorted(skipped_p) == sorted(skipped_j), name
        assert any("inorm" in k for k in skipped_p) == (name == "MinkUNetHyper14INBN")
