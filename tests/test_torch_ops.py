"""Sparse conv ops of the PyTorch port (CPU) against the JAX package's.

Both packages build the graph from the same coordinates with their own
builders (array-equal, tests/test_torch_graph.py) and get the same numpy
inputs. The selector and child-sum convs run bf16 projection GEMMs on both
sides, rounded by two different backends: <= 2e-2 of max |ref|, the
tolerance of tests/test_onehot_conv.py:91 (JAX runs its Pallas kernels in
interpret mode). The f32 ops (masked shift, flat gather, transpose child
sum, pointwise, segment means) differ only in sum order: <= 1e-5 of max
|ref|.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from languagegroundedsemseg_tpu.ops import msconv as jax_msconv
from languagegroundedsemseg_tpu.ops import onehot_conv as jax_oh
from languagegroundedsemseg_tpu.ops import segment as jax_segment
from languagegroundedsemseg_tpu.ops import spconv as jax_spconv
from languagegroundedsemseg_tpu.sparse import graph_host as jax_gh
from languagegroundedsemseg_tpu.sparse.offsets import ConvKind as JaxConvKind
from languagegroundedsemseg_torch.ops import msconv, onehot_conv, segment, spconv
from languagegroundedsemseg_torch.sparse import graph_host as gh
from languagegroundedsemseg_torch.sparse.offsets import ConvKind
from oracles import make_cloud

CAP = 4096
BF16_RTOL = 2e-2
F32_RTOL = 1e-5


def _specs(down=False):
    """The same GraphSpec in each package (each with its own enums)."""
    maps = {"k3": (0, 0, dict(kernel_size=3), dict(fuse_width=3))}
    if down:
        maps["down0"] = (0, 1, dict(kernel_size=2, stride=2),
                         dict(companion="up1"))
        maps["up1"] = (1, 0, dict(kernel_size=2, stride=2, transpose=True),
                       dict(companion="down0"))
    n = 2 if down else 1
    port = gh.GraphSpec(n, {k: gh.MapSpec(a, b, ConvKind(**c), **kw)
                            for k, (a, b, c, kw) in maps.items()})
    ref = jax_gh.GraphSpec(n, {k: jax_gh.MapSpec(a, b, JaxConvKind(**c), **kw)
                               for k, (a, b, c, kw) in maps.items()})
    return port, ref


def _graphs(seed, down=False, caps=(CAP,), validate=True, n=3000):
    """(rng, JAX graph, port graph on the CPU) from the same coords."""
    rng = np.random.default_rng(seed)
    coords = make_cloud(rng, n=n, extent=40)
    coords = coords[np.argsort(gh.pack_keys(coords), kind="stable")]
    port_spec, ref_spec = _specs(down)
    kw = dict(drop_redundant=False, validate=validate)
    ref = jax_gh.build_graph(coords, ref_spec, caps, **kw)
    port = gh.build_graph(coords, port_spec, caps, **kw).to("cpu")
    return rng, ref, port


def _port_replace(pm, **arrays):
    return pm.replace(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                         else v for k, v in arrays.items()})


def _route_anchors_to_ov(m, rng, frac=0.05):
    """An equivalent MaskedShiftMap with ``frac`` of its (int32) anchors
    moved into the overflow COO (guarded in ``anchors``), so the ov paths
    run. Returns the replaced arrays."""
    anchors = np.asarray(m.anchors).copy()
    n_cols, cap = anchors.shape
    assert np.asarray(m.ov_off)[-1] == 0  # start from an empty COO
    pick = (anchors < cap) & (rng.random(anchors.shape) < frac)
    entries = jax_gh._route_bad(anchors, pick)
    ov_in, ov_out, ov_off, ov_seg = jax_gh._pack_ov(entries, n_cols, cap, cap)
    return dict(anchors=anchors, ov_in=ov_in, ov_out=ov_out, ov_off=ov_off,
                ov_seg=ov_seg)


def _shift_cs_windows(m, cap_in, shift=128):
    """An equivalent ChildSumMap whose windows start ``shift`` rows later:
    the overflow COO becomes exactly the children outside the new windows
    (as the builder defines it), so the kernel and the COO split the work
    differently and the f32 COO path runs."""
    win, tile, ng, k = m.win, m.tile, m.n_groups, m.num_slots
    ws = np.minimum(np.asarray(m.wstart).astype(np.int64) + shift,
                    cap_in - win) & ~np.int64(127)
    parent, kslot = np.asarray(m.parent), np.asarray(m.kslot)
    i = np.flatnonzero(kslot < k).astype(np.int64)
    o, slot = parent[i].astype(np.int64), kslot[i].astype(np.int64)
    w0 = ws[(o // tile) * ng + slot // (k // ng)]
    bad = (i < w0) | (i >= w0 + win)
    ov_in, ov_out, ov_off, ov_seg = jax_gh._pack_ov(
        (slot[bad], o[bad], i[bad]), k, 0, m.out_capacity, guard_in=cap_in,
        guard_out=m.out_capacity)
    return dict(wstart=ws.astype(np.int32), ov_in=ov_in, ov_out=ov_out,
                ov_off=ov_off, ov_seg=ov_seg)


def _feats(rng, graph, cap, c):
    x = np.zeros((cap, c), np.float32)
    n = int(graph.levels[0].num)
    x[:n] = rng.normal(size=(n, c))
    return x


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("cin,cout,ov", [(16, 32, False), (96, 96, False),
                                         (16, 20, True)])
def test_onehot_window_conv_matches_jax(cin, cout, ov):
    """ov=True also routes anchors into the COO the selector path serves
    from the projection table (and pads 20 output channels to 24)."""
    rng, ref, port = _graphs(1)
    jm, pm = ref.gmaps["k3"], port.gmaps["k3"]
    assert pm.tile > 0
    if ov:
        arrays = _route_anchors_to_ov(jm, rng)
        jm, pm = jm.replace(**arrays), _port_replace(pm, **arrays)
    x = _feats(rng, ref, CAP, cin)
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    b = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    want = jax_oh.onehot_window_conv(jnp.asarray(x), jnp.asarray(w), jm,
                                     jnp.asarray(b), interpret=True)
    with torch.no_grad():
        got = onehot_conv.onehot_window_conv(
            torch.from_numpy(x), torch.from_numpy(w), pm, torch.from_numpy(b))
    assert got.shape == (CAP, cout) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= BF16_RTOL


@pytest.mark.parametrize("n_groups", [1, 2])
def test_child_sum_conv_matches_jax(n_groups):
    rng, ref, port = _graphs(7 if n_groups == 1 else 11, down=True,
                             caps=(4096, 2048), n=2600)
    jm, pm = ref.gmaps["down0"], port.gmaps["down0"]
    if n_groups == 2:
        pin = (2, 128, 1024)
        jm = jax_gh._try_child_sum_map(np.asarray(ref.maps["down0"].idx),
                                       4096, pin_tilewin=pin)
        pm = gh._try_child_sum_map(port.maps["down0"].idx.numpy(), 4096,
                                   pin_tilewin=pin).to("cpu")
    assert pm.tile > 0 and pm.n_groups == n_groups
    arrays = _shift_cs_windows(jm, 4096)
    jm, pm = jm.replace(**arrays), _port_replace(pm, **arrays)
    assert pm.ov_in.shape[0] > 0  # the f32 overflow COO is exercised
    x = _feats(rng, ref, 4096, 16)
    x *= np.asarray(ref.gmaps["k3"].mc)[:, None]
    w = (rng.normal(size=(8, 16, 24)) * 0.2).astype(np.float32)
    want = jax_oh.child_sum_conv(jnp.asarray(x), jnp.asarray(w), jm,
                                 interpret=True)
    with torch.no_grad():
        got = onehot_conv.child_sum_conv(torch.from_numpy(x),
                                         torch.from_numpy(w), pm)
    assert got.shape == (2048, 24)
    assert _rel(got.numpy(), want) <= BF16_RTOL


def test_child_sum_scatter_form_matches_jax():
    """Without a window annotation both packages take the f32 scatter."""
    rng, ref, port = _graphs(5, down=True, caps=(4096, 2048), n=2600)
    jm = ref.gmaps["down0"].replace(tile=0, win=0)
    pm = port.gmaps["down0"].replace(tile=0, win=0)
    x = _feats(rng, ref, 4096, 16)
    w = (rng.normal(size=(8, 16, 24)) * 0.2).astype(np.float32)
    want = jax_oh.child_sum_conv(jnp.asarray(x), jnp.asarray(w), jm)
    got = onehot_conv.child_sum_conv(torch.from_numpy(x), torch.from_numpy(w),
                                     pm)
    assert _rel(got.numpy(), want) <= F32_RTOL


@pytest.mark.parametrize("wire", ["int32", "int16", "ov"])
def test_masked_shift_conv_matches_jax(wire):
    """f32 masked shift: absolute anchors, the production int16 anchor
    deltas (validate=False), and anchors routed into the overflow COO."""
    rng, ref, port = _graphs(2, validate=wire != "int16")
    jm, pm = ref.gmaps["k3"], port.gmaps["k3"]
    assert (pm.anchors.dtype == torch.int16) == (wire == "int16")
    if wire == "ov":
        arrays = _route_anchors_to_ov(jm, rng)
        jm, pm = jm.replace(**arrays), _port_replace(pm, **arrays)
        assert pm.ov_in.shape[0] > 0
    x = _feats(rng, ref, CAP, 12)
    w = (rng.normal(size=(27, 12, 20)) * 0.1).astype(np.float32)
    b = (0.1 * rng.normal(size=(20,))).astype(np.float32)
    want = jax_msconv.masked_shift_conv(jnp.asarray(x), jnp.asarray(w), jm,
                                        jnp.asarray(b))
    got = msconv.masked_shift_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   pm, torch.from_numpy(b))
    assert _rel(got.numpy(), want) <= F32_RTOL


@pytest.mark.parametrize("map_name", ["k3", "down0"])
def test_flat_sparse_conv_matches_jax(map_name):
    """Flat gather-GEMM: the k3 map (center slot, mirror) and the down map
    (no center)."""
    rng, ref, port = _graphs(3, down=True, caps=(4096, 2048), n=2600)
    jk, pk = ref.maps[map_name], port.maps[map_name]
    k = jk.idx.shape[0]
    x = _feats(rng, ref, 4096, 10)
    w = (rng.normal(size=(k, 10, 14)) * 0.1).astype(np.float32)
    want = jax_spconv.sparse_conv(jnp.asarray(x), jnp.asarray(w), jk.idx,
                                  center_slot=jk.center_slot,
                                  mirror_perm=jk.mirror_perm)
    got = spconv.sparse_conv(torch.from_numpy(x), torch.from_numpy(w), pk.idx,
                             center_slot=pk.center_slot)
    assert _rel(got.numpy(), want) <= F32_RTOL


def test_transpose_child_sum_conv_matches_jax():
    """The up conv through the companion down map's partition, on the
    production build whose parents ship as uint16 block deltas."""
    from languagegroundedsemseg_tpu.data.batching import BatchBuilder as JB
    from languagegroundedsemseg_tpu.models.res16unet import (
        res16unet_graph_spec as jax_spec,
    )
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.models.res16unet import (
        res16unet_graph_spec,
    )

    rng = np.random.default_rng(4)
    scenes = [voxelize_scene(rng, 6000) for _ in range(2)]
    jg = JB(spec=jax_spec()).build(scenes).graph
    pg = BatchBuilder(spec=res16unet_graph_spec()).build(scenes,
                                                         device="cpu").graph
    jm, pm = jg.gmaps["down0"], pg.gmaps["down0"]
    assert np.asarray(jm.parent).dtype == np.uint16
    x = rng.normal(size=(jg.levels[1].capacity, 24)).astype(np.float32)
    w = (rng.normal(size=(8, 24, 16)) * 0.2).astype(np.float32)
    b = (0.1 * rng.normal(size=(16,))).astype(np.float32)
    want = jax_oh.transpose_child_sum_conv(jnp.asarray(x), jnp.asarray(w), jm,
                                           jnp.asarray(b))
    got = onehot_conv.transpose_child_sum_conv(
        torch.from_numpy(x), torch.from_numpy(w), pm, torch.from_numpy(b))
    assert got.shape == (jg.levels[0].capacity, 16)
    np.testing.assert_array_equal(onehot_conv._abs_parent(pm).numpy(),
                                  np.asarray(jax_oh._abs_parent(jm)))
    assert _rel(got.numpy(), want) <= F32_RTOL


@pytest.mark.parametrize("kernel_ndim", [2, 3])
def test_pointwise_conv_matches_jax(kernel_ndim):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(300, 40)).astype(np.float32)
    w = rng.normal(size=(1, 40, 24) if kernel_ndim == 3 else (40, 24))
    w = w.astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = jax_spconv.pointwise_conv(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))
    got = spconv.pointwise_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b))
    assert _rel(got.numpy(), want) <= F32_RTOL


def test_batch_mean_and_broadcast_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(500, 7)).astype(np.float32)
    bidx = np.sort(rng.integers(0, 3, size=500)).astype(np.int32)
    mask = (rng.random(500) < 0.8).astype(np.float32)
    want = jax_segment.batch_mean(jnp.asarray(x), jnp.asarray(bidx),
                                  jnp.asarray(mask), 4)
    got = segment.batch_mean(torch.from_numpy(x), torch.from_numpy(bidx),
                             torch.from_numpy(mask), 4)
    assert _rel(got.numpy(), want) <= F32_RTOL
    np.testing.assert_array_equal(
        segment.batch_broadcast(got, torch.from_numpy(bidx)).numpy(),
        got.numpy()[bidx])


@pytest.mark.parametrize("train", [False, True])
def test_sparse_batch_norm_matches_jax(train):
    """Eval mode normalizes every row with the running statistics; train
    mode takes the batch statistics over valid rows only and updates the
    running ones (momentum 0.02, unbiased variance)."""
    import jax

    from languagegroundedsemseg_tpu.models.layers import (
        SparseBatchNorm as JaxSparseBatchNorm,
    )
    from languagegroundedsemseg_torch.models.layers import SparseBatchNorm

    rng = np.random.default_rng(9)
    x = (2.0 + 3.0 * rng.normal(size=(400, 6))).astype(np.float32)
    mask = (rng.random(400) < 0.7).astype(np.float32)
    x[mask == 0] = 1e3  # padding rows must not reach the statistics
    params = {"scale": rng.uniform(0.6, 1.4, 6).astype(np.float32),
              "bias": (0.1 * rng.normal(size=6)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.normal(size=6)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    want, mut = JaxSparseBatchNorm().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(mask), train, mutable=["batch_stats"])

    bn = SparseBatchNorm(6, device="cpu")
    bn.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"])})
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x), torch.from_numpy(mask))
    valid = mask > 0
    assert _rel(got.numpy()[valid], np.asarray(want)[valid]) <= F32_RTOL
    new = jax.device_get(mut["batch_stats"])
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"],
                               rtol=F32_RTOL, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"],
                               rtol=F32_RTOL, atol=1e-7)
