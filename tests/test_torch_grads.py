"""Gradients of the port's sparse conv ops (CPU) against the JAX package's.

For each op, dX, dW and dbias of ``(op(x, w, b) * ct).sum()`` from the
port's autograd against ``jax.grad`` of the JAX op, on the same numpy
inputs and graphs as tests/test_torch_ops.py. The selector and child-sum
paths run bf16 projection GEMMs on both sides (JAX's Pallas kernels in
interpret mode): <= BF16_RTOL of max |ref|, the tolerance of the forward
tests. The f32 paths (masked shift, flat gather, scatter and parent forms,
pointwise, batch norm) differ only in sum order: <= F32_RTOL of max |ref|.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from languagegroundedsemseg_tpu.ops import msconv as jax_msconv
from languagegroundedsemseg_tpu.ops import onehot_conv as jax_oh
from languagegroundedsemseg_tpu.ops import spconv as jax_spconv
from languagegroundedsemseg_tpu.sparse import graph_host as jax_gh
from languagegroundedsemseg_torch.ops import msconv, onehot_conv, spconv
from languagegroundedsemseg_torch.sparse import graph_host as gh
from test_torch_ops import (
    BF16_RTOL,
    CAP,
    F32_RTOL,
    _feats,
    _graphs,
    _port_replace,
    _rel,
    _route_anchors_to_ov,
    _shift_cs_windows,
)


def _grads(jax_op, port_op, x, w, b, ct):
    """((dx, dw, db) of the JAX op, the same of the port's op) for the loss
    (op(x, w, b) * ct).sum(); b may be None."""
    def loss(x, w, b):
        return (jax_op(x, w, b) * jnp.asarray(ct)).sum()

    args = (jnp.asarray(x), jnp.asarray(w),
            None if b is None else jnp.asarray(b))
    want = jax.grad(loss, argnums=(0, 1) if b is None else (0, 1, 2))(*args)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = None if b is None else torch.from_numpy(b).requires_grad_(True)
    (port_op(xt, wt, bt) * torch.from_numpy(ct)).sum().backward()
    got = [xt.grad, wt.grad] + ([] if b is None else [bt.grad])
    return [np.asarray(v) for v in want], [g.numpy() for g in got]


def _check(want, got, rtol):
    for name, wv, gv in zip(("dx", "dw", "db"), want, got):
        assert gv.shape == wv.shape, name
        err = _rel(gv, wv)
        assert err <= rtol, f"{name}: relative max error {err}"


def _ct(rng, rows, cols):
    return rng.normal(size=(rows, cols)).astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "ov", "production", "pad"])
def test_onehot_window_conv_grads_match_jax(case):
    """plain: host-built inverse tiling; ov: anchors routed into the
    overflow COO (the forward's and the dX's COO); production: the
    validate=False wire format, whose 0-width inv_anchors both packages
    rebuild on the device; pad: 20 output channels padded to 24 (the port)
    and 128 (JAX)."""
    rng, ref, port = _graphs(1 if case != "production" else 9,
                             validate=case != "production")
    jm, pm = ref.gmaps["k3"], port.gmaps["k3"]
    assert pm.tile > 0
    if case == "production":
        assert pm.inv_anchors.shape[1] == 0
    if case == "ov":
        arrays = _route_anchors_to_ov(jm, rng)
        jm, pm = jm.replace(**arrays), _port_replace(pm, **arrays)
    cin, cout = (12, 20) if case == "pad" else (16, 16)
    x = _feats(rng, ref, CAP, cin)
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    b = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    want, got = _grads(
        lambda x, w, b: jax_oh.onehot_window_conv(x, w, jm, b, interpret=True),
        lambda x, w, b: onehot_conv.onehot_window_conv(x, w, pm, b),
        x, w, b, _ct(rng, CAP, cout))
    _check(want, got, BF16_RTOL)


@pytest.mark.parametrize("form", ["window1", "window2", "scatter"])
def test_child_sum_conv_grads_match_jax(form):
    rng, ref, port = _graphs(7 if form != "window2" else 11, down=True,
                             caps=(4096, 2048), n=2600)
    jm, pm = ref.gmaps["down0"], port.gmaps["down0"]
    if form == "window2":
        pin = (2, 128, 1024)
        jm = jax_gh._try_child_sum_map(np.asarray(ref.maps["down0"].idx),
                                       4096, pin_tilewin=pin)
        pm = gh._try_child_sum_map(port.maps["down0"].idx.numpy(), 4096,
                                   pin_tilewin=pin).to("cpu")
    if form == "scatter":
        jm, pm = jm.replace(tile=0, win=0), pm.replace(tile=0, win=0)
    else:
        assert pm.tile > 0 and pm.n_groups == (2 if form == "window2" else 1)
        arrays = _shift_cs_windows(jm, 4096)
        jm, pm = jm.replace(**arrays), _port_replace(pm, **arrays)
    x = _feats(rng, ref, 4096, 16)
    x *= np.asarray(ref.gmaps["k3"].mc)[:, None]
    w = (rng.normal(size=(8, 16, 24)) * 0.2).astype(np.float32)
    b = (0.1 * rng.normal(size=(24,))).astype(np.float32)
    want, got = _grads(
        lambda x, w, b: jax_oh.child_sum_conv(x, w, jm, b, interpret=True),
        lambda x, w, b: onehot_conv.child_sum_conv(x, w, pm, b),
        x, w, b, _ct(rng, 2048, 24))
    # the backward is the f32 gather form in both packages
    _check(want, got, F32_RTOL)


@pytest.mark.parametrize("form", ["window", "scatter"])
def test_transpose_child_sum_conv_grads_match_jax(form):
    """The up conv through the companion down map: dX runs the child-sum
    direction (the windowed kernel path in bf16, or the f32 scatter)."""
    rng, ref, port = _graphs(7, down=True, caps=(4096, 2048), n=2600)
    jm, pm = ref.gmaps["down0"], port.gmaps["down0"]
    if form == "scatter":
        jm, pm = jm.replace(tile=0, win=0), pm.replace(tile=0, win=0)
    else:
        assert pm.tile > 0
    x = rng.normal(size=(2048, 24)).astype(np.float32)
    w = (rng.normal(size=(8, 24, 16)) * 0.2).astype(np.float32)
    b = (0.1 * rng.normal(size=(16,))).astype(np.float32)
    ct = _ct(rng, 4096, 16)
    ct *= np.asarray(ref.gmaps["k3"].mc)[:, None]
    want, got = _grads(
        lambda x, w, b: jax_oh.transpose_child_sum_conv(x, w, jm, b,
                                                        interpret=True),
        lambda x, w, b: onehot_conv.transpose_child_sum_conv(x, w, pm, b),
        x, w, b, ct)
    _check(want, got, BF16_RTOL if form == "window" else F32_RTOL)


@pytest.mark.parametrize("wire", ["int32", "ov"])
def test_masked_shift_conv_grads_match_jax(wire):
    rng, ref, port = _graphs(2)
    jm, pm = ref.gmaps["k3"], port.gmaps["k3"]
    if wire == "ov":
        arrays = _route_anchors_to_ov(jm, rng)
        jm, pm = jm.replace(**arrays), _port_replace(pm, **arrays)
    x = _feats(rng, ref, CAP, 12)
    w = (rng.normal(size=(27, 12, 20)) * 0.1).astype(np.float32)
    b = (0.1 * rng.normal(size=(20,))).astype(np.float32)
    want, got = _grads(
        lambda x, w, b: jax_msconv.masked_shift_conv(x, w, jm, b),
        lambda x, w, b: msconv.masked_shift_conv(x, w, pm, b),
        x, w, b, _ct(rng, CAP, 20))
    _check(want, got, F32_RTOL)


@pytest.mark.parametrize("form", ["plain", "mirror", "cparent"])
def test_flat_sparse_conv_grads_match_jax(form):
    """plain: scatter dX; mirror: the k3 map's mirrored slots; cparent:
    the down map with its companion up ParentMap."""
    rng, ref, port = _graphs(3, down=True, caps=(4096, 2048), n=2600)
    name = "down0" if form == "cparent" else "k3"
    jk, pk = ref.maps[name], port.maps[name]
    k = jk.idx.shape[0]
    x = _feats(rng, ref, 4096, 10)
    w = (rng.normal(size=(k, 10, 14)) * 0.1).astype(np.float32)
    b = (0.1 * rng.normal(size=(14,))).astype(np.float32)
    jkw = dict(center_slot=jk.center_slot)
    pkw = dict(center_slot=pk.center_slot)
    if form == "mirror":
        jkw["mirror_perm"], pkw["mirror_perm"] = jk.mirror_perm, pk.mirror_perm
    if form == "cparent":
        jp = jax_gh._try_parent_map(np.asarray(ref.maps["up1"].idx))
        pp = gh._try_parent_map(port.maps["up1"].idx.numpy()).to("cpu")
        jkw["companion_parent"] = (jp.parent, jp.kslot)
        pkw["companion_parent"] = (pp.parent, pp.kslot)
    want, got = _grads(
        lambda x, w, b: jax_spconv.sparse_conv(x, w, jk.idx, b, **jkw),
        lambda x, w, b: spconv.sparse_conv(x, w, pk.idx, b, **pkw),
        x, w, b, _ct(rng, jk.idx.shape[1], 14))
    _check(want, got, F32_RTOL)


@pytest.mark.parametrize("form", ["plain", "idx_down"])
def test_sparse_conv_parent_grads_match_jax(form):
    rng, ref, port = _graphs(3, down=True, caps=(4096, 2048), n=2600)
    jp = jax_gh._try_parent_map(np.asarray(ref.maps["up1"].idx))
    pp = gh._try_parent_map(port.maps["up1"].idx.numpy()).to("cpu")
    jd = ref.maps["down0"].idx if form == "idx_down" else None
    pd = port.maps["down0"].idx if form == "idx_down" else None
    x = rng.normal(size=(2048, 10)).astype(np.float32)
    w = (rng.normal(size=(8, 10, 14)) * 0.1).astype(np.float32)
    b = (0.1 * rng.normal(size=(14,))).astype(np.float32)
    want, got = _grads(
        lambda x, w, b: jax_spconv.sparse_conv_parent(x, w, jp, b,
                                                      idx_down=jd),
        lambda x, w, b: spconv.sparse_conv_parent(x, w, pp, b, idx_down=pd),
        x, w, b, _ct(rng, 4096, 14))
    _check(want, got, F32_RTOL)


def test_pointwise_conv_grads_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(300, 40)).astype(np.float32)
    w = rng.normal(size=(40, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want, got = _grads(jax_spconv.pointwise_conv, spconv.pointwise_conv,
                       x, w, b, _ct(rng, 300, 24))
    _check(want, got, F32_RTOL)


def test_train_mode_batch_norm_grads_match_jax():
    """Train-mode SparseBatchNorm: dX, d(weight), d(bias) through the
    statistics of the valid rows; the padding rows' outputs carry
    gradient too (the reference normalizes every row)."""
    from languagegroundedsemseg_tpu.models.layers import (
        SparseBatchNorm as JaxSparseBatchNorm,
    )
    from languagegroundedsemseg_torch.models.layers import SparseBatchNorm

    rng = np.random.default_rng(9)
    x = (2.0 + 3.0 * rng.normal(size=(400, 6))).astype(np.float32)
    mask = (rng.random(400) < 0.7).astype(np.float32)
    scale = rng.uniform(0.6, 1.4, 6).astype(np.float32)
    bias = (0.1 * rng.normal(size=6)).astype(np.float32)
    stats = {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}
    ct = _ct(rng, 400, 6)
    bn_jax = JaxSparseBatchNorm()

    def jax_op(x, s, b):
        y, _ = bn_jax.apply({"params": {"scale": s, "bias": b},
                             "batch_stats": stats}, x, jnp.asarray(mask),
                            True, mutable=["batch_stats"])
        return y

    bn = SparseBatchNorm(6, device="cpu").train()

    def port_op(x, s, b):
        with torch.no_grad():
            bn.weight.copy_(s)
            bn.bias.copy_(b)
        bn.weight.grad = bn.bias.grad = None
        return bn(x, torch.from_numpy(mask))

    def loss(x, s, b):
        return (jax_op(x, s, b) * jnp.asarray(ct)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x),
                                             jnp.asarray(scale),
                                             jnp.asarray(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    (port_op(xt, torch.from_numpy(scale), torch.from_numpy(bias))
     * torch.from_numpy(ct)).sum().backward()
    got = [xt.grad.numpy(), bn.weight.grad.numpy(), bn.bias.grad.numpy()]
    _check([np.asarray(v) for v in want], got, F32_RTOL)
