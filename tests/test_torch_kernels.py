"""Kernel contracts: the port's plain versions of its three Hopper kernels
against the JAX package's Pallas kernels in interpret mode.

``sel_fwd_reference`` vs ``_run_sel_fwd(..., interpret=True)``,
``csum_reference`` vs ``_run_csum(..., interpret=True)`` (n_groups 1 and 2)
and ``dw_fused_reference`` vs ``_run_dw_fused(..., interpret=True)``, on the
graphs of tests/test_onehot_conv.py with the same bf16 inputs. Both sides
add the same bf16 values (or their exact products) in f32 and differ only
in the order of the sum: max abs error <= 1e-5 * max |ref|. The device
rebuild of the dW inverse tiling is held array-equal to JAX's. The CUDA
kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from languagegroundedsemseg_tpu.ops.msconv import _abs_anchors as jax_abs_anchors
from languagegroundedsemseg_tpu.ops.onehot_conv import (
    _inv_from_anchors as jax_inv_from_anchors,
    _parent_groups as jax_parent_groups,
    _run_csum,
    _run_dw_fused,
    _run_sel_fwd,
)
from languagegroundedsemseg_tpu.sparse import GraphSpec, MapSpec, build_graph
from languagegroundedsemseg_tpu.sparse.graph_host import (
    _try_child_sum_map,
    pack_keys,
)
from languagegroundedsemseg_tpu.sparse.offsets import ConvKind
from languagegroundedsemseg_torch.ops import msconv
from languagegroundedsemseg_torch.ops import onehot_conv as oc
from languagegroundedsemseg_torch.sparse import graph_host as gh
from languagegroundedsemseg_torch.sparse.offsets import ConvKind as PortConvKind
from oracles import make_cloud
from test_torch_ops import _graphs

CAP = 4096
RTOL = 1e-5


def _bf16(rng, shape):
    """The same bf16 values for both packages, as (jax, torch) arrays."""
    a = jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def _k3_map(seed):
    rng = np.random.default_rng(seed)
    coords = make_cloud(rng, n=3000, extent=40)
    coords = coords[np.argsort(pack_keys(coords), kind="stable")]
    spec = GraphSpec(num_levels=1,
                     maps={"k3": MapSpec(0, 0, ConvKind(3), fuse_width=3)})
    g = build_graph(coords, spec, (CAP,), drop_redundant=False)
    return rng, g.gmaps["k3"]


def _down_map(seed, pin=None):
    rng = np.random.default_rng(seed)
    coords = make_cloud(rng, n=2600, extent=40)
    coords = coords[np.argsort(pack_keys(coords), kind="stable")]
    spec = GraphSpec(num_levels=2, maps={
        "k3": MapSpec(0, 0, ConvKind(3), fuse_width=3),
        "down0": MapSpec(0, 1, ConvKind(kernel_size=2, stride=2))})
    g = build_graph(coords, spec, (4096, 2048), drop_redundant=False)
    if pin is None:
        return rng, g.gmaps["down0"]
    return rng, _try_child_sum_map(np.asarray(g.maps["down0"].idx),
                                   g.levels[0].capacity, pin_tilewin=pin)


def _scramble(rng, rows, hi):
    """A copy of ``rows`` with 10% of its entries moved to random values
    in [0, hi): many then fall outside their windows, which the contract
    must skip (the builder itself only leaves in-window entries)."""
    out = rows.copy()
    pick = rng.random(out.shape) < 0.1
    out[pick] = rng.integers(0, hi, size=int(pick.sum()))
    return out


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("c_run,scramble", [(128, False), (32, False),
                                            (128, True)])
def test_sel_fwd_reference_matches_pallas(c_run, scramble):
    rng, m = _k3_map(1)
    assert m.tile > 0
    n_cols = m.anchors.shape[0]
    anchors = _scramble(rng, m.anchors, CAP) if scramble else m.anchors
    pj, pt = _bf16(rng, (CAP, (n_cols + 1) * c_run))
    want = _run_sel_fwd(jnp.asarray(m.wstart), jnp.asarray(anchors),
                        jnp.asarray(m.mc), pj, n_cols, m.tile, m.win, True)
    got = oc.sel_fwd_reference(
        torch.from_numpy(m.wstart), torch.from_numpy(anchors),
        torch.from_numpy(m.mc), pt, n_cols, m.tile, m.win)
    assert got.dtype == torch.float32 and got.shape == (CAP, c_run)
    assert _max_rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("n_groups,scramble", [(1, False), (2, False),
                                               (2, True)])
def test_csum_reference_matches_pallas(n_groups, scramble):
    rng, m = _down_map(7 if n_groups == 1 else 11,
                       pin=None if n_groups == 1 else (2, 128, 1024))
    assert m.tile > 0 and m.n_groups == n_groups
    if scramble:
        m = m.replace(parent=_scramble(rng, m.parent, m.out_capacity))
    cap_in = m.parent.shape[0]
    c_run = 128
    pj, pt = _bf16(rng, (cap_in, c_run))
    pg = jax_parent_groups(jnp.asarray(m.parent), jnp.asarray(m.kslot),
                           m.num_slots, n_groups, m.out_capacity)
    want = _run_csum(jnp.asarray(m.wstart), pg, pj, m.out_capacity, m.tile,
                     m.win, n_groups, True)
    pg_port = oc._parent_groups(torch.from_numpy(m.parent),
                                torch.from_numpy(m.kslot), m.num_slots,
                                n_groups, m.out_capacity)
    np.testing.assert_array_equal(pg_port.numpy(), np.asarray(pg))
    got = oc.csum_reference(torch.from_numpy(m.wstart), pg_port, pt,
                            m.out_capacity, m.tile, m.win, n_groups)
    assert got.dtype == torch.float32 and got.shape == (m.out_capacity, c_run)
    assert _max_rel(got.numpy(), want) <= RTOL


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    """On CPU tensors the wrappers return the plain versions' results and
    leave the launch counts alone: a count is a launch on the card."""
    rng, m = _k3_map(2)
    _, pt = _bf16(rng, (CAP, 9 * 16))
    args = (torch.from_numpy(m.wstart), torch.from_numpy(m.anchors),
            torch.from_numpy(m.mc), pt, 8, m.tile, m.win)
    before = dict(oc.launch_counts)
    torch.testing.assert_close(oc.sel_fwd(*args), oc.sel_fwd_reference(*args),
                               rtol=0, atol=0)
    rng, d = _down_map(7)
    _, pc = _bf16(rng, (d.parent.shape[0], 16))
    pg = oc._parent_groups(torch.from_numpy(d.parent),
                           torch.from_numpy(d.kslot), d.num_slots, 1,
                           d.out_capacity)
    cargs = (torch.from_numpy(d.wstart), pg, pc, d.out_capacity, d.tile,
             d.win, 1)
    torch.testing.assert_close(oc.csum(*cargs), oc.csum_reference(*cargs),
                               rtol=0, atol=0)
    assert oc.launch_counts == before


@pytest.mark.parametrize("cw,c_out,scramble", [(48, 16, False), (9, 8, False),
                                               (48, 16, True), (9, 8, True)])
def test_dw_fused_reference_matches_pallas(cw, c_out, scramble):
    """3C = 9 is conv0's width (not a multiple of 8); scrambled inverse
    anchors leave their windows, which the contract must skip."""
    rng, m = _k3_map(5)
    assert m.tile > 0 and m.inv_anchors.shape[1] == CAP
    inv = _scramble(rng, m.inv_anchors, CAP + 1) if scramble else m.inv_anchors
    tj, tt = _bf16(rng, (CAP, cw))
    gj, gt = _bf16(rng, (CAP, c_out))
    want = _run_dw_fused(jnp.asarray(m.inv_wstart), jnp.asarray(inv), tj, gj,
                         m.tile, m.win, True)
    got = oc.dw_fused_reference(torch.from_numpy(m.inv_wstart),
                                torch.from_numpy(inv), tt, gt, m.tile, m.win)
    assert got.dtype == torch.float32 and got.shape == (8, cw, c_out)
    assert _max_rel(got.numpy(), want) <= RTOL


def test_inv_from_anchors_matches_jax_and_host():
    """The device rebuild of the inverse tiling from a production map
    (int16 anchors, 0-width inv_anchors) is array-equal to JAX's rebuild
    and to the host's debug build of the same coordinates."""
    _, ref, port = _graphs(9, validate=False)
    _, dbg, _ = _graphs(9)
    jm, pm = ref.gmaps["k3"], port.gmaps["k3"]
    assert pm.inv_anchors.shape[1] == 0 and pm.anchors.dtype == torch.int16
    want = jax_inv_from_anchors(
        jax_abs_anchors(jnp.asarray(jm.anchors)),
        jnp.asarray(jm.ov_in), jnp.asarray(jm.ov_out), jnp.asarray(jm.ov_off),
        jnp.asarray(jm.dwov_in), jnp.asarray(jm.dwov_off))
    got = oc._inv_from_anchors(
        msconv._abs_anchors(pm.anchors), pm.ov_in, pm.ov_out, pm.ov_off,
        pm.dwov_in, pm.dwov_off)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(dbg.gmaps["k3"].inv_anchors))
    rebuilt = oc.with_inverse_anchors(port).gmaps["k3"].inv_anchors
    np.testing.assert_array_equal(rebuilt.numpy(), got.numpy())


def test_kernels_run_inside_autograd_on_cpu():
    """On CPU tensors the wrappers run their plain versions inside autograd
    (grad mode on, inputs that require grad) and leave the launch counts
    alone; gradients flow through the three conv ops built on them."""
    rng, m = _k3_map(3)
    _, pt = _bf16(rng, (CAP, 9 * 8))
    pt.requires_grad_(True)
    before = dict(oc.launch_counts)
    out = oc.sel_fwd(torch.from_numpy(m.wstart), torch.from_numpy(m.anchors),
                     torch.from_numpy(m.mc), pt, 8, m.tile, m.win)
    out.sum().backward()
    assert pt.grad is not None and pt.grad.shape == pt.shape
    pc = pt.detach()[:, :8].clone().requires_grad_(True)
    oc.csum(torch.zeros(CAP // 128, dtype=torch.int32),
            torch.zeros((1, CAP), dtype=torch.int32), pc, 1024, 128, 512,
            1).sum().backward()
    assert pc.grad is not None

    # the three conv ops: grads reach x, w and bias
    rng = np.random.default_rng(4)
    coords = make_cloud(rng, n=2600, extent=40)
    coords = coords[np.argsort(gh.pack_keys(coords), kind="stable")]
    spec = gh.GraphSpec(2, {
        "k3": gh.MapSpec(0, 0, PortConvKind(3), fuse_width=3),
        "down0": gh.MapSpec(0, 1, PortConvKind(kernel_size=2, stride=2))})
    g = gh.build_graph(coords, spec, (4096, 2048),
                       drop_redundant=False).to("cpu")
    k3, down = g.gmaps["k3"], g.gmaps["down0"]
    assert k3.tile > 0 and down.tile > 0
    cases = [(oc.onehot_window_conv, k3, (4096, 8), (27, 8, 8)),
             (oc.child_sum_conv, down, (4096, 8), (8, 8, 8)),
             (oc.transpose_child_sum_conv, down, (2048, 8), (8, 8, 8))]
    for op, gm, xs, ws in cases:
        x = torch.randn(xs, requires_grad=True)
        w = torch.randn(ws, requires_grad=True)
        b = torch.randn(ws[2], requires_grad=True)
        op(x, w, gm, b).square().sum().backward()
        for t in (x, w, b):
            assert t.grad is not None and bool(torch.isfinite(t.grad).all())
            assert float(t.grad.abs().sum()) > 0
    assert oc.launch_counts == before
