"""The port's point ops (``ops/points.py``) and cluster ops
(``ops/cluster.py``) against the JAX package's, on the same seeded numpy
inputs, on the CPU.

Indices are held equal and values within 1e-6 (both packages compute the
squared distances in f32 with the same expansion); the radius graphs, the
component labels and the host pipeline are held array-equal, including a
chain that the 64-sweep cap of ``connected_components`` leaves
unconverged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.ops import cluster as jc
from languagegroundedsemseg_tpu.ops import points as jp
from languagegroundedsemseg_torch.ops import cluster as pc
from languagegroundedsemseg_torch.ops import points as pp

VALUE_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed, n=400, extent=1.0):
    rng = np.random.default_rng(seed)
    return rng, (rng.random((n, 3)) * extent).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_furthest_point_sample_equals_jax(seed):
    rng, pts = _cloud(seed)
    want = np.asarray(jp.furthest_point_sample(jnp.asarray(pts), 48))
    got = pp.furthest_point_sample(_t(pts), 48)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == 0


def test_furthest_point_sample_with_mask_equals_jax():
    rng, pts = _cloud(3)
    mask = (rng.random(len(pts)) > 0.3).astype(np.int32)
    mask[:5] = 0  # the first valid row is the start
    want = np.asarray(jp.furthest_point_sample(jnp.asarray(pts), 40, jnp.asarray(mask)))
    got = pp.furthest_point_sample(_t(pts), 40, _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.argmax(mask) and mask[got].all()


def test_furthest_point_sample_ties_go_to_the_first_index():
    """Duplicated points: every max-min tie resolves to the lowest index,
    as jnp.argmax does."""
    base = np.random.default_rng(4).random((20, 3)).astype(np.float32)
    pts = np.concatenate([base, base, base])
    want = np.asarray(jp.furthest_point_sample(jnp.asarray(pts), 30))
    np.testing.assert_array_equal(pp.furthest_point_sample(_t(pts), 30).numpy(), want)


def test_gather_and_group_points_equal_jax():
    rng, pts = _cloud(5, n=100)
    feats = rng.normal(size=(100, 6)).astype(np.float32)
    idx = rng.integers(0, 100, 30).astype(np.int32)
    np.testing.assert_array_equal(
        pp.gather_points(_t(feats), _t(idx)).numpy(),
        np.asarray(jp.gather_points(jnp.asarray(feats), jnp.asarray(idx))))
    gidx = rng.integers(-1, 100, (30, 8)).astype(np.int32)
    got = pp.group_points(_t(feats), _t(gidx)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jp.group_points(jnp.asarray(feats), jnp.asarray(gidx))))
    assert (got[gidx < 0] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_knn_three_nn_and_interpolate_equal_jax(masked):
    rng, ref = _cloud(6, n=300)
    query = rng.random((60, 3)).astype(np.float32)
    feats = rng.normal(size=(300, 8)).astype(np.float32)
    mask = (rng.random(300) > 0.4).astype(np.int32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    jd, ji = jp.knn(jnp.asarray(query), jnp.asarray(ref), 5, jm)
    d, i = pp.knn(_t(query), _t(ref), 5, tm)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=VALUE_ATOL)
    jd3, ji3 = jp.three_nn(jnp.asarray(query), jnp.asarray(ref), jm)
    d3, i3 = pp.three_nn(_t(query), _t(ref), tm)
    np.testing.assert_array_equal(i3.numpy(), np.asarray(ji3))
    want = np.asarray(jp.three_interpolate(jnp.asarray(feats), ji3, jd3))
    got = pp.three_interpolate(_t(feats), i3, d3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL)
    if masked:
        assert mask[i.numpy()].all()


def test_three_interpolate_guards_zero_distance():
    """A query on a reference point: 1/max(d, 1e-8)^2 keeps the weights
    finite, and the point's own features win."""
    rng, ref = _cloud(7, n=50)
    feats = rng.normal(size=(50, 4)).astype(np.float32)
    query = ref[:3].copy()
    d, i = pp.three_nn(_t(query), _t(ref))
    got = pp.three_interpolate(_t(feats), i, d).numpy()
    jd, ji = jp.three_nn(jnp.asarray(query), jnp.asarray(ref))
    want = np.asarray(jp.three_interpolate(jnp.asarray(feats), ji, jd))
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL)
    np.testing.assert_allclose(got, feats[:3], atol=1e-4)


@pytest.mark.parametrize("radius,nsample,masked", [
    (0.1, 8, False), (0.2, 16, True), (0.02, 4, False)])
def test_ball_query_equals_jax(radius, nsample, masked):
    rng, ref = _cloud(8, n=300)
    query = np.concatenate([ref[:20], rng.random((20, 3)).astype(np.float32) + 2.0])
    mask = (rng.random(300) > 0.3).astype(np.int32) if masked else None
    want = np.asarray(jp.ball_query(jnp.asarray(query), jnp.asarray(ref), radius, nsample,
                                    None if mask is None else jnp.asarray(mask)))
    got = pp.ball_query(_t(query), _t(ref), radius, nsample,
                        None if mask is None else _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[20:] == -1).all()  # far queries find nothing
    # padded slots repeat the first in-radius index
    for row in got[:20]:
        found = row[row >= 0]
        assert len(found) and (found[len(np.unique(found)):] == found[0]).all()


# ---- ops/cluster.py -----------------------------------------------------


def _labeled_cloud(seed, n=300):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 0.25, (n, 3)).astype(np.float32)
    return pts, rng.integers(0, 3, n)


@pytest.mark.parametrize("labeled", [False, True])
def test_radius_edges_and_graph_host_equal_jax(labeled):
    pts, lab = _labeled_cloud(11)
    lab = lab if labeled else None
    np.testing.assert_array_equal(pc.radius_edges_host(pts, 0.05, lab),
                                  jc.radius_edges_host(pts, 0.05, lab))
    for k in (4, 64):  # truncated and complete tables
        np.testing.assert_array_equal(pc.radius_graph_host(pts, 0.05, k, lab),
                                      jc.radius_graph_host(pts, 0.05, k, lab))
    assert pc.radius_edges_host(pts[:0], 0.05).shape == (0, 2)


@pytest.mark.parametrize("labeled,masked", [(False, False), (True, True)])
def test_radius_graph_device_equals_jax(labeled, masked):
    pts, lab = _labeled_cloud(12)
    rng = np.random.default_rng(13)
    mask = (rng.random(len(pts)) > 0.2).astype(np.int32) if masked else None
    want = np.asarray(jc.radius_graph_device(
        jnp.asarray(pts), None if not labeled else jnp.asarray(lab),
        None if mask is None else jnp.asarray(mask), 24, 0.05))
    got = pc.radius_graph_device(
        _t(pts), None if not labeled else _t(lab),
        None if mask is None else _t(mask), 24, 0.05)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # every listed neighbor is within the radius, never the row itself
    r, c = np.nonzero(want >= 0)
    d = np.linalg.norm(pts[r] - pts[want[r, c]], axis=1)
    assert (d <= 0.05 + 1e-6).all() and (want[r, c] != r).all()


def _chain(perm):
    """(L, 2) neighbor table of a chain visiting rows in ``perm`` order."""
    nb = np.full((len(perm), 2), -1, np.int32)
    nb[perm[1:], 0] = perm[:-1]
    nb[perm[:-1], 1] = perm[1:]
    return nb


@pytest.mark.parametrize("case", ["radius_graph", "two_blobs", "reversed_chain"])
def test_connected_components_equals_jax(case):
    """Component labels array-equal to the JAX loop's. The reversed chain
    (row 0 at one end, the rest in decreasing order) needs more than 64
    sweeps: both packages stop at the cap with the same unconverged
    labels."""
    if case == "radius_graph":
        pts, lab = _labeled_cloud(14, n=400)
        nb = jc.radius_graph_host(pts, 0.03, 32, lab)
        valid = (np.random.default_rng(15).random(len(nb)) > 0.1).astype(np.int32)
    elif case == "two_blobs":
        nb = np.full((7, 2), -1, np.int32)
        nb[0, 0] = 1; nb[1] = [0, 2]; nb[2, 0] = 1
        nb[3, 0] = 4; nb[4] = [3, 5]; nb[5, 0] = 4
        valid = np.ones(7, np.int32)
    else:
        nb = _chain(np.r_[0, np.arange(399, 0, -1)])
        valid = np.ones(400, np.int32)
    want = np.asarray(jc.connected_components(jnp.asarray(nb), jnp.asarray(valid)))
    got = pc.connected_components(_t(nb), _t(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    n = len(nb)
    assert (got.numpy()[valid == 0] == n).all()
    if case == "reversed_chain":
        assert len(np.unique(want)) > 1  # the cap stopped it unconverged
        converged = pc.connected_components(_t(nb), _t(valid), max_iters=4096)
        assert (converged == 0).all()


def test_component_sizes_equals_jax():
    pts, lab = _labeled_cloud(16, n=400)
    nb = jc.radius_graph_host(pts, 0.03, 32, lab)
    valid = (np.random.default_rng(17).random(len(nb)) > 0.1).astype(np.int32)
    comp = jc.connected_components(jnp.asarray(nb), jnp.asarray(valid))
    want = np.asarray(jc.component_sizes(comp, jnp.asarray(valid), len(nb)))
    got = pc.component_sizes(_t(np.asarray(comp)), _t(valid), len(nb))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[valid == 0] == 0).all() and want[valid > 0].min() >= 1


@pytest.mark.parametrize("seed,ignored", [(18, False), (19, True)])
def test_cluster_points_equals_jax(seed, ignored):
    rng = np.random.default_rng(seed)
    blobs = [rng.normal(0, 0.01, (150, 3)) + c for c in ([0, 0, 0], [1, 0, 0], [0, 1, 0])]
    pts = np.concatenate(blobs + [rng.random((40, 3)) * 2]).astype(np.float32)
    lab = np.r_[np.zeros(300, int), np.ones(150, int), rng.integers(0, 2, 40)]
    mask = (rng.random(len(pts)) < 0.1) if ignored else None
    got = pc.cluster_points(pts, lab, radius=0.03, min_points=50, ignored_mask=mask)
    want = jc.cluster_points(pts, lab, radius=0.03, min_points=50, ignored_mask=mask)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 3
