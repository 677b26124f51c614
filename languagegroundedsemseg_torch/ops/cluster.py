"""Radius-graph construction + connected components for instance clustering.

Counterpart of ``languagegroundedsemseg_tpu/ops/cluster.py`` (:21-183), the
replacement for the PointGroup CUDA/C++ ops (reference
downstream/insseg/lib/bfs/ops: ballquery_batch_p kernel + sequential CPU
BFS). The host path (``radius_edges_host``, ``radius_graph_host``,
``cluster_points``: cKDTree pairs + scipy components) is the JAX package's
numpy code as it is. The device path (``radius_graph_device``,
``connected_components``, ``component_sizes``) is tensor code on the
caller's device: min-label propagation with path halving, the JAX loop
sweep for sweep.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from languagegroundedsemseg_torch.ops.points import _f32, _sq_dists


def radius_edges_host(
    points: np.ndarray,
    radius: float,
    labels: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Exact radius graph as an (E, 2) undirected edge array (each pair
    once, u < v), optionally restricted to same-``labels`` pairs (the BFS
    expands only through equal semantic labels, reference
    bfs_cluster.cpp:54-101).

    Vectorized cKDTree pair query — the host analog of the reference's
    ballquery_batch_p CUDA kernel with its adaptive meanActive retry
    (bfs.py:32-39), which keeps growing the per-point budget until the
    whole within-radius neighborhood fits; the exact pair set is that
    loop's fixed point, with no truncation at any density."""
    from scipy.spatial import cKDTree

    if len(points) == 0:
        return np.zeros((0, 2), dtype=np.int64)
    tree = cKDTree(points)
    pairs = tree.query_pairs(r=radius, output_type="ndarray")
    if labels is not None and len(pairs):
        lab = np.asarray(labels)
        pairs = pairs[lab[pairs[:, 0]] == lab[pairs[:, 1]]]
    return pairs


def radius_graph_host(
    points: np.ndarray,
    radius: float,
    max_neighbors: int,
    labels: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(N, 3) -> (N, max_neighbors) neighbor indices (-1 padded) — the
    fixed-shape table the *device* label-propagation path consumes.
    Built from the exact pair set (radius_edges_host); per-point lists
    beyond ``max_neighbors`` are truncated, so callers that need exact
    reference connectivity should cluster via the edge list instead
    (cluster_points does)."""
    n = len(points)
    out = np.full((n, max_neighbors), -1, dtype=np.int32)
    if n == 0:
        return out
    pairs = radius_edges_host(points, radius, labels)
    if not len(pairs):
        return out
    src = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(src)) - starts[src]
    keep = slot < max_neighbors
    out[src[keep], slot[keep]] = dst[keep]
    return out


def radius_graph_device(points: torch.Tensor, labels, mask,
                        max_neighbors: int, radius: float = 0.03) -> torch.Tensor:
    """Brute-force radius graph on ``points``' device: (N, max_neighbors)
    int32 neighbor indices, lowest first, -1 padded. Quadratic in N (it
    builds (N, N) tables): for modest N. Squared distances are elementwise
    sums (``ops/points._sq_dists``), so the TF32 setting cannot move a
    pair across the radius."""
    d2 = _sq_dists(points, points)
    n = points.shape[0]
    r = _f32(radius, d2)
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    ok = (d2 <= r * r) & ~eye
    if labels is not None:
        lab = torch.as_tensor(labels, device=d2.device)
        ok = ok & (lab[:, None] == lab[None, :])
    if mask is not None:
        m = torch.as_tensor(mask, device=d2.device) > 0
        ok = ok & m[None, :] & m[:, None]
    ar = torch.arange(n, device=d2.device)[None, :]
    order_key = torch.where(ok, ar, n + ar)  # distinct keys: no ties
    idx = torch.topk(order_key, max_neighbors, dim=1, largest=False,
                     sorted=True).indices
    got = torch.gather(ok, 1, idx)
    return torch.where(got, idx, torch.full_like(idx, -1)).to(torch.int32)


def connected_components(neighbors: torch.Tensor, valid: torch.Tensor,
                         max_iters: int = 64) -> torch.Tensor:
    """(N, K) padded neighbor lists -> (N,) int32 component root ids.

    Min-label propagation with two path-halving hops a sweep; each sweep
    reads the previous sweep's labels only. Invalid rows (valid == 0) get
    id N (a sentinel none of the valid rows can take). Stops when a sweep
    changes nothing or after ``max_iters`` sweeps, converged or not (the
    JAX ``while_loop``'s condition; a long chain returns unconverged
    labels). Reads one flag back to the host a sweep."""
    dev = neighbors.device
    n = neighbors.shape[0]
    nb = neighbors.long()
    is_valid = torch.as_tensor(valid, device=dev) > 0
    sentinel = torch.full((n,), n, dtype=torch.int64, device=dev)
    comp = torch.where(is_valid, torch.arange(n, device=dev), sentinel)
    safe = torch.clamp(nb, min=0)
    has = nb >= 0
    changed, it = True, 0
    while changed and it < max_iters:
        if nb.shape[1]:
            ncomp = torch.where(has, comp[safe], torch.full_like(nb, n))
            best = torch.minimum(comp, ncomp.min(dim=1).values)
        else:
            best = comp
        # path halving: follow the parent pointer twice
        best2 = torch.where(best < n,
                            torch.minimum(best, comp[torch.clamp(best, max=n - 1)]),
                            best)
        best3 = torch.where(best2 < n,
                            torch.minimum(best2, comp[torch.clamp(best2, max=n - 1)]),
                            best2)
        new = torch.where(is_valid, best3, sentinel)
        changed = bool(torch.any(new != comp))
        comp, it = new, it + 1
    return comp.to(torch.int32)


def component_sizes(comp: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """(N,) int32 size of each point's component (0 for invalid rows)."""
    dev = comp.device
    is_valid = torch.as_tensor(valid, device=dev) > 0
    c = comp.long()
    seg = torch.where(is_valid, c, torch.full_like(c, n))
    counts = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, seg, is_valid.to(torch.int32))
    return torch.where(is_valid, counts[torch.clamp(c, max=n)],
                       torch.zeros((), dtype=torch.int32, device=dev))


def cluster_points(
    points: np.ndarray,
    semantic_labels: np.ndarray,
    radius: float = 0.03,
    max_neighbors: int = 48,  # kept for API compat; exact path ignores it
    min_points: int = 50,
    ignored_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full pipeline -> (component_id per point (-1 = none), num_components).

    Exact host radius graph (every within-radius same-label pair; the
    converged state of the reference's adaptive-meanActive ball query) +
    C-speed union-find components — the reference's bfs_cluster also runs
    on CPU (lib/bfs/bfs.py:141: tensors moved to .cpu() before the BFS),
    so this is the same division of labor with no per-point neighbor cap
    that could split dense components.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as _cc

    n = len(points)
    keep = np.ones(n, dtype=bool) if ignored_mask is None else ~ignored_mask
    kept_idx = np.flatnonzero(keep)
    if len(kept_idx) == 0:
        return np.full(n, -1, np.int32), 0
    pts = points[kept_idx]
    lab = np.asarray(semantic_labels)[kept_idx]
    pairs = radius_edges_host(pts, radius, lab)
    m = len(kept_idx)
    adj = coo_matrix(
        (np.ones(len(pairs), np.int8), (pairs[:, 0], pairs[:, 1])),
        shape=(m, m),
    )
    _, comp_k = _cc(adj, directed=False)
    sizes = np.bincount(comp_k)
    ok = sizes[comp_k] >= min_points
    # densify surviving component ids in first-occurrence order
    uniq, inv = np.unique(comp_k[ok], return_inverse=True)
    out = np.full(n, -1, np.int32)
    out[kept_idx[ok]] = inv
    return out, len(uniq)
