"""Point-cloud ops: FPS, ball query, kNN interpolation, grouping.

Counterpart of ``languagegroundedsemseg_tpu/ops/points.py`` (:20-112), the
replacements for the pointnet2 CUDA extension (reference
lib/ext/pointnet2/_ext_src: sampling_gpu.cu, ball_query_gpu.cu,
interpolate_gpu.cu, group_points_gpu.cu). Plain tensor code on the caller's
device: FPS is a loop over a running min-distance field that never reads a
value back to the host; neighbor searches are brute force. Ties go to the
lowest index, as ``jnp.argmax`` and ``lax.top_k`` break them.

Squared distances are summed coordinate by coordinate (``_dot``), never
through a matmul, so they do not depend on the TF32 setting and the card
computes the same bits as the CPU.
"""

from __future__ import annotations

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis of a * b as a chain of fused
    multiply-adds, coordinate by coordinate: each product is exact in f64
    and each partial sum is rounded to f32 once. This is the rounding of
    the JAX package's dots and squared-norm reductions on the CPU, and,
    being elementwise, it gives the same bits on every device and under
    any TF32 setting."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    out = (a[..., 0] * b[..., 0]).to(torch.float32)
    for c in range(1, a.shape[-1]):
        out = (out.to(torch.float64) + a[..., c] * b[..., c]).to(torch.float32)
    return out


def _sq_dists(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(M, N) f32 squared distances as ``|q|^2 - 2 q.r + |r|^2``, the JAX
    package's expansion and rounding."""
    cross = _dot(2.0 * query[:, None, :], ref[None, :, :])
    return (_dot(query, query)[:, None] - cross) + _dot(ref, ref)[None, :]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as an f32 scalar on ``like``'s device (JAX traces a
    non-static float argument as f32, so its products round in f32)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          valid_mask=None) -> torch.Tensor:
    """(N, 3) -> (npoint,) int32 indices. Greedy max-min sampling (reference
    sampling_gpu.cu furthest_point_sampling_kernel; consumed by the
    limited-annotation preprocessing, lib/datasets/preprocessing/
    scannet_long.py:99-104). Starts at index 0, or at the first valid row
    when ``valid_mask`` is given; masked rows hold distance -1."""
    n = xyz.shape[0]
    mindist = torch.full((n,), 1e10, dtype=xyz.dtype, device=xyz.device)
    if valid_mask is None:
        last = torch.zeros((), dtype=torch.int64, device=xyz.device)
    else:
        vm = torch.as_tensor(valid_mask, device=xyz.device)
        mindist = torch.where(vm > 0, mindist, torch.full_like(mindist, -1.0))
        last = torch.argmax(vm.to(torch.float32))
    idxs = torch.zeros((npoint,), dtype=torch.int64, device=xyz.device)
    idxs[0] = last
    for i in range(1, npoint):
        diff = xyz - xyz[last]
        d = _dot(diff, diff)
        mindist = torch.minimum(mindist, d)
        last = torch.argmax(mindist)
        idxs[i] = last
    return idxs.to(torch.int32)


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, C), (M,) -> (M, C) (sampling.cpp gather_points, grad = scatter)."""
    return feats[idx.long()]


# query rows ranked at a time by knn: (KNN_BLOCK_ROWS, N) of memory, not (M, N)
KNN_BLOCK_ROWS = 1024


def _knn_rows(query, ref, k, mask):
    d2 = _sq_dists(query, ref)
    if mask is not None:
        d2 = torch.where(mask, d2, torch.full_like(d2, float("inf")))
    d2, idx = torch.sort(d2, dim=1, stable=True)
    # new tensors, not views: a block's (rows, N) sort is freed on return
    return torch.sqrt(torch.clamp(d2[:, :k], min=0.0)), idx[:, :k].to(torch.int32)


def knn(query: torch.Tensor, ref: torch.Tensor, k: int, ref_mask=None):
    """Brute-force kNN: (M, D) x (N, D) -> (dists (M, k), idx (M, k) int32),
    nearest first, ties to the lower index. Query rows are ranked
    ``KNN_BLOCK_ROWS`` at a time; each row's ranking is the whole
    matrix's."""
    mask = (None if ref_mask is None
            else torch.as_tensor(ref_mask, device=ref.device)[None, :] > 0)
    parts = [_knn_rows(query[i:i + KNN_BLOCK_ROWS], ref, k, mask)
             for i in range(0, max(query.shape[0], 1), KNN_BLOCK_ROWS)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def three_nn(query: torch.Tensor, ref: torch.Tensor, ref_mask=None):
    """3 nearest neighbors (interpolate_gpu.cu three_nn_kernel)."""
    return knn(query, ref, 3, ref_mask)


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      dist: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weighted interpolation of ref feats onto queries
    (interpolate_gpu.cu three_interpolate_kernel; autograd provides the
    scatter backward the CUDA grad kernel implements)."""
    w = 1.0 / torch.clamp(dist, min=1e-8) ** 2
    w = w / w.sum(-1, keepdim=True)
    gathered = feats[idx.long()]  # (M, 3, C)
    return (gathered * w[..., None]).sum(dim=1)


def ball_query(query: torch.Tensor, ref: torch.Tensor, radius: float,
               nsample: int, ref_mask=None) -> torch.Tensor:
    """(M, 3) x (N, 3) -> (M, nsample) int32 indices of ref points within
    radius (ball_query_gpu.cu semantics: the first nsample in-radius points
    by index, remaining slots filled with the first found; -1 rows when
    none is found)."""
    d2 = _sq_dists(query, ref)
    r = _f32(radius, d2)
    inside = d2 <= r * r
    if ref_mask is not None:
        inside = inside & (torch.as_tensor(ref_mask, device=d2.device)[None, :] > 0)
    n = ref.shape[0]
    ar = torch.arange(n, device=d2.device)[None, :]
    # in-radius points first, in index order: the keys are distinct
    order_key = torch.where(inside, ar, n + ar)
    idx = torch.topk(order_key, nsample, dim=1, largest=False, sorted=True).indices
    got = torch.gather(inside, 1, idx)
    any_found = got[:, :1]
    idx = torch.where(got, idx, idx[:, :1])  # pad with the first in-radius point
    idx = torch.where(any_found, idx, torch.full_like(idx, -1))
    return idx.to(torch.int32)


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, C), (M, S) -> (M, S, C), zeros where idx is -1
    (group_points_gpu.cu; grad = scatter-add via autograd)."""
    g = feats[torch.clamp(idx.long(), min=0)]
    return torch.where((idx >= 0)[..., None], g, torch.zeros((), dtype=g.dtype,
                                                              device=g.device))
