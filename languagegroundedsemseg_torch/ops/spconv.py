"""Sparse convolution as gather-GEMM-accumulate over kernel offsets (forward).

Counterpart of ``languagegroundedsemseg_tpu/ops/spconv.py``: the flat
gather-GEMM (``sparse_conv``, :34-77 and :123), the parent-map conv
(``_parent_fwd_impl``, :277) and the pointwise conv. For each kernel slot k
the op gathers the neighbor rows the kernel map selects and multiplies them
into the f32 accumulator; missing neighbors (idx == -1) contribute zero.
The backwards come with the train step in a later slice.
"""

from __future__ import annotations

import torch


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x at idx, zeros where idx < 0."""
    valid = idx >= 0
    g = x[torch.clamp(idx, min=0).long()]
    return torch.where(valid[:, None], g, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def _center_masked(x, idx, center):
    """x with rows whose center-slot entry is missing zeroed: padding and
    sentinel rows may carry nonzero features, and the center fast path
    must not leak them."""
    return torch.where((idx[center] >= 0)[:, None], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _conv_fwd_impl(x, w, idx, center: int):
    n_out = idx.shape[1]
    c_out = w.shape[2]
    if center >= 0:
        # the center slot of a stride-1 kernel maps each valid row to
        # itself: a masked matmul, no gather
        acc = _center_masked(x, idx, center).to(torch.float32) @ w[center].to(torch.float32)
    else:
        acc = torch.zeros((n_out, c_out), dtype=torch.float32, device=x.device)
    for k in range(w.shape[0]):
        if k == center:
            continue
        g = _gather_rows(x, idx[k]).to(torch.float32)
        acc = acc + g @ w[k].to(torch.float32)
    return acc.to(x.dtype)


def sparse_conv(x, w, idx, bias=None, center_slot: int = -1) -> torch.Tensor:
    """Apply a sparse convolution through a flat kernel map.

    x: (cap_in, Cin); w: (K, Cin, Cout) in the map's slot order;
    idx: (K, cap_out) int32 (-1 = missing); center_slot: the slot whose map
    is the identity (no gather), -1 if none. Returns (cap_out, Cout).
    (The reference's ``mirror_perm`` / ``companion_parent`` arguments only
    pick its backward; they arrive with the backward.)
    """
    if not (w.dim() == 3 and idx.dim() == 2 and w.shape[0] == idx.shape[0]):
        raise ValueError(f"w {tuple(w.shape)} vs idx {tuple(idx.shape)}")
    out = _conv_fwd_impl(x, w, idx, center_slot)
    if bias is not None:
        out = out + bias
    return out


def _parent_fwd_impl(x, w, parent, kslot):
    """out[o] = x[parent[o]] @ w[kslot[o]]; rows whose slot matches no
    kernel slot (kslot == K) contribute zero."""
    g = x[parent.long()]
    acc = torch.zeros((parent.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    ks = kslot.long()
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for k in range(w.shape[0]):
        gk = torch.where((ks == k)[:, None], g, zero)
        acc = acc + gk.to(torch.float32) @ w[k].to(torch.float32)
    return acc.to(x.dtype)


def sparse_conv_parent(x, w, pmap, bias=None):
    """Apply a transpose conv through a ParentMap (one parent per output
    row)."""
    if pmap.num_slots != w.shape[0]:
        raise ValueError(f"ParentMap has {pmap.num_slots} slots, w {w.shape[0]}")
    out = _parent_fwd_impl(x, w, pmap.parent, pmap.kslot)
    if bias is not None:
        out = out + bias
    return out


def pointwise_conv(x, w, bias=None) -> torch.Tensor:
    """Kernel-size-1 conv == dense matmul over the feature dim."""
    if w.dim() == 3:
        if w.shape[0] != 1:
            raise ValueError(f"pointwise kernel has {w.shape[0]} slots")
        w = w[0]
    out = (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out
