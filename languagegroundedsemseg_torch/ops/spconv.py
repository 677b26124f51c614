"""Sparse convolution as gather-GEMM-accumulate over kernel offsets.

Counterpart of ``languagegroundedsemseg_tpu/ops/spconv.py``: the flat
gather-GEMM (``sparse_conv``), the parent-map conv (``sparse_conv_parent``),
the pointwise conv and the average / sum / max pools over a flat table. For each kernel slot k the op gathers the neighbor
rows the kernel map selects and multiplies them into the f32 accumulator;
missing neighbors (idx == -1) contribute zero.

The backwards recompute the gathers instead of saving the K gathered copies
of the input (reference :9-15). dW[k] = gather(x, idx_k)^T @ dOut. dX is a
scatter of dOut @ W[k]^T, or, when the graph names a transpose map, the
forward over that map with transposed weights: the mirrored slots of a
symmetric stride-1 map (``mirror_perm``), the companion ParentMap of a down
conv (``companion_parent``), the companion down table of an up conv
(``idx_down``).
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


def _wt(w, perm=None):
    """(K, Cin, Cout) -> (K, Cout, Cin) f32, slots permuted by ``perm``."""
    wt = w.to(torch.float32).transpose(1, 2)
    if perm is not None:
        wt = wt[torch.as_tensor(perm, dtype=torch.long, device=w.device)]
    return wt


def _slot_dw(a, b, kslot, n_slots):
    """(K, A, B) dW as K masked contractions: dw[k] = a[kslot == k]^T @ b,
    both f32; rows whose slot is none of the K (guards) add nothing."""
    ks = kslot.long()
    zero = torch.zeros((), device=a.device)
    return torch.stack([torch.where((ks == k)[:, None], a, zero).t() @ b
                        for k in range(n_slots)])


def _scatter_rows(src, idx, n_rows):
    """(n_rows, C) f32 sum of src rows into rows idx; idx < 0 is dropped."""
    dst = torch.where(idx >= 0, idx, torch.full_like(idx, n_rows)).long()
    out = src.new_zeros((n_rows + 1, src.shape[1]))
    return out.index_add_(0, dst, src)[:-1]


class _FlatConv(torch.autograd.Function):
    """The reference's ``_conv_core`` (:33-120) and its gather-only
    variants ``_conv_core_mirror`` (:176-210) and ``_conv_core_cparent``
    (:213-237): one forward, dX by the transpose map when there is one."""

    @staticmethod
    def forward(ctx, x, w, idx, center, mirror_perm, parent, kslot):
        ctx.save_for_backward(x, w, idx, parent, kslot)
        ctx.center, ctx.mirror_perm = center, mirror_perm
        return _conv_fwd_impl(x, w, idx, center)

    @staticmethod
    def backward(ctx, g_out):
        x, w, idx, parent, kslot = ctx.saved_tensors
        center = ctx.center
        g32 = g_out.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.mirror_perm is not None:
                dx = _conv_fwd_impl(g32, _wt(w, ctx.mirror_perm), idx, center)
            elif parent is not None:
                dx = _parent_fwd_impl(g32, _wt(w), parent, kslot)
            else:
                wt = _wt(w)
                dx = torch.zeros((x.shape[0], x.shape[1]),
                                 dtype=torch.float32, device=x.device)
                if center >= 0:
                    dx = _center_masked(g32, idx, center) @ wt[center]
                for k in range(w.shape[0]):
                    if k != center:
                        dx = dx + _scatter_rows(g32 @ wt[k], idx[k],
                                                x.shape[0])
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dws = []
            for k in range(w.shape[0]):
                gx = (_center_masked(x, idx, k) if k == center
                      else _gather_rows(x, idx[k]))
                dws.append(gx.to(torch.float32).t() @ g32)
            dw = torch.stack(dws).to(w.dtype)
        return dx, dw, None, None, None, None, None


def sparse_conv(x, w, idx, bias=None, center_slot: int = -1,
                mirror_perm=None, companion_parent=None) -> torch.Tensor:
    """Apply a sparse convolution through a flat kernel map.

    x: (cap_in, Cin); w: (K, Cin, Cout) in the map's slot order;
    idx: (K, cap_out) int32 (-1 = missing); center_slot: the slot whose map
    is the identity (no gather), -1 if none. ``mirror_perm`` (symmetric
    stride-1 maps) or ``companion_parent`` = (parent, kslot) of the
    companion ParentMap (down convs) lets the backward compute dX as a
    forward instead of a scatter. Returns (cap_out, Cout).
    """
    if not (w.dim() == 3 and idx.dim() == 2 and w.shape[0] == idx.shape[0]):
        raise ValueError(f"w {tuple(w.shape)} vs idx {tuple(idx.shape)}")
    parent, kslot = companion_parent if companion_parent is not None else (None, None)
    perm = None if mirror_perm is None else tuple(mirror_perm)
    out = _FlatConv.apply(x, w, idx, center_slot, perm, parent, kslot)
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


class _ParentConv(torch.autograd.Function):
    """The reference's ``_parent_core`` (:272-307) and
    ``_parent_core_cidx`` (:240-263): dX by scatter into the parents, or by
    the forward over the companion down table ``idx_down``; dW as K masked
    contractions against x gathered at the parents."""

    @staticmethod
    def forward(ctx, x, w, parent, kslot, idx_down):
        ctx.save_for_backward(x, w, parent, kslot, idx_down)
        return _parent_fwd_impl(x, w, parent, kslot)

    @staticmethod
    def backward(ctx, g_out):
        x, w, parent, kslot, idx_down = ctx.saved_tensors
        g32 = g_out.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if idx_down is not None:
                dx = _conv_fwd_impl(g32, _wt(w), idx_down, -1)
            else:
                wt, ks = _wt(w), kslot.long()
                zero = torch.zeros((), device=g32.device)
                dg = g32.new_zeros((parent.shape[0], x.shape[1]))
                for k in range(w.shape[0]):
                    dg = dg + torch.where((ks == k)[:, None], g32 @ wt[k],
                                          zero)
                dst = torch.where(ks < w.shape[0], parent.long(),
                                  torch.full_like(ks, -1))
                dx = _scatter_rows(dg, dst, x.shape[0])
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _slot_dw(x[parent.long()].to(torch.float32), g32, kslot,
                          w.shape[0]).to(w.dtype)
        return dx, dw, None, None, None


def sparse_conv_parent(x, w, pmap, bias=None, idx_down=None):
    """Apply a transpose conv through a ParentMap (one parent per output
    row). ``idx_down``: the companion down map's flat table, for a
    gather-only backward."""
    if pmap.num_slots != w.shape[0]:
        raise ValueError(f"ParentMap has {pmap.num_slots} slots, w {w.shape[0]}")
    out = _ParentConv.apply(x, w, pmap.parent, pmap.kslot, idx_down)
    if bias is not None:
        out = out + bias
    return out


def pointwise_conv(x, w, bias=None) -> torch.Tensor:
    """Kernel-size-1 conv == dense matmul over the feature dim, accumulated
    in f32 and returned in x's dtype (JAX's ``preferred_element_type=f32``
    then ``astype``): a bf16 x and w make one bf16 GEMM (tensor cores on
    the card, f32 accumulation, one rounding of the result)."""
    if w.dim() == 3:
        if w.shape[0] != 1:
            raise ValueError(f"pointwise kernel has {w.shape[0]} slots")
        w = w[0]
    if x.dtype == torch.bfloat16:
        out = x @ w.to(torch.bfloat16)
    else:
        out = (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


def sparse_avg_pool(x, idx) -> torch.Tensor:
    """Mean of the existing neighbors over a flat kernel map (K, cap_out)
    (ME.MinkowskiAvgPooling); rows without one are 0."""
    s = torch.zeros((idx.shape[1], x.shape[1]), dtype=torch.float32,
                    device=x.device)
    c = torch.zeros((idx.shape[1], 1), dtype=torch.float32, device=x.device)
    for ik in idx:
        s = s + _gather_rows(x, ik).to(torch.float32)
        c = c + (ik >= 0).to(torch.float32)[:, None]
    return (s / torch.clamp(c, min=1.0)).to(x.dtype)


def sparse_sum_pool(x, idx) -> torch.Tensor:
    """Sum over a flat kernel map's neighbors (ME.MinkowskiSumPooling)."""
    s = torch.zeros((idx.shape[1], x.shape[1]), dtype=torch.float32,
                    device=x.device)
    for ik in idx:
        s = s + _gather_rows(x, ik).to(torch.float32)
    return s.to(x.dtype)


def sparse_max_pool(x, idx) -> torch.Tensor:
    """Max over a flat kernel map's existing neighbors; rows without one
    are 0."""
    neg = torch.finfo(torch.float32).min
    m = torch.full((idx.shape[1], x.shape[1]), neg, dtype=torch.float32,
                   device=x.device)
    for ik in idx:
        g = torch.where((ik >= 0)[:, None], _gather_rows(x, ik).to(torch.float32),
                        torch.full((), neg, device=x.device))
        m = torch.maximum(m, g)
    return torch.where(m == neg, torch.zeros((), device=x.device), m).to(x.dtype)
