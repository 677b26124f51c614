"""Masked-shift fused sparse convolution for stride-1 k3 kernels.

Counterpart of ``languagegroundedsemseg_tpu/ops/msconv.py``. Sorted keys put
a voxel's z+-1 neighbors in its physical prev/next rows, so the table

    T3 = [x_prev * mp | x * mc | x_next * mn]    (cap + 1 rows, 3C)

serves a whole (dx, dy) offset column with ONE gathered row, anchored at
the column's dz=0 entry (or at a sentinel zero row the graph builder
interleaved at a z-run boundary). The center column needs no gather. The
overflow COO adds back the anchors the builder routed out of the windows
(those are guards in ``anchors``), so every path sums each pair once.

Only the reference's direct branch is ported (:153-170, :200-202). Its
over-budget windowed branch (:171-198) exists because the TPU's gathers
slow down past a table-size cliff, and computes the same sum.

The backward (:205-291) is gather-only and reuses the same tables: the
offset region is symmetric, so dX is the forward over the same map with
mirrored, transposed weights ``W'[k] = W[mirror(k)]^T``; dW re-gathers the
T3 rows and contracts them with the output gradient.
"""

from __future__ import annotations

import torch

from languagegroundedsemseg_torch.ops.spconv import _wt


def _t3(x, mp, mn, mc):
    """(cap, C) -> (cap+1, 3C) masked-shift table with a zero guard row."""
    xp = torch.roll(x, 1, 0) * mp[:, None].to(x.dtype)
    xn = torch.roll(x, -1, 0) * mn[:, None].to(x.dtype)
    xc = x * mc[:, None].to(x.dtype)
    t = torch.cat([xp, xc, xn], dim=1)
    return torch.cat([t, t.new_zeros((1, t.shape[1]))], dim=0)


def _wstack(w, cols):
    """(K, C, C') -> (len(cols), 3C, C') stacking each column's 3 slots."""
    return torch.stack([torch.cat([w[ka], w[kb], w[kc]], dim=0)
                        for ka, kb, kc in cols])


def _abs_anchors(anchors):
    """Decode int16 anchor deltas (production wire format: |anchor - out|
    <= GWIN_MARGIN, -32768 = guard) to absolute int32 rows; int32 anchors
    pass through."""
    if anchors.dtype != torch.int16:
        return anchors
    cap = anchors.shape[-1]
    rows = torch.arange(cap, dtype=torch.int32, device=anchors.device)
    a = rows + anchors.to(torch.int32)
    return torch.where(anchors == -32768, torch.full_like(a, cap), a)


def _entry_cols(ov_off, n):
    """Column id of each column-major COO entry from the segment starts
    (entries past the last segment get the last column; they are guards)."""
    j = torch.arange(n, dtype=torch.int64, device=ov_off.device)
    return torch.searchsorted(ov_off[1:-1].to(torch.int64), j, right=True)


def _gather_t3_rows(x, mp, mn, mc, idx):
    """Rows of T3 at ``idx`` without building T3: the guard index (== cap)
    yields a zero row, and the %cap wraparound matches ``torch.roll`` (those
    rows are masked by mp/mn exactly as in ``_t3``)."""
    cap = x.shape[0]
    dt = x.dtype
    valid = (idx < cap).to(dt)[:, None]
    j = torch.where(idx < cap, idx, torch.zeros_like(idx)).long()
    gp = x[(j - 1) % cap] * (mp[j].to(dt)[:, None] * valid)
    gc = x[j] * (mc[j].to(dt)[:, None] * valid)
    gn = x[(j + 1) % cap] * (mn[j].to(dt)[:, None] * valid)
    return torch.cat([gp, gc, gn], dim=1)


def _ov_fwd(x, mp, mn, mc, ws, ov_in, ov_out, ov_off, n_out, c_out):
    """Window-overflow COO: out[ov_out] += T3[ov_in] @ ws[col + 1]. Guard
    entries gather the zero row and land in the dropped row n_out."""
    if ov_in.shape[0] == 0:
        return 0.0
    g = _gather_t3_rows(x, mp, mn, mc, ov_in).to(torch.float32)
    col = _entry_cols(ov_off, ov_in.shape[0])
    contrib = torch.zeros((g.shape[0], c_out), dtype=torch.float32,
                          device=x.device)
    for gi in range(ws.shape[0] - 1):
        contrib = torch.where((col == gi)[:, None],
                              g @ ws[gi + 1].to(torch.float32), contrib)
    out = torch.zeros((n_out + 1, c_out), dtype=torch.float32, device=x.device)
    return out.index_add_(0, ov_out.long(), contrib)[:-1]


def _ms_fwd_impl(x, w, mp, mn, mc, anchors, ov_in, ov_out, ov_off, cols):
    cap = x.shape[0]
    c_out = w.shape[2]
    t3 = _t3(x, mp, mn, mc).to(torch.float32)
    ws = _wstack(w, cols).to(torch.float32)
    # center column: T3 rows are exactly the outputs' triples — no gather
    acc = t3[:-1] @ ws[0]
    for k in range(anchors.shape[0]):
        acc = acc + t3[anchors[k].long()] @ ws[k + 1]
    acc = acc + _ov_fwd(x, mp, mn, mc, ws, ov_in, ov_out, ov_off, cap, c_out)
    return acc * mc[:, None].to(torch.float32)


def _put_cols(dw, cols, c, dwg):
    """Add a (3C, Cout) column contraction into the per-slot list ``dw``:
    third j of the column belongs to slot cols[j]."""
    for j, k in enumerate(cols):
        piece = dwg[j * c:(j + 1) * c]
        dw[k] = piece if dw[k] is None else dw[k] + piece


def _ov_dw_pieces(x, mp, mn, mc, g32, ov_in, ov_out, ov_off, n_cols):
    """dW of a COO: per column, gathered T3 rows^T @ gradient rows. Yields
    (column index, (3C, Cout) piece). Guard entries (in = cap, out = cap)
    gather zero rows on both sides."""
    if not ov_in.shape[0]:
        return
    cap = x.shape[0]
    gl = _gather_t3_rows(x, mp, mn, mc, ov_in).to(torch.float32)
    g_pad = torch.cat([g32, g32.new_zeros((1, g32.shape[1]))])
    go = g_pad[torch.clamp(ov_out.long(), max=cap)]
    col = _entry_cols(ov_off, ov_in.shape[0])
    zero = torch.zeros((), device=go.device)
    for gi in range(n_cols):
        yield gi, gl.t() @ torch.where((col == gi)[:, None], go, zero)


def _ms_dw_impl(x, g32, mp, mn, mc, anchors, ov_in, ov_out, ov_off, cols,
                k_num):
    """dW[k] = gathered_k^T @ dOut, re-gathering the fused rows (f32)."""
    c = x.shape[1]
    t3 = _t3(x, mp, mn, mc).to(torch.float32)
    dw = [None] * k_num
    _put_cols(dw, cols[0], c, t3[:-1].t() @ g32)
    for gi, col in enumerate(cols[1:]):
        _put_cols(dw, col, c, t3[anchors[gi].long()].t() @ g32)
    for gi, dcol in _ov_dw_pieces(x, mp, mn, mc, g32, ov_in, ov_out, ov_off,
                                  len(cols) - 1):
        _put_cols(dw, cols[gi + 1], c, dcol)
    zero = g32.new_zeros((c, g32.shape[1]))
    return torch.stack([zero if d is None else d for d in dw])


class _MaskedShiftConv(torch.autograd.Function):
    """The reference's ``_ms_core`` custom VJP (:264-291). Saves x and w
    only; the backward rebuilds T3."""

    @staticmethod
    def forward(ctx, x, w, msmap, anchors):
        m = msmap
        out = _ms_fwd_impl(x, w, m.mp, m.mn, m.mc, anchors, m.ov_in,
                           m.ov_out, m.ov_off, tuple(m.cols))
        ctx.save_for_backward(x, w, anchors)
        ctx.msmap = msmap
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g_out):
        x, w, anchors = ctx.saved_tensors
        m = ctx.msmap
        g32 = g_out.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the T3 build masks g's center third with mc (the forward's
            # output mask, applied on the o side); the trailing * mc zeroes
            # sentinel-row grads
            dx = _ms_fwd_impl(g32, _wt(w, m.mirror_perm), m.mp, m.mn,
                              m.mc, anchors, m.ov_in, m.ov_out, m.ov_off,
                              tuple(m.cols)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _ms_dw_impl(x, g32 * m.mc[:, None].to(torch.float32), m.mp,
                             m.mn, m.mc, anchors, m.ov_in, m.ov_out, m.ov_off,
                             tuple(m.cols), w.shape[0]).to(w.dtype)
        return dx, dw, None, None


def masked_shift_conv(x, w, msmap, bias=None) -> torch.Tensor:
    """Apply a stride-1 k3 sparse conv through a MaskedShiftMap, in f32.

    Exact: sentinel rows serve every gap case and the ov COO serves the
    window outliers. Returns (cap, Cout) f32."""
    out = _MaskedShiftConv.apply(x, w, msmap, _abs_anchors(msmap.anchors))
    out = out.to(torch.float32)
    if bias is not None:
        out = out + bias * msmap.mc[:, None].to(torch.float32)
    return out
