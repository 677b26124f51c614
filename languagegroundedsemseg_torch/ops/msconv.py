"""Masked-shift fused sparse convolution for stride-1 k3 kernels (forward).

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
"""

from __future__ import annotations

import torch


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


def masked_shift_conv(x, w, msmap, bias=None) -> torch.Tensor:
    """Apply a stride-1 k3 sparse conv through a MaskedShiftMap, in f32.

    Exact: sentinel rows serve every gap case and the ov COO serves the
    window outliers. Returns (cap, Cout) f32."""
    out = _ms_fwd_impl(x, w, msmap.mp, msmap.mn, msmap.mc,
                       _abs_anchors(msmap.anchors), msmap.ov_in, msmap.ov_out,
                       msmap.ov_off, tuple(msmap.cols))
    out = out.to(x.dtype).to(torch.float32)
    if bias is not None:
        out = out + bias * msmap.mc[:, None].to(torch.float32)
    return out
