"""The benchmark's yardstick: the card's peaks, the model FLOPs a train
step requires, and the work of the hand-written kernels' launches.

Model FLOPs (``step_flops``) count what the step must compute, from the
batch's own voxel coordinates: 2 * pairs * c_in * c_out for every sparse
conv (a k3 conv's pairs are its valid neighbour pairs; a stride-2 conv's
and a transposed conv's are their child rows), 2 * N * c_in * c_out for
every pointwise layer, and the backward as twice the forward. Neither
recomputation nor the padded or unused columns of an implementation count.

Kernel work (``sel_fwd_bounds``, ``dw_bounds``) is a frozen copy of the
port's smoke script's ``sel_work`` / ``dw_work`` / ``_bound`` arithmetic:
each input byte read once, each output byte written once, against the
operations at the peak of their type; the least time of a launch is the
larger of the two. The launches of one step follow the model: per k3 conv
on a window-annotated map one ``sel_fwd`` for the forward (width c_out
padded to 8), one for the dX (width c_in padded to 8) except the input
conv's, and one ``dw`` (3 c_in x c_out padded to 8).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from lgsb.reference import NUM_LEVELS, Arch, Geometry

# (name substring, HBM bytes/s, dense bf16 tensor-core FLOP/s, f32 FLOP/s
# outside the tensor cores): NVIDIA's data sheets, dense rates, full power
PEAKS = (
    ("H200", 4.8e12, 989e12, 67e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100", 3.35e12, 989e12, 67e12),
)


def peaks(device_name: str) -> Tuple[float, float, float]:
    for key, bw, bf16, f32 in PEAKS:
        if key in device_name:
            return bw, bf16, f32
    raise RuntimeError(f"no peaks on record for {device_name!r}")


def convs(a: Arch, representation_only: bool):
    """Every conv of the model: (kind, level, c_in, c_out, is_input).
    kind: 'k3' (level's k3 map), 'down' (level -> level + 1), 'up'
    (level + 1 -> level), 'pw' (pointwise at level)."""
    P, L = a.planes, a.layers
    out = [("k3", 0, a.in_channels, a.init_dim, True)]

    def block(ci, planes, l):
        out.append(("k3", l, ci, planes, False))
        out.append(("k3", l, planes, planes, False))
        if ci != planes:
            out.append(("pw", l, ci, planes, False))

    c = a.init_dim
    for e in range(4):
        out.append(("down", e, c, c, False))
        for i in range(L[e]):
            block(c if i == 0 else P[e], P[e], e + 1)
        c = P[e]
    skip_c = [P[2], P[1], P[0], a.init_dim]
    for d in range(4):
        lvl = 4 - d
        out.append(("up", lvl - 1, c, P[4 + d], False))
        for i in range(L[4 + d]):
            block(P[4 + d] + skip_c[d] if i == 0 else P[4 + d], P[4 + d], lvl - 1)
        c = P[4 + d]
    if not representation_only:
        out.append(("pw", 0, c, a.out_channels, False))
    return out


def forward_flops(a: Arch, geo: Geometry, representation_only: bool) -> float:
    pairs = [geo.pairs(l) for l in range(NUM_LEVELS)]
    rows = [geo.num(l) for l in range(NUM_LEVELS)]
    total = 0.0
    for kind, l, ci, co, _ in convs(a, representation_only):
        n = pairs[l] if kind == "k3" else rows[l]
        total += 2.0 * n * ci * co
    return total


def step_flops(a: Arch, geo: Geometry, representation_only: bool) -> float:
    return 3.0 * forward_flops(a, geo, representation_only)


# ---- the hand-written kernels' launches (frozen copies of the decoders) ----


def _abs_anchors(anchors: torch.Tensor) -> torch.Tensor:
    """int16 anchor deltas (-32768 = guard) -> absolute int32 rows."""
    if anchors.dtype != torch.int16:
        return anchors
    cap = anchors.shape[-1]
    rows = torch.arange(cap, dtype=torch.int32, device=anchors.device)
    a = rows + anchors.to(torch.int32)
    return torch.where(anchors == -32768, torch.full_like(a, cap), a)


def _entry_cols(ov_off, n):
    j = torch.arange(n, dtype=torch.int64, device=ov_off.device)
    return torch.searchsorted(ov_off[1:-1].to(torch.int64), j, right=True)


def _inverse(anchors, ov_in, ov_out, ov_off, dwov_in, dwov_off):
    """The dW inverse tiling of a k3 map (each column's scatter of the
    complete pair set, the dW overflow entries guarded)."""
    n_cols, cap = anchors.shape
    dev = anchors.device
    a_full = torch.cat([anchors.long(), torch.full((n_cols, 1), cap, device=dev,
                                                   dtype=torch.long)], dim=1)
    if ov_in.shape[0]:
        a_full[_entry_cols(ov_off, ov_in.shape[0]), ov_out.long()] = ov_in.long()
    o = torch.arange(cap + 1, dtype=torch.int32, device=dev).expand(n_cols, -1)
    inv = torch.full((n_cols, cap + 1), cap, dtype=torch.int32, device=dev)
    inv.scatter_(1, a_full, o)
    if dwov_in.shape[0]:
        inv[_entry_cols(dwov_off, dwov_in.shape[0]), dwov_in.long()] = cap
    return inv[:, :cap]


def _windowed(m) -> bool:
    cap = int(m.mc.shape[0])
    return bool(m.tile > 0 and m.wstart.numel() and m.inv_wstart.numel()
                and cap % m.tile == 0 and cap >= m.win)


def _in_window(idx, wstart, tile, win, cap) -> int:
    n_cols = idx.shape[0]
    t = torch.arange(cap, device=idx.device) // tile
    ws = wstart.long().view(-1, n_cols)[t].t()
    i = idx.long()
    return int(((i >= ws) & (i < ws + win) & (i < cap)).sum())


def map_work(m) -> Optional[dict]:
    """What the launches on one k3 map read: its capacity, window, the
    anchored pairs the selector adds and the dW pairs, or None when the
    map carries no window (its convs take another path)."""
    if not _windowed(m):
        return None
    cap = int(m.mc.shape[0])
    anchors = _abs_anchors(m.anchors)
    inv = _inverse(anchors, m.ov_in, m.ov_out, m.ov_off, m.dwov_in, m.dwov_off)
    return {"cap": cap, "n_cols": int(anchors.shape[0]),
            "anchors": int(anchors.numel()), "wstart": int(m.wstart.numel()),
            "inv_wstart": int(m.inv_wstart.numel()),
            "sel_hits": _in_window(anchors, m.wstart, m.tile, m.win, cap),
            "dw_hits": _in_window(inv, m.inv_wstart, m.tile, m.win, cap)}


def _pad8(c: int) -> int:
    return c + (-c) % 8


def _bound(nbytes: float, ops: float, bw: float, peak: float) -> float:
    return max(nbytes / bw, ops / peak)


def sel_fwd_bounds(a: Arch, works: Dict[int, Optional[dict]], bw: float,
                   f32_peak: float, representation_only: bool) -> List[float]:
    """Least seconds of each sel_fwd launch of one train step."""
    out = []
    for kind, l, ci, co, first in convs(a, representation_only):
        w = works.get(l) if kind == "k3" else None
        if w is None:
            continue
        for c_run in ([_pad8(co)] if first else [_pad8(co), _pad8(ci)]):
            cap, hits = w["cap"], w["sel_hits"]
            nbytes = (cap * c_run * 2 + hits * c_run * 2 + w["anchors"] * 4
                      + w["wstart"] * 4 + cap + cap * c_run * 4)
            out.append(_bound(nbytes, (hits + cap) * c_run, bw, f32_peak))
    return out


def dw_bounds(a: Arch, works: Dict[int, Optional[dict]], bw: float,
              bf16_peak: float, representation_only: bool) -> List[float]:
    """Least seconds of each dw launch of one train step."""
    out = []
    for kind, l, ci, co, _ in convs(a, representation_only):
        w = works.get(l) if kind == "k3" else None
        if w is None:
            continue
        cw, c_out, cap = 3 * ci, _pad8(co), w["cap"]
        nbytes = (cap * cw * 2 + cap * c_out * 2 + w["n_cols"] * cap * 4
                  + w["inv_wstart"] * 4 + w["n_cols"] * cw * c_out * 4)
        out.append(_bound(nbytes, 2 * w["dw_hits"] * cw * c_out, bw, bf16_peak))
    return out


def graph_works(graph) -> Dict[int, Optional[dict]]:
    """``map_work`` of each level's k3 map of a port batch's graph."""
    gm = graph.gmaps or {}
    out = {}
    for l in range(NUM_LEVELS):
        m = gm.get(f"l{l}.k3")
        out[l] = None if m is None or not hasattr(m, "wstart") else map_work(m)
    return out
