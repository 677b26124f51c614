"""Plain reference of the training step: Res16UNet by coordinate lookup,
its objectives and SGD, in float32 with TF32 off.

Written from the published architecture (MinkowskiEngine's Res16UNet of
the reference repository, models/res16unet.py and
models/modules/resnet_block.py) and the reference trainers' losses, in
plain PyTorch. It imports nothing of the port and takes nothing the port
made: it builds its own coordinate pyramid and neighbour tables from the
voxel coordinates, holds only real voxels (no padding, no sentinels), and
trains its own copy of the weights the benchmark made.

Conventions (MinkowskiEngine's): level l holds the voxels
floor(c / 2^l) * 2^l; a stride-1 conv with kernel size 3 sums
W[k]^T x(u + o_k 2^l) over the 27 offsets o_k in {-1, 0, 1}^3, the last
axis fastest; a stride-2 conv with kernel size 2 sends child c to parent
p = floor(c / 2^(l+1)) * 2^(l+1) through slot k of (c - p) / 2^l in
{0, 1}^3; the transposed conv sends p back to c through the same slot.
Batch norm uses the valid rows' biased variance, and updates its running
statistics with the unbiased one at momentum 0.02.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

NUM_LEVELS = 5
BN_EPS, BN_MOMENTUM = 1e-5, 0.02
K3 = np.array(list(itertools.product((-1, 0, 1), repeat=3)), np.int64)


def strict_numerics() -> None:
    """float32 products in float32: no TF32, no reduced-precision sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


def _key(c: torch.Tensor) -> torch.Tensor:
    """(N, 4) int64 (b, x, y, z) -> int64 keys, 16 bits a coordinate."""
    xyz = c[:, 1:] + (1 << 15)
    return (c[:, 0] << 48) | (xyz[:, 0] << 32) | (xyz[:, 1] << 16) | xyz[:, 2]


def _find(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row of each query key in the sorted ``keys``, -1 where absent."""
    i = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    return torch.where(keys[i] == q, i, torch.full_like(i, -1))


@dataclass
class Pairs:
    """(output rows, input rows) of one kernel slot."""
    out: torch.Tensor
    src: torch.Tensor


class Geometry:
    """The coordinate pyramid of one batch and its kernel maps.

    ``coords0``: (N, 4) int64 (scene, x, y, z), unique rows. Level rows are
    in ascending key order; ``order0[i]`` is the row of ``coords0`` that
    level 0's row i holds."""

    def __init__(self, coords0: torch.Tensor):
        c0 = coords0.to(torch.int64)
        k0 = _key(c0)
        k0_sorted, order0 = torch.sort(k0)
        if k0_sorted.numel() > 1 and bool((k0_sorted[1:] == k0_sorted[:-1]).any()):
            raise ValueError("duplicate voxels in the batch")
        self.order0 = order0
        self.coords = [c0[order0]]
        self.keys = [k0_sorted]
        for l in range(1, NUM_LEVELS):
            s = 1 << l
            p = self.coords[-1].clone()
            p[:, 1:] = torch.div(p[:, 1:], s, rounding_mode="floor") * s
            kp = torch.unique(_key(p))
            self.keys.append(kp)
            self.coords.append(self._unkey(kp))
        self.k3 = [self._k3(l) for l in range(NUM_LEVELS)]
        self.down = [self._down(l) for l in range(NUM_LEVELS - 1)]

    @staticmethod
    def _unkey(k: torch.Tensor) -> torch.Tensor:
        m = (1 << 16) - 1
        return torch.stack([k >> 48, ((k >> 32) & m) - (1 << 15),
                            ((k >> 16) & m) - (1 << 15), (k & m) - (1 << 15)], 1)

    def num(self, l: int) -> int:
        return int(self.keys[l].numel())

    def _k3(self, l: int) -> List[Pairs]:
        c, keys = self.coords[l], self.keys[l]
        rows = torch.arange(c.shape[0], device=c.device)
        out = []
        for o in K3:
            q = c.clone()
            q[:, 1:] += torch.as_tensor(o * (1 << l), device=c.device)
            j = _find(keys, _key(q))
            hit = j >= 0
            out.append(Pairs(rows[hit], j[hit]))
        return out

    def _down(self, l: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(parent row of every level-l row, the level-l rows of each of
        the 8 slots)."""
        c = self.coords[l]
        s = 1 << (l + 1)
        p = c.clone()
        p[:, 1:] = torch.div(p[:, 1:], s, rounding_mode="floor") * s
        parent = _find(self.keys[l + 1], _key(p))
        if bool((parent < 0).any()):
            raise AssertionError("a child without its parent")
        off = torch.div(c[:, 1:] - p[:, 1:], 1 << l, rounding_mode="floor")
        slot = off[:, 0] * 4 + off[:, 1] * 2 + off[:, 2]
        return parent, [torch.nonzero(slot == k)[:, 0] for k in range(8)]

    def pairs(self, l: int) -> int:
        """Valid (output, input) pairs of level l's k3 map."""
        return int(sum(p.out.numel() for p in self.k3[l]))


class _Subm(torch.autograd.Function):
    """Stride-1 sparse conv over a level's k3 pairs. Saves only x and w:
    the backward gathers again, one slot at a time."""

    @staticmethod
    def forward(ctx, x, w, pairs):
        out = x.new_zeros((x.shape[0], w.shape[2]))
        for k, p in enumerate(pairs):
            if p.out.numel():
                out.index_add_(0, p.out, x[p.src] @ w[k])
        ctx.save_for_backward(x, w)
        ctx.pairs = pairs
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = torch.zeros_like(x), torch.zeros_like(w)
        for k, p in enumerate(ctx.pairs):
            if p.out.numel():
                gk = g[p.out]
                dx.index_add_(0, p.src, gk @ w[k].t())
                dw[k] = x[p.src].t() @ gk
        return dx, dw, None


def subm_conv(x, w, pairs):
    return _Subm.apply(x, w, pairs)


def down_conv(x, w, geo: Geometry, l: int):
    """Level l -> l + 1, kernel 2, stride 2."""
    parent, slots = geo.down[l]
    out = x.new_zeros((geo.num(l + 1), w.shape[2]))
    for k, rows in enumerate(slots):
        if rows.numel():
            out = out.index_add(0, parent[rows], x[rows] @ w[k])
    return out


def up_conv(x, w, geo: Geometry, l: int):
    """Level l + 1 -> l, the transposed kernel-2 stride-2 conv."""
    parent, slots = geo.down[l]
    vals = [x[parent[rows]] @ w[k] for k, rows in enumerate(slots)]
    perm = torch.cat(slots)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return torch.cat(vals)[inv]


def batch_norm(x, p: Dict[str, torch.Tensor], name: str):
    """Train-mode batch norm over the rows of ``x``; moves the running
    statistics in ``p``."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    n = x.shape[0]
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    with torch.no_grad():
        rm, rv = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        rm.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.detach())
        rv.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var.detach() * n / max(n - 1, 1))
    return (x - mean) * torch.rsqrt(var + BN_EPS) * w + b


@dataclass(frozen=True)
class Arch:
    """A Res16UNet of basic blocks: the stage widths and depths."""
    planes: Tuple[int, ...]
    layers: Tuple[int, ...]
    init_dim: int = 32
    in_channels: int = 3
    out_channels: int = 200
    strip_final_relu: bool = False


def param_shapes(a: Arch) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and batch-norm buffer, by the reference state_dict's
    names, with its shape."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def bn(name, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.bn.{s}"] = (c,)

    def block(name, ci, planes):
        shapes[f"{name}.conv1.kernel"] = (27, ci, planes)
        bn(f"{name}.norm1", planes)
        shapes[f"{name}.conv2.kernel"] = (27, planes, planes)
        bn(f"{name}.norm2", planes)
        if ci != planes:
            shapes[f"{name}.downsample.0.kernel"] = (ci, planes)
            bn(f"{name}.downsample.1", planes)

    P, L = a.planes, a.layers
    shapes["conv0p1s1.kernel"] = (27, a.in_channels, a.init_dim)
    bn("bn0", a.init_dim)
    c = a.init_dim
    for e in range(4):
        shapes[f"conv{e + 1}p{1 << e}s2.kernel"] = (8, c, c)
        bn(f"bn{e + 1}", c)
        for i in range(L[e]):
            block(f"block{e + 1}.{i}", c if i == 0 else P[e], P[e])
        c = P[e]
    skip_c = [P[2], P[1], P[0], a.init_dim]
    for d in range(4):
        lvl = 4 - d
        shapes[f"convtr{4 + d}p{1 << lvl}s2.kernel"] = (8, c, P[4 + d])
        bn(f"bntr{4 + d}", P[4 + d])
        for i in range(L[4 + d]):
            block(f"block{5 + d}.{i}", P[4 + d] + skip_c[d] if i == 0 else P[4 + d],
                  P[4 + d])
        c = P[4 + d]
    shapes["final.kernel"] = (c, a.out_channels)
    shapes["final.bias"] = (a.out_channels,)
    return shapes


def forward(a: Arch, p: Dict[str, torch.Tensor], feats: torch.Tensor,
            geo: Geometry, representation_only: bool = False):
    """(logits or None, decoder features), rows in level-0 key order."""

    def basic(name, x, l, final_relu=True):
        res = x
        if f"{name}.downsample.0.kernel" in p:
            res = batch_norm(x @ p[f"{name}.downsample.0.kernel"], p,
                             f"{name}.downsample.1.bn")
        out = torch.relu(batch_norm(subm_conv(x, p[f"{name}.conv1.kernel"], geo.k3[l]),
                                    p, f"{name}.norm1.bn"))
        out = batch_norm(subm_conv(out, p[f"{name}.conv2.kernel"], geo.k3[l]),
                         p, f"{name}.norm2.bn") + res
        return torch.relu(out) if final_relu else out

    out = subm_conv(feats, p["conv0p1s1.kernel"], geo.k3[0])
    out_p1 = torch.relu(batch_norm(out, p, "bn0.bn"))
    out, skips = out_p1, []
    for e in range(4):
        out = down_conv(out, p[f"conv{e + 1}p{1 << e}s2.kernel"], geo, e)
        out = torch.relu(batch_norm(out, p, f"bn{e + 1}.bn"))
        for i in range(a.layers[e]):
            out = basic(f"block{e + 1}.{i}", out, e + 1)
        skips.append(out)
    dec_skips = [skips[2], skips[1], skips[0], out_p1]
    for d in range(4):
        lvl = 4 - d
        out = up_conv(out, p[f"convtr{4 + d}p{1 << lvl}s2.kernel"], geo, lvl - 1)
        out = torch.relu(batch_norm(out, p, f"bntr{4 + d}.bn"))
        out = torch.cat([out, dec_skips[d]], dim=-1)
        strip = d == 3 and (a.strip_final_relu or representation_only)
        n = a.layers[4 + d]
        for i in range(n):
            out = basic(f"block{5 + d}.{i}", out, lvl - 1,
                        final_relu=not (strip and i == n - 1))
    if representation_only:
        return None, out
    return out @ p["final.kernel"] + p["final.bias"], out


def cross_entropy(logits, labels, ignore: int = 255):
    """Summed over the labelled voxels, over all voxels of the batch (the
    reference's balanced-sampling mean with no category subsampled)."""
    valid = labels != ignore
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.clamp(0, logits.shape[1] - 1).long()[:, None])[:, 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / labels.numel()


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def contrastive(features, labels, anchors, negatives, pos_thresh=0.0,
                neg_thresh=0.6, neg_weight=1.0, ignore: int = 255):
    """The language-grounded contrastive loss (cosine distance): the
    distance to the label's anchor above ``pos_thresh`` plus
    ``neg_weight`` times the mean distance to the sampled negative anchors
    below ``neg_thresh``, summed over the labelled voxels, over all."""
    valid = labels != ignore
    f = _unit(features)
    lab = labels.clamp(0, anchors.shape[0] - 1).long()
    d_pos = 1.0 - (f * _unit(anchors[lab])).sum(-1)
    d_neg = 1.0 - (f[:, None, :] * _unit(anchors[negatives])).sum(-1).mean(-1)
    per = torch.relu(d_pos - pos_thresh) + neg_weight * torch.relu(neg_thresh - d_neg)
    return torch.where(valid, per, torch.zeros_like(per)).sum() / labels.numel()


class SGD:
    """torch's SGD: d = g + wd p; the first step's buffer is d, later
    m buf + (1 - dampening) d; p -= lr buf. Leaves without a gradient
    are left alone."""

    def __init__(self, lr, momentum=0.9, dampening=0.1, weight_decay=1e-4):
        self.lr, self.m, self.damp, self.wd = lr, momentum, dampening, weight_decay
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor]) -> None:
        for name, t in params.items():
            if t.grad is None:
                continue
            d = t.grad + self.wd * t
            if name in self.buf:
                self.buf[name].mul_(self.m).add_((1 - self.damp) * d)
            else:
                self.buf[name] = d.clone()
            t.sub_(self.lr * self.buf[name])


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))
