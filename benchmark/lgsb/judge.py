"""The reference follows the program's three proof steps, and the numbers
that decide ``correct``.

Numbers compared (each against its limit in the configuration file):

* ``batch_mismatch``: voxels, colours and labels of the three proof
  batches that differ from what the reference works out again from the raw
  scenes and the seed (scenes, their dropping at the voxel limit, every
  voxel's coordinates, its colour as the loader ships it, its label).
  Exact: limit 0.
* ``output_gap``: the first step's output (logits, or a contrastive model's features),
  by the worst voxel: the norm of its gap over its reference norm or the
  median voxel's, whichever is larger.
* ``loss_gap``: the largest relative gap of the three steps' losses.
* ``grad_gap``: the first gradient as the optimizer got it (its momentum
  buffer after one step, less the weight decay), by the median leaf: each
  leaf's gap of the two norms over the reference's norm of that leaf or of
  the median leaf, whichever is larger. (The worst leaf, a batch norm's
  scale or shift in the first encoder stages, swings from seed to seed
  with the sparse convs' bf16 rounding; it is kept under ``detail``.)
* ``change_gap``: the same of each leaf's change after three steps
  (parameters and batch-norm running statistics).
* ``stage_gap``: in the first step, each batch norm's and the head's
  output against float32 arithmetic from that stage's own input, the
  widest gap over the largest magnitude, worst stage. The sparse convs of
  the float32 configuration take bf16 operands by design, so the other
  numbers read bf16 rounding in sound runs too; this one reads the stages
  that the configuration computes in float32, and separates the bf16 path.

Leaves whose reference gradient is below a thousandth of the median
leaf's move by round-off alone and are left out of both gaps by that rule.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from lgsb import pipeline_ref, reference
from lgsb.reference import Geometry

NUMBERS = ("batch_mismatch", "output_gap", "loss_gap", "grad_gap", "change_gap",
           "stage_gap")


def fold_in_seed(initial_seed: int, data: int) -> int:
    """The seed of a generator folded with ``data`` (the train step's
    per-step generator)."""
    return int(np.random.SeedSequence([initial_seed, int(data)])
               .generate_state(1, np.uint64)[0])


def reference_batch(raw, seed: int, n_pool: int, batch: int, shuffle: bool,
                    limit: int, k: int, workers: int = 8):
    """The k-th batch worked out again: per scene (coords, colours,
    labels) of the scenes the loader hands the builder, and how many of
    them the voxel limit keeps."""
    idx = pipeline_ref.batch_indices(seed, n_pool, batch, shuffle, k)

    def one(j):
        return pipeline_ref.voxelized_scene(*raw[idx[j]],
                                            pipeline_ref.scene_rng(seed, k, j))

    with ThreadPoolExecutor(workers) as ex:
        sc = list(ex.map(one, range(len(idx))))
    total, kept = 0, 0
    for j, (c, _, _) in enumerate(sc):
        if total + len(c) > limit and j > 0:
            break
        total += len(c)
        kept += 1
    return sc, kept


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """Each leaf's gap of norms over its reference norm or the median
    leaf's, whichever is larger."""
    names = list(names)
    med = float(np.median([ref[n] for n in names])) if names else 0.0
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def _worst(gaps: Dict[str, float]) -> float:
    return max(gaps.values()) if gaps else float("nan")


def _top(gaps: Dict[str, float], prog, ref, n: int = 3):
    return [[k, v, prog.get(k, 0.0), ref[k]]
            for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n]]


def follow(cfg: dict, traffic: dict, loader_seed: int, raw, n_pool: int,
           weights: Dict[str, torch.Tensor], anchors, proof, gen_seed: int,
           device) -> Dict[str, float]:
    """Run the reference through the proof steps and compare. The batches
    are worked out again from the raw scenes and the loader's seed."""
    from lgsb.workload import PROOF_STEPS, arch_of

    reference.strict_numerics()
    dev = torch.device(device)
    arch = arch_of(cfg)
    representation = cfg["objective"] == "contrastive"
    params = {n: w.detach().to(dev, torch.float32).clone() for n, w in weights.items()}
    p0 = {n: t.clone() for n, t in params.items()}
    for n, t in params.items():
        t.requires_grad_(not reference.is_buffer(n))
    trainable = {n: t for n, t in params.items() if t.requires_grad}
    sgd = reference.SGD(cfg["lr"], cfg["momentum"], cfg["dampening"],
                        cfg["weight_decay"])
    anchors_t = None if anchors is None else torch.as_tensor(anchors, device=dev)
    mismatch = 0
    losses: List[float] = []
    grads: Dict[str, float] = {}
    output_gap = float("nan")
    for k in range(PROOF_STEPS):
        pb = proof.batches[k]
        sc, kept = reference_batch(raw, loader_seed, n_pool, cfg["batch_size"],
                                   traffic["shuffle"], cfg["train_limit_numpoints"],
                                   pb["counter"])
        lay = pb["layout"]
        # what the loader handed the builder, scene by scene
        if len(lay["coords"]) != len(sc):
            mismatch += 1
        for j, (c, _, _) in enumerate(sc):
            if j >= len(lay["coords"]) or not np.array_equal(lay["coords"][j], c):
                mismatch += len(c)
        if lay["scenes_dropped"] != len(sc) - kept:
            mismatch += 1
        sc = sc[:kept]
        coords = pipeline_ref.batched([c for c, _, _ in sc])
        wire, feats = pipeline_ref.wire_feats([f for _, f, _ in sc])
        labels = np.concatenate([l for _, _, l in sc]).astype(np.int64)
        # the step's rows: voxel order[j] sits on padded row pos0[j]
        order = lay["order"]
        if len(order) != len(coords):
            mismatch += abs(len(coords) - len(order))
        else:
            got = pb["wire"]
            mismatch += (len(order) if got.dtype != wire.dtype else
                         int((got != wire[order]).any(axis=1).sum()))
            mismatch += int((pb["labels"] != labels[order]).sum())

        geo = Geometry(torch.as_tensor(coords, device=dev))
        o0 = geo.order0
        x = torch.as_tensor(feats, device=dev)[o0]
        y = torch.as_tensor(labels, device=dev)[o0]
        logits, feat_out = reference.forward(arch, params, x, geo, representation)
        if representation:
            s = cfg["num_negative_samples"]
            g = torch.Generator(device=dev).manual_seed(fold_in_seed(gen_seed, k))
            r = torch.randint(0, cfg["num_classes"] - 1, (pb["cap"], s),
                              generator=g, device=dev)
            row = np.full(len(coords), 0, np.int64)
            row[order[:len(coords)]] = lay["pos0"][:len(coords)]
            r = r[torch.as_tensor(row, device=dev)[o0]]
            neg = r + (r >= y.clamp(0, cfg["num_classes"] - 1)[:, None]).long()
            loss = reference.contrastive(feat_out, y, anchors_t, neg,
                                         neg_thresh=cfg["contrast_neg_thresh"])
            out = feat_out
        else:
            loss = reference.cross_entropy(logits, y)
            out = logits
        loss.backward()
        losses.append(loss.item())
        if k == 0:
            ref_out = torch.empty_like(out)
            ref_out[o0] = out.detach()
            ref_out = ref_out.cpu()
            if len(order) == len(coords):
                want = ref_out[torch.as_tensor(order)]
                gap = torch.linalg.vector_norm(proof.output - want, dim=1)
                size = torch.linalg.vector_norm(want, dim=1)
                output_gap = float((gap / torch.clamp(size, min=max(
                    float(size.median()), 1e-30))).max())
            grads = {n: float(torch.linalg.vector_norm(t.grad)) if t.grad is not None
                     else 0.0 for n, t in trainable.items()}
            del ref_out
        sgd.step(trainable)
        for t in trainable.values():
            t.grad = None
        del logits, feat_out, out, loss, geo
    change = {n: float(torch.linalg.vector_norm(params[n].detach() - p0[n]))
              for n in params}
    med_grad = float(np.median(list(grads.values())))
    moved = [n for n, g in grads.items() if g >= 1e-3 * med_grad]
    kept_leaves = moved + [n for n in params if reference.is_buffer(n)]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(proof.losses, losses))
    g_gaps = _leaf_gaps(proof.grad_norms, grads, moved)
    c_gaps = _leaf_gaps(proof.change_norms, change, kept_leaves)
    return {
        "batch_mismatch": float(mismatch),
        "output_gap": output_gap,
        "loss_gap": loss_gap,
        "grad_gap": float(np.median(list(g_gaps.values()))),
        "change_gap": _worst(c_gaps),
        "stage_gap": proof.stage_gap,
        "_losses_ref": losses,
        "_losses_prog": list(proof.losses),
        "_leaves_left_out": sorted(set(grads) - set(moved)),
        "_grad_worst": _top(g_gaps, proof.grad_norms, grads),
        "_change_worst": _top(c_gaps, proof.change_norms, change),
        "_grad_worst_leaf_gap": _worst(g_gaps),
        "_change_median_leaf_gap": float(np.median(list(c_gaps.values()))),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the configuration holds to a limit within it; a number
    that is not a number fails, and so does a configuration with no
    limits."""
    if not limits:
        return False
    for name, lim in limits.items():
        v = numbers.get(name)
        if v is None or not np.isfinite(v) or v > lim:
            return False
    return True
