"""The port's Res16UNet34D language-grounded pretraining step against the
benchmark's plain reference (``benchmark/lgsb/reference.py``), on the CPU.

One representation step of the port, as the benchmark's
``res16unet34d_lg`` configuration defines it (``models.load_model``,
``make_representation_objective``, ``make_train_step(...,
representation_only=True)``, the seeded weights and anchors of
``benchmark/lgsb/workload.py``), on one ~1,500-point scene, against the
reference's ``forward(..., representation_only=True)`` and ``contrastive``
on the same voxels, colours, labels and negatives. The reference imports
no JAX and nothing of the port. The port computes its sparse convs from
bf16 operands and rounds each projection to bf16 by design (the reference
is float32), and train-mode batch norms at random weights over ~1,000
rows amplify that rounding from stage to stage backwards (PERF.md §6,
PR 18 and the bring-up's findings), so the tolerances, each read off this
seed and written beside its reading:

* features: the worst voxel's gap norm over its or the median voxel's
  norm, 0.2 (reads 0.080; the cell's ``output_gap`` limit is 0.4). With the
  final ReLU left in, 0.65.
* loss: relative gap 2e-3 (reads 5e-5; the cell's ``loss_gap`` limit is
  1.5e-3). With the final ReLU left in, 5.8e-3.
* every leaf's gradient, as the benchmark's judge reads it: the gap of its
  two norms over its or the median leaf's norm, at most 0.5 (reads 0.28 at
  the worst leaf, a first-stage batch norm's scale or shift, a sum over
  every row with much cancellation), 0.03 at the median leaf
  (res16unet34c's ``grad_gap`` limit; reads 0.015); and the last norm's two leaves, whose
  gradient is the loss's own summed over the rows, by the norm of their
  gap, 0.05 (reads 0.014 and 0.0008). The classifier ``final.*`` gets no
  gradient in either.
"""

import json
import os
import sys
from functools import lru_cache

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark"))

from lgsb import reference, workload  # noqa: E402

SEED = 2 ** 31 + 22
CFG_FILE = os.path.join(REPO, "benchmark", "configs", "res16unet34d_lg.json")
FEATURE_TOL, LOSS_TOL, LEAF_TOL, MEDIAN_LEAF_TOL, LAST_NORM_TOL = 0.2, 2e-3, 0.5, 0.03, 0.05
LAST_NORM = "block8.1.norm2.bn."


@lru_cache(maxsize=None)
def _port():
    """The port's first step: its features on the kept voxels, its loss,
    its gradients, and the inputs the reference needs."""
    from languagegroundedsemseg_torch.config import Config
    from languagegroundedsemseg_torch.data.batching import BatchBuilder
    from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
    from languagegroundedsemseg_torch.models import load_model
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec
    from languagegroundedsemseg_torch.train.objectives import (
        make_representation_objective,
    )
    from languagegroundedsemseg_torch.train.solvers import sgd_torch
    from languagegroundedsemseg_torch.train.state import TrainState
    from languagegroundedsemseg_torch.train.step import fold_in, make_train_step

    with open(CFG_FILE) as f:
        cfg = json.load(f)
    arch = workload.arch_of(cfg)
    weights = workload.make_weights(arch, SEED, "cpu")
    anchors = workload.make_anchors(cfg["num_classes"], cfg["anchor_dim"], SEED)
    coords, feats, labels = voxelize_scene(np.random.default_rng(SEED), 1500)
    batch, lay = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=2048) \
        .build_host([(coords, feats, labels)], return_layout=True)

    model = load_model(cfg["model"])(
        in_channels=3, out_channels=cfg["num_classes"], conv1_kernel_size=3,
        bn_momentum=cfg["bn_momentum"], device="cpu",
        generator=torch.Generator().manual_seed(0), max_batch=2)
    model.load_state_dict({k: v.clone() for k, v in weights.items()})
    port_cfg = Config(use_embedding_loss=cfg["use_embedding_loss"],
                      embedding_loss_type=cfg["embedding_loss_type"],
                      num_negative_samples=cfg["num_negative_samples"],
                      contrast_neg_thresh=cfg["contrast_neg_thresh"],
                      ignore_label=255, balanced_category_sampling=False)
    objective = make_representation_objective(port_cfg, anchors[:, None, :],
                                              device="cpu")
    opt = sgd_torch(model.parameters(), cfg["lr"], momentum=cfg["momentum"],
                    dampening=cfg["dampening"], weight_decay=cfg["weight_decay"])
    step = make_train_step(model, opt, objective, representation_only=True,
                           device="cpu")
    out = {}
    hook = model.register_forward_hook(
        lambda _m, _i, o: out.__setitem__("features", o[0].detach()))
    gen = torch.Generator().manual_seed(7)
    _, metrics = step(TrainState(model, opt), batch, gen)
    hook.remove()

    pos0 = torch.as_tensor(lay["pos0"]).long()
    dev_batch = batch.to("cpu").decompact()
    # the objective's first draw: the negatives over every padded row
    r = torch.randint(0, cfg["num_classes"] - 1,
                      (dev_batch.feats.shape[0], cfg["num_negative_samples"]),
                      generator=fold_in(gen, 0))
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return {"cfg": cfg, "arch": arch, "weights": weights,
            "anchors": torch.as_tensor(anchors),
            "coords": torch.as_tensor(coords, dtype=torch.int64)[lay["order"]],
            "x": dev_batch.feats[pos0].float(),
            "y": dev_batch.labels[pos0].long(), "r": r[pos0],
            "features": out["features"][pos0], "loss": float(metrics["loss"]),
            "grads": grads}


def _reference(port, final_relu=False):
    """The reference's step on the port's kept voxels, rows back in the
    port's kept order: (features, loss, gradients). ``final_relu`` keeps
    the last block's ReLU, which Res16UNet34D's representation drops."""
    reference.strict_numerics()
    params = {n: w.clone().requires_grad_(not reference.is_buffer(n))
              for n, w in port["weights"].items()}
    coords = torch.cat([torch.zeros_like(port["coords"][:, :1]), port["coords"]], 1)
    geo = reference.Geometry(coords)
    o0 = geo.order0
    _, feat = reference.forward(port["arch"], params, port["x"][o0], geo, True)
    if final_relu:
        feat = torch.relu(feat)
    y, r = port["y"][o0], port["r"][o0]
    neg = r + (r >= y.clamp(0, port["cfg"]["num_classes"] - 1)[:, None]).long()
    loss = reference.contrastive(feat, y, port["anchors"], neg,
                                 neg_thresh=port["cfg"]["contrast_neg_thresh"])
    loss.backward()
    kept = torch.empty_like(feat)
    kept[o0] = feat.detach()
    grads = {n: p.grad for n, p in params.items() if p.grad is not None}
    return kept, loss.item(), grads


def _gaps(port, ref):
    """(features' worst voxel gap, loss gap, each leaf's gap of gradient
    norms, each leaf's norm of the gradient gap), the leaves' over their
    own or the median leaf's norm."""
    feat, loss, grads = ref
    size = torch.linalg.vector_norm(feat, dim=1)
    gap = torch.linalg.vector_norm(port["features"] - feat, dim=1)
    feature_gap = float((gap / torch.clamp(size, min=float(size.median()))).max())
    loss_gap = abs(port["loss"] - loss) / abs(loss)
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
    med = float(np.median(list(norms.values())))
    of_norms = {n: abs(float(torch.linalg.vector_norm(port["grads"][n])) - v)
                / max(v, med) for n, v in norms.items()}
    of_gap = {n: float(torch.linalg.vector_norm(port["grads"][n] - g))
              / max(norms[n], med) for n, g in grads.items()}
    return feature_gap, loss_gap, of_norms, of_gap


def test_34d_pretraining_step_matches_the_plain_reference():
    port = _port()
    ref = _reference(port)
    assert set(port["grads"]) == set(ref[2])
    assert not [n for n in port["grads"] if n.startswith("final.")]
    feature_gap, loss_gap, of_norms, of_gap = _gaps(port, ref)
    last = {n: v for n, v in of_gap.items() if n.startswith(LAST_NORM)}
    print(json.dumps({"feature_gap": feature_gap, "loss_gap": loss_gap,
                      "leaf_worst": max(of_norms.items(), key=lambda kv: kv[1]),
                      "leaf_median": float(np.median(list(of_norms.values()))),
                      "last_norm": last}))
    assert feature_gap <= FEATURE_TOL
    assert loss_gap <= LOSS_TOL
    assert max(of_norms.values()) <= LEAF_TOL
    assert float(np.median(list(of_norms.values()))) <= MEDIAN_LEAF_TOL
    assert len(last) == 2 and max(last.values()) <= LAST_NORM_TOL


def test_the_comparison_fails_with_the_final_relu_left_in():
    """The reference with Res16UNet34D's last ReLU kept (the supervised
    model's decoder) is a different model: its features and its loss fail
    the comparison."""
    port = _port()
    feature_gap, loss_gap, _, _ = _gaps(port, _reference(port, final_relu=True))
    assert feature_gap > 2 * FEATURE_TOL
    assert loss_gap > 2 * LOSS_TOL
