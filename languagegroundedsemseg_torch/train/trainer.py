"""Training orchestration on one device: the replacement for main.py + the
PL trainer modules (reference main.py:55-201, lib/train_test/pl_*Trainer.py).

Counterpart of ``languagegroundedsemseg_tpu/train/trainer.py`` (:53-744).
Mode selection mirrors main.py:160-175:
- ``use_embedding_loss`` set and != 'both'  -> representation pretraining
- 'Classifier' in model name               -> classifier fine-tuning
- otherwise                                -> baseline supervised training

One Trainer drives: the data loaders (worker threads, batches copied to the
device ahead of the step), the train and eval steps (``make_train_step`` /
``make_eval_step``, so on the card every conv runs the port's kernels),
metric accumulation on the device, LR scheduling incl ReduceLROnPlateau,
best-checkpoint tracking, and resume. Every tensor lives on ``device`` (the
card unless the caller asks for the CPU).

Data parallelism (JAX :85-110, :262-282, :525-570): ``num_devices`` ranks,
one process each (``torchrun``; ``parallel/mesh.py``). Each rank's loaders
build its shard, its batch norms sync over the group and its train step
averages the gradients; the weights are broadcast from rank 0 once. Each
rank validates its shard and the counts and the loss are all-reduced, so
every rank reads the same metrics (plateau and best-checkpoint decisions
agree). Rank 0 alone writes the logs, TensorBoard, the checkpoints and the
profiler trace; each rank dumps the predictions of its own scenes.

CRF wrappers (``wrapper_type``): the model is wrapped (``models/crf.py``),
both loaders ship the level-0 coords the CRF reads, the train step draws
the wrapper's coin from its generator, and the CRF's parameters train at
``wrapper_lr`` (their own parameter group, JAX's masked update scale).

Instance datasets train with ``insseg.trainer.InssegTrainer``; this
trainer refuses them. It also refuses a model whose graph spec is not the
loaders' (ResNet, the 4D ST variants): the JAX trainer builds its loaders
with the Res16UNet spec whatever the model (ROADMAP Queue 3). Not ported
yet, raising ``NotImplementedError`` with its ROADMAP Queue 1 item: the
classifier mode and its feature-resampling stage (item 7), bf16 compute and
remat (item 9).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.data.loader import initialize_data_loader, load_dataset
from languagegroundedsemseg_torch.eval.miou import (
    IoUEvaluator,
    ap_from_histograms,
    ap_histograms_torch,
    fast_hist_torch,
)
from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss
from languagegroundedsemseg_torch.losses.contrastive import feature_sim
from languagegroundedsemseg_torch.models import load_model
from languagegroundedsemseg_torch.models.layers import convert_sync_batchnorm
from languagegroundedsemseg_torch.parallel.collectives import all_reduce_sum, barrier
from languagegroundedsemseg_torch.parallel.dp import broadcast_module
from languagegroundedsemseg_torch.parallel.mesh import Mesh, make_mesh
from languagegroundedsemseg_torch.train.checkpoints import (
    CheckpointManager,
    find_resume_checkpoint,
    load_checkpoint_metadata,
    restore_checkpoint,
)
from languagegroundedsemseg_torch.train.objectives import (
    make_baseline_objective,
    make_representation_objective,
)
from languagegroundedsemseg_torch.train.solvers import initialize_optimizer, make_lr_schedule
from languagegroundedsemseg_torch.train.state import TrainState
from languagegroundedsemseg_torch.train.step import make_eval_step, make_train_step
from languagegroundedsemseg_torch.utils.observability import (
    ProfilerHook,
    TensorBoardLogger,
)


def select_mode(config: Config) -> str:
    if "Instance" in config.dataset:
        return "insseg"
    if config.use_embedding_loss and config.use_embedding_loss != "both":
        return "representation"
    if "Classifier" in config.model:
        return "classifier"
    return "baseline"


def _not_ported(config: Config, mode: str) -> None:
    """Raise for what the port does not run yet, naming its ROADMAP item."""
    if mode == "insseg":
        raise ValueError(
            f"{config.dataset} is an instance dataset: instance segmentation "
            "trains with insseg.trainer.InssegTrainer (cli.main routes it there)")
    if mode == "classifier" or config.classifier_resample_features:
        raise NotImplementedError(
            "the classifier mode and classifier_resample_features are not "
            "ported yet (ROADMAP Queue 1, item 7)")
    if config.compute_dtype != "float32" or config.remat:
        raise NotImplementedError(
            "the port computes in float32 without recomputation: "
            "compute_dtype must be 'float32' and remat False "
            "(ROADMAP Queue 1, item 9)")


def wrapped(config: Config) -> bool:
    return bool(config.wrapper_type
                and config.wrapper_type.lower() not in ("", "none"))


def check_graph_spec(model_cls, config: Config) -> None:
    """Refuse a model whose kernel maps the loaders' graphs (the
    Res16UNet spec) do not hold, naming it: JAX would fail at its first
    step."""
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec

    spec_fn = getattr(model_cls, "graph_spec", None)
    ks = config.conv1_kernel_size
    if spec_fn is not None and spec_fn(ks) != res16unet_graph_spec(ks):
        raise ValueError(
            f"{config.model}: its graph spec is not the Res16UNet spec the "
            "trainer's loaders build (ResNet and the 4D ST variants need "
            "maps those graphs lack; ROADMAP Queue 3)")


def in_head(name: str, prefixes) -> bool:
    """Whether a dotted parameter name has a component starting with one
    of ``prefixes`` (JAX labels a leaf by any key of its path, so a
    wrapped model's ``base.final.*`` counts)."""
    return any(part.startswith(tuple(prefixes)) for part in name.split("."))


class Trainer:
    def __init__(self, config: Config, mode: Optional[str] = None,
                 device="cuda", mesh: Optional[Mesh] = None):
        """``mesh``: this process's rank and group (``make_mesh``); None
        makes it from ``config.num_devices`` and ``device``."""
        self.config = config
        self.mode = mode or select_mode(config)
        _not_ported(config, self.mode)
        self.mesh = mesh or make_mesh(config.num_devices, device)
        self.device = self.mesh.device
        self.group, self.rank, self.world = self.mesh.group, self.mesh.rank, self.mesh.world
        self.log_dir = config.log_dir
        os.makedirs(self.log_dir, exist_ok=True)

        # Data. Training batches ship compact (no device-side spatial
        # coords) unless the CRF reads them; the prediction dumps read
        # coords back (_dump_batch_predictions), so the val batches carry
        # them when a dump can be asked for.
        model_cls = load_model(config.model)
        check_graph_spec(model_cls, config)
        self.wrapped = wrapped(config)
        self.DatasetClass = load_dataset(config.dataset)
        self.train_loader = initialize_data_loader(
            self.DatasetClass, config, config.train_phase,
            num_workers=config.num_workers, shuffle=True, repeat=False,
            augment_data=config.train_augmentation, batch_size=config.batch_size,
            limit_numpoints=config.train_limit_numpoints,
            ship_coords=self.wrapped,
            num_devices=self.world, rank=self.rank, device=self.device,
        )
        self.val_loader = initialize_data_loader(
            self.DatasetClass, config, config.val_phase,
            num_workers=config.num_val_workers, shuffle=False, repeat=False,
            augment_data=False, batch_size=config.val_batch_size,
            limit_numpoints=config.train_limit_numpoints,
            ship_coords=self.wrapped or bool(config.visualize)
            or bool(config.save_prediction)
            or bool(config.test_original_pointcloud),
            num_devices=self.world, rank=self.rank, device=self.device,
        )
        self.dataset = self.train_loader.dataset
        self.num_labels = self.dataset.num_train_labels

        # Model. Parameters are made on the device from a seeded generator;
        # unlike flax, no init batch is needed to infer shapes (the JAX
        # trainer's _first_batch has no counterpart here). Every rank makes
        # the same ones; rank 0's (loaded weights included) are broadcast
        # all the same.
        self.model = model_cls(
            in_channels=getattr(self.dataset, "NUM_IN_CHANNEL", 3),
            out_channels=self.num_labels,
            conv1_kernel_size=config.conv1_kernel_size,
            bn_momentum=config.bn_momentum,
            device=self.device,
            generator=torch.Generator().manual_seed(config.seed),
            max_batch=max(config.batch_size, config.val_batch_size) + 1,
        )
        if self.wrapped:
            # reference main.py load_wrapper wiring, models/wrapper.py:20-30
            from languagegroundedsemseg_torch.models import load_wrapper

            self.model = load_wrapper(config.wrapper_type)(
                self.model, self.num_labels,
                spatial_sigma=float(config.crf_spatial_sigma),
                chromatic_sigma=float(config.crf_chromatic_sigma),
                iterations=config.meanfield_iterations, device=self.device)
        self._maybe_load_weights()
        convert_sync_batchnorm(self.model, self.group)
        broadcast_module(self.model, self.group)
        self.representation_only = self.mode == "representation"

        # Objective
        anchors = getattr(self.dataset, "loaded_text_features", None)
        anchors_full = None if anchors is None else np.asarray(anchors)
        self.anchors = None if anchors_full is None else anchors_full[:, 0, :]
        self._anchors_t = (None if self.anchors is None else torch.as_tensor(
            self.anchors, dtype=torch.float32, device=self.device))
        split = getattr(self.dataset, "frequency_organized_cats", None)
        weights = getattr(self.dataset, "category_weights", None)
        if self.mode == "representation":
            if self.anchors is None:
                raise ValueError(f"representation mode needs text anchors: "
                                 f"{config.dataset} has no loaded_text_features")
            proj_w = (
                self._load_projection_weights(anchors_full.shape[-1])
                if config.instance_augmentation == "latent"
                else None
            )
            objective = make_representation_objective(
                config, anchors_full, split, projection_w=proj_w,
                device=self.device,
            )
        else:
            objective = make_baseline_objective(
                config, weights, split, self.anchors, device=self.device)
        self._objective = objective

        # Optimizer / schedule: the reference steps ALL schedulers once per
        # epoch (PL default interval='epoch', lib/solvers.py via
        # configure_optimizers), so every schedule consumes
        # floor(updates / steps_per_epoch).
        steps_per_epoch = max(len(self.train_loader), 1)
        epoch_sched = make_lr_schedule(
            config.scheduler, config.lr,
            step_size=config.step_size, step_gamma=config.step_gamma,
            multi_step_milestones=config.multi_step_milestones,
            poly_power=config.poly_power,
            max_steps=config.max_epoch if config.scheduler == "PolyLR" else config.max_iter,
            exp_gamma=config.exp_gamma, exp_step_size=config.exp_step_size,
        )
        self.schedule = lambda s: epoch_sched(s // steps_per_epoch)  # noqa: E731
        named = list(self.model.named_parameters())
        if config.classifier_only:
            # Only the model-declared classifier head is updated (reference
            # set_classifier_mode, pl_BaselineTrainer.py:411 and
            # --classifier_only, scripts/fine_tune_classifier.sh); the rest
            # still takes gradients (grad_norm reads them all) and keeps
            # its BN running statistics moving, as in JAX.
            prefixes = getattr(self.model, "classifier_trainable_prefixes", ("final",))
            named = [(n, p) for n, p in named if in_head(n, prefixes)]
        params = [p for _, p in named]
        if self.wrapped and config.lr > 0:
            # the CRF's updates scaled to an effective lr of wrapper_lr
            # (reference config wrapper_lr; JAX: a masked optax.scale)
            crf = [p for n, p in named if n.startswith("crf.")]
            params = [{"params": [p for n, p in named if not n.startswith("crf.")]},
                      {"params": crf, "lr_factor": config.wrapper_lr / config.lr}]
        optimizer = initialize_optimizer(params, config, self.schedule)
        self.state = TrainState(self.model, optimizer)

        # Steps
        self.p_train_step = make_train_step(
            self.model, optimizer, objective,
            representation_only=self.representation_only, device=self.device,
            group=self.group,
        )
        self.p_eval_step = make_eval_step(
            self.model, representation_only=self.representation_only,
            device=self.device,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)

        monitors = {"val_miou": "max"}
        if self.mode == "representation":
            monitors["val_loss"] = "min"
        self.ckpt = CheckpointManager(self.log_dir, monitors, rank=self.rank)
        self.plateau_best = None
        self.plateau_wait = 0
        self._log_f = None
        if self.mesh.is_writer:
            self._log_f = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
            with open(os.path.join(self.log_dir, "config.json"), "w") as f:
                f.write(config.to_json())

        # Observability: TensorBoard scalars (reference main.py:178) and
        # torch.profiler trace capture behind config.profile
        self.tb = TensorBoardLogger(self.log_dir, enabled=config.tensorboard,
                                    rank=self.rank)
        self.profiler = ProfilerHook(
            self.log_dir, enabled=config.profile,
            start_step=config.profile_start_step,
            num_steps=config.profile_num_steps, rank=self.rank,
        )

    # ------------------------------------------------------------------

    def _load_projection_weights(self, feature_dim: int) -> np.ndarray:
        """(A, D, D) attribute-rotation weights for latent augmentation.

        Loads the pretrained AttributeFittingModel from
        config.projection_model_path when present (reference
        ContrastiveLanguageLoss.py:53-57 does the same torch.load); falls
        back to near-identity random maps so the path stays runnable —
        matching the reference, which also proceeds unloaded when the file
        is absent.
        """
        cfg = self.config
        num_attributes = 8  # reference's fixed attribute prompt set
        path = os.path.join(cfg.scannet_path or cfg.data_dir or "", cfg.projection_model_path)
        if os.path.isfile(path):
            from languagegroundedsemseg_torch.train.checkpoints import load_torch_state_dict

            sd = load_torch_state_dict(path)
            mats = []
            for a in range(num_attributes):
                for k in (f"maps.{a}.weight", f"projections.{a}.weight", f"{a}.weight"):
                    if k in sd and sd[k].shape == (feature_dim, feature_dim):
                        mats.append(np.asarray(sd[k]).T)  # torch Linear: y = x W^T
                        break
            if len(mats) == num_attributes:
                print(f"loaded attribute projection model from {path}")
                return np.stack(mats)
            print(f"projection model at {path} had unexpected keys; using random init")
        rng = np.random.default_rng(cfg.seed)
        eye = np.eye(feature_dim, dtype=np.float32)
        return np.stack([
            eye + 0.02 * rng.normal(size=(feature_dim, feature_dim)).astype(np.float32)
            for _ in range(num_attributes)
        ])

    def _maybe_load_weights(self):
        """--weights: a reference (MinkowskiEngine) ``.pth`` / ``.tar`` is
        imported name for name (``torch_to_port_state_dict``); any other
        file is a port checkpoint (``cli/convert.py`` or the trainer's own
        ``.ckpt``), whose model state dict loads as it is. With
        ``--weights_for_inner_model`` a reference file holds the bare
        model while ``self.model`` is CRF-wrapped: it loads into the
        wrapper's ``base`` (reference main.py:125-130)."""
        cfg = self.config
        if not cfg.weights or cfg.weights in ("None", ""):
            return
        if cfg.weights.endswith((".pth", ".tar")) or "torch" in cfg.weights:
            from languagegroundedsemseg_torch.train.checkpoints import (
                load_torch_state_dict,
                torch_to_port_state_dict,
            )

            target = (self.model.base if self.wrapped and cfg.weights_for_inner_model
                      else self.model)
            sd = load_torch_state_dict(cfg.weights)
            merged, skipped = torch_to_port_state_dict(sd, target.state_dict())
            print(f"loaded torch weights; skipped {len(skipped)} tensors")
        else:
            target = self.model
            blob = torch.load(cfg.weights, map_location=self.device, weights_only=True)
            merged = blob["model"]
        target.load_state_dict(merged)

    def _eval_metrics_fn(self, state: TrainState, batch):
        """(hist, loss, pred, tp_hist, fp_hist) of one batch, on the
        device. ``state`` is the trainer's (the model is the step's)."""
        cfg = self.config
        batch = batch.to(self.device).decompact()
        out_a, out_b = self.p_eval_step(batch)
        row_mask = batch.graph.levels[0].mask()
        with torch.inference_mode():
            if self.representation_only:
                logits = feature_sim(out_a, self._anchors_t, cfg.representation_distance_type)
                # val_loss is the training objective (the reference
                # RepresentationTrainer monitors it for best-checkpoint
                # selection); a fixed generator makes negative sampling
                # deterministic across validation runs
                gen = torch.Generator(device=self.device).manual_seed(0)
                loss, _ = self._objective(out_a, out_b, batch, gen, row_mask)
            else:
                logits = out_a
                loss = cross_entropy_loss(
                    logits, batch.labels, ignore_index=cfg.ignore_label, row_mask=row_mask)
            pred = torch.argmax(logits, dim=-1)
            hist = fast_hist_torch(pred, batch.labels, self.num_labels, row_mask)
            probs = torch.softmax(logits.to(torch.float32), dim=-1)
            tp_hist, fp_hist = ap_histograms_torch(
                probs, batch.labels, self.num_labels, row_mask=row_mask)
        return hist, loss, pred, tp_hist, fp_hist

    # ------------------------------------------------------------------

    def log(self, record: Dict):
        """Append ``record`` to metrics.jsonl and TensorBoard (rank 0)."""
        if self._log_f is None:
            return
        record = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
                  for k, v in record.items()}
        self._log_f.write(json.dumps(record) + "\n")
        self._log_f.flush()
        step = int(record.get("step", 0))
        phase = record.get("phase", "train")
        self.tb.log_scalars(
            step,
            {k: v for k, v in record.items()
             if isinstance(v, float) and k not in ("epoch", "step")},
            prefix=f"{phase}/",
        )

    def _dump_batch_predictions(self, batch, pred, out_dir: str, scene_base: int):
        """Per-scene prediction dumps (reference eval_step -> visualize_results,
        lib/utils.py:340-435): writes the *pred*NNNN.npy files that
        test_pointcloud consumes plus colored pred/gt/rgb .ply."""
        from languagegroundedsemseg_torch.utils.visualization import visualize_results

        ds = self.val_loader.dataset
        lvl0 = batch.graph.levels[0]
        if lvl0.coords is None:
            raise RuntimeError(
                "prediction dumps need device-side coords: run with "
                "--visualize/--save_prediction set at trainer construction "
                "so the val loader builds with ship_coords=True"
            )
        m = (lvl0.mask() > 0).cpu().numpy()  # sentinel rows are not voxels
        coords = lvl0.coords.cpu().numpy()[m]
        labels = batch.labels.cpu().numpy()[m]
        feats = batch.decompact().feats.cpu().numpy()[m]
        pred = pred.cpu().numpy()[m]
        inv_map = getattr(ds, "inverse_label_map", None)
        inv_arr = None
        if inv_map:
            inv_arr = np.zeros(self.num_labels, dtype=np.int64)
            for t, r in inv_map.items():
                if 0 <= t < self.num_labels:
                    inv_arr[t] = r
        cmap = getattr(ds, "SCANNET_COLOR_MAP", {})
        # Scene identity comes from the loader's per-voxel dataset-index
        # stream when present — immune to limit_numpoints scene drops; the
        # positional scene_base+b fallback serves directly-built batches.
        scene_idx = batch.extras.get("scene_idx")
        scene_idx = None if scene_idx is None else scene_idx.cpu().numpy()[m]
        transforms = batch.extras.get("transform")
        transforms = None if transforms is None else transforms.cpu().numpy()[m]
        for b in np.unique(coords[:, 0]):
            rows = coords[:, 0] == b
            if scene_idx is not None:
                idx = int(scene_idx[rows][0])
            else:
                idx = scene_base + int(b)
            if transforms is not None and self.config.save_prediction:
                # Original-scale prediction (reference save_predictions,
                # lib/utils.py:292-337): undo the voxelizer transform and
                # the train-id label mapping.
                tr = transforms[rows][0].reshape(4, 4)
                homo = np.hstack([
                    coords[rows, 1:4].astype(np.float64) + 0.5,
                    np.ones((int(rows.sum()), 1)),
                ])
                orig_xyz = (np.linalg.inv(tr) @ homo.T).T[:, :3]
                p = pred[rows]
                if inv_arr is not None:
                    p = inv_arr[np.clip(p, 0, self.num_labels - 1)]
                os.makedirs(self.config.save_pred_dir, exist_ok=True)
                np.save(
                    os.path.join(
                        self.config.save_pred_dir,
                        "pred_%04d_%02d.npy" % (idx, int(b)),
                    ),
                    np.hstack([orig_xyz, p[:, None].astype(np.float64)]),
                )
            name = (
                ds.get_output_id(idx)
                if hasattr(ds, "get_output_id")
                else f"scene_{idx:04d}"
            )
            colors = None
            if feats.shape[1] >= 3:
                colors = (feats[rows, :3] + 0.5) * 255.0 if self.config.normalize_color else feats[rows, :3]
            visualize_results(
                out_dir, name, coords[rows, 1:4].astype(np.float32), colors,
                pred[rows], labels[rows], cmap, self.num_labels,
                iteration=idx, inverse_map=inv_arr,
            )

    def validate(
        self,
        max_batches: Optional[int] = None,
        save_predictions_dir: Optional[str] = None,
        batches=None,
    ) -> Dict[str, float]:
        """One pass over the val loader (or ``batches``). The confusion
        counts, the AP histograms and the loss sum accumulate on the
        device and are read once, at the end. With several ranks each
        validates its shard; the counts and histograms are summed over the
        ranks and the mean loss averaged (JAX sums the devices' and
        averages their losses per batch), so every rank returns the same
        metrics."""
        split = getattr(self.dataset, "frequency_organized_cats", None)
        ev = IoUEvaluator(self.num_labels, split, getattr(self.dataset, "CLASS_LABELS", None))
        hist_acc = tp_acc = fp_acc = None
        loss_sum = torch.zeros((), dtype=torch.float64, device=self.device)
        count = 0
        viz_freq = self.config.visualize_freq
        for i, batch in enumerate(self.val_loader if batches is None else batches):
            if max_batches is not None and i >= max_batches:
                break
            hist, loss, pred, tp, fp = self._eval_metrics_fn(self.state, batch)
            if hist_acc is None:
                # the AP accumulators take the histograms' bin count
                hist_acc = torch.zeros_like(hist)
                tp_acc = torch.zeros_like(tp, dtype=torch.float64)
                fp_acc = torch.zeros_like(fp, dtype=torch.float64)
            hist_acc += hist
            tp_acc += tp
            fp_acc += fp
            loss_sum += loss
            count += 1
            # visualize_freq gates how often a val batch is dumped (0 =
            # every batch; reference pl_BaselineTrainer.py:176 semantics)
            if save_predictions_dir and (
                viz_freq == 0 or (i % viz_freq == 0 and i > 0)
            ):
                self._dump_batch_predictions(
                    batch, pred, save_predictions_dir,
                    scene_base=(i * self.world + self.rank) * self.val_loader.batch_size,
                )
        if hist_acc is not None:
            with torch.no_grad():
                summed = all_reduce_sum({"hist": hist_acc, "tp": tp_acc, "fp": fp_acc,
                                         "loss": loss_sum}, self.group)
            loss_sum = summed["loss"] / self.world
            ev.update_hist(summed["hist"].cpu().numpy())
            tp_acc, fp_acc = summed["tp"].cpu().numpy(), summed["fp"].cpu().numpy()
        m = ev.compute()
        aps = (ap_from_histograms(tp_acc, fp_acc) if tp_acc is not None
               else np.full(self.num_labels, np.nan))
        out = {
            "val_miou": m["miou"], "val_macc": m["macc"],
            "val_loss": float(loss_sum) / max(count, 1),
            "val_map": float(np.nanmean(aps)) if not np.isnan(aps).all() else float("nan"),
        }
        for k in ("head_miou", "common_miou", "tail_miou"):
            if k in m:
                out["val_" + k] = m[k]
        if split is not None:
            for i, name in enumerate(["head", "common", "tail"]):
                sel = np.asarray(split)[:, i]
                if sel.any() and not np.isnan(aps[sel]).all():
                    out[f"val_{name}_map"] = float(np.nanmean(aps[sel]))
        return out

    def fit(self, max_epochs: Optional[int] = None, val_every: int = 1,
            max_steps_per_epoch: Optional[int] = None):
        """Train for epochs [start, max_epochs) (``config.max_epoch`` when
        None); start is 0, or the epoch after the one a resumed checkpoint
        recorded (PL's resume semantics: max_epochs counts from the start
        of the run, not from the resume)."""
        cfg = self.config
        epochs = max_epochs if max_epochs is not None else cfg.max_epoch
        start_epoch = 0
        if cfg.resume:
            path = cfg.resume if os.path.isfile(cfg.resume) else find_resume_checkpoint(cfg.resume)
            if path:
                self.state = restore_checkpoint(path, self.state)
                start_epoch = int(load_checkpoint_metadata(path).get("epoch", -1)) + 1
                print(f"resumed from {path} at step {int(self.state.step)}")

        # overfit_batches (reference config/config.py:265): cache the first
        # N train batches (fraction of an epoch if < 1) and train AND
        # validate on exactly those — the standard sanity-check loop.
        overfit: Optional[list] = None
        if cfg.overfit_batches:
            n_ov = (
                int(cfg.overfit_batches)
                if cfg.overfit_batches >= 1
                else max(1, round(cfg.overfit_batches * len(self.train_loader)))
            )
            overfit = []
            for batch in self.train_loader:
                overfit.append(batch)
                if len(overfit) >= n_ov:
                    break
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            # The hot loop never reads a device value back per step:
            # metrics stay device tensors (read at stat_freq and at the
            # epoch's end) and the step counter is host-side, so the
            # loader's copy of the next batch overlaps this step.
            n_steps = 0
            losses: list = []
            step0 = int(self.state.step)
            for batch in (overfit if overfit is not None else self.train_loader):
                self.profiler.maybe_start(step0 + n_steps)
                self.state, metrics = self.p_train_step(self.state, batch, self.generator)
                self.profiler.maybe_stop(step0 + n_steps + 1)
                n_steps += 1
                losses.append(metrics["loss"])
                if n_steps % cfg.stat_freq == 0:
                    self.log({"phase": "train", "epoch": epoch,
                              "step": step0 + n_steps,
                              **{k: float(v) for k, v in metrics.items()}})
                if max_steps_per_epoch and n_steps >= max_steps_per_epoch:
                    break
            train_loss = (
                float(torch.stack(losses).to(torch.float64).mean()) if losses else 0.0
            )

            val_metrics = {}
            if (epoch + 1) % val_every == 0:
                val_metrics = self.validate(batches=overfit)
                self._plateau_update(val_metrics)
            rec = {"phase": "epoch", "epoch": epoch, "step": int(self.state.step),
                   "train_loss": train_loss, "time_s": time.time() - t0,
                   **self.train_loader.counters.snapshot(), **val_metrics}
            self.log(rec)
            if self.mesh.is_writer:
                print(json.dumps(rec))
            self.ckpt.save(self.state, val_metrics, int(self.state.step),
                           extra_meta={"epoch": epoch})
            barrier(self.group)  # rank 0's files are whole before any rank reads them
        self.profiler.close()
        return self.state

    def _plateau_update(self, val_metrics: Dict[str, float]):
        cfg = self.config
        if cfg.scheduler != "ReduceLROnPlateau":
            return
        monitor = val_metrics.get(cfg.scheadule_monitor, val_metrics.get("val_miou"))
        if monitor is None:
            return
        if self.plateau_best is None or monitor > self.plateau_best:
            self.plateau_best = monitor
            self.plateau_wait = 0
        else:
            self.plateau_wait += 1
            if self.plateau_wait > cfg.reduce_patience:
                new_scale = float(self.state.lr_scale) * cfg.step_gamma
                floor = cfg.scheduler_min_lr / max(cfg.lr, 1e-12)
                self.state.lr_scale = float(np.float32(max(new_scale, floor)))
                self.plateau_wait = 0

    def close(self):
        """Close the metrics file and the TensorBoard writer."""
        if self._log_f is not None:
            self._log_f.close()
        self.tb.close()

    def test(self, save_predictions: bool = False):
        """Validation pass + optional full-pointcloud eval: voxel preds are
        dumped per scene, then KD-queried from the full-resolution cloud
        (reference eval_step -> visualize_results -> on_test_epoch_end ->
        dataset.test_pointcloud, lib/datasets/scannet.py:391-439)."""
        cfg = self.config
        dump = (
            save_predictions or cfg.save_prediction or cfg.visualize
            or cfg.test_original_pointcloud
        )
        pred_dir = cfg.visualize_path or os.path.join(self.log_dir, "visualize")
        metrics = self.validate(save_predictions_dir=pred_dir if dump else None)
        barrier(self.group)  # every rank's dumps are written
        if cfg.test_original_pointcloud and hasattr(self.val_loader.dataset, "test_pointcloud"):
            miou, _ = self.val_loader.dataset.test_pointcloud(pred_dir, self.num_labels)
            metrics["full_cloud_miou"] = miou
        return metrics
