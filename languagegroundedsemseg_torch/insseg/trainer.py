"""Instance-segmentation trainer, on one device or across ranks.

Counterpart of ``languagegroundedsemseg_tpu/insseg/trainer.py`` (:37-367),
the mirror of reference downstream/insseg/lib/pl_Trainer.py:245-387:
semantic CE/focal + offset norm/direction losses during training;
validation shifts coords by predicted offsets, clusters on the host, and
feeds the ScanNet instance evaluator (dual checkpoints on val_miou and
val_map05 like ddp_main.py:75-78).

The train step is ``train.step.make_train_step`` with the insseg objective
(``make_insseg_objective``), the eval step ``make_insseg_eval_step``; both
run on ``device`` (the card unless the caller asks for the CPU), so on the
card every conv of the backbone runs the port's kernels; the offset head's
pointwise convs and the losses are plain tensor code. Metrics stay device
tensors until they are logged; the validation's confusion counts
accumulate on the device and are read once. bfloat16 compute raises
``NotImplementedError``.

Data parallelism (JAX :78-125, :186-195, :256): with ``num_devices`` ranks
(one process each, ``parallel/mesh.py``) each rank's loader builds its
shard, the batch norms sync over the group, and the step averages the
gradients, the loss and the parts. JAX validates on one device, unsharded:
here rank 0 validates every scene while the other ranks wait, then
broadcasts the metrics. Rank 0 alone writes the log and the checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from scipy import spatial

from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.data.dataset import build_input_transforms
from languagegroundedsemseg_torch.data.loader import DataLoader
from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.eval.miou import IoUEvaluator, fast_hist_torch
from languagegroundedsemseg_torch.insseg.clustering import Clustering
from languagegroundedsemseg_torch.insseg.evaluation import InstanceEvaluator
from languagegroundedsemseg_torch.insseg.losses import offset_losses
from languagegroundedsemseg_torch.insseg.model import (
    InstanceRes16UNet,
    InstanceRes16UNet14A,
)
from languagegroundedsemseg_torch.losses.classification import (
    cross_entropy_loss,
    focal_loss,
)
from languagegroundedsemseg_torch.models.layers import convert_sync_batchnorm
from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec
from languagegroundedsemseg_torch.parallel.collectives import barrier
from languagegroundedsemseg_torch.parallel.dp import broadcast_module
from languagegroundedsemseg_torch.parallel.mesh import Mesh, make_mesh
from languagegroundedsemseg_torch.train.checkpoints import (
    CheckpointManager,
    find_resume_checkpoint,
    restore_checkpoint,
)
from languagegroundedsemseg_torch.train.solvers import (
    initialize_optimizer,
    make_lr_schedule,
)
from languagegroundedsemseg_torch.train.state import TrainState
from languagegroundedsemseg_torch.train.step import TrainBatch, make_train_step

INSSEG_MODELS = {
    "InstanceRes16UNet": InstanceRes16UNet,
    "InstanceRes16UNet14A": InstanceRes16UNet14A,
}


def insseg_extras(item) -> Dict[str, np.ndarray]:
    """The per-voxel instance targets a batch carries (rows with no
    instance have center -1 and ``instance_valid`` 0; padding rows are 0)."""
    return {
        "centers": item["centers"].astype(np.float32),
        "instance_valid": (item["instances"] >= 0).astype(np.float32),
        "instance_ids": item["instances"].astype(np.int32),
        "xyz": item["coords"].astype(np.float32),
    }


def make_insseg_objective(voxel_size: float, ignore_label: int = 255,
                          loss_type: str = "cross_entropy",
                          focal_gamma: float = 2.0) -> Callable:
    """The objective ``train.step.make_train_step`` takes for the instance
    model: ``objective(offsets, logits, features, batch, generator,
    row_mask) -> (total, parts)``, the semantic CE (or focal) loss plus the
    offset norm and direction losses over the rows with an instance."""

    def objective(offsets, logits, _features, batch, _generator, row_mask):
        if loss_type == "focal":
            sem = focal_loss(logits, batch.labels, gamma=focal_gamma,
                             ignore_index=ignore_label, row_mask=row_mask)
        else:
            sem = cross_entropy_loss(logits, batch.labels,
                                     ignore_index=ignore_label, row_mask=row_mask)
        norm_l, dir_l = offset_losses(
            offsets, batch.extras["xyz"], batch.extras["centers"],
            batch.extras["instance_valid"], voxel_size, row_mask,
        )
        return sem + norm_l + dir_l, dict(semantic_loss=sem, offset_norm_loss=norm_l,
                                          offset_dir_loss=dir_l)

    return objective


def make_insseg_eval_step(model, num_labels: int, device="cuda") -> Callable:
    """Build ``eval(batch) -> (offsets, probs, hist)``: the eval-mode
    forward under ``torch.inference_mode()``, the softmax probabilities and
    the (num_labels, num_labels) confusion counts over the valid rows, all
    on the device."""
    dev = resolve_device(device)
    model = model.to(dev)

    def step(batch: TrainBatch):
        model.eval()
        with torch.inference_mode():
            batch = batch.to(dev).decompact()
            offsets, logits, _ = model(batch.feats, batch.graph)
            row_mask = batch.graph.levels[0].mask()
            pred = torch.argmax(logits, dim=-1)
            hist = fast_hist_torch(pred, batch.labels, num_labels, row_mask)
            probs = torch.softmax(logits.to(torch.float32), dim=-1)
        return offsets, probs, hist

    return step


class InssegTrainer:
    def __init__(self, config: Config, dataset_cls=None, model_cls=None,
                 device="cuda", mesh: Optional[Mesh] = None):
        """``mesh``: this process's rank and group (``make_mesh``); None
        makes it from ``config.num_devices`` and ``device``."""
        if config.compute_dtype != "float32":
            raise NotImplementedError(
                "the port computes in float32: compute_dtype must be 'float32' "
                "(ROADMAP Queue 1, item 9)")
        self.mesh = mesh or make_mesh(config.num_devices, device)
        self.device = self.mesh.device
        self.group, self.rank, self.world = self.mesh.group, self.mesh.rank, self.mesh.world
        self.config = config
        os.makedirs(config.log_dir, exist_ok=True)

        from languagegroundedsemseg_torch.insseg.dataset import SyntheticInstanceDataset

        dataset_cls = dataset_cls or SyntheticInstanceDataset
        prevoxel, input_t = build_input_transforms(config, dataset_cls, config.train_augmentation)
        self.dataset = dataset_cls(
            config, phase=config.train_phase, augment_data=config.train_augmentation,
            prevoxel_transform=prevoxel, input_transform=input_t,
        )
        self.val_dataset = dataset_cls(config, phase=config.val_phase, augment_data=False)
        self.num_labels = self.dataset.num_train_labels
        self.voxel_size = self.dataset.VOXEL_SIZE

        # ship_coords (the default): validation reads level-0 coords back
        self.builder = BatchBuilder(
            spec=res16unet_graph_spec(config.conv1_kernel_size),
            ignore_index=config.ignore_label,
            limit_numpoints=config.train_limit_numpoints,
            fixed_capacity=config.fixed_capacity or None,
            level_ratios=config.level_capacity_ratios,
        )

        model_cls = model_cls or INSSEG_MODELS.get(config.model, InstanceRes16UNet)
        self.model = model_cls(
            in_channels=getattr(self.dataset, "NUM_IN_CHANNEL", 3),
            out_channels=self.num_labels,
            conv1_kernel_size=config.conv1_kernel_size,
            bn_momentum=config.bn_momentum,
            device=self.device,
            generator=torch.Generator().manual_seed(config.seed),
        )
        convert_sync_batchnorm(self.model, self.group)
        broadcast_module(self.model, self.group)
        # the schedule steps once per update (optax's count), not per epoch
        sched = make_lr_schedule(config.scheduler, config.lr, step_gamma=config.step_gamma,
                                 multi_step_milestones=config.multi_step_milestones,
                                 max_steps=config.max_iter)
        optimizer = initialize_optimizer(self.model.parameters(), config, sched)
        self.state = TrainState(self.model, optimizer)
        # step(state, batch) -> (state, parts): the three losses, their sum
        # ``loss`` and ``grad_norm``, device tensors
        self.p_train_step = make_train_step(
            self.model, optimizer,
            make_insseg_objective(
                self.voxel_size, config.ignore_label,
                "focal" if config.loss_type == "focal" else "cross_entropy",
                config.focal_gamma),
            device=self.device, group=self.group)
        self.p_eval = make_insseg_eval_step(self.model, self.num_labels, device=self.device)
        self._log_f = (open(os.path.join(config.log_dir, "metrics.jsonl"), "a")
                       if self.mesh.is_writer else None)

        self.clusterer = Clustering(
            ignored_labels=[],  # train-id space; benchmark mapping applied after
            class_mapping=np.asarray(self.dataset.VALID_CLASS_IDS),
            thresh=0.03, min_points=50, propose_points=100,
        )
        self.ckpt = CheckpointManager(config.log_dir, {"val_miou": "max", "val_map05": "max"},
                                      rank=self.rank)
        self.train_loader = None

    # ------------------------------------------------------------------

    def _host_batch(self, items) -> TrainBatch:
        """A host batch of dataset items, colors normalized as the config
        says, with the instance extras."""
        scenes = []
        for item in items:
            feats = item["feats"].copy()
            if self.config.normalize_color:
                feats[:, :3] = feats[:, :3] / 255.0 - 0.5
            scenes.append((item["coords"], feats, item["labels"]))
        return self.builder.build_host(scenes, [insseg_extras(it) for it in items])

    # ------------------------------------------------------------------

    def _log(self, rec: Dict):
        if self._log_f is None:
            return
        self._log_f.write(json.dumps({k: (float(v) if hasattr(v, "item") else v)
                                      for k, v in rec.items()}) + "\n")
        self._log_f.flush()

    def close(self):
        """Close the metrics file."""
        if self._log_f is not None:
            self._log_f.close()

    def fit(
        self,
        max_steps: int = 100,
        log_every: int = 10,
        val_every: int = 0,
        max_val_scenes: Optional[int] = None,
    ):
        """Train steps [start, max_steps) with periodic validation +
        dual-monitor checkpointing (reference ddp_main.py:75-78 checkpoints
        on val_miou AND val_map05) and max-step resume (ddp_main.py:83-105):
        start is the restored step."""
        cfg = self.config
        if cfg.resume:
            path = cfg.resume if os.path.isfile(cfg.resume) else find_resume_checkpoint(cfg.resume)
            if path:
                self.state = restore_checkpoint(path, self.state)
                print(f"resumed from {path} at step {int(self.state.step)}")

        # Threaded prefetching loader with epoch semantics (fresh shuffled
        # order per epoch, wrap-around padding, batches copied to the device
        # ahead of the step) — the host graph build runs in worker threads
        # while the device steps (reference trains through torch DataLoader
        # workers, downstream/insseg/lib/ddp_trainer.py).
        self.train_loader = DataLoader(
            self.dataset, self.builder,
            batch_size=min(cfg.batch_size, len(self.dataset)),
            shuffle=True, repeat=True, seed=cfg.seed,
            num_workers=cfg.num_workers, num_devices=self.world, rank=self.rank,
            ignore_index=cfg.ignore_label, extras_fn=insseg_extras, device=self.device,
        )
        batch_iter = iter(self.train_loader)
        try:
            for step in range(int(self.state.step), max_steps):
                batch = next(batch_iter)
                self.state, parts = self.p_train_step(self.state, batch)
                if (step + 1) % log_every == 0:
                    rec = {k: float(v) for k, v in parts.items()} | {"step": step + 1}
                    if self.mesh.is_writer:
                        print(json.dumps(rec))
                    self._log(rec | {"phase": "train"})
                if val_every and (step + 1) % val_every == 0:
                    metrics = self.validate(max_scenes=max_val_scenes)
                    self._log(metrics | {"phase": "val", "step": step + 1})
                    self.ckpt.save(self.state, metrics, step + 1)
                    barrier(self.group)
        finally:
            batch_iter.close()  # stops the loader's feeder and workers
        if not val_every:
            self.ckpt.save(self.state, {}, int(self.state.step))
            barrier(self.group)
        return self.state

    def validate(self, max_scenes: Optional[int] = None) -> Dict[str, float]:
        """One scene at a time (rng ``(999, i)``): the eval forward on the
        device, then on the host the vote shift, the clustering and the
        instance evaluation at full resolution (voxel masks back-projected
        to the original cloud), or in voxel space without one. With
        several ranks, rank 0 validates every scene (the eval forward
        never syncs) while the others wait; every rank returns rank 0's
        metrics."""
        metrics = [self._validate(max_scenes) if self.mesh.is_writer else None]
        if self.world > 1:
            dist.broadcast_object_list(metrics, src=0, group=self.group)
        return metrics[0]

    def _validate(self, max_scenes: Optional[int]) -> Dict[str, float]:
        ev_sem = IoUEvaluator(self.num_labels)
        ev_inst = InstanceEvaluator(
            [int(i) for i in self.dataset.VALID_CLASS_IDS], self.dataset.CLASS_LABELS
        )
        ds = self.val_dataset
        n = len(ds) if max_scenes is None else min(len(ds), max_scenes)
        hist_acc = None
        for i in range(n):
            rng = np.random.default_rng((999, i))
            item = ds.get_item(i, rng)
            batch = self._host_batch([item])
            offsets, probs, hist = self.p_eval(batch)
            hist_acc = hist if hist_acc is None else hist_acc + hist

            m_valid = np.asarray(batch.graph.levels[0].valid) > 0
            offsets = offsets.cpu().numpy()[m_valid]
            probs = probs.cpu().numpy()[m_valid]
            coords = np.asarray(batch.graph.levels[0].coords)[m_valid, 1:]
            # vote shift (reference pl_Trainer.py:356)
            vertices = coords * self.voxel_size + offsets
            instances = self.clusterer.get_instances(vertices, probs)
            scene = item["scene_name"]
            original = item.get("original")
            if original is not None:
                # full-resolution instance eval: back-project voxel masks to
                # the original points via nearest-voxel query (the reference
                # uses a pykeops KNN, datasets/scannet.py:149-170; a host
                # KD-tree is our analog). GT comes from the raw cloud.
                m_v, m_r = item["transform"]
                rigid = m_v  # val path voxelizes without augmentation
                homo = np.hstack([
                    original["xyz"], np.ones((len(original["xyz"]), 1), np.float32)
                ])
                xyz_vox = homo @ rigid.T[:, :3]
                tree = spatial.cKDTree(coords.astype(np.float32) + 0.5)
                _, nearest = tree.query(xyz_vox)
                full_instances = {
                    k: {
                        "label_id": v["label_id"],
                        "conf": v["conf"],
                        "pred_mask": np.asarray(v["pred_mask"])[nearest],
                    }
                    for k, v in instances.items()
                }
                ev_inst.add_gt(scene, original["semantic"], original["instance"])
                ev_inst.add_prediction(scene, full_instances)
                if self.config.save_prediction:
                    # ScanNet benchmark submission files (reference
                    # evaluate_semantic_instance.py:363-374 writes them
                    # during eval when exporting is on)
                    ev_inst.export_benchmark(
                        self.config.save_pred_dir, scene, full_instances
                    )
            else:
                # voxel-space fallback (no original cloud available)
                inv = np.asarray(
                    [ds.inverse_label_map.get(t, -1) for t in range(self.num_labels)]
                )
                labels = np.asarray(batch.labels)[m_valid]
                sem_raw = np.where(
                    labels == self.config.ignore_label,
                    -1,
                    inv[np.clip(labels, 0, self.num_labels - 1)],
                )
                inst_ids = np.asarray(batch.extras["instance_ids"])[m_valid]
                ev_inst.add_gt(scene, sem_raw, inst_ids)
                ev_inst.add_prediction(scene, instances)
                if self.config.save_prediction:
                    ev_inst.export_benchmark(
                        self.config.save_pred_dir, scene, instances
                    )

        if hist_acc is not None:
            ev_sem.update_hist(hist_acc.cpu().numpy())
        sem = ev_sem.compute()
        inst = ev_inst.evaluate()
        return {
            "val_miou": sem["miou"],
            "val_map": inst["all_ap"],
            "val_map05": inst["ap_50"],
            "val_map25": inst["ap_25"],
        }
