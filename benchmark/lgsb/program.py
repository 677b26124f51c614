"""The system under test: the port's dataset, loader, model, optimizer,
objective and train step, built as its training program builds them, and
the wrappers that time its workers.

This is the only module of the benchmark that imports
``languagegroundedsemseg_torch``. It hands the port the benchmark's own
inputs (the raw scenes, the weights, the text anchors) and reads back only
what the port produces: batches, outputs, optimizer state, counters.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.data.loader import initialize_data_loader
from languagegroundedsemseg_torch.data.synthetic_dataset import SyntheticDatasetBase
from languagegroundedsemseg_torch.models import load_model
from languagegroundedsemseg_torch.train.objectives import (
    make_baseline_objective,
    make_representation_objective,
)
from languagegroundedsemseg_torch.train.solvers import sgd_torch
from languagegroundedsemseg_torch.train.state import TrainState
from languagegroundedsemseg_torch.train.step import make_train_step

LOADER_THREAD_PREFIX = "lgs-loader"


class Timed:
    """Wraps a callable the loader's workers call; keeps each call's
    (end time, seconds) on the host clock (thread-safe)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        t1 = time.perf_counter()
        with self._lock:
            self.calls.append((t1, t1 - t0))
        return out

    def between(self, t0: float, t1: float):
        with self._lock:
            return [s for end, s in self.calls if t0 <= end <= t1]


class RecordingBuild:
    """``BatchBuilder.build_host`` with its host time kept, and for each
    built batch what the judge and the work arithmetic read: the voxels the
    loader's dataset handed over (per scene), the builder's layout (kept
    row -> concatenated voxel, kept row -> padded row), the scenes it
    dropped and each level's capacity. Keyed by the loader's batch
    counter."""

    def __init__(self, builder, keep_layouts: int):
        self.builder = builder
        self.build_host = builder.build_host
        self.keep_layouts = keep_layouts
        self.timed = Timed(self._build)
        self.layouts: Dict[int, dict] = {}
        self.scenes_per_batch: Dict[int, int] = {}
        self.caps: Dict[int, list] = {}
        self._local = threading.local()
        self._lock = threading.Lock()

    def _build(self, scenes, extras=None, return_layout=False, stats_out=None):
        stats = {} if stats_out is None else stats_out
        batch, layout = self.build_host(scenes, extras=extras,
                                        return_layout=True, stats_out=stats)
        k = getattr(self._local, "counter", None)
        if k is not None:
            with self._lock:
                self.scenes_per_batch[k] = len(scenes) - stats.get("scenes_dropped", 0)
                self.caps[k] = level_caps(stats)
                if k < self.keep_layouts:
                    self.layouts[k] = {
                        "coords": [np.array(s[0], np.int32) for s in scenes],
                        "order": np.asarray(layout["order"]),
                        "pos0": np.asarray(layout["pos0"]),
                        "scenes_dropped": stats.get("scenes_dropped", 0),
                        "voxels_dropped": stats.get("voxels_dropped", 0),
                    }
        return (batch, layout) if return_layout else batch

    def install(self, loader) -> None:
        self.builder.build_host = self.timed
        build_one = loader._build_one

        def counted(indices, batch_counter):
            self._local.counter = batch_counter
            try:
                return build_one(indices, batch_counter)
            finally:
                self._local.counter = None

        loader._build_one = counted


def level_caps(stats: dict) -> list:
    """Each level's capacity (padded rows) from ``build_host``'s stats."""
    return [int(cap) for _, (_, cap, _) in sorted(stats["levels"].items())]


def dataset_class(raw: Dict[int, tuple], n: int, num_classes: int, anchor_dim: int):
    """A port dataset of ``n`` scenes whose clouds are the benchmark's raw
    scenes (made in set-up and held in memory, as a page cache would hold a
    scan). ``raw`` may hold more clouds past ``n``, which the loader never
    draws (the capacity envelope's)."""

    class BenchScenes(SyntheticDatasetBase):
        NUM_SCENES = n
        NUM_CLASSES = num_classes
        ANCHOR_DIM = anchor_dim

        def load_cloud(self, index: int):
            xyz, rgb, labels = raw[index]
            return xyz, rgb, labels, None, f"bench_{index:05d}"

    return BenchScenes


def port_config(cfg: dict, traffic: dict, seed: int, dtype: str) -> Config:
    return Config(
        model=cfg["model"], batch_size=cfg["batch_size"],
        num_workers=traffic.get("num_workers", 1), ignore_label=255,
        seed=seed, train_limit_numpoints=cfg["train_limit_numpoints"],
        lr=cfg["lr"], sgd_momentum=cfg["momentum"],
        sgd_dampening=cfg["dampening"], weight_decay=cfg["weight_decay"],
        bn_momentum=cfg["bn_momentum"], conv1_kernel_size=3,
        balanced_category_sampling=cfg["balanced_category_sampling"],
        use_embedding_loss=cfg.get("use_embedding_loss"),
        embedding_loss_type=cfg.get("embedding_loss_type", "contrast"),
        num_negative_samples=cfg.get("num_negative_samples", 3),
        compute_dtype=dtype)


def make_loader(cfg: dict, traffic: dict, port_cfg: Config, ds_cls,
                anchors: Optional[np.ndarray], device, keep_layouts: int):
    loader = initialize_data_loader(
        ds_cls, port_cfg, "train", num_workers=traffic["num_workers"],
        shuffle=traffic["shuffle"], repeat=traffic["repeat"],
        augment_data=True, batch_size=cfg["batch_size"],
        limit_numpoints=cfg["train_limit_numpoints"], ship_coords=False,
        device=device)
    if anchors is not None:
        loader.dataset.loaded_text_features = anchors[:, None, :]
    rec = RecordingBuild(loader.builder, keep_layouts)
    rec.install(loader)
    get_item = Timed(loader.dataset.get_item)
    loader.dataset.get_item = get_item
    return loader, rec, get_item


def make_step(cfg: dict, port_cfg: Config, dataset, weights: Dict[str, torch.Tensor],
              device, wrap_objective=None):
    """(step, state, model, optimizer): the port's model with the
    benchmark's weights, SGD and the configuration's objective, bound by
    ``make_train_step`` as the trainer binds them. ``wrap_objective``
    plants a fault in the objective (tests and calibration only)."""
    dtype = torch.bfloat16 if port_cfg.compute_dtype == "bfloat16" else torch.float32
    model = load_model(cfg["model"])(
        in_channels=3, out_channels=cfg["num_classes"], conv1_kernel_size=3,
        bn_momentum=cfg["bn_momentum"], device=device,
        generator=torch.Generator().manual_seed(0),
        max_batch=cfg["batch_size"] + 1, dtype=dtype)
    sd = model.state_dict()
    if set(sd) != set(weights) or any(tuple(sd[k].shape) != tuple(weights[k].shape)
                                      for k in sd):
        raise RuntimeError(
            f"{cfg['model']}'s state_dict does not match the benchmark's "
            f"architecture: {sorted(set(sd) ^ set(weights))[:8]}")
    model.load_state_dict({k: v.detach().clone() for k, v in weights.items()})
    optimizer = sgd_torch(model.parameters(), cfg["lr"], momentum=cfg["momentum"],
                          dampening=cfg["dampening"],
                          weight_decay=cfg["weight_decay"])
    representation = cfg["objective"] == "contrastive"
    ds = dataset
    if representation:
        objective = make_representation_objective(
            port_cfg, np.asarray(ds.loaded_text_features),
            ds.frequency_organized_cats, projection_w=None, device=device)
    else:
        objective = make_baseline_objective(
            port_cfg, ds.category_weights, ds.frequency_organized_cats,
            None, device=device)
    if wrap_objective is not None:
        objective = wrap_objective(objective)
    step = make_train_step(model, optimizer, objective,
                           representation_only=representation, device=device)
    return step, TrainState(model, optimizer), model, optimizer


def prime_capacities(loader, rec: RecordingBuild, indices, rngs,
                     workers: int = 8) -> list:
    """Builds one batch of the clouds ``indices`` (each augmented by its
    generator of ``rngs``, as the loader's workers do) through the loader's
    builder before the loader runs, and returns its level capacities. The
    production builder keeps every level's capacity at the running maximum
    of the batches it has built, as a long training run settles it; this
    batch sets that maximum first, so the batches that follow are padded
    alike whatever their own sizes, up to its."""
    def one(i, rng):
        item = loader.dataset.get_item(int(i), rng)
        f = item["feats"].copy()
        f[:, :3] = f[:, :3] / 255.0 - 0.5
        return item["coords"], f, item["labels"]

    with ThreadPoolExecutor(workers) as ex:
        scenes = list(ex.map(one, indices, rngs))
    stats: dict = {}
    rec.build_host(scenes, stats_out=stats)
    return level_caps(stats)


def momentum_buffers(model, optimizer) -> Dict[str, torch.Tensor]:
    """The optimizer's momentum buffer of each parameter, by name."""
    state = optimizer.inner.state
    return {n: state[p]["momentum_buffer"] for n, p in model.named_parameters()
            if p in state and "momentum_buffer" in state[p]}


def loader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(LOADER_THREAD_PREFIX)]
