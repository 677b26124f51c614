"""Dataset registry + parallel prefetching data loader.

Counterpart of ``languagegroundedsemseg_tpu/data/loader.py`` (:28-349). The
loader replaces torch DataLoader + InfSampler + collate (reference
lib/dataloader.py:6-35, lib/transforms.py:385-423, lib/dataset.py:337-416):
a pool of ``num_workers`` threads runs the per-scene pipeline and the graph
builder (the C++ builder releases the GIL, so threads give real
concurrency), assembling fixed-capacity device batches ahead of the
accelerator. Batches are delivered in deterministic submission order; any
worker exception is re-raised in the consuming thread (the reference gets
this from torch DataLoader worker propagation). Color normalization
(feats/255 - 0.5) happens here — matching the trainer-side normalization of
the reference (pl_BaselineTrainer.py:299).

Device transfer (the JAX loader's worker-side ``jax.device_put``): on the
card each worker pins the host batch's arrays and copies them with
``non_blocking=True`` on a side stream the loader owns, then records an
event. Before it yields the batch the consumer makes its current stream wait
on that event and marks every device tensor as used by that stream
(``record_stream``), so the caching allocator cannot hand a batch's memory
to a later copy while the step still reads it. The copy of batch k+1 thus
overlaps the step on batch k. On the CPU (``device="cpu"``) batches are
torch tensors sharing the builder's numpy memory.

Data parallelism (JAX :141-146, :218-276): with ``num_devices`` ranks,
every rank walks the same epoch order, padded by wrap-around to whole
``(num_devices, batch_size)`` groups, and rank k builds row k of each group
with the scene counter ``base + k``: the batch the JAX loader stacks at
index k. The shards' graphs are not harmonized (``parallel/dp.py`` says why
``stack_batches`` has no counterpart).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter
from typing import Iterator, List, Optional

import numpy as np
import torch

from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.data.dataset import DatasetPhase, build_input_transforms
from languagegroundedsemseg_torch.device import resolve_device
from languagegroundedsemseg_torch.train.step import TrainBatch
from languagegroundedsemseg_torch.utils.observability import span

_DATASETS = {}


def register_dataset(cls):
    _DATASETS[cls.__name__] = cls
    return cls


def load_dataset(name: str):
    if not _DATASETS:
        _populate()
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(_DATASETS)}")
    return _DATASETS[name]


def _populate():
    from languagegroundedsemseg_torch.data import scannet, stanford, prior_info, synthetic_dataset

    for mod in (scannet, stanford, prior_info, synthetic_dataset):
        for nm in dir(mod):
            obj = getattr(mod, nm)
            if isinstance(obj, type) and nm.endswith("Dataset"):
                _DATASETS[nm] = obj


class LoaderCounters:
    """Thread-safe data-loss / fill / time counters, logged by the trainer.

    The reference's analog (limit_numpoints truncation, lib/transforms.py:405)
    prints a warning per event; here every silent-drop site increments a
    counter so truncation is observable in metrics.jsonl. Beside them,
    running sums on the host clock where the loader's spans are: each
    scene's ``get_item``, each batch's build, each wait of the consumer
    for its next batch, and the bytes of each batch handed to the
    device."""

    def __init__(self):
        self._lock = threading.Lock()
        self.batches = 0
        self.scenes_dropped = 0  # limit_numpoints whole-scene drops
        self.voxels_dropped = 0  # level-0 capacity truncation
        self.level_overflows: dict = {}  # level -> count of truncated batches
        self.level_fill_sum: dict = {}  # level -> sum of num/capacity
        self.level_num_sum: dict = {}  # level -> sum of valid rows
        self.get_item_s = 0.0
        self.build_s = 0.0
        self.wait_s = 0.0
        self.waits = 0
        self.h2d_bytes = 0
        self.copies = 0

    def update(self, stats: dict, get_item_s: float, build_s: float):
        """One built batch: its ``build_host`` stats and the host seconds
        its scenes' ``get_item`` and its build took."""
        with self._lock:
            self.batches += 1
            self.get_item_s += get_item_s
            self.build_s += build_s
            self.scenes_dropped += stats.get("scenes_dropped", 0)
            self.voxels_dropped += stats.get("voxels_dropped", 0)
            for l, (num, cap, overflowed) in stats.get("levels", {}).items():
                self.level_overflows[l] = self.level_overflows.get(l, 0) + int(overflowed)
                self.level_fill_sum[l] = self.level_fill_sum.get(l, 0.0) + num / max(cap, 1)
                self.level_num_sum[l] = self.level_num_sum.get(l, 0) + int(num)

    def add_wait(self, seconds: float):
        with self._lock:
            self.wait_s += seconds
            self.waits += 1

    def add_copy(self, nbytes: int):
        with self._lock:
            self.h2d_bytes += nbytes
            self.copies += 1

    def snapshot(self) -> dict:
        """The counts, each level's mean fill, and the means per batch of
        the time sums (ms) and of the bytes handed to the device (MB)."""
        with self._lock:
            out = {
                "loader_batches": self.batches,
                "loader_scenes_dropped": self.scenes_dropped,
                "loader_voxels_dropped": self.voxels_dropped,
            }
            for l, c in sorted(self.level_overflows.items()):
                out[f"loader_overflow_l{l}"] = c
            if self.batches:
                for l, s in sorted(self.level_fill_sum.items()):
                    out[f"loader_fill_l{l}"] = round(s / self.batches, 4)
                out["loader_get_item_ms"] = round(1e3 * self.get_item_s / self.batches, 3)
                out["loader_build_ms"] = round(1e3 * self.build_s / self.batches, 3)
            if self.waits:
                out["loader_wait_ms"] = round(1e3 * self.wait_s / self.waits, 3)
            if self.copies:
                out["loader_h2d_mb"] = round(self.h2d_bytes / self.copies / 1e6, 3)
            return out


def _leaves(obj, kind) -> Iterator:
    """Every leaf of type ``kind`` of a batch (TrainBatch, ConvGraph and
    their maps, walked through dataclass fields, dicts and sequences)."""
    if isinstance(obj, kind):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), kind)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v, kind)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v, kind)


def batch_tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor leaf of a batch."""
    return _leaves(obj, torch.Tensor)


class DataLoader:
    """Yields TrainBatch on ``device`` (the card unless the caller asks for
    the CPU). Infinite iteration when repeat=True (InfSampler semantics)."""

    def __init__(
        self,
        dataset,
        builder: BatchBuilder,
        batch_size: int,
        shuffle: bool = True,
        repeat: bool = False,
        seed: int = 0,
        num_workers: int = 2,
        num_devices: int = 1,
        ignore_index: int = 255,
        extras_fn=None,
        device="cuda",
        rank: Optional[int] = None,
    ):
        if rank is None and num_devices > 1:
            raise ValueError(
                f"num_devices={num_devices}: pass this process's rank (one "
                "process per rank, as torchrun starts them)")
        rank = rank or 0
        if not 0 <= rank < num_devices:
            raise ValueError(
                f"rank {rank} is not one of num_devices={num_devices} ranks")
        # Graph builds churn large numpy scratch every batch; tune the host
        # allocator once per process (utils/host_alloc.py — big, measured
        # win on lazily-backed VM memory; no-op where unsupported).
        from languagegroundedsemseg_torch.utils.host_alloc import tune

        tune()
        self.dataset = dataset
        self.builder = builder
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.repeat = repeat
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.num_devices = num_devices
        self.rank = rank
        # Optional per-item extras: extras_fn(item) -> dict of (N, ...)
        # arrays carried through dedup/sort/padding (instance targets for
        # the insseg trainer).
        self.extras_fn = extras_fn
        self.epoch = 0
        # Persistent across __iter__ calls: keeps per-scene augmentation RNG
        # distinct epoch over epoch (torch DataLoader gets this implicitly
        # from its global RNG stream).
        self._batch_counter = 0
        self.counters = LoaderCounters()
        # Ship batches to the device from the worker thread so the
        # host->device copy overlaps the previous step's compute: pinned
        # host memory, non_blocking copies on a side stream of the loader's
        # own (see the module docstring).
        self.device = resolve_device(device)
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)

    def __len__(self):
        per_step = self.batch_size * self.num_devices
        if not len(self.dataset):
            return 0
        # wrap-around padding -> ceil (torch DistributedSampler total_size)
        return max(-(-len(self.dataset) // per_step), 1)

    def _epoch_orders(self):
        while True:
            # Epoch folded into the shuffle RNG: a fresh order every epoch
            # (torch DistributedSampler.set_epoch semantics).
            rng = np.random.default_rng((self.seed, self.epoch))
            order = np.arange(len(self.dataset))
            if self.shuffle:
                rng.shuffle(order)
            yield order
            self.epoch += 1
            if not self.repeat:
                return

    def _build_one(self, indices: List[int], batch_counter: int) -> TrainBatch:
        scenes, items = [], []
        get_item_s = 0.0
        for j, idx in enumerate(indices):
            rng = np.random.default_rng((self.seed, batch_counter, j))
            with span("lgs.loader.get_item", (batch_counter, int(idx))):
                t0 = perf_counter()
                item = self.dataset.get_item(int(idx), rng)
                get_item_s += perf_counter() - t0
            items.append(item)
            feats = item["feats"]
            labels = item["labels"]
            if labels is not None and labels.ndim == 2:
                labels = labels[:, 0]
            scenes.append((item["coords"], feats, labels))
        if getattr(self.dataset.config, "normalize_color", True):
            # Wire format decided PER BATCH (mixed dtypes would promote to
            # raw-valued f32 that the device step would not normalize):
            # uint8 = ship raw colors, the step normalizes on device
            # (TrainBatch.decompact — the reference also normalizes
            # trainer-side, pl_BaselineTrainer.py:299). Augmented colors
            # re-quantize to the source color depth; a batch whose chromatic
            # augs left [0, 255] takes the f32 wire path instead of clamping
            # (ADVICE r4 — no silent train-time distribution change).
            as_uint8 = self.builder.compact_feats and all(
                f.shape[1] == 3
                and (f.size == 0 or (f.min() >= 0.0 and f.max() <= 255.0))
                for _, f, _ in scenes
            )
            for j, (c, f, l) in enumerate(scenes):
                if as_uint8:
                    f = np.round(f).astype(np.uint8)
                else:
                    f = f.copy()
                    f[:, :3] = f[:, :3] / 255.0 - 0.5
                scenes[j] = (c, f, l)
        stats: dict = {}
        # Per-voxel dataset index: prediction dumps derive scene identity
        # from this, so dropped/reordered scenes can never shift ids
        # (reference aligns dumps positionally, lib/utils.py:340-435).
        extras = [
            {"scene_idx": np.full(len(s[0]), int(idx), np.int32)}
            for idx, s in zip(indices, scenes)
        ]
        if self.extras_fn is not None:
            for e, it in zip(extras, items):
                e.update(self.extras_fn(it))
        if getattr(self.dataset.config, "return_transformation", False):
            # Voxelizer transform rows (reference cflt_collate, lib/
            # dataset.py:352): lets the dump path restore original-scale
            # coordinates (lib/utils.py:292-315).
            for e, it in zip(extras, items):
                tr = np.asarray(
                    it.get("transform") if it.get("transform") is not None
                    else np.eye(4), np.float32,
                ).reshape(16)
                e["transform"] = np.tile(tr, (len(e["scene_idx"]), 1))
        # the span and the clock sit at the call: only the loader knows the
        # batch counter
        with span("lgs.loader.build", (batch_counter,)):
            t0 = perf_counter()
            batch = self.builder.build_host(scenes, extras=extras, stats_out=stats)
            build_s = perf_counter() - t0
        self.counters.update(stats, get_item_s, build_s)
        return batch

    def _build_group(self, index_groups: List[List[int]], base_counter: int):
        # this rank's row of the (num_devices, batch_size) group
        counter = base_counter + self.rank
        b = self._build_one(index_groups[self.rank], counter)
        if getattr(b, "graph", None) is not None:
            # pinned builds keep flats (see batching.py); no cross-shard
            # decision here, so drop covered ones now
            from languagegroundedsemseg_torch.sparse.graph_host import (
                drop_covered_flat_maps,
            )

            b = b.replace(graph=drop_covered_flat_maps(b.graph))
        # the host arrays are what crosses to the device
        nbytes = sum(a.nbytes for a in _leaves(b, np.ndarray))
        with span("lgs.loader.h2d", (counter,)):
            built = self._to_device(b)
        self.counters.add_copy(nbytes)
        return built

    def _to_device(self, b: TrainBatch):
        """(batch on the device, copy-done event or None). On the card the
        copy is queued on the side stream from pinned memory and the
        event marks its end; the consumer waits on it (``_ready``)."""
        stream = self._copy_stream
        if stream is None:
            return b.to(self.device), None
        with torch.cuda.stream(stream):
            b = b.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return b, done

    def _ready(self, built) -> TrainBatch:
        """The consumer's half of the transfer: order the current stream
        after the copy and tie every device tensor's memory to it."""
        b, done = built
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in batch_tensors(b):
                if t.is_cuda:
                    t.record_stream(cur)
        return b

    def __iter__(self) -> Iterator:
        per_step = self.batch_size * self.num_devices
        n_dev = self.num_devices
        # Queue of in-flight futures, in submission order. maxsize bounds the
        # number of batches being built/held at once.
        fut_q: "queue.Queue" = queue.Queue(maxsize=self.num_workers + 1)
        stop = threading.Event()
        pool = ThreadPoolExecutor(
            max_workers=self.num_workers, thread_name_prefix="lgs-loader"
        )

        def feeder():
            try:
                for order in self._epoch_orders():
                    if stop.is_set() or not len(order):
                        return
                    # Pad the epoch to a whole number of per-step groups by
                    # wrapping around (torch DistributedSampler semantics:
                    # duplicates <= per_step-1 scenes instead of dropping).
                    total = -(-len(order) // per_step) * per_step
                    padded = np.resize(order, total)
                    for start in range(0, total, per_step):
                        if stop.is_set():
                            return
                        group = padded[start:start + per_step].reshape(
                            n_dev, self.batch_size
                        )
                        base = self._batch_counter
                        self._batch_counter += n_dev
                        fut_q.put(pool.submit(
                            self._build_group, [list(g) for g in group], base
                        ))
            except BaseException as e:  # index-stream/submit errors -> consumer
                fut_q.put(e)
            finally:
                fut_q.put(None)

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        try:
            while True:
                with span("lgs.loader.wait"):
                    t0 = perf_counter()
                    item = fut_q.get()
                    if item is None:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    # result() re-raises any worker exception
                    built = item.result()
                self.counters.add_wait(perf_counter() - t0)
                yield self._ready(built)
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)


def initialize_data_loader(
    DatasetClass,
    config,
    phase,
    num_workers: int,
    shuffle: bool,
    repeat: bool,
    augment_data: bool,
    batch_size: int,
    limit_numpoints: int,
    num_devices: int = 1,
    spec=None,
    ship_coords: bool = True,
    device="cuda",
    rank: Optional[int] = None,
):
    """Reference-compatible loader factory (lib/dataset.py:337-416).

    ship_coords=False builds compact batches (no device-side spatial
    coords — data/batching.py); callers that visualize, run CRF wrappers,
    or read coords back keep the default. Batches land on ``device``; with
    ``num_devices`` ranks, this process is ``rank``."""
    from languagegroundedsemseg_torch.models.res16unet import res16unet_graph_spec

    prevoxel, input_t = build_input_transforms(config, DatasetClass, augment_data)
    dataset = DatasetClass(
        config,
        phase=phase,
        augment_data=augment_data,
        prevoxel_transform=prevoxel,
        input_transform=input_t,
        cache=config.cache_data,
    )
    builder = BatchBuilder(
        spec=spec or res16unet_graph_spec(config.conv1_kernel_size),
        ignore_index=config.ignore_label,
        limit_numpoints=limit_numpoints,
        fixed_capacity=config.fixed_capacity or None,
        level_ratios=config.level_capacity_ratios,
        ship_coords=ship_coords,
        compact_feats=True,
        # Pin batch signatures across batches (data/batching.py): flex
        # capacities floor at their running max, window geometry pins to
        # first-seen, overflow buckets pad to running maxima — shapes stop
        # tracking per-batch density, as in the JAX loader.
        stabilize=True,
    )
    return DataLoader(
        dataset,
        builder,
        batch_size=batch_size,
        shuffle=shuffle,
        repeat=repeat,
        seed=config.seed,
        num_workers=num_workers,
        num_devices=num_devices,
        ignore_index=config.ignore_label,
        device=device,
        rank=rank,
    )
