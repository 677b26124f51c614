"""Capacity-bucketed batch assembly: scenes -> padded TrainBatch + ConvGraph.

Counterpart of ``languagegroundedsemseg_tpu/data/batching.py``, copied with
its flex capacities, the stabilize contract and the compact wire format, so
the two packages build array-equal batches from the same scenes.
``build_host`` returns the numpy batch; ``build`` moves it to a device.

Reproduces the reference collate semantics (lib/transforms.py:385-423):
scenes are concatenated with a batch-index column; a scene that would push
the batch past ``limit_numpoints`` is dropped whole (the reference truncates
the batch there too, :405-411). Capacities are rounded up to bucket sizes so
jit recompiles only a handful of times, then serves from cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from languagegroundedsemseg_torch.sparse.graph_host import (
    GraphSpec,
    default_capacities,
    quantize,
)
from languagegroundedsemseg_torch.sparse.graph_native import build_graph_native as build_graph
from languagegroundedsemseg_torch.train.step import TrainBatch


def bucket_capacity(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket if none fits — caller truncates)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


DEFAULT_BUCKETS = tuple(2 ** k for k in range(13, 22))  # 8k .. 2M voxels


@dataclass
class BatchBuilder:
    """Builds padded device batches from per-scene voxelized arrays."""

    spec: GraphSpec
    ignore_index: int = 255
    limit_numpoints: int = 1_800_000  # reference config/config.py:191
    buckets: Sequence[int] = DEFAULT_BUCKETS
    fixed_capacity: Optional[int] = None  # pin cap0 (for jit-stable training)
    level_ratios: Optional[Sequence[float]] = None
    # Flex mode (default whenever cap0 is not pinned): the graph finalize
    # pass re-buckets every level's capacity to fit its real rows PLUS its
    # sentinel demand (sparse/graph_host.py:finalize_graph flex=True), so
    # the fused conv paths never fall back to flat for lack of headroom and
    # loose level ratios stop costing compute. Shapes quantize to
    # flex_bucket steps (~6%), so jit still serves from a handful of cached
    # compilations. Pinned mode keeps fully static shapes for multi-device
    # stacking (parallel/dp.py:stack_batches) and instead reserves
    # ``sentinel_headroom`` of cap0 at truncation time.
    flex: Optional[bool] = None
    # Pinned-mode only: fraction of cap0 kept free for sentinel rows — a
    # level filled to its exact capacity has no room for the expansion pass
    # (sparse/graph_host.py:expand_sentinels), which silently drops the
    # whole level-0 conv stack to the flat path (~3x slower). Sentinel
    # demand is scene-dependent (~10-40% of rows on ScanNet-like surfaces).
    sentinel_headroom: float = 0.12
    # H2D compaction (the host<->device link bounds e2e throughput —
    # PERF.md round 4). ship_coords=False replaces each level's (cap, 4)
    # coords with per-scene row boundaries (sparse/types.py:batch_starts);
    # the device compute path only reads the batch column. Consumers that
    # need device-side spatial coords (CRF wrappers, visualization dumps,
    # insseg clustering readback) must keep it True — the trainer picks.
    ship_coords: bool = True
    # float16 feats / uint8 labels on the wire: the train/eval steps cast
    # back at entry (train/step.py:TrainBatch.decompact). uint8 labels are
    # lossless (requires labels <= 255 with ignore_index 255 — the
    # reference's own convention) and default on. f16 feats quantize
    # (~3 decimal digits — plenty for color-scale inputs) so they are
    # opt-in: the production loader (data/loader.py) and bench enable it;
    # oracle/parity tests keep exact f32.
    compact_feats: bool = False
    compact_labels: bool = True
    # Jit-signature stabilization (the production loader turns this on):
    # without it every batch's flex capacities, window-menu picks, and
    # pow-2 overflow buckets track that batch's density, so similar scenes
    # still produce MANY distinct jit signatures — and under a remote
    # compile service each new signature is minutes of XLA time. With it,
    # the builder keeps a per-process contract: per-level capacities are
    # floored at their running max, each map's (tile, win) window geometry
    # is pinned to first-seen, and overflow-COO arrays are padded (with
    # semantic no-op guard rows, as the cross-shard harmonization does) to
    # running maxima. Signatures then change only on monotone growth
    # events, which decay to zero after a few batches. (The reference gets
    # this for free: torch tolerates dynamic shapes per batch.)
    stabilize: bool = False

    def __post_init__(self):
        import threading

        self._sig_lock = threading.Lock()
        self._sig_caps: Optional[list] = None
        self._sig_windows: dict = {}
        self._sig_ov: dict = {}

    def capacities(self, cap0: int) -> Tuple[int, ...]:
        return default_capacities(cap0, self.spec.num_levels, self.level_ratios)

    def _stabilize_signature(self, graph):
        """Post-build half of the signature contract: fold this build's
        shapes into the running maxima and pad the overflow-COO arrays up
        to them (guard rows are semantic no-ops — the same padding the
        cross-shard harmonization applies, sparse/graph_host.py
        pad_ms_overflow_to / pad_cs_overflow_to)."""
        from languagegroundedsemseg_torch.sparse.graph_host import (
            pad_cs_overflow_to,
            pad_ms_overflow_to,
        )
        from languagegroundedsemseg_torch.sparse.types import (
            ChildSumMap,
            MaskedShiftMap,
        )

        with self._sig_lock:
            caps = [lvl.valid.shape[0] for lvl in graph.levels]
            if self._sig_caps is None:
                self._sig_caps = caps
            else:
                self._sig_caps = [max(a, b)
                                  for a, b in zip(self._sig_caps, caps)]
            gmaps = dict(graph.gmaps or {})
            changed = False
            for name, gm in gmaps.items():
                if isinstance(gm, MaskedShiftMap):
                    # builds consume the pin as a menu SUFFIX
                    # (graph_host._menu_from_pin), so the observed choice is
                    # >= the pin in menu order — recording it keeps the
                    # contract monotone and convergent
                    self._sig_windows[name] = (int(gm.tile), int(gm.win))
                    rec = self._sig_ov.setdefault(
                        name, {"seg": 0, "n": 0, "dseg": 0, "dn": 0})
                    seg = max(rec["seg"], int(gm.ov_seg))
                    dseg = max(rec["dseg"], int(gm.dwov_seg))
                    n = max(rec["n"], gm.ov_in.shape[0], seg,
                            (int(gm.ov_off[-1]) + seg)
                            if gm.ov_in.shape[0] else 0)
                    dn = max(rec["dn"], gm.dwov_in.shape[0], dseg,
                             (int(gm.dwov_off[-1]) + dseg)
                             if gm.dwov_in.shape[0] else 0)
                    rec.update(seg=seg, n=n, dseg=dseg, dn=dn)
                    if (n > gm.ov_in.shape[0] or dn > gm.dwov_in.shape[0]
                            or seg != int(gm.ov_seg)
                            or dseg != int(gm.dwov_seg)):
                        gmaps[name] = pad_ms_overflow_to(gm, seg, n, dseg, dn)
                        changed = True
                elif isinstance(gm, ChildSumMap):
                    # cs pins are (n_groups, tile, win) triples matching
                    # graph_host._CS_MENU; (0, 0, 0) pins scatter mode
                    self._sig_windows[name] = (
                        (int(gm.n_groups), int(gm.tile), int(gm.win))
                        if gm.tile else (0, 0, 0))
                    rec = self._sig_ov.setdefault(name, {"seg": 0, "n": 0})
                    seg = max(rec["seg"], int(gm.ov_seg))
                    n = max(rec["n"], gm.ov_in.shape[0], seg,
                            (int(gm.ov_off[-1]) + seg)
                            if gm.ov_in.shape[0] else 0)
                    rec.update(seg=seg, n=n)
                    if n > gm.ov_in.shape[0] or seg != int(gm.ov_seg):
                        gmaps[name] = pad_cs_overflow_to(gm, seg, n)
                        changed = True
        if changed:
            graph = graph.replace(gmaps=gmaps)
        return graph

    def build(
        self,
        scenes: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        extras: Optional[List[dict]] = None,
        return_layout: bool = False,
        stats_out: Optional[dict] = None,
        device="cuda",
    ):
        """``build_host`` followed by a move of every array to ``device``
        (torch tensors; the wire dtypes are kept and ``TrainBatch.decompact``
        casts at the step's entry)."""
        out = self.build_host(scenes, extras=extras,
                              return_layout=return_layout, stats_out=stats_out)
        if return_layout:
            return out[0].to(device), out[1]
        return out.to(device)

    def build_host(
        self,
        scenes: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        extras: Optional[List[dict]] = None,
        return_layout: bool = False,
        stats_out: Optional[dict] = None,
    ) -> TrainBatch:
        """scenes: list of (voxel_coords int32 (N,3), feats (N,F), labels (N,)).
        extras: optional per-scene dicts of (N, ...) arrays carried through
        dedup/sort/padding (instance centers, ids, ...); padded with zeros.
        stats_out: if given, filled with data-loss/fill stats for this batch
        (scenes_dropped, voxels_dropped, levels: l -> (num, cap, overflowed)).

        Coordinates must already be quantized voxel integers (the voxelizer's
        output); duplicates within a scene are deduped here.
        """
        coords_l, feats_l, labels_l = [], [], []
        extras_l: dict = {}
        total = 0
        scenes_dropped = 0
        for b, (vc, vf, vl) in enumerate(scenes):
            if total + len(vc) > self.limit_numpoints and b > 0:
                scenes_dropped = len(scenes) - b
                break  # drop the remainder of the batch, reference-style
            bc = np.concatenate(
                [np.full((len(vc), 1), b, dtype=np.int32), vc.astype(np.int32)], axis=1
            )
            coords_l.append(bc)
            feats_l.append(vf)
            labels_l.append(vl)
            if extras is not None:
                for k, v in extras[b].items():
                    extras_l.setdefault(k, []).append(np.asarray(v))
            total += len(vc)

        coords = np.concatenate(coords_l, axis=0)
        feats = np.concatenate(feats_l, axis=0)
        if feats.dtype != np.uint8:  # uint8 = raw colors, normalized on device
            feats = feats.astype(np.float32)
        labels = np.concatenate(labels_l, axis=0).astype(np.int32)
        extra_cat = {k: np.concatenate(v, axis=0) for k, v in extras_l.items()}

        # Safety dedup across the batch (scenes are independent via batch col),
        # then sort rows by packed key: grouped kernel maps rely on
        # z-neighbors being adjacent rows.
        from languagegroundedsemseg_torch.sparse.graph_host import pack_keys

        keep = quantize(coords)
        if len(keep) != len(coords):
            keep = np.sort(keep)
        else:
            keep = np.arange(len(coords))
        order = keep[np.argsort(pack_keys(coords[keep]), kind="stable")]

        n_raw = len(order)
        flex = self.flex if self.flex is not None else self.fixed_capacity is None
        if flex:
            # Flex: truncation only at the bucket ceiling / pinned budget;
            # the finalize pass re-buckets the real capacities to demand.
            cap0 = self.fixed_capacity or bucket_capacity(n_raw, self.buckets)
            limit0 = cap0
        else:
            # Pinned: reserve headroom so sentinel expansion fits
            # (drop-overflow, as at the deeper levels).
            denom = max(1.0 - self.sentinel_headroom, 1e-6)
            cap0 = self.fixed_capacity or bucket_capacity(
                int(np.ceil(n_raw / denom)), self.buckets)
            limit0 = cap0 - int(cap0 * self.sentinel_headroom)
        order = order[:limit0]
        coords, feats, labels = coords[order], feats[order], labels[order]
        extra_cat = {k: v[order] for k, v in extra_cat.items()}

        glay: dict = {}
        # Pinned (multi-device) builds keep every flat table: which fused
        # maps survive the cross-shard harmonization is a global decision,
        # so redundant flats are dropped after stacking
        # (graph_host.drop_covered_flat_maps), not per shard.
        # Production loaders skip the per-batch invariant scans inside map
        # fusion (~60 full-cap numpy passes per k3 map); our builders
        # guarantee them by construction, and LGS_VALIDATE_GRAPH=1 re-arms
        # them for debugging.
        import os as _os
        min_caps = pin_windows = None
        if self.stabilize and flex:
            with self._sig_lock:
                min_caps = list(self._sig_caps) if self._sig_caps else None
                pin_windows = dict(self._sig_windows) or None
        graph = build_graph(coords, self.spec, self.capacities(cap0),
                            layout_out=glay, flex=flex, drop_redundant=flex,
                            validate=_os.environ.get(
                                "LGS_VALIDATE_GRAPH", "0") == "1",
                            ship_coords=self.ship_coords,
                            min_caps=min_caps, pin_windows=pin_windows)
        if self.stabilize and flex:
            graph = self._stabilize_signature(graph)
        cap0 = graph.levels[0].valid.shape[0]  # post-flex level-0 capacity
        # Sentinel expansion (sparse/graph_host.py:expand_sentinels) may have
        # interleaved zero rows: real level-0 row i now lives at pos0[i].
        pos0 = glay.get("pos0")
        if pos0 is None:
            pos0 = np.arange(len(coords), dtype=np.int32)
        if stats_out is not None:
            stats_out["scenes_dropped"] = scenes_dropped
            stats_out["voxels_dropped"] = n_raw - len(order)
            stats_out["levels"] = {
                l: (int(lvl.num), lvl.capacity, bool(int(lvl.num) >= lvl.capacity and l > 0))
                for l, lvl in enumerate(graph.levels)
            }
            # level 0 overflow is exact (n_raw known); deeper levels flag
            # num == capacity (the truncation site, graph_host.py:399-407)
            stats_out["levels"][0] = (
                len(pos0),
                graph.levels[0].capacity,
                n_raw > cap0,
            )
        # uint8 feats stay uint8 on the wire (raw colors; the step
        # normalizes on device — TrainBatch.decompact, matching the
        # reference's trainer-side /255 - 0.5)
        if feats.dtype == np.uint8:
            f_dtype = np.uint8
        else:
            f_dtype = np.float16 if self.compact_feats else np.float32
        feats_p = np.zeros((cap0, feats.shape[1]), dtype=f_dtype)
        feats_p[pos0] = feats
        l_dtype = (
            np.uint8
            if (self.compact_labels and self.ignore_index == 255
                and labels.size and labels.min() >= 0 and labels.max() <= 255)
            else np.int32
        )
        labels_p = np.full((cap0,), self.ignore_index, dtype=l_dtype)
        labels_p[pos0] = labels
        extras_p = {}
        for k, v in extra_cat.items():
            pad = np.zeros((cap0,) + v.shape[1:], dtype=v.dtype)
            pad[pos0] = v
            extras_p[k] = pad
        batch = TrainBatch(feats=feats_p, labels=labels_p, graph=graph, extras=extras_p)
        if return_layout:
            # order maps kept row i -> original concatenated row; pos0 maps
            # kept row i -> padded device row; scene_offsets give each
            # scene's base in the concatenated (pre-sort) space — callers
            # remap cross-batch indices (paired-view correspondences).
            offsets = np.cumsum([0] + [len(s[0]) for s in scenes[:-1]])
            return batch, {"order": order, "pos0": pos0,
                           "scene_offsets": offsets}
        return batch
