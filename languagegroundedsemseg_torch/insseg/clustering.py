"""Vote-shift clustering -> instance proposals.

Counterpart of ``languagegroundedsemseg_tpu/insseg/clustering.py``
(:18-111), on the port's ``ops/cluster.cluster_points`` (the host path:
cKDTree pairs and scipy components, as in the JAX package).

Mirror of reference downstream/insseg/lib/bfs/bfs.py:83-157 Clustering: the
vertices are coords + predicted offsets / voxel_size; a radius graph over
same-semantic-label points is clustered into connected components; clusters
under ``propose_points`` are dropped; confidence = score_func over the
cluster's class scores.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from languagegroundedsemseg_torch.ops.cluster import cluster_points


class Clustering:
    def __init__(
        self,
        ignored_labels: List[int],
        class_mapping: Optional[np.ndarray] = None,
        thresh: float = 0.03,
        closed_points: int = 300,
        min_points: int = 50,
        propose_points: int = 100,
        score_func=np.max,
        max_neighbors: int = 48,
    ):
        self.ignored_labels = list(ignored_labels)
        self.class_mapping = class_mapping  # train id -> raw benchmark id
        self.thresh = thresh
        # closed_points is the reference's initial meanActive ball-query
        # budget (bfs.py:141), which its retry loop grows until the whole
        # within-radius neighborhood fits; our exact host pair query IS that
        # converged state, so the budget only matters as a sanity bound on
        # expected neighborhood size (kept for constructor parity).
        self.closed_points = closed_points
        self.min_points = min_points
        self.propose_points = propose_points
        self.score_func = score_func
        self.max_neighbors = max_neighbors  # device-path table width only

    def get_instances_dual_set(
        self,
        vertices_shifted: np.ndarray,
        vertices_original: np.ndarray,
        scores: np.ndarray,
        nms_iou: float = 0.3,
    ) -> Dict[int, dict]:
        """Dual-set clustering + class-conditional NMS: cluster both the
        vote-shifted and the original coordinates, merge proposals, suppress
        same-class duplicates by mask IoU (reference
        downstream/insseg/lib/pl_Trainer.py:370-387 and lib/test.py)."""
        a = self.get_instances(vertices_shifted, scores)
        b = self.get_instances(vertices_original, scores)
        proposals = list(a.values()) + list(b.values())
        proposals.sort(key=lambda p: -p["conf"])
        kept: list = []
        for p in proposals:
            pm = p["pred_mask"]
            ps = pm.sum()
            dup = False
            for q in kept:
                if q["label_id"] != p["label_id"]:
                    continue
                inter = np.logical_and(pm, q["pred_mask"]).sum()
                union = ps + q["pred_mask"].sum() - inter
                if union > 0 and inter / union > nms_iou:
                    dup = True
                    break
            if not dup:
                kept.append(p)
        return {i: p for i, p in enumerate(kept)}

    def get_instances(self, vertices: np.ndarray, scores: np.ndarray) -> Dict[int, dict]:
        """vertices (N, 3) vote-shifted positions; scores (N, C) softmax.

        -> {proposal_id: {conf, label_id, pred_mask}} (reference :146-157).
        """
        labels = scores.argmax(axis=1)
        mapped = (
            self.class_mapping[labels] if self.class_mapping is not None else labels
        )
        ignore = np.isin(mapped, self.ignored_labels)

        comp, n_comp = cluster_points(
            vertices,
            labels,
            radius=self.thresh,
            max_neighbors=self.max_neighbors,
            min_points=self.min_points,
            ignored_mask=ignore,
        )

        instances = {}
        pid = 0
        for c in range(n_comp):
            mask = comp == c
            if mask.sum() <= self.propose_points:
                continue
            lab = labels[mask][0]
            conf = float(self.score_func(scores[mask, lab]))
            instances[pid] = {
                "conf": conf,
                "label_id": int(self.class_mapping[lab]) if self.class_mapping is not None else int(lab),
                "pred_mask": mask,
            }
            pid += 1
        return instances
