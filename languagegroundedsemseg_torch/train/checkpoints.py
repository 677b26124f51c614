"""Checkpointing: save/restore the train state, best-monitor tracking,
resume discovery, and the MinkowskiEngine (reference) state-dict import and
export.

Counterpart of ``languagegroundedsemseg_tpu/train/checkpoints.py``
(:26-324). It keeps the reference's PL ModelCheckpoint semantics (top-1 on
val_miou max plus val_loss min for pretraining, main.py:129-170), the
max-step resume glob (main.py:140-156), the file names
(``last_step=N.ckpt``, ``best_<metric>=<v:.4f>_step=N.ckpt``, each with a
``.json`` manifest) and the lenient shape-matched cross-ecosystem weight
loading (lib/utils.py:17-45).

The blob is a torch file of tensors only — the model's state dict, the
inner optimizer's state dict, the optimizer's update count, the step and
the plateau scale — so it loads with ``torch.load(..., weights_only=True)``;
everything else goes in the ``.json``. The port's parameter names are the
reference state dict's, so the import is a name-for-name copy with the
JAX importer's rules: the same name translation and skip list, the
ME -> canonical kernel-slot permutation, and the pointwise (1, Cin, Cout)
-> (Cin, Cout) squeeze.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from languagegroundedsemseg_torch.train.state import TrainState


def _state_blob(state: TrainState) -> Dict:
    opt = state.optimizer
    blob = {
        "model": state.model.state_dict(),
        "optimizer": opt.inner.state_dict(),
        "updates": torch.tensor(opt.updates, dtype=torch.int64),
        "mini_step": torch.tensor(opt.mini_step, dtype=torch.int64),
        "step": torch.tensor(int(state.step), dtype=torch.int64),
        "lr_scale": torch.tensor(float(state.lr_scale), dtype=torch.float64),
    }
    if opt._acc is not None:  # gradients accumulated by iter_size > 1
        blob["acc"] = list(opt._acc)
    return blob


def save_checkpoint(path: str, state: TrainState, metadata: Optional[Dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_state_blob(state), path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load ``path`` into ``template``'s model and optimizer (in place, on
    the model's device) and return the state with its step and scale."""
    dev = next(template.model.parameters()).device
    blob = torch.load(path, map_location=dev, weights_only=True)
    template.model.load_state_dict(blob["model"])
    opt = template.optimizer
    opt.inner.load_state_dict(blob["optimizer"])
    opt.updates = int(blob["updates"])
    opt.mini_step = int(blob.get("mini_step", 0))
    opt._acc = blob.get("acc")
    template.step = int(blob["step"])
    template.lr_scale = float(blob["lr_scale"])
    return template


def load_checkpoint_metadata(path: str) -> Dict:
    meta = path + ".json"
    if os.path.isfile(meta):
        with open(meta) as f:
            return json.load(f)
    return {}


def find_resume_checkpoint(log_dir: str) -> Optional[str]:
    """Pick the max-step checkpoint in log_dir (reference main.py:140-156)."""
    ckpts = glob.glob(os.path.join(log_dir, "*.ckpt"))
    best, best_step = None, -1
    for c in ckpts:
        m = re.search(r"step[=_](\d+)", os.path.basename(c))
        step = int(m.group(1)) if m else 0
        if step > best_step:
            best, best_step = c, step
    return best


class CheckpointManager:
    """Keeps 'last' plus top-1 per monitored metric. Under data parallelism
    every rank holds the same state and only rank 0 writes; the other
    ranks' ``save`` does nothing."""

    def __init__(self, log_dir: str, monitors: Dict[str, str], rank: int = 0):
        """monitors: name -> 'max' | 'min' (e.g. {'val_miou': 'max'})."""
        self.log_dir = log_dir
        self.monitors = monitors
        self.best: Dict[str, float] = {}
        self.writer = rank == 0
        if self.writer:
            os.makedirs(log_dir, exist_ok=True)

    def save(self, state: TrainState, metrics: Dict[str, float], step: int, extra_meta=None):
        if not self.writer:
            return
        meta = {"step": step, "metrics": metrics}
        if extra_meta:
            meta.update(extra_meta)
        save_checkpoint(os.path.join(self.log_dir, f"last_step={step}.ckpt"), state, meta)
        # prune older "last" checkpoints
        for c in glob.glob(os.path.join(self.log_dir, "last_step=*.ckpt")):
            m = re.search(r"step=(\d+)", c)
            if m and int(m.group(1)) < step:
                for p in (c, c + ".json"):
                    if os.path.isfile(p):
                        os.remove(p)
        for name, mode in self.monitors.items():
            if name not in metrics or metrics[name] is None:
                continue
            v = float(metrics[name])
            cur = self.best.get(name)
            better = cur is None or (v > cur if mode == "max" else v < cur)
            if better:
                self.best[name] = v
                for c in glob.glob(os.path.join(self.log_dir, f"best_{name}*.ckpt")):
                    for p in (c, c + ".json"):
                        if os.path.isfile(p):
                            os.remove(p)
                save_checkpoint(
                    os.path.join(self.log_dir, f"best_{name}={v:.4f}_step={step}.ckpt"),
                    state,
                    meta,
                )


# ---- cross-ecosystem (MinkowskiEngine / reference) import and export ------


def me_kernel_permutation(num_slots: int, d: int = 3) -> Optional[np.ndarray]:
    """ME -> canonical kernel-slot permutation for hypercube regions.

    MinkowskiEngine's kernel-region iterator enumerates cube offsets with the
    FIRST spatial axis varying fastest (kernel_region.hpp increments
    coordinate 1 first); the canonical order (sparse/offsets.py,
    itertools.product) has the LAST axis fastest. Both walk the same per-axis
    ranges, so the mapping is the axis-reversal of the index cube:
    ``w_canonical[k] = w_me[perm[k]]``.

    Returns None when num_slots is not a perfect d-cube (cross/custom
    regions, where no permutation applies).
    """
    k = round(num_slots ** (1.0 / d))
    if k**d != num_slots or k <= 1:
        return None
    cube = np.arange(num_slots).reshape((k,) * d)
    return cube.transpose(tuple(range(d - 1, -1, -1))).ravel()


def _strip_prefixes(name: str) -> str:
    for p in ("module.", "model.", "encoder."):
        if name.startswith(p):
            name = name[len(p):]
    return name


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference (MinkowskiEngine) checkpoint's tensors as numpy arrays,
    wrapper prefixes stripped. Such files hold pickled training objects,
    so they load with ``weights_only=False``: read only trusted files."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {_strip_prefixes(k): v.numpy() for k, v in blob.items() if hasattr(v, "numpy")}


# modules the port names otherwise than their flax paths (an instance
# norm's ``inorm``, the SE gate's ``se``): the JAX importer looks a bias up
# at its flax path, finds none there and skips it, and so does the port
_RENAMED = frozenset({"inorm", "se"})


def _tensor_kind(name: str) -> Tuple[Optional[str], str]:
    """(kind, port name) of a reference tensor name: kind is 'kernel',
    'bn' (affine), 'bn_stat' (running statistics), 'bias', or None for a
    tensor the import skips (the JAX importer's rules)."""
    name = _strip_prefixes(name)
    parts = name.split(".")
    tail = parts[-1]
    if tail == "kernel":
        return "kernel", name
    if len(parts) >= 2 and parts[-2] == "bn":
        if tail in ("weight", "bias"):
            return "bn", name
        if tail in ("running_mean", "running_var"):
            return "bn_stat", name
    elif tail == "bias" and not _RENAMED.intersection(parts[:-1]):
        return "bias", name
    return None, name


def torch_to_port_state_dict(
    sd: Mapping[str, np.ndarray],
    template: Mapping[str, torch.Tensor],
    kernel_perm: "Optional[np.ndarray] | str" = "me",
) -> Tuple[Dict[str, torch.Tensor], list]:
    """Map a MinkowskiEngine Res16UNet state_dict onto the port's.

    The counterpart of the JAX package's ``torch_to_flax_params``: returns
    (``template`` with every matched tensor replaced (f32, on the
    template's device), skipped names). Shapes are matched leniently
    (reference lib/utils.py:17-45): mismatches are skipped and reported.
    ``kernel_perm`` permutes ME kernel-slot order into the canonical offset
    order: the default "me" derives the hypercube axis-reversal per tensor
    (``me_kernel_permutation``); pass an explicit array or None to
    override. A kernel-volume-1 kernel stored (1, Cin, Cout) loads into a
    (Cin, Cout) pointwise kernel.
    """
    out = dict(template)
    skipped = []
    for name, v in sd.items():
        v = np.asarray(v)
        kind, key = _tensor_kind(name)
        if kind == "kernel" and v.ndim == 3:
            if isinstance(kernel_perm, str) and kernel_perm == "me":
                p = me_kernel_permutation(v.shape[0])
                if p is not None:
                    v = v[p]
            elif kernel_perm is not None and len(kernel_perm) == v.shape[0]:
                v = v[kernel_perm]
            if v.shape[0] == 1 and key in template and template[key].dim() == 2:
                v = v[0]
        if kind is None or key not in template or tuple(template[key].shape) != v.shape:
            skipped.append(name)
            continue
        out[key] = torch.as_tensor(v.astype(np.float32),
                                   device=template[key].device)
    return out, skipped


def port_to_torch_state_dict(
    state_dict: Mapping[str, torch.Tensor],
    template_sd: Mapping[str, np.ndarray],
) -> Tuple[Dict[str, np.ndarray], list]:
    """Inverse of ``torch_to_port_state_dict`` (the counterpart of the JAX
    package's ``flax_to_torch_state_dict``): exports the port's state dict
    into a MinkowskiEngine-format one following a TEMPLATE (names + shapes).
    Inverts the ME kernel-slot permutation and the pointwise (1, Cin, Cout)
    <-> (Cin, Cout) squeeze. Returns (state_dict, missing_names)."""
    out: Dict[str, np.ndarray] = {}
    missing = []
    for name, tv in template_sd.items():
        tv = np.asarray(tv)
        kind, key = _tensor_kind(name)
        v = None
        if kind is not None and key in state_dict:
            v = state_dict[key].detach().cpu().numpy()
            if kind == "kernel":
                if tv.ndim == 3 and v.ndim == 2:
                    v = v[None]  # pointwise back to kernel-volume-1
                if v.ndim == 3:
                    p = me_kernel_permutation(v.shape[0])
                    if p is not None:
                        v = v[np.argsort(p)]
        if v is None or v.shape != tv.shape:
            missing.append(name)
            continue
        out[name] = np.asarray(v, dtype=np.float32)
    return out, missing
