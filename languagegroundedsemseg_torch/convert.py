"""Weights carried from the JAX package's flax trees to the port.

``state_dict_from_jax(params, batch_stats)`` takes the flax ``params`` and
``batch_stats`` of any model of the zoo as nested dicts of arrays and
returns the port's ``state_dict``, named as the reference state_dict names
its tensors:

    conv0p1s1/kernel                              -> conv0p1s1.kernel
    bn0/SparseBatchNorm_0/{scale,bias}            -> bn0.bn.{weight,bias}
    (batch_stats) bn0/SparseBatchNorm_0/{mean,var} -> bn0.bn.running_{mean,var}
    bn0/SparseInstanceNorm_0/{scale,bias}         -> bn0.inorm.{weight,bias}
    final_in/{scale,bias} (a bare instance norm)  -> final_in.{weight,bias}
    block1_0/conv1/kernel, layer2_1/...           -> block1.0.conv1.kernel, layer2.1...
    block5_0/downsample_conv|downsample_norm/...  -> block5.0.downsample.0|1...
    block1_0/SELayer_0/Dense_0|Dense_1            -> block1.0.se.fc1|fc2
    MeanFieldCRF_0/compatibility                  -> crf.compatibility
    _SharedMLP_0/mlp0                             -> mlp.mlp0
    final/{kernel,bias}                           -> final.{kernel,bias}

A flax ``Dense`` (the SE layers, ``projection_layer``, ``classifier``, the
PointNet++ ``mlp*``) becomes an ``nn.Linear``: its (in, out) ``kernel`` is
the transposed ``weight``. Other names (``base``, ``backbone``,
``compatibility``, ``maps``) carry as they are. Kernel tensors keep the JAX
canonical slot order (``sparse/offsets.py``), so the carry is the identity
on slots. (MinkowskiEngine checkpoints enumerate slots in another order;
loading them needs the reference's ``me_kernel_permutation``.)
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BN_STAT = {"mean": "running_mean", "var": "running_var"}
_RENAME = {"downsample_conv": ["downsample", "0"],
           "downsample_norm": ["downsample", "1"],
           "SparseBatchNorm_0": ["bn"], "SparseInstanceNorm_0": ["inorm"],
           "SELayer_0": ["se"], "Dense_0": ["fc1"], "Dense_1": ["fc2"],
           "MeanFieldCRF_0": ["crf"], "_SharedMLP_0": ["mlp"]}
# flax Dense modules: their kernel is an nn.Linear weight, transposed
_DENSE = re.compile(r"Dense_\d+|projection_layer|classifier|mlp\d+")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _module_path(parts) -> list:
    """flax module names -> torch module path segments."""
    out = []
    for p in parts:
        m = re.fullmatch(r"((?:block|layer)\d+)_(\d+)", p)
        if m:
            out += [m.group(1), m.group(2)]
        else:
            out += _RENAME.get(p, [p])
    return out


def state_dict_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """The port's state_dict from the JAX package's flax trees (f32)."""
    sd = {}
    for path, v in _flatten(params).items():
        mod, leaf = _module_path(path[:-1]), path[-1]
        if leaf == "scale":
            leaf = "weight"
        elif leaf == "kernel" and path[:-1] and _DENSE.fullmatch(path[-2]):
            leaf, v = "weight", v.T
        sd[".".join(mod + [leaf])] = torch.tensor(np.ascontiguousarray(v),
                                                  dtype=torch.float32)
    for path, v in _flatten(batch_stats).items():
        mod = _module_path(path[:-1])
        sd[".".join(mod + [_BN_STAT[path[-1]]])] = torch.tensor(
            v, dtype=torch.float32)
    return sd
