"""Weights carried from the JAX package's flax trees to the port.

``state_dict_from_jax(params, batch_stats)`` takes the flax ``params`` and
``batch_stats`` of a Res16UNet as nested dicts of arrays and returns the
port's ``state_dict``, named as the reference state_dict names its tensors:

    conv0p1s1/kernel                              -> conv0p1s1.kernel
    bn0/SparseBatchNorm_0/{scale,bias}            -> bn0.bn.{weight,bias}
    (batch_stats) bn0/SparseBatchNorm_0/{mean,var} -> bn0.bn.running_{mean,var}
    block1_0/conv1/kernel                         -> block1.0.conv1.kernel
    block5_0/downsample_conv|downsample_norm/...  -> block5.0.downsample.0|1...
    final/{kernel,bias}                           -> final.{kernel,bias}

Kernel tensors keep the JAX canonical slot order (``sparse/offsets.py``), so
the carry is the identity on slots. (MinkowskiEngine checkpoints enumerate
slots in another order; loading them needs the reference's
``me_kernel_permutation``.)
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}


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
        m = re.fullmatch(r"(block\d+)_(\d+)", p)
        if m:
            out += [m.group(1), m.group(2)]
        elif p == "downsample_conv":
            out += ["downsample", "0"]
        elif p == "downsample_norm":
            out += ["downsample", "1"]
        elif p == "SparseBatchNorm_0":
            out.append("bn")
        else:
            out.append(p)
    return out


def state_dict_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """The port's state_dict from the JAX package's flax trees (f32)."""
    sd = {}
    for path, v in _flatten(params).items():
        mod, leaf = _module_path(path[:-1]), path[-1]
        if mod and mod[-1] == "bn":
            leaf = _BN_PARAM[leaf]
        sd[".".join(mod + [leaf])] = torch.tensor(v, dtype=torch.float32)
    for path, v in _flatten(batch_stats).items():
        mod = _module_path(path[:-1])
        sd[".".join(mod + [_BN_STAT[path[-1]]])] = torch.tensor(
            v, dtype=torch.float32)
    return sd
