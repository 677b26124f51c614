"""Model registry: name -> model class, mirroring the reference's
load_model() / load_wrapper() string lookup (reference
models/__init__.py:33-50).

Counterpart of ``languagegroundedsemseg_tpu/models/__init__.py``. Only the
classes the port has are registered: the BasicBlock Res16UNet variants and
the CLIP variants Res16UNet34CR and Res16UNet34D.
"""

from __future__ import annotations

import inspect

from languagegroundedsemseg_torch.models import clip_models as _clip_models
from languagegroundedsemseg_torch.models import res16unet as _res16unet
from languagegroundedsemseg_torch.models.res16unet import (
    Res16UNetBase,
    res16unet_graph_spec,
)

_REGISTRY: dict[str, type] = {}


def register(cls=None, name: str | None = None):
    def _do(c):
        _REGISTRY[name or c.__name__] = c
        return c

    return _do(cls) if cls is not None else _do


def _register_module_nets(module):
    for nm, cls in inspect.getmembers(module, inspect.isclass):
        if "Net" in nm and issubclass(cls, Res16UNetBase) and cls is not Res16UNetBase:
            _REGISTRY[nm] = cls


_register_module_nets(_res16unet)
_register_module_nets(_clip_models)


def load_wrapper(name: str) -> type:
    """The CRF wrappers (reference models/__init__.py:50) come with the
    rest of the model zoo (ROADMAP Queue 1, item 6)."""
    raise NotImplementedError(
        f"wrapper {name!r}: the CRF wrappers are not ported yet "
        "(ROADMAP Queue 1, item 6)")


def load_model(name: str) -> type:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def available_models() -> list[str]:
    return sorted(_REGISTRY)


__all__ = [
    "load_model",
    "load_wrapper",
    "available_models",
    "register",
    "Res16UNetBase",
    "res16unet_graph_spec",
]
