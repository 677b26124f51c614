"""Model registry: name -> model class, mirroring the reference's
load_model() / load_wrapper() string lookup (reference
models/__init__.py:33-50).

Counterpart of ``languagegroundedsemseg_tpu/models/__init__.py``: every
class with "Net" in its name from res16unet, clip_models, classifier,
resnet and resunet is registered, as in JAX.
"""

from __future__ import annotations

import inspect

from languagegroundedsemseg_torch.models import classifier as _classifier
from languagegroundedsemseg_torch.models import clip_models as _clip_models
from languagegroundedsemseg_torch.models import res16unet as _res16unet
from languagegroundedsemseg_torch.models import resnet as _resnet
from languagegroundedsemseg_torch.models import resunet as _resunet
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
        if "Net" in nm:
            _REGISTRY[nm] = cls


for _m in (_res16unet, _clip_models, _classifier, _resnet, _resunet):
    _register_module_nets(_m)


def load_wrapper(name: str) -> type:
    """Wrapper registry (reference models/__init__.py:50): CRF post-filters
    around a base model."""
    from languagegroundedsemseg_torch.models.crf import (
        BilateralCRF,
        TrilateralCRF,
        Wrapper,
    )

    wrappers = {"Wrapper": Wrapper, "BilateralCRF": BilateralCRF,
                "TrilateralCRF": TrilateralCRF}
    if name not in wrappers:
        raise KeyError(f"unknown wrapper {name!r}; available: {sorted(wrappers)}")
    return wrappers[name]


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
