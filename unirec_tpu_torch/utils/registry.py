"""Model registry of the port (counterpart of unirec_tpu/utils/registry.py;
the JAX registry imports the flax models, so the port keeps its own)."""
from __future__ import annotations

from typing import Callable, Dict

_MODELS: Dict[str, type] = {}


def register_model(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _MODELS[name] = cls
        return cls
    return deco


def get_model_class(name: str) -> type:
    from unirec_tpu_torch import models  # noqa: F401  (registers the models)
    if name not in _MODELS:
        raise ValueError(f"unknown model '{name}'. Registered: {sorted(_MODELS)}")
    return _MODELS[name]
