"""Model registry of the port (counterpart of unirec_tpu/utils/registry.py;
the JAX registry imports the flax models, so the port keeps its own)."""
from __future__ import annotations

from typing import Callable, Dict

_MODELS: Dict[str, type] = {}
# the JAX package's closed-form solver models (unirec_tpu/models/solvers.py)
_NOT_PORTED = {name: "Queue 1 item 9" for name in ("EASE", "SLIM", "AdmmSLIM", "SAR", "UserCF")}


def register_model(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _MODELS[name] = cls
        return cls
    return deco


def get_model_class(name: str) -> type:
    from unirec_tpu_torch import models  # noqa: F401  (registers the models)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md {_NOT_PORTED[name]})")
    if name not in _MODELS:
        raise ValueError(f"unknown model '{name}'. Registered: {sorted(_MODELS)}")
    return _MODELS[name]
