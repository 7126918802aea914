"""Checkpoint pickles shared with the JAX package.

Counterpart of unirec_tpu/utils/checkpoint.py. A checkpoint is a pickled
dict {config, params, ...}: ``config`` a plain dict and ``params`` the flax
parameter tree as nested dicts of numpy arrays. The JAX trainer also stores
its optax ``opt_state``, whose pickle names optax classes; the loader maps
every global of the ``jax``, ``flax`` and ``optax`` packages to an inert
stub, so a checkpoint loads without them and serving reads only ``config``
and ``params``. The port's trainer stores its own ``opt_state`` as numpy
(``opt_state_to_numpy``): scalars as 0-d arrays and every per-parameter
list as a flax-layout tree, so the file holds no class of either
framework. Only load checkpoints that this project wrote: unpickling runs
code named by the file.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

_FOREIGN_ROOTS = ("jax", "jaxlib", "flax", "optax")


class _Inert:
    """Stands in for any class or function of a foreign package: accepts
    whatever the pickle passes it and keeps it, doing nothing else."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __setstate__(self, state):
        self.state = state


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN_ROOTS:
            return _Inert
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` in the JAX package's pickle layout: arrays as numpy,
    config without its private ``_`` keys; written to a temporary file and
    renamed, so a reader never sees half a checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = dict(state)
    for key in ("params", "opt_state"):
        if payload.get(key) is not None:
            payload[key] = _to_numpy(payload[key])
    if payload.get("config") is not None:
        payload["config"] = {k: v for k, v in payload["config"].items()
                             if not k.startswith("_")}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def opt_state_to_numpy(model, opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The port optimizer's state (core/optim.py) as numpy: 0-d tensors as
    arrays, per-parameter lists as flax-layout trees."""
    from unirec_tpu_torch.utils.flax_bridge import to_flax_tree
    return {k: to_flax_tree(model, v) if isinstance(v, list)
            else v.detach().cpu().numpy() for k, v in opt_state.items()}


def opt_state_from_numpy(model, state: Dict[str, Any], device) -> Dict[str, Any]:
    """Inverse of opt_state_to_numpy, onto ``device``."""
    from unirec_tpu_torch.utils.flax_bridge import from_flax_tree
    return {k: [t.to(device) for t in from_flax_tree(model, v)] if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v), device=device) for k, v in state.items()}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def load_model_freely(path: str, device: Optional[str] = None):
    """Rebuild a model from the config embedded in its checkpoint
    (reference general.py:208-230) and load its weights through the flax
    bridge. Returns (model on ``device`` in eval mode, config)."""
    from unirec_tpu_torch.utils import resolve_device
    from unirec_tpu_torch.utils.flax_bridge import load_flax_params
    from unirec_tpu_torch.utils.registry import get_model_class

    dev = resolve_device(device)
    ckpt = load_checkpoint(path)
    cfg = ckpt["config"]
    model = get_model_class(cfg["model"])(cfg)
    load_flax_params(model, ckpt["params"])
    return model.to(dev).eval(), cfg
