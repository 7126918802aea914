"""Import reference (UniRec torch) checkpoints into the port.

Counterpart of unirec_tpu/utils/torch_import.py: the migration path for
users of the reference trainer, whose ``.pth`` files (trainer.py:389-398, a
dict with ``state_dict`` and ``config``) convert into a flax-style
parameter tree. The port names its parameters as flax does
(utils/flax_bridge.py), so the converted tree loads into a port model
through the bridge. Name mapping, as in the JAX package:

    a.b.weight (Linear [out, in])  -> a/b/kernel (transposed to [in, out])
    a.b.bias                       -> a/b/bias
    *embedding*.weight             -> .../embedding (no transpose)
    LayerNorm.weight / .bias       -> .../scale, .../bias
    trm_encoder.layer.<i>.*        -> trm_encoder/layer_<i>/*

Keys whose leaf is neither ``weight`` nor ``bias`` are not converted: they
are returned (and ``load_reference_checkpoint`` warns about them) for the
caller to inspect, never dropped silently.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _is_embedding(path: List[str]) -> bool:
    return any("embedding" in p for p in path)


def _merge_indices(parts: List[str]) -> List[str]:
    """torch ModuleList indices joined to their list: layer.0.x -> layer_0/x."""
    merged: List[str] = []
    for p in parts:
        if p.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    return merged


def convert_state_dict(state_dict: Dict[str, Any]) -> Tuple[Dict[str, Any], List[str]]:
    """A reference state_dict -> (nested dict of numpy arrays by flax path,
    the keys left unconverted)."""
    tree: Dict[str, Any] = {}
    leftovers: List[str] = []
    for key, tensor in state_dict.items():
        arr = np.asarray(tensor.detach().cpu().numpy() if hasattr(tensor, "detach")
                         else tensor)
        *path, leaf = _merge_indices(key.split("."))
        if leaf == "weight":
            if path and path[-1].startswith("LayerNorm"):
                leaf = "scale"
            elif _is_embedding(path):
                leaf = "embedding"
            else:
                leaf = "kernel"
                if arr.ndim == 2:
                    arr = arr.T
        elif leaf != "bias":
            leftovers.append(key)
            continue
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree, leftovers


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(converted parameter tree, reference config) from a UniRec ``.pth``
    file; warns naming the keys it left unconverted."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    params, leftovers = convert_state_dict(ckpt["state_dict"])
    if leftovers:
        logger.warning("unconverted checkpoint keys: %s", leftovers)
    return params, ckpt.get("config", {})


def load_reference_into(model, path: str, strict: bool = False) -> Dict[str, Any]:
    """Load a UniRec ``.pth`` file's parameters into the port ``model``
    through the bridge (``load_flax_params``; not strict: the leaves whose
    path and shape match, as the JAX trainer merges a loaded tree). Returns
    the reference config."""
    from unirec_tpu_torch.utils.flax_bridge import load_flax_params
    params, cfg = load_reference_checkpoint(path)
    load_flax_params(model, params, strict=strict)
    return cfg
