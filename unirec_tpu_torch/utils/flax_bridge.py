"""flax parameter trees <-> the port's modules.

The port names its submodules exactly as the flax modules are named
(``trm_encoder.layer_0.multi_head_attention.query``), so a parameter's flax
path is its module path plus a leaf name fixed by the module type:

    nn.Linear     weight [out, in] <-> kernel [in, out] (transposed)
                  bias                 bias
    nn.LayerNorm  weight               scale
                  bias                 bias
    nn.Embedding  weight               embedding
    any other     <name>               <name>  (e.g. SASRec's item_bias)

The fused and unfused layer paths of the JAX package share one parameter
tree (unirec_tpu/models/modules.py:414-491), so this one mapping covers
both. Values are copied bit for bit; a round trip is exact. A table
row-sharded over the mesh's ``model`` ranks (``row_shard``, core/mesh.py)
is written whole, its rows gathered from every rank (a collective: every
rank builds the tree), and loads its own rows of a whole table.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_LEAF = {nn.Linear: {"weight": "kernel"},
         nn.LayerNorm: {"weight": "scale"},
         nn.Embedding: {"weight": "embedding"}}


def _leaves(model: nn.Module) -> Iterator[Tuple[Tuple[str, ...], nn.Parameter, bool]]:
    """(flax path, parameter, transposed) for every parameter of ``model``."""
    for mod_name, mod in model.named_modules():
        renames = _LEAF.get(type(mod), {})
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        for pname, p in mod.named_parameters(recurse=False):
            transposed = isinstance(mod, nn.Linear) and pname == "weight"
            yield prefix + (renames.get(pname, pname),), p, transposed


def named_flax_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """{"item_embedding/embedding": parameter, ...}: each parameter by its
    flax path, in ``model.parameters()`` order."""
    return {"/".join(path): p for path, p, _ in _leaves(model)}


def to_flax_params(model: nn.Module) -> Dict:
    """The flax ``params`` tree (nested dicts of numpy arrays) of ``model``."""
    return to_flax_tree(model, list(model.parameters()))


def to_flax_tree(model: nn.Module, values: Sequence[torch.Tensor]) -> Dict:
    """A flax-layout tree of per-parameter tensors ``values`` (in
    ``model.parameters()`` order, each shaped like its parameter), such as
    an optimizer's moments."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    tree: Dict = {}
    for path, p, transposed in _leaves(model):
        value = values[index[id(p)]].detach()
        shard = getattr(p, "row_shard", None)
        if shard is not None:        # a row-sharded table: every rank's rows
            value = shard.gather(value)
        value = value.cpu()
        value = value.t() if transposed else value
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(value.numpy())
    return tree


def from_flax_tree(model: nn.Module, tree: Dict) -> List[torch.Tensor]:
    """Inverse of to_flax_tree: CPU tensors in ``model.parameters()`` order."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    out: List = [None] * len(index)
    for path, p, transposed in _leaves(model):
        value = torch.from_numpy(np.array(_node(tree, path), copy=True))
        value = value.t().contiguous() if transposed else value
        shard = getattr(p, "row_shard", None)
        out[index[id(p)]] = value[shard.rows].clone() if shard is not None \
            and value.shape[0] == shard.n_rows else value
    return out


def _node(tree: Dict, path: Tuple[str, ...]):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            raise KeyError(f"checkpoint has no parameter {'/'.join(path)}")
        node = node[key]
    return node


def load_flax_params(model: nn.Module, params: Dict, strict: bool = True) -> None:
    """Copy a flax ``params`` tree into ``model``. Strict: every parameter
    of the model must be present with its shape, and leaves the model does
    not have are an error too, so a checkpoint of another configuration
    cannot load silently. Not strict: copy the leaves whose path and shape
    match and skip the rest (the JAX trainer's ``_merge_trees``)."""
    seen = set()
    with torch.no_grad():
        for path, p, transposed in _leaves(model):
            try:
                node = _node(params, path)
            except KeyError:
                if strict:
                    raise
                continue
            value = torch.from_numpy(np.array(node, copy=True))
            value = value.t() if transposed else value
            shard = getattr(p, "row_shard", None)
            if shard is not None and value.shape[0] == shard.n_rows:
                value = value[shard.rows]      # this rank's rows of the table
            if tuple(value.shape) != tuple(p.shape):
                if not strict:
                    continue
                raise ValueError(f"{'/'.join(path)}: checkpoint shape "
                                 f"{tuple(value.shape)} != model {tuple(p.shape)}")
            p.copy_(value.to(p.dtype))
            seen.add(path)
    extra = sorted("/".join(path) for path in _flat_paths(params)
                   if path not in seen)
    if extra and strict:
        raise KeyError(f"checkpoint parameters the model does not have: {extra}")


def loaded_mask(model: nn.Module, params: Dict) -> List[bool]:
    """Per parameter of ``model`` (``model.parameters()`` order): whether
    the flax tree ``params`` holds its path, as the JAX trainer marks the
    parameters a checkpoint loaded (trainer.py:547-552)."""
    paths = set(_flat_paths(params))
    flags = {id(p): path in paths for path, p, _ in _leaves(model)}
    return [flags[id(p)] for p in model.parameters()]


def _flat_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)
