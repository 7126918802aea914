"""Checkpoint pickles shared with the JAX package.

Counterpart of unirec_tpu/utils/checkpoint.py. A checkpoint is a pickled
dict {config, params, constants, ...}: ``config`` a plain dict, ``params``
the flax parameter tree as nested dicts of numpy arrays and ``constants``
the frozen item inputs ({"item2features", "text_embedding"} as numpy, or
None), the JAX package's 'constants' collection. The JAX trainer also stores
its optax ``opt_state``, whose pickle names optax classes; the loader maps
every global of the ``jax``, ``flax`` and ``optax`` packages to an inert
stub, so a checkpoint loads without them and serving reads only ``config``
and ``params``. The port's trainer stores its own ``opt_state`` as numpy
(``opt_state_to_numpy``): scalars as 0-d arrays and every per-parameter
list as a flax-layout tree, so the file holds no class of either
framework. Only load checkpoints that this project wrote: unpickling runs
code named by the file.

Under a process group the pickle is written by rank 0 alone, behind a
barrier (unirec_tpu/utils/checkpoint.py:25-36); its sharded tables were
gathered to every rank first, so the file is the one-process format that
the JAX package and a one-process port read unchanged.
``checkpoint_backend=orbax`` is the JAX package's sharded multi-host
checkpoint (:72-120); the port writes a ``torch.distributed.checkpoint``
directory ``<file>.dcp/`` in its place: every parameter under
``params/<flax path>`` in flax layout, a row-sharded table as a
``DTensor(Shard(0))`` over the ``model`` mesh (each rank writes its own
rows), its optimizer moments alike under ``opt_state/<name>/<flax path>``,
and in ``side.pkl``, which rank 0 writes, the config, the scalars and the
replicated optimizer state. ``load_checkpoint`` reads it back whole in any
process, at any mesh. A JAX ``.orbax`` directory (OCDBT/tensorstore, which
the card's machine lacks) is refused by name: convert it with the JAX
package's ``load_checkpoint`` then ``save_checkpoint`` (pickle), which the
port reads (ROADMAP.md, deliberate differences).
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


DCP_SUFFIX = ".dcp"


def checkpoint_exists(path: str) -> bool:
    """A pickle at ``path`` or a ``<path>.dcp`` directory."""
    return os.path.exists(path) or os.path.isdir(_dcp_dir(path))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A pickle, or a ``.dcp`` directory (``path`` itself or ``path`` +
    ".dcp"), as the pickle's dict; a JAX ``.orbax`` directory raises."""
    for orbax in (path, path + ".orbax"):
        if os.path.isdir(orbax) and orbax.rstrip("/").endswith(".orbax"):
            raise ValueError(
                f"{orbax} is a JAX orbax checkpoint (OCDBT/tensorstore), which the "
                "port does not read: convert it with the JAX package's "
                "unirec_tpu.utils.checkpoint.load_checkpoint and save_checkpoint "
                "(the pickle backend), which the port reads")
    if os.path.isdir(_dcp_dir(path)):
        return _load_dcp(_dcp_dir(path))
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def _dcp_dir(path: str) -> str:
    return path if path.rstrip("/").endswith(DCP_SUFFIX) else path + DCP_SUFFIX


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` in the JAX package's pickle layout: arrays as numpy,
    config without its private ``_`` keys; written to a temporary file and
    renamed, so a reader never sees half a checkpoint. Under a process
    group rank 0 writes and every rank waits for it."""
    from unirec_tpu_torch.core.distributed import barrier, is_main_process
    if is_main_process():
        _write_pickle(path, state)
    barrier()


def _write_pickle(path: str, state: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = dict(state)
    for key in ("params", "constants", "opt_state"):
        if payload.get(key) is not None:
            payload[key] = _to_numpy(payload[key])
    if payload.get("config") is not None:
        payload["config"] = {k: v for k, v in payload["config"].items()
                             if not k.startswith("_")}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def save_checkpoint_dcp(path: str, state: Dict[str, Any], model,
                        opt_state: Dict[str, Any], mesh) -> str:
    """Write the ``.dcp`` directory of ``path`` (module docstring): ``state``
    (config, counters, constants) into side.pkl with the replicated
    optimizer state, the parameters and the sharded moments through
    torch.distributed.checkpoint. A collective under a process group.
    Returns the directory."""
    import shutil

    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor, Shard

    from unirec_tpu_torch.core.distributed import barrier, is_main_process
    from unirec_tpu_torch.utils.flax_bridge import _leaves
    out = _dcp_dir(os.path.abspath(path))
    if is_main_process():
        if os.path.exists(out):
            shutil.rmtree(out)
        os.makedirs(out)
    barrier()
    index = {id(p): i for i, p in enumerate(model.parameters())}
    tensors: Dict[str, torch.Tensor] = {}
    side_opt = {k: v.detach().cpu().numpy() for k, v in opt_state.items()
                if not isinstance(v, list)}

    def put(key, value, p, transposed):
        if getattr(p, "row_shard", None) is not None:
            tensors[key] = DTensor.from_local(value.detach().contiguous(),
                                              mesh.device_mesh["model"], [Shard(0)],
                                              run_check=False)
        else:
            tensors[key] = (value.t() if transposed else value).detach().contiguous()

    for path_, p, transposed in _leaves(model):
        name = "/".join(path_)
        put(f"params/{name}", p, p, transposed)
        for k, v in opt_state.items():
            if not isinstance(v, list):
                continue
            value = v[index[id(p)]]
            if getattr(p, "row_shard", None) is not None:
                put(f"opt_state/{k}/{name}", value, p, transposed)
            else:
                node = side_opt.setdefault(k, {})
                for key in path_[:-1]:
                    node = node.setdefault(key, {})
                node[path_[-1]] = (value.t() if transposed else value).detach().cpu().numpy()
    dcp.save(tensors, checkpoint_id=out, no_dist=not mesh.distributed)
    if is_main_process():
        side = dict(state, opt_state=side_opt)
        if side.get("constants") is not None:
            side["constants"] = _to_numpy(side["constants"])
        if side.get("config") is not None:
            side["config"] = {k: v for k, v in side["config"].items() if not k.startswith("_")}
        _write_pickle(os.path.join(out, "side.pkl"), side)
    barrier()
    return out


def _load_dcp(path: str) -> Dict[str, Any]:
    """A ``.dcp`` directory as the pickle's dict, every tensor whole (read
    by this process alone: any mesh, or none)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    with open(os.path.join(path, "side.pkl"), "rb") as f:
        state = _CheckpointUnpickler(f).load()
    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata().state_dict_metadata
    tensors = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
               for k, m in meta.items() if isinstance(m, TensorStorageMetadata)}
    dcp.load(tensors, storage_reader=reader, no_dist=True)
    params: Dict[str, Any] = {}
    opt = dict(state.get("opt_state") or {})
    for key, value in tensors.items():
        kind, rest = key.split("/", 1)
        if kind == "params":
            node, parts = params, rest.split("/")
        else:
            name, tail = rest.split("/", 1)
            node, parts = opt.setdefault(name, {}), tail.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.numpy()
    state["params"] = params
    state["opt_state"] = opt
    return state


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
    bridge, and its constants. Returns (model on ``device`` in eval mode,
    config)."""
    from unirec_tpu_torch.utils import resolve_device
    from unirec_tpu_torch.utils.flax_bridge import load_flax_params
    from unirec_tpu_torch.utils.registry import get_model_class

    dev = resolve_device(device)
    ckpt = load_checkpoint(path)
    cfg = ckpt["config"]
    model = get_model_class(cfg["model"])(cfg)
    load_flax_params(model, ckpt["params"])
    model.load_constants(ckpt.get("constants"))
    return model.to(dev).eval(), cfg
