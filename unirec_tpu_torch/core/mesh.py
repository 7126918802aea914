"""The ('data', 'model') mesh (counterpart of unirec_tpu/core/mesh.py).

One abstraction from one card to many processes: a 2-D
``torch.distributed`` device mesh with dimensions ``data`` and ``model``.
Batches are split over ``data``; embedding tables may be row-sharded over
``model``. Where XLA inserts the collectives from the JAX package's
shardings, the port calls them itself: the trainer sums gradients over
``data`` (facility/trainer.py), a row-sharded table sums its lookups and
gathers its rows over ``model`` (models/base.py), and evaluation gathers
the per-row metrics over ``data`` (facility/evaluation/).

Without a process group the mesh is 1 x 1, its collectives are identities
and its rank owns every row, so one process runs the code of a many-rank
run. With a group, even of a single process, every collective runs.

Every rank holds the same global host batch, as every JAX process does
(tests/mp_worker.py:8-11); ``shard_batch`` pads it to a multiple of
``n_data`` (copies of the last row, ``weight`` 0 on them) and keeps this
rank's rows. Random draws of the device pipeline, of dropout and of
evaluation's tie noise are taken at the global batch's shape and then
sliced (``RowSlice``), so a rank's rows draw what they draw in a
one-process run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from unirec_tpu_torch.core.distributed import GROUP_TIMEOUT


def shard_rule(name: str, shape: Sequence[int], n_model: int, min_rows: int = 1024,
               shard_embeddings: bool = True) -> bool:
    """Whether a parameter is row-sharded over ``model``: the JAX package's
    ``MeshContext.param_shardings`` rule (mesh.py:74-102) on the
    parameter's flax path ``name`` ("item_embedding/embedding"): a 2-D
    parameter whose path contains "embedding", with at least ``min_rows``
    rows and a row count that ``n_model`` divides. Everything else is
    replicated."""
    return (bool(shard_embeddings) and n_model > 1 and len(shape) == 2
            and "embedding" in name.lower() and shape[0] >= min_rows
            and shape[0] % n_model == 0)


@dataclasses.dataclass(frozen=True)
class RowSlice:
    """A generator whose draws are taken at ``total`` rows and cut to rows
    [lo, lo + n): a rank's share of a draw over the global batch. A draw
    whose leading dim is m times ``n`` (a batch flattened with m entries a
    row, as BST's candidates) is taken at m * ``total`` rows and cut to
    [m * lo, m * (lo + n)); any other leading dim is not the batch's, so
    it is drawn as it is, the same on every rank."""
    generator: torch.Generator
    lo: int
    n: int
    total: int


def _draw_rows(draw, gen, shape) -> torch.Tensor:
    """``draw(shape, generator)`` for ``gen`` a generator or a RowSlice."""
    shape = tuple(shape)
    if not isinstance(gen, RowSlice):
        return draw(shape, gen)
    if gen.n == 0 or not shape or shape[0] % gen.n:
        return draw(shape, gen.generator)
    m = shape[0] // gen.n
    u = draw((m * gen.total, *shape[1:]), gen.generator)
    return u[m * gen.lo:m * (gen.lo + gen.n)]


def rand_rows(gen, shape, device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen``, a generator or a RowSlice."""
    return _draw_rows(lambda s, g: torch.rand(s, generator=g, device=device), gen, shape)


def randn_rows(gen, shape, device) -> torch.Tensor:
    """``torch.randn`` as ``rand_rows``."""
    return _draw_rows(lambda s, g: torch.randn(s, generator=g, device=device), gen, shape)


def randint_rows(gen, low: int, high: int, shape, device, dtype=torch.int64) -> torch.Tensor:
    """``torch.randint`` as ``rand_rows``."""
    return _draw_rows(lambda s, g: torch.randint(low, high, s, generator=g, device=device,
                                                 dtype=dtype), gen, shape)


# ---------------------------------------------------------------- collectives
def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group``'s ranks."""
    dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0, in rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class RowShard:
    """A table row-sharded over ``model``: this rank holds rows
    [offset, offset + n_local) of ``n_rows``. Set as ``row_shard`` on the
    parameter that holds them (``MeshContext.shard_params``)."""
    group: Any
    rank: int
    n_shards: int
    n_rows: int

    @property
    def n_local(self) -> int:
        return self.n_rows // self.n_shards

    @property
    def offset(self) -> int:
        return self.rank * self.n_local

    @property
    def rows(self) -> slice:
        return slice(self.offset, self.offset + self.n_local)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole table from every rank's rows (a collective)."""
        return all_gather_rows(local, self.group)


class MeshContext:
    """The mesh: its sizes, this rank's coordinates and groups, and the
    batch and parameter placement rules."""

    def __init__(self, n_data: int = 1, n_model: int = 1, device_mesh=None):
        self.n_data, self.n_model = int(n_data), int(n_model)
        self.device_mesh = device_mesh

    @property
    def n_devices(self) -> int:
        return self.n_data * self.n_model

    @property
    def distributed(self) -> bool:
        """A process group is up: the collectives run (at any size)."""
        return self.device_mesh is not None

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis) if self.distributed else 0

    def all_reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` in place over ``axis`` (``t`` itself without a group)."""
        return all_reduce_(t, self.group(axis)) if self.distributed else t

    def all_reduce_flat(self, ts: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """Each of ``ts`` summed over ``axis``, in one collective on their
        f32 concatenation (``ts`` themselves without a group)."""
        if not self.distributed:
            return list(ts)
        flat = all_reduce_(torch.cat([t.reshape(-1).float() for t in ts]), self.group(axis))
        return [part.view_as(t).to(t.dtype)
                for part, t in zip(flat.split([t.numel() for t in ts]), ts)]

    def all_gather_rows(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Every ``axis`` rank's ``t`` stacked along dim 0 (``t`` itself
        without a group)."""
        return all_gather_rows(t, self.group(axis)) if self.distributed else t

    def row_slice(self, gen, n_local: int, n_global: int) -> RowSlice:
        """``gen`` for this rank's ``n_local`` rows of a global batch of
        ``n_global``."""
        return RowSlice(gen, self.rank("data") * n_local, n_local, n_global)

    # ------------------------------------------------------------------ batches
    def padded_rows(self, n: int) -> int:
        return -(-n // self.n_data) * self.n_data

    def row_range(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows in a global batch of ``n`` rows
        padded to a multiple of ``n_data``."""
        per = self.padded_rows(n) // self.n_data
        lo = self.rank("data") * per
        return lo, lo + per

    def pad_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The global batch padded to a multiple of ``n_data`` rows with
        copies of its last row, ``weight`` 0 on them (mesh.py:47-68);
        scalars stay as they are."""
        out = {}
        for k, v in batch.items():
            a = np.asarray(v)
            pad = self.padded_rows(len(a)) - len(a) if a.ndim else 0
            if pad:
                filler = np.repeat(a[-1:], pad, axis=0)
                a = np.concatenate([a, np.zeros_like(filler) if k == "weight" else filler])
            out[k] = a if a.ndim else v
        return out

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of the padded global batch."""
        out = self.pad_batch(batch)
        n = next((len(np.asarray(v)) for v in out.values() if np.ndim(v)), 0)
        lo, hi = self.row_range(n)
        return {k: (np.asarray(v)[lo:hi] if np.ndim(v) else v) for k, v in out.items()}

    # --------------------------------------------------------------- parameters
    def param_shardings(self, shapes: Dict[str, Sequence[int]], min_rows: int = 1024,
                        shard_embeddings: bool = True) -> Dict[str, bool]:
        """{flax path: row-sharded over ``model``} for parameter shapes by
        flax path (``shard_rule``)."""
        return {name: shard_rule(name, shape, self.n_model, min_rows, shard_embeddings)
                for name, shape in shapes.items()}

    def shard_params(self, model, min_rows: int = 1024,
                     shard_embeddings: bool = True) -> Dict[str, bool]:
        """Keep this rank's rows of every table ``param_shardings`` shards
        (in place: the parameter objects stay) and mark each with its
        ``RowShard``; everything else stays replicated. Returns the rule's
        result by flax path."""
        from unirec_tpu_torch.utils.flax_bridge import named_flax_params
        named = named_flax_params(model)
        rule = self.param_shardings({k: tuple(p.shape) for k, p in named.items()},
                                    min_rows, shard_embeddings)
        for name, p in named.items():
            if rule[name] and getattr(p, "row_shard", None) is None:
                shard = RowShard(self.group("model"), self.rank("model"), self.n_model,
                                 p.shape[0])
                with torch.no_grad():
                    p.data = p.data[shard.rows].clone()
                p.row_shard = shard
        return rule

    def __repr__(self) -> str:
        return f"MeshContext(data={self.n_data}, model={self.n_model}, " \
               f"distributed={self.distributed})"


def _backend_override(device_type: str) -> Dict[str, Any]:
    """Each mesh group's backend with its timeout (GROUP_TIMEOUT): NCCL for
    CUDA tensors unless the default group is gloo alone, else gloo."""
    gloo = dist.get_backend() == "gloo" or device_type == "cpu"
    opts = (getattr(dist.ProcessGroupGloo, "_Options", None)
            or dist.ProcessGroupGloo.Options)() if gloo else dist.ProcessGroupNCCL.Options()
    opts._timeout = GROUP_TIMEOUT
    name = "gloo" if gloo else "nccl"
    return {"data": (name, opts), "model": (name, opts)}


def create_mesh(config: Optional[Dict[str, Any]] = None, data: int = -1, model: int = 1,
                device=None) -> MeshContext:
    """The ('data', 'model') mesh; ``data`` -1 takes the world size //
    ``model``, as in the JAX package (mesh.py:104). Without a process group
    the mesh is 1 x 1 and anything larger raises: one process drives one
    device, so a mesh of n needs n processes (torchrun --nproc_per_node n)."""
    if config is not None:
        data = int(config.get("mesh_data", data))
        model = int(config.get("mesh_model", model))
    model = max(model, 1)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data <= 0:
        data = max(world // model, 1)
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes, have "
                         f"{world} (launch with torchrun --nproc_per_node "
                         f"{data * model})")
    if not dist.is_initialized():
        return MeshContext(data, model)
    from torch.distributed.device_mesh import init_device_mesh
    device_type = torch.device("cuda" if device is None else device).type
    device_type = "cuda" if device_type == "cuda" else "cpu"
    mesh = init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"),
                            backend_override=_backend_override(device_type))
    return MeshContext(data, model, mesh)
