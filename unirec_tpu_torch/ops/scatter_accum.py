"""Embedding-gradient scatter-add and the gather whose backward it is.

Counterpart of unirec_tpu/ops/scatter_accum.py. ``scatter_add_rows(ids, g,
n_rows)`` is sum_i onehot(ids[i]) * g[i] -> [n_rows, D] in g's dtype; on
CUDA tensors it launches csrc/scatter_add.cu (the TPU's ``_scatter_kernel``),
on CPU tensors its plain PyTorch version. ``scatter_add_rows2`` is the JAX
package's packed two-accumulator entry (``_scatter2_kernel``): the same
sum, so the same kernel. ``gather_vmem(table, ids)`` is ``table[ids]`` whose
backward is ``scatter_add_rows``; the models use it for the item-embedding
gathers under ``vmem_embedding_grad`` (models/base.py).

Accumulation: the TPU kernel sums in the table dtype (bf16 on the bench
path), sequentially. The kernel here and its plain version sum in f32 and
cast once at the end, so they are more exact than the TPU kernel; the
kernel adds with atomics, in an order that changes from run to run, so it
is not bit-reproducible (tolerances in the tests and in chip_smoke.py say
so). ``scatter_add_rows.launches`` counts kernel launches.

The kernel has two bodies (``_scatter_body`` picks one; the wrapper names it
to the C entry point, which refuses a sorted launch its own rule does not
admit): "sorted" sorts each tile of rows by id and sums every run of equal
ids in registers before one vector atomic per four columns, so padding and
hot ids cost a few reductions a tile (``scatter_add_rows.launches_sorted``
counts it); "per_row", one warp and one scalar atomic per element of every
row, takes what the sorted body does not.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from unirec_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SORTED_IDS = 2 ** 21 - 1   # csrc/scatter_add.cu::kMaxIds: an id and a tile row in 32 bits


def scatter_supported(n_rows: int, d: int, dtype) -> bool:
    """The port's gate in place of the TPU's VMEM budget
    (scatter_vmem_supported): the accumulator lives in device memory, so
    any float32/bfloat16 table whose [n_rows, d] offsets fit 32 bits."""
    return dtype in _DTYPES and n_rows * d < 2 ** 31


def _scatter_body(dtype, d: int, n_rows: int) -> str:
    """The body of csrc/scatter_add.cu that runs the call (its rule
    ``sorted_takes``): "sorted" for float32/bfloat16 rows of whole 4-column
    chunks into fewer than 2^21 table rows; else "per_row"."""
    ok = dtype in _DTYPES and d > 0 and d % 4 == 0 and 1 <= n_rows <= _MAX_SORTED_IDS
    return "sorted" if ok else "per_row"


def _scatter_plain(ids: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain version: f32 accumulation, one cast to g's dtype."""
    acc = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    keep = (ids >= 0) & (ids < n_rows)
    idx = torch.where(keep, ids, 0).long()[:, None].expand(-1, g.shape[1])
    acc.scatter_add_(0, idx, torch.where(keep[:, None], g.float(), 0.0))
    return acc.to(g.dtype)


@functools.cache
def _lib():
    fn = _build.library("scatter_add").unirec_scatter_add
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scatter_cuda(ids: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Launch csrc/scatter_add.cu, the body ``_scatter_body`` names, into a
    zeroed f32 accumulator, then cast."""
    if g.dtype not in _DTYPES or ids.device != g.device:
        raise TypeError(f"scatter_add takes float32/bfloat16 rows and ids on "
                        f"{g.device}, got {g.dtype} rows and ids on {ids.device}")
    if not scatter_supported(n_rows, g.shape[1], g.dtype):
        raise ValueError(f"scatter_add does not take [{n_rows}, {g.shape[1]}]")
    body = _scatter_body(g.dtype, g.shape[1], n_rows)
    ids = ids.to(torch.int32).contiguous()
    g = g.contiguous()
    if body == "sorted" and g.data_ptr() % 16:   # it reads rows in 8- or 16-byte chunks
        g = g.clone()
    acc = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    err = _lib()(_DTYPES[g.dtype], ids.data_ptr(), g.data_ptr(), acc.data_ptr(),
                 g.shape[0], g.shape[1], n_rows, int(body == "sorted"),
                 _build.stream_handle(g.device))
    _build.check(err, "scatter_add launch")
    scatter_add_rows.launches += 1
    scatter_add_rows.launches_sorted += body == "sorted"
    return acc.to(g.dtype)


def scatter_add_rows(ids: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """sum_i onehot(ids[i]) * g[i] -> [n_rows, D] in g's dtype.

    ids: [M] integer ids in [0, n_rows) (others add nothing); g: [M, D]."""
    if ids.shape != g.shape[:1] or g.dim() != 2:
        raise ValueError(f"ids [M] and g [M, D] expected, got {tuple(ids.shape)} "
                         f"and {tuple(g.shape)}")
    if g.is_cuda:
        return _scatter_cuda(ids, g, n_rows)
    if g.device.type == "cpu":
        return _scatter_plain(ids, g, n_rows)
    raise ValueError(f"no scatter_add kernel for device {g.device}")


scatter_add_rows.launches = 0
scatter_add_rows.launches_sorted = 0   # of those, the sorted-tile body's


def scatter_add_rows2(ids: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The JAX package's packed two-accumulator entry (n_rows even): the
    same sum as scatter_add_rows, through the same kernel."""
    if n_rows % 2:
        raise ValueError(f"scatter_add_rows2 needs an even n_rows, got {n_rows}")
    return scatter_add_rows(ids, g, n_rows)


class _GatherVmem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n, d = ctx.shape
        g_flat = g.reshape(-1, d).to(ctx.dtype)
        return scatter_add_rows(ids.reshape(-1), g_flat, n), None


def gather_vmem(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] whose backward is scatter_add_rows (gradient in the
    table's dtype, as the JAX package's _gather_vmem_bwd)."""
    return _GatherVmem.apply(table, ids)
