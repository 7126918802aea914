"""The opt-in gradient variants of the embedding gather.

Counterpart of unirec_tpu/ops/embedding.py, whose four custom-VJP gathers
are XLA programs (no Pallas), so they are plain torch ops here, each a
``torch.autograd.Function`` whose forward is the table's rows at ``ids``
and whose backward builds the table's gradient as its JAX counterpart
does, in the same accumulation dtype:

- ``gather_scan`` (config ``scan_embedding_grad``): the rows of the table
  cast to the compute dtype; the gradient's rows summed per id in f32 (the
  JAX package's sort + blocked-cumsum + boundary gathers, an f32
  accumulator), then cast to the table's dtype;
- ``gather_sorted`` (``sorted_embedding_grad``; JAX ``gather``): the rows of
  the table as it is; the gradient's rows cast to the table's dtype, sorted
  by id and summed in that dtype;
- ``gather_expand`` (``expand_embedding_grad`` = k > 1): the rows of the
  table as it is given (the caller casts it first); row i of the gradient
  summed into slot ``id * k + i % k`` of a [N * k, D] buffer, then the k
  slots of each id reduced, all in the table's (the compute) dtype;
- ``gather_cast`` (``embedding_grad_f32``): the rows of the table cast to the
  compute dtype; the gradient's rows summed per id in the table's dtype (f32
  parameters: f32 rows).

``models/base.py::_masked_gather`` chooses among them in the JAX package's
precedence (unirec_tpu/models/base.py:168-208). The scatter-add kernel of
``vmem_embedding_grad`` (row 6, ops/scatter_accum.py) is not one of them.
"""
from __future__ import annotations

from typing import Optional

import torch


def _flat(ids: torch.Tensor, g: torch.Tensor, d: int):
    return ids.reshape(-1).long(), g.reshape(-1, d)


class _GatherScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, compute_dtype):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        t = table if compute_dtype is None else table.to(compute_dtype)
        return t[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n, d = ctx.shape
        i, rows = _flat(ids, g, d)
        acc = torch.zeros((n, d), dtype=torch.float32, device=g.device)
        return acc.index_add_(0, i, rows.float()).to(ctx.dtype), None, None


class _GatherSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n, d = ctx.shape
        i, rows = _flat(ids, g, d)
        order = torch.argsort(i, stable=True)
        out = torch.zeros((n, d), dtype=ctx.dtype, device=g.device)
        return out.index_add_(0, i[order], rows.to(ctx.dtype)[order]), None


class _GatherExpand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, k):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype, ctx.k = table.shape, table.dtype, k
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        (n, d), k = ctx.shape, ctx.k
        i, rows = _flat(ids, g, d)
        slot = i * k + torch.arange(i.shape[0], device=i.device) % k
        wide = torch.zeros((n * k, d), dtype=ctx.dtype, device=g.device)
        wide.index_add_(0, slot, rows.to(ctx.dtype))
        return wide.view(n, k, d).sum(1, dtype=ctx.dtype), None, None


class _GatherCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, compute_dtype):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table.to(compute_dtype)[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n, d = ctx.shape
        i, rows = _flat(ids, g, d)
        out = torch.zeros((n, d), dtype=ctx.dtype, device=g.device)
        return out.index_add_(0, i, rows.to(ctx.dtype)), None, None


def gather_scan(table: torch.Tensor, ids: torch.Tensor,
                compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``table`` in ``compute_dtype`` (as it is when None) at ``ids``; the
    backward sums the gradient's rows per id in f32."""
    return _GatherScan.apply(table, ids, compute_dtype)


def gather_sorted(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table`` at ``ids``; the backward sums the gradient's rows sorted by
    id in the table's dtype."""
    return _GatherSorted.apply(table, ids)


def gather_expand(table: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """``table`` at ``ids``; the backward spreads the rows of one id over
    ``k`` slots, then reduces them, in the table's dtype."""
    return _GatherExpand.apply(table, ids, int(k))


def gather_cast(table: torch.Tensor, ids: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """``table`` in ``compute_dtype`` at ``ids``; the backward sums the
    gradient's rows in the table's dtype."""
    return _GatherCast.apply(table, ids, compute_dtype)
