"""The port's spans and counters, on the profiler's clock.

``span(name)`` opens a ``torch.profiler.record_function`` while a
``torch.profiler`` runs, and is a shared no-op context otherwise (one flag
read), so the port keeps its spans in the code that is timed. A span is a
profiler annotation: it lands in the same Chrome trace as the kernels and
the runtime calls, on the same clock, which is how an idle gap of the
device is put down to what the host was doing. The profiled windows are a
benchmark's traced window and ``main.run(profile=1)``; both get every span
with no switch of their own.

The spans, at the layer boundaries (one root a step or a request, the
others nested inside it):

- ``train.step`` (``Trainer.train_step``) over ``train.augment``
  (``DeviceAugmenter.augment``), ``train.forward`` (the model and its
  loss), ``train.backward`` (``torch.autograd.grad``), ``train.reduce``
  (``all_reduce_flat``) and ``train.update`` (``apply_update``), which holds
  ``optim.update`` (``Optimizer.update``: ``optim.moments``,
  ``optim.bias_correction``, ``optim.direction`` for the Adam kinds) and
  ``train.apply`` (the guarded parameter copies and the state select);
- ``serve.request`` (``get_topk_recommendations``) over ``serve.catalog``,
  then per batch ``serve.windows``, ``serve.history_gather``,
  ``serve.to_device``, ``serve.tower``, ``serve.topk`` (with
  ``fused_catalog_topk``'s ``topk.pass1`` and ``topk.pass2``), and
  ``serve.fetch``;
- ``data.to_device`` (every host batch's copies) and ``model.user_emb``
  (the tower), inside the functions a caller may wrap.

Counters are attributes of the function that does the work. The kernels'
``launches*`` count every launch (tests read them); the work counters,
``fused_catalog_topk.users``, ``.selected`` and ``.rows_rescored``, count
only while a profiler runs, so in a process whose one profiled stretch is
a traced window they are that window's. ``counters()`` reads them all.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or the autograd profiler) runs."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A profiler annotation ``name`` while a profiler runs, else a no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def _counted() -> Dict[str, object]:
    from unirec_tpu_torch.ops import attention as AT, ffn as FF, layer as LY, \
        member as MB, scatter_accum as SA, topk as TK
    return {"layer_fwd": LY.fused_transformer_layer, "layer_bwd": LY.layer_bwd,
            "lastq_fwd": LY.fused_last_query_layer, "lastq_bwd": LY.lastq_bwd,
            "fused_attention": AT.fused_attention,
            "fused_attention_bwd": AT.fused_attention_bwd,
            "flash_attention": AT.flash_attention, "fused_ffn": FF.fused_ffn,
            "fused_ffn_bwd": FF.fused_ffn_bwd, "scatter_add": SA.scatter_add_rows,
            "member": MB.member_mask, "blockmax": TK.catalog_blockmax,
            "topk": TK.fused_catalog_topk}


def _counter_attrs(fn):
    return [a for a in sorted(vars(fn)) if type(getattr(fn, a)) is int]


def counters() -> Dict[str, int]:
    """Every counter of the port: ``<kernel>`` and ``<kernel>_<body>`` for
    the launch counters (``launches``, ``launches_<body>``), and
    ``<name>_<attr>`` for the work counters (``topk_rows_rescored``)."""
    out = {}
    for name, fn in _counted().items():
        for attr in _counter_attrs(fn):
            key = attr[len("launches"):] if attr.startswith("launches") else "_" + attr
            out[name + key] = getattr(fn, attr)
    return out


def reset_counters() -> None:
    """Every counter of ``counters()`` back to 0."""
    for fn in _counted().values():
        for attr in _counter_attrs(fn):
            setattr(fn, attr, 0)
