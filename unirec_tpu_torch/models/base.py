"""Base recommender modules (counterpart of unirec_tpu/models/base.py).

Conventions as in the JAX package: item/user id 0 is the padding id, and
embedding gathers are multiplied by ``ids != 0``, which also keeps row 0's
gradient at zero; ``batch`` is a dict of tensors. Parameters stay f32;
``compute_dtype`` (config ``compute_dtype``) is the dtype the towers compute
in. ``forward(batch, train, rng)`` is the training objective and returns
(scalar_loss, per_row_loss).

Item side inputs (unirec_tpu/models/base.py:112-150, 212-243): with
``use_features`` a ``features_embedding`` table of sum(features_shape) rows,
gathered at each item's categorical ids (the ``item2features`` constant, or
the batch's ``item_features`` / ``item_seq_features``) and summed over the
fields; with ``use_text_emb`` the frozen ``text_embedding`` constant
[n_items, text_emb_size] through ``text_dense1``, erf-gelu and
``text_dense2``; with ``time_seq`` > 0 a ``time_embedding`` of that many
buckets on the sequence side. ``distance_type=mlp`` scores through an
``MLPScorer``. The constants are buffers, not parameters: the optimizer
never sees them and checkpoints carry them under ``constants`` as the JAX
package does (``constants()``, ``load_constants``).

The embedding gathers' gradient paths under autograd follow the JAX
package's precedence (``_masked_gather``): ``scan_embedding_grad``, the
scatter-add kernel of ``vmem_embedding_grad`` (row 6), then
``sorted_embedding_grad``, ``expand_embedding_grad`` > 1 and
``embedding_grad_f32`` (ops/embedding.py, plain torch as XLA in JAX).
"""
from __future__ import annotations

import ast
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from unirec_tpu_torch.constants import DistanceType, LossType
from unirec_tpu_torch.models import modules
from unirec_tpu_torch.ops import embedding as E
from unirec_tpu_torch.ops import losses as L
from unirec_tpu_torch.ops import scatter_accum as SA
from unirec_tpu_torch.utils import tracing

# tables whose row 0 is the padding row, zeroed at initialization
_PADDED_TABLES = ("user_embedding", "item_embedding", "item_dst_embedding",
                  "features_embedding", "time_embedding")


class _ShardedLookup(torch.autograd.Function):
    """Rows ``ids`` of a table row-sharded over ``model`` (RowShard): each
    rank gathers the ids it owns, zero for the rest, in ``dtype``, and the
    ranks' rows are summed over ``model``. The backward is the identity
    through that sum: the gradient downstream is already the same on every
    model rank (an all-reduce there would multiply it by n_model). It
    scatters into the local rows through row 6 (ops/scatter_accum.py) with
    local ids, other ranks' rows at zero weight, in ``dtype`` as
    gather_vmem's. The JAX package leaves this scatter to XLA on a sharded
    table (unirec_tpu/models/base.py:177-183); row 6 computes exactly this
    function on a shard, so the port keeps it (ROADMAP.md, deliberate
    differences)."""

    @staticmethod
    def forward(ctx, shard_rows, ids, shard, dtype):
        local = ids.long() - shard.offset
        owned = (local >= 0) & (local < shard.n_local)
        local = torch.where(owned, local, 0)
        out = shard_rows[local].to(dtype) * owned[..., None]
        from unirec_tpu_torch.core.mesh import all_reduce_
        all_reduce_(out, shard.group)
        ctx.save_for_backward(local, owned)
        ctx.shard, ctx.dtype, ctx.rows_dtype = shard, dtype, shard_rows.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        local, owned = ctx.saved_tensors
        g = (g * owned[..., None]).reshape(-1, g.shape[-1]).to(ctx.dtype)
        grad = SA.scatter_add_rows(local.reshape(-1), g, ctx.shard.n_local)
        return grad.to(ctx.rows_dtype), None, None, None


class _ShardedFull(torch.autograd.Function):
    """The whole of a row-sharded table, gathered over ``model``; the
    backward keeps this rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, shard_rows, shard):
        ctx.shard = shard
        return shard.gather(shard_rows)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.shard.rows].contiguous(), None


def features_shape(cfg: Dict[str, Any]) -> list:
    """``features_shape`` as a list (checkpoint and CLI configs may hold
    its string form)."""
    shape = cfg.get("features_shape", [])
    return ast.literal_eval(shape) if isinstance(shape, str) else list(shape)


class BaseRecommender(nn.Module):
    is_seqrec = False
    # FM replaces the item table with a feature table (fm.py:84)
    use_item_emb = True

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        if cfg.get("has_user_emb"):
            self.user_embedding = nn.Embedding(self.n_users, self.emb_dim)
        if self.use_item_emb:
            self.item_embedding = nn.Embedding(self.n_items, self.emb_dim)
        if cfg.get("has_user_bias"):
            self.user_bias = nn.Parameter(torch.zeros(self.n_users))
        if cfg.get("has_item_bias"):
            self.item_bias = nn.Parameter(torch.zeros(self.n_items))
        if cfg.get("use_text_emb"):
            text = cfg.get("_text_emb")
            tdim = int(cfg.get("text_emb_size", 768))
            self.register_buffer("text_embedding", torch.zeros(self.n_items, tdim)
                                 if text is None else torch.as_tensor(
                                     np.asarray(text, np.float32)), persistent=False)
            self.text_dense1 = nn.Linear(self.text_embedding.shape[1], 2 * self.emb_dim)
            self.text_dense2 = nn.Linear(2 * self.emb_dim, self.emb_dim)
        if cfg.get("use_features"):
            feats, shape = cfg.get("_item2features"), features_shape(cfg)
            self.register_buffer("item2features", torch.zeros(
                self.n_items, max(len(shape), 1), dtype=torch.int32) if feats is None
                else torch.as_tensor(np.asarray(feats, np.int32)), persistent=False)
            self.features_embedding = nn.Embedding(int(sum(shape)) or 1, self.emb_dim)
        if int(cfg.get("time_seq", 0) or 0):
            self.time_embedding = nn.Embedding(int(cfg["time_seq"]), self.emb_dim)
        if cfg.get("distance_type", "dot") == DistanceType.MLP.value:
            self.mlp_scorer = modules.MLPScorer(self.emb_dim, self.emb_dim,
                                                float(cfg.get("dropout_prob", 0.0)),
                                                act_f="tanh")

    # ------------------------------------------------------------- properties
    @property
    def n_users(self) -> int:
        return int(self.cfg["n_users"])

    @property
    def n_items(self) -> int:
        return int(self.cfg["n_items"])

    @property
    def emb_dim(self) -> int:
        return int(self.cfg.get("embedding_size", 32))

    @property
    def hidden_size(self) -> int:
        return int(self.cfg.get("hidden_size", self.emb_dim) or self.emb_dim)

    @property
    def loss_type(self) -> str:
        return self.cfg.get("loss_type", "bce")

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.cfg.get("compute_dtype") == "bfloat16" \
            else None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # ------------------------------------------------------- initialization
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights as the JAX package initializes them
        (modules.make_initializer): Embedding tables and Linear kernels
        from the configured initializer, padding row 0 of the id tables
        zeroed, zero biases, LayerNorm scale 1 and bias 0, user and item
        bias terms normal(0.1); a module with its own JAX initializers (the
        GRU cell, the conv mixers, the attention pooling vector) draws them
        in its ``jax_init``. With ``use_pre_item_emb`` the item table
        is the pretrained rows main.run put under ``_pre_item_emb`` (row 0
        the padding item's zeros), as unirec_tpu/models/base.py:89-93 does."""
        method = self.cfg.get("init_method", "normal")
        mean = float(self.cfg.get("init_mean", 0.0))
        std = float(self.cfg.get("init_std", 0.02))

        def init(w):
            if method == "xavier_normal":
                nn.init.xavier_normal_(w, generator=generator)
            elif method == "xavier_uniform":
                nn.init.xavier_uniform_(w, generator=generator)
            else:
                nn.init.normal_(w, mean, std, generator=generator)

        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Embedding)):
                    init(mod.weight)
                if isinstance(mod, nn.Linear) and mod.bias is not None:
                    mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
            for mod in self.modules():
                if hasattr(mod, "jax_init"):
                    mod.jax_init(generator)
            for name in _PADDED_TABLES:
                if hasattr(self, name):
                    getattr(self, name).weight[0].zero_()
            for name in ("user_bias", "item_bias"):
                if hasattr(self, name):
                    nn.init.normal_(getattr(self, name), 0.0, 0.1,
                                    generator=generator)
            pre_item = self.cfg.get("_pre_item_emb")
            if self.cfg.get("use_pre_item_emb") and pre_item is not None:
                w = self.item_embedding.weight
                w.copy_(torch.as_tensor(pre_item, dtype=w.dtype).reshape(w.shape))

    # ------------------------------------------------------------- embeddings
    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _gather(self, weight: torch.Tensor, ids: torch.Tensor, cast: bool = True) -> torch.Tensor:
        """``weight``'s rows at ``ids``, in the compute dtype unless not
        ``cast``; a row-sharded table (``row_shard``) through
        ``_ShardedLookup``."""
        cast_fn = self._cast if cast else (lambda t: t)
        shard = getattr(weight, "row_shard", None)
        if shard is not None:
            dtype = self.compute_dtype if cast and self.compute_dtype else weight.dtype
            return _ShardedLookup.apply(weight, ids, shard, dtype)
        if torch.is_grad_enabled() and self.cfg.get("vmem_embedding_grad") \
                and not self.cfg.get("shard_embeddings"):
            # the table in the compute dtype, gathered; the backward runs
            # the scatter-add kernel (ops/scatter_accum.py). Tables that
            # shard_embeddings leaves whole keep the plain gather, as at
            # models/base.py:177-178. Without autograd no backward runs, and
            # gathering before the cast gives the same values without
            # casting the whole table.
            table = cast_fn(weight)
            if SA.scatter_supported(*table.shape, table.dtype):
                return SA.gather_vmem(table, ids)
        return cast_fn(weight[ids])

    def _masked_gather(self, emb: nn.Embedding, ids: torch.Tensor,
                       all_rows: bool = False) -> torch.Tensor:
        """Rows ``ids`` with the padding id's zeroed; ``all_rows``: ``ids``
        is the whole table's arange, which a row-sharded table serves by
        gathering its rows (``_ShardedFull``). Under autograd a whole table
        takes the first gradient path of the JAX package's precedence
        (unirec_tpu/models/base.py:168-208) that its config turns on:
        ``scan_embedding_grad``, then the scatter-add kernel of
        ``vmem_embedding_grad`` unless ``shard_embeddings``, then
        ``sorted_embedding_grad``, ``expand_embedding_grad`` > 1 and
        ``embedding_grad_f32`` (ops/embedding.py), else autograd's own. A
        row-sharded table always takes its sharded lookup, whose backward
        is row 6 on the shard."""
        shard = getattr(emb.weight, "row_shard", None)
        mask = (ids != 0)[..., None]
        if all_rows and shard is not None:
            rows = _ShardedFull.apply(self._cast(emb.weight), shard)
            return rows * mask
        if shard is None and torch.is_grad_enabled():
            rows = self._variant_gather(emb.weight, ids, mask)
            if rows is not None:
                return rows
        return self._gather(emb.weight, ids) * mask

    def _variant_gather(self, weight: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor):
        """The masked rows through the first opt-in gradient path the config
        turns on before autograd's own (``_masked_gather``), or None; the
        masks and casts sit where the JAX package puts them."""
        c, dt = self.cfg, self.compute_dtype
        if c.get("scan_embedding_grad"):
            return E.gather_scan(weight, ids, dt) * mask
        if c.get("vmem_embedding_grad") and not c.get("shard_embeddings") \
                and SA.scatter_supported(*weight.shape, dt or weight.dtype):
            return None                 # _gather's scatter-add kernel
        if c.get("sorted_embedding_grad"):
            return self._cast(E.gather_sorted(weight, ids) * mask)
        k = int(c.get("expand_embedding_grad", 0) or 0)
        if k > 1:
            return E.gather_expand(self._cast(weight), ids, k) * mask
        if c.get("embedding_grad_f32") and dt is not None:
            return E.gather_cast(weight, ids, dt) * mask
        return None

    def _table(self, emb: nn.Embedding) -> torch.Tensor:
        """The whole table (its rows gathered when row-sharded), for the
        tables read by slice (position embeddings)."""
        shard = getattr(emb.weight, "row_shard", None)
        return emb.weight if shard is None else _ShardedFull.apply(emb.weight, shard)

    def _lookup(self, emb: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        """Plain ``emb.weight[ids]`` (no kernel, no cast), row-sharded
        tables through ``_ShardedLookup``."""
        shard = getattr(emb.weight, "row_shard", None)
        if shard is None:
            return emb.weight[ids]
        return _ShardedLookup.apply(emb.weight, ids, shard, emb.weight.dtype)

    def _text_emb(self, items: torch.Tensor) -> torch.Tensor:
        """The frozen text rows of ``items`` (zero for the padding id)
        through text_dense1, erf-gelu and text_dense2, in the promoted dtype
        (f32), then cast to the compute dtype. text_dense1's product is
        linear, so it runs once over the table and its rows are gathered:
        the values of dense1 on each gathered row, without writing
        text_emb_size floats for every occurrence of an item. Its backward
        is the scatter kernel too: the padding id takes most of a history
        window's rows."""
        d1 = self.text_dense1
        proj = torch.nn.functional.linear(self.text_embedding, d1.weight)
        h = self._gather(proj, items, cast=False) * (items != 0)[..., None] + d1.bias
        return self._cast(modules.dense(self.text_dense2, modules.ACT2FN["gelu"](h), None))

    def _features_emb(self, feats: torch.Tensor) -> torch.Tensor:
        """Sum over the fields of the feature rows: an unmasked gather, as
        the JAX model's nn.Embed (the padding row is zero at init), whose
        backward is the scatter kernel too; a few dozen rows take every
        occurrence, which the kernel's sorted runs sum in registers."""
        return self._gather(self.features_embedding.weight, feats).sum(-2)

    def forward_item_emb(self, items: torch.Tensor,
                         item_features: Optional[torch.Tensor] = None,
                         all_rows: bool = False) -> torch.Tensor:
        e = self._masked_gather(self.item_embedding, items, all_rows)
        if self.cfg.get("use_features") and item_features is not None:
            e = e + self._features_emb(item_features)
        if self.cfg.get("use_text_emb"):
            e = e + self._text_emb(items)
        return e

    def item_embedding_for_user(self, item_seq: torch.Tensor, item_seq_features=None,
                                time_seq=None) -> torch.Tensor:
        """Sequence-side item encoding (recommender.py:136-147)."""
        return self._side_inputs(self._masked_gather(self.item_embedding, item_seq),
                                 item_seq, item_seq_features, time_seq)

    def _side_inputs(self, e, item_seq, item_seq_features=None, time_seq=None):
        """``e`` plus the sequence's features, time buckets and text."""
        if self.cfg.get("use_features") and item_seq_features is not None:
            e = e + self._features_emb(item_seq_features)
        if int(self.cfg.get("time_seq", 0) or 0) and time_seq is not None:
            e = e + self._masked_gather(self.time_embedding, time_seq)
        if self.cfg.get("use_text_emb"):
            e = e + self._text_emb(item_seq)
        return e

    def forward_user_emb(self, user_id=None, item_seq=None, item_seq_len=None,
                         item_seq_features=None, time_seq=None, train: bool = False,
                         rng=None):
        return self._masked_gather(self.user_embedding, user_id)

    # ---------------------------------------------------------------- scoring
    def _predict_layer(self, user_emb, items_emb, user_id=None, item_id=None,
                       train: bool = False, rng=None):
        """Scores (base.py:245-266): dot, cosine or the MLP scorer, bias
        terms, / tau, clip."""
        dist = self.cfg.get("distance_type", "dot")
        if dist == DistanceType.DOT.value:
            scores = modules.inner_product_scores(user_emb, items_emb)
        elif dist == DistanceType.COSINE.value:
            scores = modules.cosine_scores(user_emb, items_emb)
        else:
            scores = self.mlp_scorer(user_emb, items_emb, train, rng)
        if self.cfg.get("has_user_bias") and user_id is not None:
            ub = self.user_bias[user_id]
            scores = scores + (ub[..., None] if scores.dim() > ub.dim() else ub)
        if self.cfg.get("has_item_bias") and item_id is not None:
            scores = scores + self.item_bias[item_id]
        scores = scores / float(self.cfg.get("tau", 1.0))
        clip = float(self.cfg.get("score_clip_value", -1) or -1)
        return torch.clamp(scores, -clip, clip) if clip > 0 else scores

    def _user_emb_from_batch(self, batch, train: bool = False, rng=None):
        return self.forward_user_emb(user_id=batch.get("user_id"),
                                     item_seq=batch.get("item_seq"),
                                     item_seq_len=batch.get("item_seq_len"),
                                     item_seq_features=batch.get("item_seq_features"),
                                     time_seq=batch.get("time_seq"),
                                     train=train, rng=rng)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = True,
                rng: Optional[modules.DropoutRNG] = None):
        """Training objective (base.py:276-303) -> (scalar_loss, per_row)."""
        weight = batch.get("weight")
        if weight is None:
            weight = torch.ones(batch["item_id"].shape[0], device=self.device)
        if self.loss_type == LossType.FULLSOFTMAX.value:
            pos = batch["item_id"]
            pos = pos[:, 0] if pos.dim() == 2 else pos
            all_ids = torch.arange(self.n_items, device=self.device)
            scores = self._predict_layer(self._user_emb_from_batch(batch, train, rng),
                                         self.all_item_emb(), batch.get("user_id"),
                                         all_ids, train, rng)
            return L.full_softmax_loss(scores, pos, weight)
        items_emb = self.forward_item_emb(batch["item_id"], batch.get("item_features"))
        user_emb = self._user_emb_from_batch(batch, train, rng)
        scores = self._predict_layer(user_emb, items_emb, batch.get("user_id"),
                                     batch["item_id"], train, rng)
        label = batch.get("label")
        group = int(self.cfg.get("group_size", -1) or -1)
        if group > 0 and scores.dim() == 1:
            scores = scores.reshape(-1, group)
            label = label.reshape(-1, group) if label is not None else None
        return L.compute_loss(self.loss_type, scores, label, weight, self.cfg)

    # ------------------------------------------------------------ entrypoints
    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Eval-mode scores of the batch's (user, item(s)) rows
        (recommender.py:99-106)."""
        return self._predict_layer(self._user_emb_from_batch(batch),
                                   self.forward_item_emb(batch["item_id"],
                                                         batch.get("item_features")),
                                   batch.get("user_id"), batch["item_id"])

    def user_emb(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with tracing.span("model.user_emb"):
            return self._user_emb_from_batch(batch)

    def item_emb(self, items: torch.Tensor,
                 item_features: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_item_emb(items, item_features)

    def all_item_emb(self) -> torch.Tensor:
        """Full-catalog item encodings [n_items, D] (recommender.py:108-128),
        the features from the ``item2features`` constant."""
        feats = self.item2features if self.cfg.get("use_features") else None
        return self.forward_item_emb(torch.arange(self.n_items, device=self.device), feats,
                                     all_rows=True)

    # -------------------------------------------------------------- constants
    def constants(self) -> Optional[Dict[str, np.ndarray]]:
        """The frozen inputs in the JAX package's 'constants' collection
        layout ({"item2features": int32, "text_embedding": f32}), or None."""
        out = {name: getattr(self, name).cpu().numpy()
               for name in ("item2features", "text_embedding") if hasattr(self, name)}
        return out or None

    def load_constants(self, constants: Optional[Dict[str, Any]]) -> None:
        """Copy a checkpoint's constants into the model's buffers (the
        model keeps its own where the checkpoint has none)."""
        if not isinstance(constants, dict):
            return
        for name, value in constants.items():
            if hasattr(self, name):
                buf = getattr(self, name)
                setattr(self, name, torch.as_tensor(np.asarray(value)).to(buf.device, buf.dtype))

    def bias_terms(self):
        """(user_bias or None, item_bias or None) for full-catalog scoring."""
        return getattr(self, "user_bias", None), getattr(self, "item_bias", None)


class SeqRecBase(BaseRecommender):
    is_seqrec = True
