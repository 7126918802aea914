"""Base recommender modules (counterpart of unirec_tpu/models/base.py).

Conventions as in the JAX package: item/user id 0 is the padding id, and
embedding gathers are multiplied by ``ids != 0``, which also keeps row 0's
gradient at zero; ``batch`` is a dict of tensors. Parameters stay f32;
``compute_dtype`` (config ``compute_dtype``) is the dtype the towers compute
in. ``forward(batch, train, rng)`` is the training objective and returns
(scalar_loss, per_row_loss).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from unirec_tpu_torch.constants import DistanceType, LossType
from unirec_tpu_torch.models import modules
from unirec_tpu_torch.ops import losses as L
from unirec_tpu_torch.ops import scatter_accum as SA

# the JAX package's opt-in XLA gradient variants of the embedding gather
_GRAD_VARIANTS = ("scan_embedding_grad", "sorted_embedding_grad",
                  "expand_embedding_grad", "embedding_grad_f32")

_NOT_PORTED = {
    "use_features": "categorical item features",
    "use_text_emb": "frozen text embeddings",
    "time_seq": "time-sequence embeddings",
}


class BaseRecommender(nn.Module):
    is_seqrec = False

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        for key, what in _NOT_PORTED.items():
            if int(cfg.get(key) or 0):
                raise NotImplementedError(f"{key}: {what} are not ported yet "
                                          "(ROADMAP.md Queue 1)")
        if cfg.get("distance_type", "dot") == "mlp":
            raise NotImplementedError("distance_type=mlp is not ported yet "
                                      "(ROADMAP.md Queue 1)")
        for key in _GRAD_VARIANTS:
            if int(cfg.get(key) or 0) > (1 if key == "expand_embedding_grad" else 0):
                raise NotImplementedError(f"{key} is an opt-in XLA variant not "
                                          "ported yet (ROADMAP.md Queue 1 item 13)")
        if cfg.get("has_user_emb"):
            self.user_embedding = nn.Embedding(self.n_users, self.emb_dim)
        self.item_embedding = nn.Embedding(self.n_items, self.emb_dim)
        if cfg.get("has_user_bias"):
            self.user_bias = nn.Parameter(torch.zeros(self.n_users))
        if cfg.get("has_item_bias"):
            self.item_bias = nn.Parameter(torch.zeros(self.n_items))

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
        return self.item_embedding.weight.device

    # ------------------------------------------------------- initialization
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights as the JAX package initializes them
        (modules.make_initializer): Embedding tables and Linear kernels
        from the configured initializer, padding row 0 of the user/item
        tables zeroed, zero biases, LayerNorm scale 1 and bias 0, user and
        item bias terms normal(0.1)."""
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
                if isinstance(mod, nn.Linear):
                    mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
            for name in ("user_embedding", "item_embedding"):
                if hasattr(self, name):
                    getattr(self, name).weight[0].zero_()
            for name in ("user_bias", "item_bias"):
                if hasattr(self, name):
                    nn.init.normal_(getattr(self, name), 0.0, 0.1,
                                    generator=generator)

    # ------------------------------------------------------------- embeddings
    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _masked_gather(self, emb: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        mask = (ids != 0)[..., None]
        if torch.is_grad_enabled() and self.cfg.get("vmem_embedding_grad") \
                and not self.cfg.get("shard_embeddings"):
            # the table in the compute dtype, gathered; the backward runs
            # the scatter-add kernel (ops/scatter_accum.py). Row-sharded
            # tables keep the plain gather, as at models/base.py:177-178.
            # Without autograd no backward runs, and gathering before the
            # cast gives the same values without casting the whole table.
            table = self._cast(emb.weight)
            if SA.scatter_supported(*table.shape, table.dtype):
                return SA.gather_vmem(table, ids) * mask
        return self._cast(emb.weight[ids]) * mask

    def forward_item_emb(self, items: torch.Tensor) -> torch.Tensor:
        return self._masked_gather(self.item_embedding, items)

    def item_embedding_for_user(self, item_seq: torch.Tensor) -> torch.Tensor:
        """Sequence-side item encoding (recommender.py:136-147)."""
        return self._masked_gather(self.item_embedding, item_seq)

    def forward_user_emb(self, user_id=None, item_seq=None, item_seq_len=None,
                         train: bool = False, rng=None):
        return self._masked_gather(self.user_embedding, user_id)

    # ---------------------------------------------------------------- scoring
    def _predict_layer(self, user_emb, items_emb, user_id=None, item_id=None):
        """Scores (base.py:245-266): dot or cosine, bias terms, / tau, clip."""
        if self.cfg.get("distance_type", "dot") == DistanceType.COSINE.value:
            scores = modules.cosine_scores(user_emb, items_emb)
        else:
            scores = modules.inner_product_scores(user_emb, items_emb)
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
                                         self.forward_item_emb(all_ids),
                                         batch.get("user_id"), all_ids)
            return L.full_softmax_loss(scores, pos, weight)
        items_emb = self.forward_item_emb(batch["item_id"])
        user_emb = self._user_emb_from_batch(batch, train, rng)
        scores = self._predict_layer(user_emb, items_emb, batch.get("user_id"),
                                     batch["item_id"])
        label = batch.get("label")
        group = int(self.cfg.get("group_size", -1) or -1)
        if group > 0 and scores.dim() == 1:
            scores = scores.reshape(-1, group)
            label = label.reshape(-1, group) if label is not None else None
        return L.compute_loss(self.loss_type, scores, label, weight, self.cfg)

    # ------------------------------------------------------------ entrypoints
    def user_emb(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._user_emb_from_batch(batch)

    def item_emb(self, items: torch.Tensor) -> torch.Tensor:
        return self.forward_item_emb(items)

    def all_item_emb(self) -> torch.Tensor:
        """Full-catalog item encodings [n_items, D] (recommender.py:108-128)."""
        return self.forward_item_emb(torch.arange(self.n_items, device=self.device))

    def bias_terms(self):
        """(user_bias or None, item_bias or None) for full-catalog scoring."""
        return getattr(self, "user_bias", None), getattr(self, "item_bias", None)


class SeqRecBase(BaseRecommender):
    is_seqrec = True
