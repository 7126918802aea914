"""Ranking models: FM, BST, AdaRanker.

Counterpart of unirec_tpu/models/rank.py (reference unirec/model/rank/*.py):
``forward_scores(batch, train, rng)`` gives pointwise [B] or grouped
[B, G] logits, and ``RankerBase.forward`` turns them into the loss. The
group comes from the data (T4 item and label groups, T7 rows folded by
``group_size``), not from negative sampling.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from unirec_tpu_torch.models import modules
from unirec_tpu_torch.models.base import BaseRecommender
from unirec_tpu_torch.ops import losses as L
from unirec_tpu_torch.utils.registry import register_model


class RankerBase(BaseRecommender):
    """Pointwise or groupwise scoring (ranker.py:9-37): scores of the given
    items, clipped at ``score_clip_value`` when it is positive, and for
    ``group_size`` > 0 flat scores and labels reshaped to [-1, group_size];
    no user and item towers."""

    def forward_scores(self, batch, train: bool = False, rng=None):
        raise NotImplementedError

    def _clip(self, scores):
        clip = float(self.cfg.get("score_clip_value", -1) or -1)
        return torch.clamp(scores, -clip, clip) if clip > 0 else scores

    def forward(self, batch, train: bool = True, rng=None):
        scores = self._clip(self.forward_scores(batch, train, rng))
        label, weight = batch.get("label"), batch.get("weight")
        if weight is None:
            weight = torch.ones(scores.shape[0], device=scores.device)
        group = int(self.cfg.get("group_size", -1) or -1)
        if group > 0 and scores.dim() == 1:
            scores = scores.reshape(-1, group)
            label = label.reshape(-1, group) if label is not None else None
        return L.compute_loss(self.loss_type, scores, label, weight, self.cfg)

    def predict(self, batch):
        return self._clip(self.forward_scores(batch))

    def forward_user_emb(self, *a, **k):
        raise NotImplementedError("rankers do not expose user embeddings")


@register_model("FM")
class FM(RankerBase):
    """Factorization machine over libFM rows (fm.py:73-152): the linear
    weights gathered at ``index_list`` times ``value_list`` plus a bias,
    and 0.5 (square of the sum - sum of the squares) of the value-scaled
    ``fm_embedding`` rows, masked where the index is 0. In f32, through
    plain indexing (an nn.Embed gather in JAX, no kernel there either).
    ``predict`` applies the sigmoid (fm.py:128-131)."""

    use_item_emb = False

    def __init__(self, cfg):
        super().__init__(cfg)
        n = int(cfg["n_feats"])
        self.fm_linear_weight = nn.Parameter(torch.zeros(n))
        self.fm_linear_bias = nn.Parameter(torch.zeros(1))
        self.fm_embedding = nn.Embedding(n, self.emb_dim)

    def jax_init(self, generator: torch.Generator) -> None:
        self.fm_linear_weight.zero_()
        self.fm_linear_bias.zero_()
        nn.init.normal_(self.fm_embedding.weight, 0.0, 0.01, generator=generator)
        self.fm_embedding.weight[0].zero_()

    def forward_scores(self, batch, train: bool = False, rng=None):
        index_list = batch["index_list"].long()
        value_list = batch["value_list"].float()
        grouped = index_list.dim() == 3
        if grouped:
            B, G, F_ = index_list.shape
            index_list, value_list = index_list.reshape(B * G, F_), value_list.reshape(B * G, F_)
        linear = (self.fm_linear_weight[index_list] * value_list).sum(-1) + self.fm_linear_bias[0]
        emb = self._lookup(self.fm_embedding, index_list) * (index_list != 0)[..., None]
        prod = emb * value_list[..., None]                         # [N, F, D]
        second = 0.5 * (prod.sum(1) ** 2 - (prod ** 2).sum(1)).sum(-1)
        scores = linear + second
        return scores.reshape(B, G) if grouped else scores

    def predict(self, batch):
        return torch.sigmoid(self._clip(self.forward_scores(batch)))


def load_xlearn_fm(path: str, n_feats: int, emb_dim: int):
    """An xlearn text FM model as an FM parameter tree in the flax layout
    (fm.py:133-152): line 0 the bias, the next n_feats lines the linear
    weights, the rest the embedding rows of width emb_dim."""
    with open(path) as f:
        lines = f.readlines()
    bias = float(lines[0].strip().split(": ")[1])
    weight = np.asarray([float(ln.strip().split(": ")[1]) for ln in lines[1:n_feats + 1]],
                        np.float32)
    emb = np.asarray([[float(v) for v in ln.strip().split(": ")[1].split()]
                      for ln in lines[n_feats + 1:]], np.float32)
    assert emb.shape == (n_feats, emb_dim), emb.shape
    return {"fm_linear_bias": np.asarray([bias], np.float32),
            "fm_linear_weight": weight,
            "fm_embedding": {"embedding": emb}}


def _transformer(c, hidden_size: int, dtype, eps: float, **extra):
    return modules.TransformerEncoder(
        n_layers=int(c.get("n_layers", 2)), n_heads=int(c.get("n_heads", 2)),
        hidden_size=hidden_size, inner_size=int(c.get("inner_size", 256)),
        hidden_act=c.get("hidden_act", "gelu"), layer_norm_eps=eps, dtype=dtype,
        use_flash=bool(c.get("use_pallas", True)),
        use_fused=bool(c.get("use_fused_attention", 0)),
        remat=bool(c.get("remat_attention", 0)), fused_ffn=bool(c.get("use_fused_ffn", 0)),
        hidden_dropout_prob=float(c.get("hidden_dropout_prob", 0.5)),
        attn_dropout_prob=float(c.get("attn_dropout_prob", 0.5)),
        bits8=_bits8(c), **extra)


def _bits8(c) -> bool:
    return int(c.get("dropout_bits", 32)) == 8


@register_model("BST")
class BST(RankerBase):
    """Behavior Sequence Transformer (bst.py:10-104): the candidate
    appended to the history, a position table of max_seq_len + 1 rows,
    LayerNorm, dropout, the bidirectional transformer under the key-padding
    mask, log-decay pooling over the max_seq_len + 1 positions divided by
    sqrt(len + 1), and ``output_dense1`` -> erf-gelu -> ``output_dense2``.
    Grouped candidates [B, G] broadcast the history over the group
    (bst.py:58-66). The encoder takes ``use_fused_attention`` and
    ``use_fused_ffn`` (rows 10-13 on the card)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        c = cfg
        self.eps = float(c.get("layer_norm_eps", 1e-10))
        self.position_embedding = nn.Embedding(int(c["max_seq_len"]) + 1, self.hidden_size)
        self.trm_encoder = _transformer(c, self.hidden_size, self.compute_dtype, self.eps)
        self.LayerNorm = nn.LayerNorm(self.hidden_size, eps=self.eps)
        self.output_dense1 = nn.Linear(self.hidden_size, self.hidden_size)
        self.output_dense2 = nn.Linear(self.hidden_size, 1)

    def forward_scores(self, batch, train: bool = False, rng=None):
        item_id, item_seq = batch["item_id"], batch["item_seq"]
        item_seq_len = batch["item_seq_len"]
        item_features = batch.get("item_features")
        item_seq_features = batch.get("item_seq_features")
        grouped = item_id.dim() == 2
        if grouped:
            B, G = item_id.shape
            Ls = item_seq.shape[1]
            item_id = item_id.reshape(-1)
            item_seq = item_seq[:, None, :].expand(B, G, Ls).reshape(-1, Ls)
            item_seq_len = item_seq_len[:, None].expand(B, G).reshape(-1)
            if item_features is not None:
                item_features = item_features.reshape(-1, item_features.shape[-1])
            if item_seq_features is not None:
                F_ = item_seq_features.shape[-1]
                item_seq_features = item_seq_features[:, None].expand(
                    B, G, Ls, F_).reshape(-1, Ls, F_)
        item_emb = self.forward_item_emb(item_id, item_features)
        seq_emb = self.item_embedding_for_user(item_seq, item_seq_features)
        x = torch.cat([seq_emb, item_emb[:, None, :]], dim=1)            # [N, L+1, D]
        new_seq = torch.cat([item_seq, item_id[:, None]], dim=1)
        x = x + self._cast(self._table(self.position_embedding)[:new_seq.shape[1]])[None]
        # flax LayerNorm(dtype=None): f32 out of f32 parameters
        x = modules.layer_norm(self.LayerNorm, x, None)
        x = modules.apply_dropout(x, float(self.cfg.get("hidden_dropout_prob", 0.5)), train,
                                  rng, _bits8(self.cfg))
        mask = modules.causal_attention_mask(new_seq, bidirectional=True)
        h = self.trm_encoder(x, mask, train, rng)
        L_full = int(self.cfg["max_seq_len"]) + 1
        decay = torch.logspace(float(self.cfg.get("seq_decay", -0.3)), 0.0, L_full,
                               device=h.device, dtype=torch.float32)
        nz = (item_seq_len[:, None] + 1).float()
        pooled = (h * decay[None, :, None]).sum(1) / torch.sqrt(nz)
        out = modules.dense(self.output_dense2, modules.ACT2FN["gelu"](
            modules.dense(self.output_dense1, pooled, None)), None)[..., 0]
        if self.cfg.get("has_item_bias"):
            out = out + self.item_bias[item_id]
        return out.reshape(B, G) if grouped else out


@register_model("AdaRanker")
class AdaRanker(RankerBase):
    """Distribution-adaptive ranker (adaranker.py:16-206, arXiv:2205.10775):
    a GRU (hidden 2D, ``dense`` to D, the last position) or SASRec (the
    last position of a post-LN encoder) backbone over the history; with
    ``train_type`` Ada-Ranker the history is FiLM-modulated by z, the
    candidates' NeuProcessEncoder vector (gamma and beta [B, 1, 1] from
    ``film_affine_emb_scale``/``_bias``), and the two-layer tanh head
    (``mlp_1``, ``mlp_2`` over [user, candidate]) takes MemoryUnit patches
    keyed on z; ``train_type`` Base runs the plain head. Every id gather is
    the masked one, so the item table's backward is the scatter-add kernel
    under ``vmem_embedding_grad``. Inits as the JAX package's: FiLM at the
    identity and patches at 1/0 unless ``ada_reference_init`` (the
    reference's torch-default and xavier inits)."""

    is_seqrec = True

    def __init__(self, cfg):
        super().__init__(cfg)
        c = cfg
        D = self.emb_dim
        self.base = c.get("base_model", "GRU")
        self.ada = c.get("train_type", "Ada-Ranker") == "Ada-Ranker"
        self.ref_init = bool(int(c.get("ada_reference_init", 0)))
        self.p = float(c.get("dropout_prob", 0.0))
        if self.base == "GRU":
            self.gru_layers = modules.RNN(D, 2 * D)
            self.dense = nn.Linear(2 * D, D)
        elif self.base == "SASRec":
            self.use_pos_emb = bool(c.get("use_position_emb", True))
            if self.use_pos_emb:
                self.position_embedding = nn.Embedding(int(c["max_seq_len"]), self.hidden_size)
            eps = float(c.get("layer_norm_eps", 1e-12))
            self.trm_encoder = _transformer(c, self.hidden_size, self.compute_dtype, eps,
                                            last_query_only=bool(c.get("last_query_only", 0)),
                                            head_stacked=bool(c.get("attn_head_stacked", 0)))
            self.LayerNorm = nn.LayerNorm(self.hidden_size, eps=eps)
        else:
            raise ValueError(f"unsupported AdaRanker base model: {self.base}")
        dnn_in, dnn_inner = 2 * D, D
        if self.ada:
            centers = dict.fromkeys(("mem_w1", "mem_b1", "mem_w2", "mem_b2"), "xavier") \
                if self.ref_init else {"mem_w1": "one", "mem_b1": "zero",
                                       "mem_w2": "one", "mem_b2": "zero"}
            self.extract_distribution_layer = modules.NeuProcessEncoder(
                D, D, D, self.p, reference_init=self.ref_init)
            self.film_affine_emb_scale = nn.Linear(D, 1)
            self.film_affine_emb_bias = nn.Linear(D, 1)
            for name, (n_in, n_out) in (("mem_w1", (dnn_in, dnn_inner)),
                                        ("mem_b1", (1, dnn_inner)),
                                        ("mem_w2", (dnn_inner, 1)), ("mem_b2", (1, 1))):
                self.add_module(name, modules.MemoryUnit(n_in, n_out, D,
                                                         init_center=centers[name]))
            self.mlp_1 = modules.AdaLinear(dnn_in, dnn_inner)
            self.mlp_2 = modules.AdaLinear(dnn_inner, 1)
        else:
            self.mlp_1 = nn.Linear(dnn_in, dnn_inner)
            self.mlp_2 = nn.Linear(dnn_inner, 1)

    def jax_init(self, generator: torch.Generator) -> None:
        """The kernels the JAX model draws from torch's Linear init (the
        GRU's ``dense``, FiLM, the Base head) and FiLM's biases (1 and 0,
        or torch's draw under ``ada_reference_init``)."""
        lins = [getattr(self, n) for n in ("dense", "film_affine_emb_scale",
                                           "film_affine_emb_bias") if hasattr(self, n)]
        if not self.ada:
            lins += [self.mlp_1, self.mlp_2]
        for lin in lins:
            modules.torch_linear_kernel_(lin, generator)
        if self.ada:
            scale, bias = self.film_affine_emb_scale.bias, self.film_affine_emb_bias.bias
            if self.ref_init:
                modules.torch_linear_(scale, generator, self.emb_dim)
                modules.torch_linear_(bias, generator, self.emb_dim)
            else:
                scale.fill_(1.0)

    def _encode_seq(self, item_seq, seq_emb, train: bool, rng):
        if self.base == "GRU":
            h = modules.apply_dropout(seq_emb, self.p, train, rng)
            return modules.dense(self.dense, self.gru_layers(h)[:, -1], None)
        x = seq_emb
        if self.use_pos_emb:
            x = x + self._cast(self._table(self.position_embedding)[:item_seq.shape[1]])[None]
        x = modules.layer_norm(self.LayerNorm, x, None)
        x = modules.apply_dropout(x, float(self.cfg.get("hidden_dropout_prob", 0.5)), train, rng,
                                  _bits8(self.cfg))
        # the causal triangle only with position embeddings (adaranker.py:104-121)
        mask = modules.causal_attention_mask(item_seq, bidirectional=not self.use_pos_emb)
        return self.trm_encoder(x, mask, train, rng)[:, -1, :]

    def forward_scores(self, batch, train: bool = False, rng=None):
        item_id = batch["item_id"]
        flat = item_id.dim() == 1
        if flat:
            item_id = item_id[:, None]
        cand_emb = self._masked_gather(self.item_embedding, item_id)          # [B, G, D]
        seq_emb = self._masked_gather(self.item_embedding, batch["item_seq"])
        if self.ada:
            z = self.extract_distribution_layer(cand_emb, train, rng)         # [B, D]
            gamma = modules.dense(self.film_affine_emb_scale, z, None)[:, None, :]
            beta = modules.dense(self.film_affine_emb_bias, z, None)[:, None, :]
            seq_emb = gamma * seq_emb + beta
        user = self._encode_seq(batch["item_seq"], seq_emb, train, rng)      # [B, D]
        dt = torch.promote_types(user.dtype, cand_emb.dtype)
        h = torch.cat([user[:, None, :].expand(cand_emb.shape).to(dt), cand_emb.to(dt)], -1)
        h = modules.apply_dropout(h, self.p, train, rng)
        if self.ada:
            h = torch.tanh(self.mlp_1(h, self.mem_w1(z), self.mem_b1(z)))
            h = self.mlp_2(h, self.mem_w2(z), self.mem_b2(z))
        else:
            h = modules.dense(self.mlp_2, torch.tanh(modules.dense(self.mlp_1, h, None)), None)
        scores = h[..., 0]                                                    # [B, G]
        return scores[:, 0] if flat else scores

