"""Sequential (history-conditioned) retrieval models.

Counterpart of unirec_tpu/models/sequential.py, the whole family: SASRec,
GRU, AvgHist, AttHist, SVDPlusPlus, ConvFormer and FASTConvFormer,
registered under the JAX names. Models consume left-padded ``item_seq``
[B, L] (most recent item at position L-1) and emit a user embedding [B, D].
Every id-table gather goes through ``_masked_gather``, so under
``vmem_embedding_grad`` each table's backward (AvgHist's and SVD++'s second
table too) is the scatter-add kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from unirec_tpu_torch.models import modules
from unirec_tpu_torch.models.base import SeqRecBase
from unirec_tpu_torch.utils.registry import register_model


@register_model("SASRec")
class SASRec(SeqRecBase):
    """Self-attentive sequential recommender (sasrec.py:10-77): item +
    position embedding -> LN -> dropout -> N post-LN transformer layers
    under the causal -10000 mask -> hidden state at the last position."""

    def __init__(self, cfg):
        super().__init__(cfg)
        c = cfg
        self.use_pos_emb = bool(c.get("use_position_emb", True))
        if self.use_pos_emb:
            # +1 slot for consistency with ranking models (sasrec.py:25)
            self.position_embedding = nn.Embedding(int(c["max_seq_len"]) + 1,
                                                   self.hidden_size)
        eps = float(c.get("layer_norm_eps", 1e-12))
        self.trm_encoder = modules.TransformerEncoder(
            n_layers=int(c.get("n_layers", 2)),
            n_heads=int(c.get("n_heads", 2)),
            hidden_size=self.hidden_size,
            inner_size=int(c.get("inner_size", 256)),
            hidden_act=c.get("hidden_act", "gelu"),
            layer_norm_eps=eps,
            dtype=self.compute_dtype,
            use_flash=bool(c.get("use_pallas", True)),
            use_fused=bool(c.get("use_fused_attention", 0)),
            remat=bool(c.get("remat_attention", 0)),
            head_stacked=bool(c.get("attn_head_stacked", 0)),
            last_query_only=bool(c.get("last_query_only", 0)),
            fused_ffn=bool(c.get("use_fused_ffn", 0)),
            fused_layer=bool(c.get("fused_layer", 0)),
            fused_causal=self.use_pos_emb,
            fused_lastq=bool(c.get("fused_lastq", 0)),
            hidden_dropout_prob=float(c.get("hidden_dropout_prob", 0.5)),
            attn_dropout_prob=float(c.get("attn_dropout_prob", 0.5)),
            bits8=self.bits8,
            qkv_packed=bool(c.get("qkv_packed", 0)))
        self.LayerNorm = nn.LayerNorm(self.hidden_size, eps=eps)

    @property
    def bits8(self) -> bool:
        return int(self.cfg.get("dropout_bits", 32)) == 8

    def encode_sequence(self, item_seq: torch.Tensor, item_seq_features=None,
                        time_seq=None, train: bool = False, rng=None) -> torch.Tensor:
        x = self.item_embedding_for_user(item_seq, item_seq_features, time_seq)
        if self.use_pos_emb:
            L = item_seq.shape[1]
            x = x + self._cast(self._table(self.position_embedding)[:L])[None]
        x = modules.layer_norm(self.LayerNorm, x, self.compute_dtype)
        x = modules.apply_dropout(x, float(self.cfg.get("hidden_dropout_prob", 0.5)),
                                  train, rng, self.bits8)
        mask = modules.causal_attention_mask(item_seq,
                                             bidirectional=not self.use_pos_emb)
        return self.trm_encoder(x, mask, train, rng)

    def forward_user_emb(self, user_id=None, item_seq=None, item_seq_len=None,
                         item_seq_features=None, time_seq=None, train: bool = False,
                         rng=None):
        return self.encode_sequence(item_seq, item_seq_features, time_seq,
                                    train, rng)[:, -1, :]


def _length_coeff(item_seq_len: torch.Tensor, alpha: float) -> torch.Tensor:
    """(len + 1) ** -alpha, [B, 1] f32."""
    return torch.pow((item_seq_len + 1).float(), -alpha)[:, None]


@register_model("GRU")
class GRU(SeqRecBase):
    """GRU4Rec-style encoder (gru.py:13-35): dropout on the item encodings,
    one GRU layer of ``hidden_size``, a dense layer back to the embedding
    width, the last position (the freshest item under left padding)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.gru_layers = modules.RNN(self.emb_dim, self.hidden_size)
        self.dense = nn.Linear(self.hidden_size, self.emb_dim)

    def forward_user_emb(self, user_id=None, item_seq=None, item_seq_len=None,
                         item_seq_features=None, time_seq=None, train: bool = False,
                         rng=None):
        x = self.item_embedding_for_user(item_seq, item_seq_features, time_seq)
        x = modules.apply_dropout(x, float(self.cfg.get("dropout_prob", 0.0)), train, rng)
        h = self.gru_layers(x)[:, -1]
        return modules.dense(self.dense, h, None)


@register_model("AvgHist")
class AvgHist(SeqRecBase):
    """(len + 1) ** -alpha scaled history sum (avghist.py:16-55); with
    ``asymmetric`` the history reads its own ``item_dst_embedding`` table."""

    def __init__(self, cfg):
        super().__init__(cfg)
        if cfg.get("asymmetric"):
            self.item_dst_embedding = nn.Embedding(self.n_items, self.emb_dim)
        self.alpha = float(cfg.get("user_sequence_alpha", 0.5))

    def item_embedding_for_user(self, item_seq, item_seq_features=None, time_seq=None):
        table = self.item_dst_embedding if self.cfg.get("asymmetric") else self.item_embedding
        return self._side_inputs(self._masked_gather(table, item_seq), item_seq,
                                 item_seq_features, time_seq)

    def forward_user_emb(self, user_id=None, item_seq=None, item_seq_len=None,
                         item_seq_features=None, time_seq=None, train: bool = False,
                         rng=None):
        e = self.item_embedding_for_user(item_seq, item_seq_features, time_seq)
        return _length_coeff(item_seq_len, self.alpha) * e.sum(1)


@register_model("AttHist")
class AttHist(SeqRecBase):
    """Learned attention pooling over the history (atthist.py:13-22)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.attention = modules.AttentionMergeLayer(self.emb_dim,
                                                     float(cfg.get("dropout_prob", 0.0)))

    def forward_user_emb(self, user_id=None, item_seq=None, item_seq_len=None,
                         item_seq_features=None, time_seq=None, train: bool = False,
                         rng=None):
        e = self.item_embedding_for_user(item_seq, item_seq_features, time_seq)
        return self.attention(e, train, rng)


@register_model("SVDPlusPlus")
class SVDPlusPlus(SeqRecBase):
    """The user's embedding plus the (len + 1) ** -alpha scaled sum of a
    separate ``item_dst_embedding`` table over the history
    (svdplusplus.py:17-39)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.item_dst_embedding = nn.Embedding(self.n_items, self.emb_dim)
        self.alpha = float(cfg.get("user_sequence_alpha", 0.5))

    def forward_user_emb(self, user_id=None, item_seq=None, item_seq_len=None,
                         item_seq_features=None, time_seq=None, train: bool = False,
                         rng=None):
        u = self._masked_gather(self.user_embedding, user_id)
        h = self._masked_gather(self.item_dst_embedding, item_seq)
        return u + _length_coeff(item_seq_len, self.alpha) * h.sum(1)


class _ConvFormerBase(SeqRecBase):
    """Item + position encodings (a table of ``max_seq_len`` rows) ->
    LayerNorm -> dropout -> n_layers of (token mixer, ConvFFN) -> the last
    position, or with ``seq_merge`` a log-decay weighted sum over the
    positions divided by sqrt(len + 1) (convformer.py:62-67). The mixers
    and FFNs compute in f32 (flax's promotion of the f32 LayerNorm)."""

    spectral = False

    def __init__(self, cfg):
        super().__init__(cfg)
        c = cfg
        eps = float(c.get("layer_norm_eps", 1e-9))
        p = float(c.get("hidden_dropout_prob", 0.5))
        self.position_embedding = nn.Embedding(int(c["max_seq_len"]), self.hidden_size)
        self.n_layers = int(c.get("n_layers", 2))
        for i in range(self.n_layers):
            if self.spectral:
                mixer = modules.SpectralConvLayer(int(c["conv_size"]), p, self.hidden_size,
                                                  eps, int(c["max_seq_len"]))
            else:
                mixer = modules.DepthwiseConvLayer(int(c["conv_size"]),
                                                   c.get("padding_mode", "circular"), p,
                                                   self.hidden_size, eps,
                                                   float(c.get("init_ratio", 5e-3)))
            self.add_module(f"mixer_{i}", mixer)
            self.add_module(f"ffn_{i}", modules.ConvFFN(
                self.hidden_size, int(c.get("inner_size", 256)), c.get("hidden_act", "gelu"),
                p, eps))
        self.LayerNorm = nn.LayerNorm(self.hidden_size, eps=eps)

    def forward_user_emb(self, user_id=None, item_seq=None, item_seq_len=None,
                         item_seq_features=None, time_seq=None, train: bool = False,
                         rng=None):
        c = self.cfg
        p = float(c.get("hidden_dropout_prob", 0.5))
        x = self.item_embedding_for_user(item_seq, item_seq_features, time_seq)
        x = x + self._cast(self._table(self.position_embedding)[:item_seq.shape[1]])[None]
        x = modules.apply_dropout(modules.layer_norm(self.LayerNorm, x, None), p, train, rng)
        for i in range(self.n_layers):
            x = getattr(self, f"mixer_{i}")(x, train, rng)
            x = getattr(self, f"ffn_{i}")(x, train, rng)
        if c.get("seq_merge"):
            L = int(c["max_seq_len"])
            decay = torch.logspace(float(c.get("seq_decay", -0.3)), 0.0, L,
                                   device=x.device, dtype=torch.float32)
            nz = (item_seq_len[:, None] + 1).float()
            return (x * decay[None, :, None]).sum(1) / torch.sqrt(nz)
        return x[:, -1, :]


@register_model("ConvFormer")
class ConvFormer(_ConvFormerBase):
    """Depthwise-convolution token mixer (arXiv:2308.02925; convformer.py)."""

    spectral = False


@register_model("FASTConvFormer")
class FASTConvFormer(_ConvFormerBase):
    """The same convolution as a pointwise product in the rfft domain
    (fastconvformer.py)."""

    spectral = True
