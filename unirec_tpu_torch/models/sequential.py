"""Sequential (history-conditioned) retrieval models.

Counterpart of unirec_tpu/models/sequential.py; SASRec is ported so far.
Models consume left-padded ``item_seq`` [B, L] (most recent item at
position L-1) and emit a user embedding [B, D].
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
        if int(c.get("qkv_packed", 0) or 0):
            raise NotImplementedError("qkv_packed changes the parameter tree "
                                      "and is not ported yet (ROADMAP.md "
                                      "Queue 1 item 13)")
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
            bits8=self.bits8)
        self.LayerNorm = nn.LayerNorm(self.hidden_size, eps=eps)

    @property
    def bits8(self) -> bool:
        return int(self.cfg.get("dropout_bits", 32)) == 8

    def encode_sequence(self, item_seq: torch.Tensor, train: bool = False,
                        rng=None) -> torch.Tensor:
        x = self.item_embedding_for_user(item_seq)
        if self.use_pos_emb:
            L = item_seq.shape[1]
            x = x + self._cast(self.position_embedding.weight[:L])[None]
        x = modules.layer_norm(self.LayerNorm, x, self.compute_dtype)
        x = modules.apply_dropout(x, float(self.cfg.get("hidden_dropout_prob", 0.5)),
                                  train, rng, self.bits8)
        mask = modules.causal_attention_mask(item_seq,
                                             bidirectional=not self.use_pos_emb)
        return self.trm_encoder(x, mask, train, rng)

    def forward_user_emb(self, user_id=None, item_seq=None, item_seq_len=None,
                         train: bool = False, rng=None):
        return self.encode_sequence(item_seq, train, rng)[:, -1, :]
