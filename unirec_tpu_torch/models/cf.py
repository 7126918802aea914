"""Collaborative-filtering retrieval models trained by SGD: MF, MultiVAE.

Counterpart of unirec_tpu/models/cf.py. The closed-form solver models
(EASE, SLIM, AdmmSLIM, SAR, UserCF) are in models/solvers.py.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from unirec_tpu_torch.core.mesh import RowSlice, randn_rows
from unirec_tpu_torch.models.base import BaseRecommender
from unirec_tpu_torch.models.modules import apply_dropout, dense
from unirec_tpu_torch.ops import losses as L
from unirec_tpu_torch.utils.registry import register_model


@register_model("MF")
class MF(BaseRecommender):
    """Matrix factorization: user embedding . item embedding (mf.py:6-11)."""


@register_model("MultiVAE")
class MultiVAE(BaseRecommender):
    """Variational autoencoder for implicit CF (multivae.py:9-120).

    The encoder reads the history's item encodings summed and scaled by
    1/sqrt(nnz), then tanh, the ``encoder_<i>`` denses (tanh between them)
    to [mu, logvar]; the decoder maps z through the ``decoder_<i>`` denses
    to a user embedding. The loss is the multinomial softmax over the
    whole catalog at the history's items plus the KL term times the
    batch's ``anneal`` (the trainer's schedule, ``kl_anneal``), else
    ``anneal_cap``. The catalog's encodings come from the masked gather of
    every id, so under ``vmem_embedding_grad`` their backward is the
    scatter-add kernel; the [B, n_items] product and its logsumexp are
    torch ops, as XLA ops in JAX.

    Noise: in training z = mu + eps exp(logvar / 2), eps from the step's
    dropout generator. In evaluation, with ``eval_reparameter_sampling_times``
    = S > 0, eps is the mean of S normals drawn from a generator seeded by
    (seed, the batch's ``reparam_seed``), which the evaluators set to a
    fresh counter each batch (cf.py:84-103): every evaluation draws fresh,
    seeded noise, as the reference's global torch RNG does; the streams are
    not JAX's. S = 0 takes z = mu. A data-parallel rank draws both at the
    global batch's shape and keeps its rows (core/mesh.py::RowSlice).
    """

    is_seqrec = True

    def __init__(self, cfg):
        super().__init__(cfg)
        enc_dims = list(cfg.get("encoder_dims", [200]))
        dec_dims = list(cfg.get("decoder_dims", [200]))
        enc_sizes = enc_dims[:-1] + [enc_dims[-1] * 2]
        dec_sizes = dec_dims + [self.emb_dim]
        self.n_enc, self.n_dec = len(enc_sizes), len(dec_sizes)
        for i, (a, b) in enumerate(zip([self.emb_dim] + enc_sizes, enc_sizes)):
            self.add_module(f"encoder_{i}", nn.Linear(a, b))
        for i, (a, b) in enumerate(zip([enc_dims[-1]] + dec_sizes, dec_sizes)):
            self.add_module(f"decoder_{i}", nn.Linear(a, b))

    def _mlp(self, prefix: str, n: int, h: torch.Tensor) -> torch.Tensor:
        for i in range(n):
            h = dense(getattr(self, f"{prefix}_{i}"), h, None)
            if i != n - 1:
                h = torch.tanh(h)
        return h

    def _encode(self, item_seq, item_seq_features, time_seq, train: bool, rng=None):
        e = self.item_embedding_for_user(item_seq, item_seq_features, time_seq)
        nnz = (item_seq != 0).sum(-1, keepdim=True).float()
        h = e.sum(1) / (torch.sqrt(nnz) + torch.finfo(torch.float32).eps)
        h = torch.tanh(apply_dropout(h, float(self.cfg.get("dropout_prob", 0.0)), train, rng))
        mu, logvar = self._mlp("encoder", self.n_enc, h).chunk(2, dim=-1)
        return mu, logvar

    def _user_emb_from_batch(self, batch, train: bool = False, rng=None):
        return self.forward_user_emb(item_seq=batch.get("item_seq"),
                                     item_seq_features=batch.get("item_seq_features"),
                                     time_seq=batch.get("time_seq"), train=train, rng=rng,
                                     reparam_seed=batch.get("reparam_seed"),
                                     reparam_rows=batch.get("reparam_rows"))

    def _eval_eps(self, mu: torch.Tensor, reparam_seed, rows=None) -> torch.Tensor:
        st = int(self.cfg.get("eval_reparameter_sampling_times", 0) or 0)
        seed = int(self.cfg.get("seed", 2022))
        if reparam_seed is not None:
            seed = int(np.random.SeedSequence([seed, int(reparam_seed)]).generate_state(1)[0])
        gen = torch.Generator(device=mu.device).manual_seed(seed)
        if rows is not None:    # a data-parallel rank's rows of the batch
            gen = RowSlice(gen, *rows)
        return randn_rows(gen, (*mu.shape, st), mu.device).mean(-1)

    def forward_user_emb(self, user_id=None, item_seq=None, item_seq_len=None,
                         item_seq_features=None, time_seq=None, train: bool = False,
                         rng=None, reparam_seed=None, reparam_rows=None):
        mu, logvar = self._encode(item_seq, item_seq_features, time_seq, train, rng)
        if train:
            eps = randn_rows(rng.rows, mu.shape, mu.device)
        elif int(self.cfg.get("eval_reparameter_sampling_times", 0) or 0) > 0:
            eps = self._eval_eps(mu, reparam_seed, reparam_rows)
        else:
            return self._mlp("decoder", self.n_dec, mu)
        return self._mlp("decoder", self.n_dec, mu + eps * torch.exp(0.5 * logvar))

    def forward(self, batch, train: bool = True, rng=None):
        item_seq = batch["item_seq"]
        weight = batch.get("weight")
        if weight is None:
            weight = torch.ones(item_seq.shape[0], device=item_seq.device)
        mu, logvar = self._encode(item_seq, batch.get("item_seq_features"),
                                  batch.get("time_seq"), train, rng)
        z = mu
        if train:
            z = mu + randn_rows(rng.rows, mu.shape, mu.device) * torch.exp(0.5 * logvar)
        user_emb = self._mlp("decoder", self.n_dec, z)
        items = self.all_item_emb()
        dt = torch.promote_types(user_emb.dtype, items.dtype)
        all_scores = user_emb.to(dt) @ items.to(dt).T                 # [B, N]
        # masked multinomial softmax over the history (multivae.py:115-120)
        real = (item_seq != 0).float() * weight[:, None]
        pos = all_scores.gather(-1, item_seq.long())
        lse = torch.logsumexp(all_scores, dim=-1, keepdim=True)
        nll = (lse - pos) * real
        softmax_loss = nll.sum() / torch.clamp(L.denominator(real.sum()), min=1.0)
        per_row_kl = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=1)
        kl = (per_row_kl * weight).sum() / torch.clamp(L.denominator(weight.sum()), min=1.0)
        anneal = batch.get("anneal")
        if anneal is None:
            anneal = float(self.cfg.get("anneal_cap", 0.2))
        loss = softmax_loss + anneal * kl
        per_row = nll.sum(-1) / torch.clamp((item_seq != 0).sum(-1), min=1)
        return loss, per_row

    def predict(self, batch):
        user_emb = self._user_emb_from_batch(batch)
        items_emb = self.forward_item_emb(batch["item_id"], batch.get("item_features"))
        dt = torch.promote_types(user_emb.dtype, items_emb.dtype)
        user_emb, items_emb = user_emb.to(dt), items_emb.to(dt)
        if items_emb.dim() == user_emb.dim():
            if items_emb.shape == user_emb.shape:
                return (user_emb * items_emb).sum(-1)
            return user_emb @ items_emb.T
        return torch.einsum("bd,bgd->bg", user_emb, items_emb)
