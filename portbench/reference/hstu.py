"""Plain PyTorch reference of HSTU training (Zhai et al., "Actions Speak
Louder than Words: Trillion-Parameter Sequential Transducers for Generative
Recommendations", ICML 2024, arXiv:2402.17152; the public code
github.com/facebookresearch/generative-recommenders, its HSTU encoder).

This file decides ``correct`` for the HSTU configurations. It imports
nothing of the program under test (``unirec_tpu_torch``) and nothing of
JAX. From reference/sasrec.py it takes the training batch (history window,
history-rejected negatives), the per-step seeds, Adam's constants and the
precision control, which are the port's pipeline and optimizer and not
part of HSTU. Everything else is worked out here in float32 with TF32 off
(or float64 in the CPU tests), as plain tensor operations with autograd:

* input: item rows (id 0 gives zeros) times sqrt(d), plus a learned
  position row (position p of the left-padded window), then dropout;
* each of ``n_layers`` layers, for x [B, L, d]:
    x^ = LN(x)                   (no affine parameters, eps layer_norm_eps)
    U, V, Q, K = split(SiLU(x^ W_uvqk))           (W_uvqk without a bias)
    A_h[i, j] = SiLU(Q_h[i] . K_h[j] + rab[j - i + L - 1]) / L
                for j <= i and key j not padding, else 0 (no softmax);
                rab is the layer's table of 2L - 1 values, shared by heads
    O = concat_h A_h V_h
    y = x + W_o Dropout(U * LN(O)) + b_o
* output: the last position, L2-normalized (x / max(|x|, 1e-6));
* scores: cosines of that and the L2-normalized item rows (0 for id 0),
  divided by ``tau``; loss: the sampled softmax of the positive (the first
  candidate) against the negatives, weighted mean over rows; Adam.

The three checked steps run over the batch in blocks of ``ROW_BLOCK`` rows,
each block's share of the loss (its rows' weighted sum over the batch's
weight) differentiated on its own and the gradients summed, so that the
[rows, H, L, L] scores of one block are what is held at once.

Departures from the public code, each as the configuration file states:

* the timestamp term of the relative bias (bucketed log-time deltas) is
  left out: the benchmark's generator draws no timestamps;
* the training objective is the port's: one target a row, the last
  position of an autoregressive window, negatives drawn and rejected
  against the history as the port's device pipeline draws them; the public
  code trains every position with unrejected negatives;
* the optimizer is the port's Adam (b1 0.9, b2 0.999, eps 1e-8, no weight
  decay); the public code uses AdamW with b2 0.98 and weight decay 0;
* positions are those of the left-padded window (the last item at L - 1).

Randomness: the dropout masks are the program's, drawn from the step's
dropout generator in the program's order (the input's [B, L, d], then each
layer's [B, L, H dv]) at the whole batch's shape, then cut to each block.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reference import sasrec as S

ADAM_B1, ADAM_B2, ADAM_EPS = S.ADAM_B1, S.ADAM_B2, S.ADAM_EPS
Precision, F32 = S.Precision, S.F32
ROW_BLOCK = 512
NORM_EPS = 1e-6


class Sizes:
    """The sizes and switches of one HSTU configuration (a port config
    dict), with the fields reference/sasrec.py's ``train_batch`` reads."""

    def __init__(self, cfg: Dict):
        g = cfg.get
        if g("model") != "HSTU":
            raise ValueError("reference models HSTU")
        self.n_items = int(cfg["n_items"])
        self.L = int(cfg["max_seq_len"])
        self.D = int(g("hidden_size") or g("embedding_size"))
        self.nh = int(g("n_heads", 2))
        self.dqk = int(g("dqk") or self.D // self.nh)
        self.dv = int(g("dv") or self.D // self.nh)
        self.n_layers = int(g("n_layers", 8))
        self.eps = float(g("layer_norm_eps", 1e-6))
        self.p = float(g("hidden_dropout_prob", 0.2))
        self.tau = float(g("tau", 1.0))
        self.n_neg = int(g("n_sample_neg_train", 0) or 0)
        self.oversample = max(int(g("neg_oversample_factor", 4)), 1)
        self.mask_mode = g("history_mask_mode", "unorder")
        self.seq_last = bool(g("seq_last", 0))
        self.alpha = float(g("neg_by_pop_alpha", 0) or 0)
        self.lr = float(g("learning_rate", 1e-3))
        if int(g("embedding_size", self.D)) != self.D:
            raise ValueError("reference models embedding_size == hidden_size")
        if int(g("dropout_bits", 32)) != 32:
            raise ValueError("reference models 32-bit dropout draws")
        for key in ("has_user_emb", "use_features", "use_text_emb", "time_seq",
                    "has_item_bias", "has_user_bias"):
            if g(key, 0):
                raise ValueError(f"reference does not model {key}")
        if g("distance_type") != "cosine" or g("loss_type") != "softmax":
            raise ValueError("reference models cosine scores under the sampled softmax")
        if float(g("score_clip_value", -1) or -1) > 0:
            raise ValueError("reference models no score clip")
        if g("optimizer", "adam") != "adam" or float(g("weight_decay", 0) or 0) \
                or float(g("grad_clip_value", -1) or -1) > 0:
            raise ValueError("reference models plain Adam")


# ---------------------------------------------------------------- the tower
def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=NORM_EPS)


def _drop(x: torch.Tensor, keep: Optional[torch.Tensor], p: float) -> torch.Tensor:
    return x if keep is None else torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def pointwise_attention(qh, kh, vh, rab, keys, q: Precision = F32) -> torch.Tensor:
    """[B, L, H, dv]: A V for q, k [B, L, H, dqk], v [B, L, H, dv], the
    table rab [2L - 1] and keys [B, L] (False at padding)."""
    L = qh.shape[1]
    r = torch.arange(L, device=qh.device)
    bias = rab[r[None, :] - r[:, None] + (L - 1)]
    s = torch.einsum("bihd,bjhd->bhij", q(qh), q(kh)) + bias
    allowed = torch.ones(L, L, dtype=torch.bool, device=qh.device).tril()[None, None] \
        & keys[:, None, None, :]
    a = torch.where(allowed, _silu(s) / L, torch.zeros_like(s))
    return torch.einsum("bhij,bjhd->bihd", q(a), q(vh))


def layer(W, s: Sizes, i: int, x, keys, keep, q: Precision = F32, parts=None):
    """One HSTU layer. ``parts``: leave out "rab", "len" (the / L) or
    "norm" (the LN of O), for the tests that show each is needed."""
    pre = f"hstu.layer_{i}."
    parts = parts or ()
    B, L, D = x.shape
    H, dqk, dv = s.nh, s.dqk, s.dv
    uvqk = _silu(q(_ln(x, s.eps)) @ q(W[pre + "uvqk.weight"]).transpose(0, 1))
    u, v, qq, k = torch.split(uvqk, [H * dv, H * dv, H * dqk, H * dqk], dim=-1)
    rab = W[pre + "rab.weight"]
    rab = torch.zeros_like(rab[:2 * L - 1]) if "rab" in parts else \
        rab[(rab.shape[0] + 1) // 2 - L:(rab.shape[0] + 1) // 2 + L - 1]
    o = pointwise_attention(qq.reshape(B, L, H, dqk), k.reshape(B, L, H, dqk),
                            v.reshape(B, L, H, dv), rab, keys, q)
    if "len" in parts:
        o = o * L
    o = o.reshape(B, L, H * dv)
    h = _drop(u * (o if "norm" in parts else _ln(o, s.eps)), keep, s.p)
    return x + q(h) @ q(W[pre + "o.weight"]).transpose(0, 1) + W[pre + "o.bias"]


def user_embedding(W, s: Sizes, item_seq: torch.Tensor, keeps: Optional[List] = None,
                   q: Precision = F32, parts=None) -> torch.Tensor:
    """The tower's output [B, D], L2-normalized, for left-padded windows
    ``item_seq``; ``keeps``: the dropout keep masks of the input and of each
    layer (None: no dropout)."""
    B, L = item_seq.shape
    seq = item_seq.long()
    keeps = keeps or [None] * (1 + s.n_layers)
    x = q(W["item_embedding.weight"])[seq] * (seq != 0)[..., None] * math.sqrt(s.D)
    x = x + q(W["position_embedding.weight"][:L])[None]
    x = _drop(x, keeps[0], s.p)
    keys = seq > 0
    for i in range(s.n_layers):
        x = layer(W, s, i, x, keys, keeps[1 + i], q, parts)
    return _normalize(x[:, -1])


def dropout_keeps(s: Sizes, seed: int, B: int, L: int, device) -> List[torch.Tensor]:
    """The program's keep masks of one step, in its order: the input's
    [B, L, d], then each layer's [B, L, H dv]."""
    if s.p <= 0.0:
        return [None] * (1 + s.n_layers)
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    shapes = [(B, L, s.D)] + [(B, L, s.nh * s.dv)] * s.n_layers
    return [torch.rand(sh, generator=gen, device=device) < 1.0 - s.p for sh in shapes]


def block_loss(W, s: Sizes, batch, rows: slice, keeps, weight_sum, q: Precision = F32,
               parts=None) -> torch.Tensor:
    """The rows' share of the step's loss: the weighted sum of their
    sampled-softmax losses over the batch's weight sum."""
    ks = [None if k is None else k[rows] for k in keeps]
    u = user_embedding(W, s, batch["item_seq"][rows], ks, q, parts)
    ids = batch["item_id"][rows].long()
    items = _normalize(q(W["item_embedding.weight"])[ids] * (ids != 0)[..., None])
    scores = (q(u)[:, None, :] * q(items)).sum(-1) / s.tau
    nll = torch.logsumexp(scores, -1) - scores[:, 0]
    w = batch["weight"][rows].to(nll.dtype)
    return (nll * w).sum() / weight_sum


def train(W0: Dict[str, torch.Tensor], cfg: Dict, raw: Sequence[Dict[str, np.ndarray]],
          hist_items: torch.Tensor, hist_lens: torch.Tensor, seed: int,
          popularity: Optional[np.ndarray] = None, q: Precision = F32,
          dtype=torch.float32, row_block: int = ROW_BLOCK, parts=None) -> Dict:
    """``len(raw)`` training steps from the weights W0 (name -> tensor).
    Returns each step's loss, each leaf's first gradient and its change over
    all the steps (norms, by name), and each step's batch."""
    S._full_f32()
    s = Sizes(cfg)
    dev = hist_items.device
    alias = S.make_alias(popularity, s.alpha) if (s.alpha > 0 and popularity is not None) \
        else None
    P = {k: v.detach().to(device=dev, dtype=dtype).clone().requires_grad_(True)
         for k, v in W0.items()}
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, batches, grad_norm = [], [], None
    for step, rb in enumerate(raw):
        aug_seed, drop_seed = S.step_seeds(seed, step)
        batch = S.train_batch(s, torch.as_tensor(rb["user_id"]), torch.as_tensor(rb["item_id"]),
                              hist_items, hist_lens, aug_seed, alias)
        batches.append({k: batch[k] for k in ("item_id", "item_seq", "item_seq_len")})
        batch["weight"] = torch.as_tensor(rb["weight"], device=dev)
        B, L = batch["item_seq"].shape
        keeps = dropout_keeps(s, drop_seed, B, L, dev)
        weight_sum = batch["weight"].to(dtype).sum().clamp(min=1.0)
        grads = {k: torch.zeros_like(p) for k, p in P.items()}
        loss = 0.0
        for lo in range(0, B, row_block):
            part = block_loss(P, s, batch, slice(lo, min(B, lo + row_block)), keeps,
                              weight_sum, q, parts)
            got = torch.autograd.grad(part, list(P.values()), allow_unused=True)
            with torch.no_grad():
                for k, g in zip(P, got):
                    if g is not None:
                        grads[k] += g
            loss += float(part.detach())
            del part, got
        losses.append(loss)
        with torch.no_grad():
            t = step + 1
            for k, p in P.items():
                g = grads[k]
                mu[k] = ADAM_B1 * mu[k] + (1 - ADAM_B1) * g
                nu[k] = ADAM_B2 * nu[k] + (1 - ADAM_B2) * g * g
                mhat = mu[k] / (1 - ADAM_B1 ** t)
                vhat = nu[k] / (1 - ADAM_B2 ** t)
                p -= s.lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
            if grad_norm is None:
                grad_norm = {k: float(g.norm()) for k, g in grads.items()}
        del grads, keeps
    change = {k: float((P[k].detach() - W0[k].to(dev, dtype)).norm()) for k in P}
    return {"losses": losses, "grad_norm": grad_norm, "change_norm": change,
            "batches": batches}
