"""Ranking metrics on the device (counterpart of unirec_tpu/ops/metrics.py).

The reference ranks with a numba kernel over CPU score matrices
(onepos.py:20-31): rank(row) = #{j > 0 : row[j] > row[0]} after tiny
tie-breaking noise. Here scoring, history masking, ranks and per-row metric
values are torch ops on the scores' device; only per-row metric vectors go
back to the host.

Metric formulas (onepos.py:95-175):
    hit@k   = 1[rank < k]
    ndcg@k  = 1[rank < k] / log2(rank + 2)
    mrr@k   = 1[rank < k] / (rank + 1)
    group_auc = (n - 1 - rank) / (n - 1)
The multi-positive variants (multipos.py:45-210) intersect the top-K ids
with the positives.

Tie noise is uniform in [-TIE_NOISE, TIE_NOISE], drawn from an explicit
``torch.Generator`` (the JAX package draws it from a PRNG key; the two
frameworks draw different numbers, so parity tests inject the same noise).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Sequence

import numpy as np
import torch

from unirec_tpu_torch.constants import NINF_SCORE

TIE_NOISE = 1e-8


def parse_metrics(metrics_str_or_list) -> List[str]:
    """'[hit@5;10, ndcg@5;10]'-style spec -> flat metric names."""
    if isinstance(metrics_str_or_list, str):
        metrics = ast.literal_eval(metrics_str_or_list)
    else:
        metrics = list(metrics_str_or_list)
    flat = []
    for m in metrics:
        if "@" in m:
            name, ks = m.split("@")
            flat.extend(f"{name}@{int(k)}" for k in ks.split(";"))
        else:
            flat.append(m)
    return flat


def add_tie_noise(scores: torch.Tensor, gen) -> torch.Tensor:
    """``gen``: a generator, or a RowSlice (core/mesh.py) when a
    data-parallel rank scores its rows of the batch: the noise is drawn at
    the global batch's shape and sliced, as a one-process run draws it."""
    from unirec_tpu_torch.core.mesh import rand_rows
    u = rand_rows(gen, scores.shape, scores.device)
    return scores + (u * (2 * TIE_NOISE) - TIE_NOISE).to(scores.dtype)


# ------------------------------------------------------------ one positive
def onepos_rank_from_group(scores: torch.Tensor) -> torch.Tensor:
    """Rank of column 0 within each group row: #{j > 0 : s_j > s_0}."""
    return (scores[:, 1:] > scores[:, :1]).sum(-1).to(torch.int32)


def _history_cols(hist_items: torch.Tensor, hist_len: torch.Tensor) -> torch.Tensor:
    """History ids with the padded slots sent to column 0 (never competes)."""
    cap = hist_items.shape[1]
    valid = torch.arange(cap, device=hist_items.device)[None, :] < hist_len[:, None]
    return torch.where(valid, hist_items, 0).long()


def onepos_rank_full_catalog(scores: torch.Tensor, pos_items: torch.Tensor,
                             hist_items: torch.Tensor, hist_len: torch.Tensor,
                             gen: torch.Generator) -> torch.Tensor:
    """Rank of the positive item against the full catalog
    (evaluator_abc.py:249-265): the positive's score is taken before
    masking, history items become NINF, column 0 (the padding item) never
    competes, and the positive column competes only through its own score.

    scores [B, n_items]; pos_items [B]; hist_items/hist_len the packed
    history rows of the batch's users."""
    return onepos_rank_and_topk(scores, pos_items, hist_items, hist_len, gen, 0)[0]


def onepos_rank_and_topk(scores: torch.Tensor, pos_items: torch.Tensor,
                         hist_items: torch.Tensor, hist_len: torch.Tensor,
                         gen: torch.Generator, topk: int):
    """(rank of the positive as ``onepos_rank_full_catalog``, and with
    ``topk`` > 0 the [B, topk] recommendation list over the same masked,
    noisy scores with the positive competing at its own score, else None;
    JAX's onepos_rank_full_catalog(..., topk), the pop-kl metric's list)."""
    scores = add_tie_noise(scores, gen)
    rows = torch.arange(scores.shape[0], device=scores.device)
    pos = pos_items.long()
    pos_score = scores[rows, pos]
    masked = scores.scatter(1, _history_cols(hist_items, hist_len), NINF_SCORE)
    masked[:, 0] = NINF_SCORE
    topk_ids = None
    if topk > 0:
        with_pos = masked.clone()
        with_pos[rows, pos] = pos_score
        topk_ids = torch.topk(with_pos, topk).indices
    masked[rows, pos] = NINF_SCORE
    return (masked > pos_score[:, None]).sum(-1).to(torch.int32), topk_ids


def onepos_metrics(rank: torch.Tensor, n_scores: int,
                   metric_names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Per-row metric values from ranks. n_scores: the score matrix's
    columns (n_items for one-vs-all, the group size for one-vs-k)."""
    r = rank.float()
    out = {}
    for m in metric_names:
        if m == "group_auc":
            out[m] = (n_scores - 1 - r) / max(n_scores - 1, 1)
        elif m == "ndcg":
            out[m] = 1.0 / torch.log2(r + 2.0)
        elif m == "mrr":
            out[m] = 1.0 / (r + 1.0)
        elif "@" in m:
            name, k = m.split("@")
            hit = (rank < int(k)).float()
            if name in ("hit", "recall"):
                out[m] = hit
            elif name == "ndcg":
                out[m] = hit / torch.log2(r + 2.0)
            elif name == "mrr":
                out[m] = hit / (r + 1.0)
    return out


# ---------------------------------------------------------- multi positive
def multipos_topk_and_metrics(scores: torch.Tensor, pos_items: torch.Tensor,
                              hist_items: torch.Tensor, hist_len: torch.Tensor,
                              metric_names: Sequence[str], max_k: int,
                              gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """One-vs-all metrics with several positives per user (T5/T6 eval,
    evaluator_abc.py:260-265 and multipos.py): positives keep their
    scores, column 0 and the rest of the history are NINF. pos_items [B, P]
    padded with 0."""
    B, N = scores.shape
    scores = add_tie_noise(scores, gen)
    rows = torch.arange(B, device=scores.device)[:, None]
    pos = pos_items.long()
    masked = scores.scatter(1, _history_cols(hist_items, hist_len), NINF_SCORE)
    is_pos = torch.zeros_like(masked, dtype=torch.bool)
    is_pos[rows, pos] = pos > 0
    masked = torch.where(is_pos, scores, masked)
    masked[:, 0] = NINF_SCORE

    top_ids = torch.topk(masked, max_k, dim=-1).indices                # [B, K]
    hits = (top_ids[:, :, None] == pos[:, None, :]) & (pos[:, None, :] > 0)
    hit_at = hits.any(-1).float()                                       # [B, K]
    n_pos = (pos > 0).sum(-1).float()
    dev = scores.device
    w_ndcg = 1.0 / torch.log2(torch.arange(2, max_k + 2, device=dev, dtype=torch.float32))
    w_mrr = 1.0 / torch.arange(1, max_k + 1, device=dev, dtype=torch.float32)
    ideal_cum = torch.cat([torch.zeros(1, device=dev), torch.cumsum(w_ndcg, 0)])

    out = {}
    for m in metric_names:
        if m == "group_auc":
            # Mann-Whitney from ordinal ranks (multipos.py:184-191); with
            # tie noise, ties occur only among NINF negatives
            order = torch.argsort(masked, dim=-1)
            ranks = torch.zeros((B, N), device=dev)
            ranks[rows, order] = torch.arange(1, N + 1, device=dev, dtype=torch.float32)
            pos_ranks = ranks.gather(1, pos)
            sum_r = torch.where(pos > 0, pos_ranks, 0.0).sum(-1)
            out[m] = (sum_r - n_pos * (n_pos + 1) / 2.0) / torch.clamp(
                n_pos * (N - n_pos), min=1.0)
            continue
        if "@" not in m:
            continue
        name, k = m.split("@")
        k = int(k)
        top = hit_at[:, :k]
        if name == "hit":
            out[m] = (top.sum(-1) > 0).float()
        elif name == "recall":
            out[m] = top.sum(-1) / torch.clamp(n_pos, min=1.0)
        elif name == "ndcg":
            ideal = ideal_cum[torch.clamp(n_pos.long(), max=k)]
            out[m] = (top * w_ndcg[:k]).sum(-1) / torch.clamp(ideal, min=1e-12)
        elif name == "mrr":
            out[m] = (top * w_mrr[:k]).sum(-1) / torch.clamp(
                torch.clamp(n_pos, max=float(k)), min=1.0)
    return out


# --------------------------------------------------------------- host-side
def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC, identical to sklearn.roc_auc_score for binary labels
    (tie-averaged ranks); NaN when one class is absent."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    if len(scores) == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    n = len(s)
    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    np.not_equal(s[1:], s[:-1], out=new_group[1:])
    gid = np.cumsum(new_group) - 1
    avg = np.bincount(gid, weights=np.arange(1, n + 1, dtype=np.float64)) / np.bincount(gid)
    ranks = np.empty(n, dtype=np.float64)
    ranks[order] = avg[gid]
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[labels > 0].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))
