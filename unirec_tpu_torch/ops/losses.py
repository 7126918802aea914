"""Ranking losses as pure functions over grouped score matrices.

Counterpart of unirec_tpu/ops/losses.py (reference reco_abc.py:220-272,
modules.py:15-35), with row weights so padded batch rows contribute
nothing. Every function returns (scalar_loss, per_row_loss [B]); losses
run in f32 whatever the towers computed in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from unirec_tpu_torch.constants import EPS, LossType


def _weighted_mean(per_row: torch.Tensor, weight: torch.Tensor):
    w = weight.to(per_row.dtype)
    return (per_row * w).sum() / torch.clamp(w.sum(), min=1.0)


def bce_loss(scores, labels, weight):
    """BCE over sigmoid probabilities, the probability clipped like the
    reference's torch.clamp(sigmoid, max=1-EPS) (reco_abc.py:249)."""
    p = torch.clamp(torch.sigmoid(scores), EPS, 1.0 - EPS)
    l = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))  # noqa: E741
    per_row = l.mean(-1) if l.dim() > 1 else l
    return _weighted_mean(per_row, weight), per_row


def bpr_loss(scores, labels, weight):
    """First column is the positive, the rest negatives (reco_abc.py:252-255)."""
    l = -torch.log(EPS + torch.sigmoid(scores[:, :1] - scores[:, 1:]))  # noqa: E741
    per_row = l.mean(-1)
    return _weighted_mean(per_row, weight), per_row


def ccl_loss(scores, labels, weight, ccl_w: float, ccl_m: float):
    """Cosine contrastive loss (SimpleX, CIKM'21), modules.py:28-35."""
    per_row = 1.0 - scores[:, 0] + ccl_w * torch.clamp(scores[:, 1:] - ccl_m,
                                                       min=0.0).mean(-1)
    return _weighted_mean(per_row, weight), per_row


def sampled_softmax_loss(scores, labels, weight):
    """-log_softmax at the positive positions; several positives per group
    are averaged over all positive elements (reco_abc.py:260-265)."""
    nll = -F.log_softmax(scores, dim=-1)
    pos = (labels > 0).to(scores.dtype)
    per_row = (nll * pos).sum(-1) / torch.clamp(pos.sum(-1), min=1.0)
    row_w = weight * pos.sum(-1)
    loss = (nll * pos * weight[:, None]).sum() / torch.clamp(row_w.sum(), min=1.0)
    return loss, per_row


def full_softmax_loss(all_scores, pos_items, weight):
    """logsumexp over the catalog minus the positive's score
    (reco_abc.py:266-270). all_scores [B, n_items]; pos_items [B]."""
    all_scores = all_scores.float()
    pos = all_scores.gather(1, pos_items.long()[:, None])[:, 0]
    per_row = torch.logsumexp(all_scores, -1) - pos
    return _weighted_mean(per_row, weight), per_row


def compute_loss(loss_type: str, scores, labels, weight, config):
    scores = scores.float()
    if labels is not None:
        labels = labels.float()
    if loss_type == LossType.BCE.value:
        return bce_loss(scores, labels, weight)
    if loss_type == LossType.BPR.value:
        return bpr_loss(scores, labels, weight)
    if loss_type == LossType.CCL.value:
        return ccl_loss(scores, labels, weight, float(config.get("ccl_w", 150)),
                        float(config.get("ccl_m", 0.4)))
    if loss_type == LossType.SOFTMAX.value:
        return sampled_softmax_loss(scores, labels, weight)
    raise ValueError(f"unknown loss type: {loss_type}")
