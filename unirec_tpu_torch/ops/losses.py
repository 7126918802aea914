"""Ranking losses as pure functions over grouped score matrices.

Counterpart of unirec_tpu/ops/losses.py (reference reco_abc.py:220-272,
modules.py:15-35), with row weights so padded batch rows contribute
nothing. Every function returns (scalar_loss, per_row_loss [B]); losses
run in f32 whatever the towers computed in.

Data parallelism: a rank computes its rows' share of the loss, its sum
divided by the global batch's denominator (``denominator``: the weight sum,
or the positives' or the history's count, summed over the ``data`` ranks by
the reducer that ``global_denominators`` installs around a train step).
The ranks' shares and their gradients then sum to the one-process loss and
gradients of the whole batch, for every normalization a loss uses.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from unirec_tpu_torch.constants import EPS, LossType

_DENOMINATOR_SUM = contextvars.ContextVar("loss_denominator_sum", default=None)


@contextlib.contextmanager
def global_denominators(reduce_sum):
    """Within the block, ``denominator(x)`` is ``reduce_sum(x)``: the sum of
    a rank's local denominator over the data-parallel ranks."""
    token = _DENOMINATOR_SUM.set(reduce_sum)
    try:
        yield
    finally:
        _DENOMINATOR_SUM.reset(token)


def denominator(local_sum: torch.Tensor) -> torch.Tensor:
    """A loss's normalizer over the global batch from this rank's sum of
    it (the sum itself outside a data-parallel step); no gradient flows
    through it, as none flows through weights and counts."""
    reduce_sum = _DENOMINATOR_SUM.get()
    return local_sum if reduce_sum is None else reduce_sum(local_sum.detach())


def _weighted_mean(per_row: torch.Tensor, weight: torch.Tensor):
    w = weight.to(per_row.dtype)
    return (per_row * w).sum() / torch.clamp(denominator(w.sum()), min=1.0)


def bce_loss(scores, labels, weight):
    """BCE over sigmoid probabilities, the probability clipped like the
    reference's torch.clamp(sigmoid, max=1-EPS) (reco_abc.py:249).

    1 - EPS rounds to 1.0 in f32, so that clamp leaves 1 - p at 0 for a
    score above about 16.6: log(0) = -inf on a negative, 0 * log(0) = NaN on
    a positive. Where 1 - p is 0, the complement is taken as sigmoid(-s)
    clamped at EPS, which is what the clamp gives in exact arithmetic.
    Wherever 1 - p > 0 this is the JAX package's formula
    (unirec_tpu/ops/losses.py:24-30) bit for bit; where it is 0 the JAX
    package's loss is not finite and its trainer skips the step."""
    p = torch.clamp(torch.sigmoid(scores), EPS, 1.0 - EPS)
    q = 1.0 - p
    q = torch.where(q > 0, q, torch.clamp(torch.sigmoid(-scores), min=EPS))
    l = -(labels * torch.log(p) + (1.0 - labels) * torch.log(q))  # noqa: E741
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
    loss = (nll * pos * weight[:, None]).sum() / torch.clamp(denominator(row_w.sum()),
                                                            min=1.0)
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
