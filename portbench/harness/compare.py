"""The comparisons that decide ``correct``: the program's outputs against
the reference's, as numbers that each have a limit (limits/<cell>.json)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def topk_gaps(scores: torch.Tensor, served: torch.Tensor, k: int):
    """Judge served top-k ids against reference scores [B, N] (banned items
    at -inf). Returns (bad, gap): ``bad`` counts served ids out of range,
    repeated in a row, or banned; ``gap`` is the widest distance by which a
    served id's score lies below the row's k-th best, over the row's score
    spread (standard deviation of its finite scores)."""
    B, N = scores.shape
    ids = served.long().to(scores.device)
    in_range = (ids >= 0) & (ids < N)
    safe = torch.where(in_range, ids, 0)
    got = scores.gather(1, safe)
    srt = ids.sort(1).values
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    banned = ~torch.isfinite(got) | ~in_range
    bad = int(banned.sum()) + int(dup.sum())
    kth = scores.topk(k, dim=1).values[:, -1:]
    finite = torch.isfinite(scores)
    cnt = finite.sum(1, keepdim=True).clamp(min=2)
    z = torch.where(finite, scores, 0.0)
    mean = z.sum(1, keepdim=True) / cnt
    std = torch.sqrt((torch.where(finite, scores - mean, 0.0) ** 2).sum(1, keepdim=True)
                     / (cnt - 1)).clamp(min=1e-30)
    gap = torch.where(banned, 0.0, (kth - got).clamp(min=0.0)) / std
    return bad, float(gap.max()) if gap.numel() else 0.0



def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> Dict:
    """Per leaf, |program norm - reference norm| over the larger of the
    reference's norm of that leaf and its median leaf's norm: the worst
    leaf's gap (and its name) and the median of the leaves' gaps."""
    med = float(np.median([ref[n] for n in names])) if names else 0.0
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get) if gaps else None
    return {"worst": gaps[worst] if worst else 0.0, "leaf": worst,
            "median_gap": float(np.median(list(gaps.values()))) if gaps else 0.0}
