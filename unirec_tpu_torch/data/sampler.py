"""Host-side negative sampling for one-vs-k evaluation batches (copy of
unirec_tpu/data/sampler.py).

For every negative slot ``oversample_factor`` candidates are drawn, uniform
over [1, n_items) or, given ``item_popularity``, in proportion to
popularity ** ``neg_by_pop_alpha`` through a Walker alias table; those in
the user's history or equal to a positive are rejected and the first
survivor is kept, 0 when none survives (addnegsamples.py:90-115).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from unirec_tpu_torch.data.history import UserHistory


class AliasTable:
    """Walker alias method for O(1) weighted sampling, built in float64
    exactly as the JAX package builds it (the device pipeline keeps its
    arrays on the device)."""

    def __init__(self, weights: np.ndarray):
        w = np.asarray(weights, dtype=np.float64)
        total = w.sum()
        if total <= 0:
            raise ValueError("alias table needs positive total weight")
        n = len(w)
        prob = w * n / total
        alias = np.zeros(n, dtype=np.int64)
        thresh = np.ones(n, dtype=np.float64)
        small = [i for i in range(n) if prob[i] < 1.0]
        large = [i for i in range(n) if prob[i] >= 1.0]
        while small and large:
            s, l = small.pop(), large.pop()
            thresh[s] = prob[s]
            alias[s] = l
            prob[l] -= 1.0 - prob[s]
            (small if prob[l] < 1.0 else large).append(l)
        self.thresh = thresh
        self.alias = alias
        self.n = n

    @classmethod
    def of_popularity(cls, item_popularity: np.ndarray, alpha: float) -> "AliasTable":
        """The table of popularity ** alpha, with item 0 (the padding item)
        never drawn (addnegsamples.py:64)."""
        w = np.power(np.asarray(item_popularity, dtype=np.float64), alpha)
        w[0] = 0.0
        return cls(w)

    def sample(self, rng: np.random.Generator, shape) -> np.ndarray:
        idx = rng.integers(0, self.n, size=shape)
        frac = rng.random(size=shape)
        return np.where(frac < self.thresh[idx], idx, self.alias[idx])


class NegativeSampler:
    def __init__(self, n_items: int, n_neg: int,
                 user_history: Optional[UserHistory] = None,
                 item_popularity: Optional[np.ndarray] = None,
                 neg_by_pop_alpha: float = 1.0,
                 oversample_factor: int = 4):
        self.n_items = int(n_items)
        self.n_neg = int(n_neg)
        self.history = user_history
        self.oversample = max(int(oversample_factor), 1)
        self.alias = None if item_popularity is None else \
            AliasTable.of_popularity(item_popularity, neg_by_pop_alpha)

    def _draw(self, rng: np.random.Generator, shape) -> np.ndarray:
        if self.alias is not None:
            return self.alias.sample(rng, shape)
        return rng.integers(1, self.n_items, size=shape)

    def __call__(self, rng: np.random.Generator, user_ids: np.ndarray,
                 pos_items: np.ndarray) -> np.ndarray:
        """[B, n_neg] int32 negatives for users [B] with positives [B] or
        [B, P]; 0 where every proposal was rejected."""
        B = len(user_ids)
        cand = self._draw(rng, (B, self.n_neg * self.oversample)).astype(np.int64)
        pos = pos_items if pos_items.ndim == 2 else pos_items[:, None]
        bad = (cand[:, :, None] == pos[:, None, :]).any(-1)
        if self.history is not None:
            bad |= self.history.contains(user_ids, cand)
        ok = (~bad).reshape(B, self.n_neg, self.oversample)
        cand = cand.reshape(B, self.n_neg, self.oversample)
        chosen = np.take_along_axis(cand, ok.argmax(-1)[..., None], axis=-1)[..., 0]
        return np.where(ok.any(-1), chosen, 0).astype(np.int32)
