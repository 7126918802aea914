"""Host-side negative sampling for one-vs-k evaluation batches (copy of
unirec_tpu/data/sampler.py's uniform path).

For every negative slot ``oversample_factor`` uniform candidates in
[1, n_items) are drawn; those in the user's history or equal to a positive
are rejected and the first survivor is kept, 0 when none survives
(addnegsamples.py:90-115). Popularity draws (the alias table) are not
ported yet and raise.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from unirec_tpu_torch.data.history import UserHistory


class NegativeSampler:
    def __init__(self, n_items: int, n_neg: int,
                 user_history: Optional[UserHistory] = None,
                 item_popularity: Optional[np.ndarray] = None,
                 oversample_factor: int = 4):
        if item_popularity is not None:
            raise NotImplementedError("popularity (alias-table) negatives are not "
                                      "ported yet (ROADMAP.md Queue 1 item 3)")
        self.n_items = int(n_items)
        self.n_neg = int(n_neg)
        self.history = user_history
        self.oversample = max(int(oversample_factor), 1)

    def __call__(self, rng: np.random.Generator, user_ids: np.ndarray,
                 pos_items: np.ndarray) -> np.ndarray:
        """[B, n_neg] int32 negatives for users [B] with positives [B] or
        [B, P]; 0 where every proposal was rejected."""
        B = len(user_ids)
        cand = rng.integers(1, self.n_items, size=(B, self.n_neg * self.oversample))
        pos = pos_items if pos_items.ndim == 2 else pos_items[:, None]
        bad = (cand[:, :, None] == pos[:, None, :]).any(-1)
        if self.history is not None:
            bad |= self.history.contains(user_ids, cand)
        ok = (~bad).reshape(B, self.n_neg, self.oversample)
        cand = cand.reshape(B, self.n_neg, self.oversample)
        chosen = np.take_along_axis(cand, ok.argmax(-1)[..., None], axis=-1)[..., 0]
        return np.where(ok.any(-1), chosen, 0).astype(np.int32)
