"""Data loading of the port: history store, datasets, host batches for
evaluation, and the device pipeline for training."""
from __future__ import annotations

import numpy as np


def construct_item_popularity(history, n_items: int) -> np.ndarray:
    """Item interaction counts over the packed user histories (reference
    main.py:235-245); item 0, the padding id, gets 0."""
    mask = np.arange(history.capacity)[None, :] < history.lengths[:, None]
    res = np.bincount(history.items[mask], minlength=n_items)[:n_items].astype(np.int32)
    res[0] = 0
    return res
