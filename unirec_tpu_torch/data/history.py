"""Packed user-history store (serving subset of unirec_tpu/data/history.py).

Histories live in one right-padded int32 matrix ``items[n_users, capacity]``
plus ``lengths[n_users]``; gathering a batch's rows and building its
left-padded windows are vectorized numpy ops with static shapes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from unirec_tpu_torch.constants import DataFormat


class UserHistory:
    def __init__(self, items: np.ndarray, lengths: np.ndarray):
        if items.ndim != 2 or lengths.shape != (items.shape[0],):
            raise ValueError(f"items [n_users, capacity] and lengths [n_users] "
                             f"expected, got {items.shape} and {lengths.shape}")
        self.items = items.astype(np.int32, copy=False)
        self.lengths = lengths.astype(np.int32, copy=False)

    @property
    def n_users(self) -> int:
        return self.items.shape[0]

    @property
    def capacity(self) -> int:
        return self.items.shape[1]

    @staticmethod
    def load(path_prefix: str, n_users: int, fmt: str,
             capacity: int = -1) -> "UserHistory":
        """Load from ``<prefix>.{ftr,pkl,tsv,csv,txt}``."""
        from unirec_tpu_torch.utils.file_io import load_table
        return UserHistory.from_dataframe(load_table(path_prefix), n_users,
                                          fmt, capacity=capacity)

    @staticmethod
    def from_dataframe(df, n_users: int, fmt: str,
                       capacity: int = -1) -> "UserHistory":
        """Build from a T1/T3 (one row per interaction) or T5/T6 (item_seq
        column) table; keeps the LAST ``capacity`` items per user and, for
        duplicate user rows, the later row."""
        seqs = [None] * n_users
        if fmt in (DataFormat.T5.value, DataFormat.T6.value,
                   DataFormat.T5_1.value):
            for uid, seq in zip(df["user_id"].to_numpy(), df["item_seq"]):
                if 0 <= int(uid) < n_users:
                    seqs[int(uid)] = np.asarray(seq, dtype=np.int64)
        elif fmt in (DataFormat.T1.value, DataFormat.T3.value):
            grouped = df.groupby("user_id")["item_id"].apply(np.asarray)
            for uid, items in grouped.items():
                if 0 <= uid < n_users:
                    seqs[uid] = items
        else:
            raise ValueError(f"unsupported user history format: {fmt}")
        max_len = max((len(s) for s in seqs if s is not None), default=1)
        if capacity is not None and capacity > 0:
            max_len = min(max_len, capacity)
        items = np.zeros((n_users, max(max_len, 1)), dtype=np.int32)
        lengths = np.zeros(n_users, dtype=np.int32)
        for uid, s in enumerate(seqs):
            if s is None or len(s) == 0:
                continue
            s = s[-max_len:]
            items[uid, :len(s)] = s
            lengths[uid] = len(s)
        return UserHistory(items, lengths)

    def gather(self, user_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Raw packed rows + lengths for a batch of users (out-of-range ids
        get an empty history)."""
        uid = np.clip(user_ids, 0, self.n_users - 1)
        valid = (user_ids >= 0) & (user_ids < self.n_users)
        return self.items[uid] * valid[:, None], self.lengths[uid] * valid

    def window(self, user_ids: np.ndarray, max_seq_len: int,
               drop_last: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Left-padded history windows for inference (inferdataset.py:44-67):
        drop the trailing ``drop_last`` items (the reference's ``last_item``
        offset), then right-align the last ``max_seq_len``."""
        rows, lens = self.gather(user_ids)
        n = np.maximum(lens.astype(np.int64) - int(drop_last), 0)
        L = max_seq_len
        grid = n[:, None] - L + np.arange(L)[None, :]
        valid = grid >= 0
        gi = np.clip(grid, 0, max(rows.shape[1] - 1, 0))
        seq = np.take_along_axis(rows, gi, axis=1) * valid
        return seq.astype(np.int32), np.minimum(n, L).astype(np.int32)
