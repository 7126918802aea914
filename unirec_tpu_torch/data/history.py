"""Packed user-history store (copy of unirec_tpu/data/history.py).

Histories live in one right-padded int32 matrix ``items[n_users, capacity]``
plus ``lengths[n_users]`` and, with ``with_time``, the matching time
buckets ``times[n_users, capacity]`` (T6's ``time_seq`` column, T3's
``rating``); gathering a batch's rows, membership tests for negative
rejection and the left-padded windows (with the reference's unorder /
autoregressive target masking, the time rows windowed alike) are
vectorized numpy ops with static shapes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from unirec_tpu_torch.constants import DataFormat, HistoryMaskMode


class UserHistory:
    def __init__(self, items: np.ndarray, lengths: np.ndarray,
                 times: Optional[np.ndarray] = None):
        if items.ndim != 2 or lengths.shape != (items.shape[0],):
            raise ValueError(f"items [n_users, capacity] and lengths [n_users] "
                             f"expected, got {items.shape} and {lengths.shape}")
        self.items = items.astype(np.int32, copy=False)
        self.lengths = lengths.astype(np.int32, copy=False)
        self.times = None if times is None else times.astype(np.int32, copy=False)
        self._sorted = None  # sorted rows, built at the first membership test

    @property
    def n_users(self) -> int:
        return self.items.shape[0]

    @property
    def capacity(self) -> int:
        return self.items.shape[1]

    @staticmethod
    def load(path_prefix: str, n_users: int, fmt: str, capacity: int = -1,
             with_time: bool = False) -> "UserHistory":
        """Load from ``<prefix>.{ftr,pkl,tsv,csv,txt}``."""
        from unirec_tpu_torch.utils.file_io import load_table
        return UserHistory.from_dataframe(load_table(path_prefix), n_users,
                                          fmt, capacity=capacity, with_time=with_time)

    @staticmethod
    def from_dataframe(df, n_users: int, fmt: str, capacity: int = -1,
                       with_time: bool = False) -> "UserHistory":
        """Build from a T1/T3 (one row per interaction) or T5/T6 (item_seq
        column) table; keeps the LAST ``capacity`` items per user and, for
        duplicate user rows, the later row. ``with_time``: also the time
        rows, from T6's time_seq or T3's rating (zeros for other formats)."""
        seqs = [None] * n_users
        tseqs = [None] * n_users
        if fmt in (DataFormat.T5.value, DataFormat.T6.value,
                   DataFormat.T5_1.value):
            times = df["time_seq"] if with_time and fmt == DataFormat.T6.value \
                else [None] * len(df)
            for uid, seq, t in zip(df["user_id"].to_numpy(), df["item_seq"], times):
                if 0 <= int(uid) < n_users:
                    seqs[int(uid)] = np.asarray(seq, dtype=np.int64)
                    tseqs[int(uid)] = None if t is None else np.asarray(t, dtype=np.int64)
        elif fmt in (DataFormat.T1.value, DataFormat.T3.value):
            grouped = df.groupby("user_id")["item_id"].apply(np.asarray)
            for uid, items in grouped.items():
                if 0 <= uid < n_users:
                    seqs[uid] = items
            if with_time and fmt == DataFormat.T3.value:
                for uid, t in df.groupby("user_id")["rating"].apply(np.asarray).items():
                    if 0 <= uid < n_users:
                        tseqs[uid] = t
        else:
            raise ValueError(f"unsupported user history format: {fmt}")
        max_len = max((len(s) for s in seqs if s is not None), default=1)
        if capacity is not None and capacity > 0:
            max_len = min(max_len, capacity)
        items = np.zeros((n_users, max(max_len, 1)), dtype=np.int32)
        lengths = np.zeros(n_users, dtype=np.int32)
        times = np.zeros_like(items) if with_time else None
        for uid, s in enumerate(seqs):
            if s is None or len(s) == 0:
                continue
            s = s[-max_len:]
            items[uid, :len(s)] = s
            lengths[uid] = len(s)
            if with_time and tseqs[uid] is not None:
                t = tseqs[uid][-max_len:]
                times[uid, :len(t)] = t
        return UserHistory(items, lengths, times)

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

    def contains(self, user_ids: np.ndarray, item_ids: np.ndarray) -> np.ndarray:
        """result[i, ...] = item_ids[i, ...] in history(user_ids[i]);
        item_ids [B] or [B, K]; item 0 never counts."""
        if self._sorted is None:
            self._sorted = np.sort(self.items, axis=1)
        rows = self._sorted[np.clip(user_ids, 0, self.n_users - 1)]
        squeeze = item_ids.ndim == 1
        q = item_ids[:, None] if squeeze else item_ids
        idx = np.empty(q.shape, dtype=np.int64)
        for b in range(0, rows.shape[0], 8192):   # chunks bound the temporaries
            sl = slice(b, min(b + 8192, rows.shape[0]))
            idx[sl] = _rowwise_searchsorted(rows[sl], q[sl])
        idx = np.minimum(idx, rows.shape[1] - 1)
        found = (np.take_along_axis(rows, idx, axis=1) == q) & (q > 0)
        found &= ((user_ids >= 0) & (user_ids < self.n_users))[:, None]
        return found[:, 0] if squeeze else found

    def sequence_batch(self, user_ids: np.ndarray, target_items: np.ndarray,
                       max_seq_len: int, mask_mode: str = HistoryMaskMode.UNORDER.value,
                       seq_last: bool = False, rng: Optional[np.random.Generator] = None,
                       explicit_max_len: Optional[np.ndarray] = None,
                       with_time: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """(item_seq [B, max_seq_len] left-padded, item_seq_len [B],
        time_seq: the same window of the time rows with ``with_time`` and
        times, else None) as AddUserHistory + SeqRecDataset._padding build
        them:

        - unorder: occurrences of the target(s) are zeroed in place
          (adduserhistory.py:50-55);
        - autoregressive: the history is cut before a random (or, with
          ``seq_last``, the last) occurrence of the target
          (adduserhistory.py:56-73), or at an explicit per-row max_len;
        - the last ``max_seq_len`` items are right-aligned in a zero-padded
          window; item_seq_len = min(prefix length, max_seq_len)."""
        rows, lens = self.gather(user_ids)
        trows = self.times[np.clip(user_ids, 0, self.n_users - 1)] \
            if with_time and self.times is not None else None
        tgt = target_items if target_items.ndim == 2 else target_items[:, None]
        is_tgt = (rows[:, :, None] == tgt[:, None, :]).any(-1) & (rows > 0)
        if mask_mode == HistoryMaskMode.UNORDER.value:
            rows = np.where(is_tgt, 0, rows)
            if trows is not None:
                trows = np.where(is_tgt, 0, trows)
            n = lens
        elif mask_mode == HistoryMaskMode.AUTOREGRESSIVE.value:
            if explicit_max_len is not None:
                n = np.minimum(explicit_max_len.astype(np.int64), lens)
            else:
                pos_mask = is_tgt & (np.arange(rows.shape[1])[None, :] < lens[:, None])
                counts = pos_mask.sum(1)
                if seq_last:
                    rev_first = rows.shape[1] - 1 - pos_mask[:, ::-1].argmax(1)
                    n = np.where(counts > 0, rev_first, lens)
                else:
                    rng = rng or np.random.default_rng(0)
                    r = rng.integers(0, np.maximum(counts, 1))
                    sel = (np.cumsum(pos_mask, axis=1) > r[:, None]) & pos_mask
                    n = np.where(counts > 0, sel.argmax(1), lens)
        else:
            raise ValueError(f"unknown history mask mode: {mask_mode}")
        L = max_seq_len
        grid = n[:, None] - L + np.arange(L)[None, :]
        valid = grid >= 0
        gi = np.clip(grid, 0, max(rows.shape[1] - 1, 0))
        seq = np.take_along_axis(rows, gi, axis=1) * valid
        tseq = None if trows is None else np.take_along_axis(trows, gi, axis=1) * valid
        return seq.astype(np.int32), np.minimum(n, L).astype(np.int32), tseq


def _rowwise_searchsorted(rows: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Per-row searchsorted through one flat searchsorted over offset rows."""
    B, C = rows.shape
    span = max(int(rows.max(initial=0)), int(queries.max(initial=0))) + 2
    offs = (np.arange(B, dtype=np.int64) * span)[:, None]
    flat = (rows.astype(np.int64) + offs).ravel()
    q = queries.astype(np.int64) + offs
    idx = np.searchsorted(flat, q.ravel()).reshape(q.shape) - np.arange(B)[:, None] * C
    return np.clip(idx, 0, C)
