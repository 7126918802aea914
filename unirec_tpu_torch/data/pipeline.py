"""Batchers (counterpart of unirec_tpu/data/pipeline.py).

Evaluation reads static-shape host batches (``Batcher``, without the
prefetch thread): dicts of fixed-shape numpy arrays, with negative
sampling, history windows (and their T6 time windows under ``time_seq``),
the item-feature gathers and padding vectorized per batch; the
final partial batch is padded to the full batch size and flagged by a
per-row ``weight`` (1 real, 0 pad). T7 (libFM) rows pass their index,
value and label columns through; AERec training rows (``aerec-train``)
are the user's own history, cut at ``aerec_max_hist`` (pipeline.py:90-98).
Training runs on the device pipeline (data/device_pipeline.py):
``make_train_batcher`` returns the raw id batcher and the augmenter that
the train step applies, except for T7 rows, which have no device table to
gather from and train on shuffled host batches (main.py:326-343).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from unirec_tpu_torch.constants import EvalProtocol, HistoryMaskMode, LossType
from unirec_tpu_torch.data.datasets import BaseDataset
from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter, RawIdBatcher
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.data.sampler import NegativeSampler


class Batcher:
    def __init__(self, dataset: BaseDataset, config: Dict[str, Any],
                 history: Optional[UserHistory] = None,
                 sampler: Optional[NegativeSampler] = None,
                 batch_size: Optional[int] = None, seed: int = 2022,
                 features: Optional[np.ndarray] = None, shuffle: bool = False):
        self.ds = dataset
        self.shuffle = shuffle
        self.features = features
        self.config = config
        self.history = history
        self.sampler = sampler
        self.batch_size = int(batch_size or config.get("batch_size", 256))
        # each __iter__ draws its negatives and autoregressive cuts from a
        # fresh rng of (seed, epoch): every pass is deterministic on its own
        self.seed = int(seed)
        self._epoch = 0
        self.max_seq_len = int(config.get("max_seq_len", 10))
        self.mask_mode = config.get("history_mask_mode", HistoryMaskMode.UNORDER.value)
        self.seq_last = bool(config.get("seq_last", 0))
        self.with_time = bool(config.get("time_seq", 0))
        self.pad_incomplete = bool(config.get("pad_incomplete_batch", True))

    def __len__(self) -> int:
        n, b = len(self.ds), self.batch_size
        if n == 0:
            return 0
        return -(-n // b) if self.pad_incomplete or n < b else n // b

    def set_epoch(self, epoch: int):
        """Fast-forward the per-epoch rng (auto_resume)."""
        self._epoch = int(epoch)

    def _next_rng(self) -> np.random.Generator:
        """This pass's generator, of (seed, epoch), and the next epoch."""
        rng = np.random.default_rng([self.seed, self._epoch])
        self._epoch += 1
        return rng

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = self._next_rng()
        n, b = len(self.ds), self.batch_size
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, b):
            idx = order[start:start + b]
            pad = b - len(idx)
            weight = np.ones(b, dtype=np.float32)
            if pad > 0:
                if not self.pad_incomplete and n >= b:
                    break
                weight[len(idx):] = 0.0
                idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            yield self._assemble(idx, weight, rng)

    def _assemble(self, idx: np.ndarray, weight: np.ndarray,
                  rng: np.random.Generator) -> Dict[str, np.ndarray]:
        cols = self.ds.cols
        if self.ds.fmt == "aerec-train":
            hist = cols["hist"][idx]
            cap = int(self.config.get("aerec_max_hist", hist.shape[1]) or hist.shape[1])
            batch = {"weight": weight, "user_id": cols["user_id"][idx].astype(np.int32),
                     "item_seq": hist[:, :cap].astype(np.int32),
                     "item_seq_len": np.minimum(cols["hist_len"][idx], cap).astype(np.int32)}
            if self.features is not None:
                batch["item_seq_features"] = self.features[batch["item_seq"]]
            return batch
        if "index_list" in cols:        # T7 libFM rows
            batch = {"weight": weight, **{k: cols[k][idx] for k in
                                          ("index_list", "value_list", "label")}}
            batch["label"] = batch["label"].astype(np.float32)
            if "session_id" in cols:
                batch["session_id"] = cols["session_id"][idx].astype(np.int64)
            return batch
        user_id = cols["user_id"][idx].astype(np.int64)
        item_id = cols["item_id"][idx]
        label = cols.get("label")
        label = None if label is None else label[idx]
        if self.sampler is not None:
            # dynamic negatives -> grouped items and labels, positives first
            pos = item_id
            negs = self.sampler(rng, user_id, pos)
            item_id = np.concatenate([pos if pos.ndim == 2 else pos[:, None], negs], axis=1)
            lab = np.zeros(item_id.shape, dtype=np.float32)
            p = pos.shape[1] if pos.ndim == 2 else 1
            if label is not None and label.ndim == 1:
                lab[:, 0] = label
            else:
                lab[:, :p] = 1.0 if label is None else label
            label = lab
        elif label is None:
            # implicit positive label (basedataset.py:138-148)
            if item_id.ndim == 2:
                label = np.zeros(item_id.shape, dtype=np.float32)
                label[:, 0] = 1.0
            else:
                label = np.ones(len(idx), dtype=np.float32)
        batch = {"weight": weight, "user_id": user_id.astype(np.int32),
                 "item_id": item_id.astype(np.int32), "label": label.astype(np.float32)}
        for k in ("session_id", "max_len"):
            if k in cols:
                batch[k] = cols[k][idx].astype(np.int64)
        if self.features is not None:
            batch["item_features"] = self.features[batch["item_id"]]
        if self.ds.is_sequential and self.history is not None:
            seq, batch["item_seq_len"], tseq = self.history.sequence_batch(
                user_id, cols["item_id"][idx], self.max_seq_len,
                mask_mode=self.mask_mode, seq_last=self.seq_last, rng=rng,
                explicit_max_len=batch.get("max_len"), with_time=self.with_time)
            batch["item_seq"] = seq
            if tseq is not None:
                batch["time_seq"] = tseq
            if self.features is not None:
                batch["item_seq_features"] = self.features[seq]
        return batch


def make_train_batcher(dataset: BaseDataset, config: Dict[str, Any],
                       history: Optional[UserHistory], item_popularity=None, device=None,
                       features=None) -> Tuple[Any, Optional[DeviceAugmenter]]:
    """(batcher, augmenter). On the device pipeline the host yields the
    dataset's (user, item) id columns and negative sampling and history
    windows run on the device in the train step
    (``Trainer.set_device_augmenter``); AERec rows read the training
    split's own deduplicated histories, scattered into a user-indexed
    matrix (main.py:220-245). T7 rows: shuffled host batches and no
    augmenter."""
    cols = dataset.cols
    seed, bs = int(config.get("seed", 2022)), int(config.get("batch_size", 256))
    shuffle = bool(config.get("shuffle_train", 0))
    if "index_list" in cols:
        return Batcher(dataset, config, batch_size=bs, seed=seed, shuffle=shuffle), None
    aerec = dataset.fmt == "aerec-train"
    if aerec:
        n_users = int(config["n_users"])
        mat = np.zeros((n_users, cols["hist"].shape[1]), np.int32)
        lens = np.zeros(n_users, np.int32)
        mat[cols["user_id"]] = cols["hist"]
        lens[cols["user_id"]] = cols["hist_len"]
        history = UserHistory(mat, lens)
    elif history is None:
        raise ValueError("training needs the user histories (user_history_filename)")
    batcher = RawIdBatcher(cols["user_id"],
                           np.zeros_like(cols["user_id"]) if aerec else cols["item_id"], bs,
                           seed=seed, shuffle=shuffle,
                           extra={k: cols[k] for k in ("label", "max_len") if k in cols})
    return batcher, DeviceAugmenter(config, history, item_popularity, features=features,
                                    aerec=aerec, device=device)


def make_negative_sampler(config: Dict[str, Any], history: Optional[UserHistory],
                          item_popularity=None, task: str = "train") -> Optional[NegativeSampler]:
    """The host sampler of ``n_sample_neg_{task}`` negatives a row (none for
    a full-softmax training loss), popularity-drawn under
    ``neg_by_pop_alpha`` (pipeline.py:240-253)."""
    n_neg = int(config.get(f"n_sample_neg_{task}", 0) or 0)
    if task == "train" and config.get("loss_type") == LossType.FULLSOFTMAX.value:
        n_neg = 0
    if n_neg <= 0:
        return None
    pop = item_popularity if float(config.get("neg_by_pop_alpha", 0) or 0) > 0 else None
    return NegativeSampler(config["n_items"], n_neg, user_history=history,
                           item_popularity=pop,
                           neg_by_pop_alpha=float(config.get("neg_by_pop_alpha", 1.0) or 1.0),
                           oversample_factor=int(config.get("neg_oversample_factor", 4)))


def make_host_train_batcher(dataset: BaseDataset, config: Dict[str, Any],
                            history: Optional[UserHistory], item_popularity=None,
                            features=None) -> Batcher:
    """Training rows as host batches with host-drawn negatives (the JAX
    package's make_train_batcher, pipeline.py:256-266, without its prefetch
    thread): MoRec's signal sweeps read the validation split through it."""
    return Batcher(dataset, config, history=history,
                   sampler=make_negative_sampler(config, history, item_popularity, "train"),
                   batch_size=config.get("batch_size"),
                   shuffle=bool(config.get("shuffle_train", 0)),
                   seed=int(config.get("seed", 2022)), features=features)


def make_eval_batcher(dataset: BaseDataset, config: Dict[str, Any],
                      history: Optional[UserHistory], task: str = "test",
                      item_popularity=None, features=None) -> Batcher:
    """Unshuffled batches of ``{task}_batch_size`` (else test_batch_size,
    else batch_size) rows; one_vs_k draws ``n_sample_neg_{task}`` negatives
    per row, one_vs_all none."""
    n_neg = int(config.get(f"n_sample_neg_{task}", 0) or 0)
    if (config.get("eval_protocol") or config.get(f"{task}_protocol")) \
            == EvalProtocol.ONE_VS_ALL.value:
        n_neg = 0
    sampler = None
    if n_neg > 0:
        pop = item_popularity if float(config.get("neg_by_pop_alpha", 0) or 0) > 0 else None
        sampler = NegativeSampler(config["n_items"], n_neg, user_history=history,
                                  item_popularity=pop,
                                  neg_by_pop_alpha=float(config.get("neg_by_pop_alpha", 1.0) or 1.0),
                                  oversample_factor=int(config.get("neg_oversample_factor", 4)))
    bs = config.get(f"{task}_batch_size") or config.get("test_batch_size") \
        or config.get("batch_size")
    return Batcher(dataset, config, history=history, sampler=sampler, batch_size=bs,
                   seed=int(config.get("seed", 2022)) + 17, features=features)
