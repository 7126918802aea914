"""Column-oriented datasets (copy of unirec_tpu/data/datasets.py).

Interactions are normalized at load time into numpy columns with static
widths, so batch assembly is slicing and vectorized ops (basedataset.py):
  - T5/T6 rows expand to one row per interaction for training and one-vs-k
    evaluation (basedataset.py:41-45), else keep their padded item groups
    (T6 also its padded ``time_seq_raw``);
  - rows with label 0 are dropped for the one_vs_all / one_vs_k protocols
    on T2/T2_1 (basedataset.py:48-54);
  - T7 (libFM) rows keep their padded ``index_list`` / ``value_list`` and
    their lengths (``feat_len``);
  - unlabeled formats get an implicit positive label at batch assembly.
AERecDataset groups the training split per user (one deduplicated history
row each) and gives the solvers its graph; RankDataset folds ``group_size``
consecutive rows into one. Text tables are read by the native parser into
packed arrays and normalized from those without per-row Python
(``_normalize_packed``, as in the JAX package); binary tables and text the
parser declines go through a DataFrame (``_normalize``). Both give the same
columns, and both regroup for AERecDataset and RankDataset (the JAX
package's packed path skips those two regroupings: ROADMAP.md Queue 3
item 8).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from unirec_tpu_torch.constants import DataFormat, EvalProtocol
from unirec_tpu_torch.utils import file_io

_DATASETS: Dict[str, type] = {}


def register_dataset(name: str):
    def deco(cls):
        _DATASETS[name] = cls
        return cls
    return deco


def get_dataset_class(name: str) -> type:
    if name not in _DATASETS:
        raise ValueError(f"unknown dataset class '{name}'. Registered: {sorted(_DATASETS)}")
    return _DATASETS[name]


def _pad_group(arrs, dtype) -> np.ndarray:
    """Ragged rows right-padded with 0 to the longest."""
    out = np.zeros((len(arrs), max((len(a) for a in arrs), default=1)), dtype=dtype)
    for i, a in enumerate(arrs):
        out[i, :len(a)] = a
    return out


@register_dataset("BaseDataset")
class BaseDataset:
    """Normalized interaction columns: ``cols`` holds user_id, item_id
    ([N] or [N, P] padded groups) and, by format, label, session_id,
    rating, max_len; ``fmt`` is the format after normalization."""

    is_sequential = False

    def __init__(self, config: Dict[str, Any], path: str, filename: str):
        self.config = config
        self.task = config.get("data_loader_task", "train")
        self.eval_protocol = config.get("eval_protocol")
        self.fmt = config["data_format"]
        packed = file_io.load_table_packed(os.path.join(path, filename))
        if packed is not None:
            self._normalize_packed(packed)
        else:
            self._normalize(file_io.load_table(os.path.join(path, filename)))

    def _normalize_packed(self, packed):
        """``_normalize`` on the native parser's packed columns, vectorized
        (unirec_tpu/data/datasets.py:66-119)."""
        from unirec_tpu_torch.utils.fastio import pad_packed
        fmt = self.fmt
        sc, ls = packed["scalars"], packed["lists"]
        cols: Dict[str, np.ndarray] = {}
        if fmt in (DataFormat.T5.value, DataFormat.T6.value):
            flat, lens = ls["item_seq"]
            if self.task == "train" or self.eval_protocol == EvalProtocol.ONE_VS_K.value:
                cols["user_id"] = np.repeat(sc["user_id"], lens).astype(np.int64)
                cols["item_id"] = flat.astype(np.int64)
                self.fmt = DataFormat.T1.value
            else:
                cols["user_id"] = sc["user_id"].astype(np.int64)
                cols["item_id"] = pad_packed(flat, lens, np.int64)
                if fmt == DataFormat.T6.value and "time_seq" in ls:
                    cols["time_seq_raw"] = pad_packed(*ls["time_seq"], np.int64)
        elif fmt == DataFormat.T7.value:
            cols["label"] = sc["label"].astype(np.float32)
            fi, li = ls["index_list"]
            cols["index_list"] = pad_packed(fi, li, np.int64)
            cols["value_list"] = pad_packed(*ls["value_list"], np.float32)
            cols["feat_len"] = li.astype(np.int32)
        elif fmt == DataFormat.T4.value:
            cols["user_id"] = sc["user_id"].astype(np.int64)
            cols["item_id"] = pad_packed(*ls["item_id_list"], np.int64)
            fl, ll = ls["label_list"]
            cols["label"] = pad_packed(fl.astype(np.float32), ll, np.float32)
        else:
            cols["user_id"] = sc["user_id"].astype(np.int64)
            cols["item_id"] = sc["item_id"].astype(np.int64)
            if fmt in (DataFormat.T2.value, DataFormat.T2_1.value) and "label" in sc:
                cols["label"] = sc["label"].astype(np.float32)
            if fmt == DataFormat.T2_1.value and "session_id" in sc:
                cols["session_id"] = sc["session_id"].astype(np.int64)
            if fmt == DataFormat.T3.value and "rating" in sc:
                cols["rating"] = sc["rating"].astype(np.float32)
            if fmt == DataFormat.T1_1.value and "max_len" in sc:
                cols["max_len"] = sc["max_len"].astype(np.int64)
        self._finish(cols)

    def _normalize(self, df):
        fmt = self.fmt
        cols: Dict[str, np.ndarray] = {}
        if fmt in (DataFormat.T5.value, DataFormat.T6.value):
            if self.task == "train" or self.eval_protocol == EvalProtocol.ONE_VS_K.value:
                seqs = [np.asarray(s, dtype=np.int64) for s in df["item_seq"]]
                users = df["user_id"].to_numpy(np.int64)
                cols["user_id"] = np.repeat(users, [len(s) for s in seqs])
                cols["item_id"] = (np.concatenate(seqs) if seqs
                                   else np.zeros(0, np.int64))
                self.fmt = DataFormat.T1.value
            else:
                cols["user_id"] = df["user_id"].to_numpy(np.int64)
                cols["item_id"] = _pad_group(df["item_seq"].tolist(), np.int64)
                if fmt == DataFormat.T6.value and "time_seq" in df:
                    cols["time_seq_raw"] = _pad_group(df["time_seq"].tolist(), np.int64)
        elif fmt == DataFormat.T7.value:
            cols["label"] = df["label"].to_numpy(np.float32)
            cols["index_list"] = _pad_group(df["index_list"].tolist(), np.int64)
            cols["value_list"] = _pad_group(df["value_list"].tolist(), np.float32)
            cols["feat_len"] = np.asarray([len(a) for a in df["index_list"]], np.int32)
        elif fmt == DataFormat.T4.value:
            cols["user_id"] = df["user_id"].to_numpy(np.int64)
            cols["item_id"] = _pad_group(df["item_id_list"].tolist(), np.int64)
            cols["label"] = _pad_group(df["label_list"].tolist(), np.float32)
        else:
            cols["user_id"] = df["user_id"].to_numpy(np.int64)
            cols["item_id"] = df["item_id"].to_numpy(np.int64)
            if fmt in (DataFormat.T2.value, DataFormat.T2_1.value) and "label" in df:
                cols["label"] = df["label"].to_numpy(np.float32)
            if fmt == DataFormat.T2_1.value and "session_id" in df:
                cols["session_id"] = df["session_id"].to_numpy(np.int64)
            if fmt == DataFormat.T3.value and "rating" in df:
                cols["rating"] = df["rating"].to_numpy(np.float32)
            if fmt == DataFormat.T1_1.value and "max_len" in df:
                cols["max_len"] = df["max_len"].to_numpy(np.int64)
        self._finish(cols)

    def _finish(self, cols: Dict[str, np.ndarray]) -> None:
        """Drop label-0 rows for the one_vs_all / one_vs_k protocols on
        T2/T2_1 and keep the columns."""
        if self.eval_protocol in (EvalProtocol.ONE_VS_ALL.value, EvalProtocol.ONE_VS_K.value) \
                and "label" in cols and cols["label"].ndim == 1 \
                and self.fmt in (DataFormat.T2.value, DataFormat.T2_1.value):
            keep = cols["label"] > 0
            cols = {k: v[keep] for k, v in cols.items()}
        self.cols = cols
        self.n_rows = next(iter(cols.values())).shape[0] if cols else 0

    def __len__(self) -> int:
        return self.n_rows


@register_dataset("SeqRecDataset")
class SeqRecDataset(BaseDataset):
    """Adds item_seq / item_seq_len at batch assembly (data/pipeline.py,
    from the packed UserHistory)."""

    is_sequential = True


@register_dataset("AERecDataset")
class AERecDataset(SeqRecDataset):
    """Autoencoder training rows (aerecdataset.py:17-60): the training split
    grouped per user into ``user_id``, a right-padded deduplicated (sorted)
    ``hist`` matrix and ``hist_len``, format ``aerec-train``; T4 groups are
    exploded first and T2/T2_1 rows with label 0 dropped. Evaluation splits
    are SeqRecDataset's. (The JAX package's packed text reader bypasses
    this grouping for .tsv/.csv/.txt tables, unirec_tpu/data/datasets.py:
    59-61; the port groups every table.)"""

    def _normalize_packed(self, packed):
        if self.task != "train":
            super()._normalize_packed(packed)
            return
        from unirec_tpu_torch.utils.fastio import packed_frame
        self._normalize(packed_frame(packed))

    def _normalize(self, df):
        if self.task != "train":
            super()._normalize(df)
            return
        fmt = self.fmt
        if fmt == DataFormat.T4.value:
            df = df.explode(["item_id_list", "label_list"]).rename(
                columns={"item_id_list": "item_id", "label_list": "label"})
            fmt = DataFormat.T2.value
        if fmt in (DataFormat.T2.value, DataFormat.T2_1.value):
            df = df[df["label"] > 0]
        if fmt in (DataFormat.T1.value, DataFormat.T1_1.value, DataFormat.T2.value,
                   DataFormat.T2_1.value, DataFormat.T3.value):
            grouped = df.groupby("user_id")["item_id"].apply(
                lambda x: np.unique(np.asarray(x, dtype=np.int64)))
            users = grouped.index.to_numpy(np.int64)
            hists = grouped.tolist()
        elif fmt in (DataFormat.T5.value, DataFormat.T6.value):
            users = df["user_id"].to_numpy(np.int64)
            hists = [np.unique(np.asarray(s, dtype=np.int64)) for s in df["item_seq"]]
        else:
            raise NotImplementedError(f"AERecDataset does not support format {fmt}")
        self.cols = {"user_id": users, "hist": _pad_group(hists, np.int64),
                     "hist_len": np.asarray([len(h) for h in hists], np.int32)}
        self.n_rows = len(users)
        self.fmt = "aerec-train"

    def get_graph(self):
        """The training split's user-item graph as a scipy CSR [n_users,
        n_items] of float64 ones (aerecdataset.py:85-117); duplicate pairs
        are summed."""
        import scipy.sparse as ssp

        if self.fmt != "aerec-train":
            raise ValueError("graph is only available for the training split")
        users = np.repeat(self.cols["user_id"], self.cols["hist_len"].astype(np.int64))
        mask = np.arange(self.cols["hist"].shape[1])[None, :] < self.cols["hist_len"][:, None]
        items = self.cols["hist"][mask]
        return ssp.csr_matrix((np.ones(len(users)), (users, items)),
                              shape=(int(self.config["n_users"]), int(self.config["n_items"])))


@register_dataset("RankDataset")
class RankDataset(BaseDataset):
    """Folds ``group_size`` consecutive rows into one sample
    (rankdataset.py:25-52), for T7 (libFM) and the labeled formats; the
    rows past the last whole group are dropped, and user_id / session_id
    keep the group's first value (the whole group under ``<key>_group``)."""

    def _normalize(self, df):
        super()._normalize(df)
        self._group()

    def _normalize_packed(self, packed):
        super()._normalize_packed(packed)
        self._group()

    def _group(self):
        g = int(self.config.get("group_size", -1))
        if g <= 1:
            return
        n = (self.n_rows // g) * g
        cols = {k: v[:n].reshape(n // g, g, *v.shape[1:]) for k, v in self.cols.items()}
        for k in ("user_id", "session_id"):
            if k in cols:
                cols[k + "_group"] = cols[k]
                cols[k] = cols[k][:, 0]
        self.cols = cols
        self.n_rows = n // g
