"""Dataset preprocessing: raw interaction logs -> framework files (the port's
copy of unirec_tpu/data/prepare.py; pandas is imported inside the functions).

Capability parity with the reference's examples/preprocess/prepare_data.py:
raw (user, item[, rating, timestamp]) rows are id-indexed from 1 (0 is the
padding id), split leave-one-out per user (last interaction -> test,
second-to-last -> valid, prepare_data.py:123-125), and written as
train/valid/test tables + a T5 ``user_history`` file + the ``data.info``
JSON that the config loader consumes (prepare_data.py:176-236). Optional
static negative sampling materializes one-vs-k evaluation files
(prepare_data.py:210-224).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from unirec_tpu_torch.utils import file_io


def prepare_data(raw_file: str, out_dir: str, sep: str = "\t",
                 user_col: str = "user_id", item_col: str = "item_id",
                 time_col: Optional[str] = None, min_inter: int = 3,
                 n_neg_k: int = 0, seed: int = 2022,
                 index_from_zero: bool = True,
                 libfm: bool = False) -> Dict[str, Any]:
    """Returns the written data.info dict."""
    import pandas as pd

    if raw_file.endswith((".csv",)):
        df = pd.read_csv(raw_file)
    else:
        df = pd.read_csv(raw_file, sep=sep)
    if user_col not in df.columns:  # headerless fallback
        df = pd.read_csv(raw_file, sep=sep, header=None)
        names = [user_col, item_col] + ([time_col] if time_col else [])
        df.columns = names + [f"extra_{i}" for i in range(len(df.columns) - len(names))]

    if time_col and time_col in df.columns:
        df = df.sort_values([user_col, time_col], kind="stable")

    # drop users with too-few interactions to split leave-one-out
    counts = df.groupby(user_col)[item_col].transform("size")
    df = df[counts >= max(min_inter, 3)]

    # contiguous 1-based ids; 0 reserved for padding (prepare_data.py:86-121)
    if index_from_zero:
        uids = {u: i + 1 for i, u in enumerate(pd.unique(df[user_col]))}
        iids = {t: i + 1 for i, t in enumerate(pd.unique(df[item_col]))}
        df = df.assign(**{user_col: df[user_col].map(uids),
                          item_col: df[item_col].map(iids)})
    n_users = int(df[user_col].max()) + 1
    n_items = int(df[item_col].max()) + 1

    grouped = df.groupby(user_col)[item_col].apply(
        lambda x: np.asarray(x, dtype=np.int64))
    train_rows, valid_rows, test_rows, hist_users, hist_seqs = [], [], [], [], []
    rng = np.random.default_rng(seed)
    all_items = np.arange(1, n_items)
    for u, seq in grouped.items():
        train_seq, v_item, t_item = seq[:-2], seq[-2], seq[-1]
        hist_users.append(u)
        hist_seqs.append(train_seq)
        train_rows.extend((u, it) for it in train_seq)
        valid_rows.append((u, v_item))
        test_rows.append((u, t_item))

    os.makedirs(out_dir, exist_ok=True)
    pd.DataFrame(train_rows, columns=["user_id", "item_id"]).to_pickle(
        os.path.join(out_dir, "train.pkl"))
    pd.DataFrame(valid_rows, columns=["user_id", "item_id"]).to_pickle(
        os.path.join(out_dir, "valid.pkl"))
    pd.DataFrame(test_rows, columns=["user_id", "item_id"]).to_pickle(
        os.path.join(out_dir, "test.pkl"))
    pd.DataFrame({"user_id": hist_users, "item_seq": hist_seqs}).to_pickle(
        os.path.join(out_dir, "user_history.pkl"))

    if n_neg_k > 0:
        # static one-vs-k files (T4): 1 positive + n_neg_k sampled negatives
        for split, rows in (("valid", valid_rows), ("test", test_rows)):
            t4 = []
            for u, pos in rows:
                seen = set(grouped[u].tolist())
                negs = []
                while len(negs) < n_neg_k:
                    cand = int(rng.choice(all_items))
                    if cand != pos and cand not in seen:
                        negs.append(cand)
                t4.append((u, np.asarray([pos] + negs, np.int64),
                           np.asarray([1.0] + [0.0] * n_neg_k, np.float32)))
            pd.DataFrame(t4, columns=["user_id", "item_id_list", "label_list"]) \
                .to_pickle(os.path.join(out_dir, f"{split}_k.pkl"))

    if libfm:
        # T7 libFM-style rows (role of the reference's
        # specific_datasets/fmlp.py converters): feature ids are 1+user and
        # 1+n_users+item (0 reserved); groups of 1+n_neg_k with pos first
        if n_neg_k <= 0:
            raise ValueError("libfm output requires n_neg_k > 0 (grouped rows)")
        for split in ("valid", "test"):
            t4 = pd.read_pickle(os.path.join(out_dir, f"{split}_k.pkl"))
            rows = []
            for u, items, labels in zip(t4["user_id"], t4["item_id_list"],
                                        t4["label_list"]):
                for it, lab in zip(items, labels):
                    rows.append((float(lab),
                                 np.asarray([1 + u, 1 + n_users + it], np.int64),
                                 np.asarray([1.0, 1.0], np.float32)))
            pd.DataFrame(rows, columns=["label", "index_list", "value_list"]) \
                .to_pickle(os.path.join(out_dir, f"libfm_{split}.pkl"))
        train_fm = [(1.0, np.asarray([1 + u, 1 + n_users + it], np.int64),
                     np.asarray([1.0, 1.0], np.float32))
                    for u, it in train_rows]
        pd.DataFrame(train_fm, columns=["label", "index_list", "value_list"]) \
            .to_pickle(os.path.join(out_dir, "libfm_train.pkl"))

    info = {
        "n_users": n_users, "n_items": n_items,
        "n_feats": 1 + n_users + n_items,
        "train_file_format": "user-item",
        "valid_file_format": "user-item",
        "test_file_format": "user-item",
        "user_history_file_format": "user-item_seq",
    }
    file_io.save_data_info(out_dir, info)
    return info


def convert_splits(split_dir: str, out_dir: str,
                   max_len_col: bool = False) -> Dict[str, Any]:
    """Convert pre-split tsv artifacts (the data/downloaders.py output set -
    train/valid/test.csv + user_history.csv, matching the reference's
    download_split_*.py layout) into training-ready pkl + data.info.

    This is the chaining link the reference implements by running
    prepare_data.py on each split file
    (examples/preprocess/run_prepare_data-ml-100k.sh)."""
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    n_users = n_items = 0
    for split in ("train", "valid", "test"):
        df = pd.read_csv(os.path.join(split_dir, f"{split}.csv"), sep="\t")
        cols = ["user_id", "item_id"] + (
            ["max_len"] if max_len_col and "max_len" in df.columns else [])
        df[cols].to_pickle(os.path.join(out_dir, f"{split}.pkl"))
        n_users = max(n_users, int(df["user_id"].max()) + 1)
        n_items = max(n_items, int(df["item_id"].max()) + 1)
    hist = pd.read_csv(os.path.join(split_dir, "user_history.csv"), sep="\t")
    hist["item_seq"] = hist["item_seq"].apply(
        lambda s: np.asarray([int(x) for x in str(s).split(",")], np.int64))
    hist.to_pickle(os.path.join(out_dir, "user_history.pkl"))
    n_items = max(n_items, int(max(
        (s.max() for s in hist["item_seq"] if len(s)), default=0)) + 1)
    fmt = "user-item-max_len" if max_len_col else "user-item"
    info = {
        "n_users": n_users, "n_items": n_items,
        "n_feats": 1 + n_users + n_items,
        "train_file_format": fmt,
        "valid_file_format": fmt,
        "test_file_format": fmt,
        "user_history_file_format": "user-item_seq",
    }
    file_io.save_data_info(out_dir, info)
    return info


def convert_adjacency(split_dir: str, out_dir: str, sep: str = " ",
                      index_from_zero: bool = True) -> Dict[str, Any]:
    """Convert pre-split adjacency text files into training-ready pkls.

    The CF benchmark datasets (yelp2018 / gowalla / amazon-book) ship as
    ``train.txt / val.txt / test.txt`` where each line is
    ``user item item item ...`` - the format the reference ingests with
    per-file ``*_file_format='user_item_seq'`` flags
    (examples/preprocess/run_prepare_data-CF_8_1_1.sh:29-50 driving
    preprocess/prepare_data.py). Output: T1 exploded train rows (so every
    dataloader works), T5 ``user-item_seq`` valid/test (multi-positive
    one_vs_all evaluation), ``user_history.pkl`` from train, ``data.info``.

    ``index_from_zero`` shifts raw 0-based ids up by one so id 0 stays the
    padding slot, mirroring prepare_data's convention above.
    """
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    shift = 1 if index_from_zero else 0
    names = {"train": "train.txt", "valid": "val.txt", "test": "test.txt"}
    seqs: Dict[str, Dict[int, np.ndarray]] = {}
    n_users = n_items = 0
    for split, fname in names.items():
        path = os.path.join(split_dir, fname)
        if split != "train" and not os.path.exists(path):
            continue
        rows: Dict[int, np.ndarray] = {}
        with open(path) as f:
            for line in f:
                parts = line.split(sep if sep != " " else None)
                if not parts or parts[0] == "":
                    continue
                u = int(parts[0]) + shift
                items = np.asarray([int(t) + shift for t in parts[1:]],
                                   np.int64)
                if len(items) == 0:
                    continue
                # a user id may span multiple lines (malformed or chunked
                # exports): concatenate rather than overwrite the earlier
                # line's interactions
                if u in rows:
                    items = np.concatenate([rows[u], items])
                rows[u] = items
                n_users = max(n_users, u + 1)
                n_items = max(n_items, int(items.max()) + 1)
        seqs[split] = rows

    train = seqs["train"]
    t_rows = [(u, int(it)) for u, items in train.items() for it in items]
    pd.DataFrame(t_rows, columns=["user_id", "item_id"]).to_pickle(
        os.path.join(out_dir, "train.pkl"))
    pd.DataFrame({"user_id": list(train), "item_seq": list(train.values())}) \
        .to_pickle(os.path.join(out_dir, "user_history.pkl"))
    for split in ("valid", "test"):
        rows = seqs.get(split, {})
        pd.DataFrame({"user_id": list(rows),
                      "item_seq": list(rows.values())}).to_pickle(
            os.path.join(out_dir, f"{split}.pkl"))

    info = {
        "n_users": n_users, "n_items": n_items,
        "n_feats": 1 + n_users + n_items,
        "train_file_format": "user-item",
        "valid_file_format": "user-item_seq",
        "test_file_format": "user-item_seq",
        "user_history_file_format": "user-item_seq",
    }
    file_io.save_data_info(out_dir, info)
    return info
