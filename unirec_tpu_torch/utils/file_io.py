"""Table readers for the formats the port consumes, the pretrained
item-embedding reader and the item-feature reader (subset of
unirec_tpu/utils/file_io.py). Text tables go through the native parser
(utils/fastio.py) first, as in the JAX package, and through pandas where it
declines. pandas is imported only inside the readers that build
DataFrames, so the card path needs it only when it reads one;
``load_features`` reads text files with the csv module alone."""
from __future__ import annotations

import ast
import csv
import json
import os
import pickle
from typing import Any, Dict, List

import numpy as np

# Columns that hold space/comma separated integer or float lists in text files.
_LIST_INT_COLS = {"item_seq", "time_seq", "item_id_list", "label_list", "index_list"}
_LIST_FLOAT_COLS = {"value_list"}


def _parse_list(cell: Any, dtype) -> np.ndarray:
    if isinstance(cell, np.ndarray):
        return cell.astype(dtype)
    if isinstance(cell, (list, tuple)):
        return np.asarray(cell, dtype=dtype)
    s = str(cell).strip()
    if s.startswith("["):
        return np.asarray(ast.literal_eval(s), dtype=dtype)
    sep = "," if "," in s else " "
    return np.asarray([t for t in s.split(sep) if t], dtype=dtype)


def load_txt_table(path: str):
    """A headered tsv/csv table with its list columns parsed: the native
    parser's frame, or where it declines (bracket lists, string columns,
    missing cells) or ``UNIREC_FASTIO=0``, pandas' (the same frame)."""
    import pandas as pd

    from unirec_tpu_torch.utils.fastio import load_txt_table_native
    native = load_txt_table_native(path, _LIST_INT_COLS, _LIST_FLOAT_COLS)
    if native is not None:
        return native
    sep = "\t" if path.endswith((".tsv", ".txt")) else ","
    df = pd.read_csv(path, sep=sep)
    for col in df.columns:
        if col in _LIST_INT_COLS:
            df[col] = df[col].apply(lambda c: _parse_list(c, np.int64))
        elif col in _LIST_FLOAT_COLS:
            df[col] = df[col].apply(lambda c: _parse_list(c, np.float32))
    return df


def load_table_packed(path_prefix: str):
    """The native parser's packed arrays of the TEXT table
    ``<prefix>.{tsv,csv,txt}``; None for binary tables (``load_table``'s
    first match wins: a ``.ftr`` or ``.pkl`` beside the text file is the
    data) or where the parser declines."""
    from unirec_tpu_torch.utils.fastio import load_txt_table_packed

    if os.path.exists(path_prefix + ".ftr") or os.path.exists(path_prefix + ".pkl"):
        return None
    for ext in (".tsv", ".csv", ".txt"):
        if os.path.exists(path_prefix + ext):
            return load_txt_table_packed(path_prefix + ext, _LIST_INT_COLS, _LIST_FLOAT_COLS)
    if os.path.exists(path_prefix) and path_prefix.endswith((".tsv", ".csv", ".txt")):
        return load_txt_table_packed(path_prefix, _LIST_INT_COLS, _LIST_FLOAT_COLS)
    return None


def load_table(path_prefix: str):
    """Load ``<prefix>.{ftr,pkl,tsv,csv,txt}``; the first match wins
    (reference basedataset.py:209-231)."""
    import pandas as pd

    if os.path.exists(path_prefix + ".ftr"):
        return pd.read_feather(path_prefix + ".ftr")
    if os.path.exists(path_prefix + ".pkl"):
        with open(path_prefix + ".pkl", "rb") as f:
            obj = pickle.load(f)
        return obj if isinstance(obj, pd.DataFrame) else pd.DataFrame(obj)
    for ext in (".tsv", ".csv", ".txt"):
        if os.path.exists(path_prefix + ext):
            return load_txt_table(path_prefix + ext)
    raise FileNotFoundError(f"no data file found for prefix: {path_prefix}")


def save_data_info(dataset_path: str, info: Dict[str, Any]) -> None:
    """Write ``<dataset_path>/data.info``, the JSON the config loader reads."""
    os.makedirs(dataset_path, exist_ok=True)
    with open(os.path.join(dataset_path, "data.info"), "w") as f:
        json.dump(info, f, indent=2)


def load_pre_item_emb(path: str) -> np.ndarray:
    """Pretrained item embeddings: text lines of ``id<TAB>v1,v2,...`` (rows
    put in id order) or of whitespace-separated floats (reference
    file_io.load_pre_item_emb)."""
    rows: List[np.ndarray] = []
    ids: List[int] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if "\t" in line:
                iid, vec = line.split("\t", 1)
                ids.append(int(iid))
                rows.append(_parse_list(vec, np.float32))
            else:
                rows.append(np.asarray(line.split(), dtype=np.float32))
    emb = np.stack(rows)
    if ids:
        emb = emb[np.argsort(ids)]
    return emb


def load_features(path: str, n_items: int, n_features: int) -> np.ndarray:
    """Item -> categorical-feature table, int32 [n_items, n_features], the
    ids as the file holds them; row 0 (the padding item) and items the
    file does not name stay all zeros (unirec_tpu/utils/file_io.py:
    149-168). The file has an ``item_id`` column and the feature lists in
    the first other column (``3,67``, ``3 67`` or ``[3, 67]``); a path
    that does not exist is read as ``<stem>.{ftr,pkl,tsv,csv,txt}``.
    ``.tsv``/``.txt`` (tab) and ``.csv`` files are read without pandas;
    ``.pkl`` and ``.ftr`` DataFrames import it."""
    res = np.zeros((n_items, n_features), dtype=np.int32)
    if not os.path.exists(path):
        ids, cells = _feature_columns(load_table(os.path.splitext(path)[0]))
    elif path.endswith((".tsv", ".csv", ".txt")):
        with open(path, newline="") as f:
            rows = csv.reader(f, delimiter="," if path.endswith(".csv") else "\t")
            header = next(rows)
            i_id = header.index("item_id")
            i_feat = next(i for i, c in enumerate(header) if c != "item_id")
            body = [r for r in rows if r]
        ids = [int(r[i_id]) for r in body]
        cells = [r[i_feat] for r in body]
    elif path.endswith(".pkl"):
        with open(path, "rb") as f:
            ids, cells = _feature_columns(pickle.load(f))
    elif path.endswith(".ftr"):
        import pandas as pd
        ids, cells = _feature_columns(pd.read_feather(path))
    else:
        raise ValueError(f"unsupported feature file: {path}")
    for iid, cell in zip(ids, cells):
        arr = _parse_list(cell, np.int64)[:n_features]
        if 0 <= iid < n_items:
            res[iid, :len(arr)] = arr
    return res


def _feature_columns(df):
    """(item ids, feature cells) of a feature DataFrame."""
    col = [c for c in df.columns if c != "item_id"][0]
    return [int(i) for i in df["item_id"].to_numpy()], list(df[col])
