"""Table readers for the formats the port consumes, and the pretrained
item-embedding reader (subset of unirec_tpu/utils/file_io.py). pandas is
imported only inside the readers that build DataFrames, so the card path
needs it only when it reads one."""
from __future__ import annotations

import ast
import os
import pickle
from typing import Any, List

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
    """A headered tsv/csv table with its list columns parsed."""
    import pandas as pd

    sep = "\t" if path.endswith((".tsv", ".txt")) else ","
    df = pd.read_csv(path, sep=sep)
    for col in df.columns:
        if col in _LIST_INT_COLS:
            df[col] = df[col].apply(lambda c: _parse_list(c, np.int64))
        elif col in _LIST_FLOAT_COLS:
            df[col] = df[col].apply(lambda c: _parse_list(c, np.float32))
    return df


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
