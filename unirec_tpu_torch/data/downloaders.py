"""Dataset downloaders + raw-to-split converters (the port's copy of
unirec_tpu/data/downloaders.py; pandas is imported inside the functions).

Mirrors the reference's example preprocessing scripts
(examples/preprocess/download_split_ml100k.py:129-386,
download_split_ml10m.py:15-123, download_split_amazon.py:125-268,
specific_datasets/fmlp.py:8-41): download a public dataset, filter
(rating threshold, dedup, iterative k-core capped at 5 rounds), remap ids to
1-based contiguous ranges (0 reserved for padding), leave-one-out split, and
write the same artifact set:

    train.csv / valid.csv / test.csv      (tsv: user_id \t item_id [\t max_len])
    user_history.csv                      (tsv: user_id \t item_seq csv-string)
    full_user_history.csv                 (history incl. valid/test items)
    map.json                              (raw->new id maps)
    item2cate.json, item_meta_morec.csv   (category + MoRec meta)

The conversion logic is pure pandas/numpy and tested on synthetic raw
files; only ``download_file`` needs the network, and it raises a clear
error where there is none. Chain with data/prepare.py (the generic
raw-csv -> pkl + data.info converter) to produce training-ready datasets.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import TYPE_CHECKING, Dict, Iterable, Optional, Tuple

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

ML100K_URL = "https://files.grouplens.org/datasets/movielens/ml-100k.zip"
ML10M_URL = "http://files.grouplens.org/datasets/movielens/ml-10m.zip"
AMAZON_URLS = {
    # 5-core review subsets (download_split_amazon.py:127-141)
    "beauty": "https://jmcauley.ucsd.edu/data/amazon/categoryFilesSmall/reviews_Beauty_5.json.gz",
    "electronics": "https://jmcauley.ucsd.edu/data/amazon/categoryFilesSmall/reviews_Electronics_5.json.gz",
    "books": "https://jmcauley.ucsd.edu/data/amazon/categoryFilesSmall/reviews_Books_5.json.gz",
}


# ------------------------------------------------------------------ download
def download_file(url: str, folder: str, timeout: int = 600) -> str:
    """Fetch ``url`` into ``folder``; raises a clear error when the
    environment has no egress."""
    os.makedirs(folder, exist_ok=True)
    out = os.path.join(folder, os.path.basename(url))
    if os.path.exists(out):
        return out
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp, \
                open(out + ".part", "wb") as f:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    except OSError as e:
        raise RuntimeError(
            f"cannot download {url} (no network egress?): {e}") from e
    os.replace(out + ".part", out)
    return out


def extract_zip(path: str, folder: Optional[str] = None) -> str:
    folder = folder or os.path.dirname(path)
    with zipfile.ZipFile(path) as z:
        z.extractall(folder)
    return folder


# ------------------------------------------------------- shared conversion
def k_core_filter(df: pd.DataFrame, user_k: int = 10, item_k: int = 10,
                  user_col: str = "user_id", item_col: str = "item_id",
                  max_iter: int = 5) -> pd.DataFrame:
    """Iterative k-core (reference caps at 5 rounds,
    download_split_ml100k.py:153-188)."""
    prev = (-1, -1)
    for _ in range(max_iter):
        uc = df[user_col].value_counts()
        df = df[df[user_col].isin(uc[uc >= user_k].index)]
        ic = df[item_col].value_counts()
        df = df[df[item_col].isin(ic[ic >= item_k].index)]
        cur = (df[user_col].nunique(), df[item_col].nunique())
        if cur == prev:
            break
        prev = cur
    return df


def leave_one_out_split(df: pd.DataFrame, by: str = "user_id"
                        ) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Last row per group -> held-out set (download_split_ml100k.py:129-148).
    Assumes df is already time-sorted within groups."""
    test_idx = df.groupby(by, as_index=False).nth(-1).index
    test = df.loc[test_idx]
    train = df.loc[df.index.difference(test_idx)]
    return train.reset_index(drop=True), test.reset_index(drop=True)


def remap_ids(df: pd.DataFrame, cols: Iterable[str]) -> Tuple[pd.DataFrame, Dict]:
    """Map raw ids to contiguous 1-based codes (0 = padding)."""
    maps = {}
    for col in cols:
        uniq = df[col].unique()
        m = {v: i + 1 for i, v in enumerate(uniq)}
        df[col] = df[col].map(m)
        maps[col] = {str(k): v for k, v in m.items()}
    return df, maps


def _history_tsv(df: pd.DataFrame, path: str):
    h = df.groupby("user_id", as_index=False).agg(
        item_seq=("item_id", lambda x: ",".join(map(str, x))))
    h[["user_id", "item_seq"]].to_csv(path, index=False, sep="\t")


def _fake_morec_meta(n_items: int, path: str, seed: int = 2022,
                     price_range=(20, 100), n_groups: int = 5):
    """Fake price + fairness/alignment groups for MoRec
    (download_split_ml100k.py:363-386)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    price = rng.uniform(*price_range, size=n_items)
    price[0] = 0.0

    def groups():
        g = np.concatenate([np.arange(1, n_groups + 1),
                            rng.integers(1, n_groups + 1,
                                         size=max(n_items - n_groups, 0))])
        rng.shuffle(g)
        g[0] = 0
        return g[:n_items]

    pd.DataFrame({"item_id": np.arange(n_items), "weight": price,
                  "fair_group": groups(), "align_group": groups()}) \
        .to_csv(path, index=False)


def write_splits(data: pd.DataFrame, outpath: str, need_max_len: bool = False,
                 maps: Optional[Dict] = None,
                 item2cate: Optional[Dict] = None) -> Dict[str, int]:
    """Leave-one-out x2 (test + valid) and the full artifact set."""
    os.makedirs(outpath, exist_ok=True)
    _history_tsv(data, os.path.join(outpath, "full_user_history.csv"))
    if need_max_len:
        data = data.copy()
        data["max_len"] = data.groupby("user_id").cumcount()
    train0, test = leave_one_out_split(data)
    train, valid = leave_one_out_split(train0)
    _history_tsv(train0, os.path.join(outpath, "user_history.csv"))
    cols = ["user_id", "item_id"] + (["max_len"] if need_max_len else [])
    for name, df in (("train", train), ("valid", valid), ("test", test)):
        df[cols].to_csv(os.path.join(outpath, f"{name}.csv"), index=False,
                        sep="\t")
    if maps is not None:
        with open(os.path.join(outpath, "map.json"), "w") as f:
            json.dump(maps, f)
    if item2cate is not None:
        with open(os.path.join(outpath, "item2cate.json"), "w") as f:
            json.dump({str(k): v for k, v in item2cate.items()}, f)
    n_items = int(data["item_id"].max()) + 1
    _fake_morec_meta(n_items, os.path.join(outpath, "item_meta_morec.csv"))
    return {"n_users": int(data["user_id"].max()) + 1, "n_items": n_items,
            "train": len(train), "valid": len(valid), "test": len(test)}


def merge_categories(item2cats: pd.Series, min_items: int = 50) -> Dict:
    """Collapse categories with <= min_items items into one bucket
    (download_split_ml100k.py:190-234), vectorized."""
    exploded = item2cats.explode().dropna()
    sizes = exploded.groupby(exploded).apply(
        lambda s: s.index.nunique())
    large = [c for c, n in sizes.items() if n > min_items]
    cate2idx = {c: i + 1 for i, c in enumerate(large)}
    overflow = len(large) + 1
    return {c: cate2idx.get(c, overflow) for c in sizes.index}


# ------------------------------------------------------------ ml-100k core
def convert_ml100k(ratings_path: str, item_info_path: str, outpath: str,
                   need_max_len: bool = False, min_rating: int = 3,
                   user_k: int = 10, item_k: int = 10) -> Dict[str, int]:
    """u.data + u.item -> split artifacts (download_split_ml100k.py:258-354)."""
    import pandas as pd

    df = pd.read_csv(ratings_path, sep="\t",
                     names=["user_id", "item_id", "rating", "timestamp"])
    cate = pd.read_csv(item_info_path, sep="|", header=None,
                       encoding="ISO-8859-1")
    genre_cols = cate.columns[5:]
    genres = cate[genre_cols].to_numpy()
    item_ids = cate[0].to_numpy()
    item2cats = pd.Series(
        [list(np.flatnonzero(g) + 1) for g in genres], index=item_ids)

    df = df.sort_values(["user_id", "timestamp"], ignore_index=True)
    df = df[df["rating"] >= min_rating]
    df = df.drop_duplicates(["user_id", "item_id"], keep="last")
    df = k_core_filter(df, user_k, item_k).reset_index(drop=True)

    cate2idx = merge_categories(item2cats)
    raw_item2cate = {i: [cate2idx[c] for c in cs]
                     for i, cs in item2cats.items()}
    raw_items = df["item_id"].copy()
    df, maps = remap_ids(df, ["user_id", "item_id"])
    maps["cate"] = {str(k): v for k, v in cate2idx.items()}
    item2cate = {int(new): raw_item2cate.get(raw, [])
                 for raw, new in zip(raw_items, df["item_id"])}
    return write_splits(df[["user_id", "item_id"]], outpath,
                        need_max_len=need_max_len, maps=maps,
                        item2cate=item2cate)


def prepare_ml100k(outpath: str, cache: Optional[str] = None,
                   need_max_len: bool = False) -> Dict[str, int]:
    cache = cache or os.path.expanduser("~/.unirec/dataset")
    zf = download_file(ML100K_URL, cache)
    root = extract_zip(zf, cache)
    d = os.path.join(root, "ml-100k")
    return convert_ml100k(os.path.join(d, "u.data"),
                          os.path.join(d, "u.item"), outpath,
                          need_max_len=need_max_len)


# ------------------------------------------------------------------ ml-10m
def convert_ml10m(ratings_path: str, outpath: str,
                  min_rating: int = 3, user_k: int = 10,
                  item_k: int = 10) -> Dict[str, int]:
    import pandas as pd

    df = pd.read_csv(ratings_path, sep="::", header=None, engine="python",
                     names=["user_id", "item_id", "rating", "timestamp"])
    df = df.sort_values(["user_id", "timestamp"], ignore_index=True)
    df = df[df["rating"] >= min_rating]
    df = df.drop_duplicates(["user_id", "item_id"], keep="last")
    df = k_core_filter(df, user_k, item_k).reset_index(drop=True)
    df, maps = remap_ids(df, ["user_id", "item_id"])
    return write_splits(df[["user_id", "item_id"]], outpath, maps=maps)


def prepare_ml10m(outpath: str, cache: Optional[str] = None) -> Dict[str, int]:
    cache = cache or os.path.expanduser("~/.unirec/dataset")
    zf = download_file(ML10M_URL, cache)
    root = extract_zip(zf, cache)
    return convert_ml10m(os.path.join(root, "ml-10M100K", "ratings.dat"),
                         outpath)


# ------------------------------------------------------------------ amazon
def convert_amazon(reviews: pd.DataFrame, outpath: str, user_k: int = 10,
                   item_k: int = 10) -> Dict[str, int]:
    """reviews: reviewerID / asin / unixReviewTime (+overall ignored -
    the 5-core subsets are already implicit-feedback)."""
    df = reviews.rename(columns={"reviewerID": "user_id", "asin": "item_id",
                                 "unixReviewTime": "timestamp"})
    df = df.sort_values(["user_id", "timestamp"], ignore_index=True)
    df = df.drop_duplicates(["user_id", "item_id"], keep="last")
    df = k_core_filter(df, user_k, item_k).reset_index(drop=True)
    df, maps = remap_ids(df, ["user_id", "item_id"])
    return write_splits(df[["user_id", "item_id"]], outpath, maps=maps)


def prepare_amazon(category: str, outpath: str,
                   cache: Optional[str] = None) -> Dict[str, int]:
    import pandas as pd

    import gzip
    cache = cache or os.path.expanduser("~/.unirec/dataset")
    gz = download_file(AMAZON_URLS[category.lower()], cache)
    rows = []
    with gzip.open(gz, "rt") as f:
        for line in f:
            r = json.loads(line)
            rows.append((r["reviewerID"], r["asin"],
                         r.get("unixReviewTime", 0)))
    df = pd.DataFrame(rows, columns=["reviewerID", "asin", "unixReviewTime"])
    return convert_amazon(df, outpath)


# ------------------------------------------------- fmlp-style seq converter
def convert_fmlp(infile: str, outdir: str) -> Dict[str, int]:
    """'user item,item,...' text lines -> dedup + leave-one-out text splits
    (specific_datasets/fmlp.py:8-41)."""
    os.makedirs(outdir, exist_ok=True)
    lengths = []
    with open(infile) as rd, \
            open(os.path.join(outdir, "train.txt"), "w") as wt, \
            open(os.path.join(outdir, "valid.txt"), "w") as wv, \
            open(os.path.join(outdir, "test.txt"), "w") as wtst, \
            open(os.path.join(outdir, "user_history.txt"), "w") as wh:
        for line in rd:
            words = line.strip().split(" ")
            if len(words) < 2:
                continue
            uid, items = words[0], words[1:]
            items = list(dict.fromkeys(items))  # order-preserving dedup
            lengths.append(len(items))
            wt.write(uid + " " + ",".join(items[:-2]) + "\n")
            wv.write(uid + " " + items[-2] + "\n")
            wtst.write(uid + " " + items[-1] + "\n")
            wh.write(uid + " " + ",".join(items) + "\n")
    return {"users": len(lengths), "max_len": max(lengths, default=0),
            "min_len": min(lengths, default=0)}
