"""The port's host tools against the JAX package, on the CPU: the native
table parser (utils/fastio.py, csrc/fastio.cc) and the packed dataset path,
prepare-data, convert-splits, convert-adjacency, the dataset converters
(data/downloaders.py), the sweeps and the CLI commands.

Inputs are synthetic raw files from numpy seeds; both packages read the
same files and their outputs are held equal (tables cell by cell, text files
byte by byte, metrics within 1e-5). Nothing here touches the network:
``download_file`` is held to its gate with ``urlopen`` replaced by one that
raises, and ``download-data`` runs on an archive already in its cache.
"""
import json
import os
import subprocess
import sys
import textwrap
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from tests.synth import BASE_CONF
from unirec_tpu.data import downloaders as JDL
from unirec_tpu.data import prepare as JP
from unirec_tpu.utils import file_io as jax_file_io
from unirec_tpu_torch import cli
from unirec_tpu_torch.data import downloaders as TDL
from unirec_tpu_torch.data import prepare as TP
from unirec_tpu_torch.data.datasets import AERecDataset, BaseDataset, RankDataset, _pad_group
from unirec_tpu_torch.data.history import UserHistory
from unirec_tpu_torch.utils import fastio
from unirec_tpu_torch.utils import file_io

REPO = Path(__file__).resolve().parents[1]
LIC, LFC = file_io._LIST_INT_COLS, file_io._LIST_FLOAT_COLS


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise OSError("network disabled in the tests")
    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def _write(tmp_path, name, header, rows):
    p = os.path.join(str(tmp_path), name)
    with open(p, "w") as f:
        f.write(header + "\n" + "\n".join(rows) + "\n")
    return p


def _pandas_load(path):
    """The pandas reader alone (the native parser bypassed)."""
    sep = "\t" if path.endswith((".tsv", ".txt")) else ","
    df = pd.read_csv(path, sep=sep)
    for col in df.columns:
        if col in LIC:
            df[col] = df[col].apply(lambda c: file_io._parse_list(c, np.int64))
        elif col in LFC:
            df[col] = df[col].apply(lambda c: file_io._parse_list(c, np.float32))
    return df


def _frames_equal(a, b):
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for c in a.columns:
        if len(a) and isinstance(a[c].iloc[0], np.ndarray):
            for x, y in zip(a[c], b[c]):
                np.testing.assert_array_equal(x, y)
                assert np.asarray(x).dtype == np.asarray(y).dtype, c
        else:
            assert a[c].dtype == b[c].dtype, c
            np.testing.assert_array_equal(a[c].to_numpy(), b[c].to_numpy())


def _seq_table(tmp_path, n=200, seed=0, name="t.tsv"):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = rng.integers(1, 12)
        seq = ",".join(str(x) for x in rng.integers(1, 999, k))
        rows.append(f"{i + 1}\t{rng.integers(1, 999)}\t{seq}\t{k}")
    return _write(tmp_path, name, "user_id\titem_id\titem_seq\titem_seq_len", rows)


def _libfm_table(tmp_path, n=150, seed=1):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = rng.integers(1, 8)
        idx = " ".join(str(x) for x in rng.integers(0, 5000, k))
        val = " ".join(f"{v:.3f}" for v in rng.random(k))
        rows.append(f"{rng.integers(0, 2)}\t{idx}\t{val}")
    return _write(tmp_path, "fm.tsv", "label\tindex_list\tvalue_list", rows)


# ------------------------------------------------------------------ fastio
@pytest.mark.parametrize("table", ["seq", "libfm", "csv_scalars"])
def test_native_reader_matches_pandas_and_jax(tmp_path, table):
    if table == "seq":
        path = _seq_table(tmp_path)
    elif table == "libfm":
        path = _libfm_table(tmp_path)
    else:
        path = os.path.join(str(tmp_path), "t.csv")
        with open(path, "w") as f:
            f.write("user_id,rating,weight\n1,3.5,1.0\n2,4,0.5\n3,-2e-1,2\n")
    native = fastio.load_txt_table_native(path, LIC, LFC)
    assert native is not None
    _frames_equal(native, _pandas_load(path))
    _frames_equal(native, jax_file_io.load_txt_table(path))
    _frames_equal(file_io.load_txt_table(path), native)


def test_native_reader_declines_what_it_does_not_cover(tmp_path):
    p1 = _write(tmp_path, "s.tsv", "user_id\tname", ["1\talice"])
    assert fastio.load_txt_table_native(p1, LIC, LFC) is None
    p2 = _write(tmp_path, "b.tsv", "user_id\titem_seq", ["1\t[1, 2, 3]"])
    assert fastio.load_txt_table_native(p2, LIC, LFC) is None
    # the public reader parses both with pandas
    np.testing.assert_array_equal(file_io.load_txt_table(p2)["item_seq"].iloc[0], [1, 2, 3])
    assert file_io.load_txt_table(p1)["name"].iloc[0] == "alice"


def test_native_reader_empty_list_cells(tmp_path):
    path = _write(tmp_path, "e.tsv", "user_id\titem_seq", ["1\t", "2\t7"])
    native = fastio.load_txt_table_native(path, LIC, LFC)
    assert len(native["item_seq"].iloc[0]) == 0
    np.testing.assert_array_equal(native["item_seq"].iloc[1], [7])


def test_unirec_fastio_0_turns_the_parser_off(tmp_path, monkeypatch):
    path = _seq_table(tmp_path)
    monkeypatch.setenv("UNIREC_FASTIO", "0")
    assert fastio.get_lib() is None
    assert fastio.load_txt_table_packed(path, LIC, LFC) is None
    _frames_equal(file_io.load_txt_table(path), _pandas_load(path))


def test_the_library_is_named_by_its_source_in_build():
    so = fastio.library_path()
    assert so.parent == REPO / "build" and so.name.startswith("libfastio-")
    assert fastio.SRC == REPO / "unirec_tpu_torch" / "csrc" / "fastio.cc"
    assert fastio.get_lib() is not None and so.exists()


_RACE = textwrap.dedent("""
    import os, sys, time
    from pathlib import Path
    sys.path.insert(0, {repo!r})
    from unirec_tpu_torch.utils import fastio
    fastio.BUILD_DIR = Path({build!r})
    while not os.path.exists({go!r}):
        time.sleep(0.001)
    packed = fastio.load_txt_table_packed({table!r}, {{"item_seq"}}, set())
    print(packed["n_rows"], int(packed["lists"]["item_seq"][1].sum()))
""")


def test_two_processes_building_at_once_both_load_it(tmp_path):
    """Each process builds under its own temporary name and renames it into
    place: both load a whole library and parse the table (the JAX
    package's shared ``.so.tmp`` is ROADMAP.md Queue 3 item 2)."""
    table = _seq_table(tmp_path)
    build, go = tmp_path / "build", tmp_path / "go"
    code = _RACE.format(repo=str(REPO), build=str(build), go=str(go), table=table)
    env = {k: v for k, v in os.environ.items() if k != "UNIREC_FASTIO"}
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    go.write_text("")
    outs = [p.communicate(timeout=240) for p in procs]
    want = f"200 {int(_pandas_load(table)['item_seq'].apply(len).sum())}"
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == want
    assert [f.name for f in build.iterdir()] == [fastio.library_path().name]


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "fastio.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastio, "SRC", bad)
    monkeypatch.setattr(fastio, "BUILD_DIR", tmp_path / "build")
    fastio._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ fastio.cc failed") as e:
            fastio.get_lib()
        assert "error" in str(e.value)
    finally:
        fastio._load.cache_clear()


# ---------------------------------------------------- the packed datasets
def _both_paths(cls, config, path, filename):
    """``cls`` built from the packed parse and from the DataFrame."""
    ds_packed = cls(config, path, filename)
    prefix = os.path.join(path, filename)
    assert file_io.load_table_packed(prefix) is not None, "the parser declined"
    ds_df = cls.__new__(cls)
    ds_df.config, ds_df.task = config, config.get("data_loader_task", "train")
    ds_df.eval_protocol = config.get("eval_protocol")
    ds_df.fmt = config["data_format"]
    ds_df._normalize(file_io.load_table(prefix))
    return ds_packed, ds_df


def _cols_equal(a, b):
    assert a.fmt == b.fmt and a.n_rows == b.n_rows
    assert set(a.cols) == set(b.cols)
    for k in a.cols:
        np.testing.assert_array_equal(a.cols[k], b.cols[k])
        assert a.cols[k].dtype == b.cols[k].dtype, k


def _jax_cols(config, path, filename):
    from unirec_tpu.data.datasets import BaseDataset as JaxBase
    return JaxBase(config, path, filename)


@pytest.mark.parametrize("task,protocol", [("train", None), ("test", "one_vs_all"),
                                           ("test", "one_vs_k")])
def test_t5_table_packed_equals_dataframe_and_jax(tmp_path, task, protocol):
    rng = np.random.default_rng(0)
    rows = [f"{u}\t" + ",".join(map(str, rng.integers(1, 99, rng.integers(1, 9))))
            for u in range(1, 40)]
    _write(tmp_path, "seq.tsv", "user_id\titem_seq", rows)
    cfg = {"data_format": "user-item_seq", "data_loader_task": task, "eval_protocol": protocol}
    packed, df = _both_paths(BaseDataset, dict(cfg), str(tmp_path), "seq")
    _cols_equal(packed, df)
    _cols_equal(packed, _jax_cols(dict(cfg), str(tmp_path), "seq"))


def test_t7_and_t2_tables_packed_equal_dataframe_and_jax(tmp_path):
    _libfm_table(tmp_path)
    cfg = {"data_format": "label-index_group-value_group", "data_loader_task": "train"}
    packed, df = _both_paths(BaseDataset, dict(cfg), str(tmp_path), "fm")
    _cols_equal(packed, df)
    _cols_equal(packed, _jax_cols(dict(cfg), str(tmp_path), "fm"))
    _write(tmp_path, "lab.tsv", "user_id\titem_id\tlabel",
           [f"{u}\t{u + 3}\t{u % 2}" for u in range(1, 30)])
    cfg = {"data_format": "user-item-label", "data_loader_task": "test",
           "eval_protocol": "one_vs_all"}
    packed, df = _both_paths(BaseDataset, dict(cfg), str(tmp_path), "lab")
    _cols_equal(packed, df)
    assert packed.n_rows == 15                               # label-0 rows dropped
    _cols_equal(packed, _jax_cols(dict(cfg), str(tmp_path), "lab"))


def test_aerec_and_rank_datasets_regroup_text_tables(tmp_path):
    """The packed path keeps AERecDataset's per-user grouping and
    RankDataset's row groups (the JAX package's packed path skips both:
    ROADMAP.md Queue 3 item 8): a text table gives the columns its
    pickled copy gives."""
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"user_id": rng.integers(1, 20, 120), "item_id": rng.integers(1, 50, 120)})
    df.to_csv(tmp_path / "tr.tsv", sep="\t", index=False)
    (tmp_path / "pk").mkdir()
    df.to_pickle(tmp_path / "pk" / "tr.pkl")
    cfg = {"data_format": "user-item", "data_loader_task": "train", "n_users": 20, "n_items": 50}
    text, pkl = AERecDataset(dict(cfg), str(tmp_path), "tr"), \
        AERecDataset(dict(cfg), str(tmp_path / "pk"), "tr")
    assert text.fmt == "aerec-train"
    _cols_equal(text, pkl)
    assert (text.get_graph() != pkl.get_graph()).nnz == 0
    cfg = {"data_format": "user-item-label", "data_loader_task": "train", "group_size": 4}
    df["label"] = (np.arange(120) % 4 == 0).astype(int)
    df.to_csv(tmp_path / "rk.tsv", sep="\t", index=False)
    df.to_pickle(tmp_path / "pk" / "rk.pkl")
    text, pkl = RankDataset(dict(cfg), str(tmp_path), "rk"), \
        RankDataset(dict(cfg), str(tmp_path / "pk"), "rk")
    _cols_equal(text, pkl)
    assert text.cols["item_id"].shape == (30, 4)


def test_text_histories_load_through_the_parser(tmp_path):
    rng = np.random.default_rng(2)
    rows = [f"{u}\t" + ",".join(map(str, rng.integers(1, 99, rng.integers(1, 15))))
            for u in range(1, 50)] + ["7\t42,43"]             # a later duplicate wins
    prefix = _write(tmp_path, "hist.tsv", "user_id\titem_seq", rows)[:-4]
    for cap in (-1, 6):
        got = UserHistory.load(prefix, 60, "user-item_seq", capacity=cap)
        ref = UserHistory.from_dataframe(_pandas_load(prefix + ".tsv"), 60, "user-item_seq",
                                         capacity=cap)
        np.testing.assert_array_equal(got.items, ref.items)
        np.testing.assert_array_equal(got.lengths, ref.lengths)


def test_packed_table_defers_to_binary_formats(tmp_path):
    _write(tmp_path, "tbl.tsv", "user_id\titem_id", [f"{u}\t{u + 1}" for u in range(1, 9)])
    prefix = os.path.join(str(tmp_path), "tbl")
    assert file_io.load_table_packed(prefix) is not None
    pd.DataFrame({"user_id": [1], "item_id": [99]}).to_pickle(prefix + ".pkl")
    assert file_io.load_table_packed(prefix) is None
    assert list(file_io.load_table(prefix)["item_id"]) == [99]


@pytest.mark.parametrize("width", [None, 3])
def test_pad_packed_matches_pad_group_and_jax(width):
    from unirec_tpu.utils.fastio import pad_packed as jax_pad
    rng = np.random.default_rng(4)
    lens = rng.integers(0, 7, 25).astype(np.int32)
    flat = rng.integers(1, 100, int(lens.sum()))
    got = fastio.pad_packed(flat, lens, np.int64, width)
    np.testing.assert_array_equal(got, jax_pad(flat, lens, np.int64, width))
    if width is None:
        np.testing.assert_array_equal(got, _pad_group(np.split(flat, np.cumsum(lens)[:-1]),
                                                      np.int64))


# ------------------------------------------------------- data preparation
def _pkl_dirs_equal(a, b, names):
    for n in names:
        _frames_equal(pd.read_pickle(os.path.join(a, n)), pd.read_pickle(os.path.join(b, n)))
    assert json.load(open(os.path.join(a, "data.info"))) == \
        json.load(open(os.path.join(b, "data.info")))


def _raw_log(path, n_users=60, n_items=80, seed=3):
    rng = np.random.default_rng(seed)
    rows = [(f"u{u}", f"i{rng.integers(0, n_items)}", t)
            for u in range(n_users) for t in range(rng.integers(5, 15))]
    pd.DataFrame(rows, columns=["user_id", "item_id", "ts"]).to_csv(path, sep="\t", index=False)


@pytest.mark.parametrize("libfm", [False, True])
def test_prepare_data_matches_jax(tmp_path, libfm):
    raw = str(tmp_path / "raw.tsv")
    _raw_log(raw)
    kw = dict(time_col="ts", n_neg_k=4, libfm=libfm)
    info = TP.prepare_data(raw, str(tmp_path / "port"), **kw)
    assert info == JP.prepare_data(raw, str(tmp_path / "jax"), **kw)
    names = ["train.pkl", "valid.pkl", "test.pkl", "user_history.pkl", "valid_k.pkl",
             "test_k.pkl"] + (["libfm_train.pkl", "libfm_valid.pkl", "libfm_test.pkl"]
                              if libfm else [])
    _pkl_dirs_equal(str(tmp_path / "port"), str(tmp_path / "jax"), names)


def _adjacency_splits(split_dir, n_users=40, n_items=60, seed=5):
    rng = np.random.default_rng(seed)
    os.makedirs(split_dir)
    for fname, lo, hi in (("train.txt", 5, 12), ("val.txt", 1, 3), ("test.txt", 1, 3)):
        with open(os.path.join(split_dir, fname), "w") as f:
            for u in range(n_users):
                items = rng.choice(n_items, size=rng.integers(lo, hi), replace=False)
                f.write(" ".join([str(u)] + [str(i) for i in items]) + "\n")
        with open(os.path.join(split_dir, "train.txt"), "a") as f:
            f.write("3 59\n")                                 # a user on two lines


@pytest.mark.parametrize("index_from_zero", [True, False])
def test_convert_adjacency_matches_jax(tmp_path, index_from_zero):
    split = str(tmp_path / "splits")
    _adjacency_splits(split)
    info = TP.convert_adjacency(split, str(tmp_path / "port"), index_from_zero=index_from_zero)
    assert info == JP.convert_adjacency(split, str(tmp_path / "jax"),
                                        index_from_zero=index_from_zero)
    _pkl_dirs_equal(str(tmp_path / "port"), str(tmp_path / "jax"),
                    ["train.pkl", "user_history.pkl", "valid.pkl", "test.pkl"])


def _fake_ml100k(root, n_users=60, n_items=40, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(1, n_users + 1):
        items = rng.choice(np.arange(1, n_items + 1), size=rng.integers(15, 30), replace=False)
        t0 = rng.integers(1, 1000)
        rows += [(u, it, rng.integers(1, 6), t0 + j) for j, it in enumerate(items)]
    os.makedirs(root, exist_ok=True)
    udata, uitem = os.path.join(root, "u.data"), os.path.join(root, "u.item")
    pd.DataFrame(rows).to_csv(udata, sep="\t", header=False, index=False)
    with open(uitem, "w", encoding="ISO-8859-1") as f:
        for i in range(1, n_items + 1):
            flags = rng.integers(0, 2, size=19)
            f.write(f"{i}|movie{i}|01-Jan-1995||http://x|" + "|".join(map(str, flags)) + "\n")
    return udata, uitem


SPLIT_FILES = ("train.csv", "valid.csv", "test.csv", "user_history.csv",
               "full_user_history.csv", "map.json", "item_meta_morec.csv")


def _text_dirs_equal(a, b, names=SPLIT_FILES):
    for n in names:
        if os.path.exists(os.path.join(b, n)):
            assert open(os.path.join(a, n), "rb").read() == open(os.path.join(b, n), "rb").read(), n


@pytest.mark.parametrize("need_max_len", [False, True])
def test_convert_ml100k_matches_jax(tmp_path, need_max_len):
    udata, uitem = _fake_ml100k(str(tmp_path / "raw"))
    kw = dict(need_max_len=need_max_len, min_rating=3, user_k=5, item_k=5)
    info = TDL.convert_ml100k(udata, uitem, str(tmp_path / "port"), **kw)
    assert info == JDL.convert_ml100k(udata, uitem, str(tmp_path / "jax"), **kw)
    _text_dirs_equal(str(tmp_path / "port"), str(tmp_path / "jax"),
                     SPLIT_FILES + ("item2cate.json",))


def test_convert_ml10m_and_amazon_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    rows = [f"{u}::{i}::{rng.integers(1, 6)}::{t}" for u in range(1, 50)
            for t, i in enumerate(rng.choice(np.arange(1, 60), 20, replace=False))]
    ratings = tmp_path / "ratings.dat"
    ratings.write_text("\n".join(rows) + "\n")
    kw = dict(user_k=5, item_k=5)
    assert TDL.convert_ml10m(str(ratings), str(tmp_path / "p10"), **kw) == \
        JDL.convert_ml10m(str(ratings), str(tmp_path / "j10"), **kw)
    _text_dirs_equal(str(tmp_path / "p10"), str(tmp_path / "j10"))
    reviews = pd.DataFrame({"reviewerID": [f"A{u}" for u in range(40) for _ in range(15)],
                            "asin": [f"B{rng.integers(0, 30)}" for _ in range(600)],
                            "unixReviewTime": rng.integers(0, 10**6, 600)})
    assert TDL.convert_amazon(reviews.copy(), str(tmp_path / "pa"), **kw) == \
        JDL.convert_amazon(reviews.copy(), str(tmp_path / "ja"), **kw)
    _text_dirs_equal(str(tmp_path / "pa"), str(tmp_path / "ja"))


def test_shared_conversion_steps_match_jax():
    rng = np.random.default_rng(2)
    df = pd.DataFrame({"user_id": rng.integers(0, 30, 400), "item_id": rng.integers(0, 40, 400)})
    pd.testing.assert_frame_equal(TDL.k_core_filter(df, 8, 8), JDL.k_core_filter(df, 8, 8))
    for got, want in zip(TDL.leave_one_out_split(df), JDL.leave_one_out_split(df)):
        pd.testing.assert_frame_equal(got, want)
    got, gmaps = TDL.remap_ids(df.copy(), ["user_id", "item_id"])
    want, wmaps = JDL.remap_ids(df.copy(), ["user_id", "item_id"])
    pd.testing.assert_frame_equal(got, want)
    assert gmaps == wmaps
    cats = pd.Series([[1, 2], [2], [3, 1], [4]] * 30, index=range(120))
    assert TDL.merge_categories(cats, 20) == JDL.merge_categories(cats, 20)


def test_convert_fmlp_and_convert_splits_match_jax(tmp_path):
    infile = tmp_path / "raw.txt"
    infile.write_text("7 1 2 2 3 4\n9 5 6 7 8\n3 9 9 10\n")
    assert TDL.convert_fmlp(str(infile), str(tmp_path / "pf")) == \
        JDL.convert_fmlp(str(infile), str(tmp_path / "jf"))
    _text_dirs_equal(str(tmp_path / "pf"), str(tmp_path / "jf"),
                     ("train.txt", "valid.txt", "test.txt", "user_history.txt"))
    udata, uitem = _fake_ml100k(str(tmp_path / "raw"), seed=1)
    TDL.convert_ml100k(udata, uitem, str(tmp_path / "splits"), user_k=5, item_k=5)
    for max_len in (False, True):
        assert TP.convert_splits(str(tmp_path / "splits"), str(tmp_path / f"p{max_len}"),
                                 max_len_col=max_len) == \
            JP.convert_splits(str(tmp_path / "splits"), str(tmp_path / f"j{max_len}"),
                              max_len_col=max_len)
        _pkl_dirs_equal(str(tmp_path / f"p{max_len}"), str(tmp_path / f"j{max_len}"),
                        ["train.pkl", "valid.pkl", "test.pkl", "user_history.pkl"])


def test_download_file_is_gated_without_the_network(tmp_path):
    with pytest.raises(RuntimeError, match="egress"):
        TDL.download_file("https://files.grouplens.org/nonexistent.zip", str(tmp_path))
    assert not list(tmp_path.glob("*.zip"))


def _ml100k_cache(cache):
    udata, uitem = _fake_ml100k(str(cache / "src"), seed=2)
    os.makedirs(cache, exist_ok=True)
    with zipfile.ZipFile(cache / "ml-100k.zip", "w") as z:
        z.write(udata, "ml-100k/u.data")
        z.write(uitem, "ml-100k/u.item")


def test_cli_download_data_converts_an_archive_in_its_cache(tmp_path, capsys):
    """The archive is already in the cache, so download_file returns it
    without a request (urlopen raises here); the splits equal the JAX
    package's prepare_ml100k from the same cache."""
    _ml100k_cache(tmp_path / "cache")
    assert cli.main(["download-data", "--dataset", "ml-100k", "--out_dir",
                     str(tmp_path / "port"), "--cache", str(tmp_path / "cache")]) == 0
    assert "n_items" in capsys.readouterr().out
    JDL.prepare_ml100k(str(tmp_path / "jax"), cache=str(tmp_path / "cache"))
    _text_dirs_equal(str(tmp_path / "port"), str(tmp_path / "jax"),
                     SPLIT_FILES + ("item2cate.json",))
    with pytest.raises(SystemExit, match="unknown dataset"):
        cli.main(["download-data", "--dataset", "nope", "--out_dir", str(tmp_path / "x")])


def test_cli_prepare_convert_commands_match_jax(tmp_path, capsys):
    raw = str(tmp_path / "raw.tsv")
    _raw_log(raw, seed=4)
    assert cli.main(["prepare-data", "--raw_file", raw, "--out_dir", str(tmp_path / "pd"),
                     "--time_col", "ts", "--n_neg_k", "3"]) == 0
    JP.prepare_data(raw, str(tmp_path / "jd"), time_col="ts", n_neg_k=3)
    _pkl_dirs_equal(str(tmp_path / "pd"), str(tmp_path / "jd"),
                    ["train.pkl", "valid_k.pkl", "test_k.pkl", "user_history.pkl"])
    split = str(tmp_path / "adj")
    _adjacency_splits(split, seed=6)
    assert cli.main(["convert-adjacency", "--split_dir", split, "--out_dir",
                     str(tmp_path / "pa")]) == 0
    JP.convert_adjacency(split, str(tmp_path / "ja"))
    _pkl_dirs_equal(str(tmp_path / "pa"), str(tmp_path / "ja"),
                    ["train.pkl", "user_history.pkl", "valid.pkl", "test.pkl"])
    udata, uitem = _fake_ml100k(str(tmp_path / "raw100k"), seed=3)
    TDL.convert_ml100k(udata, uitem, str(tmp_path / "splits"), user_k=5, item_k=5)
    assert cli.main(["convert-splits", "--split_dir", str(tmp_path / "splits"), "--out_dir",
                     str(tmp_path / "ps")]) == 0
    JP.convert_splits(str(tmp_path / "splits"), str(tmp_path / "js"))
    _pkl_dirs_equal(str(tmp_path / "ps"), str(tmp_path / "js"),
                    ["train.pkl", "valid.pkl", "test.pkl", "user_history.pkl"])
    out = capsys.readouterr().out
    assert out.count("'n_users'") == 3


def test_cli_lists_every_jax_command_but_export():
    """Every JAX command, export included since the serving export is
    ported (tests/test_torch_serving.py::test_cli_export)."""
    from unirec_tpu import cli as jax_cli
    assert set(jax_cli.COMMANDS) == set(cli.COMMANDS)


# ----------------------------------------------------------------- sweep
SWEEP = """
method: grid
metric: {name: hit@10, goal: maximize}
parameters:
  edge_norm: {values: [sqrt_degree, none]}
"""


def _sweep_args(root, out):
    return dict(BASE_CONF, model="SAR", dataloader="AERecDataset", n_sample_neg_train=0,
                dataset_path=root, output_path=out, exp_name="sw")


def test_sweep_matches_jax(synth_dataset, tmp_path):
    from unirec_tpu.facility.sweep import run_sweep as jax_sweep
    from unirec_tpu_torch.facility.sweep import run_sweep
    root, _ = synth_dataset
    (tmp_path / "sweep.yaml").write_text(SWEEP)
    best, records = run_sweep(str(tmp_path / "sweep.yaml"),
                              dict(_sweep_args(root, str(tmp_path / "port")), device="cpu"))
    jbest, jrecords = jax_sweep(str(tmp_path / "sweep.yaml"),
                                _sweep_args(root, str(tmp_path / "jax")))
    assert [r["edge_norm"] for r in records] == ["sqrt_degree", "none"]
    for got, want in zip(records, jrecords):
        assert got["trial"] == want["trial"] and abs(got["hit@10"] - want["hit@10"]) <= 1e-5
    assert best["trial"] == jbest["trial"]
    tsv = pd.read_csv(tmp_path / "port" / "sweep_results.tsv", sep="\t")
    assert list(tsv["edge_norm"]) == ["sqrt_degree", "none"] and len(tsv.columns) == 3


def test_cli_sweep_without_wandb_warns_and_runs(synth_dataset, tmp_path, capsys, caplog,
                                                monkeypatch):
    import importlib.util
    root, _ = synth_dataset
    (tmp_path / "sweep.yaml").write_text(SWEEP)
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "wandb" else find_spec(name, *a))
    argv = ["sweep", "--sweep_file", str(tmp_path / "sweep.yaml"), "--model", "SAR",
            "--dataloader", "AERecDataset", "--n_sample_neg_train", "0", "--dataset_path", root,
            "--output_path", str(tmp_path / "out"), "--user_history_filename", "user_history",
            "--valid_protocol", "one_vs_all", "--test_protocol", "one_vs_all",
            "--metrics", "['hit@10']", "--use_wandb", "1", "--device", "cpu"]
    with caplog.at_level("WARNING"):
        assert cli.main(argv) == 0
    assert "best trial:" in capsys.readouterr().out
    assert "wandb unavailable" in caplog.text
    assert (tmp_path / "out" / "sweep_results.tsv").exists()
