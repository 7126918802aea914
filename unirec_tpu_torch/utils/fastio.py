"""ctypes bindings of the native table parser (unirec_tpu_torch/csrc/fastio.cc;
counterpart of unirec_tpu/utils/fastio.py).

The text formats (headered TSV/CSV with list-valued columns: user_history
item_seq, libFM index_list/value_list, T5/T6 sequence splits) read through
pandas cross the Python boundary at every list cell. The native parser
walks the bytes twice (count, fill) into packed numpy arrays. This module
builds it with g++ at first use into the checkout's ``build/`` directory,
named by a hash of the source and flags and written under a per-process
temporary name before ``os.replace`` (so processes that build at once each
load a whole library), reassembles the exact DataFrame the pandas path
produces, and returns None where the file uses what the parser does not
cover (bracket lists, string columns, missing cells): the caller then reads
it with pandas. ``UNIREC_FASTIO=0`` (or ``false``) turns the parser off. A
failed build raises with the compiler's message.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from unirec_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parents[1] / "csrc" / "fastio.cc"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libfastio-{h.hexdigest()[:16]}.so"


@functools.cache
def _load() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {SRC.name} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.unirec_count.restype = ctypes.c_int64
    lib.unirec_count.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.unirec_fill.restype = ctypes.c_int64
    lib.unirec_fill.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p)]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The parser's library, built first if needed; None under
    ``UNIREC_FASTIO=0``."""
    if os.environ.get("UNIREC_FASTIO", "1") in ("0", "false"):
        return None
    return _load()


def load_txt_table_packed(path: str, list_int_cols, list_float_cols) -> Optional[Dict]:
    """Parse a headered text table natively into PACKED arrays:
    ``{"n_rows": int, "columns": [...], "scalars": {col: np[N]}, "lists":
    {col: (flat_values, lengths[N])}}``. None where the parser declines."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    nl = data.find(b"\n")
    if nl < 0:
        return None
    header = data[:nl].decode("utf-8", "replace").strip("\r")
    sep = "\t" if path.endswith((".tsv", ".txt")) else ","
    cols = header.split(sep)
    body = data[nl + 1:]
    if b"[" in body[:4096]:
        return None  # bracket-style lists: the pandas reader parses them

    types = np.zeros(len(cols), np.int32)
    for i, c in enumerate(cols):
        if c in list_int_cols:
            types[i] = 1
        elif c in list_float_cols:
            types[i] = 2

    n_cols = len(cols)
    rows = ctypes.c_int64(0)
    list_counts = (ctypes.c_int64 * n_cols)()
    rc = lib.unirec_count(body, len(body), ctypes.c_char(sep.encode()), n_cols,
                          types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                          ctypes.byref(rows), list_counts)
    if rc != 0:
        return None
    n_rows = rows.value

    scalars: Dict[int, np.ndarray] = {}
    flats: Dict[int, np.ndarray] = {}
    lens: Dict[int, np.ndarray] = {}
    p_scal = (ctypes.c_void_p * n_cols)()
    p_i64 = (ctypes.c_void_p * n_cols)()
    p_f32 = (ctypes.c_void_p * n_cols)()
    p_lens = (ctypes.c_void_p * n_cols)()
    for i in range(n_cols):
        if types[i] == 0:
            scalars[i] = np.empty(n_rows, np.float64)
            p_scal[i] = scalars[i].ctypes.data_as(ctypes.c_void_p)
        else:
            flats[i] = np.empty(list_counts[i], np.int64 if types[i] == 1 else np.float32)
            lens[i] = np.empty(n_rows, np.int32)
            (p_i64 if types[i] == 1 else p_f32)[i] = flats[i].ctypes.data_as(ctypes.c_void_p)
            p_lens[i] = lens[i].ctypes.data_as(ctypes.c_void_p)
    integral = (ctypes.c_int32 * n_cols)()
    rc = lib.unirec_fill(body, len(body), ctypes.c_char(sep.encode()), n_cols,
                         types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         ctypes.cast(p_scal, ctypes.POINTER(ctypes.c_void_p)), integral,
                         ctypes.cast(p_i64, ctypes.POINTER(ctypes.c_void_p)),
                         ctypes.cast(p_f32, ctypes.POINTER(ctypes.c_void_p)),
                         ctypes.cast(p_lens, ctypes.POINTER(ctypes.c_void_p)))
    if rc != 0:
        return None

    packed: Dict = {"n_rows": n_rows, "columns": list(cols), "scalars": {}, "lists": {}}
    for i, c in enumerate(cols):
        if types[i] == 0:
            # pandas' dtype inference: an all-integral column is int64
            packed["scalars"][c] = scalars[i].astype(np.int64) if integral[i] else scalars[i]
        else:
            packed["lists"][c] = (flats[i], lens[i])
    return packed


def packed_frame(packed: Dict):
    """The DataFrame the pandas reader gives for a packed parse: list cells
    as per-row ndarray views (np.split)."""
    import pandas as pd

    n_rows = packed["n_rows"]
    out = {}
    for c in packed["columns"]:
        if c in packed["scalars"]:
            out[c] = packed["scalars"][c]
        else:
            flat, lens = packed["lists"][c]
            splits = np.cumsum(lens[:-1]) if n_rows > 1 else []
            out[c] = pd.Series(np.split(flat, splits), dtype=object) \
                if n_rows else pd.Series([], dtype=object)
    return pd.DataFrame(out, columns=packed["columns"])


def load_txt_table_native(path: str, list_int_cols, list_float_cols):
    """DataFrame of a native parse (None where the parser declines)."""
    packed = load_txt_table_packed(path, list_int_cols, list_float_cols)
    return None if packed is None else packed_frame(packed)


def pad_packed(flat: np.ndarray, lens: np.ndarray, dtype,
               width: Optional[int] = None) -> np.ndarray:
    """out[r, :min(lens[r], width)] = the first elements of row r, zero
    padded (datasets._pad_group on a packed list column, vectorized)."""
    n = len(lens)
    width = int(width or max(int(lens.max()) if n else 1, 1))
    offsets = np.concatenate([[0], np.cumsum(lens[:-1])]) if n else np.zeros(0, np.int64)
    j = np.arange(width)
    valid = j[None, :] < np.minimum(lens, width)[:, None]
    out = np.zeros((n, width), dtype=dtype)
    src = offsets[:, None] + j[None, :]
    out[valid] = flat[src[valid]]
    return out
