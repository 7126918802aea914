"""Tensor container IO for the C++ serving client (serving/cpp/unirec_serve.cc).

The port's copy of the JAX package's examples/serving_cpp/tensor_io.py: the
same ``UTSR`` format (little-endian),
    u32 magic 'UTSR' | u32 n_tensors
    per tensor: u32 dtype (0=f32, 1=s32) | u32 ndim | u64 dims[ndim] | data
"""
from __future__ import annotations

import struct
from typing import List

import numpy as np

MAGIC = 0x55545352

_DTYPES = {0: np.float32, 1: np.int32}
_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1}


def write_tensors(path: str, arrays: List[np.ndarray]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<II", MAGIC, len(arrays)))
        for a in arrays:
            a = np.ascontiguousarray(a)
            f.write(struct.pack("<II", _CODES[a.dtype], a.ndim))
            for d in a.shape:
                f.write(struct.pack("<Q", d))
            f.write(a.tobytes())


def read_tensors(path: str) -> List[np.ndarray]:
    out = []
    with open(path, "rb") as f:
        magic, n = struct.unpack("<II", f.read(8))
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic:#x}")
        for _ in range(n):
            code, ndim = struct.unpack("<II", f.read(8))
            dims = [struct.unpack("<Q", f.read(8))[0] for _ in range(ndim)]
            size = int(np.prod(dims)) * 4 if dims else 4
            out.append(np.frombuffer(f.read(size), dtype=_DTYPES[code]).reshape(dims))
    return out
