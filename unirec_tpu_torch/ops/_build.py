"""Build and load the port's CUDA kernels.

Each ``unirec_tpu_torch/csrc/<name>.cu`` compiles with nvcc into its own
shared library with a plain C interface, loaded through ctypes (no PyTorch
headers, so a build takes seconds). Libraries go to ``build/`` at the root
of the checkout, named by a hash of the sources and flags, so an edited
source never loads a stale build; they are built at first use, and
``build()`` compiles several sources at once, one nvcc process each.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")
KERNEL_SOURCES = ("layer_fwd", "lastq_fwd", "blockmax", "layer_bwd", "lastq_bwd",
                  "scatter_add", "member", "attention", "ffn", "flash_attention",
                  "rescore_topk", "hstu_attention", "adam")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "unirec_tpu_torch are built from csrc/ on the card's machine")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES, ptxas_verbose: bool = False
          ) -> Dict[str, Dict[str, object]]:
    """Compile the named sources that have no current library, all at once.
    Returns {name: {"seconds": wall time of its nvcc (0 if already built),
    "log": nvcc's output}}; raises with the log if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, lib)
    failed = []
    for name, (proc, t0, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device) -> Optional[int]:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
