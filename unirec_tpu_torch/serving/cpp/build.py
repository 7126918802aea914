"""Build and run the C++ serving client (serving/cpp/unirec_serve.cc).

``build_client()`` writes ``unirec_schemas.h`` from ops/op_schemas.py's
table (the strings ``torch.ops.unirec.*`` are defined from) and compiles
the client with g++ against the installed torch's libtorch, into
``build/unirec_serve-<hash>/`` at the root of the checkout (named by a hash
of the source, the header and the flags, so an edit rebuilds; built at first
use, under a per-process temporary name). Where torch is built for CUDA the
client is built with ``-DUNIREC_WITH_CUDA`` and implements rows 1 and 3 on
the card; elsewhere it registers the schemas and implements none, so it
serves packages without ``unirec::*`` operators and refuses the others.

    python -m unirec_tpu_torch.serving.cpp.build      # prints the binary's path

``run_client`` writes the inputs as a UTSR file, runs the binary on a
package and returns its outputs, its printed launch counts and its seconds
per call; ``kernel_libs`` builds the kernel libraries the client dlopens.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from unirec_tpu_torch.ops import _build, op_schemas
from unirec_tpu_torch.serving.cpp import tensor_io

SOURCE = Path(__file__).with_name("unirec_serve.cc")
CLIENT_OPS = ("layer_fwd", "lastq_fwd")   # the operators the CUDA build implements


def schema_header() -> str:
    rows = "\n".join(f'    {{"{n}", "{op_schemas.full_schema(n)}"}},' for n in op_schemas.SCHEMAS)
    return ("// Written by serving/cpp/build.py from ops/op_schemas.py.\n#pragma once\n"
            "struct UnirecSchema { const char* name; const char* schema; };\n"
            f"static const UnirecSchema kUnirecSchemas[] = {{\n{rows}\n}};\n")


def _flags(cuda: bool) -> List[str]:
    import torch
    tdir = Path(torch.__file__).resolve().parent
    inc = [tdir / "include", tdir / "include" / "torch" / "csrc" / "api" / "include"]
    defs = [f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        inc.append(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "include")
        defs.append("-DUNIREC_WITH_CUDA")
        libs = ["-ltorch_cuda", "-lc10_cuda"] + libs
    # --no-as-needed: the CUDA runner of AOTIModelPackageLoader registers
    # itself from libtorch_cuda's static initializers
    return (["-O2", "-std=c++20", "-fPIC", *defs, *[f"-I{p}" for p in inc],
             f"-L{tdir / 'lib'}", f"-Wl,-rpath,{tdir / 'lib'}", "-Wl,--no-as-needed", *libs,
             "-Wl,--as-needed", "-ldl"])


def build_client(cuda: Optional[bool] = None) -> Dict[str, object]:
    """{"binary": path, "seconds": the g++ wall time (0 if built already),
    "cuda": bool}; raises with g++'s output if the build fails."""
    import torch
    if cuda is None:
        cuda = torch.version.cuda is not None
    header, flags = schema_header(), _flags(cuda)
    h = hashlib.sha256(SOURCE.read_bytes() + header.encode() + " ".join(flags).encode())
    out_dir = _build.BUILD_DIR / f"unirec_serve-{h.hexdigest()[:16]}"
    binary = out_dir / "unirec_serve"
    if binary.exists():
        return {"binary": binary, "seconds": 0.0, "cuda": cuda}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "unirec_schemas.h").write_text(header)
    tmp = binary.with_name(f"unirec_serve.{os.getpid()}.tmp")
    cmd = ["g++", str(SOURCE), f"-I{out_dir}", "-o", str(tmp), *flags]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ unirec_serve.cc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, binary)
    return {"binary": binary, "seconds": time.perf_counter() - t0, "cuda": cuda}


def kernel_libs(names: Sequence[str] = CLIENT_OPS) -> Dict[str, Path]:
    """The kernel library of each named operator, built if needed."""
    _build.build(names)
    return {n: _build.library_path(n) for n in names}


def run_client(binary, package, inputs: Sequence[np.ndarray],
               libs: Optional[Dict[str, Path]] = None, repeat: int = 1,
               timeout: float = 600.0) -> Dict[str, object]:
    """Run the client on ``package`` with ``inputs`` (int32 or f32 arrays).
    Returns {"outputs": [f32 arrays], "launches": {op: n}, "launches_mma":
    {op: n}, "seconds_per_call": s, "calls": n, "device": str}; raises
    CalledProcessError (stderr kept) if the client fails or refuses."""
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "inputs.bin"), os.path.join(tmp, "outputs.bin")
        tensor_io.write_tensors(fin, [np.ascontiguousarray(a) for a in inputs])
        cmd = [str(binary), str(package), fin, fout, "--repeat", str(int(repeat))]
        for name, path in (libs or {}).items():
            cmd += ["--lib", f"{name}={path}"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, cmd, proc.stdout, proc.stderr)
        out = {"outputs": tensor_io.read_tensors(fout), "launches": {}, "launches_mma": {}}
    for line in proc.stdout.splitlines():
        key, *rest = line.split()
        if key in ("launches", "launches_mma"):
            out[key][rest[0]] = int(rest[1])
        elif key == "seconds_per_call":
            out[key] = float(rest[0])
        elif key == "calls":
            out[key] = int(rest[0])
        elif key == "device":
            out[key] = rest[0]
    return out


def client_schemas(binary) -> List[str]:
    """The schemas the client registers, as it prints them."""
    proc = subprocess.run([str(binary), "--schemas"], capture_output=True, text=True,
                          check=True)
    return [ln.split(" ", 1)[1] for ln in proc.stdout.splitlines() if ln.startswith("schema ")]


if __name__ == "__main__":
    print(build_client()["binary"])
    sys.exit(0)
