"""Serving export: checkpoint -> torch.export programs (and AOTInductor
packages for the C++ client).

Counterpart of unirec_tpu/serving/export.py. The same three serving
functions, ``user_emb(user_id, item_seq, item_seq_len)``,
``item_emb(item_id)`` and ``score(user_id, item_seq, item_seq_len,
item_id)``, int32 ids in and f32 out whatever the model's compute dtype,
are traced with ``torch.export`` at a symbolic batch (``batch_size`` 0, a
``torch.export.Dim``) or a fixed one, checked against the live model on
seeded ids (``atol``, rtol 1e-4) and written as ``<fn>.pt2``
(``torch.export.save``) with a ``manifest.json`` of the JAX package's keys.
``kept_inputs`` lists every index: torch.export prunes no argument.

The fused kernels are ``unirec::*`` operators (ops/op_schemas.py), so a
``fused_layer``/``fused_lastq`` checkpoint's ``user_emb`` records
``unirec::layer_fwd`` and ``unirec::lastq_fwd`` nodes (rows 1 and 3), a
``use_fused_attention``/``use_fused_ffn`` one ``unirec::attention_fwd`` and
``unirec::ffn_fwd`` (rows 10 and 12), a ``use_pallas`` one
``unirec::flash_fwd`` (row 9); each function's entry lists the operators
its graph holds (``custom_ops``). No body choice reads the batch, so the
symbolic batch stays symbolic.

``aoti`` (a list of function names) also compiles each named function,
exported at the fixed batch ``aoti_batch`` (or ``batch_size``), into an
AOTInductor package ``<fn>.aoti.pt2`` for the C++ client
(serving/cpp/unirec_serve.cc): Inductor compiles the glue around the
operators, which stay calls of the hand-written kernels through the
dispatcher; the package's metadata ``unirec_ops`` names them, so the client
refuses, by name, a package whose operators it does not register. Each
package is checked like the ``.pt2`` files.

The JAX package writes StableHLO for PJRT; the port writes what torch
serves (ROADMAP.md, deliberate differences).
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from unirec_tpu_torch.ops import op_schemas

FUNCTIONS = ("user_emb", "item_emb", "score")


class ServeFunction(torch.nn.Module):
    """One serving function of ``model`` as a module torch.export traces:
    int32 ids in, f32 out."""

    def __init__(self, model, name: str):
        super().__init__()
        self.model, self.name = model, name

    def forward(self, *ids):
        ids = [t.long() for t in ids]
        if self.name == "item_emb":
            return self.model.item_emb(ids[0]).float()
        batch = {"user_id": ids[0], "item_seq": ids[1], "item_seq_len": ids[2]}
        if self.name == "user_emb":
            return self.model.user_emb(batch).float()
        return self.model.predict(dict(batch, item_id=ids[3])).float()


def in_shapes(name: str, batch, L: int, n_candidates: int) -> List[list]:
    """The function's input shapes, ``batch`` an int or the symbol's name."""
    return {"user_emb": [[batch], [batch, L], [batch]],
            "item_emb": [[batch]],
            "score": [[batch], [batch, L], [batch], [batch, n_candidates]]}[name]


def custom_ops(ep) -> List[str]:
    """The ``unirec::*`` operators an ExportedProgram's graph calls."""
    ops = set()
    for node in ep.graph.nodes:
        target = getattr(node.target, "name", None)
        if node.op == "call_function" and callable(target) \
                and target().startswith(op_schemas.NAMESPACE + "::"):
            ops.add(target())
    return sorted(ops)


def seeded_inputs(shapes, b: int, n_items: int, device) -> List[torch.Tensor]:
    """The check's ids, as the JAX exporter draws them: one numpy generator
    seeded 0, ids in [1, n_items - 1) for every input."""
    rng = np.random.default_rng(0)
    hi = max(int(n_items) - 1, 2)
    return [torch.as_tensor(rng.integers(1, hi, size=tuple(b if not isinstance(d, int) else d
                                                           for d in s)), dtype=torch.int32,
                            device=device) for s in shapes]


def _export(module, args, symbolic: bool):
    dyn = None
    if symbolic:
        b = torch.export.Dim("b", min=1, max=1 << 20)
        dyn = (tuple({0: b} for _ in args),)    # forward(*ids): one tuple
    with torch.no_grad():
        return torch.export.export(module, tuple(args), dynamic_shapes=dyn)


def _check(got, want, atol: float, what: str):
    np.testing.assert_allclose(np.asarray(got.detach().float().cpu()),
                               np.asarray(want.detach().float().cpu()), atol=atol, rtol=1e-4,
                               err_msg=what)


def openmp_cxx() -> str:
    """The C++ compiler AOTInductor builds a package with: ``$CXX``, else
    ``g++`` on the PATH, the first of them that links an OpenMP program
    (AOTInductor links its wrapper with -fopenmp, which a GCC installation
    without libgomp's spec file refuses). Raises naming each one tried."""
    tried = []
    for cxx in dict.fromkeys(c for c in (os.environ.get("CXX"), "g++") if c):
        with tempfile.TemporaryDirectory() as d:
            src = os.path.join(d, "omp.cc")
            with open(src, "w") as f:
                f.write("#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n")
            try:
                r = subprocess.run([cxx, "-fopenmp", src, "-o", os.path.join(d, "omp")],
                                   capture_output=True, text=True)
            except FileNotFoundError as e:
                tried.append(f"{cxx}: {e}")
                continue
        if r.returncode == 0:
            return cxx
        tried.append(f"{cxx}: {r.stderr.strip()[-300:]}")
    raise RuntimeError("no C++ compiler links an OpenMP program, as AOTInductor needs: "
                       + "; ".join(tried))


def compile_package(ep, path: str, name: str, batch: int) -> Dict[str, Any]:
    """AOTInductor-compile ``ep`` into the package ``path`` with
    ``openmp_cxx()``; its metadata names the function, its batch and its
    unirec operators."""
    ops = custom_ops(ep)
    cxx = openmp_cxx()
    t0 = time.perf_counter()
    with torch.no_grad():
        torch._inductor.aoti_compile_and_package(
            ep, package_path=path,
            inductor_configs={"cpp.cxx": (None, cxx), "aot_inductor.metadata": {
                "unirec_ops": ",".join(ops), "function": name, "batch": str(batch)}})
    return {"file": os.path.basename(path), "batch": batch, "custom_ops": ops, "cxx": cxx,
            "compile_s": time.perf_counter() - t0}


def export_model(model_file: str, out_dir: str, batch_size: int = 0,
                 n_candidates: int = 32, atol: float = 1e-5,
                 aoti: Sequence[str] = (), aoti_batch: int = 0,
                 device: Optional[str] = None) -> Dict[str, Any]:
    """Export the three serving functions of ``model_file`` into ``out_dir``
    (module docstring); returns the manifest. Runs on the card unless
    ``device`` says otherwise."""
    from unirec_tpu_torch.utils.checkpoint import load_model_freely

    batch_size, n_candidates = int(batch_size), int(n_candidates)
    if isinstance(aoti, str):
        aoti = [a for a in aoti.split(",") if a]
    os.makedirs(out_dir, exist_ok=True)
    model, config = load_model_freely(model_file, device)
    dev = model.device
    L = int(config.get("max_seq_len", 10))
    n_items = int(config.get("n_items", 100))
    manifest = {"model": config.get("model"), "max_seq_len": L,
                "is_seqrec": bool(getattr(model, "is_seqrec", False)),
                "n_items": config.get("n_items"), "n_users": config.get("n_users"),
                "embedding_size": config.get("embedding_size"), "device": str(dev),
                "functions": {}}
    b_val = batch_size if batch_size > 0 else 4
    for name in FUNCTIONS:
        module = ServeFunction(model, name).eval()
        shapes = in_shapes(name, batch_size if batch_size > 0 else "b", L, n_candidates)
        args = seeded_inputs(shapes, b_val, n_items, dev)
        t0 = time.perf_counter()
        ep = _export(module, args, symbolic=batch_size <= 0)
        export_s = time.perf_counter() - t0
        fname = f"{name}.pt2"
        torch.export.save(ep, os.path.join(out_dir, fname))
        info = {"file": fname, "in_shapes": shapes, "kept_inputs": list(range(len(shapes))),
                "custom_ops": custom_ops(ep), "export_s": export_s}
        # numerical validation against the live model, from the saved file
        with torch.no_grad():
            got = torch.export.load(os.path.join(out_dir, fname)).module()(*args)
            _check(got, module(*args), atol, f"{name}.pt2 against the live model")
        if name in aoti:
            b = int(aoti_batch or batch_size)
            if b <= 0:
                raise ValueError("an AOTInductor package needs a fixed batch: aoti_batch")
            fixed = seeded_inputs(in_shapes(name, b, L, n_candidates), b, n_items, dev)
            fixed_ep = ep if b == batch_size else _export(module, fixed, symbolic=False)
            path = os.path.join(out_dir, f"{name}.aoti.pt2")
            info["aoti"] = compile_package(fixed_ep, path, name, b)
            with torch.no_grad():
                got = torch._inductor.aoti_load_package(path)(*fixed)
                _check(got, module(*fixed), atol, f"{name}.aoti.pt2 against the live model")
        manifest["functions"][name] = info
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServingModel:
    """Client-side loader of an exported artifact directory: each function
    takes int arrays and returns an f32 numpy array, run on the device the
    artifact was exported on."""

    def __init__(self, artifact_dir: str):
        from unirec_tpu_torch.ops import attention, ffn, layer  # noqa: F401 (the unirec ops)
        with open(os.path.join(artifact_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.device = torch.device(self.manifest["device"])
        self._fns = {name: torch.export.load(os.path.join(artifact_dir, info["file"])).module()
                     for name, info in self.manifest["functions"].items()}

    def __getattr__(self, name):
        if name in ("manifest", "_fns", "device"):
            raise AttributeError(name)
        if name in self._fns:
            fn = self._fns[name]

            @torch.no_grad()
            def call(*args):
                ids = [torch.as_tensor(np.asarray(a), dtype=torch.int32, device=self.device)
                       for a in args]
                return fn(*ids).float().cpu().numpy()
            return call
        raise AttributeError(name)
