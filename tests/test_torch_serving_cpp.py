"""The port's C++ serving client (serving/cpp/unirec_serve.cc) on the CPU.

The client is built with g++ against the installed torch's libtorch (here
a CPU build: it registers every unirec::* schema and implements none) and
serves an AOTInductor package of a small unfused SASRec at a fixed batch;
its outputs must equal the Python artifact's (the ``.pt2`` program) and
the live model's within 1e-5. It refuses, by name, the package of a
fused_layer/fused_lastq checkpoint, whose operators it does not implement
on the CPU; that package runs in Python through the operators' CPU
implementations and equals the live model. The client's schema strings
equal ``torch.ops.unirec.*``'s, and its tensor files are the JAX example's
UTSR format byte for byte. Skipped only where g++ is absent.
"""
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_serving import write_port_checkpoint
from unirec_tpu_torch.ops import op_schemas
from unirec_tpu_torch.serving.cpp import build as CB
from unirec_tpu_torch.serving.cpp import tensor_io
from unirec_tpu_torch.serving.export import ServingModel, export_model, in_shapes, seeded_inputs

BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def client():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return CB.build_client(cuda=False)["binary"]


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    """An unfused SASRec's ``score`` package and a fused one's ``user_emb``
    package, both at batch 8."""
    tmp = tmp_path_factory.mktemp("aoti")
    plain = write_port_checkpoint(tmp / "plain.pkl", n_layers=2)
    fused = write_port_checkpoint(tmp / "fused.pkl", n_layers=2, last_query_only=1,
                                  fused_layer=1, fused_lastq=1)
    out = {}
    for name, ckpt, fn in (("plain", plain, "score"), ("fused", fused, "user_emb")):
        art = str(tmp / name)
        out[name] = (export_model(ckpt, art, aoti=[fn], aoti_batch=BATCH, device="cpu"), art)
    return out


def _inputs(fn, manifest):
    shapes = in_shapes(fn, BATCH, manifest["max_seq_len"], 32)
    return [t.numpy() for t in seeded_inputs(shapes, BATCH, manifest["n_items"], "cpu")]


def test_client_serves_the_package_as_python_does(client, packages):
    man, art = packages["plain"]
    ins = _inputs("score", man)
    got = CB.run_client(client, os.path.join(art, "score.aoti.pt2"), ins, repeat=3)
    assert got["device"] == "cpu" and got["calls"] == 4
    assert set(got["launches"]) == {op_schemas.qualname(n) for n in op_schemas.SCHEMAS}
    assert not any(got["launches"].values())
    ref = ServingModel(art).score(*ins)
    assert got["outputs"][0].shape == ref.shape == (BATCH, 32)
    np.testing.assert_allclose(got["outputs"][0], ref, atol=1e-5, rtol=1e-5)
    assert got["seconds_per_call"] > 0
    assert man["functions"]["score"]["aoti"]["custom_ops"] == []


def test_client_schemas_equal_torch_ops(client):
    mine = CB.client_schemas(client)
    assert mine == [str(getattr(torch.ops.unirec, n).default._schema) for n in op_schemas.SCHEMAS]


def test_client_refuses_an_operator_it_does_not_register(client, packages):
    man, art = packages["fused"]
    info = man["functions"]["user_emb"]["aoti"]
    assert info["custom_ops"] == ["unirec::lastq_fwd", "unirec::layer_fwd"]
    with pytest.raises(subprocess.CalledProcessError) as err:
        CB.run_client(client, os.path.join(art, "user_emb.aoti.pt2"), _inputs("user_emb", man))
    assert err.value.returncode == 3
    assert "refusing" in err.value.stderr and "unirec::lastq_fwd" in err.value.stderr


def test_fused_package_runs_through_the_operators_in_python(packages):
    """The package calls the operators through AOTInductor's proxy
    executor, here their CPU implementations: the .pt2 program's values."""
    man, art = packages["fused"]
    ins = _inputs("user_emb", man)
    run = torch._inductor.aoti_load_package(os.path.join(art, "user_emb.aoti.pt2"))
    with torch.no_grad():
        got = run(*[torch.as_tensor(a) for a in ins]).numpy()
    np.testing.assert_allclose(got, ServingModel(art).user_emb(*ins), atol=1e-5, rtol=1e-5)


def test_tensor_files_are_the_jax_examples_format(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_tensor_io", Path(__file__).resolve().parents[1] / "examples" / "serving_cpp"
        / "tensor_io.py")
    jax_io = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_io)
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 9, size=(3, 4)).astype(np.int32),
              rng.normal(size=(2, 5)).astype(np.float32), np.zeros(7, np.int32)]
    tensor_io.write_tensors(str(tmp_path / "a.bin"), arrays)
    jax_io.write_tensors(str(tmp_path / "b.bin"), arrays)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    for a, b in zip(tensor_io.read_tensors(str(tmp_path / "b.bin")), arrays):
        np.testing.assert_array_equal(a, b)
