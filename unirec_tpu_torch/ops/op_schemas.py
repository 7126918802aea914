"""The ``unirec::*`` custom operators: one schema table for both sides.

Each forward kernel that a serving function can reach is a
``torch.library`` operator, so that ``torch.export`` records it as one node
(it traces with fake tensors, on which a ctypes launch cannot run) and a
C++ process can call it. The operator's arguments are its C launcher's
contract: operands already padded, the key-pad row built, the weights
flattened, the activation as its index, dropout as (seed, keep thresholds,
1/(1-p), the global index b0 of the first example, which serving leaves at 0). The Python side (ops/layer.py, ops/attention.py, ops/ffn.py)
defines the operators from this table, with the launch on CUDA tensors and
the plain version on CPU tensors; the C++ client
(serving/cpp/unirec_serve.cc) registers the same strings, written into a
header at its build (serving/cpp/build.py). Nothing here imports torch.
"""
from __future__ import annotations

NAMESPACE = "unirec"

_DROP = "int seed, int t_attn, int t_hidden, float inv_attn, float inv_hidden, int b0=0"

SCHEMAS = {
    "layer_fwd": ("(Tensor x, Tensor madd, Tensor[] flat, int nh, int act, bool causal, "
                  f"float eps, {_DROP}) -> Tensor"),
    "lastq_fwd": ("(Tensor x, Tensor madd, Tensor[] flat, int qi, int nh, int act, "
                  f"float eps, {_DROP}) -> Tensor"),
    "flash_fwd": "(Tensor q, Tensor k, Tensor v, Tensor mask) -> (Tensor, Tensor)",
    "attention_fwd": ("(Tensor q, Tensor k, Tensor v, Tensor mask, int seed, int t_attn, "
                      "float inv_attn, int b0=0) -> Tensor"),
    "ffn_fwd": "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, int act) -> Tensor",
}


def qualname(name: str) -> str:
    return f"{NAMESPACE}::{name}"


def full_schema(name: str) -> str:
    """The schema as ``TORCH_LIBRARY``'s ``def`` takes it: name, then
    arguments and returns."""
    return f"{name}{SCHEMAS[name]}"
