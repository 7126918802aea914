"""Fused pointwise feed-forward, forward and backward.

Counterpart of unirec_tpu/ops/ffn.py: ``fused_ffn(x, w1, b1, w2, b2, act)``
computes act(x @ w1 + b1) @ w2 + b2 for x [T, D], w1 [D, F], w2 [F, D]
(flax layout) without writing the [T, F] activation, as the TPU's
``_fwd_kernel``; its backward, the TPU's ``_bwd_kernel``, recomputes it. A
``torch.autograd.Function``: on CUDA tensors the two directions launch
csrc/ffn.cu, on CPU tensors they run their plain versions ``_fwd_plain``
and ``_bwd_plain``. Both round where the Pallas kernels round: products of
x-dtype values summed in f32, the bias added to the f32 sum, the
activation in f32 and cast to the weights' dtype before the second
product; in the backward dh in f32 and cast to x's dtype before its
products, db1 summed from the f32 dh and db2 from the f32 dy, the weight
gradients summed in f32 and cast to each weight's dtype
(ffn.py:62-101, :201-202). ``fused_ffn.launches`` and
``fused_ffn_bwd.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from unirec_tpu_torch.ops import _build
from unirec_tpu_torch.ops.layer import _DTYPES, _dispatch, _ptr

# activation codes of csrc/common.cuh (gelu is the erf form; leakyrelu's
# slope is 0.01, as jax.nn.leaky_relu)
ACTS = ("relu", "swish", "gelu", "tanh", "sigmoid", "leakyrelu")


def act_and_grad(pre: torch.Tensor, act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activation value and derivative in f32 (ffn.py::_act_and_grad)."""
    if act == "relu":
        return torch.relu(pre), (pre > 0).to(pre.dtype)
    if act == "swish":
        s = torch.sigmoid(pre)
        return pre * s, s * (1.0 + pre * (1.0 - s))
    if act == "sigmoid":
        s = torch.sigmoid(pre)
        return s, s * (1.0 - s)
    if act == "tanh":
        t = torch.tanh(pre)
        return t, 1.0 - t * t
    if act == "gelu":
        phi = 0.5 * (1.0 + torch.erf(pre * (2.0 ** -0.5)))
        pdf = torch.exp(-0.5 * pre * pre) * 0.3989422804014327
        return pre * phi, phi + pre * pdf
    if act == "leakyrelu":
        return F.leaky_relu(pre, 0.01), torch.where(pre > 0, 1.0, 0.01)
    raise ValueError(f"unsupported activation for fused ffn: {act}")


# ------------------------------------------------------------ plain versions
def _pre(x, w1, b1):
    return x.float() @ w1.float() + b1.float()


def _fwd_plain(x, w1, b1, w2, b2, act: str) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel."""
    h, _ = act_and_grad(_pre(x, w1, b1), act)
    return (h.to(w2.dtype).float() @ w2.float() + b2.float()).to(x.dtype)


def _bwd_plain(x, w1, b1, w2, b2, dy, act: str):
    """Plain PyTorch version of the backward kernel: (dx, dw1, db1, dw2, db2)."""
    dt = x.dtype
    h, dact = act_and_grad(_pre(x, w1, b1), act)
    dyc = dy.to(dt).float()
    dh = (dyc @ w2.float().T) * dact
    dhc = dh.to(dt).float()
    dx = (dhc @ w1.float().T).to(dt)
    dw1 = x.float().T @ dhc
    dw2 = h.to(dt).float().T @ dyc
    return (dx, dw1.to(w1.dtype), dh.sum(0).to(b1.dtype), dw2.to(w2.dtype),
            dy.float().sum(0).to(b2.dtype))


# ----------------------------------------------------------------- kernels
def _check(x, w1, b1, w2, b2, act: str):
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (w1, b1, w2, b2)):
        raise TypeError("fused ffn takes float32 or bfloat16 operands of one dtype")
    T, D = x.shape
    Fi = w1.shape[1]
    if w1.shape != (D, Fi) or b1.shape != (Fi,) or w2.shape != (Fi, D) \
            or b2.shape != (D,):
        raise ValueError(f"fused ffn: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if act not in ACTS:
        raise ValueError(f"unsupported activation for fused ffn: {act}")
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {t.device}")
    return T, D, Fi


@functools.cache
def _entry(name: str):
    lib = _build.library("ffn")
    fn = getattr(lib, f"unirec_ffn_{name}")
    if name == "fwd":
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    elif name == "bwd":
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_blocks(dtype: int, T: int, D: int, Fi: int, device_index: int) -> int:
    n = _entry("bwd_blocks")(dtype, T, D, Fi)
    if n <= 0:
        _build.check(-n if n < 0 else 1, "ffn backward occupancy query")
    return n


def _fwd_cuda(x, w1, b1, w2, b2, act: str) -> torch.Tensor:
    """Launch the forward kernel of csrc/ffn.cu."""
    T, D, Fi = _check(x, w1, b1, w2, b2, act)
    x, w1, b1, w2, b2 = (t.contiguous() for t in (x, w1, b1, w2, b2))
    y = torch.empty_like(x)
    err = _entry("fwd")(_DTYPES[x.dtype], _ptr(x), _ptr(w1), _ptr(b1), _ptr(w2),
                        _ptr(b2), _ptr(y), T, D, Fi, ACTS.index(act),
                        _build.stream_handle(x.device))
    _build.check(err, "ffn forward launch")
    fused_ffn.launches += 1
    return y


def _bwd_cuda(x, w1, b1, w2, b2, dy, act: str):
    """Launch the backward kernel of csrc/ffn.cu: (dx, dw1, db1, dw2, db2)."""
    T, D, Fi = _check(x, w1, b1, w2, b2, act)
    x, w1, b1 = x.contiguous(), w1.contiguous(), b1.contiguous()
    dy = dy.to(x.dtype).contiguous()
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    nblk = _bwd_blocks(_DTYPES[x.dtype], T, D, Fi, x.device.index or 0)
    slabs = torch.empty((nblk, 2 * D * Fi + Fi + D), dtype=torch.float32,
                        device=x.device)
    dx = torch.empty_like(x)
    err = _entry("bwd")(_DTYPES[x.dtype], _ptr(x), _ptr(dy), _ptr(w1), _ptr(b1),
                        _ptr(w1t), _ptr(w2t), _ptr(dx), _ptr(slabs), nblk, T, D, Fi,
                        ACTS.index(act), _build.stream_handle(x.device))
    _build.check(err, "ffn backward launch")
    fused_ffn_bwd.launches += 1
    tot = slabs.sum(0)
    dw1, db1, dw2, db2 = torch.split(tot, [D * Fi, Fi, Fi * D, D])
    return (dx, dw1.view(D, Fi).to(w1.dtype), db1.to(b1.dtype),
            dw2.view(Fi, D).to(w2.dtype), db2.to(b2.dtype))


def fused_ffn_bwd(x, w1, b1, w2, b2, dy, act: str):
    """(dx, dw1, db1, dw2, db2): the backward kernel on CUDA tensors, its
    plain version on CPU tensors."""
    return _dispatch(x, _bwd_cuda, _bwd_plain, "fused ffn backward")(
        x, w1, b1, w2, b2, dy, act)


fused_ffn_bwd.launches = 0


class _FusedFFN(torch.autograd.Function):
    """Only the inputs are kept; the backward recomputes the activation."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.act = act
        return _dispatch(x, _fwd_cuda, _fwd_plain, "fused ffn")(x, w1, b1, w2, b2, act)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        return (*fused_ffn_bwd(x, w1, b1, w2, b2, dy, ctx.act), None)


def fused_ffn(x, w1, b1, w2, b2, act: str = "swish") -> torch.Tensor:
    """y = act(x @ w1 + b1) @ w2 + b2, differentiable in every tensor.
    x: [T, D]; w1: [D, F]; b1: [F]; w2: [F, D]; b2: [D]; one dtype
    (float32 or bfloat16). Returns [T, D] in x's dtype."""
    return _FusedFFN.apply(x, w1, b1, w2, b2, act)


fused_ffn.launches = 0

