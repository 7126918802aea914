"""Whole-layer and last-query-layer transformer kernels (eval mode).

Counterpart of unirec_tpu/ops/layer.py. Two public wrappers:

- ``fused_transformer_layer``: one post-LN layer (qkv -> masked softmax
  attention -> out-proj -> +res -> LN -> FFN -> +res -> LN), the TPU's
  ``_layer_fwd_kernel``; on CUDA tensors it launches csrc/layer_fwd.cu.
- ``fused_last_query_layer``: the same layer for one query row, the TPU's
  ``_lastq_fwd_kernel``; on CUDA tensors it launches csrc/lastq_fwd.cu.

Beside each wrapper is its plain PyTorch version, which computes the same
function with the same rounding points (every matmul accumulates in f32 and
is cast to the input dtype, then the bias is added in that dtype; softmax
and both LayerNorms run in f32). A wrapper takes the plain version only for
tensors on the CPU; for a CUDA tensor it launches its kernel or raises.
``<wrapper>.launches`` counts kernel launches.

Parameters use the JAX package's tuple, with flax kernels in [in, out]:
((wq,bq),(wk,bk),(wv,bv),(wo,bo),(g1,c1),(w1,b1),(w2,b2),(g2,c2)).
Dropout arrives with the training slice; these are eval-mode kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from unirec_tpu_torch.ops import _build

MASK_VALUE = -1e4  # reference additive mask (sasrec.py:56)
PAD_MASK = -1e30   # hard ban on Lp-padding keys
SUPPORTED_ACTS = ("relu", "swish", "gelu", "tanh", "sigmoid")
_SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def activation(name: str, u: torch.Tensor) -> torch.Tensor:
    """f32 activation of the fused kernels (gelu is the erf form)."""
    if name == "relu":
        return torch.relu(u)
    if name == "swish":
        return u * torch.sigmoid(u)
    if name == "gelu":
        return F.gelu(u)
    if name == "tanh":
        return torch.tanh(u)
    if name == "sigmoid":
        return torch.sigmoid(u)
    raise ValueError(f"unsupported activation for fused layer: {name}")


def _ln(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float):
    mu = r.mean(-1, keepdim=True)
    var = ((r - mu) ** 2).mean(-1, keepdim=True)
    return (r - mu) * torch.rsqrt(var + eps) * g + b


def _dense(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32-accumulated a @ w cast to a's dtype, then + b in that dtype."""
    return (a.float() @ w.float()).to(a.dtype) + b


def _pad_L(x: torch.Tensor, madd: torch.Tensor, L: int):
    """Pad the sequence dim to a multiple of 8; padded keys are banned with
    a hard -1e30 (probability exactly 0; the reference's soft -1e4 lets a
    fully masked row attend uniformly over REAL keys only)."""
    Lp = -(-L // 8) * 8
    if Lp == L:
        return x, madd, L
    x = F.pad(x, (0, 0, 0, Lp - L))
    madd = F.pad(madd, (0, Lp - L), value=PAD_MASK)
    return x, madd, Lp


def _layer_smem_bytes(Lp: int, D: int, F_: int) -> int:
    """csrc/layer_fwd.cu::layer_smem_floats, in bytes."""
    return 4 * (Lp * (D + 1) * 3 + Lp * max(3 * D + 1, F_ + 1)
                + Lp * (Lp + 1) + Lp)


def _lastq_smem_bytes(Lp: int, D: int, F_: int, nh: int) -> int:
    """csrc/lastq_fwd.cu::lastq_smem_floats, in bytes."""
    return 4 * (Lp * (D + 1) + Lp * (2 * D + 1) + Lp + nh * Lp + 5 * D + F_)


def fused_layer_supported(x: torch.Tensor, hidden_act: str, n_heads: int,
                          inner_size: int | None = None) -> bool:
    """Shape gate of both kernels, in the role of the JAX package's
    fused_layer_supported: a supported activation, heads of a width that
    is a multiple of 8, L <= 512, and one example's working set within a
    block's shared memory. Independent of the device: on the CPU the
    wrappers run their plain versions for the same shapes."""
    B, L, D = x.shape
    if hidden_act not in SUPPORTED_ACTS:
        return False
    if D % n_heads or (D // n_heads) % 8 or L > 512:
        return False
    F_ = int(inner_size) if inner_size else 4 * D
    Lp = -(-L // 8) * 8
    return (_layer_smem_bytes(Lp, D, F_) <= _SMEM_LIMIT
            and _lastq_smem_bytes(Lp, D, F_, n_heads) <= _SMEM_LIMIT)


def _check_cuda_inputs(x, madd, flat):
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer kernels take float32 or bfloat16, got {x.dtype}")
    for t in (madd, *flat):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {t.device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# --------------------------------------------------------- whole-layer kernel
def _layer_weights(params, dt):
    """(wqkv, bqkv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2): matmul weights
    and biases in ``dt``, LayerNorm parameters in f32, all contiguous."""
    (wq, bq), (wk, bk), (wv, bv), (wo, bo), (g1, c1), \
        (w1, b1), (w2, b2), (g2, c2) = params
    wqkv = torch.cat([wq, wk, wv], dim=1).to(dt).contiguous()
    bqkv = torch.cat([bq, bk, bv]).to(dt).contiguous()
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    c = lambda t: t.to(dt).contiguous()  # noqa: E731
    return (wqkv, bqkv, c(wo), c(bo), f32(g1), f32(c1), c(w1), c(b1),
            c(w2), c(b2), f32(g2), f32(c2))


def _layer_fwd_plain(x, madd, flat, nh: int, act: str, eps: float,
                     causal: bool) -> torch.Tensor:
    """Plain PyTorch version of csrc/layer_fwd.cu (x pre-padded to Lp)."""
    wqkv, bqkv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2 = flat
    dt = x.dtype
    B, Lp, D = x.shape
    hd = D // nh
    qkv = _dense(x, wqkv, bqkv)
    mfull = madd.float()[:, None, :]
    if causal:
        idx = torch.arange(Lp, device=x.device)
        tri = torch.where(idx[None, :] > idx[:, None],
                          torch.tensor(MASK_VALUE, device=x.device),
                          torch.tensor(0.0, device=x.device))
        mfull = torch.minimum(mfull, tri[None])
    scale = 1.0 / math.sqrt(hd)
    heads = []
    for h in range(nh):
        q = qkv[..., h * hd:(h + 1) * hd].float()
        k = qkv[..., D + h * hd:D + (h + 1) * hd].float()
        v = qkv[..., 2 * D + h * hd:2 * D + (h + 1) * hd].float()
        p = torch.softmax(q @ k.transpose(1, 2) * scale + mfull, dim=-1)
        heads.append((p.to(dt).float() @ v).to(dt))
    o = _dense(torch.cat(heads, dim=-1), wo, bo)
    x1 = _ln((o + x).float(), g1, c1, eps).to(dt)
    hm = activation(act, _dense(x1, w1, b1).float()).to(dt)
    h2 = _dense(hm, w2, b2)
    return _ln((h2 + x1).float(), g2, c2, eps).to(dt)


@functools.cache
def _layer_lib():
    fn = _build.library("layer_fwd").unirec_layer_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _layer_fwd_cuda(x, madd, flat, nh: int, act: str, eps: float,
                    causal: bool) -> torch.Tensor:
    """Launch csrc/layer_fwd.cu on x [B, Lp, D] (Lp a multiple of 8)."""
    _check_cuda_inputs(x, madd, flat)
    x = x.contiguous()
    madd = madd.to(torch.float32).contiguous()
    B, Lp, D = x.shape
    F_ = flat[6].shape[1]
    if _layer_smem_bytes(Lp, D, F_) > _SMEM_LIMIT or D % nh:
        raise ValueError(f"layer_fwd does not take Lp={Lp}, D={D}, F={F_}, nh={nh}")
    y = torch.empty_like(x)
    err = _layer_lib()(_DTYPES[x.dtype], _ptr(x), _ptr(madd),
                       *[_ptr(t) for t in flat], _ptr(y), B, Lp, D, F_, nh,
                       SUPPORTED_ACTS.index(act), int(bool(causal)),
                       float(eps), _build.stream_handle(x.device))
    _build.check(err, "layer_fwd launch")
    fused_transformer_layer.launches += 1
    return y


def fused_transformer_layer(x, madd, params, *, n_heads: int, inner_size: int,
                            hidden_act: str, layer_norm_eps: float,
                            causal: bool) -> torch.Tensor:
    """One whole post-LN transformer layer, eval mode.

    x: [B, L, D] (compute dtype); madd: [B, L] additive key-pad row
    (0 / -10000, or -1e30 on padding); params: the flax parameter tuple
    (module docstring). Returns [B, L, D] in x's dtype."""
    del inner_size  # read from the weights
    B, L, D = x.shape
    xp, mp, _ = _pad_L(x, madd, L)
    flat = _layer_weights(params, x.dtype)
    args = (n_heads, hidden_act, float(layer_norm_eps), bool(causal))
    if x.is_cuda:
        y = _layer_fwd_cuda(xp, mp, flat, *args)
    elif x.device.type == "cpu":
        y = _layer_fwd_plain(xp, mp, flat, *args)
    else:
        raise ValueError(f"no layer_fwd kernel for device {x.device}")
    return y[:, :L]


fused_transformer_layer.launches = 0


# --------------------------------------------------------- last-query kernel
def _lastq_weights(params, dt):
    (wq, bq), (wk, bk), (wv, bv), (wo, bo), (g1, c1), \
        (w1, b1), (w2, b2), (g2, c2) = params
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    c = lambda t: t.to(dt).contiguous()  # noqa: E731
    return (c(wq), c(bq), c(wk), c(bk), c(wv), c(bv), c(wo), c(bo),
            f32(g1), f32(c1), c(w1), c(b1), c(w2), c(b2), f32(g2), f32(c2))


def _lastq_fwd_plain(x, madd, flat, qi: int, nh: int, act: str,
                     eps: float) -> torch.Tensor:
    """Plain PyTorch version of csrc/lastq_fwd.cu (x pre-padded to Lp)."""
    wq, bq, wk, bk, wv, bv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2 = flat
    dt = x.dtype
    B, Lp, D = x.shape
    hd = D // nh
    xq = x[:, qi]
    k = _dense(x, wk, bk)
    v = _dense(x, wv, bv)
    q = _dense(xq, wq, bq)
    mrow = madd.float()
    scale = 1.0 / math.sqrt(hd)
    heads = []
    for h in range(nh):
        sl = slice(h * hd, (h + 1) * hd)
        s = torch.einsum("bd,bld->bl", q[:, sl].float(), k[..., sl].float())
        p = torch.softmax(s * scale + mrow, dim=-1)
        heads.append(torch.einsum("bl,bld->bd", p.to(dt).float(),
                                  v[..., sl].float()).to(dt))
    o = _dense(torch.cat(heads, dim=-1), wo, bo)
    x1 = _ln((o + xq).float(), g1, c1, eps).to(dt)
    hm = activation(act, _dense(x1, w1, b1).float()).to(dt)
    h2 = _dense(hm, w2, b2)
    return _ln((h2 + x1).float(), g2, c2, eps).to(dt)


@functools.cache
def _lastq_lib():
    fn = _build.library("lastq_fwd").unirec_lastq_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 19
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _lastq_fwd_cuda(x, madd, flat, qi: int, nh: int, act: str,
                    eps: float) -> torch.Tensor:
    """Launch csrc/lastq_fwd.cu on x [B, Lp, D]; returns [B, D]."""
    _check_cuda_inputs(x, madd, flat)
    x = x.contiguous()
    madd = madd.to(torch.float32).contiguous()
    B, Lp, D = x.shape
    F_ = flat[10].shape[1]
    if _lastq_smem_bytes(Lp, D, F_, nh) > _SMEM_LIMIT or D % nh \
            or not 0 <= qi < Lp:
        raise ValueError(f"lastq_fwd does not take Lp={Lp}, D={D}, F={F_}, "
                         f"nh={nh}, qi={qi}")
    y = torch.empty((B, D), dtype=x.dtype, device=x.device)
    err = _lastq_lib()(_DTYPES[x.dtype], _ptr(x), _ptr(madd),
                       *[_ptr(t) for t in flat], _ptr(y), B, Lp, D, F_, nh,
                       int(qi), SUPPORTED_ACTS.index(act), float(eps),
                       _build.stream_handle(x.device))
    _build.check(err, "lastq_fwd launch")
    fused_last_query_layer.launches += 1
    return y


def fused_last_query_layer(x, madd, params, *, n_heads: int, inner_size: int,
                           hidden_act: str, layer_norm_eps: float,
                           q_index: int | None = None) -> torch.Tensor:
    """The layer for query row ``q_index`` only (default L-1; callers on
    pre-padded inputs pass the last REAL row). Same parameter tuple as
    fused_transformer_layer. Returns [B, D]."""
    del inner_size
    B, L, D = x.shape
    qi = int(L - 1 if q_index is None else q_index)
    xp, mp, _ = _pad_L(x, madd, L)
    flat = _lastq_weights(params, x.dtype)
    args = (qi, n_heads, hidden_act, float(layer_norm_eps))
    if x.is_cuda:
        return _lastq_fwd_cuda(xp, mp, flat, *args)
    if x.device.type == "cpu":
        return _lastq_fwd_plain(xp, mp, flat, *args)
    raise ValueError(f"no lastq_fwd kernel for device {x.device}")


fused_last_query_layer.launches = 0
