"""HSTU's attention: causal pointwise attention with a learned
relative-position bias (Zhai et al., ICML 2024, arXiv:2402.17152).

For q, k [B, L, H, dqk], v [B, L, H, dv], a table ``rab`` of 2L - 1 f32
values shared by the heads and ``keys`` [B, L] (False at padding keys):

    s_ij = q_i . k_j + rab[j - i + L - 1]
    a_ij = SiLU(s_ij) / L  for j <= i and keys[j], else 0
    o_i  = sum_j a_ij v_j

There is no softmax. The JAX package has no HSTU, so this replaces no TPU
kernel; it is the one kernel of the port that computes this function
(csrc/hstu_attention.cu). ``hstu_attention`` is a ``torch.autograd.Function``:
on CUDA tensors the forward and the backward launch the kernel's
tensor-core bodies and never materialize an [L, L] tile in device memory;
on CPU tensors they run the plain versions ``_fwd_plain`` and
``_bwd_plain``, which round where the kernels round: q k^T of bf16 values
summed in f32, the bias, SiLU and 1/L in f32, a rounded to the input dtype
before its product with v; in the backward ds rounded before its products
with k and q, and the table's gradient summed from the unrounded f32 ds.
On the card the kernels take bf16 alone, and their C entry points refuse a
shape past their capacity; either raises a ValueError. Nothing falls back
to the plain versions on the card, where they would store [B, H, L, L] f32.

``hstu_attention.launches`` counts forward calls, ``launches_mma`` the
tensor-core kernel's and ``launches_plain`` the plain version's;
``hstu_attention_bwd`` counts the backward likewise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from unirec_tpu_torch.ops import _build
from unirec_tpu_torch.ops.layer import _dispatch, _ptr

_PAST_CAPACITY = -1   # csrc/hstu_attention.cu::kPastCapacity


def rel_index(L: int, device) -> torch.Tensor:
    """[L, L] long: the table index j - i + L - 1 of query i and key j."""
    r = torch.arange(L, device=device)
    return r[None, :] - r[:, None] + (L - 1)


# ------------------------------------------------------------ plain versions
def _allowed(keys: torch.Tensor, L: int) -> torch.Tensor:
    """[B, 1, L, L] bool: key j at or before row i, and not padding."""
    tri = torch.ones(L, L, dtype=torch.bool, device=keys.device).tril()
    return tri[None, None] & keys.bool()[:, None, None, :]


def _scores(q, k, rab):
    """[B, H, L, L] f32: q k^T plus the bias of each pair's offset."""
    L = q.shape[1]
    return torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) + \
        rab.float()[rel_index(L, q.device)]


def _fwd_plain(q, k, v, rab, keys) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: [B, L, H, dv] in q's dtype."""
    L = q.shape[1]
    s = _scores(q, k, rab)
    a = torch.where(_allowed(keys, L), s * torch.sigmoid(s) * (1.0 / L), 0.0)
    return torch.einsum("bhij,bjhd->bihd", a.to(q.dtype).float(), v.float()).to(q.dtype)


def _bwd_plain(q, k, v, rab, keys, g):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv, drab),
    drab [2L - 1] f32."""
    dt, L = q.dtype, q.shape[1]
    s = _scores(q, k, rab)
    ok = _allowed(keys, L)
    sg = torch.sigmoid(s)
    a = torch.where(ok, s * sg * (1.0 / L), 0.0)
    da = torch.einsum("bihd,bjhd->bhij", g.float(), v.float())
    ds = torch.where(ok, da * sg * (1.0 + s * (1.0 - sg)) * (1.0 / L), 0.0)
    dv = torch.einsum("bhij,bihd->bjhd", a.to(dt).float(), g.float()).to(dt)
    dsr = ds.to(dt).float()
    dq = torch.einsum("bhij,bjhd->bihd", dsr, k.float()).to(dt)
    dk = torch.einsum("bhij,bihd->bjhd", dsr, q.float()).to(dt)
    drab = torch.zeros(2 * L - 1, dtype=torch.float32, device=q.device).index_add_(
        0, rel_index(L, q.device).reshape(-1), ds.sum((0, 1)).reshape(-1))
    return dq, dk, dv, drab


def _fwd_plain_counted(q, k, v, rab, keys):
    hstu_attention.launches_plain += 1
    return _fwd_plain(q, k, v, rab, keys)


def _bwd_plain_counted(q, k, v, rab, keys, g):
    hstu_attention_bwd.launches_plain += 1
    return _bwd_plain(q, k, v, rab, keys, g)


# ----------------------------------------------------------------- kernels
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_OPERAND = [_P] + [_LL] * 3            # a tensor and its (batch, row, head) strides


@functools.cache
def _entry(name: str):
    lib = _build.library("hstu_attention")
    fn = getattr(lib, f"unirec_hstu_{name}")
    if name == "fwd":      # q, k, v, keys, rab, out, B, H, L, dqk, dv, stream
        fn.argtypes = _OPERAND * 3 + [_P, _P] + _OPERAND + [_I] * 5 + [_P]
    elif name == "bwd":    # q, k, v, g, keys, rab, dq, dk, dv, ws, ws_bytes, drab, sizes
        fn.argtypes = (_OPERAND * 4 + [_P, _P] + _OPERAND * 3 + [_P, _LL, _P] + [_I] * 5
                       + [_P])
    else:                  # bwd_workspace(B, H, L, dqk, dv, &bytes)
        fn.argtypes = [_I] * 5 + [_P]
    fn.restype = ctypes.c_int
    return fn


def _refused(err: int, what: str, L: int, dqk: int, dv: int) -> None:
    """Raise for an entry point's return code: a ValueError for a shape past
    the kernels' capacity, a RuntimeError for a CUDA error."""
    if err == _PAST_CAPACITY:
        raise ValueError(f"{what}: L {L} with head widths {dqk} and {dv} is past the "
                         f"kernels' capacity (L up to 512, head widths up to 64)")
    _build.check(err, what)


@functools.cache
def _workspace_bytes(device_index: int, B: int, H: int, L: int, dqk: int, dv: int) -> int:
    """Bytes of the backward's workspace, which the kernel sizes: the dQ
    kernel's partial tables of the table's gradient, one a block."""
    n = ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        err = _entry("bwd_workspace")(B, H, L, dqk, dv, ctypes.byref(n))
    _refused(err, "hstu attention backward", L, dqk, dv)
    return n.value


def _strided(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _operand(t: torch.Tensor):
    return (_ptr(t), *(int(s) for s in t.stride()[:3]))


def _check(q, k, v, rab, keys, what: str):
    """Validate CUDA operands; returns (q, k, v, rab, keys) as the kernel
    reads them: a contiguous last axis, rab f32, keys uint8 [B, L]."""
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise ValueError(f"{what}: the kernels take bf16 q, k, v (compute_dtype bfloat16), "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, L, H, dqk = q.shape
    if k.shape != q.shape or v.shape[:3] != (B, L, H) or tuple(keys.shape) != (B, L) \
            or tuple(rab.shape) != (2 * L - 1,):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"rab {tuple(rab.shape)}, keys {tuple(keys.shape)}")
    for t in (k, v, rab, keys):
        if t.device != q.device:
            raise ValueError(f"{what}: all operands must be on {q.device}, got {t.device}")
    return (_strided(q), _strided(k), _strided(v), rab.float().contiguous(),
            keys.to(torch.uint8).contiguous())


def _fwd_cuda(q, k, v, rab, keys) -> torch.Tensor:
    """Launch the forward kernel of csrc/hstu_attention.cu."""
    q, k, v, rab, keys = _check(q, k, v, rab, keys, "hstu attention")
    B, L, H, dqk = q.shape
    dv = v.shape[-1]
    out = torch.empty((B, L, H, dv), dtype=q.dtype, device=q.device)
    err = _entry("fwd")(*_operand(q), *_operand(k), *_operand(v), _ptr(keys), _ptr(rab),
                        *_operand(out), B, H, L, dqk, dv, _build.stream_handle(q.device))
    _refused(err, "hstu attention forward launch", L, dqk, dv)
    hstu_attention.launches_mma += 1
    return out


def _bwd_cuda(q, k, v, rab, keys, g):
    """Launch the backward kernels of csrc/hstu_attention.cu: (dq, dk, dv, drab)."""
    q, k, v, rab, keys = _check(q, k, v, rab, keys, "hstu attention backward")
    B, L, H, dqk = q.shape
    dv = v.shape[-1]
    g = _strided(g.to(q.dtype))
    if g.shape != v.shape:
        raise ValueError(f"hstu attention backward: gradient {tuple(g.shape)}, "
                         f"v {tuple(v.shape)}")
    dq, dk = torch.empty_like(q, memory_format=torch.contiguous_format), \
        torch.empty_like(k, memory_format=torch.contiguous_format)
    dvo = torch.empty((B, L, H, dv), dtype=q.dtype, device=q.device)
    n = _workspace_bytes(q.device.index or 0, B, H, L, dqk, dv)
    ws = torch.empty(n, dtype=torch.uint8, device=q.device)
    drab = torch.empty(2 * L - 1, dtype=torch.float32, device=q.device)
    err = _entry("bwd")(*_operand(q), *_operand(k), *_operand(v), *_operand(g), _ptr(keys),
                        _ptr(rab), *_operand(dq), *_operand(dk), *_operand(dvo),
                        _ptr(ws), n, _ptr(drab), B, H, L, dqk, dv,
                        _build.stream_handle(q.device))
    _refused(err, "hstu attention backward launch", L, dqk, dv)
    hstu_attention_bwd.launches_mma += 1
    return dq, dk, dvo, drab


def hstu_attention_fwd(q, k, v, rab, keys) -> torch.Tensor:
    """The forward: the kernel on CUDA tensors, its plain version on CPU tensors."""
    hstu_attention.launches += 1
    return _dispatch(q, _fwd_cuda, _fwd_plain_counted, "hstu attention")(q, k, v, rab, keys)


def hstu_attention_bwd(q, k, v, rab, keys, g):
    """(dq, dk, dv, drab): the backward kernels on CUDA tensors, their plain
    version on CPU tensors."""
    hstu_attention_bwd.launches += 1
    return _dispatch(q, _bwd_cuda, _bwd_plain_counted, "hstu attention backward")(
        q, k, v, rab, keys, g)


hstu_attention_bwd.launches = 0
hstu_attention_bwd.launches_mma = 0     # of those, the tensor-core kernels'
hstu_attention_bwd.launches_plain = 0   # and the plain version's


class _HSTUAttention(torch.autograd.Function):
    """Keeps q, k, v, the table and the key mask; the backward recomputes
    the scores."""

    @staticmethod
    def forward(ctx, q, k, v, rab, keys):
        ctx.save_for_backward(q, k, v, rab, keys)
        return hstu_attention_fwd(q, k, v, rab, keys)

    @staticmethod
    def backward(ctx, g):
        q, k, v, rab, keys = ctx.saved_tensors
        dq, dk, dv, drab = hstu_attention_bwd(q, k, v, rab, keys, g)
        return dq, dk, dv, drab.to(rab.dtype), None


def hstu_attention(q, k, v, rab, keys) -> torch.Tensor:
    """Differentiable HSTU attention. q, k: [B, L, H, dqk]; v: [B, L, H, dv]
    (bf16 on the card; any strides with a contiguous last axis); rab: [2L - 1]
    f32; keys: [B, L] bool, False at padding. Returns [B, L, H, dv] in q's
    dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rab)):
        return _HSTUAttention.apply(q, k, v, rab, keys)
    return hstu_attention_fwd(q, k, v, rab, keys)


hstu_attention.launches = 0
hstu_attention.launches_mma = 0     # of those, the tensor-core kernel's
hstu_attention.launches_plain = 0   # and the plain version's
