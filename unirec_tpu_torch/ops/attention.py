"""Short-sequence fused attention, forward and backward.

Counterpart of unirec_tpu/ops/attention.py's fused short-sequence path:
``fused_attention`` (q, k, v [B, H, L, hd], additive mask [B, 1 or H, L,
L]) computes softmax(q k^T / sqrt(hd) + mask) with in-kernel dropout,
times v, as the TPU's ``_fused_fwd_kernel``; its backward is the TPU's
``_fused_bwd_kernel``. It is a ``torch.autograd.Function``: on CUDA tensors
the two directions launch csrc/attention.cu, on CPU tensors they run their
plain versions, ``_fwd_plain`` and ``_bwd_plain``, which round where the
Pallas kernels round (products of input-dtype values summed in f32, the
scale on the f32 scores, f32 softmax, the dropped probabilities cast to the
input dtype before the product with v; in the backward z and ds cast before
their products, dq and dk scaled after theirs). ``fused_attention.launches``
and ``fused_attention_bwd.launches`` count kernel launches.

Padding: the JAX wrapper pads L to a multiple of 8 and gives the padded keys
-1e30, which makes their probability exactly 0 and leaves every real row's
result as it is; the port does not pad. The soft -1e4 of the model's mask
stays, so a row whose keys are all masked attends uniformly over the real
keys.

Dropout: the TPU kernels draw on the TPU's hardware PRNG. Here the element
(row i, key j) of head h of example b is kept iff ``philox_bits(seed, h, b,
i * L + j) >= round(p * 2^32)`` (ops/layer.py), in the kernels and in the
plain versions alike, so the card holds kernel against plain version with
dropout on and the backward replays the forward's mask.

``xla_attention`` and ``xla_attention_probs`` are the JAX package's plain
helpers. When ``fused_supported`` declines a shape, the caller
(models/modules.py::MultiHeadAttention) runs its own plain attention, as
the JAX module does; ``short_attention`` is called only for shapes the gate
takes.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from unirec_tpu_torch.ops import _build
from unirec_tpu_torch.ops.layer import (_DTYPES, _SMEM_LIMIT, NO_DROP, Drop, _dispatch,
                                        _ptr, drop_params, keep_mask)

MASK_VALUE = -1e4           # the reference additive mask (sasrec.py:56)
MAX_FUSED_SEQ_LEN = 512     # unirec_tpu/ops/attention.py:179
_ROWS = 32                  # query rows per tile, csrc/attention.cu::kRows


def xla_attention(q, k, v, mask):
    """[B,H,L,D] x [B,1 or H,L,L] additive mask -> [B,H,L,D], plain."""
    return xla_attention_probs(q, k, mask) @ v.to(torch.promote_types(q.dtype, mask.dtype))


def xla_attention_probs(q, k, mask):
    d = q.shape[-1]
    s = (q @ k.transpose(-1, -2)) / torch.sqrt(torch.tensor(float(d), dtype=q.dtype))
    return torch.softmax(s + mask, dim=-1)


# ------------------------------------------------------------------- gate
def _fwd_smem_bytes(L: int, hd: int) -> int:
    """csrc/attention.cu::fwd_smem_floats, in bytes."""
    return 4 * (2 * L * (hd + 1) + _ROWS * (hd + 1) + _ROWS * (L + 1))


def _bwd_smem_bytes(L: int, hd: int) -> int:
    """csrc/attention.cu::bwd_smem_floats, in bytes."""
    return 4 * (4 * L * (hd + 1) + 2 * _ROWS * (hd + 1) + 2 * _ROWS * (L + 1))


def fused_supported(q: torch.Tensor, mask: torch.Tensor) -> bool:
    """The JAX gate (L <= 512, attention.py:405-411) and the mask layouts
    the kernels take, on any device. The kernels themselves take a
    narrower range (``kernels_take``); main.run refuses a configuration
    between the two on the card at startup."""
    B, H, L, hd = q.shape
    return L <= MAX_FUSED_SEQ_LEN and mask.dim() == 4 and mask.shape[1] in (1, H)


def kernels_take(L: int, hd: int) -> bool:
    """Whether csrc/attention.cu takes sequences of L rows at head width hd:
    one (example, head)'s K and V, and in the backward their f32
    gradients, fit in a block's shared memory (L <= 285 at head width 32)."""
    return max(_fwd_smem_bytes(L, hd), _bwd_smem_bytes(L, hd)) <= _SMEM_LIMIT


# ------------------------------------------------------------ plain versions
def _keep(drop: Drop, B: int, H: int, L: int, device) -> Optional[torch.Tensor]:
    """[B, H, L, L] keep mask (site h for head h), or None without dropout."""
    if drop.t_attn == 0:
        return None
    return torch.stack([keep_mask(drop.seed, drop.t_attn, h, B, (L, L), device)
                        for h in range(H)], dim=1)


def _probs(q, k, mask, drop: Drop):
    """(y, keep): the f32 softmax of the scaled scores plus mask, and the
    dropout keep mask."""
    B, H, L, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale + mask.float()
    return torch.softmax(s, dim=-1), _keep(drop, B, H, L, q.device)


def _dropped(y, keep, drop: Drop):
    return y if keep is None else torch.where(keep, y * drop.inv_attn, 0.0)


def _fwd_plain(q, k, v, mask, drop: Drop = NO_DROP) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel."""
    y, keep = _probs(q, k, mask, drop)
    return (_dropped(y, keep, drop).to(q.dtype).float() @ v.float()).to(q.dtype)


def _bwd_plain(q, k, v, mask, do, drop: Drop = NO_DROP):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv)."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    y, keep = _probs(q, k, mask, drop)
    dof = do.float()
    dy = _dropped(dof @ v.float().transpose(-1, -2), keep, drop)
    t = (dy * y).sum(-1, keepdim=True)
    ds = (y * (dy - t)).to(dt).float()
    dv = (_dropped(y, keep, drop).to(dt).float().transpose(-1, -2) @ dof).to(dt)
    dq = ((ds @ k.float()) * scale).to(dt)
    dk = ((ds.transpose(-1, -2) @ q.float()) * scale).to(dt)
    return dq, dk, dv


# ----------------------------------------------------------------- kernels
def _strides(t: torch.Tensor):
    return tuple(int(s) for s in t.stride()[:3])


def _operands(q, k, v, mask):
    """Validate CUDA operands; q, k, v sharing one stride set with a
    contiguous last axis (copied to contiguous otherwise), and the mask as
    a contiguous [B, Hm, L, L] f32."""
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"fused attention takes float32 or bfloat16 q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, L, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape or mask.dim() != 4 \
            or mask.shape[1] not in (1, H):
        raise ValueError(f"fused attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(mask.shape)}")
    for t in (k, v, mask):
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, got {t.device}")
    if not kernels_take(L, hd):
        raise ValueError(f"fused attention kernels do not take L={L}, hd={hd}: one "
                         "head's K, V and their gradients exceed a block's shared memory")
    if not (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = mask.float().expand(B, mask.shape[1], L, L).contiguous()
    return q, k, v, mask


def _empty_out(q: torch.Tensor) -> torch.Tensor:
    """A [B, H, L, hd] output laid out as [B, L, H, hd] in memory, which the
    caller's head merge reads without a copy."""
    B, H, L, hd = q.shape
    return torch.empty((B, L, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)


@functools.cache
def _entry(name: str):
    fn = getattr(_build.library("attention"), f"unirec_attention_{name}")
    n_ptr_strides = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_void_p, ctypes.c_int]
    if name == "fwd":
        mid = [ctypes.c_void_p] + [ctypes.c_longlong] * 3
    else:
        mid = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3 \
            + [ctypes.c_longlong] * 3
    fn.argtypes = ([ctypes.c_int] + n_ptr_strides + mid + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _fwd_cuda(q, k, v, mask, drop: Drop = NO_DROP) -> torch.Tensor:
    """Launch the forward kernel of csrc/attention.cu."""
    q, k, v, mask = _operands(q, k, v, mask)
    B, H, L, hd = q.shape
    out = _empty_out(q)
    err = _entry("fwd")(_DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), *_strides(q),
                        _ptr(mask), mask.shape[1], _ptr(out), *_strides(out),
                        B, H, L, hd, 1.0 / math.sqrt(hd), drop.seed, drop.t_attn,
                        float(drop.inv_attn), _build.stream_handle(q.device))
    _build.check(err, "attention forward launch")
    fused_attention.launches += 1
    return out


def _bwd_cuda(q, k, v, mask, do, drop: Drop = NO_DROP):
    """Launch the backward kernel of csrc/attention.cu: (dq, dk, dv)."""
    q, k, v, mask = _operands(q, k, v, mask)
    B, H, L, hd = q.shape
    do = do.to(q.dtype)
    if do.shape != q.shape:
        raise ValueError(f"fused attention backward: dout {tuple(do.shape)}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    dq, dk, dv = _empty_out(q), _empty_out(q), _empty_out(q)
    err = _entry("bwd")(_DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), *_strides(q),
                        _ptr(mask), mask.shape[1], _ptr(do), *_strides(do),
                        _ptr(dq), _ptr(dk), _ptr(dv), *_strides(dq),
                        B, H, L, hd, 1.0 / math.sqrt(hd), drop.seed, drop.t_attn,
                        float(drop.inv_attn), _build.stream_handle(q.device))
    _build.check(err, "attention backward launch")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


def fused_attention_bwd(q, k, v, mask, do, drop: Drop = NO_DROP):
    """(dq, dk, dv): the backward kernel on CUDA tensors, its plain version
    on CPU tensors."""
    return _dispatch(q, _bwd_cuda, _bwd_plain, "fused attention backward")(
        q, k, v, mask, do, drop)


fused_attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    """Only q, k, v, the mask and the dropout seed are kept for the
    backward, which recomputes the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, mask, drop):
        ctx.save_for_backward(q, k, v, mask)
        ctx.drop = drop
        return _dispatch(q, _fwd_cuda, _fwd_plain, "fused attention")(q, k, v, mask, drop)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, mask, do, ctx.drop), None, None)


def fused_attention(q, k, v, mask, p_drop: float = 0.0,
                    seed: Optional[int] = None) -> torch.Tensor:
    """Differentiable masked attention with dropout rate ``p_drop`` on the
    probabilities (drawn from the host-int ``seed``; none without one).
    q, k, v: [B, H, L, hd] in float32 or bfloat16; mask: additive [B, 1 or
    H, L or 1, L]. Returns [B, H, L, hd] in q's dtype."""
    drop = drop_params(float(p_drop), 0.0, True, seed)
    return _FusedAttention.apply(q, k, v, mask, drop)


fused_attention.launches = 0


def short_attention(q, k, v, mask, p_drop: float = 0.0, rng=None,
                    train: bool = False) -> torch.Tensor:
    """The JAX package's ``short_attention`` on a shape that
    ``fused_supported`` takes: the fused kernels, with dropout (one seed
    from the layer's ``DropoutRNG``) in train mode."""
    drop = float(p_drop) if train and rng is not None else 0.0
    return fused_attention(q, k, v, mask, drop, rng.seed() if drop > 0.0 else None)
