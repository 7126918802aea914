"""Attention: the short-sequence fused kernels and flash attention.

Counterpart of unirec_tpu/ops/attention.py, whose two Pallas paths each
have a Hopper kernel here.

Fused short-sequence path. ``fused_attention`` (q, k, v [B, H, L, hd],
additive mask [B, 1 or H, L, L]) computes softmax(q k^T / sqrt(hd) + mask)
with in-kernel dropout, times v, as the TPU's ``_fused_fwd_kernel``; its
backward is the TPU's ``_fused_bwd_kernel``. It is a
``torch.autograd.Function``: on CUDA tensors the two directions launch
csrc/attention.cu, on CPU tensors they run their plain versions,
``_fwd_plain`` and ``_bwd_plain``, which round where the Pallas kernels
round (products of input-dtype values summed in f32, the scale on the f32
scores, f32 softmax, the dropped probabilities cast to the input dtype
before the product with v; in the backward z and ds cast before their
products, dq and dk scaled after theirs). ``fused_attention.launches`` and
``fused_attention_bwd.launches`` count kernel launches. The kernels take
every L the JAX gate takes (L <= 512) at every head width: while one
head's K, V and their f32 gradients fit a block's shared memory (L <= 285
at head width 32) the whole-sequence kernels run, beyond that their tiled
pair, which holds at most 128 columns of the head width at once, with the
same results. bf16 at L <= 64 and head width <= 64 runs a third body in
each direction, on the tensor cores (``_fwd_body``, ``_bwd_body``;
``fused_attention.launches_mma`` and ``fused_attention_bwd.launches_mma``
count them), held to the plain versions within their tolerances.

Padding: the JAX wrapper pads L to a multiple of 8 and gives the padded keys
-1e30, which makes their probability exactly 0 and leaves every real row's
result as it is; the port does not pad. The soft -1e4 of the model's mask
stays, so a row whose keys are all masked attends uniformly over the real
keys.

Dropout: the TPU kernels draw on the TPU's hardware PRNG. Here the element
(row i, key j) of head h of example b is kept iff ``philox_bits(seed, h, b0
+ b, i * L + j) >= round(p * 2^32)`` (ops/layer.py; b0 the global index of
the first example, a data-parallel rank's row offset), in the kernels and
in the plain versions alike, so the card holds kernel against plain version with
dropout on and the backward replays the forward's mask.

Flash attention. ``flash_attention(q, k, v, mask)`` is the TPU's
``_fwd_kernel`` (online softmax over key blocks, f32 products with the
scale on f32 q, the output in q's dtype and the row logsumexp in f32); on
CUDA tensors it launches csrc/flash_attention.cu, on CPU tensors its plain
version ``_flash_fwd_plain``. bf16 at head widths up to 128 runs on the
tensor cores (the scale on the f32 scores, p as two bf16 halves for P V),
f32 and wider bf16 heads on the CUDA cores (``_flash_body``). Its
backward is the JAX package's ``_flash_bwd``, plain XLA there and plain
torch ops here, recomputing the probabilities from the saved lse (the
scale after the product, ``delta`` from the rounded output). ``causal_attention`` is the JAX entry point:
flash attention where ``flash_supported`` (the JAX device gate: L >= 256,
L and hd multiples of 8) takes the shape, else ``xla_attention``.
``flash_attention.launches`` counts kernel launches.

Both forward kernels are ``torch.library`` operators as ops/layer.py's are,
``unirec::attention_fwd`` and ``unirec::flash_fwd`` (ops/op_schemas.py),
whose outputs keep the kernels' [B, L, H, hd] memory layout on either
device.

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
                                        _ptr, define_op, drop_params, keep_mask,
                                        needs_grad)

MASK_VALUE = -1e4           # the reference additive mask (sasrec.py:56)
MAX_FUSED_SEQ_LEN = 512     # unirec_tpu/ops/attention.py:179
MIN_FLASH_SEQ_LEN = 256     # unirec_tpu/ops/attention.py:119
FLASH_MMA_MAX_HEAD_DIM = 128  # the bf16 tensor-core flash body, csrc/flash_attention.cu::kMaxHd
_FLASH_DC = 128             # head-width columns of the CUDA-core flash body, ::kDc
_ROWS = 32                  # query rows per tile, csrc/attention.cu::kRows
_KEYS = 32                  # key rows per tile of the tiled kernels, ::kKeys
_DC = 128                   # head-width columns the tiled kernels hold at once, ::kDc
MMA_MAX_LEN = 64            # the bf16 tensor-core bodies, ::kMmaMaxLen
MMA_MAX_HEAD_DIM = 64       # ::kMmaMaxHd


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


def _fwd_tiled_smem_bytes(L: int, hd: int) -> int:
    """csrc/attention.cu::fwd_tiled_smem_floats, in bytes (at most _DC
    columns of the head width)."""
    dc = min(hd, _DC)
    return 4 * (2 * _ROWS * (dc + 1) + _ROWS * (L + 1) + _KEYS * (dc + 1))


def _bwd_tiled_smem_bytes(L: int, hd: int) -> int:
    """csrc/attention.cu::bwd_tiled_smem_floats, in bytes."""
    dc = min(hd, _DC)
    return 4 * (3 * _ROWS * (dc + 1) + 2 * _ROWS * (L + 1) + 2 * _KEYS * (dc + 1))


def fused_supported(q: torch.Tensor, mask: torch.Tensor) -> bool:
    """The JAX gate (L <= 512, attention.py:405-411) and the mask layouts
    the kernels take, on any device."""
    B, H, L, hd = q.shape
    return L <= MAX_FUSED_SEQ_LEN and mask.dim() == 4 and mask.shape[1] in (1, H)


def _tiled(L: int, hd: int) -> bool:
    """Whether the tiled kernels run: one (example, head)'s K and V, and in
    the backward their f32 gradients, exceed a block's shared memory (L >
    285 at head width 32). The tiled pair holds at most _DC columns of the
    head width and a query tile's [32, L] score rows, which fit at every L
    the gate takes."""
    return max(_fwd_smem_bytes(L, hd), _bwd_smem_bytes(L, hd)) > _SMEM_LIMIT


def _bwd_body(dtype: torch.dtype, L: int, hd: int) -> str:
    """The body of csrc/attention.cu that runs the backward (its rule
    ``mma_takes``, then ``_tiled``): "mma", the bf16 tensor-core body
    (L <= 64, head width <= 64); else the CUDA-core "whole"-sequence body or
    its "tiled" pair."""
    if dtype == torch.bfloat16 and L <= MMA_MAX_LEN and hd <= MMA_MAX_HEAD_DIM:
        return "mma"
    return "tiled" if _tiled(L, hd) else "whole"


def _fwd_body(dtype: torch.dtype, L: int, hd: int) -> str:
    """The body of csrc/attention.cu that runs the forward, by the backward's
    rule (``mma_takes``): "mma", the bf16 tensor-core body; else "whole" or
    "tiled" on the CUDA cores."""
    return _bwd_body(dtype, L, hd)


# ------------------------------------------------------------ plain versions
def _keep(drop: Drop, B: int, H: int, L: int, device) -> Optional[torch.Tensor]:
    """[B, H, L, L] keep mask (site h for head h), or None without dropout."""
    if drop.t_attn == 0:
        return None
    return torch.stack([keep_mask(drop.seed, drop.t_attn, h, B, (L, L), device, drop.b0)
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
    if not (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = mask.float().expand(B, mask.shape[1], L, L).contiguous()
    return q, k, v, mask


def _empty_out(q: torch.Tensor) -> torch.Tensor:
    """A [B, H, L, hd] output laid out as [B, L, H, hd] in memory, which the
    caller's head merge reads without a copy."""
    B, H, L, hd = q.shape
    return torch.empty((B, L, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_QKV = [_P] * 3 + [_LL] * 3            # q, k, v and their shared strides
_TAIL = [_I] * 4 + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                    ctypes.c_uint32]


@functools.cache
def _entry(name: str):
    fn = getattr(_build.library("attention"), f"unirec_attention_{name}")
    if name == "fwd":   # ..., mask, Hm, out + strides, B, H, L, hd, drop, tiled, stream
        fn.argtypes = [_I] + _QKV + [_P, _I] + [_P] + [_LL] * 3 + _TAIL + [_I, _P]
    else:               # ..., dout + strides, dq, dk, dv + strides, scratch, ..., stream
        fn.argtypes = ([_I] + _QKV + [_P, _I] + [_P] + [_LL] * 3 + [_P] * 3 + [_LL] * 3
                       + [_P] + _TAIL + [_P])
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
                        float(drop.inv_attn), drop.b0, int(_tiled(L, hd)),
                        _build.stream_handle(q.device))
    _build.check(err, "attention forward launch")
    fused_attention.launches += 1
    fused_attention.launches_mma += _fwd_body(q.dtype, L, hd) == "mma"
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
    body = _bwd_body(q.dtype, L, hd)
    # the tiled kernel sums dK and dV in f32 device memory of its own
    scratch = torch.empty((2, B * H, L, hd), dtype=torch.float32,
                          device=q.device) if body == "tiled" else None
    err = _entry("bwd")(_DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), *_strides(q),
                        _ptr(mask), mask.shape[1], _ptr(do), *_strides(do),
                        _ptr(dq), _ptr(dk), _ptr(dv), *_strides(dq),
                        None if scratch is None else _ptr(scratch),
                        B, H, L, hd, 1.0 / math.sqrt(hd), drop.seed, drop.t_attn,
                        float(drop.inv_attn), drop.b0, _build.stream_handle(q.device))
    _build.check(err, "attention backward launch")
    fused_attention_bwd.launches += 1
    fused_attention_bwd.launches_mma += body == "mma"
    return dq, dk, dv


def fused_attention_bwd(q, k, v, mask, do, drop: Drop = NO_DROP):
    """(dq, dk, dv): the backward kernel on CUDA tensors, its plain version
    on CPU tensors."""
    return _dispatch(q, _bwd_cuda, _bwd_plain, "fused attention backward")(
        q, k, v, mask, do, drop)


fused_attention_bwd.launches = 0
fused_attention_bwd.launches_mma = 0   # of those, the bf16 tensor-core body's


class _FusedAttention(torch.autograd.Function):
    """Only q, k, v, the mask and the dropout seed are kept for the
    backward, which recomputes the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, mask, drop):
        ctx.save_for_backward(q, k, v, mask)
        ctx.drop = drop
        return _attention_fwd_op(q, k, v, mask, drop)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, mask, do, ctx.drop), None, None)


def fused_attention(q, k, v, mask, p_drop: float = 0.0,
                    seed: Optional[int] = None, row_offset: int = 0) -> torch.Tensor:
    """Differentiable masked attention with dropout rate ``p_drop`` on the
    probabilities (drawn from the host-int ``seed``; none without one),
    keyed by global example ``row_offset`` + b. q, k, v: [B, H, L, hd] in
    float32 or bfloat16; mask: additive [B, 1 or H, L or 1, L]. Returns
    [B, H, L, hd] in q's dtype."""
    drop = drop_params(float(p_drop), 0.0, True, seed, row_offset)
    if needs_grad(q, k, v):
        return _FusedAttention.apply(q, k, v, mask, drop)
    return _attention_fwd_op(q, k, v, mask, drop)


fused_attention.launches = 0
fused_attention.launches_mma = 0   # of those, the bf16 tensor-core body's


def short_attention(q, k, v, mask, p_drop: float = 0.0, rng=None,
                    train: bool = False) -> torch.Tensor:
    """The JAX package's ``short_attention`` on a shape that
    ``fused_supported`` takes: the fused kernels, with dropout (one seed
    from the layer's ``DropoutRNG``) in train mode."""
    if not (train and rng is not None and p_drop > 0.0):
        return fused_attention(q, k, v, mask)
    return fused_attention(q, k, v, mask, float(p_drop), rng.seed(),
                           rng.row_offset(q.shape[0]))


# ------------------------------------------------------------ flash attention
def flash_supported(q: torch.Tensor, mask: torch.Tensor) -> bool:
    """The JAX device gate (attention.py:122-129: L >= 256, L and hd
    multiples of 8) and a mask that broadcasts to [B, H, L, L], on any
    device."""
    B, H, L, hd = q.shape
    return (L >= MIN_FLASH_SEQ_LEN and L % 8 == 0 and hd % 8 == 0 and mask.dim() == 4
            and mask.shape[1] in (1, H) and mask.shape[2] in (1, L) and mask.shape[3] == L)


def _flash_fwd_plain(q, k, v, mask):
    """Plain PyTorch version of the forward kernel: (out [B, H, L, hd] in q's
    dtype, lse [B, H, L] f32). The scale multiplies f32 q before the
    product, as in the Pallas kernel (attention.py:50)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() * scale) @ k.float().transpose(-1, -2) + mask.float()
    lse = torch.logsumexp(s, dim=-1)
    out = torch.softmax(s, dim=-1) @ v.float()
    return out.to(q.dtype), lse


def _flash_bwd(q, k, v, mask, out, lse, g):
    """The JAX package's ``_flash_bwd`` (attention.py:143-162) line for line:
    p rebuilt from the saved lse with the scale after the f32 product,
    delta from the output rounded to its dtype; (dq, dk, dv) in the input
    dtype. Its [B, H, L, L] f32 temporaries are the ones XLA materializes."""
    # 1 / sqrt(d) computed in f32, as jnp does it, held as a host float
    scale = float(1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]))))
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    s = (q32 @ k32.transpose(-1, -2)) * scale + mask
    p = torch.exp(s - lse[..., None])
    del s
    dv = p.transpose(-1, -2) @ g32
    dp = g32 @ v32.transpose(-1, -2)
    delta = (g32 * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    del p, dp
    dq = (ds @ k32) * scale
    dk = (ds.transpose(-1, -2) @ q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_MQ, _MK = 64, 64   # csrc/flash_attention.cu::kMQ, kMK (bf16 body)


def _flash_body(dtype: torch.dtype, hd: int) -> str:
    """The body of csrc/flash_attention.cu that runs the forward: "mma", the
    bf16 tensor-core body (head width <= 128); else "cuda", the CUDA-core
    body (f32, and wider bf16 heads), which holds at most 128 head-width
    columns at once."""
    return "mma" if dtype == torch.bfloat16 and hd <= FLASH_MMA_MAX_HEAD_DIM else "cuda"


def _flash_smem_bytes(dtype: torch.dtype, hd: int, H: int, mask_heads: bool) -> int:
    """csrc/flash_attention.cu::unirec_flash_fwd_smem_bytes: the CUDA-core
    body's tiles (at most 128 columns of the head width), or the bf16 body's
    two stages of K, V and mask tiles for a group of heads (at most 4 /
    ceil(hd / 16) of them)."""
    if _flash_body(dtype, hd) == "cuda":
        dc = min(hd, _FLASH_DC)
        return 4 * (2 * 32 * (dc + 1) + 2 * 32 * (dc + 1) + 32 * 33 + 3 * 32)
    hd16 = -(-hd // 16)
    G = min(1 if hd16 >= 4 else 4 // hd16, H)
    return 2 * (2 * G * _MK * (16 * hd16 + 8) * 2 + (G if mask_heads else 1) * _MQ * _MK * 4)


def _aligned(*ts, elems: int) -> bool:
    """Whether each tensor starts on 16 bytes and its batch, head and row
    strides are multiples of ``elems`` elements (16 bytes): the bf16 flash
    body copies 16-byte chunks."""
    return all(t.data_ptr() % 16 == 0 and all(s % elems == 0 for s in t.stride()[:3])
               for t in ts)


@functools.cache
def _flash_entry():
    fn = _build.library("flash_attention").unirec_flash_fwd
    # dtype, q, k, v + strides, mask + strides, out + strides, lse, B, H, L,
    # hd, scale, stream
    fn.argtypes = ([_I] + _QKV + [_P] + [_LL] * 3 + [_P] + [_LL] * 3 + [_P]
                   + [_I] * 4 + [ctypes.c_float, _P])
    fn.restype = ctypes.c_int
    return fn


def _flash_fwd_cuda(q, k, v, mask):
    """Launch csrc/flash_attention.cu: (out, lse) as ``_flash_fwd_plain``.
    q, k, v go by strides (copied only when they do not share one stride
    set with a contiguous last axis); the mask by strides too, 0 on the
    axes where it broadcasts, so [B, 1, L, L] is read as it is."""
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, L, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape or not flash_supported(q, mask):
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(mask.shape)}")
    for t in (k, v, mask):
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, got {t.device}")
    mma = _flash_body(q.dtype, hd) == "mma"
    if not (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1
            and (not mma or _aligned(q, k, v, elems=8))):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    m = mask.float()
    if m.stride(-1) != 1 or (mma and not _aligned(m, elems=4)):
        m = m.contiguous()
    m = m.expand(B, H, L, L)
    out = _empty_out(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    err = _flash_entry()(_DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), *_strides(q),
                         _ptr(m), *_strides(m), _ptr(out), *_strides(out), _ptr(lse),
                         B, H, L, hd, 1.0 / math.sqrt(hd), _build.stream_handle(q.device))
    _build.check(err, "flash attention launch")
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Saves q, k, v, the mask as the caller gave it (not broadcast per
    head), the output and lse; the backward recomputes the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        out, lse = FLASH_FWD_OP(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, mask.float(), out, lse, g), None)


def flash_attention(q, k, v, mask) -> torch.Tensor:
    """Differentiable masked attention for long sequences. q, k, v: [B, H,
    L, hd] in float32 or bfloat16; mask: additive f32 [B, 1 or H, L or 1,
    L]. Returns [B, H, L, hd] in q's dtype."""
    if needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, mask)
    return FLASH_FWD_OP(q, k, v, mask)[0]


flash_attention.launches = 0


# -------------------------------------------------------- custom operators
# unirec::attention_fwd (row 10) and unirec::flash_fwd (row 9), ops/op_schemas.py:
# q, k, v [B, H, L, hd] as the caller gives them, the additive mask, dropout
# as (seed, keep threshold, 1/(1-p), first example's global index) of the
# probabilities. The outputs keep
# the kernels' layout ([B, L, H, hd] in memory) on either device, so an
# exported graph has one layout. Each implementation looks its function up
# by name at the call (chip_smoke.py's plain_versions patches them).
def _in_out_layout(q: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    o = _empty_out(q)
    if out.stride() == o.stride():
        return out
    return o.copy_(out)


def _attention_op(fn: str):
    def impl(q, k, v, mask, seed, t_attn, inv_attn, b0=0):
        return _in_out_layout(q, globals()[fn](q, k, v, mask,
                                               Drop(seed, t_attn, 0, inv_attn, 1.0, b0)))
    return impl


def _flash_op(fn: str):
    def impl(q, k, v, mask):
        out, lse = globals()[fn](q, k, v, mask)
        return _in_out_layout(q, out), lse.contiguous()
    return impl


ATTENTION_FWD_OP = define_op("attention_fwd", _attention_op("_fwd_plain"),
                             _attention_op("_fwd_cuda"),
                             lambda q, k, v, mask, *a: _empty_out(q))
FLASH_FWD_OP = define_op("flash_fwd", _flash_op("_flash_fwd_plain"), _flash_op("_flash_fwd_cuda"),
                         lambda q, k, v, mask: (_empty_out(q), q.new_empty(q.shape[:3],
                                                                          dtype=torch.float32)))


def _attention_fwd_op(q, k, v, mask, drop: Drop = NO_DROP) -> torch.Tensor:
    return ATTENTION_FWD_OP(q, k, v, mask, drop.seed, drop.t_attn, float(drop.inv_attn),
                            drop.b0)


def causal_attention(q, k, v, mask, use_pallas: bool = True) -> torch.Tensor:
    """Masked attention entry point (attention.py:442-450): flash attention
    when ``flash_supported`` takes the shape, ``xla_attention`` otherwise."""
    if use_pallas and flash_supported(q, mask):
        return flash_attention(q, k, v, mask)
    return xla_attention(q, k, v, mask)
