"""Whole-layer and last-query-layer transformer kernels, forward and backward.

Counterpart of unirec_tpu/ops/layer.py. Two public wrappers, each a
``torch.autograd.Function``:

- ``fused_transformer_layer``: one post-LN layer (qkv -> masked softmax
  attention -> dropout -> out-proj -> dropout -> +res -> LN -> FFN ->
  dropout -> +res -> LN), the TPU's ``_layer_fwd_kernel``; its backward
  ``layer_bwd`` is the TPU's ``_layer_bwd_kernel``. On CUDA tensors they
  launch csrc/layer_fwd.cu and csrc/layer_bwd.cu.
- ``fused_last_query_layer``: the same layer for one query row, the TPU's
  ``_lastq_fwd_kernel``; backward ``lastq_bwd`` (``_lastq_bwd_kernel``),
  csrc/lastq_fwd.cu and csrc/lastq_bwd.cu.

Beside each kernel is its plain PyTorch version, which computes the same
function with the same rounding points (every matmul accumulates in f32 and
is cast to the input dtype, then the bias is added in that dtype; softmax
and both LayerNorms run in f32; the backward casts dh2, du, do, dctx, ds
and dq|dk|dv to the input dtype where the Pallas kernel does). A wrapper
takes the plain version only for tensors on the CPU; for a CUDA tensor it
launches its kernel or raises. ``<wrapper>.launches`` counts launches.
All four kernels have two bodies each: in bf16 with Lp <= 64, D and the
head width multiples of 16 up to 64 and F a multiple of 16 the tensor
cores' (``_layer_fwd_body``, ``_layer_bwd_body``, ``_lastq_fwd_body``,
``_lastq_bwd_body``; ``fused_transformer_layer.launches_mma``,
``layer_bwd.launches_mma``, ``fused_last_query_layer.launches_mma`` and
``lastq_bwd.launches_mma`` count them), else the CUDA cores'. The wrapper
names the body to the C entry point, which refuses a tensor-core launch its
own rule does not admit.

Dropout. The TPU kernels draw on the TPU's hardware PRNG, which no other
machine reproduces. Here the masks come from Philox4x32-10 keyed by (seed,
site, example index, element index): site h for head h's attention
probabilities, nh for the attention output and nh+1 for the FFN output,
as the JAX kernels number them; element i*Lp+j for a probability, i*D+c
for a hidden value. An element is kept iff its 32 random bits are >=
round(p * 2^32), the JAX package's rule. The mask depends on no block or
grid size, and ``philox_bits`` computes the kernels' bits exactly in int64
arithmetic, so the card holds kernel against plain version with dropout
on. A kept hidden value is scaled by 1/(1-p) in f32 and rounded to the
input dtype (the JAX kernels multiply a bf16 value by a weak-typed scalar,
which rounds 1/(1-p) to bf16 first).

Operators. Both forward kernels are ``torch.library`` operators,
``unirec::layer_fwd`` and ``unirec::lastq_fwd`` (ops/op_schemas.py): their
arguments are the C launchers' (x padded, madd built, the weights
flattened, the activation's index, dropout's fields), CPU tensors run the
plain version and CUDA tensors the launch. The autograd Functions call them
in their forward, and a call that autograd does not record (evaluation,
torch.export) calls them directly, so an exported graph holds the kernels
as nodes that the C++ client (serving/cpp) implements too.

Parameters use the JAX package's tuple, with flax kernels in [in, out]:
((wq,bq),(wk,bk),(wv,bv),(wo,bo),(g1,c1),(w1,b1),(w2,b2),(g2,c2)). The
weights enter the Functions cast to the compute dtype, so, as in
layer.py:571-572, their gradients come back in that dtype and autograd
widens them to the f32 parameters.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from unirec_tpu_torch.ops import _build, op_schemas

MASK_VALUE = -1e4  # reference additive mask (sasrec.py:56)
PAD_MASK = -1e30   # hard ban on Lp-padding keys
SUPPORTED_ACTS = ("relu", "swish", "gelu", "tanh", "sigmoid")
_SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_U32 = 0xFFFFFFFF


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


def activation_grad(name: str, u: torch.Tensor) -> torch.Tensor:
    """act'(u) in f32, the closed forms of unirec_tpu/ops/layer.py::_act_pair."""
    if name == "relu":
        return (u > 0.0).to(u.dtype)
    if name in ("swish", "sigmoid"):
        s = torch.sigmoid(u)
        return s * (1.0 + u * (1.0 - s)) if name == "swish" else s * (1.0 - s)
    if name == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(u * (1.0 / math.sqrt(2.0))))
        return cdf + u * torch.exp(-0.5 * u * u) * (1.0 / math.sqrt(2.0 * math.pi))
    if name == "tanh":
        return 1.0 - torch.tanh(u) ** 2
    raise ValueError(f"unsupported activation for fused layer: {name}")


# ------------------------------------------------------------------- dropout
class Drop(NamedTuple):
    """Dropout of one kernel call: the seed, the keep thresholds
    round(p * 2^32) of the attention and hidden sites (0: no dropout) and
    their 1/(1-p)."""
    seed: int
    t_attn: int
    t_hidden: int
    inv_attn: float
    inv_hidden: float
    b0: int = 0      # the global index of the call's first example


NO_DROP = Drop(0, 0, 0, 1.0, 1.0)


def _thresh(p: float) -> int:
    return min(max(int(round(p * 2.0 ** 32)), 0), _U32)


def drop_params(p_attn: float, p_hidden: float, train: bool,
                seed: Optional[int], row_offset: int = 0) -> Drop:
    """As the JAX wrappers' ``drop_on`` (layer.py:883-894, :933-945):
    dropout only in train mode with a seed, else both rates are 0.
    ``row_offset``: the global index of the batch's first example (a
    data-parallel rank's first row), by which the masks are keyed."""
    if not (train and (p_attn > 0.0 or p_hidden > 0.0) and seed is not None):
        return NO_DROP
    inv = lambda p: 1.0 / (1.0 - p) if p > 0.0 else 1.0  # noqa: E731
    return Drop(int(seed) & _U32, _thresh(p_attn), _thresh(p_hidden),
                inv(p_attn), inv(p_hidden), int(row_offset))


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c for 32-bit m and c (int64 tensor),
    from 16-bit halves: the 64-bit product itself would overflow int64."""
    ml, mh = m & 0xFFFF, m >> 16
    cl, ch = c & 0xFFFF, c >> 16
    t1 = mh * cl + ml * ch
    low = ml * cl + ((t1 & 0xFFFF) << 16)
    return (mh * ch + (t1 >> 16) + (low >> 32)) & _U32, low & _U32


def philox_bits(seed: int, site: int, b: torch.Tensor,
                elem: torch.Tensor) -> torch.Tensor:
    """Word 0 of Philox4x32-10 for counter (elem, b, 0, 0) and key (seed,
    site), as csrc/common.cuh::philox_bits; b and elem broadcast (int64)."""
    c0, c1 = torch.broadcast_tensors(elem.to(torch.int64), b.to(torch.int64))
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = int(seed) & _U32, int(site) & _U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _U32, (k1 + 0xBB67AE85) & _U32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def keep_mask(seed: int, thresh: int, site: int, B: int, shape,
              device, b0: int = 0) -> Optional[torch.Tensor]:
    """[B, *shape] keep mask of one dropout site (element index = the
    row-major index within one example, example index b0 + b), or None
    when nothing is dropped."""
    if thresh == 0:
        return None
    n = math.prod(shape)
    elem = torch.arange(n, device=device).view(1, *shape)
    b = torch.arange(b0, b0 + B, device=device).view(B, *([1] * len(shape)))
    return philox_bits(seed, site, b, elem) >= thresh


def _drop_hidden(v: torch.Tensor, drop: Drop, site: int) -> torch.Tensor:
    keep = keep_mask(drop.seed, drop.t_hidden, site, v.shape[0], v.shape[1:], v.device,
                     drop.b0)
    if keep is None:
        return v
    return torch.where(keep, (v.float() * drop.inv_hidden).to(v.dtype),
                       torch.zeros_like(v))


def _drop_grad(g: torch.Tensor, drop: Drop, site: int) -> torch.Tensor:
    """The hidden-site mask applied to an f32 gradient (scaled by 1/(1-p))."""
    keep = keep_mask(drop.seed, drop.t_hidden, site, g.shape[0], g.shape[1:], g.device,
                     drop.b0)
    return g if keep is None else torch.where(keep, g * drop.inv_hidden, 0.0)


def _drop_probs(p: torch.Tensor, keep, drop: Drop) -> torch.Tensor:
    return p if keep is None else torch.where(keep, p * drop.inv_attn, 0.0)


# --------------------------------------------------------------- shared math
def _ln_stats(r: torch.Tensor, eps: float):
    """f32 LayerNorm statistics: (xhat, rs)."""
    mu = r.mean(-1, keepdim=True)
    rs = torch.rsqrt(((r - mu) ** 2).mean(-1, keepdim=True) + eps)
    return (r - mu) * rs, rs


def _ln_bwd(dy, xhat, rs, g):
    """dr of the f32 LayerNorm (unirec_tpu/ops/layer.py::_ln_bwd)."""
    dxh = dy * g
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    return rs * (dxh - m1 - xhat * m2)


def _dense(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32-accumulated a @ w cast to a's dtype, then + b in that dtype."""
    return (a.float() @ w.float()).to(a.dtype) + b


def _tmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over every leading axis of a^T b in f32: a weight gradient."""
    return a.reshape(-1, a.shape[-1]).float().T @ b.reshape(-1, b.shape[-1]).float()


def _rows_sum(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).float().sum(0)


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


def _layer_bwd_smem_bytes(Lp: int, D: int, F_: int, nh: int) -> int:
    """csrc/layer_bwd.cu::layer_bwd_smem_floats, in bytes."""
    return 4 * (7 * Lp * (D + 1) + Lp * (3 * D + 1) + (nh + 1) * Lp * (Lp + 1)
                + Lp * (F_ + 1) + 3 * Lp)


def _lastq_bwd_smem_bytes(Lp: int, D: int, F_: int, nh: int) -> int:
    """csrc/lastq_bwd.cu::lastq_bwd_smem_floats, in bytes."""
    return 4 * (Lp * (D + 1) + Lp * (2 * D + 1) + Lp + 2 * nh * Lp + 10 * D
                + 3 * F_ + 2)


_MMA_MAX_D = 64     # csrc/layer_bwd.cu::kMmaMaxD
_MMA_ROWS = 64      # ::kMmaRows, the most rows (Lp rounded up to 16) a block takes


def _layer_bwd_mma_smem_bytes(D: int, F_: int, nh: int) -> int:
    """csrc/layer_bwd.cu::mma_smem_bytes: the tensor-core backward's bf16
    weights, two stages of x, dy (and the f32 madd row), q|k|v, dctx and the
    per-example tiles (or z and ds of two heads, the larger), rows padded by
    8; then the f32 bias and LayerNorm sums of its four strips and the row
    statistics their warp pairs exchange."""
    ldd, ldq, ldf = D + 8, 3 * D + 8, F_ + 8
    tiles = max(2 * _MMA_ROWS * (4 * ldd + 2 * ldf), min(nh, 2) * 2 * 2 * _MMA_ROWS * 72)
    return (2 * (D * ldq + D * ldd + D * ldf + F_ * ldd)
            + 2 * (2 * 2 * _MMA_ROWS * ldd + 4 * _MMA_ROWS)
            + 2 * _MMA_ROWS * (ldq + ldd) + tiles + 4 * 4 * (9 * D + F_) + 4 * 4 * 32)


def _layer_fwd_mma_smem_bytes(D: int, F_: int) -> int:
    """csrc/layer_fwd.cu::fwd_mma_smem_bytes: the tensor-core forward's bf16
    weights once, then for each of its two 8-warp groups two stages of x
    (and the f32 madd row), q|k|v, ctx and x1 (rows padded by 8) and the row
    statistics its strip pairs exchange."""
    ldd, ldq, ldf = D + 8, 3 * D + 8, F_ + 8
    group = (2 * (2 * _MMA_ROWS * ldd + 4 * _MMA_ROWS) + 2 * _MMA_ROWS * ldq
             + 2 * 2 * _MMA_ROWS * ldd + 4 * 4 * 32)
    return 2 * (D * ldq + D * ldd + D * ldf + F_ * ldd) + 2 * group


def _lastq_bwd_mma_smem_bytes(D: int, F_: int, nh: int) -> int:
    """csrc/lastq_bwd.cu::mma_smem_bytes: the tensor-core last-query
    backward's bf16 weights (wq, wk|wv side by side, wo, w1, w2), two stages
    of x, madd and dy, k|v (then dk|dv), the bf16 row vectors of a group of
    16 examples, then f32: z and ds of every head, the row vectors of one
    example, the bias and LayerNorm sums and the dbk|dbv partial sums."""
    ldd, ldkv, ldf = D + 8, 2 * D + 8, F_ + 8
    weights = 2 * (D * ldd + D * ldkv + D * ldd + D * ldf + F_ * ldd)
    ring = 2 * (2 * _MMA_ROWS * ldd + 4 * _MMA_ROWS + 2 * D)
    gather = 2 * 16 * (6 * ldd + 2 * ldf)
    floats = 2 * nh * _MMA_ROWS + 13 * D + 3 * F_ + 2 + 7 * D + F_ + 256
    return weights + ring + 2 * _MMA_ROWS * ldkv + gather + 4 * floats


def _lastq_fwd_mma_smem_bytes(D: int, F_: int, nh: int) -> int:
    """csrc/lastq_fwd.cu::mma_smem_bytes: the tensor-core last-query
    forward's bf16 weights (wq, wk|wv side by side, wo, w1, w2) once, then
    for each of its two 8-warp groups two stages of x and the f32 madd row,
    the room k|v and the row phase share (k|v, or x1, hm and the f32
    pre-LayerNorm rows of 16 examples), the gathered x[qi] and ctx rows, f32
    q and z, and the 16 rows' example indices."""
    ldd, ldkv, ldf = D + 8, 2 * D + 8, F_ + 8
    room = max(2 * _MMA_ROWS * ldkv, 2 * 16 * (ldd + ldf) + 4 * 16 * D)
    group = (2 * (2 * _MMA_ROWS * ldd + 4 * _MMA_ROWS) + room + 2 * 2 * 16 * ldd
             + 4 * (D + nh * _MMA_ROWS) + 4 * 16)
    return 2 * (D * ldd + D * ldkv + D * ldd + D * ldf + F_ * ldd) + 2 * group


def _mma_widths_take(dtype: torch.dtype, Lp: int, D: int, F_: int, nh: int) -> bool:
    """The widths every bf16 tensor-core layer body takes (csrc/layer_*.cu's
    rules before their shared-memory test): Lp <= 64 and a multiple of 8, D
    and the head width multiples of 16 up to 64, F a multiple of 16."""
    return (dtype == torch.bfloat16 and 1 <= Lp <= _MMA_ROWS and Lp % 8 == 0
            and 16 <= D <= _MMA_MAX_D and D % 16 == 0 and nh >= 1 and D % nh == 0
            and (D // nh) % 16 == 0 and F_ >= 16 and F_ % 16 == 0)


def _layer_fwd_body(dtype: torch.dtype, Lp: int, D: int, F_: int, nh: int) -> str:
    """The body of csrc/layer_fwd.cu that runs the forward (its rule
    ``fwd_mma_takes``): "mma", the bf16 tensor-core body (the widths of
    ``_mma_widths_take``, its shared memory within a block's); else "cuda",
    the CUDA-core body."""
    return ("mma" if _mma_widths_take(dtype, Lp, D, F_, nh)
            and _layer_fwd_mma_smem_bytes(D, F_) <= _SMEM_LIMIT else "cuda")


def _layer_bwd_body(dtype: torch.dtype, Lp: int, D: int, F_: int, nh: int) -> str:
    """The body of csrc/layer_bwd.cu that runs the backward (its rule
    ``mma_takes``): "mma", the bf16 tensor-core body (the widths of
    ``_mma_widths_take``, its shared memory within a block's); else "cuda",
    the CUDA-core body."""
    return ("mma" if _mma_widths_take(dtype, Lp, D, F_, nh)
            and _layer_bwd_mma_smem_bytes(D, F_, nh) <= _SMEM_LIMIT else "cuda")


def _lastq_fwd_body(dtype: torch.dtype, Lp: int, D: int, F_: int, nh: int) -> str:
    """The body of csrc/lastq_fwd.cu that runs the last-query forward (its
    rule ``mma_takes``): "mma", the bf16 tensor-core body (the widths of
    ``_mma_widths_take``, its shared memory within a block's); else "cuda",
    the CUDA-core body."""
    return ("mma" if _mma_widths_take(dtype, Lp, D, F_, nh)
            and _lastq_fwd_mma_smem_bytes(D, F_, nh) <= _SMEM_LIMIT else "cuda")


def _lastq_bwd_body(dtype: torch.dtype, Lp: int, D: int, F_: int, nh: int) -> str:
    """The body of csrc/lastq_bwd.cu that runs the last-query backward (its
    rule ``mma_takes``): "mma", the bf16 tensor-core body (the widths of
    ``_mma_widths_take``, its shared memory within a block's); else "cuda",
    the CUDA-core body."""
    return ("mma" if _mma_widths_take(dtype, Lp, D, F_, nh)
            and _lastq_bwd_mma_smem_bytes(D, F_, nh) <= _SMEM_LIMIT else "cuda")


def fused_layer_supported(x: torch.Tensor, hidden_act: str, n_heads: int,
                          inner_size: int | None = None) -> bool:
    """Shape gate of the four kernels, in the role of the JAX package's
    fused_layer_supported: a supported activation, heads of a width that
    is a multiple of 8, L <= 512, and one example's working set, forward
    and backward, within a block's shared memory (the JAX gate likewise
    requires both directions to fit, layer.py:915-917). Independent of the
    device: on the CPU the wrappers run their plain versions for the same
    shapes."""
    B, L, D = x.shape
    if hidden_act not in SUPPORTED_ACTS:
        return False
    if D % n_heads or (D // n_heads) % 8 or L > 512:
        return False
    F_ = int(inner_size) if inner_size else 4 * D
    Lp = -(-L // 8) * 8
    return max(_layer_smem_bytes(Lp, D, F_),
               _lastq_smem_bytes(Lp, D, F_, n_heads),
               _layer_bwd_smem_bytes(Lp, D, F_, n_heads),
               _lastq_bwd_smem_bytes(Lp, D, F_, n_heads)) <= _SMEM_LIMIT


def _check_cuda_inputs(x, madd, flat):
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer kernels take float32 or bfloat16, got {x.dtype}")
    for t in (madd, *flat):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {t.device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _opt_ptr(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    return None if t is None else _ptr(t)


def _drop_args(drop: Drop):
    return (drop.seed, drop.t_attn, drop.t_hidden, float(drop.inv_attn),
            float(drop.inv_hidden), drop.b0)


_DROP_ARGTYPES = [ctypes.c_uint32] * 3 + [ctypes.c_float] * 2 + [ctypes.c_uint32]


@functools.cache
def _entry(name: str, n_ptr: int, n_int: int):
    """The C entry point unirec_<name> of csrc/<name>.cu: (dtype, n_ptr
    pointers, n_int ints, eps, the dropout arguments with the first
    example's global index, stream)."""
    fn = getattr(_build.library(name), f"unirec_{name}")
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] + _DROP_ARGTYPES + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_blocks(lib: str, dtype: int, B: int, Lp: int, D: int, F_: int,
                nh: int, device_index: int, *body: int) -> int:
    """Blocks of a backward kernel's persistent grid on this card (``body``:
    layer_bwd's 1 for its tensor-core body, 0 for its CUDA-core one)."""
    fn = getattr(_build.library(lib), f"unirec_{lib}_blocks")
    fn.argtypes = [ctypes.c_int] * (6 + len(body))
    fn.restype = ctypes.c_int
    n = fn(dtype, B, Lp, D, F_, nh, *body)
    if n <= 0:
        _build.check(-n if n < 0 else 1, f"{lib} occupancy query")
    return n


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t (contiguous) on a 16-byte boundary, copied if it is not: the
    tensor-core bodies move 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bwd_operands(body: str, x, dy, madd, flat, mats, nblk: int):
    """(x, dy, madd, flat, slabs, transposes) for a backward kernel's body;
    ``mats`` index the matmul weights in ``flat``. The tensor-core body moves
    16 bytes at a time, adds into zeroed per-block slabs and reads the
    weights untransposed through ldmatrix (no transposes: None each); the
    CUDA-core body writes its slabs whole and reads contiguous transposes of
    the weights, so its products with W^T read them coalesced."""
    shape = (nblk, sum(t.numel() for t in flat))
    if body == "mma":
        x, dy, madd = (_aligned16(t) for t in (x, dy, madd))
        flat = tuple(_aligned16(t) if i in mats else t for i, t in enumerate(flat))
        return (x, dy, madd, flat, torch.zeros(shape, dtype=torch.float32, device=x.device),
                [None] * len(mats))
    return (x, dy, madd, flat, torch.empty(shape, dtype=torch.float32, device=x.device),
            [flat[i].t().contiguous() for i in mats])


def _unflatten(total: torch.Tensor, flat):
    """The summed slab [sum of numels] as gradients shaped and typed like
    ``flat`` (cast to each leaf's dtype, as layer.py:571-572)."""
    out, o = [], 0
    for w in flat:
        out.append(total[o:o + w.numel()].view(w.shape).to(w.dtype))
        o += w.numel()
    return tuple(out)


def _dispatch(x: torch.Tensor, cuda_fn, plain_fn, what: str):
    if x.is_cuda:
        return cuda_fn
    if x.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no {what} kernel for device {x.device}")


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


def _attn_mask(madd: torch.Tensor, Lp: int, causal: bool) -> torch.Tensor:
    """[B, Lp, Lp] f32 additive mask: the key-pad row, elementwise min with
    the causal -1e4 triangle (layer.py:204-216)."""
    mfull = madd.float()[:, None, :]
    if causal:
        idx = torch.arange(Lp, device=madd.device)
        tri = torch.where(idx[None, :] > idx[:, None], MASK_VALUE, 0.0)
        mfull = torch.minimum(mfull, tri[None])
    return mfull.expand(-1, Lp, -1)


def _layer_forward_parts(x, madd, flat, nh: int, act: str, eps: float,
                         causal: bool, drop: Drop):
    """The plain forward with every intermediate the backward reads."""
    wqkv, bqkv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2 = flat
    dt = x.dtype
    B, Lp, D = x.shape
    hd = D // nh
    qkv = _dense(x, wqkv, bqkv)
    mfull = _attn_mask(madd, Lp, causal)
    scale = 1.0 / math.sqrt(hd)
    heads, probs, keeps = [], [], []
    for h in range(nh):
        q = qkv[..., h * hd:(h + 1) * hd].float()
        k = qkv[..., D + h * hd:D + (h + 1) * hd].float()
        v = qkv[..., 2 * D + h * hd:2 * D + (h + 1) * hd].float()
        p = torch.softmax(q @ k.transpose(1, 2) * scale + mfull, dim=-1)
        keep = keep_mask(drop.seed, drop.t_attn, h, B, (Lp, Lp), x.device, drop.b0)
        heads.append((_drop_probs(p, keep, drop).to(dt).float() @ v).to(dt))
        probs.append(p)
        keeps.append(keep)
    ctx = torch.cat(heads, dim=-1)
    o = _dense(ctx, wo, bo)
    xhat1, rs1 = _ln_stats((_drop_hidden(o, drop, nh) + x).float(), eps)
    x1 = (xhat1 * g1 + c1).to(dt)
    u = _dense(x1, w1, b1)
    hm = activation(act, u.float()).to(dt)
    h2 = _dense(hm, w2, b2)
    xhat2, rs2 = _ln_stats((_drop_hidden(h2, drop, nh + 1) + x1).float(), eps)
    y = (xhat2 * g2 + c2).to(dt)
    return dict(qkv=qkv, probs=probs, keeps=keeps, ctx=ctx, xhat1=xhat1,
                rs1=rs1, x1=x1, u=u, hm=hm, xhat2=xhat2, rs2=rs2, y=y)


def _layer_fwd_plain(x, madd, flat, nh: int, act: str, eps: float,
                     causal: bool, drop: Drop = NO_DROP) -> torch.Tensor:
    """Plain PyTorch version of csrc/layer_fwd.cu (x pre-padded to Lp)."""
    return _layer_forward_parts(x, madd, flat, nh, act, eps, causal, drop)["y"]


def _layer_bwd_plain(x, madd, flat, dy, nh: int, act: str, eps: float,
                     causal: bool, drop: Drop = NO_DROP):
    """Plain PyTorch version of csrc/layer_bwd.cu: (dx, weight grads)."""
    wqkv, bqkv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2 = flat
    f = _layer_forward_parts(x, madd, flat, nh, act, eps, causal, drop)
    dt = x.dtype
    B, Lp, D = x.shape
    hd = D // nh
    scale = 1.0 / math.sqrt(hd)
    dyf = dy.float()
    dg2, dc2 = _rows_sum(dyf * f["xhat2"]), _rows_sum(dyf)
    dr2 = _ln_bwd(dyf, f["xhat2"], f["rs2"], g2)
    dh2 = _drop_grad(dr2, drop, nh + 1).to(dt)
    dw2, db2 = _tmm(f["hm"], dh2), _rows_sum(dh2)
    du = ((dh2.float() @ w2.float().T) * activation_grad(act, f["u"].float())).to(dt)
    dw1, db1 = _tmm(f["x1"], du), _rows_sum(du)
    dx1 = dr2 + du.float() @ w1.float().T
    dg1, dc1 = _rows_sum(dx1 * f["xhat1"]), _rows_sum(dx1)
    dr1 = _ln_bwd(dx1, f["xhat1"], f["rs1"], g1)
    do = _drop_grad(dr1, drop, nh).to(dt)
    dwo, dbo = _tmm(f["ctx"], do), _rows_sum(do)
    dctx = (do.float() @ wo.float().T).to(dt)
    qkv = f["qkv"]
    dq, dk, dv = [], [], []
    for h in range(nh):
        q = qkv[..., h * hd:(h + 1) * hd].float()
        k = qkv[..., D + h * hd:D + (h + 1) * hd].float()
        v = qkv[..., 2 * D + h * hd:2 * D + (h + 1) * hd].float()
        p, keep = f["probs"][h], f["keeps"][h]
        dch = dctx[..., h * hd:(h + 1) * hd].float()
        dv.append((_drop_probs(p, keep, drop).to(dt).float().transpose(1, 2) @ dch).to(dt))
        dp = _drop_probs(dch @ v.transpose(1, 2), keep, drop)
        t = (dp * p).sum(-1, keepdim=True)
        ds = (p * (dp - t) * scale).to(dt).float()
        dq.append((ds @ k).to(dt))
        dk.append((ds.transpose(1, 2) @ q).to(dt))
    dqkv = torch.cat(dq + dk + dv, dim=-1)
    dwqkv, dbqkv = _tmm(x, dqkv), _rows_sum(dqkv)
    dx = (dr1 + dqkv.float() @ wqkv.float().T).to(dt)
    grads = (dwqkv, dbqkv, dwo, dbo, dg1, dc1, dw1, db1, dw2, db2, dg2, dc2)
    return dx, tuple(g.to(w.dtype) for g, w in zip(grads, flat))


def _layer_shape_check(x, madd, flat, nh: int, backward: bool):
    _check_cuda_inputs(x, madd, flat)
    B, Lp, D = x.shape
    F_ = flat[6].shape[1]
    smem = (_layer_bwd_smem_bytes(Lp, D, F_, nh) if backward
            else _layer_smem_bytes(Lp, D, F_))
    if smem > _SMEM_LIMIT or D % nh or Lp % 8:
        raise ValueError(f"layer kernels do not take Lp={Lp}, D={D}, F={F_}, nh={nh}")
    return B, Lp, D, F_


def _layer_fwd_cuda(x, madd, flat, nh: int, act: str, eps: float,
                    causal: bool, drop: Drop = NO_DROP) -> torch.Tensor:
    """Launch csrc/layer_fwd.cu, the body ``_layer_fwd_body`` names, on x
    [B, Lp, D] (Lp a multiple of 8)."""
    B, Lp, D, F_ = _layer_shape_check(x, madd, flat, nh, backward=False)
    body = _layer_fwd_body(x.dtype, Lp, D, F_, nh)
    x = x.contiguous()
    madd = madd.to(torch.float32).contiguous()
    if body == "mma":   # 16-byte copies of x, madd and the four matmul weights
        x, madd = _aligned16(x), _aligned16(madd)
        flat = tuple(_aligned16(t) if i in (0, 2, 6, 8) else t for i, t in enumerate(flat))
    y = torch.empty_like(x)
    err = _entry("layer_fwd", 15, 8)(_DTYPES[x.dtype], _ptr(x), _ptr(madd),
                           *[_ptr(t) for t in flat], _ptr(y), B, Lp, D, F_, nh,
                           SUPPORTED_ACTS.index(act), int(bool(causal)),
                           int(body == "mma"), float(eps), *_drop_args(drop),
                           _build.stream_handle(x.device))
    _build.check(err, "layer_fwd launch")
    fused_transformer_layer.launches += 1
    fused_transformer_layer.launches_mma += body == "mma"
    return y


def _layer_bwd_cuda(x, madd, flat, dy, nh: int, act: str, eps: float,
                    causal: bool, drop: Drop = NO_DROP):
    """Launch csrc/layer_bwd.cu, the body ``_layer_bwd_body`` names: (dx
    [B, Lp, D], weight grads)."""
    B, Lp, D, F_ = _layer_shape_check(x, madd, flat, nh, backward=True)
    body = _layer_bwd_body(x.dtype, Lp, D, F_, nh)
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    madd = madd.to(torch.float32).contiguous()
    nblk = _bwd_blocks("layer_bwd", _DTYPES[x.dtype], B, Lp, D, F_, nh,
                       x.device.index or 0, int(body == "mma"))
    x, dy, madd, flat, slabs, wt = _bwd_operands(body, x, dy, madd, flat, (0, 2, 6, 8), nblk)
    dx = torch.empty_like(x)
    err = _entry("layer_bwd", 21, 9)(_DTYPES[x.dtype], _ptr(x), _ptr(madd),
                           *[_ptr(t) for t in flat], *[_opt_ptr(t) for t in wt],
                           _ptr(dy), _ptr(dx),
                           _ptr(slabs), nblk, B, Lp, D, F_, nh,
                           SUPPORTED_ACTS.index(act), int(bool(causal)),
                           int(body == "mma"), float(eps), *_drop_args(drop),
                           _build.stream_handle(x.device))
    _build.check(err, "layer_bwd launch")
    layer_bwd.launches += 1
    layer_bwd.launches_mma += body == "mma"
    return dx, _unflatten(slabs.sum(0), flat)


def layer_bwd(x, madd, flat, dy, nh: int, act: str, eps: float, causal: bool,
              drop: Drop = NO_DROP):
    """Backward of the whole layer on pre-padded x: csrc/layer_bwd.cu on
    CUDA tensors, its plain version on CPU tensors."""
    fn = _dispatch(x, _layer_bwd_cuda, _layer_bwd_plain, "layer_bwd")
    return fn(x, madd, flat, dy, nh, act, eps, causal, drop)


layer_bwd.launches = 0
layer_bwd.launches_mma = 0   # of those, the bf16 tensor-core body's


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records a call on ``ts``: the training paths go
    through the autograd.Functions, every other call straight to the
    operator, which is what torch.export records."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def define_op(name: str, cpu, cuda, fake):
    """Define ``unirec::<name>`` from ops/op_schemas.py's table, with the
    plain version for CPU tensors, the kernel launch for CUDA tensors (no
    fallback: the launch raises on what it does not take) and the fake
    implementation torch.export traces with. Returns the operator."""
    q = op_schemas.qualname(name)
    torch.library.define(q, op_schemas.SCHEMAS[name])
    torch.library.impl(q, "cpu")(cpu)
    torch.library.impl(q, "cuda")(cuda)
    torch.library.register_fake(q)(fake)
    return getattr(getattr(torch.ops, op_schemas.NAMESPACE), name).default


class _Fused(torch.autograd.Function):
    """A fused layer on pre-padded x: ``fwd`` (its operator) forward, ``bwd`` (layer_bwd or lastq_bwd) backward; only x,
    madd, the weights and the dropout seed are saved."""

    @staticmethod
    def forward(ctx, fwd, bwd, x, madd, static, drop, *flat):
        ctx.save_for_backward(x, madd, *flat)
        ctx.bwd, ctx.static, ctx.drop = bwd, static, drop
        return fwd(x, madd, flat, *static, drop)

    @staticmethod
    def backward(ctx, dy):
        x, madd, *flat = ctx.saved_tensors
        dx, grads = ctx.bwd(x, madd, flat, dy, *ctx.static, ctx.drop)
        return (None, None, dx, None, None, None, *grads)


def fused_transformer_layer(x, madd, params, *, n_heads: int, inner_size: int,
                            hidden_act: str, layer_norm_eps: float,
                            causal: bool, p_attn: float = 0.0,
                            p_hidden: float = 0.0, train: bool = False,
                            seed: Optional[int] = None,
                            row_offset: int = 0) -> torch.Tensor:
    """One whole post-LN transformer layer, differentiable.

    x: [B, L, D] (compute dtype); madd: [B, L] additive key-pad row
    (0 / -10000, or -1e30 on padding); params: the flax parameter tuple
    (module docstring). Dropout runs when ``train`` and a host-int ``seed``
    is given (the JAX wrapper's ``dropout_rng``), its masks keyed by the
    global example index ``row_offset`` + b. Returns [B, L, D] in x's
    dtype."""
    del inner_size  # read from the weights
    B, L, D = x.shape
    xp, mp, _ = _pad_L(x, madd, L)
    flat = _layer_weights(params, x.dtype)
    static = (n_heads, hidden_act, float(layer_norm_eps), bool(causal))
    drop = drop_params(p_attn, p_hidden, train, seed, row_offset)
    if needs_grad(xp, *flat):
        y = _Fused.apply(_layer_fwd_op, layer_bwd, xp, mp, static, drop, *flat)
    else:
        y = _layer_fwd_op(xp, mp, flat, *static, drop)
    return y[:, :L]


fused_transformer_layer.launches = 0
fused_transformer_layer.launches_mma = 0   # of those, the bf16 tensor-core body's


# --------------------------------------------------------- last-query kernel
def _lastq_weights(params, dt):
    (wq, bq), (wk, bk), (wv, bv), (wo, bo), (g1, c1), \
        (w1, b1), (w2, b2), (g2, c2) = params
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    c = lambda t: t.to(dt).contiguous()  # noqa: E731
    return (c(wq), c(bq), c(wk), c(bk), c(wv), c(bv), c(wo), c(bo),
            f32(g1), f32(c1), c(w1), c(b1), c(w2), c(b2), f32(g2), f32(c2))


def _lastq_forward_parts(x, madd, flat, qi: int, nh: int, act: str,
                         eps: float, drop: Drop):
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
    heads, probs, keeps = [], [], []
    for h in range(nh):
        sl = slice(h * hd, (h + 1) * hd)
        s = torch.einsum("bd,bld->bl", q[:, sl].float(), k[..., sl].float())
        p = torch.softmax(s * scale + mrow, dim=-1)
        keep = keep_mask(drop.seed, drop.t_attn, h, B, (Lp,), x.device, drop.b0)
        heads.append(torch.einsum("bl,bld->bd", _drop_probs(p, keep, drop).to(dt).float(),
                                  v[..., sl].float()).to(dt))
        probs.append(p)
        keeps.append(keep)
    ctx = torch.cat(heads, dim=-1)
    o = _dense(ctx, wo, bo)
    xhat1, rs1 = _ln_stats((_drop_hidden(o, drop, nh) + xq).float(), eps)
    x1 = (xhat1 * g1 + c1).to(dt)
    u = _dense(x1, w1, b1)
    hm = activation(act, u.float()).to(dt)
    h2 = _dense(hm, w2, b2)
    xhat2, rs2 = _ln_stats((_drop_hidden(h2, drop, nh + 1) + x1).float(), eps)
    y = (xhat2 * g2 + c2).to(dt)
    return dict(xq=xq, q=q, k=k, v=v, probs=probs, keeps=keeps, ctx=ctx,
                xhat1=xhat1, rs1=rs1, x1=x1, u=u, hm=hm, xhat2=xhat2,
                rs2=rs2, y=y)


def _lastq_fwd_plain(x, madd, flat, qi: int, nh: int, act: str,
                     eps: float, drop: Drop = NO_DROP) -> torch.Tensor:
    """Plain PyTorch version of csrc/lastq_fwd.cu (x pre-padded to Lp)."""
    return _lastq_forward_parts(x, madd, flat, qi, nh, act, eps, drop)["y"]


def _lastq_bwd_plain(x, madd, flat, dy, qi: int, nh: int, act: str,
                     eps: float, drop: Drop = NO_DROP):
    """Plain PyTorch version of csrc/lastq_bwd.cu: (dx, weight grads)."""
    wq, bq, wk, bk, wv, bv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2 = flat
    f = _lastq_forward_parts(x, madd, flat, qi, nh, act, eps, drop)
    dt = x.dtype
    B, Lp, D = x.shape
    hd = D // nh
    scale = 1.0 / math.sqrt(hd)
    dyf = dy.float()
    dg2, dc2 = _rows_sum(dyf * f["xhat2"]), _rows_sum(dyf)
    dr2 = _ln_bwd(dyf, f["xhat2"], f["rs2"], g2)
    dh2 = _drop_grad(dr2, drop, nh + 1).to(dt)
    dw2, db2 = _tmm(f["hm"], dh2), _rows_sum(dh2)
    du = ((dh2.float() @ w2.float().T) * activation_grad(act, f["u"].float())).to(dt)
    dw1, db1 = _tmm(f["x1"], du), _rows_sum(du)
    dx1 = dr2 + du.float() @ w1.float().T
    dg1, dc1 = _rows_sum(dx1 * f["xhat1"]), _rows_sum(dx1)
    dr1 = _ln_bwd(dx1, f["xhat1"], f["rs1"], g1)
    do = _drop_grad(dr1, drop, nh).to(dt)
    dwo, dbo = _tmm(f["ctx"], do), _rows_sum(do)
    dctx = (do.float() @ wo.float().T).to(dt)
    dq, dk, dv = [], [], []
    for h in range(nh):
        sl = slice(h * hd, (h + 1) * hd)
        p, keep = f["probs"][h], f["keeps"][h]
        dch = dctx[:, sl].float()
        pz = _drop_probs(p, keep, drop).to(dt).float()
        dv.append((pz[:, :, None] * dch[:, None, :]).to(dt))
        dp = _drop_probs(torch.einsum("bd,bld->bl", dch, f["v"][..., sl].float()), keep, drop)
        t = (dp * p).sum(-1, keepdim=True)
        ds = (p * (dp - t) * scale).to(dt).float()
        dq.append(torch.einsum("bl,bld->bd", ds, f["k"][..., sl].float()).to(dt))
        dk.append((ds[:, :, None] * f["q"][:, None, sl].float()).to(dt))
    dq, dk, dv = torch.cat(dq, -1), torch.cat(dk, -1), torch.cat(dv, -1)
    dx = dk.float() @ wk.float().T + dv.float() @ wv.float().T
    dxq = dq.float() @ wq.float().T + dr1
    dx = torch.cat([dx[:, :qi], (dx[:, qi] + dxq)[:, None], dx[:, qi + 1:]], 1).to(dt)
    grads = (_tmm(f["xq"], dq), _rows_sum(dq), _tmm(x, dk), _rows_sum(dk),
             _tmm(x, dv), _rows_sum(dv), dwo, dbo, dg1, dc1, dw1, db1, dw2,
             db2, dg2, dc2)
    return dx, tuple(g.to(w.dtype) for g, w in zip(grads, flat))


def _lastq_shape_check(x, madd, flat, qi: int, nh: int, backward: bool):
    _check_cuda_inputs(x, madd, flat)
    B, Lp, D = x.shape
    F_ = flat[10].shape[1]
    smem = (_lastq_bwd_smem_bytes if backward else _lastq_smem_bytes)(Lp, D, F_, nh)
    if smem > _SMEM_LIMIT or D % nh or Lp % 8 or not 0 <= qi < Lp:
        raise ValueError(f"last-query kernels do not take Lp={Lp}, D={D}, "
                         f"F={F_}, nh={nh}, qi={qi}")
    return B, Lp, D, F_


def _lastq_fwd_cuda(x, madd, flat, qi: int, nh: int, act: str,
                    eps: float, drop: Drop = NO_DROP) -> torch.Tensor:
    """Launch csrc/lastq_fwd.cu, the body ``_lastq_fwd_body`` names, on x
    [B, Lp, D]; returns [B, D]."""
    B, Lp, D, F_ = _lastq_shape_check(x, madd, flat, qi, nh, backward=False)
    body = _lastq_fwd_body(x.dtype, Lp, D, F_, nh)
    x = x.contiguous()
    madd = madd.to(torch.float32).contiguous()
    if body == "mma":   # 16-byte copies of x, madd and the six matmul weights
        x, madd = _aligned16(x), _aligned16(madd)
        flat = tuple(_aligned16(t) if i in (0, 2, 4, 6, 10, 12) else t
                     for i, t in enumerate(flat))
    y = torch.empty((B, D), dtype=x.dtype, device=x.device)
    err = _entry("lastq_fwd", 19, 8)(_DTYPES[x.dtype], _ptr(x), _ptr(madd),
                           *[_ptr(t) for t in flat], _ptr(y), B, Lp, D, F_, nh,
                           int(qi), SUPPORTED_ACTS.index(act), int(body == "mma"),
                           float(eps), *_drop_args(drop), _build.stream_handle(x.device))
    _build.check(err, "lastq_fwd launch")
    fused_last_query_layer.launches += 1
    fused_last_query_layer.launches_mma += body == "mma"
    return y


def _lastq_bwd_cuda(x, madd, flat, dy, qi: int, nh: int, act: str,
                    eps: float, drop: Drop = NO_DROP):
    """Launch csrc/lastq_bwd.cu, the body ``_lastq_bwd_body`` names: (dx
    [B, Lp, D], weight grads)."""
    B, Lp, D, F_ = _lastq_shape_check(x, madd, flat, qi, nh, backward=True)
    body = _lastq_bwd_body(x.dtype, Lp, D, F_, nh)
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    madd = madd.to(torch.float32).contiguous()
    nblk = _bwd_blocks("lastq_bwd", _DTYPES[x.dtype], B, Lp, D, F_, nh,
                       x.device.index or 0, int(body == "mma"))
    x, dy, madd, flat, slabs, wt = _bwd_operands(body, x, dy, madd, flat,
                                                 (0, 2, 4, 6, 10, 12), nblk)
    dx = torch.empty_like(x)
    err = _entry("lastq_bwd", 27, 9)(_DTYPES[x.dtype], _ptr(x), _ptr(madd),
                           *[_ptr(t) for t in flat], *[_opt_ptr(t) for t in wt],
                           _ptr(dy), _ptr(dx),
                           _ptr(slabs), nblk, B, Lp, D, F_, nh, int(qi),
                           SUPPORTED_ACTS.index(act), int(body == "mma"),
                           float(eps), *_drop_args(drop),
                           _build.stream_handle(x.device))
    _build.check(err, "lastq_bwd launch")
    lastq_bwd.launches += 1
    lastq_bwd.launches_mma += body == "mma"
    return dx, _unflatten(slabs.sum(0), flat)


def lastq_bwd(x, madd, flat, dy, qi: int, nh: int, act: str, eps: float,
              drop: Drop = NO_DROP):
    """Backward of the last-query layer on pre-padded x: csrc/lastq_bwd.cu
    on CUDA tensors, its plain version on CPU tensors."""
    fn = _dispatch(x, _lastq_bwd_cuda, _lastq_bwd_plain, "lastq_bwd")
    return fn(x, madd, flat, dy, qi, nh, act, eps, drop)


lastq_bwd.launches = 0
lastq_bwd.launches_mma = 0   # of those, the bf16 tensor-core body's


def fused_last_query_layer(x, madd, params, *, n_heads: int, inner_size: int,
                           hidden_act: str, layer_norm_eps: float,
                           q_index: int | None = None, p_attn: float = 0.0,
                           p_hidden: float = 0.0, train: bool = False,
                           seed: Optional[int] = None,
                           row_offset: int = 0) -> torch.Tensor:
    """The layer for query row ``q_index`` only (default L-1; callers on
    pre-padded inputs pass the last REAL row), differentiable. Same
    parameter tuple and dropout arguments as fused_transformer_layer.
    Returns [B, D]."""
    del inner_size
    B, L, D = x.shape
    qi = int(L - 1 if q_index is None else q_index)
    xp, mp, _ = _pad_L(x, madd, L)
    flat = _lastq_weights(params, x.dtype)
    static = (qi, n_heads, hidden_act, float(layer_norm_eps))
    drop = drop_params(p_attn, p_hidden, train, seed, row_offset)
    if needs_grad(xp, *flat):
        return _Fused.apply(_lastq_fwd_op, lastq_bwd, xp, mp, static, drop, *flat)
    return _lastq_fwd_op(xp, mp, flat, *static, drop)


fused_last_query_layer.launches = 0
fused_last_query_layer.launches_mma = 0   # of those, the bf16 tensor-core body's


# -------------------------------------------------------- custom operators
# unirec::layer_fwd and unirec::lastq_fwd (ops/op_schemas.py): the launcher's
# contract, x padded to Lp, madd the f32 key-pad row, the weights flattened as
# _layer_weights / _lastq_weights give them, the activation's index in
# SUPPORTED_ACTS, dropout as Drop's fields. Each implementation looks its
# function up by name at the call, so a test that patches the module's
# launcher with the plain version (chip_smoke.py's plain_versions) reroutes
# the operator too.
def _layer_op(fn: str):
    def impl(x, madd, flat, nh, act, causal, eps, *drop):
        return globals()[fn](x, madd, tuple(flat), nh, SUPPORTED_ACTS[act], eps, causal,
                             Drop(*drop))
    return impl


def _lastq_op(fn: str):
    def impl(x, madd, flat, qi, nh, act, eps, *drop):
        return globals()[fn](x, madd, tuple(flat), qi, nh, SUPPORTED_ACTS[act], eps,
                             Drop(*drop))
    return impl


LAYER_FWD_OP = define_op("layer_fwd", _layer_op("_layer_fwd_plain"),
                         _layer_op("_layer_fwd_cuda"),
                         lambda x, madd, flat, *a: x.new_empty(x.shape))
LASTQ_FWD_OP = define_op("lastq_fwd", _lastq_op("_lastq_fwd_plain"),
                         _lastq_op("_lastq_fwd_cuda"),
                         lambda x, madd, flat, *a: x.new_empty((x.shape[0], x.shape[2])))


def _layer_fwd_op(x, madd, flat, nh: int, act: str, eps: float, causal: bool,
                  drop: Drop = NO_DROP) -> torch.Tensor:
    return LAYER_FWD_OP(x, madd, list(flat), nh, SUPPORTED_ACTS.index(act), bool(causal),
                        float(eps), *drop)


def _lastq_fwd_op(x, madd, flat, qi: int, nh: int, act: str, eps: float,
                  drop: Drop = NO_DROP) -> torch.Tensor:
    return LASTQ_FWD_OP(x, madd, list(flat), int(qi), nh, SUPPORTED_ACTS.index(act),
                        float(eps), *drop)
