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

The forward kernel is the ``torch.library`` operator ``unirec::ffn_fwd``
(ops/op_schemas.py), as ops/layer.py's kernels are.

Bodies. Both directions in f32 or at widths the tensor cores do not take
run on the CUDA cores; they hold at most 128 columns of F at once and a row
tile that shrinks as D grows (``_rows``), so every D <= 2048 launches at any
F. In bf16 with D a multiple of 16 up to 64 and F a multiple of 16 both
directions run on the tensor cores (``_fwd_body``, ``_bwd_body``; counted by
``fused_ffn.launches_mma`` and ``fused_ffn_bwd.launches_mma``), held to the
plain versions within their tolerances.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from unirec_tpu_torch.ops import _build
from unirec_tpu_torch.ops.layer import (_DTYPES, _SMEM_LIMIT, _aligned16, _dispatch, _ptr,
                                        define_op, needs_grad)

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
_FWD_ROWS, _BWD_ROWS, _FC = 64, 32, 128   # csrc/ffn.cu::kFwdRows, kBwdRows, kFc
MMA_MAX_D, _MMA_FC = 64, 128              # ::kMmaMaxD, kMmaFc


def _smem_bytes(bwd: bool, rows: int, D: int, Fi: int) -> int:
    """csrc/ffn.cu::fwd_smem_floats / bwd_smem_floats, in bytes: the CUDA-core
    bodies' tile of ``rows`` tokens (f32 x and, in the backward, dy; at most
    128 columns of F; the f32 y or dx sums when F has more than one chunk)."""
    fc = min(Fi, _FC)
    extra = rows * (D + 1) if Fi > _FC else 0
    if bwd:
        return 4 * (2 * rows * (D + 1) + 2 * rows * (fc + 1) + extra)
    return 4 * (rows * (D + 1) + rows * (fc + 1) + extra)


def _rows(bwd: bool, D: int, Fi: int) -> int:
    """Tokens per tile of the CUDA-core forward or backward (csrc/ffn.cu::
    ffn_rows): the most, halving from 64 (forward) or 32 (backward), whose
    shared memory fits a block; 0 if none does."""
    r = _BWD_ROWS if bwd else _FWD_ROWS
    while r >= 1:
        if _smem_bytes(bwd, r, D, Fi) <= _SMEM_LIMIT:
            return r
        r //= 2
    return 0


def _bwd_body(dtype: torch.dtype, D: int, Fi: int) -> str:
    """The body of csrc/ffn.cu that runs the backward (its rule
    ``mma_takes``): "mma", the bf16 tensor-core body (D a multiple of 16 up
    to 64, F a multiple of 16); else "cuda", the CUDA-core body."""
    if (dtype == torch.bfloat16 and 16 <= D <= MMA_MAX_D and D % 16 == 0
            and Fi >= 16 and Fi % 16 == 0):
        return "mma"
    return "cuda"


def _fwd_body(dtype: torch.dtype, D: int, Fi: int) -> str:
    """The body of csrc/ffn.cu that runs the forward: the backward's rule
    (``mma_takes``), "mma" for the bf16 tensor-core body, else "cuda"."""
    return _bwd_body(dtype, D, Fi)


def _fwd_mma_smem_bytes(D: int, Fi: int) -> int:
    """csrc/ffn.cu::fwd_mma_smem_bytes: W1 and W2 of one chunk of at most
    128 columns of F and two 128-token stages of x in bf16 (rows padded by
    8), and the chunk's b1 in f32."""
    fc = min(Fi, _MMA_FC)
    return 2 * (D * (fc + 8) + fc * (D + 8) + 2 * 128 * (D + 8)) + 4 * _MMA_FC


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
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
    elif name == "bwd":
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
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


def _refuse_width(D: int, Fi: int, bwd: bool):
    if _rows(bwd, D, Fi) == 0:
        raise ValueError(f"fused ffn kernels do not take D={D}: one token's f32 row "
                         "exceeds a block's shared memory")


def _fwd_cuda(x, w1, b1, w2, b2, act: str) -> torch.Tensor:
    """Launch the forward kernel of csrc/ffn.cu."""
    T, D, Fi = _check(x, w1, b1, w2, b2, act)
    body = _fwd_body(x.dtype, D, Fi)
    if body == "cuda":
        _refuse_width(D, Fi, bwd=False)
    x, w1, b1, w2, b2 = (t.contiguous() for t in (x, w1, b1, w2, b2))
    if body == "mma":
        x, w1, w2 = (_aligned16(t) for t in (x, w1, w2))
    y = torch.empty_like(x)
    err = _entry("fwd")(_DTYPES[x.dtype], _ptr(x), _ptr(w1), _ptr(b1), _ptr(w2),
                        _ptr(b2), _ptr(y), T, D, Fi, ACTS.index(act), int(body == "mma"),
                        _build.stream_handle(x.device))
    _build.check(err, "ffn forward launch")
    fused_ffn.launches += 1
    fused_ffn.launches_mma += body == "mma"
    return y


def _bwd_cuda(x, w1, b1, w2, b2, dy, act: str):
    """Launch the backward kernel of csrc/ffn.cu: (dx, dw1, db1, dw2, db2)."""
    T, D, Fi = _check(x, w1, b1, w2, b2, act)
    body = _bwd_body(x.dtype, D, Fi)
    if body == "cuda":
        _refuse_width(D, Fi, bwd=True)
    x, w1, b1, w2 = x.contiguous(), w1.contiguous(), b1.contiguous(), w2.contiguous()
    dy = dy.to(x.dtype).contiguous()
    nblk = _bwd_blocks(_DTYPES[x.dtype], T, D, Fi, x.device.index or 0)
    dx = torch.empty_like(x)
    dxp = None
    if body == "mma":
        x, dy, w1, w2 = (_aligned16(t) for t in (x, dy, w1, w2))
        w1t = w2t = None
        # each block fills only its F chunk's entries; with several chunks
        # each writes its f32 part of dx
        slabs = torch.zeros((nblk, 2 * D * Fi + Fi + D), dtype=torch.float32,
                            device=x.device)
        nch = -(-Fi // _MMA_FC)
        if nch > 1:
            dxp = torch.empty((nch, T, D), dtype=torch.float32, device=x.device)
    else:
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        slabs = torch.empty((nblk, 2 * D * Fi + Fi + D), dtype=torch.float32,
                            device=x.device)
    opt = lambda t: None if t is None else _ptr(t)  # noqa: E731
    err = _entry("bwd")(_DTYPES[x.dtype], _ptr(x), _ptr(dy), _ptr(w1), _ptr(b1), _ptr(w2),
                        opt(w1t), opt(w2t), _ptr(dx), opt(dxp), _ptr(slabs), nblk, T, D,
                        Fi, ACTS.index(act), _build.stream_handle(x.device))
    _build.check(err, "ffn backward launch")
    fused_ffn_bwd.launches += 1
    fused_ffn_bwd.launches_mma += body == "mma"
    if dxp is not None:
        dx = dxp.sum(0).to(x.dtype)
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
fused_ffn_bwd.launches_mma = 0   # of those, the bf16 tensor-core body's


class _FusedFFN(torch.autograd.Function):
    """Only the inputs are kept; the backward recomputes the activation."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.act = act
        return FFN_FWD_OP(x, w1, b1, w2, b2, ACTS.index(act))

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        return (*fused_ffn_bwd(x, w1, b1, w2, b2, dy, ctx.act), None)


def fused_ffn(x, w1, b1, w2, b2, act: str = "swish") -> torch.Tensor:
    """y = act(x @ w1 + b1) @ w2 + b2, differentiable in every tensor.
    x: [T, D]; w1: [D, F]; b1: [F]; w2: [F, D]; b2: [D]; one dtype
    (float32 or bfloat16). Returns [T, D] in x's dtype."""
    if needs_grad(x, w1, b1, w2, b2):
        return _FusedFFN.apply(x, w1, b1, w2, b2, act)
    return FFN_FWD_OP(x, w1, b1, w2, b2, ACTS.index(act))


fused_ffn.launches = 0
fused_ffn.launches_mma = 0   # of those, the bf16 tensor-core body's



# -------------------------------------------------------- custom operator
# unirec::ffn_fwd (row 12, ops/op_schemas.py): x [T, D] and the flax-layout
# weights, the activation's index in ACTS; a contiguous [T, D] on either
# device. The implementation looks its function up by name at the call
# (chip_smoke.py's plain_versions patches it).
def _ffn_op(fn: str):
    def impl(x, w1, b1, w2, b2, act):
        return globals()[fn](x, w1, b1, w2, b2, ACTS[act]).contiguous()
    return impl


FFN_FWD_OP = define_op("ffn_fwd", _ffn_op("_fwd_plain"), _ffn_op("_fwd_cuda"),
                       lambda x, *a: x.new_empty(x.shape))
