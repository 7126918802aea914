"""Membership test for negative-sampling rejection.

Counterpart of unirec_tpu/ops/member.py. ``member_mask(rows, cand)`` is the
[B, K] bool ``cand[b, k] > 0 and cand[b, k] in rows[b, :]``; on CUDA tensors
it launches csrc/member.cu (the TPU's ``_member_kernel``), on CPU tensors
its plain version, the broadcast compare of data/device_pipeline.py.
``member_mask.launches`` counts kernel launches. Forward only: nothing
differentiates through the sampler.

The kernel has two bodies (``_member_body`` picks one; the wrapper names it
to the C entry point, which refuses a warp launch its own rule does not
admit): "warp", one warp an example holding the history in registers
behind a hashed filter, with an exact vote only on the candidates the
filter flags, for up to 64 candidates an example
(``member_mask.launches_warp`` counts it); "block", the first port's
shared-memory scan, for more.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from unirec_tpu_torch.ops import _build

_ROWS_PER_BLOCK = 8  # csrc/member.cu::kRows
_SMEM_LIMIT = 232_448
_WARP_MAX_K = 64     # csrc/member.cu::kWarpMaxK: two candidates a lane


def member_supported(C: int) -> bool:
    """Whether csrc/member.cu takes histories of C ids at any batch size
    and candidate count: its block body stages kRows histories in shared
    memory (the warp body takes any C, but the gate does not know K, so it
    holds the body that takes more than 64 candidates). The JAX package's gate
    (member.py::member_supported) also holds the TPU's row-block rule and
    4 MB VMEM budget, which Hopper does not have; where that gate declines
    a shape the JAX package computes the same mask by the broadcast
    compare."""
    return 4 * _ROWS_PER_BLOCK * C <= _SMEM_LIMIT


def _member_body(C: int, K: int) -> str:
    """The body of csrc/member.cu that runs the call (its rule
    ``warp_takes``): "warp" for at most 64 candidates an example, whatever
    the history's length (it walks longer ones in passes of 256 ids); else
    "block"."""
    return "warp" if 0 <= C and 0 <= K <= _WARP_MAX_K else "block"


def _member_plain(rows: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    return ((cand[:, :, None] == rows[:, None, :]) & (cand[:, :, None] > 0)).any(-1)


@functools.cache
def _lib():
    fn = _build.library("member").unirec_member
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _member_cuda(rows: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    if rows.device != cand.device or rows.dim() != 2 or cand.dim() != 2 \
            or rows.shape[0] != cand.shape[0]:
        raise ValueError(f"rows [B, C] and cand [B, K] on one device expected, "
                         f"got {tuple(rows.shape)} and {tuple(cand.shape)}")
    if rows.dtype.is_floating_point or cand.dtype.is_floating_point:
        raise TypeError("member takes integer ids")
    B, C = rows.shape
    if not member_supported(C):
        raise ValueError(f"member does not take histories of {C} ids")
    K = cand.shape[1]
    body = _member_body(C, K)
    rows = rows.to(torch.int32).contiguous()
    cand = cand.to(torch.int32).contiguous()
    out = torch.empty(cand.shape, dtype=torch.bool, device=cand.device)
    err = _lib()(rows.data_ptr(), cand.data_ptr(), out.data_ptr(), B, C, K,
                 int(body == "warp"), _build.stream_handle(cand.device))
    _build.check(err, "member launch")
    member_mask.launches += 1
    member_mask.launches_warp += body == "warp"
    return out


def member_mask(rows: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[B, K] bool: cand[b, k] is a real id (>0) present in rows[b, :]."""
    if cand.is_cuda:
        return _member_cuda(rows, cand)
    if cand.device.type == "cpu":
        return _member_plain(rows, cand)
    raise ValueError(f"no member kernel for device {cand.device}")


member_mask.launches = 0
member_mask.launches_warp = 0   # of those, the warp body's
