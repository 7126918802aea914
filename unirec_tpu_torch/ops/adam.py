"""Adam in place: the whole update of every leaf in one hand-written kernel.

``adam_step(params, grads, mu, nu, count, lr, loss, ...)`` updates float32
CUDA leaves, their moments and the step count in place under the NaN guard:
when ``loss`` is not finite, nothing changes. It launches csrc/adam.cu, one
launch for every ``max_leaves()`` leaves (the kernel's argument table),
with no host read, so the host runs on ahead of the step; other devices
raise, after the same checks of what the kernel takes. It replaces no TPU
kernel: XLA fused the JAX package's optax chain. The arithmetic is
core/optim.py::Optimizer.update's for the Adam kinds, element by element
in optax's order, followed by the trainer's guarded apply ``p + u``: that
chain is the kernel's plain version, which ``Optimizer.step_`` runs on CPU
leaves. ``decay`` is ``L2`` (adam, sparse_adam: grad += wd p) or
``DECOUPLED`` (adamw: u += wd p) when wd > 0; with ``clip`` > 0 the
gradients are scaled by the global norm ``gnorm``, a 0-d tensor on the
leaves' device.

Counters (utils/tracing.py, key ``adam``): ``adam_step.launches_fused``
counts the kernel's launches, ``launches_plain`` the updates through its
plain version (``Optimizer.step_`` bumps it); the work counter ``leaves``
counts the leaves the kernel updated, while a profiler runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import torch

from unirec_tpu_torch.ops import _build
from unirec_tpu_torch.utils import tracing

NO_DECAY, L2, DECOUPLED = 0, 1, 2


@functools.cache
def _lib():
    lib = _build.library("adam")
    fn = lib.unirec_adam
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                   ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.unirec_adam_max_leaves.restype = ctypes.c_int
    return fn, lib.unirec_adam_max_leaves


def max_leaves() -> int:
    """The most leaves one launch of the kernel takes (its argument table)."""
    return _lib()[1]()


def new_ticket(device) -> torch.Tensor:
    """The kernel's last-block ticket: one zeroed 32-bit word on ``device``,
    zero again after every update; its owner passes it to each call."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _adam_cuda(params, grads, mu, nu, count, lr, loss, b1, b2, eps, wd, decay, clip,
               gnorm, ticket) -> None:
    """Launch csrc/adam.cu over every leaf; no host read."""
    if ticket is None or ticket.dtype != torch.int32 or ticket.device != count.device:
        raise ValueError("the kernel needs its int32 ticket (new_ticket) on the leaves' device")
    quads = [t for quad in zip(params, grads, mu, nu) for t in quad]
    n = len(params)
    ptrs = (ctypes.c_uint64 * (4 * n))(*[t.data_ptr() for t in quads])
    numels = (ctypes.c_int64 * n)(*[p.numel() for p in params])
    err = _lib()[0](n, ptrs, numels, loss.data_ptr(), lr.data_ptr(),
                    gnorm.data_ptr() if clip > 0 else None, count.data_ptr(),
                    ticket.data_ptr(), b1, b2, eps, wd, clip, decay,
                    _build.stream_handle(count.device))
    _build.check(err, "adam launch")
    adam_step.launches_fused += max(1, -(-n // max_leaves()))   # n == 0 launches once
    if tracing.profiling():
        adam_step.leaves += n


def _checked(params, grads, mu, nu, count, lr, loss, clip, gnorm):
    """Refuse what the kernel does not take; the gradients made contiguous
    (a copy on the device where one is not) and the loss as f32."""
    dev = params[0].device if params else count.device
    if not (len(params) == len(grads) == len(mu) == len(nu)):
        raise ValueError("params, grads, mu and nu must have one entry per leaf")
    for what, ts in (("param", params), ("grad", grads), ("mu", mu), ("nu", nu)):
        for t in ts:
            if t.dtype != torch.float32:
                raise TypeError(f"adam_step takes float32 leaves, got a {t.dtype} {what}")
            if t.device != dev:
                raise ValueError(f"adam_step: a {what} on {t.device}, the leaves on {dev}")
    for p, g, m, v in zip(params, grads, mu, nu):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"adam_step: a leaf of shape {tuple(p.shape)} with grad "
                             f"{tuple(g.shape)}, mu {tuple(m.shape)}, nu {tuple(v.shape)}")
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError("adam_step writes its leaves in place: param, mu and nu "
                             "must be contiguous")
    if count.dtype != torch.int32 or count.numel() != 1 or count.device != dev:
        raise ValueError(f"adam_step: count must be one int32 on {dev}")
    for what, t in (("lr", lr), ("loss", loss)) + ((("gnorm", gnorm),) if clip > 0 else ()):
        if t is None or t.numel() != 1 or t.device != dev:
            raise ValueError(f"adam_step: {what} must be one value on {dev}")
    if lr.dtype != torch.float32:
        raise TypeError(f"adam_step: lr must be float32, got {lr.dtype}")
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    return grads, loss.detach().float(), None if gnorm is None else gnorm.float()


def adam_step(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
              nu: List[torch.Tensor], count: torch.Tensor, lr: torch.Tensor,
              loss: torch.Tensor, *, b1: float, b2: float, eps: float, wd: float = 0.0,
              decay: int = NO_DECAY, clip: float = -1.0,
              gnorm: Optional[torch.Tensor] = None,
              ticket: Optional[torch.Tensor] = None) -> None:
    """One Adam update of float32 ``params`` from ``grads``, in place with
    ``mu``, ``nu`` and ``count`` (0-d int32), at the 0-d learning rate
    ``lr``, unless ``loss`` is not finite, through the kernel (``ticket``:
    ``new_ticket``, kept by the caller). Leaves off the card raise."""
    grads, loss, gnorm = _checked(params, grads, mu, nu, count, lr, loss, clip, gnorm)
    args = (params, grads, mu, nu, count, lr, loss, b1, b2, eps, wd, decay, clip, gnorm)
    with torch.no_grad():
        if not count.is_cuda:
            raise ValueError(f"no adam kernel for device {count.device}")
        _adam_cuda(*args, ticket)


adam_step.launches_fused = 0
adam_step.launches_plain = 0  # updates through Optimizer.step_'s plain version
adam_step.leaves = 0          # work counter: leaves the kernel updated, under a profiler
