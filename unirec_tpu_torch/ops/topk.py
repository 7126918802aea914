"""Full-catalog scoring and exact top-k.

Counterpart of unirec_tpu/ops/topk.py (single-device paths). The catalog
pass of ``fused_catalog_topk`` is ``catalog_blockmax``: per 16-item chunk,
the max of user . item, [B, ceil(N/16)], without writing the [B, N] score
matrix. On CUDA tensors it launches csrc/blockmax.cu (the TPU's
``_blockmax_kernel`` / ``_blockmax_kernel_q``); on CPU tensors it runs its
plain PyTorch version. ``catalog_blockmax.launches`` counts launches of the
float bodies, ``catalog_blockmax.launches_int8`` those of the int8 body.

The row-sharded paths (``sharded_catalog_topk``, ``masked_sharded_topk``)
and approximate selection (``lax.approx_max_k``) are not ported yet
(ROADMAP.md Queue 1 items 10 and 12).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from unirec_tpu_torch.ops import _build

CHUNK = 16  # items per block-max chunk (csrc/blockmax.cu::kChunk)
_USER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEM_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def full_catalog_scores(model, batch, item_emb: torch.Tensor,
                        tau: float = 1.0) -> torch.Tensor:
    """User emb x item table + bias terms, / tau (reference
    recommender.py:46-96 semantics)."""
    scores = model.user_emb(batch) @ item_emb.T
    ub, ib = model.bias_terms()
    if ib is not None:
        scores = scores + ib[None, :]
    if ub is not None:
        scores = scores + ub[batch["user_id"]][:, None]
    return scores / tau


def fast_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis. The JAX package's block-max
    selection existed to avoid a full TPU sort (unirec_tpu/ops/topk.py:
    167-171); ``torch.topk`` selects without one."""
    return torch.topk(x, k, dim=-1)


def quantize_catalog(item_emb: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: ``q[i] = round(e[i] / s[i])``
    with ``s[i] = max|e[i]| / 127`` (1 for an all-zero row)."""
    e = item_emb.to(torch.float32)
    scale = e.abs().amax(dim=1) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(e / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


# ------------------------------------------------------------------- blockmax
def _blockmax_plain(user_emb, item_emb, item_scale=None) -> torch.Tensor:
    """Plain PyTorch version of csrc/blockmax.cu."""
    B = user_emb.shape[0]
    N = item_emb.shape[0]
    s = user_emb.float() @ item_emb.float().T
    if item_scale is not None:
        s = s * item_scale.float()[None, :]
    nb = -(-N // CHUNK)
    s = torch.nn.functional.pad(s, (0, nb * CHUNK - N), value=float("-inf"))
    return s.view(B, nb, CHUNK).amax(dim=-1)


@functools.cache
def _blockmax_lib():
    fn = _build.library("blockmax").unirec_blockmax
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _blockmax_cuda(user_emb, item_emb, item_scale=None) -> torch.Tensor:
    """Launch csrc/blockmax.cu; returns [B, ceil(N/16)] f32."""
    if user_emb.dtype not in _USER_DTYPES or item_emb.dtype not in _ITEM_DTYPES:
        raise TypeError(f"blockmax takes float32/bfloat16 users and float32/"
                        f"bfloat16/int8 items, got {user_emb.dtype}, {item_emb.dtype}")
    quantized = item_emb.dtype == torch.int8
    if quantized != (item_scale is not None):
        raise ValueError("int8 items need item_scale, and only they take one")
    B, D = user_emb.shape
    N = item_emb.shape[0]
    if item_emb.shape[1] != D or item_emb.device != user_emb.device:
        raise ValueError(f"users {tuple(user_emb.shape)} on {user_emb.device} and "
                         f"items {tuple(item_emb.shape)} on {item_emb.device} do not match")
    if -(-N // 256) > 65535:
        raise ValueError(f"blockmax grid takes at most {65535 * 256} items, got {N}")
    u = user_emb.contiguous()
    it = item_emb.contiguous()
    sc = item_scale.to(torch.float32).contiguous() if quantized else None
    out = torch.empty((B, -(-N // CHUNK)), dtype=torch.float32, device=u.device)
    err = _blockmax_lib()(_USER_DTYPES[u.dtype], _ITEM_DTYPES[it.dtype],
                          ctypes.c_void_p(u.data_ptr()),
                          ctypes.c_void_p(it.data_ptr()),
                          ctypes.c_void_p(sc.data_ptr() if quantized else 0),
                          ctypes.c_void_p(out.data_ptr()), B, N, D,
                          _build.stream_handle(u.device))
    _build.check(err, "blockmax launch")
    if quantized:
        catalog_blockmax.launches_int8 += 1
    else:
        catalog_blockmax.launches += 1
    return out


def catalog_blockmax(user_emb: torch.Tensor, item_emb: torch.Tensor,
                     chunk: int = CHUNK,
                     item_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-``chunk``-item maxima of user_emb [B, D] x item_emb [N, D] scores
    (f32 accumulation), [B, ceil(N/chunk)]; a ragged last chunk takes the
    max over its real items. ``item_scale`` [N] f32 goes with int8 items:
    each item's score is multiplied by its scale before the max."""
    if chunk != CHUNK:
        raise ValueError(f"catalog_blockmax takes chunk={CHUNK}, got {chunk}")
    if user_emb.is_cuda:
        return _blockmax_cuda(user_emb, item_emb, item_scale)
    if user_emb.device.type == "cpu":
        return _blockmax_plain(user_emb, item_emb, item_scale)
    raise ValueError(f"no blockmax kernel for device {user_emb.device}")


catalog_blockmax.launches = 0
catalog_blockmax.launches_int8 = 0


# ---------------------------------------------------------- two-pass top-k
def fused_catalog_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
                       *, chunk: int = CHUNK,
                       hist_items: Optional[torch.Tensor] = None,
                       hist_len: Optional[torch.Tensor] = None,
                       keep_ids: Optional[torch.Tensor] = None,
                       exclude_pad_item: bool = False,
                       item_scale: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k straight from the factors (user_emb [B, D], item_emb
    [N, D]): the [B, N] score matrix is never written.

    Pass 1, ``catalog_blockmax``, streams the catalog once and keeps each
    16-item chunk's max; pass 2 re-scores the k' chunks with the largest
    maxima (a proven superset of the true top-k, with headroom for the
    ragged chunk, the padding item and banned history) and selects.
    ``hist_items``/``hist_len`` exclude each user's history,
    ``keep_ids`` [B] exempts one id per user, ``exclude_pad_item`` bans
    id 0; with ``item_scale`` the int8 items are scored dequantized.
    Returns (values [B, k] f32, ids [B, k] int64)."""
    B, D = user_emb.shape
    N = item_emb.shape[0]
    dev = user_emb.device
    hcap = 0 if hist_items is None else int(hist_items.shape[1])
    kp = k + (chunk if N % chunk else 0) + (1 if exclude_pad_item else 0) + hcap
    nb_real = -(-N // chunk)

    banned_sorted = None
    if hcap:
        valid = torch.arange(hcap, device=dev)[None, :] < hist_len[:, None]
        hcols = torch.where(valid, hist_items.long(), -1)
        if keep_ids is not None:
            hcols = torch.where(hcols == keep_ids.long()[:, None], -1, hcols)
        banned_sorted = hcols.sort(dim=1).values

    def mask_candidates(sc, iid):
        sc = torch.where(iid < N, sc, float("-inf"))
        if exclude_pad_item:
            sc = torch.where(iid == 0, float("-inf"), sc)
        if banned_sorted is not None:
            pos = torch.searchsorted(banned_sorted, iid.contiguous()).clamp_(max=hcap - 1)
            banned = banned_sorted.gather(1, pos) == iid
            sc = torch.where(banned, float("-inf"), sc)
        return sc

    quantized = item_scale is not None
    if quantized and item_emb.dtype != torch.int8:
        raise TypeError("item_scale requires int8 items")

    if kp >= nb_real or N <= 4 * k * chunk:  # dense at small N
        sc = user_emb.float() @ item_emb.float().T
        if quantized:
            sc = sc * item_scale[None, :]
        iid = torch.arange(N, device=dev).expand(B, N)
        return fast_topk(mask_candidates(sc, iid), k)

    bm = catalog_blockmax(user_emb, item_emb, chunk, item_scale)
    _, blk = fast_topk(bm, kp)                                  # [B, kp]
    iid = (blk[..., None] * chunk
           + torch.arange(chunk, device=dev)).reshape(B, kp * chunk)
    rows = iid.clamp(max=N - 1)
    cand = item_emb[rows].float()                               # [B, kp*chunk, D]
    sc = torch.bmm(cand, user_emb.float()[:, :, None])[..., 0]
    if quantized:
        sc = sc * item_scale[rows]
    v, ci = fast_topk(mask_candidates(sc, iid), k)
    return v, iid.gather(1, ci)
