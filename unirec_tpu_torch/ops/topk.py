"""Full-catalog scoring and exact top-k.

Counterpart of unirec_tpu/ops/topk.py (single-device paths). The catalog
pass of ``fused_catalog_topk`` is ``catalog_blockmax``: per 16-item chunk,
the max of user . item, [B, ceil(N/16)], without writing the [B, N] score
matrix. On CUDA tensors it launches csrc/blockmax.cu (the TPU's
``_blockmax_kernel`` / ``_blockmax_kernel_q``); on CPU tensors it runs its
plain PyTorch version. ``catalog_blockmax.launches`` counts launches on
float items, ``catalog_blockmax.launches_int8`` those on int8 items.

The kernel has two bodies (``_blockmax_body`` picks one; the wrapper names
it to the C entry point, which refuses a tensor-core launch its own rule
does not admit): "mma", bf16 users against bf16 or int8 items of width at
most 128 on the tensor cores, over a grid sized by the card, not by N
(``launches_mma`` and ``launches_int8_mma`` count it); "cuda", the CUDA-core
body, for f32 users or items and wider factors, at most 65,535 x 256 items.
While a profiler runs (utils/tracing.py), ``fused_catalog_topk`` opens
``topk.pass1`` and ``topk.pass2`` and counts its users, the B k ids it
selects and the catalog rows it re-scores (``users``, ``selected``,
``rows_rescored``).

Pass 2 is ``rescore_topk``: on CUDA tensors one launch of
csrc/rescore_topk.cu re-scores each user's kp 16 candidate rows straight
from the catalog, applies the bans and selects the top k on the card
(``rescore_topk.launches``, ``launches_int8``), at every shape: the kernel
picks its body itself, and a working set past shared memory spills to a
workspace the wrapper allocates; on CPU tensors its plain version gathers,
scores, bans and selects with tensor code.

Row-sharded serving (unirec_tpu/ops/topk.py:43-160): the catalog lives
row-sharded over the mesh's ``model`` ranks (``place_item_table`` pads it
with zero rows to a multiple of the shard count); each shard takes its
local top-k (``local_shard_topk``: bias-free through ``fused_catalog_topk``,
whose blockmax launch is row 5/5q once a shard, its padded tail rows banned
by ``invalid_from``; with a bias densely), the candidates are all-gathered
over ``model`` and ``merge_shard_candidates`` takes the final top-k.
``sharded_catalog_topk`` and ``masked_sharded_topk`` run that on a
distributed mesh, or over ``n_shards`` logical shards of one table in one
process through the very same two functions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from unirec_tpu_torch.ops import _build
from unirec_tpu_torch.utils import tracing

CHUNK = 16  # items per block-max chunk (csrc/blockmax.cu::kChunk)
_USER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEM_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MMA_MAX_D = 128  # csrc/blockmax.cu::kMmaMaxD


def full_catalog_scores(model, batch, item_emb: torch.Tensor,
                        tau: float = 1.0) -> torch.Tensor:
    """User emb x item table + bias terms, / tau (reference
    recommender.py:46-96 semantics), in the promoted dtype (MultiVAE's f32
    user embeddings against a bf16 table score in f32, as in JAX)."""
    user = model.user_emb(batch)
    dt = torch.promote_types(user.dtype, item_emb.dtype)
    scores = user.to(dt) @ item_emb.to(dt).T
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


def _blockmax_body(udt, idt, D: int) -> str:
    """The body of csrc/blockmax.cu that runs the call (its rule
    ``mma_takes``): "mma" for bf16 users against bf16 or int8 items of width
    1-128 (padded to a multiple of 16 on the tensor cores); else "cuda"."""
    ok = udt == torch.bfloat16 and idt in (torch.bfloat16, torch.int8) and 1 <= D <= _MMA_MAX_D
    return "mma" if ok else "cuda"


@functools.cache
def _blockmax_lib():
    fn = _build.library("blockmax").unirec_blockmax
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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
    body = _blockmax_body(user_emb.dtype, item_emb.dtype, D)
    if body == "cuda" and -(-N // 256) > 65535:
        raise ValueError(f"the CUDA-core blockmax grid takes at most {65535 * 256} items, "
                         f"got {N}")
    u = user_emb.contiguous()
    it = item_emb.contiguous()
    if body == "mma":   # it reads both in 16-byte words
        u = u if u.data_ptr() % 16 == 0 else u.clone()
        it = it if it.data_ptr() % 16 == 0 else it.clone()
    sc = item_scale.to(torch.float32).contiguous() if quantized else None
    out = torch.empty((B, -(-N // CHUNK)), dtype=torch.float32, device=u.device)
    err = _blockmax_lib()(_USER_DTYPES[u.dtype], _ITEM_DTYPES[it.dtype],
                          ctypes.c_void_p(u.data_ptr()),
                          ctypes.c_void_p(it.data_ptr()),
                          ctypes.c_void_p(sc.data_ptr() if quantized else 0),
                          ctypes.c_void_p(out.data_ptr()), B, N, D, int(body == "mma"),
                          _build.stream_handle(u.device))
    _build.check(err, "blockmax launch")
    if quantized:
        catalog_blockmax.launches_int8 += 1
        catalog_blockmax.launches_int8_mma += body == "mma"
    else:
        catalog_blockmax.launches += 1
        catalog_blockmax.launches_mma += body == "mma"
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
catalog_blockmax.launches_mma = 0        # of launches, the tensor-core body's
catalog_blockmax.launches_int8_mma = 0   # of launches_int8, the tensor-core body's


# ------------------------------------------------------------------ pass 2
def _ban_candidates(sc, iid, N, *, hist_items=None, hist_len=None, keep_ids=None,
                    exclude_pad_item=False, invalid_from=None):
    """Scores ``sc`` [B, C] of candidate ids ``iid`` [B, C] with every
    banned id at -inf: ids at or past N or ``invalid_from``, id 0 under
    ``exclude_pad_item``, and each user's valid history but ``keep_ids``."""
    sc = torch.where(iid < N, sc, float("-inf"))
    if invalid_from is not None:
        sc = torch.where(iid >= invalid_from, float("-inf"), sc)
    if exclude_pad_item:
        sc = torch.where(iid == 0, float("-inf"), sc)
    hcap = 0 if hist_items is None else int(hist_items.shape[1])
    if hcap:
        valid = torch.arange(hcap, device=sc.device)[None, :] < hist_len[:, None]
        hcols = torch.where(valid, hist_items.long(), -1)
        if keep_ids is not None:
            hcols = torch.where(hcols == keep_ids.long()[:, None], -1, hcols)
        banned_sorted = hcols.sort(dim=1).values
        pos = torch.searchsorted(banned_sorted, iid.contiguous()).clamp_(max=hcap - 1)
        banned = banned_sorted.gather(1, pos) == iid
        sc = torch.where(banned, float("-inf"), sc)
    return sc


def _rescore_topk_plain(user_emb, item_emb, blk, k, *, item_scale=None, **bans):
    """Plain PyTorch version of csrc/rescore_topk.cu: the candidate rows
    gathered, scored in f32, banned (``_ban_candidates``), then selected."""
    B = user_emb.shape[0]
    N = item_emb.shape[0]
    kp = blk.shape[1]
    iid = (blk[..., None] * CHUNK
           + torch.arange(CHUNK, device=blk.device)).reshape(B, kp * CHUNK)
    rows = iid.clamp(max=N - 1)
    cand = item_emb[rows].float()                               # [B, kp*16, D]
    sc = torch.bmm(cand, user_emb.float()[:, :, None])[..., 0]
    if item_scale is not None:
        sc = sc * item_scale[rows]
    v, ci = fast_topk(_ban_candidates(sc, iid, N, **bans), k)
    return v, iid.gather(1, ci)


_RESCORE_PAST_CAPACITY = -1   # csrc/rescore_topk.cu::kPastCapacity


@functools.cache
def _rescore_lib():
    lib = _build.library("rescore_topk")
    fn = lib.unirec_rescore_topk
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ws = lib.unirec_rescore_topk_workspace
    ws.argtypes = [ctypes.c_int] * 5
    ws.restype = ctypes.c_longlong
    return fn, ws


def _rescore_cuda(user_emb, item_emb, blk, k, *, hist_items=None, hist_len=None,
                  keep_ids=None, exclude_pad_item=False, invalid_from=None,
                  item_scale=None):
    """Launch csrc/rescore_topk.cu, which picks its body; returns (values
    [B, k] f32, ids [B, k] int64)."""
    if user_emb.dtype not in _USER_DTYPES or item_emb.dtype not in _ITEM_DTYPES:
        raise TypeError(f"rescore_topk takes float32/bfloat16 users and float32/"
                        f"bfloat16/int8 items, got {user_emb.dtype}, {item_emb.dtype}")
    quantized = item_emb.dtype == torch.int8
    if quantized != (item_scale is not None):
        raise ValueError("int8 items need item_scale, and only they take one")
    dev = user_emb.device
    args = dict(item_emb=item_emb, blk=blk, hist_items=hist_items, hist_len=hist_len,
                keep_ids=keep_ids, item_scale=item_scale)
    away = [n for n, t in args.items() if t is not None and t.device != dev]
    if away:
        raise ValueError(f"rescore_topk: {', '.join(away)} not on the users' device {dev}")
    B, D = user_emb.shape
    N = item_emb.shape[0]
    kp = blk.shape[1]
    hcap = 0 if hist_items is None else int(hist_items.shape[1])
    if item_emb.shape[1] != D or blk.shape[0] != B:
        raise ValueError(f"users {tuple(user_emb.shape)}, items {tuple(item_emb.shape)} "
                         f"and chunks {tuple(blk.shape)} do not match")
    if hcap and (hist_len is None or hist_items.shape[0] != B or hist_len.numel() != B):
        raise ValueError(f"hist_items {tuple(hist_items.shape)} needs hist_len of {B} users")
    if (keep_ids is not None and keep_ids.numel() != B) or \
            (quantized and item_scale.numel() != N):
        raise ValueError(f"keep_ids takes one id a user ({B}), item_scale one scale an "
                         f"item ({N})")
    if not 1 <= k <= kp * CHUNK:
        raise ValueError(f"top-{k} of {kp * CHUNK} candidates")
    u = user_emb.contiguous()
    it = item_emb.contiguous()
    as64 = lambda t: None if t is None else t.to(torch.int64).contiguous()  # noqa: E731
    b64, h, hl, keep = as64(blk), as64(hist_items), as64(hist_len), as64(keep_ids)
    sc = item_scale.to(torch.float32).contiguous() if quantized else None
    limit = N if invalid_from is None else max(0, min(N, int(invalid_from)))
    launch, workspace = _rescore_lib()
    ws_bytes = workspace(B, D, kp, k, hcap)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev) if ws_bytes else None
    v = torch.empty((B, k), dtype=torch.float32, device=dev)
    i = torch.empty((B, k), dtype=torch.int64, device=dev)
    ptr = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())  # noqa: E731
    err = launch(_USER_DTYPES[u.dtype], _ITEM_DTYPES[it.dtype], ptr(u), ptr(it), ptr(sc),
                 ptr(b64), ptr(h if hcap else None), ptr(hl if hcap else None), ptr(keep),
                 ptr(v), ptr(i), B, N, D, kp, k, hcap, int(bool(exclude_pad_item)), limit,
                 ptr(ws), ws_bytes, _build.stream_handle(dev))
    if err == _RESCORE_PAST_CAPACITY:
        raise ValueError(f"rescore_topk: {N} items of width {D}, top-{k} of {kp} chunks "
                         f"with {hcap} history ids, is past the kernel's capacity (ids "
                         f"and a user's working set in 32 bits)")
    _build.check(err, "rescore_topk launch")
    if quantized:
        rescore_topk.launches_int8 += 1
    else:
        rescore_topk.launches += 1
    return v, i


def rescore_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, blk: torch.Tensor,
                 k: int, *, hist_items: Optional[torch.Tensor] = None,
                 hist_len: Optional[torch.Tensor] = None,
                 keep_ids: Optional[torch.Tensor] = None,
                 exclude_pad_item: bool = False, invalid_from: Optional[int] = None,
                 item_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of ``fused_catalog_topk``: the top k (values [B, k] f32,
    descending, ids [B, k] int64) of the 16 items of each chunk in ``blk``
    [B, kp] scored against user_emb [B, D], with the bans of
    ``_ban_candidates``. CUDA tensors launch csrc/rescore_topk.cu, CPU
    tensors run the plain version."""
    bans = dict(hist_items=hist_items, hist_len=hist_len, keep_ids=keep_ids,
                exclude_pad_item=exclude_pad_item, invalid_from=invalid_from)
    if user_emb.is_cuda:
        return _rescore_cuda(user_emb, item_emb, blk, k, item_scale=item_scale, **bans)
    if user_emb.device.type == "cpu":
        return _rescore_topk_plain(user_emb, item_emb, blk, k, item_scale=item_scale, **bans)
    raise ValueError(f"no rescore_topk kernel for device {user_emb.device}")


rescore_topk.launches = 0
rescore_topk.launches_int8 = 0


# ---------------------------------------------------------- two-pass top-k
def fused_catalog_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
                       *, chunk: int = CHUNK,
                       hist_items: Optional[torch.Tensor] = None,
                       hist_len: Optional[torch.Tensor] = None,
                       keep_ids: Optional[torch.Tensor] = None,
                       exclude_pad_item: bool = False,
                       invalid_from: Optional[int] = None,
                       max_invalid: int = 0,
                       item_scale: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k straight from the factors (user_emb [B, D], item_emb
    [N, D]): the [B, N] score matrix is never written.

    Pass 1, ``catalog_blockmax``, streams the catalog once and keeps each
    16-item chunk's max; pass 2, ``rescore_topk``, re-scores the k' chunks
    with the largest maxima (a proven superset of the true top-k, with
    headroom for the ragged chunk, the padding item and banned history) and
    selects.
    ``hist_items``/``hist_len`` exclude each user's history,
    ``keep_ids`` [B] exempts one id per user, ``exclude_pad_item`` bans
    id 0, ``invalid_from`` bans every row id from it on (a shard's padded
    tail), of which there are at most ``max_invalid``: each ban buys its
    overfetch of chunks, so the result stays exact (topk.py:308-371); with
    ``item_scale`` the int8 items are scored dequantized.
    Returns (values [B, k] f32, ids [B, k] int64)."""
    B, D = user_emb.shape
    N = item_emb.shape[0]
    dev = user_emb.device
    hcap = 0 if hist_items is None else int(hist_items.shape[1])
    icap = (-(-max_invalid // chunk) + 1) if invalid_from is not None else 0
    kp = k + (chunk if N % chunk else 0) + (1 if exclude_pad_item else 0) + hcap + icap
    nb_real = -(-N // chunk)
    quantized = item_scale is not None
    if quantized and item_emb.dtype != torch.int8:
        raise TypeError("item_scale requires int8 items")
    dense = kp >= nb_real or N <= 4 * k * chunk
    if tracing.profiling():
        _TOPK.users += B
        _TOPK.selected += B * k
        _TOPK.rows_rescored += B * (N if dense else kp * chunk)
    bans = dict(hist_items=hist_items, hist_len=hist_len, keep_ids=keep_ids,
                exclude_pad_item=exclude_pad_item, invalid_from=invalid_from)

    if dense:  # dense at small N
        sc = user_emb.float() @ item_emb.float().T
        if quantized:
            sc = sc * item_scale[None, :]
        iid = torch.arange(N, device=dev).expand(B, N)
        return fast_topk(_ban_candidates(sc, iid, N, **bans), k)

    with tracing.span("topk.pass1"):
        bm = catalog_blockmax(user_emb, item_emb, chunk, item_scale)
        _, blk = fast_topk(bm, kp)                                  # [B, kp]
    with tracing.span("topk.pass2"):
        return rescore_topk(user_emb, item_emb, blk, k, item_scale=item_scale, **bans)


fused_catalog_topk.users = 0
fused_catalog_topk.selected = 0        # B k
fused_catalog_topk.rows_rescored = 0   # B kp chunk in pass 2, B N on the dense path
# the counters' owner, bound once: a caller may rebind the module's name to a
# wrapper of its own (a benchmark's span), which holds no counters
_TOPK = fused_catalog_topk


# ------------------------------------------------------------ row-sharded
def place_item_table(item_emb: torch.Tensor, n_shards: int, rank: Optional[int] = None
                     ) -> Tuple[torch.Tensor, int]:
    """The [N, D] table (or an [N] column: scales, biases) zero-padded to a
    multiple of ``n_shards`` rows (topk.py:148-158); with ``rank``, only that
    shard's rows. Returns (rows, padded N)."""
    N = item_emb.shape[0]
    pad = (-N) % n_shards
    if pad:
        item_emb = torch.cat([item_emb, item_emb.new_zeros((pad, *item_emb.shape[1:]))])
    if rank is None:
        return item_emb, N + pad
    n_local = (N + pad) // n_shards
    return item_emb[rank * n_local:(rank + 1) * n_local].contiguous(), N + pad


def local_shard_topk(u: torch.Tensor, shard: torch.Tensor, offset: int, n_real: int,
                     k_local: int, bias: Optional[torch.Tensor] = None,
                     scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's top-``k_local`` (values, global ids) of user_emb ``u``
    [B, D] against its rows ``shard`` [n_local, D], the global rows
    [offset, offset + n_local); rows at or past ``n_real`` are padding.
    Bias-free: ``fused_catalog_topk`` (row 5/5q), the padding banned by
    ``invalid_from``; with ``bias`` [n_local]: dense f32 scores (int8 rows
    dequantized by ``scale``), the padding at -inf, ``fast_topk``."""
    n_local = shard.shape[0]
    valid = min(max(n_real - offset, 0), n_local)
    if bias is None:
        v, i = fused_catalog_topk(u, shard, k_local, invalid_from=valid,
                                  max_invalid=n_local - valid, item_scale=scale)
    else:
        local = u.float() @ shard.float().T
        if scale is not None:
            local = local * scale[None, :]
        local = local + bias[None, :]
        local[:, valid:] = float("-inf")
        v, i = fast_topk(local, k_local)
    return v, i + offset


def merge_shard_candidates(vals: torch.Tensor, ids: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final top-k of the shards' candidates, vals and global ids
    [B, S * k_local]."""
    v, sel = fast_topk(vals, k)
    return v, ids.gather(1, sel)


def sharded_catalog_topk(user_emb: torch.Tensor, item_shard: torch.Tensor, k: int,
                         mesh=None, *, n_real: int, n_shards: Optional[int] = None,
                         item_bias: Optional[torch.Tensor] = None,
                         item_scale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k], global ids [B, k]) over a row-sharded catalog
    (topk.py:43-114). On a distributed ``mesh`` ``item_shard`` (and the
    bias and scale) are this model rank's rows and the candidates are
    all-gathered over ``model``; without one, ``item_shard`` is the whole
    padded table, taken as ``n_shards`` logical shards in this process.
    ``n_real``: the unpadded item count."""
    if k > n_real:
        raise ValueError(f"top-{k} requested from a {n_real}-item catalog")
    distributed = mesh is not None and mesh.distributed
    S = mesh.n_model if distributed else int(n_shards or 1)
    n_local = item_shard.shape[0] if distributed else item_shard.shape[0] // S
    if not distributed and item_shard.shape[0] != S * n_local:
        raise ValueError(f"a padded table of {item_shard.shape[0]} rows does not split "
                         f"into {S} shards")
    k_local = min(k, n_local)   # a shard contributes at most n_local items
    if distributed:
        from unirec_tpu_torch.core.mesh import all_gather_rows
        m = mesh.rank("model")
        v, i = local_shard_topk(user_emb, item_shard, m * n_local, n_real, k_local,
                                item_bias, item_scale)
        group = mesh.group("model")
        B = user_emb.shape[0]
        # k_local candidates a shard cross the ranks: [S * B, kl] -> [B, S * kl]
        vals = all_gather_rows(v, group).view(S, B, k_local).transpose(0, 1).reshape(B, -1)
        ids = all_gather_rows(i, group).view(S, B, k_local).transpose(0, 1).reshape(B, -1)
    else:
        parts = []
        for s in range(S):
            rows = slice(s * n_local, (s + 1) * n_local)
            parts.append(local_shard_topk(
                user_emb, item_shard[rows], s * n_local, n_real, k_local,
                None if item_bias is None else item_bias[rows],
                None if item_scale is None else item_scale[rows]))
        vals = torch.cat([p[0] for p in parts], 1)
        ids = torch.cat([p[1] for p in parts], 1)
    return merge_shard_candidates(vals, ids, k)


def masked_sharded_topk(user_emb: torch.Tensor, item_shard: torch.Tensor,
                        hist_items: torch.Tensor, hist_len: torch.Tensor, k: int,
                        mesh=None, *, n_real: int, n_shards: Optional[int] = None,
                        item_bias: Optional[torch.Tensor] = None,
                        item_scale: Optional[torch.Tensor] = None,
                        exclude_pad_item: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-sharded catalog with each user's history
    excluded (topk.py:117-145): at most C history ids (and the padding
    item) can be banned, so fetching k + C (+1) sharded candidates and
    filtering afterwards leaves at least k. Returns (values, ids) [B, k]."""
    C = hist_items.shape[1]
    fetch = min(k + C + (1 if exclude_pad_item else 0), int(n_real))
    vals, ids = sharded_catalog_topk(user_emb, item_shard, fetch, mesh, n_real=n_real,
                                     n_shards=n_shards, item_bias=item_bias,
                                     item_scale=item_scale)
    valid = torch.arange(C, device=ids.device)[None, :] < hist_len[:, None]
    hcols = torch.where(valid, hist_items.long(), -1)
    banned = (ids[:, :, None] == hcols[:, None, :]).any(-1)
    if exclude_pad_item:
        banned |= ids == 0
    return merge_shard_candidates(torch.where(banned, float("-inf"), vals), ids, k)
