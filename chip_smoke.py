#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unirec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of every path from unirec_tpu_torch/csrc
     with nvcc for sm_90a, one nvcc process per source, all at once;
  3. each kernel at the serving shapes against its plain PyTorch version on
     the same inputs, with the tolerance stated in its line, and timed:
     kernel, plain version, a PyTorch yardstick where one exists, and the
     least time the card could take (bound); the whole layer in its bf16
     tensor-core body, with its CUDA-core body timed in turns with it (at
     least 3x slower) and nn.TransformerEncoderLayer on the same weights
     and mask as the yardstick (its agreement with the plain version
     reported); the last-query layer likewise in its tensor-core body, its
     CUDA-core body timed in turns beside it (no gate at this batch);
  4. the serving path: a bench-width SASRec (2 layers, d=64, 2 heads, inner
     128, L=50, 50,000 items; random weights from a seed, saved and loaded
     as a checkpoint) serves top-100 to a few thousand users of a synthetic
     100,000-user history through reco_topk.get_topk_recommendations, with
     a bf16 catalog and then an int8 one. Every serving kernel's launch
     count must rise in that run (both layers in their tensor-core bodies),
     and the ids must agree with the same model
     run through the plain versions on the card;
  5. the training kernels at bench.py's training shapes (B=32,768): the two
     forward layers with dropout 0.1, their backwards, the embedding-grad
     scatter-add (on uniform ids at the paths' four shapes, its sorted-tile
     body timed in turns with its per-row body) and the negative-membership
     test, each against its plain version with the same inputs and dropout
     seeds, and timed; both layers' forwards and backwards in their bf16
     tensor-core bodies, each with its CUDA-core body timed in turns with it
     (at least 3x slower for the forwards and the last-query backward, 5x
     for the layer backward), the key biases' zero-sum checks and another seed's
     masks (which must disagree); nn.TransformerEncoderLayer's train-mode
     forward, and forward and backward, as the layer's yardsticks;
  6. the training path: bench.py's workload (SASRec as above, BCE with 9
     rejection-sampled negatives, Adam, dropout 0.1, bf16, batch 32,768,
     with neg_membership_pallas on) trained through the port's
     Trainer.fit, 3 warm-up and 24 timed steps; the loss must stay finite
     and fall, and every training kernel must launch (both layers' forwards
     and backwards in their tensor-core bodies, the scatter-add in its
     sorted-tile body).
     Then one step from the
     same weights, batch and seeds through the kernels and through the plain
     versions, loss and every gradient compared; then two traced steps;
  7. the fused attention kernels (forward, backward) at B=32,768, H=2, L=50,
     head dim 32, bf16, at dropout 0 and 0.1, and with a per-head mask (the
     backward in its bf16 tensor-core body, whose dropout mask is also held
     to the forward's keying bit for bit; bf16 runs both directions on the
     tensor cores); the fused FFN kernels at 1,638,400, 32,768 and
     2,097,152 tokens (d=64, inner 128, swish; bf16 both ways on the
     tensor cores, the forward's CUDA-core body timed beside it and the
     forward faster than addmm -> silu -> addmm at the two large counts)
     and over all six activations; each against its plain version;
  8. the entry path: main.run(task=train) on sasrec_fusedattn_ffn (bench.py's
     widths with use_fused_attention and use_fused_ffn in place of the fused
     layers) over synthetic data at bench.py's scale written under build/,
     2 epochs of 200 steps with one-vs-all validation before each and the
     test after; the best validation's hit@10 must show that the model
     learned, main.run(task=test) from the best checkpoint must give the
     same metrics, and every kernel of the path must launch. Then one step
     at dropout 0 and one eval batch through the kernels and the plain
     versions (loss, gradients, each row's rank of the positive, metrics),
     whose two scatter-adds (the item_seq and the candidate gathers' ids and
     gradient rows) are then timed as lines of their own: the sorted-tile
     body at least 3x its per-row body on the item_seq ids, index_add_
     beside them; and a traced step and eval batch; the tensor-core bodies
     of the attention pair and of both FFN directions and the sorted-tile
     scatter must launch there;
  9. flash attention (row 9) at the long path's training shape (B=8,192,
     H=2, L=256, hd=32) in bf16 (the tensor-core body) and f32 (the
     CUDA-core body), at L=264 and L=1,024, and at the
     serving shape, against its plain version; the plain backward's time
     and peak memory; and the fused attention kernels' tiled pair at L=300
     and L=512 (p=0 and 0.1); then (wide_widths) the widths the earlier
     kernels refused: flash attention and the fused attention pair at head
     widths 136 and 256, the fused FFN at (D, F) = (256, 1024) and (64,
     2048), each against its plain version and timed;
 10. the long path: main.run(task=train) on sasrec_long256_flash (the entry
     path's widths at max_seq_len 256 with use_pallas, attention dropout 0,
     batch 8,192) over synthetic data with 64-767 training items per user,
     2 epochs of 300 steps with one-vs-all validation before each: the best
     validation's hit@10 must reach 0.1, task=test from the best checkpoint
     must repeat the metrics, task=infer must write one finite score per
     test row that agrees with model.predict through the plain versions, and
     flash attention must launch in training, evaluation and infer, and
     both FFN directions' tensor-core bodies in training (the layer
     kernels and the fused attention kernels never). Then one step at
     dropout 0 and one eval batch through the kernels and the plain
     versions (its scatter-adds timed as on the entry path, with the same
     gate), a traced step and eval batch, and top-100 serving of 4,096
     users from the long checkpoint (flash attention and blockmax launch;
     the ids agree with the plain-version run).
Then it prints its wall time (and each of phases 9-10), the card, one
{"kernels": [...]} line and, last, {"ok": true, ...}.
It exits non-zero, without the "ok" line, when any phase fails, when no CUDA
card is visible, or when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; f32 off the tensor cores
N_USERS, N_ITEMS, HIST_CAP, SEQ_LEN, EMB = 100_000, 50_000, 200, 50, 64
SERVE_USERS, BATCH, TOPK = 4096, 256, 100
LN_TOL = {"bfloat16": 3e-2, "float32": 1e-4}  # abs, on O(1) LayerNorm outputs
TRAIN_BATCH, N_NEG, P_DROP = 32_768, 9, 0.1
WARMUP_STEPS, TIMED_STEPS = 3, 24
# backward and gradient checks, relative to each output's largest reference
# value: the kernels round to bf16 where the plain versions do, but sum in
# another order, so a rounding can flip and later roundings carry it
BWD_TOL = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def emb_tol(u) -> float:
    """Tolerance on bf16 user embeddings (LayerNorm outputs), kernels against
    plain: LN_TOL or two bf16 ulps of the largest one, whichever is larger. A
    rounding that flips moves an element by one ulp, and trained LN outputs
    pass 4, where one ulp is 2^-5 > LN_TOL."""
    return max(LN_TOL["bfloat16"], 2.0 ** -6 * float(u.abs().max()))


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


# ------------------------------------------------------------------ kernels
def layer_inputs(torch, dtype, B=BATCH, L=SEQ_LEN, D=EMB, F=2 * EMB, seed=SEED):
    """Serving-shape layer inputs: LN-scale activations, left-padded key
    rows of 10..L real items, weights at the model's init scale."""
    from unirec_tpu_torch.ops import layer as LY
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=g, device="cuda") * std  # noqa: E731
    x = rn(B, L, D).to(dtype)
    lens = torch.randint(10, L + 1, (B,), generator=g, device="cuda")
    madd = torch.where(torch.arange(L, device="cuda")[None, :] >= L - lens[:, None],
                       0.0, LY.MASK_VALUE)
    lin = lambda i, o: (rn(i, o, std=0.1), rn(o, std=0.02))  # noqa: E731
    ln = lambda: (1.0 + rn(D, std=0.1), rn(D, std=0.1))  # noqa: E731
    params = (lin(D, D), lin(D, D), lin(D, D), lin(D, D), ln(),
              lin(D, F), lin(F, D), ln())
    xp, mp, _ = LY._pad_L(x, madd, L)
    return xp, mp, params


def kernel_layer(torch, dtype_name, act="swish", causal=True, timed=True):
    from unirec_tpu_torch.ops import layer as LY
    dt = getattr(torch, dtype_name)
    xp, mp, params = layer_inputs(torch, dt)
    flat = LY._layer_weights(params, dt)
    args = (2, act, 1e-10, causal)
    y = LY._layer_fwd_cuda(xp, mp, flat, *args)
    ref = LY._layer_fwd_plain(xp, mp, flat, *args)
    torch.cuda.synchronize()
    err = float((y.float() - ref.float()).abs().max())
    tol = LN_TOL[dtype_name]
    line = {"phase": "kernel", "name": "layer_fwd", "act": act, "causal": causal,
            "shape": list(xp.shape), "dtype": dtype_name, "max_abs_err": err,
            "tol": tol, "finite": bool(torch.isfinite(y).all())}
    ok = True
    if timed:
        B, Lp, D = xp.shape
        F = flat[6].shape[1]
        line["kernel_ms"] = cuda_ms(lambda: LY._layer_fwd_cuda(xp, mp, flat, *args))
        line["plain_ms"] = cuda_ms(lambda: LY._layer_fwd_plain(xp, mp, flat, *args))
        line["bound_ms"], line["bound_by"] = bound_ms(nbytes(xp, mp, *flat, y),
                                                      layer_flops(B, Lp, D, F), dtype_name)
        line["library_ms"] = None
        if dtype_name == "bfloat16":
            lib = encoder_layer_yardstick(torch, xp, mp, flat, ref, *args, LY.NO_DROP)
            line.update(lib)
            ok, _ = fwd_bodies(torch, "layer", line, xp, mp, flat, args, ref)
    emit(line)
    if not (err <= tol and line["finite"] and ok):
        raise AssertionError(f"layer_fwd disagrees with its plain version: {line}")
    return line


def bodies_in_turns(line, selector, run, mma_iters, rounds=3, module=None, other="cuda",
                    other_iters=3):
    """The kernel's time in its own body and in its older body (the CUDA-core
    one, or ``other``), timed in turns (own, other, then other, own, ...) so
    that both meet the card at the same clocks. The own body's median goes
    to line["kernel_ms"], every run's time to line["in_turns_ms"]; returns
    the other body's median. ``selector`` names the function of ``module``
    (ops/layer.py unless given) that picks the body; ``run`` launches the
    kernel."""
    if module is None:
        from unirec_tpu_torch.ops import layer as module
    times = {"own": [], other: []}
    for r in range(rounds):
        for body in ("own", other) if r % 2 == 0 else (other, "own"):
            with (mock.patch.object(module, selector, lambda *a: other) if body == other
                  else nullcontext()):
                times[body].append(cuda_ms(run, iters=mma_iters) if body == "own"
                                   else cuda_ms(run, iters=other_iters, warmup=1))
    line["kernel_ms"] = statistics.median(times["own"])
    line["in_turns_ms"] = times
    return statistics.median(times[other])


def fwd_bodies(torch, which, line, xp, mp, flat, args, ref, gate=3):
    """Rows 1 ("layer") and 3 ("lastq"): the checks beyond the common ones,
    into the kernel line: which body ran, and the CUDA-core body on the same
    inputs, against the plain version and timed in this run in turns with it
    ("cuda_core"), which the tensor-core body must beat ``gate``-fold (no
    gate when None). Returns (ok, the CUDA-core body's row)."""
    from unirec_tpu_torch.ops import layer as LY
    _, Lp, D = xp.shape
    if which == "layer":
        selector, kernel, F, nh = "_layer_fwd_body", LY._layer_fwd_cuda, flat[6].shape[1], args[0]
    else:
        selector, kernel, F, nh = "_lastq_fwd_body", LY._lastq_fwd_cuda, flat[10].shape[1], args[1]
    line["body"] = getattr(LY, selector)(xp.dtype, Lp, D, F, nh)
    with mock.patch.object(LY, selector, lambda *a: "cuda"):
        yc = kernel(xp, mp, flat, *args)
    core = {"body": "cuda", "max_abs_err": float((yc.float() - ref.float()).abs().max()),
            "kernel_ms": bodies_in_turns(line, selector, lambda: kernel(xp, mp, flat, *args), 20),
            **{k: line[k] for k in ("plain_ms", "bound_ms", "bound_by", "library_ms")}}
    line["cuda_core"] = core
    line["cuda_core_over_mma"] = core["kernel_ms"] / line["kernel_ms"]
    line["gate"] = gate
    ok = (line["body"] == "mma" and core["max_abs_err"] <= line["tol"]
          and (gate is None or gate * line["kernel_ms"] <= core["kernel_ms"]))
    return ok, core


def encoder_layer(torch, flat, nh, eps, p_drop):
    """torch.nn.TransformerEncoderLayer holding the fused layer's weights:
    the same post-LN layer (batch_first, norm_first=False, swish as F.silu,
    the dtype of the weights), the library yardstick of rows 1 and 2; the
    port never calls it."""
    import torch.nn.functional as TF
    wqkv, bqkv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2 = flat
    D, F = wqkv.shape[0], w1.shape[1]
    m = torch.nn.TransformerEncoderLayer(D, nh, F, dropout=p_drop, activation=TF.silu,
                                         layer_norm_eps=eps, batch_first=True,
                                         norm_first=False, device="cuda", dtype=wqkv.dtype)
    with torch.no_grad():
        for dst, src in ((m.self_attn.in_proj_weight, wqkv.T), (m.self_attn.in_proj_bias, bqkv),
                         (m.self_attn.out_proj.weight, wo.T), (m.self_attn.out_proj.bias, bo),
                         (m.linear1.weight, w1.T), (m.linear1.bias, b1),
                         (m.linear2.weight, w2.T), (m.linear2.bias, b2),
                         (m.norm1.weight, g1), (m.norm1.bias, c1),
                         (m.norm2.weight, g2), (m.norm2.bias, c2)):
            dst.copy_(src)
    return m


def encoder_mask(torch, mp, Lp, nh, causal, dtype):
    """The additive mask of the fused layer (ops/layer.py::_attn_mask), one
    [Lp, Lp] slice per example and head, as nn.MultiheadAttention takes it."""
    from unirec_tpu_torch.ops import layer as LY
    return LY._attn_mask(mp, Lp, causal).repeat_interleave(nh, 0).to(dtype)


def encoder_layer_yardstick(torch, xp, mp, flat, ref, nh, act, eps, causal, drop,
                            backward=False, dy=None, row=None):
    """The library call's time on the kernel's inputs (eval when the kernel
    ran without dropout, else train mode with the path's dropout; forward, or
    forward and backward), and in eval mode without dropout its agreement
    with the plain version (its output's ``row`` alone when given): two bf16
    ulps of the largest LN output."""
    assert act == "swish"
    _, Lp, _ = xp.shape
    mask = encoder_mask(torch, mp, Lp, nh, causal, xp.dtype)
    train = drop.t_attn != 0
    m = encoder_layer(torch, flat, nh, eps, P_DROP if train else 0.0)
    out = {}
    with torch.no_grad():
        m.eval()
        ev = m(xp, src_mask=mask)
        if row is not None:
            ev = ev[:, row]
        if ref is not None:
            err = float((ev.float() - ref.float()).abs().max())
            out["library_max_abs_err"] = err
            out["library_agrees"] = err <= 2.0 ** -6 * float(ref.float().abs().max())
        del ev
    m.train(train)
    if backward:
        xg = xp.detach().requires_grad_()

        def fwd_bwd():
            m.zero_grad(set_to_none=True)
            xg.grad = None
            m(xg, src_mask=mask).backward(dy)
        out["library_ms"] = cuda_ms(fwd_bwd, iters=5, warmup=2)
    else:
        with torch.no_grad():
            out["library_ms"] = cuda_ms(lambda: m(xp, src_mask=mask), iters=10)
    out["library"] = ("nn.TransformerEncoderLayer(batch_first, post-LN, F.silu, "
                      + ("train, dropout 0.1" if train else "eval") + ")"
                      + (", forward + backward" if backward else "")
                      + (f", row {row} of its output" if row is not None else ""))
    return out


def lastq_yardstick(torch, xp, mp, flat, fargs):
    """Row 3's library call: nn.TransformerEncoderLayer on the same inputs and
    weights (wq|wk|wv as one in-projection) under the key-pad mask alone, so
    that row qi of its output is the last-query layer's (it computes every
    other row as well). Its agreement is held on row qi, in eval mode, with
    the plain version without dropout."""
    from unirec_tpu_torch.ops import layer as LY
    qi, nh, act, eps = fargs[:4]
    drop = fargs[4] if len(fargs) > 4 else LY.NO_DROP
    wq, bq, wk, bk, wv, bv, *rest = flat
    lflat = (torch.cat([wq, wk, wv], 1), torch.cat([bq, bk, bv]), *rest)
    ref = LY._lastq_fwd_plain(xp, mp, flat, qi, nh, act, eps)
    return encoder_layer_yardstick(torch, xp, mp, lflat, ref, nh, act, eps, False, drop, row=qi)


def kernel_lastq(torch, dtype_name, act="swish", timed=True):
    from unirec_tpu_torch.ops import layer as LY
    dt = getattr(torch, dtype_name)
    xp, mp, params = layer_inputs(torch, dt, seed=SEED + 1)
    flat = LY._lastq_weights(params, dt)
    args = (SEQ_LEN - 1, 2, act, 1e-10)
    y = LY._lastq_fwd_cuda(xp, mp, flat, *args)
    ref = LY._lastq_fwd_plain(xp, mp, flat, *args)
    torch.cuda.synchronize()
    err = float((y.float() - ref.float()).abs().max())
    tol = LN_TOL[dtype_name]
    line = {"phase": "kernel", "name": "lastq_fwd", "act": act,
            "shape": list(xp.shape), "q_index": SEQ_LEN - 1, "dtype": dtype_name,
            "max_abs_err": err, "tol": tol, "finite": bool(torch.isfinite(y).all())}
    if timed:
        B, Lp, D = xp.shape
        F = flat[10].shape[1]
        flops = 2 * B * (Lp * 2 * D * D + 2 * D * D + 2 * D * F) + 4 * B * Lp * D
        line["kernel_ms"] = cuda_ms(lambda: LY._lastq_fwd_cuda(xp, mp, flat, *args))
        line["plain_ms"] = cuda_ms(lambda: LY._lastq_fwd_plain(xp, mp, flat, *args))
        line["library_ms"] = None
        line["bound_ms"], line["bound_by"] = bound_ms(nbytes(xp, mp, *flat, y), flops,
                                                      dtype_name)
    ok = True
    if timed and dtype_name == "bfloat16":   # no gate at the serving batch
        line.update(lastq_yardstick(torch, xp, mp, flat, args))
        ok, _ = fwd_bodies(torch, "lastq", line, xp, mp, flat, args, ref, gate=None)
        ok = ok and line["library_agrees"]
    emit(line)
    if not (err <= tol and line["finite"] and ok):
        raise AssertionError(f"lastq_fwd disagrees with its plain version: {line}")
    return line


def catalog(torch, n_items, dtype_name, seed):
    """Users [256, 64] at LN scale and items [N, 64] at the model's scale."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(BATCH, EMB, generator=g, device="cuda").to(getattr(torch, dtype_name))
    it = (torch.randn(n_items, EMB, generator=g, device="cuda") * 0.05)
    return u, it.to(getattr(torch, dtype_name))


def kernel_blockmax(torch, n_items, dtype_name, int8=False):
    from unirec_tpu_torch.ops import topk as TK
    u, it = catalog(torch, n_items, dtype_name, SEED + 2)
    scale = None
    if int8:
        it, scale = TK.quantize_catalog(it)
    bm = TK._blockmax_cuda(u, it, scale)
    ref = TK._blockmax_plain(u, it, scale)
    torch.cuda.synchronize()
    err = float((bm - ref).abs().max())
    tol = 1e-3 * float(ref.abs().max())
    name = "blockmax_int8" if int8 else "blockmax"
    B, D = u.shape
    flops = 2 * B * n_items * D
    if int8:
        lib = lambda: ((u @ it.to(u.dtype).T).float() * scale).view(B, -1, 16).amax(-1)  # noqa: E731
        peak = "bfloat16"  # int8 items enter the products as bf16
    else:
        lib = lambda: (u @ it.T).view(B, -1, 16).amax(-1)  # noqa: E731
        peak = dtype_name
    line = {"phase": "kernel", "name": name, "users": B, "items": n_items, "dim": D,
            "dtype": dtype_name, "item_dtype": str(it.dtype).replace("torch.", ""),
            "max_abs_err": err, "tol": tol,
            "kernel_ms": cuda_ms(lambda: TK._blockmax_cuda(u, it, scale)),
            "plain_ms": cuda_ms(lambda: TK._blockmax_plain(u, it, scale)),
            "library_ms": cuda_ms(lib)}
    line["bound_ms"], line["bound_by"] = bound_ms(
        nbytes(u, it, bm, *([scale] if int8 else [])), flops, peak)
    emit(line)
    if not err <= tol:
        raise AssertionError(f"{name} disagrees with its plain version: {line}")
    return line


def topk_agrees(ids, ref_scores, k, tol):
    """(every row valid, rows with the same id set): ids [B, k] agree with
    ref_scores [B, N] (banned entries -inf) when they are distinct, none is
    banned, and each scores within ``tol`` of the reference's k-th best."""
    import torch
    kth = torch.topk(ref_scores, k).values[:, -1:]
    got = ref_scores.gather(1, ids)
    srt = ids.sort(dim=1).values
    distinct = bool((srt[:, 1:] != srt[:, :-1]).all())
    valid = distinct and bool(torch.isfinite(got).all()) and bool((got >= kth - tol).all())
    ref_ids = torch.topk(ref_scores, k).indices.sort(dim=1).values
    same = int((ref_ids == srt).all(dim=1).sum())
    return valid, same


def kernel_fused_topk(torch):
    """fused_catalog_topk (blockmax kernel + re-scoring) against the dense
    plain top-k of the same f32 scores, with history exclusion."""
    from unirec_tpu_torch.ops import topk as TK
    u, it = catalog(torch, N_ITEMS, "bfloat16", SEED + 3)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    hist = torch.randint(1, N_ITEMS, (BATCH, HIST_CAP), generator=g, device="cuda")
    hlen = torch.randint(10, HIST_CAP, (BATCH,), generator=g, device="cuda")
    _, ids = TK.fused_catalog_topk(u, it, TOPK, hist_items=hist, hist_len=hlen,
                                   exclude_pad_item=True)
    ref = u.float() @ it.float().T
    banned = torch.where(torch.arange(HIST_CAP, device="cuda")[None] < hlen[:, None],
                         hist, 0)
    ref = ref.scatter(1, banned, float("-inf"))
    tol = 1e-3 * float(ref[torch.isfinite(ref)].abs().max())
    valid, same = topk_agrees(ids, ref, TOPK, tol)
    line = {"phase": "kernel", "name": "fused_catalog_topk", "users": BATCH,
            "items": N_ITEMS, "k": TOPK, "hist_cap": HIST_CAP, "tol": tol,
            "rows_valid": valid, "rows_identical": same}
    emit(line)
    if not valid:
        raise AssertionError(f"fused top-k disagrees with the dense plain top-k: {line}")


# ---------------------------------------------------------------- main path
def synthetic_history(rng=None):
    """bench.py's recipe: 100,000 users with 10..200 random items each."""
    from unirec_tpu_torch.data.history import UserHistory
    rng = np.random.default_rng(SEED) if rng is None else rng
    lens = rng.integers(10, HIST_CAP, size=N_USERS).astype(np.int32)
    items = np.zeros((N_USERS, HIST_CAP), np.int32)
    mask = np.arange(HIST_CAP)[None, :] < lens[:, None]
    items[mask] = rng.integers(1, N_ITEMS, size=int(mask.sum()))
    return UserHistory(items, lens)


def write_checkpoint(torch, path: Path):
    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint
    from unirec_tpu_torch.utils.flax_bridge import to_flax_params
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = config_mod.parse_arguments({
        "model": "SASRec", "n_users": N_USERS, "n_items": N_ITEMS,
        "max_seq_len": SEQ_LEN, "embedding_size": EMB, "hidden_size": EMB,
        "inner_size": 2 * EMB, "n_layers": 2, "n_heads": 2,
        "dataloader": "SeqRecDataset", "compute_dtype": "bfloat16",
        "last_query_only": 1, "fused_layer": 1, "fused_lastq": 1,
        "test_batch_size": BATCH}, device="cuda")
    model = get_model_class("SASRec")(cfg)
    model.init_weights(torch.Generator().manual_seed(SEED))
    save_checkpoint(str(path), {"config": cfg, "params": to_flax_params(model)})


@contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain version (on the card)."""
    from unirec_tpu_torch.ops import attention as AT, ffn as FF, layer as LY, \
        member as MB, scatter_accum as SA, topk as TK
    with mock.patch.object(AT, "_fwd_cuda", AT._fwd_plain), \
            mock.patch.object(AT, "_bwd_cuda", AT._bwd_plain), \
            mock.patch.object(AT, "_flash_fwd_cuda", AT._flash_fwd_plain), \
            mock.patch.object(FF, "_fwd_cuda", FF._fwd_plain), \
            mock.patch.object(FF, "_bwd_cuda", FF._bwd_plain), \
            mock.patch.object(LY, "_layer_fwd_cuda", LY._layer_fwd_plain), \
            mock.patch.object(LY, "_lastq_fwd_cuda", LY._lastq_fwd_plain), \
            mock.patch.object(LY, "_layer_bwd_cuda", LY._layer_bwd_plain), \
            mock.patch.object(LY, "_lastq_bwd_cuda", LY._lastq_bwd_plain), \
            mock.patch.object(SA, "_scatter_cuda", SA._scatter_plain), \
            mock.patch.object(MB, "_member_cuda", MB._member_plain), \
            mock.patch.object(TK, "_blockmax_cuda", TK._blockmax_plain):
        yield


def _counters():
    from unirec_tpu_torch.ops import attention as AT, ffn as FF, layer as LY, \
        member as MB, scatter_accum as SA, topk as TK
    return {"flash_attention": (AT.flash_attention, "launches"),
            "fused_attention": (AT.fused_attention, "launches"),
            "fused_attention_mma": (AT.fused_attention, "launches_mma"),
            "fused_attention_bwd": (AT.fused_attention_bwd, "launches"),
            "fused_attention_bwd_mma": (AT.fused_attention_bwd, "launches_mma"),
            "fused_ffn": (FF.fused_ffn, "launches"),
            "fused_ffn_mma": (FF.fused_ffn, "launches_mma"),
            "fused_ffn_bwd": (FF.fused_ffn_bwd, "launches"),
            "fused_ffn_bwd_mma": (FF.fused_ffn_bwd, "launches_mma"),
            "layer_fwd": (LY.fused_transformer_layer, "launches"),
            "layer_fwd_mma": (LY.fused_transformer_layer, "launches_mma"),
            "lastq_fwd": (LY.fused_last_query_layer, "launches"),
            "lastq_fwd_mma": (LY.fused_last_query_layer, "launches_mma"),
            "blockmax": (TK.catalog_blockmax, "launches"),
            "blockmax_int8": (TK.catalog_blockmax, "launches_int8"),
            "layer_bwd": (LY.layer_bwd, "launches"),
            "layer_bwd_mma": (LY.layer_bwd, "launches_mma"),
            "lastq_bwd": (LY.lastq_bwd, "launches"),
            "lastq_bwd_mma": (LY.lastq_bwd, "launches_mma"),
            "scatter_add": (SA.scatter_add_rows, "launches"),
            "scatter_add_sorted": (SA.scatter_add_rows, "launches_sorted"),
            "member": (MB.member_mask, "launches")}


# *_mma: the bf16 tensor-core bodies of rows 1-4; scatter_add_sorted: row 6's
# sorted-tile body
SERVING_KERNELS = ("layer_fwd", "layer_fwd_mma", "lastq_fwd", "lastq_fwd_mma", "blockmax",
                   "blockmax_int8")
TRAINING_KERNELS = ("layer_fwd", "layer_fwd_mma", "lastq_fwd", "lastq_fwd_mma", "layer_bwd",
                    "layer_bwd_mma", "lastq_bwd", "lastq_bwd_mma", "scatter_add",
                    "scatter_add_sorted", "member")
# *_mma: the bf16 tensor-core bodies of rows 10, 11 (L <= 64) and 12, 13 (D <= 64)
ENTRY_KERNELS = ("fused_attention", "fused_attention_mma", "fused_attention_bwd",
                 "fused_attention_bwd_mma", "fused_ffn", "fused_ffn_mma", "fused_ffn_bwd",
                 "fused_ffn_bwd_mma", "scatter_add", "scatter_add_sorted", "member")
LONG_KERNELS = ("flash_attention", "fused_ffn", "fused_ffn_mma", "fused_ffn_bwd",
                "fused_ffn_bwd_mma", "scatter_add", "scatter_add_sorted", "member")
OFF_LONG_PATH = ("layer_fwd", "layer_bwd", "lastq_fwd", "lastq_bwd", "fused_attention",
                 "fused_attention_bwd")


def launch_counts(names):
    return {n: getattr(*_counters()[n]) for n in names}


def reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def main_path(torch, card: str):
    from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
    from unirec_tpu_torch.utils.checkpoint import load_model_freely

    history = synthetic_history()
    ckpt = ROOT / "build" / "chip_smoke" / "sasrec_bench.pkl"
    write_checkpoint(torch, ckpt)
    model, cfg = load_model_freely(str(ckpt), "cuda")
    users = np.arange(1, SERVE_USERS + 1, dtype=np.int64)
    modes = {"bf16": dict(cfg), "int8": dict(cfg, catalog_int8=1)}

    for c in modes.values():  # warm-up (cuBLAS handles, caching allocator)
        get_topk_recommendations(c, model, users[:BATCH], history, TOPK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results, seconds = {}, {}
    for name, c in modes.items():
        t0 = time.perf_counter()
        results[name] = get_topk_recommendations(c, model, users, history, TOPK)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    counts = launch_counts(SERVING_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-SERVE_USERS // BATCH)
    for name in modes:
        emit({"phase": "main_path", "catalog": name, "users": SERVE_USERS,
              "items": N_ITEMS, "topk": TOPK, "batch": BATCH,
              "users_per_s": SERVE_USERS / seconds[name],
              "ms_per_batch": seconds[name] * 1e3 / n_batches,
              "peak_mem_bytes": peak, "card": card})
    emit({"phase": "main_path_launches", **counts})
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}: {counts}")

    # correctness: shape/range/history, and agreement with the plain versions
    with torch.no_grad():
        check_main_path(torch, model, cfg, users, history, modes, results)
    profile_main_path(torch, model, modes["bf16"], users, history, card)
    return counts


def check_main_path(torch, model, cfg, users, history, modes, results,
                    phase="main_path_check"):
    from unirec_tpu_torch.main.infer_embedding import iter_infer_batches
    from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
    from unirec_tpu_torch.ops import topk as TK
    from unirec_tpu_torch.utils import to_device
    with plain_versions():
        plain = {n: get_topk_recommendations(c, model, users, history, TOPK)
                 for n, c in modes.items()}
    item_emb = model.all_item_emb()
    q_items, q_scale = TK.quantize_catalog(item_emb)
    catalogs = {"bf16": item_emb.float(), "int8": q_items.float() * q_scale[:, None]}
    catalogs = {n: c for n, c in catalogs.items() if n in modes}
    du, du_tol, checks = 0.0, 0.0, {n: {"valid": True, "identical_rows": 0,
                           "identical_to_plain_run": 0} for n in modes}
    for start, batch in zip(range(0, len(users), BATCH),
                            iter_infer_batches(cfg, users, history, True)):
        n = batch.pop("n_real")
        tb = to_device(batch, "cuda", torch.int64)
        u_k = model.user_emb(tb)[:n].float()
        with plain_versions():
            u_p = model.user_emb(tb)[:n].float()
        du = max(du, float((u_k - u_p).abs().max()))
        du_tol = max(du_tol, emb_tol(u_p))
        hist, hlen = history.gather(batch["user_id"][:n])
        h = torch.from_numpy(np.where(np.arange(hist.shape[1])[None] < hlen[:, None],
                                      hist, 0).astype(np.int64)).cuda()
        for name, items in catalogs.items():
            ids = torch.from_numpy(results[name][start:start + n]).cuda()
            if ids.shape != (n, TOPK) or int(ids.min()) < 1 or int(ids.max()) >= N_ITEMS:
                raise AssertionError(f"{name}: ids out of shape or range")
            # the score error a user-embedding difference du can cause
            tol = 2 * max(du, 1e-6) * float(items.abs().sum(1).max())
            ref = (u_p @ items.T).scatter(1, h, float("-inf"))
            ref[:, 0] = float("-inf")
            valid, same = topk_agrees(ids, ref, TOPK, tol)
            pl = torch.from_numpy(plain[name][start:start + n]).cuda()
            checks[name]["valid"] &= valid
            checks[name]["identical_rows"] += same
            checks[name]["identical_to_plain_run"] += int(
                (pl.sort(1).values == ids.sort(1).values).all(1).sum())
    emit({"phase": phase, "user_emb_max_abs_diff": du,
          "user_emb_tol": du_tol, **checks})
    if du > du_tol or not all(c["valid"] for c in checks.values()):
        raise AssertionError("main path disagrees with the plain versions")


def profile_main_path(torch, model, cfg, users, history, card):
    """One traced serving run (bf16 catalog, 1024 users): device busy time
    against wall time, and the operations that hold the device longest."""
    from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
    n = 4 * BATCH
    emit({"phase": "main_path_profile", "users": n,
          **device_profile(torch, lambda: get_topk_recommendations(
              cfg, model, users[:n], history, TOPK)), "card": card})


# ------------------------------------------------------- training kernels
def layer_flops(B, Lp, D, F):
    """Forward products of one whole layer (qkv, out-proj, FFN, scores, PV)."""
    return 2 * B * Lp * (3 * D * D + D * D + 2 * D * F) + 4 * B * Lp * Lp * D


def lastq_flops(B, Lp, D, F):
    return 2 * B * (Lp * 2 * D * D + 2 * D * D + 2 * D * F) + 4 * B * Lp * D


def leaf_errs(gots, refs, zero_sum=None):
    """(errors, zero-sum report). Each output's error is its largest
    difference over its own reference's largest magnitude, except for the
    outputs in ``zero_sum``: a key bias's gradient is zero in exact
    arithmetic (softmax ignores a shift shared by a row's scores) and holds
    only rounding noise, so ``zero_sum`` maps it to the output whose scale it
    takes instead, the same layer's query bias (the same sums of the score
    gradients, with keys in place of queries, which do not cancel). The
    report gives, for each such output, both largest magnitudes and the
    scale, so the vanishing reference can be read."""
    zero_sum = zero_sum or {}
    diff = [float((g.float() - r.float()).abs().max()) for g, r in zip(gots, refs)]
    peak = [float(r.float().abs().max()) for r in refs]
    errs = [d / max(peak[zero_sum.get(i, i)], 1e-30) for i, d in enumerate(diff)]
    report = {i: {"ref_max": peak[i], "kernel_max": float(gots[i].float().abs().max()),
                  "scale": peak[j], "err": errs[i]} for i, j in zero_sum.items()}
    return errs, report


def zero_sum_ok(report) -> bool:
    """The outputs taken as zero in exact arithmetic really are, against
    their scale, in the plain version."""
    return all(r["ref_max"] <= BWD_TOL * r["scale"] for r in report.values())


def kernel_train_layers(torch):
    """Both forward kernels with dropout 0.1 and both backward kernels at the
    training shapes (bf16), each against its plain version with the same
    dropout seed. The backward's least work recomputes the forward from x:
    one forward's products plus two for the gradients."""
    from unirec_tpu_torch.ops import layer as LY
    dt, name = torch.bfloat16, "bfloat16"
    drop = LY.drop_params(P_DROP, P_DROP, True, 12345)
    xp, mp, params = layer_inputs(torch, dt, B=TRAIN_BATCH, seed=SEED + 10)
    B, Lp, D = xp.shape
    F = 2 * EMB
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = {}
    for which in ("layer", "lastq"):
        if which == "layer":
            flat = LY._layer_weights(params, dt)
            fargs = (2, "swish", 1e-10, True, drop)
            fwd_k, fwd_p = LY._layer_fwd_cuda, LY._layer_fwd_plain
            bwd_k, bwd_p = LY._layer_bwd_cuda, LY._layer_bwd_plain
            flops = layer_flops(B, Lp, D, F)
            dy = torch.randn(xp.shape, generator=g, device="cuda").to(dt)
            zero_sum = {}  # the key bias is a third of bqkv, held with it
        else:
            flat = LY._lastq_weights(params, dt)
            fargs = (SEQ_LEN - 1, 2, "swish", 1e-10, drop)
            fwd_k, fwd_p = LY._lastq_fwd_cuda, LY._lastq_fwd_plain
            bwd_k, bwd_p = LY._lastq_bwd_cuda, LY._lastq_bwd_plain
            flops = lastq_flops(B, Lp, D, F)
            dy = torch.randn(B, D, generator=g, device="cuda").to(dt)
            zero_sum = {4: 2}  # (dx, dwq, dbq, dwk, dbk, ...): dbk takes dbq's scale
        y = fwd_k(xp, mp, flat, *fargs)
        ref = fwd_p(xp, mp, flat, *fargs)
        torch.cuda.synchronize()
        line = {"phase": "kernel", "name": f"{which}_fwd", "mode": "train",
                "p_drop": P_DROP, "shape": list(xp.shape), "dtype": name,
                "max_abs_err": float((y.float() - ref.float()).abs().max()),
                # over 10^8 outputs some bf16 rounding flips; it moves an output
                # by one ulp, at most 2^-7 of its magnitude
                "tol": max(LN_TOL[name], 2.0 ** -6 * float(ref.float().abs().max())),
                "tol_reason": "two bf16 ulps of the largest LN output",
                "finite": bool(torch.isfinite(y).all()),
                "kernel_ms": cuda_ms(lambda: fwd_k(xp, mp, flat, *fargs)),
                "plain_ms": cuda_ms(lambda: fwd_p(xp, mp, flat, *fargs), iters=3, warmup=1),
                "library_ms": None}
        line["bound_ms"], line["bound_by"] = bound_ms(nbytes(xp, mp, *flat, y), flops, name)
        ok_fwd = True
        if which == "layer":
            line.update(encoder_layer_yardstick(torch, xp, mp, flat, None, *fargs))
            ok_fwd, rows["layer_fwd_train_cuda_core"] = fwd_bodies(
                torch, "layer", line, xp, mp, flat, fargs, ref)
        else:   # the training batch: the tensor-core body at least 3x its CUDA-core one
            line.update(lastq_yardstick(torch, xp, mp, flat, fargs))
            ok_fwd, rows["lastq_fwd_train_cuda_core"] = fwd_bodies(
                torch, "lastq", line, xp, mp, flat, fargs, ref)
            ok_fwd = ok_fwd and line["library_agrees"]
        emit(line)
        if not (line["max_abs_err"] <= line["tol"] and line["finite"] and ok_fwd):
            raise AssertionError(f"{which}_fwd (train) disagrees with its plain version")
        rows[f"{which}_fwd_train"] = line
        del y, ref
        dx, grads = bwd_k(xp, mp, flat, dy, *fargs)
        rdx, rgrads = bwd_p(xp, mp, flat, dy, *fargs)
        torch.cuda.synchronize()
        errs, zeros = leaf_errs((dx, *grads), (rdx, *rgrads), zero_sum)
        line = {"phase": "kernel", "name": f"{which}_bwd", "p_drop": P_DROP,
                "shape": list(xp.shape), "dtype": name,
                "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                   for a, b in zip((dx, *grads), (rdx, *rgrads))),
                "max_rel_err": max(errs), "rel_errs": errs, "rel_err_dx": errs[0],
                "dx_ref_max": float(rdx.float().abs().max()),
                "key_bias_grad": zeros.get(4), "tol": BWD_TOL,
                "tol_reason": "each output relative to its own largest value (the key "
                              "bias, zero in exact arithmetic, to the query bias's); "
                              "bf16 roundings at the same points, f32 sums in "
                              "another order",
                "finite": bool(torch.isfinite(dx).all()),
                "kernel_ms": cuda_ms(lambda: bwd_k(xp, mp, flat, dy, *fargs), iters=5),
                "plain_ms": cuda_ms(lambda: bwd_p(xp, mp, flat, dy, *fargs), iters=2,
                                    warmup=1),
                "library_ms": None}
        line["bound_ms"], line["bound_by"] = bound_ms(
            nbytes(xp, mp, *flat, dy, dx, *grads), 3 * flops, name)
        if which == "layer":
            line.update(encoder_layer_yardstick(torch, xp, mp, flat, None, *fargs,
                                                backward=True, dy=dy))
        ok_extra, rows[f"{which}_bwd_cuda_core"] = bwd_bodies(
            torch, which, line, xp, mp, flat, dy, fargs, dx, grads, rdx, rgrads)
        emit(line)
        if not (line["max_rel_err"] <= BWD_TOL and line["finite"] and zero_sum_ok(zeros)
                and ok_extra):
            raise AssertionError(f"{which}_bwd disagrees with its plain version")
        rows[f"{which}_bwd"] = line
        del dx, grads, rdx, rgrads
    return rows


def bwd_bodies(torch, which, line, xp, mp, flat, dy, fargs, dx, grads, rdx, rgrads):
    """Rows 2 ("layer") and 4 ("lastq"): the checks beyond the common ones,
    into the kernel line: which body ran; for row 2 the key bias's gradient
    (a slice of dbqkv, zero in exact arithmetic) against the query bias's
    scale (row 4's is a leaf of its own, held so in the common check); the
    masks (the plain version with another seed must disagree far beyond the
    tolerance, so the kernel drew the forward's masks); and the CUDA-core
    body on the same inputs, against the plain version and timed in this
    run in turns with it, which the tensor-core body must beat fivefold (row
    2) or threefold (row 4). Returns (ok, the CUDA-core body's row)."""
    from unirec_tpu_torch.ops import layer as LY
    _, Lp, D = xp.shape
    layer = which == "layer"
    body_of = "_layer_bwd_body" if layer else "_lastq_bwd_body"
    kernel, plain = ((LY._layer_bwd_cuda, LY._layer_bwd_plain) if layer
                     else (LY._lastq_bwd_cuda, LY._lastq_bwd_plain))
    nh, F = (fargs[0], flat[6].shape[1]) if layer else (fargs[1], flat[10].shape[1])
    line["body"] = getattr(LY, body_of)(xp.dtype, Lp, D, F, nh)
    ok = True
    if layer:
        dbk, rdbk, rdbq = (t.float() for t in (grads[1][D:2 * D], rgrads[1][D:2 * D],
                                                rgrads[1][:D]))
        scale = float(rdbq.abs().max())
        kb = line["key_bias_grad"] = {
            "ref_max": float(rdbk.abs().max()), "kernel_max": float(dbk.abs().max()),
            "scale": scale, "err": float((dbk - rdbk).abs().max()) / max(scale, 1e-30)}
        ok = kb["ref_max"] <= BWD_TOL * scale and kb["err"] <= BWD_TOL
    other = plain(xp, mp, flat, dy, *fargs[:-1], LY.drop_params(P_DROP, P_DROP, True, 12346))[0]
    peak = float(rdx.float().abs().max())
    line["other_seed_rel_err_dx"] = float((dx.float() - other.float()).abs().max()) / peak
    del other
    with mock.patch.object(LY, body_of, lambda *a: "cuda"):
        cdx, cgrads = kernel(xp, mp, flat, dy, *fargs)
    cerrs, _ = leaf_errs((cdx, *cgrads), (rdx, *rgrads), {} if layer else {4: 2})
    core = {"body": "cuda", "max_rel_err": max(cerrs),
            "max_abs_err": max(float((a.float() - b.float()).abs().max())
                               for a, b in zip((cdx, *cgrads), (rdx, *rgrads))),
            "kernel_ms": bodies_in_turns(line, body_of,
                                         lambda: kernel(xp, mp, flat, dy, *fargs), 5),
            **{k: line[k] for k in ("plain_ms", "bound_ms", "bound_by", "library_ms")}}
    del cdx, cgrads
    line["cuda_core"] = {k: core[k] for k in ("max_rel_err", "kernel_ms")}
    line["cuda_core_over_mma"] = core["kernel_ms"] / line["kernel_ms"]
    ok = (ok and line["body"] == "mma" and line["other_seed_rel_err_dx"] > 4 * BWD_TOL
          and core["max_rel_err"] <= BWD_TOL
          and (5 if layer else 3) * line["kernel_ms"] <= core["kernel_ms"])
    return ok, core


def scatter_line(torch, ids, rows, what, gate=None):
    """One line of row 6: the sorted-tile body against the plain version and
    timed in turns with the per-row body (which must agree as well), the plain
    version and index_add_ (the library call) beside them, and the ids' share
    of id 0 and largest multiplicity. Both bodies are held to the plain
    version on the table's largest element and element by element
    (``scatter_elementwise``). With ``gate`` the sorted body must beat the
    per-row one that many times."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    M = ids.shape[0]
    acc = SA._scatter_cuda(ids, rows, N_ITEMS)
    ref = SA._scatter_plain(ids, rows, N_ITEMS)
    with mock.patch.object(SA, "_scatter_body", lambda *a: "per_row"):
        old = SA._scatter_cuda(ids, rows, N_ITEMS)
    lib_ids = ids.long()
    lib = lambda: torch.zeros(N_ITEMS, EMB, device="cuda").index_add_(  # noqa: E731
        0, lib_ids, rows.float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    err = float((acc.float() - ref.float()).abs().max())
    tol = 8e-3 * float(ref.float().abs().max())
    valid = lib_ids[(lib_ids >= 0) & (lib_ids < N_ITEMS)]
    line = {"phase": "kernel", "name": "scatter_add", "ids": what, "rows": M,
            "table": [N_ITEMS, EMB], "dtype": "bfloat16",
            "id0_share": float((ids == 0).float().mean()),
            "max_id_multiplicity": int(torch.bincount(valid, minlength=N_ITEMS).max()),
            "body": SA._scatter_body(rows.dtype, rows.shape[1], N_ITEMS),
            "max_abs_err": err, "tol": tol,
            "tol_reason": "f32 atomics in run-dependent order, one bf16 rounding "
                          "of the sum (2^-7 relative, doubled)",
            "plain_ms": cuda_ms(lambda: SA._scatter_plain(ids, rows, N_ITEMS)),
            "library_ms": cuda_ms(lib)}
    line["bound_ms"], line["bound_by"] = bound_ms(nbytes(ids, rows, acc), M * EMB, "float32")
    per_row = bodies_in_turns(line, "_scatter_body", lambda: SA._scatter_cuda(ids, rows, N_ITEMS),
                              20, module=SA, other="per_row", other_iters=5)
    line["per_row"] = {"max_abs_err": float((old.float() - ref.float()).abs().max()),
                       "kernel_ms": per_row}
    line["per_row_over_sorted"] = per_row / line["kernel_ms"]
    line["elementwise_worst"], line["per_row"]["elementwise_worst"] = scatter_elementwise(
        torch, (acc, old), ids, rows)
    line["gate"] = gate
    emit(line)
    if not (err <= tol and line["per_row"]["max_abs_err"] <= tol and line["body"] == "sorted"
            and line["elementwise_worst"] <= 1.0
            and line["per_row"]["elementwise_worst"] <= 1.0
            and (gate is None or gate * line["kernel_ms"] <= per_row)):
        raise AssertionError(f"scatter_add ({what}) failed its checks: {line}")
    return line


def scatter_elementwise(torch, outs, ids, rows):
    """Each output against the plain version element by element, as the card
    tests hold it: 1e-4 of the largest gradient element, plus 2e-5 of the sum
    of the magnitudes added into the element (f32 sums in another order),
    plus one bf16 rounding of the sum (2^-7 of it). Returns, for each output,
    the worst element's error over its tolerance (at most 1 to pass)."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    ref = SA._scatter_plain(ids, rows, N_ITEMS).float()
    mag = SA._scatter_plain(ids, rows.float().abs(), N_ITEMS)
    tol = 1e-4 * float(rows.float().abs().max()) + 2e-5 * mag + 2.0 ** -7 * ref.abs()
    return [float(((o.float() - ref).abs() / tol).max()) for o in outs]


def kernel_scatter(torch):
    """The embedding-grad scatter-add on uniform ids at the training and entry
    step's two shapes, the item_seq gather's [B*L, 64] and the candidates'
    [B*10, 64] bf16 gradient rows into [50,000, 64], then at the long path's
    (batch 8,192 at L=256: 2,097,152 and 81,920 rows); last, at the first
    shape, ids 80% of which are 0 under gradient rows that are not zero, so
    that the sum on a hot id is held too (the paths send zero rows to id 0)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for M in (TRAIN_BATCH * SEQ_LEN, TRAIN_BATCH * (1 + N_NEG), LONG_BATCH * LONG_LEN,
              LONG_BATCH * (1 + N_NEG)):
        ids = torch.randint(0, N_ITEMS, (M,), generator=g, device="cuda", dtype=torch.int32)
        rows = (torch.randn(M, EMB, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
        scatter_line(torch, ids, rows, "uniform")
    M = TRAIN_BATCH * SEQ_LEN
    ids = torch.randint(1, N_ITEMS, (M,), generator=g, device="cuda", dtype=torch.int32)
    ids = torch.where(torch.rand(M, generator=g, device="cuda") < 0.8, 0, ids)
    rows = (torch.randn(M, EMB, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    scatter_line(torch, ids, rows, "80% id 0")


@contextmanager
def scatter_capture(store):
    """Record the ids and gradient rows of every scatter-add the kernels
    launch inside (not the plain versions' calls)."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    real = SA._scatter_cuda

    def spy(ids, g, n_rows):
        store.append((ids.detach().clone(), g.detach().clone()))
        return real(ids, g, n_rows)
    with mock.patch.object(SA, "_scatter_cuda", spy):
        yield


def kernel_scatter_path(torch, path, store):
    """Row 6 on the ids and gradient rows one real training batch of a path
    scatters (captured in its *_check step): the item_seq gather's (gate: the
    sorted body 3x the per-row one) and the candidates'."""
    calls = sorted(store, key=lambda c: -c[0].numel())
    if len(calls) != 2:
        raise AssertionError(f"{path}: a step scattered {len(calls)} times, not 2")
    return {what: scatter_line(torch, ids.to(torch.int32), g, f"{path} {what}",
                               gate=3 if what == "item_seq" else None)
            for (ids, g), what in zip(calls, ("item_seq", "candidates"))}


def kernel_member(torch):
    """Negative-rejection membership at bench shapes: [B, 200] histories,
    [B, 36] candidates (9 negatives x oversample 4); exact."""
    from unirec_tpu_torch.ops import member as MB
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows = torch.randint(0, N_ITEMS, (TRAIN_BATCH, HIST_CAP), generator=g,
                         device="cuda", dtype=torch.int32)
    cand = torch.randint(1, N_ITEMS, (TRAIN_BATCH, 4 * N_NEG), generator=g,
                         device="cuda", dtype=torch.int32)
    cand[:, ::3] = rows[:, :12]  # a third of the candidates are in the history
    out = MB._member_cuda(rows, cand)
    ref = MB._member_plain(rows, cand)
    torch.cuda.synchronize()
    line = {"phase": "kernel", "name": "member", "rows": list(rows.shape),
            "cand": list(cand.shape), "mismatches": int((out != ref).sum()),
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            "tol": 0.0, "tol_reason": "exact", "hits": int(out.sum()),
            "kernel_ms": cuda_ms(lambda: MB._member_cuda(rows, cand)),
            "plain_ms": cuda_ms(lambda: MB._member_plain(rows, cand)),
            "library_ms": None}
    # compares counted at the f32 CUDA-core rate
    line["bound_ms"], line["bound_by"] = bound_ms(
        nbytes(rows, cand, out), rows.numel() * cand.shape[1], "float32")
    emit(line)
    if line["mismatches"]:
        raise AssertionError("member disagrees with its plain version")
    return line


# ------------------------------------------------------------ training path
def train_config(torch):
    """bench.py's configuration, with neg_membership_pallas on."""
    from unirec_tpu_torch import config as config_mod
    return config_mod.parse_arguments({
        "model": "SASRec", "n_users": N_USERS, "n_items": N_ITEMS,
        "max_seq_len": SEQ_LEN, "embedding_size": EMB, "hidden_size": EMB,
        "inner_size": 2 * EMB, "n_layers": 2, "n_heads": 2, "loss_type": "bce",
        "hidden_dropout_prob": P_DROP, "attn_dropout_prob": P_DROP,
        "learning_rate": 1e-3, "group_size": -1, "n_sample_neg_train": N_NEG,
        "dataloader": "SeqRecDataset", "history_mask_mode": "autoregressive",
        "compute_dtype": "bfloat16", "dropout_bits": 8, "last_query_only": 1,
        "fused_layer": 1, "fused_lastq": 1, "vmem_embedding_grad": 1,
        "neg_membership_pallas": 1, "epochs": 1, "seed": SEED,
        "output_path": str(ROOT / "build" / "chip_smoke"), "exp_name": "train"},
        argv=[], device="cuda")


def train_setup(torch):
    """bench.py's data (seed 0): the history, then raw (user, item) pairs."""
    from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter, RawIdBatcher
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.utils.registry import get_model_class
    rng = np.random.default_rng(SEED)
    history = synthetic_history(rng)
    cfg = train_config(torch)
    n_rows = TRAIN_BATCH * (WARMUP_STEPS + TIMED_STEPS)
    raw = RawIdBatcher(rng.integers(1, N_USERS, size=n_rows),
                       rng.integers(1, N_ITEMS, size=n_rows), TRAIN_BATCH, shuffle=False)
    trainer = Trainer(cfg, get_model_class("SASRec")(cfg), device="cuda")
    aug = DeviceAugmenter(cfg, history, device="cuda")
    trainer.set_device_augmenter(aug)
    return trainer, raw, aug


def train_path(torch, card: str):
    """Trainer.fit over 27 batches; the clock starts on a sync before step 4
    and stops when fit has fetched the epoch's losses."""
    trainer, raw, aug = train_setup(torch)
    step, losses, marks = trainer.train_step, [], {}

    def timed_step(batch):
        if len(losses) == WARMUP_STEPS:
            torch.cuda.synchronize()
            marks["t0"] = time.perf_counter()
        losses.append(step(batch))
        return losses[-1]

    trainer.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer.fit(raw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - marks["t0"]
    counts = launch_counts(TRAINING_KERNELS)
    loss = torch.stack(losses).float().cpu().numpy()
    line = {"phase": "train_path", "batch": TRAIN_BATCH, "steps": len(losses),
            "timed_steps": TIMED_STEPS,
            "examples_per_s": TRAIN_BATCH * TIMED_STEPS / seconds,
            "ms_per_step": seconds * 1e3 / TIMED_STEPS,
            "first_loss": float(loss[0]), "last_loss": float(loss[-1]),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card}
    emit(line)
    emit({"phase": "train_path_launches", **counts})
    if len(losses) != WARMUP_STEPS + TIMED_STEPS or not np.isfinite(loss).all() \
            or not loss[-1] < loss[0]:
        raise AssertionError(f"training did not run as expected: {loss.tolist()}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"train path never launched {missing}: {counts}")
    trainer.train_step = step
    return counts, line, trainer, raw, aug


def check_train_path(torch, trainer, raw, aug):
    """One step's loss and gradients from identical weights, batch and seeds,
    through the kernels and through the plain versions."""
    from unirec_tpu_torch.utils import to_device
    from unirec_tpu_torch.models.modules import DropoutRNG
    model, params = trainer.model, trainer.params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    batch = aug.augment(to_device(next(iter(raw)), "cuda"), gen)

    def loss_grads():
        loss, _ = model(batch, train=True, rng=DropoutRNG(SEED + 21, "cuda"))
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_k, grads_k = loss_grads()
    with plain_versions():
        loss_p, grads_p = loss_grads()
    names = [n for n, _ in model.named_parameters()]
    zero_sum = {i: names.index(n.replace("key.bias", "query.bias"))
                for i, n in enumerate(names) if n.endswith("key.bias")}
    errs, zeros = leaf_errs(grads_k, grads_p, zero_sum)
    errs = dict(zip(names, errs))
    worst = max(errs, key=errs.get)
    line = {"phase": "train_path_check", "batch": TRAIN_BATCH,
            "loss_kernels": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel_diff": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
            "loss_tol": 2e-3, "grad_leaves": len(errs), "grad_max_rel_err": errs[worst],
            "grad_worst_leaf": worst, "grad_tol": BWD_TOL,
            "key_bias_grads": {names[i]: r for i, r in zeros.items()},
            "tol_reason": "each leaf relative to its own largest value (a key bias, "
                          "zero in exact arithmetic, to its query bias's); bf16 "
                          "roundings at the same points, f32 sums and atomics in "
                          "another order"}
    emit(line)
    if not (line["loss_rel_diff"] <= 2e-3 and errs[worst] <= BWD_TOL
            and len(zeros) == 2 and zero_sum_ok(zeros)):
        raise AssertionError(f"train path disagrees with the plain versions: {line}")


def device_profile(torch, fn):
    """Run fn under torch.profiler: (wall ms, device busy ms, top device ops,
    the port's kernels among them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side entries only (kernels, copies, sets); host ops would
    # count their kernels a second time
    ops = sorted(((float(e.self_device_time_total), e.key, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(us for us, _, _ in ops) / 1e3
    # the port's own kernels (csrc/*.cu, in an anonymous namespace), wherever
    # they fall in the ranking
    port = [{"op": k[:90], "ms": us / 1e3, "calls": c} for us, k, c in ops
            if k.startswith("void (anonymous namespace)::")]
    return {"traced_device_ops": len(ops), "wall_ms": wall * 1e3,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / (wall * 1e3),
            "top_device_ops": [{"op": k[:90], "ms": us / 1e3, "calls": c}
                               for us, k, c in ops[:14]],
            "port_kernels": port}


def profile_train_path(torch, trainer, raw, card):
    from unirec_tpu_torch.utils import to_device
    batches = [to_device(b, "cuda") for _, b in zip(range(2), iter(raw))]
    torch.cuda.synchronize()
    emit({"phase": "train_path_profile", "steps": 2, "batch": TRAIN_BATCH,
          **device_profile(torch, lambda: [trainer.train_step(b) for b in batches]),
          "card": card})


# ---------------------------------------- fused attention and FFN kernels
ATT_TOL = 2.0 ** -6   # bf16 forward outputs: two ulps of the largest output


def attention_inputs(torch, B, H=2, L=SEQ_LEN, hd=EMB // 2, mask_heads=1, seed=SEED + 30):
    """q, k, v [B, H, L, hd] bf16 at unit scale; the model's additive mask
    [B, mask_heads, L, L] (causal triangle, left padding of 10..L real
    items per example and head)."""
    from unirec_tpu_torch.models.modules import causal_attention_mask
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, hd, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    masks = []
    for _ in range(mask_heads):
        lens = torch.randint(10, L + 1, (B,), generator=g, device="cuda")
        seq = (torch.arange(L, device="cuda")[None, :] >= L - lens[:, None]).long()
        masks.append(causal_attention_mask(seq))
    return q, k, v, torch.cat(masks, dim=1)


def bwd_mask_replay(torch, B, L, hd):
    """Mismatches between the dropout mask the backward applies and the
    forward's keying (the plain keep mask), at p=0.1: q = k = 0 and no mask
    make every probability 1/L, and dO rows one-hot (dO[i, i - c0] = 1 for
    i in [c0, c0 + hd)) make dV[j, i - c0] = z[i, j] = rnd(keep / L / (1 -
    p)) exactly, so dV shows every kept element."""
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.ops import layer as LY
    drop = LY.drop_params(P_DROP, 0.0, True, 780)
    z = torch.zeros(B, 2, L, hd, dtype=torch.bfloat16, device="cuda")
    m = torch.zeros(B, 1, L, L, device="cuda")
    keep = AT._keep(drop, B, 2, L, "cuda")
    want = torch.where(keep, torch.full(keep.shape, 1.0 / L, device="cuda") * drop.inv_attn,
                       0.0).to(torch.bfloat16)
    bad = 0
    for c0 in range(0, L, hd):
        n = min(hd, L - c0)
        do = torch.zeros_like(z)
        do[:, :, c0 + torch.arange(n), torch.arange(n)] = 1.0
        dv = AT._bwd_cuda(z, z, z, m, do, drop)[2]
        bad += int((dv[..., :n].transpose(-1, -2) != want[:, :, c0:c0 + n]).sum())
    return bad, int((~keep).sum())


def kernel_fused_attention(torch):
    """Rows 10 and 11 at the slice's shape (B=32,768, H=2, L=50, hd=32,
    bf16, mask [B,1,L,L]) at p=0 and p=0.1, each against its plain version
    with the same dropout seed (both in their bf16 tensor-core bodies; row 11's
    dropout mask is also held to the forward's keying bit for bit); then a
    per-head mask at B=64. Library: F.scaled_dot_product_attention at p=0
    with the same additive mask (forward; forward plus backward for row
    11, printed beside both of its lines)."""
    import torch.nn.functional as F
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.ops import layer as LY
    q, k, v, mask = attention_inputs(torch, TRAIN_BATCH)
    B, H, L, hd = q.shape
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(SEED + 31),
                     device="cuda").to(torch.bfloat16)
    flops = 4 * B * H * L * L * hd               # QK^T and PV
    mb = mask.to(torch.bfloat16)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mb)
        torch.autograd.grad(o, (qs, ks, vs), do)

    with torch.enable_grad():
        lib_bwd_ms = cuda_ms(lib_fwd_bwd, iters=10)
    rows = {}
    for p in (0.0, P_DROP):
        drop = LY.drop_params(p, 0.0, True, 777)
        out = AT._fwd_cuda(q, k, v, mask, drop)
        ref = AT._fwd_plain(q, k, v, mask, drop)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = ATT_TOL * float(ref.float().abs().max())
        line = {"phase": "kernel", "name": "fused_attention", "p_drop": p,
                "body": AT._fwd_body(q.dtype, L, hd),
                "shape": [B, H, L, hd], "mask": list(mask.shape), "dtype": "bfloat16",
                "max_abs_err": err, "tol": tol,
                "tol_reason": "two bf16 ulps of the largest output",
                "finite": bool(torch.isfinite(out).all()),
                "kernel_ms": cuda_ms(lambda: AT._fwd_cuda(q, k, v, mask, drop)),
                "plain_ms": cuda_ms(lambda: AT._fwd_plain(q, k, v, mask, drop), iters=3,
                                    warmup=1)}
        line["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mb)) if p == 0.0 else None
        line["bound_ms"], line["bound_by"] = bound_ms(nbytes(q, k, v, mask, out), flops,
                                                      "bfloat16")
        emit(line)
        if not (err <= tol and line["finite"]):
            raise AssertionError(f"fused_attention disagrees with its plain version: {line}")
        del out, ref
        got = AT._bwd_cuda(q, k, v, mask, do, drop)
        ref = AT._bwd_plain(q, k, v, mask, do, drop)
        torch.cuda.synchronize()
        errs, _ = leaf_errs(got, ref)
        line_b = {"phase": "kernel", "name": "fused_attention_bwd", "p_drop": p,
                  "shape": [B, H, L, hd], "dtype": "bfloat16",
                  "body": AT._bwd_body(q.dtype, L, hd),
                  "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(got, ref)),
                  "max_rel_err": max(errs), "rel_errs": errs, "tol": BWD_TOL,
                  "tol_reason": "dq, dk, dv each relative to its own largest value; "
                                "bf16 roundings at the same points, f32 sums in "
                                "another order",
                  "finite": all(bool(torch.isfinite(t).all()) for t in got),
                  "kernel_ms": cuda_ms(lambda: AT._bwd_cuda(q, k, v, mask, do, drop),
                                       iters=10),
                  "plain_ms": cuda_ms(lambda: AT._bwd_plain(q, k, v, mask, do, drop),
                                      iters=2, warmup=1),
                  "library_ms": lib_bwd_ms,
                  "library_note": "scaled_dot_product_attention forward plus backward, "
                                  "no dropout"}
        if p > 0.0:
            line_b["mask_replay_mismatches"], line_b["dropped"] = bwd_mask_replay(
                torch, B, L, hd)
        # the backward recomputes S and reads dO: products QK^T, dO V^T,
        # dV, dQ, dK
        line_b["bound_ms"], line_b["bound_by"] = bound_ms(
            nbytes(q, k, v, mask, do, *got), 5 * flops // 2, "bfloat16")
        emit(line_b)
        if not (line_b["max_rel_err"] <= BWD_TOL and line_b["finite"]
                and line_b.get("mask_replay_mismatches", 0) == 0
                and line_b.get("dropped", 1) > 0):
            raise AssertionError("fused_attention_bwd disagrees with its plain version")
        rows[f"fused_attention_p{p}"], rows[f"fused_attention_bwd_p{p}"] = line, line_b
        del got, ref
    # a mask per head (the JAX kernel's other mask layout), small batch
    q, k, v, mask = attention_inputs(torch, 64, mask_heads=2, seed=SEED + 32)
    drop = LY.drop_params(P_DROP, 0.0, True, 778)
    do = torch.randn_like(q.float()).to(torch.bfloat16)
    e_f = float((AT._fwd_cuda(q, k, v, mask, drop).float()
                 - AT._fwd_plain(q, k, v, mask, drop).float()).abs().max())
    e_b, _ = leaf_errs(AT._bwd_cuda(q, k, v, mask, do, drop),
                       AT._bwd_plain(q, k, v, mask, do, drop))
    line = {"phase": "kernel", "name": "fused_attention_head_mask", "shape": list(q.shape),
            "mask": list(mask.shape), "p_drop": P_DROP, "fwd_max_abs_err": e_f,
            "bwd_max_rel_err": max(e_b), "tol_fwd": ATT_TOL * 4, "tol_bwd": BWD_TOL}
    emit(line)
    if not (e_f <= ATT_TOL * 4 and max(e_b) <= BWD_TOL):
        raise AssertionError(f"per-head-mask attention disagrees: {line}")
    kernel_fused_attention_long(torch)
    # the kernels line takes p=0, where scaled_dot_product_attention computes
    # the same function
    return rows["fused_attention_p0.0"], rows["fused_attention_bwd_p0.0"]


def kernel_fused_attention_long(torch):
    """Rows 10 and 11 beyond the whole-sequence kernels' shared memory: the
    tiled pair at L=300 and L=512 (H=2, hd=32, bf16, B=256), forward and
    backward at p=0 and p=0.1, against the plain versions. Tolerances as at
    L=50, but a fully padded example's rows are held to 2^-10 of their
    largest value (scores near -1e4 keep f32 steps of 2^-10)."""
    import torch.nn.functional as F
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.ops import layer as LY
    t0 = time.perf_counter()
    for L in (300, 512):
        q, k, v, mask = attention_inputs(torch, 256, L=L, seed=SEED + 33)
        B, H, _, hd = q.shape
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(
            SEED + 34), device="cuda").to(torch.bfloat16)
        flops = 4 * B * H * L * L * hd
        mb = mask.to(torch.bfloat16)
        for p in (0.0, P_DROP):
            drop = LY.drop_params(p, 0.0, True, 779)
            out = AT._fwd_cuda(q, k, v, mask, drop)
            ref = AT._fwd_plain(q, k, v, mask, drop)
            got = AT._bwd_cuda(q, k, v, mask, do, drop)
            refb = AT._bwd_plain(q, k, v, mask, do, drop)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = ATT_TOL * float(ref.float().abs().max())
            errs, _ = leaf_errs(got, refb)
            line = {"phase": "kernel", "name": "fused_attention", "tiled": AT._tiled(L, hd),
                    "p_drop": p, "shape": [B, H, L, hd], "mask": list(mask.shape),
                    "dtype": "bfloat16", "max_abs_err": err, "tol": tol,
                    "tol_reason": "two bf16 ulps of the largest output",
                    "kernel_ms": cuda_ms(lambda: AT._fwd_cuda(q, k, v, mask, drop), iters=10),
                    "plain_ms": cuda_ms(lambda: AT._fwd_plain(q, k, v, mask, drop), iters=2,
                                        warmup=1),
                    "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mb)) if p == 0.0 else None}
            line["bound_ms"], line["bound_by"] = bound_ms(nbytes(q, k, v, mask, out), flops,
                                                          "bfloat16")
            emit(line)
            line_b = {"phase": "kernel", "name": "fused_attention_bwd",
                      "tiled": AT._tiled(L, hd), "p_drop": p, "shape": [B, H, L, hd],
                      "dtype": "bfloat16", "max_rel_err": max(errs), "rel_errs": errs,
                      "tol": BWD_TOL,
                      "kernel_ms": cuda_ms(lambda: AT._bwd_cuda(q, k, v, mask, do, drop),
                                           iters=5),
                      "plain_ms": cuda_ms(lambda: AT._bwd_plain(q, k, v, mask, do, drop),
                                          iters=2, warmup=1),
                      "library_ms": None}
            line_b["bound_ms"], line_b["bound_by"] = bound_ms(
                nbytes(q, k, v, mask, do, *got), 5 * flops // 2, "bfloat16")
            emit(line_b)
            if not (err <= tol and max(errs) <= BWD_TOL):
                raise AssertionError(f"tiled fused attention disagrees at L={L}: {line}, "
                                     f"{line_b}")
            del out, ref, got, refb
    emit({"phase": "kernel_fused_attention_long", "seconds": time.perf_counter() - t0})


# --------------------------------------------------------- flash attention
FLASH_TOL = {"bfloat16": 2.0 ** -6, "float32": 2.0 ** -10}
FLASH_TOL_REASON = ("bf16: two bf16 ulps of the largest output; f32: 2^-10 of it, the "
                    "f32 step of a score near -1e4 (a fully padded example's rows, where "
                    "a product summed in another order can move a probability by that)")
LONG_LEN, LONG_BATCH = 256, 8192


def flash_inputs(torch, B, L, dtype, hd=EMB // 2, seed=SEED + 60):
    """q, k, v [B, 2, L, hd] at unit scale and the model's additive mask [B,
    1, L, L] f32: causal triangle, left padding of 0..L real items (every
    64th example all padding)."""
    from unirec_tpu_torch.models.modules import causal_attention_mask
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, 2, L, hd, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    lens = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
    lens[::64] = 0
    seq = (torch.arange(L, device="cuda")[None, :] >= L - lens[:, None]).long()
    return q, k, v, causal_attention_mask(seq)


def kernel_flash_attention(torch):
    """Row 9: csrc/flash_attention.cu against its plain version at the long
    path's training shape (B=8,192, H=2, L=256, hd=32) in bf16 and f32, at
    L=264 (ragged) and L=1,024 at a smaller batch, at the serving shape
    (B=256); then the plain backward (torch ops, as the JAX package's XLA
    backward) at the training shape, its time and peak memory. Library:
    scaled_dot_product_attention with the same float mask."""
    import torch.nn.functional as F
    from unirec_tpu_torch.ops import attention as AT
    t0 = time.perf_counter()
    rows = {}
    for B, L, dt in ((LONG_BATCH, LONG_LEN, "bfloat16"), (LONG_BATCH, LONG_LEN, "float32"),
                     (512, 264, "bfloat16"), (128, 1024, "bfloat16"),
                     (BATCH, LONG_LEN, "bfloat16")):
        dtype = getattr(torch, dt)
        q, k, v, mask = flash_inputs(torch, B, L, dtype)
        out, lse = AT._flash_fwd_cuda(q, k, v, mask)
        ref, ref_lse = AT._flash_fwd_plain(q, k, v, mask)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = FLASH_TOL[dt] * max(1.0, float(ref.float().abs().max()))
        lse_err = float(((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max())
        hd = q.shape[-1]
        line = {"phase": "kernel", "name": "flash_attention", "shape": [B, 2, L, hd],
                "body": AT._flash_body(dtype, hd),
                "mask": list(mask.shape), "dtype": dt, "max_abs_err": err, "tol": tol,
                "tol_reason": FLASH_TOL_REASON, "lse_max_rel_err": lse_err, "lse_tol": 1e-5,
                "finite": bool(torch.isfinite(out).all()),
                "kernel_ms": cuda_ms(lambda: AT._flash_fwd_cuda(q, k, v, mask), iters=10),
                "plain_ms": cuda_ms(lambda: AT._flash_fwd_plain(q, k, v, mask), iters=3,
                                    warmup=1)}
        del ref, ref_lse
        ml = mask.to(dtype)
        line["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=ml), iters=10)
        line["library_note"] = "scaled_dot_product_attention, the same float mask"
        line["bound_ms"], line["bound_by"] = bound_ms(
            nbytes(q, k, v, mask, out, lse), 4 * B * 2 * L * L * hd, dt)
        emit(line)
        if not (err <= tol and lse_err <= 1e-5 and line["finite"]):
            raise AssertionError(f"flash_attention disagrees with its plain version: {line}")
        rows.setdefault(f"{dt}_{B}_{L}", line)
        del q, k, v, mask, out, lse, ml
    # the plain backward at the training shape: time and peak memory
    q, k, v, mask = flash_inputs(torch, LONG_BATCH, LONG_LEN, torch.bfloat16)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(SEED + 61),
                    device="cuda").to(torch.bfloat16)
    out, lse = AT._flash_fwd_cuda(q, k, v, mask)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    AT._flash_bwd(q, k, v, mask, out, lse, g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    mb = mask.to(torch.bfloat16)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mb)
        torch.autograd.grad(o, (qs, ks, vs), g)

    with torch.enable_grad():
        lib = cuda_ms(lib_fwd_bwd, iters=5)
    line = {"phase": "kernel", "name": "flash_attention_bwd_plain",
            "shape": list(q.shape), "dtype": "bfloat16", "kernel_ms": None,
            "plain_ms": cuda_ms(lambda: AT._flash_bwd(q, k, v, mask, out, lse, g), iters=3,
                                warmup=1),
            "peak_mem_above_inputs_bytes": peak, "library_ms": lib,
            "library_note": "scaled_dot_product_attention forward plus backward",
            "note": "no kernel: the JAX package's backward is plain XLA (attention.py:143-162)"}
    emit(line)
    del q, k, v, mask, g, out, lse, qs, ks, vs, mb
    emit({"phase": "kernel_flash_attention", "seconds": time.perf_counter() - t0})
    return rows[f"bfloat16_{LONG_BATCH}_{LONG_LEN}"]


def kernel_fused_ffn(torch):
    """Rows 12 and 13 at the entry path's two token counts (layer 0's B*L
    and layer 1's B) and the long path's layer 0 (8,192 x 256), D=64,
    F=128, bf16, swish, against their plain versions (row 13 in its bf16
    tensor-core body);
    then all six activations at a small T in f32 and bf16. No single PyTorch
    call computes the FFN: library_ms is null, and addmm -> act -> addmm is
    timed beside it for information."""
    import torch.nn.functional as F
    from unirec_tpu_torch.ops import ffn as FF
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    D, Fi = EMB, 2 * EMB
    rn = lambda *s, std=1.0, dt=torch.bfloat16: (  # noqa: E731
        torch.randn(*s, generator=g, device="cuda") * std).to(dt)
    w1, b1, w2, b2 = rn(D, Fi, std=0.1), rn(Fi, std=0.02), rn(Fi, D, std=0.1), rn(D, std=0.02)
    rows = {}
    for T in (TRAIN_BATCH * SEQ_LEN, TRAIN_BATCH, LONG_BATCH * LONG_LEN):
        x, dy = rn(T, D), rn(T, D)
        y = FF._fwd_cuda(x, w1, b1, w2, b2, "swish")
        ref = FF._fwd_plain(x, w1, b1, w2, b2, "swish")
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        tol = ATT_TOL * float(ref.float().abs().max())
        chain = cuda_ms(lambda: torch.addmm(b2, F.silu(torch.addmm(b1, x, w1)), w2))
        line = {"phase": "kernel", "name": "fused_ffn", "tokens": T, "dims": [D, Fi],
                "act": "swish", "dtype": "bfloat16", "body": FF._fwd_body(x.dtype, D, Fi),
                "max_abs_err": err, "tol": tol,
                "tol_reason": "two bf16 ulps of the largest output",
                "kernel_ms": cuda_ms(lambda: FF._fwd_cuda(x, w1, b1, w2, b2, "swish")),
                "plain_ms": cuda_ms(lambda: FF._fwd_plain(x, w1, b1, w2, b2, "swish")),
                "library_ms": chain, "library_call": "addmm -> silu -> addmm (three calls)",
                "addmm_act_addmm_ms": chain}
        line["bound_ms"], line["bound_by"] = bound_ms(nbytes(x, w1, b1, w2, b2, y),
                                                      4 * T * D * Fi, "bfloat16")
        # the CUDA-core body on the same inputs, timed in this run
        with mock.patch.object(FF, "_fwd_body", lambda *a: "cuda"):
            core_err = float((FF._fwd_cuda(x, w1, b1, w2, b2, "swish").float()
                              - ref.float()).abs().max())
            core_ms = cuda_ms(lambda: FF._fwd_cuda(x, w1, b1, w2, b2, "swish"), iters=5)
        line["cuda_core"] = {"max_abs_err": core_err, "kernel_ms": core_ms}
        emit(line)
        # the tensor-core body must beat the three-call chain where the paths run it
        slow = T >= TRAIN_BATCH * SEQ_LEN and not line["kernel_ms"] < chain
        if not (err <= tol and core_err <= tol and line["body"] == "mma") or slow:
            raise AssertionError(f"fused_ffn disagrees with its plain version or is slow: {line}")
        rows.setdefault("fused_ffn_cuda_core", {
            "body": "cuda", "max_abs_err": core_err, "kernel_ms": core_ms,
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": line["bound_by"], "library_ms": chain})
        got = FF._bwd_cuda(x, w1, b1, w2, b2, dy, "swish")
        refb = FF._bwd_plain(x, w1, b1, w2, b2, dy, "swish")
        torch.cuda.synchronize()
        errs, _ = leaf_errs(got, refb)
        line_b = {"phase": "kernel", "name": "fused_ffn_bwd", "tokens": T, "dims": [D, Fi],
                  "act": "swish", "dtype": "bfloat16", "body": FF._bwd_body(x.dtype, D, Fi),
                  "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(got, refb)),
                  "max_rel_err": max(errs), "rel_errs": errs, "tol": BWD_TOL,
                  "tol_reason": "dx, dW1, db1, dW2, db2 each relative to its own largest "
                                "value; f32 sums in another order",
                  "kernel_ms": cuda_ms(lambda: FF._bwd_cuda(x, w1, b1, w2, b2, dy, "swish"),
                                       iters=10),
                  "plain_ms": cuda_ms(lambda: FF._bwd_plain(x, w1, b1, w2, b2, dy, "swish"),
                                      iters=5),
                  "library_ms": None}
        # recompute (x W1) plus dh, dx, dW1, dW2: five products of 2*T*D*F
        line_b["bound_ms"], line_b["bound_by"] = bound_ms(
            nbytes(x, dy, w1, b1, w2, b2, *got), 10 * T * D * Fi, "bfloat16")
        emit(line_b)
        if not line_b["max_rel_err"] <= BWD_TOL:
            raise AssertionError("fused_ffn_bwd disagrees with its plain version")
        rows.setdefault("fused_ffn", line)
        rows.setdefault("fused_ffn_bwd", line_b)
        del x, dy, y, ref, got, refb
    worst, fwd = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        x, dy = rn(4099, D, dt=dt), rn(4099, D, dt=dt)
        ws = [t.to(dt) for t in (w1, b1, w2, b2)]
        for act in FF.ACTS:
            errs = leaf_errs((FF._fwd_cuda(x, *ws, act), *FF._bwd_cuda(x, *ws, dy, act)),
                             (FF._fwd_plain(x, *ws, act), *FF._bwd_plain(x, *ws, dy, act)))[0]
            worst[f"{act}_{str(dt)[6:]}"] = max(errs)
            fwd[f"{act}_{str(dt)[6:]}"] = errs[0]
    line = {"phase": "kernel", "name": "fused_ffn_activations", "tokens": 4099,
            "max_rel_err": worst, "tol": {"float32": 1e-4, "bfloat16": BWD_TOL},
            "fwd_rel_err": fwd, "fwd_tol_bfloat16": ATT_TOL,
            "fwd_tol_reason": "the forward (bf16: the tensor-core body) within two bf16 ulps "
                              "of its largest output"}
    emit(line)
    if any(e > (1e-4 if k.endswith("float32") else BWD_TOL) for k, e in worst.items()) or \
            any(e > ATT_TOL for k, e in fwd.items() if k.endswith("bfloat16")):
        raise AssertionError(f"fused_ffn disagrees for an activation: {line}")
    return rows["fused_ffn"], rows["fused_ffn_bwd"], rows["fused_ffn_cuda_core"]


# ------------------------------------------------------------- wide widths
def wide_widths(torch):
    """The widths the JAX gates take and the earlier kernels refused, each
    against its plain version and timed: flash attention at head widths 136
    and 256 (L=256, B=64, H=2, both dtypes: the CUDA-core body in column
    chunks of 128); the fused attention pair at head widths 136 and 256, L=50
    (B=256) and L=512 (B=32), p=0 and 0.1, bf16; the fused FFN at (D, F) =
    (256, 1024) and (64, 2048), 65,536 tokens, both dtypes (the CUDA-core
    bodies in F chunks of 128, and the bf16 backward at D=64 on the tensor
    cores in 16 F chunks). Tolerances as at the paths' shapes."""
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.ops import ffn as FF
    from unirec_tpu_torch.ops import layer as LY
    t0 = time.perf_counter()
    bad = []

    def report(line, ok):
        emit(line)
        if not ok:
            bad.append(line)

    for hd in (136, 256):
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            q, k, v, mask = flash_inputs(torch, 64, LONG_LEN, dtype, hd=hd)
            out, lse = AT._flash_fwd_cuda(q, k, v, mask)
            ref, ref_lse = AT._flash_fwd_plain(q, k, v, mask)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = FLASH_TOL[dt] * max(1.0, float(ref.float().abs().max()))
            lse_err = float(((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max())
            B, H, L, _ = q.shape
            line = {"phase": "wide_widths", "name": "flash_attention", "shape": list(q.shape),
                    "dtype": dt, "body": AT._flash_body(dtype, hd), "max_abs_err": err,
                    "tol": tol, "lse_max_rel_err": lse_err, "lse_tol": 1e-5,
                    "kernel_ms": cuda_ms(lambda: AT._flash_fwd_cuda(q, k, v, mask), iters=5),
                    "plain_ms": cuda_ms(lambda: AT._flash_fwd_plain(q, k, v, mask), iters=3,
                                        warmup=1)}
            line["bound_ms"], line["bound_by"] = bound_ms(
                nbytes(q, k, v, mask, out, lse), 4 * B * H * L * L * hd, dt)
            report(line, err <= tol and lse_err <= 1e-5)
            del q, k, v, mask, out, lse, ref, ref_lse
    for hd in (136, 256):
        for L, B in ((SEQ_LEN, 256), (512, 32)):
            q, k, v, mask = attention_inputs(torch, B, L=L, hd=hd, seed=SEED + 35)
            do = torch.randn_like(q.float()).to(torch.bfloat16)
            H = q.shape[1]
            for p in (0.0, P_DROP):
                drop = LY.drop_params(p, 0.0, True, 781)
                out = AT._fwd_cuda(q, k, v, mask, drop)
                ref = AT._fwd_plain(q, k, v, mask, drop)
                got = AT._bwd_cuda(q, k, v, mask, do, drop)
                refb = AT._bwd_plain(q, k, v, mask, do, drop)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                tol = ATT_TOL * float(ref.float().abs().max())
                errs, _ = leaf_errs(got, refb)
                flops = 4 * B * H * L * L * hd
                line = {"phase": "wide_widths", "name": "fused_attention", "shape": [B, H, L, hd],
                        "p_drop": p, "dtype": "bfloat16", "body": AT._fwd_body(q.dtype, L, hd),
                        "max_abs_err": err, "tol": tol, "bwd_max_rel_err": max(errs),
                        "bwd_tol": BWD_TOL,
                        "kernel_ms": cuda_ms(lambda: AT._fwd_cuda(q, k, v, mask, drop), iters=5),
                        "bwd_kernel_ms": cuda_ms(lambda: AT._bwd_cuda(q, k, v, mask, do, drop),
                                                 iters=3, warmup=1),
                        "plain_ms": cuda_ms(lambda: AT._fwd_plain(q, k, v, mask, drop),
                                            iters=2, warmup=1),
                        "bwd_plain_ms": cuda_ms(lambda: AT._bwd_plain(q, k, v, mask, do, drop),
                                                iters=2, warmup=1)}
                line["bound_ms"], line["bound_by"] = bound_ms(nbytes(q, k, v, mask, out), flops,
                                                              "bfloat16")
                line["bwd_bound_ms"], _ = bound_ms(nbytes(q, k, v, mask, do, *got),
                                                   5 * flops // 2, "bfloat16")
                report(line, err <= tol and max(errs) <= BWD_TOL)
                del out, ref, got, refb
            del q, k, v, mask, do
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    T = 65_536
    for D, Fi in ((256, 1024), (64, 2048)):
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            rn = lambda *sh, std=1.0: (torch.randn(*sh, generator=g, device="cuda")  # noqa: E731
                                       * std).to(dtype)
            x, dy = rn(T, D), rn(T, D)
            w1, b1 = rn(D, Fi, std=(2 / D) ** 0.5), rn(Fi, std=0.02)
            w2, b2 = rn(Fi, D, std=(1 / Fi) ** 0.5), rn(D, std=0.02)
            y = FF._fwd_cuda(x, w1, b1, w2, b2, "swish")
            ref = FF._fwd_plain(x, w1, b1, w2, b2, "swish")
            got = FF._bwd_cuda(x, w1, b1, w2, b2, dy, "swish")
            refb = FF._bwd_plain(x, w1, b1, w2, b2, dy, "swish")
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            tol = (ATT_TOL if dt == "bfloat16" else 1e-5) * float(ref.float().abs().max())
            errs, _ = leaf_errs(got, refb)
            btol = BWD_TOL if dt == "bfloat16" else 1e-4
            line = {"phase": "wide_widths", "name": "fused_ffn", "tokens": T, "dims": [D, Fi],
                    "dtype": dt, "rows": [FF._rows(False, D, Fi), FF._rows(True, D, Fi)],
                    "bwd_body": FF._bwd_body(dtype, D, Fi), "max_abs_err": err, "tol": tol,
                    "bwd_max_rel_err": max(errs), "bwd_tol": btol,
                    "kernel_ms": cuda_ms(lambda: FF._fwd_cuda(x, w1, b1, w2, b2, "swish"),
                                         iters=5),
                    "bwd_kernel_ms": cuda_ms(lambda: FF._bwd_cuda(x, w1, b1, w2, b2, dy, "swish"),
                                             iters=3, warmup=1),
                    "plain_ms": cuda_ms(lambda: FF._fwd_plain(x, w1, b1, w2, b2, "swish"),
                                        iters=3),
                    "bwd_plain_ms": cuda_ms(lambda: FF._bwd_plain(x, w1, b1, w2, b2, dy,
                                                                  "swish"), iters=3)}
            line["bound_ms"], line["bound_by"] = bound_ms(nbytes(x, w1, b1, w2, b2, y),
                                                          4 * T * D * Fi, dt)
            line["bwd_bound_ms"], _ = bound_ms(nbytes(x, dy, w1, b1, w2, b2, *got),
                                               10 * T * D * Fi, dt)
            report(line, err <= tol and max(errs) <= btol)
            del x, dy, y, ref, got, refb
    emit({"phase": "wide_widths", "seconds": time.perf_counter() - t0})
    if bad:
        raise AssertionError(f"wide widths disagree with their plain versions: {bad}")


# --------------------------------------------------------------- entry path
EVAL_USERS, EVAL_BATCH, ENTRY_STEPS, ENTRY_EPOCHS = 8192, 1024, 200, 2
# chance is 10 / 50,000; the walk data below is learned to far above it
LEARN_MIN_HIT10 = 0.1
# the synthetic histories walk groups of WALK_GROUP consecutive item ids (more
# than HIST_CAP + 2, so a walk never repeats an item); WALK_NOISE of the items
# are uniform over the catalog instead
WALK_GROUP, WALK_NOISE = 200, 0.1


def write_slice_data(root: Path, hist=(10, HIST_CAP), group=WALK_GROUP,
                     rows=ENTRY_STEPS * TRAIN_BATCH) -> None:
    """tests/synth.py's on-disk layout at bench.py's scale: 100,000 users
    (id 0 is padding) with hist[0]..hist[1]-1 training items each (10..199
    for the entry path) over 50,000 items, seed 0, then one valid and one
    test item per user. User u walks the items of group u % (49,999 //
    group) (``group`` consecutive ids, more than a history, so a walk never
    repeats an item) one id up at each step from a random start, wrapping
    inside the group, and 10% of its items are uniform over the catalog
    instead; so the next item follows from the last one, which SASRec
    learns within the run's 200 steps per epoch (at 40 it learned only the
    1-in-10 base rate), so the validations choose between scores that
    differ. train.pkl holds ``rows`` (user, item) pairs drawn from the
    histories; valid.pkl and test.pkl 8,192 users each; user_history.pkl
    (user_id, item_seq) the training histories."""
    import json

    import pandas as pd
    rng = np.random.default_rng(SEED)
    users = np.arange(1, N_USERS)
    n = rng.integers(hist[0], hist[1], size=len(users))
    owner = np.repeat(users, n + 2)
    starts = np.concatenate([[0], np.cumsum(n + 2)[:-1]])
    pos = np.arange(len(owner)) - np.repeat(starts, n + 2)
    start = np.repeat(rng.integers(0, group, len(users)), n + 2)
    walk = 1 + (owner % ((N_ITEMS - 1) // group)) * group + (start + pos) % group
    items = np.where(rng.random(len(owner)) < WALK_NOISE,
                     rng.integers(1, N_ITEMS, len(owner)), walk)
    is_train = pos < np.repeat(n, n + 2)
    root.mkdir(parents=True, exist_ok=True)
    seqs = np.split(items[is_train], np.cumsum(n)[:-1])
    pd.DataFrame({"user_id": users, "item_seq": seqs}).to_pickle(root / "user_history.pkl")
    pick = rng.choice(int(is_train.sum()), rows, replace=False)
    pd.DataFrame({"user_id": owner[is_train][pick],
                  "item_id": items[is_train][pick]}).to_pickle(root / "train.pkl")
    for name, off in (("valid", 0), ("test", 1)):
        who = np.sort(rng.choice(len(users), EVAL_USERS, replace=False))
        pd.DataFrame({"user_id": users[who],
                      "item_id": items[starts[who] + n[who] + off]}).to_pickle(
            root / f"{name}.pkl")
    (root / "data.info").write_text(json.dumps({
        "n_users": N_USERS, "n_items": N_ITEMS, "train_file_format": "user-item",
        "valid_file_format": "user-item", "test_file_format": "user-item",
        "user_history_file_format": "user-item_seq"}))


def entry_args(data: Path, out: Path):
    """sasrec_fusedattn_ffn: bench.py's widths and training options with the
    fused attention and FFN kernels in place of the fused layers."""
    return {"task": "train", "model": "SASRec", "dataloader": "SeqRecDataset",
            "dataset_path": str(data), "output_path": str(out),
            "exp_name": "sasrec_fusedattn_ffn", "user_history_filename": "user_history",
            "max_seq_len": SEQ_LEN, "embedding_size": EMB, "hidden_size": EMB,
            "inner_size": 2 * EMB, "n_layers": 2, "n_heads": 2, "hidden_act": "swish",
            "loss_type": "bce", "n_sample_neg_train": N_NEG,
            "history_mask_mode": "autoregressive", "hidden_dropout_prob": P_DROP,
            "attn_dropout_prob": P_DROP, "dropout_bits": 8, "compute_dtype": "bfloat16",
            "last_query_only": 1, "fused_layer": 0, "fused_lastq": 0,
            "use_fused_attention": 1, "use_fused_ffn": 1, "vmem_embedding_grad": 1,
            "neg_membership_pallas": 1, "batch_size": TRAIN_BATCH, "epochs": ENTRY_EPOCHS,
            "learning_rate": 1e-3, "seed": SEED, "shuffle_train": 1,
            "valid_protocol": "one_vs_all", "test_protocol": "one_vs_all",
            "test_batch_size": EVAL_BATCH, "metrics": "['hit@10', 'ndcg@10', 'mrr', 'group_auc']",
            "key_metric": "ndcg@10", "early_stop": 5}


def entry_path(torch, card: str):
    """main.run(task=train) on sasrec_fusedattn_ffn, then task=test from the
    best checkpoint. Timed: epoch 2 (from the end of the validation before
    it to the test evaluation after it) and each evaluation."""
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.main import main as main_mod
    t0 = time.perf_counter()
    data, out = ROOT / "build" / "chip_smoke" / "slice_data", ROOT / "build" / "chip_smoke" / "slice"
    write_slice_data(data)
    setup_s = time.perf_counter() - t0
    seen = {"losses": [], "evals": [], "marks": []}
    step, evaluate, fit = Trainer.train_step, Trainer.evaluate, Trainer.fit

    def spy_step(self, batch):
        seen["losses"].append(step(self, batch))
        return seen["losses"][-1]

    def spy_eval(self, data, load_best_model=True, model_file=None, **kw):
        torch.cuda.synchronize()
        seen["marks"].append(time.perf_counter())
        res = evaluate(self, data, load_best_model, model_file, **kw)
        torch.cuda.synchronize()
        seen["marks"].append(time.perf_counter())
        seen["evals"].append((res, seen["marks"][-1] - seen["marks"][-2], len(data.ds)))
        return res

    def spy_fit(self, train_data, valid_data=None, **kw):
        seen["trainer"], seen["train_data"] = self, train_data
        return fit(self, train_data, valid_data, **kw)

    args = entry_args(data, out)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with mock.patch.object(Trainer, "train_step", spy_step), \
            mock.patch.object(Trainer, "evaluate", spy_eval), \
            mock.patch.object(Trainer, "fit", spy_fit):
        t0 = time.perf_counter()
        result = main_mod.run(dict(args))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    counts = launch_counts(ENTRY_KERNELS + ("layer_fwd", "layer_bwd", "lastq_fwd",
                                            "lastq_bwd"))
    peak = torch.cuda.max_memory_allocated()
    ckpt = out / "checkpoint" / "sasrec_fusedattn_ffn.pkl"
    again = main_mod.run({"task": "test", "model_file": str(ckpt), "dataset_path": str(data),
                          "output_path": str(out / "test")})
    loss = torch.stack(seen["losses"]).float().cpu().numpy()
    valid, (test_res, test_s, n_test) = seen["evals"][:-1], seen["evals"][-1]
    # marks: [v0 start, v0 end, v1 start, v1 end, test start, test end]
    epoch2_s = seen["marks"][4] - seen["marks"][3]
    line = {"phase": "entry_path", "config": "sasrec_fusedattn_ffn", "batch": TRAIN_BATCH,
            "steps": len(loss), "epochs": ENTRY_EPOCHS, "data_setup_s": setup_s,
            "run_s": run_s, "examples_per_s": TRAIN_BATCH * ENTRY_STEPS / epoch2_s,
            "ms_per_step": epoch2_s * 1e3 / ENTRY_STEPS,
            "first_losses": loss[:3].tolist(), "last_losses": loss[-3:].tolist(),
            "valid": [{"result": r, "seconds": s, "users_per_s": u / s} for r, s, u in valid],
            "test": test_res, "test_users_per_s": n_test / test_s,
            "test_from_checkpoint": again, "peak_mem_bytes": peak, "card": card}
    emit(line)
    emit({"phase": "entry_path_launches", **counts})
    if len(loss) != ENTRY_STEPS * ENTRY_EPOCHS or not np.isfinite(loss).all() \
            or not loss[-10:].mean() < loss[:10].mean():
        raise AssertionError(f"training did not run as expected: {loss.tolist()}")
    if len(valid) != ENTRY_EPOCHS or not all(np.isfinite(r["ndcg@10"]) for r, _, _ in valid):
        raise AssertionError(f"a validation gave no key metric: {valid}")
    if not max(r["hit@10"] for r, _, _ in valid) >= LEARN_MIN_HIT10:
        raise AssertionError(f"the model learned nothing the validations show: {valid}")
    if again != test_res or again != result:
        raise AssertionError(f"test from the checkpoint {again} != the run's {result}")
    missing = [k for k in ENTRY_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"entry path never launched {missing}: {counts}")
    return counts, line, seen["trainer"], seen["train_data"]


def check_entry_path(torch, trainer, train_data, phase="entry_path_check"):
    """One step at dropout 0 from the trained weights, through the kernels
    and through the plain versions: loss and every gradient leaf. Then one
    test batch's user embeddings, ranks and metrics both ways."""
    from unirec_tpu_torch.facility.evaluation import OnePositiveEvaluator
    from unirec_tpu_torch.models.modules import DropoutRNG
    from unirec_tpu_torch.utils import to_device
    from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = dict(trainer.config, hidden_dropout_prob=0.0, attn_dropout_prob=0.0)
    model = get_model_class("SASRec")(cfg)
    load_flax_params(model, to_flax_params(trainer.model))
    model.to("cuda")
    params = list(model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    batch = trainer._augmenter.augment(to_device(next(iter(train_data)), "cuda"), gen)

    def loss_grads():
        loss, _ = model(batch, train=True, rng=DropoutRNG(SEED + 51, "cuda"))
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_k, grads_k = loss_grads()
    with plain_versions():
        loss_p, grads_p = loss_grads()
    names = [n for n, _ in model.named_parameters()]
    zero_sum = {i: names.index(n.replace("key.bias", "query.bias"))
                for i, n in enumerate(names) if n.endswith("key.bias")}
    errs, zeros = leaf_errs(grads_k, grads_p, zero_sum)
    errs = dict(zip(names, errs))
    worst = max(errs, key=errs.get)
    line = {"phase": phase, "batch": len(batch["user_id"]), "p_drop": 0.0,
            "loss_kernels": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel_diff": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
            "loss_tol": 2e-3, "grad_leaves": len(errs), "grad_max_rel_err": errs[worst],
            "grad_worst_leaf": worst, "grad_tol": BWD_TOL,
            "key_bias_grads": {names[i]: r for i, r in zeros.items()}}
    ev = OnePositiveEvaluator(cfg, model, "cuda")
    eval_batch = next(iter(trainer_test_batcher(trainer)))
    line.update(eval_agreement(torch, trainer, model, ev, eval_batch))
    emit(line)
    if not (line["loss_rel_diff"] <= 2e-3 and errs[worst] <= BWD_TOL and len(zeros) == 2
            and zero_sum_ok(zeros) and line["user_emb_max_abs_diff"] <= line["user_emb_tol"]
            and line["rank_agree_share"] >= RANK_AGREE_SHARE
            and line["metric_max_rel_diff"] <= METRIC_REL_TOL):
        raise AssertionError(f"{phase}: kernels disagree with the plain versions: {line}")
    return ev, eval_batch


# one eval batch, kernels against plain versions: a row's rank of the
# positive agrees when the two differ by at most RANK_SLACK plus
# RANK_REL_SLACK of the rank (bf16 user embeddings within emb_tol move a
# score by about 1e-2 of its spread, and with it the items packed around a
# mid-catalog positive); RANK_AGREE_SHARE of the rows must agree, and each
# metric must lie within METRIC_REL_TOL of its own plain value
RANK_SLACK, RANK_REL_SLACK, RANK_AGREE_SHARE, METRIC_REL_TOL = 2, 0.05, 0.99, 0.02


def eval_agreement(torch, trainer, model, ev, eval_batch):
    """One test batch through the kernels and through the plain versions:
    the user embeddings, each row's rank of the positive among the catalog
    (evaluate_full's ranking, the same tie noise both ways), and the
    batch's metrics."""
    from unirec_tpu_torch.ops import metrics as M
    from unirec_tpu_torch.ops.topk import full_catalog_scores
    from unirec_tpu_torch.utils import to_device
    history = trainer.user_history
    tb = to_device(eval_batch, "cuda")
    items, lens = history.gather(np.asarray(eval_batch["user_id"]))
    h = to_device({"items": items, "len": lens}, "cuda")
    real = torch.as_tensor(np.asarray(eval_batch["weight"]) > 0, device="cuda")

    def one_way():
        u = model.user_emb(tb).float()
        scores = full_catalog_scores(model, tb, model.all_item_emb(), 1.0)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 202)
        rank = M.onepos_rank_full_catalog(scores, tb["item_id"], h["items"], h["len"], gen)
        return u, rank[real].long(), ev.evaluate_full([eval_batch], history)

    with torch.no_grad():
        u_k, r_k, m_k = one_way()
        with plain_versions():
            u_p, r_p, m_p = one_way()
    gap = (r_k - r_p).abs()
    agree = gap <= RANK_SLACK + RANK_REL_SLACK * r_p
    return {"eval_batch": int(real.sum()),
            "user_emb_max_abs_diff": float((u_k - u_p).abs().max()),
            "user_emb_tol": emb_tol(u_p),
            "rank_equal_share": float((gap == 0).float().mean()),
            "rank_agree_share": float(agree.float().mean()),
            "rank_agree_tol": [RANK_SLACK, RANK_REL_SLACK, RANK_AGREE_SHARE],
            "rank_gap_quantiles_50_90_99": torch.quantile(
                gap.float(), torch.tensor([0.5, 0.9, 0.99], device="cuda")).tolist(),
            "rank_plain_median": float(r_p.float().median()),
            "metrics_kernels": m_k, "metrics_plain": m_p,
            # a metric that is 0 both ways is held to one row's step
            "metric_max_rel_diff": max(abs(m_k[m] - m_p[m]) / max(abs(m_p[m]), 1.0 / len(r_p))
                                       for m in m_p),
            "metric_rel_tol": METRIC_REL_TOL}


def trainer_test_batcher(trainer, config=None, history=None):
    """The test table's eval batcher, as main.run builds it."""
    from unirec_tpu_torch.data.datasets import get_dataset_class
    from unirec_tpu_torch.data.pipeline import make_eval_batcher
    from unirec_tpu_torch.main.main import _task_config
    config = config or trainer.config
    tcfg = _task_config(config, "test")
    ds = get_dataset_class("SeqRecDataset")(tcfg, config["dataset_path"], "test")
    return make_eval_batcher(ds, tcfg, history or trainer.user_history, task="test")


def profile_entry_path(torch, trainer, train_data, ev, eval_batch, card,
                       phase="entry_path_profile"):
    from unirec_tpu_torch.utils import to_device
    batch = to_device(next(iter(train_data)), "cuda")
    trainer.train_step(batch)
    torch.cuda.synchronize()
    emit({"phase": phase, "what": "one train step", "batch": len(batch["user_id"]),
          **device_profile(torch, lambda: trainer.train_step(batch)), "card": card})
    emit({"phase": phase, "what": "one eval batch (one_vs_all)",
          "users": len(eval_batch["user_id"]), "items": N_ITEMS,
          **device_profile(torch, lambda: ev.evaluate_full([eval_batch],
                                                           trainer.user_history)),
          "card": card})


# ---------------------------------------------------------------- long path
LONG_HIST, LONG_GROUP, LONG_STEPS, LONG_EPOCHS = (64, 768), 800, 300, 2


def long_args(data: Path, out: Path):
    """sasrec_long256_flash: the entry path's widths and training options at
    max_seq_len 256 with use_pallas (flash attention) in place of
    use_fused_attention, attention dropout 0 (which lets training reach the
    kernel), batch 8,192."""
    return dict(entry_args(data, out), exp_name="sasrec_long256_flash",
                max_seq_len=LONG_LEN, attn_dropout_prob=0.0, use_fused_attention=0,
                use_pallas=1, batch_size=LONG_BATCH, epochs=LONG_EPOCHS)


def long_path(torch, card: str):
    """main.run(task=train) on sasrec_long256_flash with one-vs-all validation
    before each epoch and the test after; then task=test and task=infer from
    the best checkpoint. Launches are counted over the train run, over its
    evaluations alone, and over the infer run."""
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.main import main as main_mod
    from unirec_tpu_torch.ops import attention as AT
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke"
    data, out = root / "long_data", root / "long"
    write_slice_data(data, LONG_HIST, LONG_GROUP, LONG_STEPS * LONG_BATCH)
    setup_s = time.perf_counter() - t0
    seen = {"losses": [], "evals": [], "marks": [], "eval_flash": 0}
    step, evaluate, fit = Trainer.train_step, Trainer.evaluate, Trainer.fit

    def spy_step(self, batch):
        seen["losses"].append(step(self, batch))
        return seen["losses"][-1]

    def spy_eval(self, data, load_best_model=True, model_file=None, **kw):
        torch.cuda.synchronize()
        seen["marks"].append(time.perf_counter())
        n0 = AT.flash_attention.launches
        res = evaluate(self, data, load_best_model, model_file, **kw)
        torch.cuda.synchronize()
        seen["eval_flash"] += AT.flash_attention.launches - n0
        seen["marks"].append(time.perf_counter())
        seen["evals"].append((res, seen["marks"][-1] - seen["marks"][-2], len(data.ds)))
        return res

    def spy_fit(self, train_data, valid_data=None, **kw):
        seen["trainer"], seen["train_data"] = self, train_data
        return fit(self, train_data, valid_data, **kw)

    args = long_args(data, out)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with mock.patch.object(Trainer, "train_step", spy_step), \
            mock.patch.object(Trainer, "evaluate", spy_eval), \
            mock.patch.object(Trainer, "fit", spy_fit):
        t1 = time.perf_counter()
        result = main_mod.run(dict(args))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
    counts = launch_counts(LONG_KERNELS + OFF_LONG_PATH)
    peak = torch.cuda.max_memory_allocated()
    ckpt = out / "checkpoint" / "sasrec_long256_flash.pkl"
    again = main_mod.run({"task": "test", "model_file": str(ckpt), "dataset_path": str(data),
                          "output_path": str(out / "test")})
    reset_counts()
    t1 = time.perf_counter()
    main_mod.run({"task": "infer", "model_file": str(ckpt), "dataset_path": str(data),
                  "output_path": str(out / "infer")})
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t1
    infer_counts = launch_counts(("flash_attention",))
    loss = torch.stack(seen["losses"]).float().cpu().numpy()
    valid, (test_res, test_s, n_test) = seen["evals"][:-1], seen["evals"][-1]
    epoch2_s = seen["marks"][4] - seen["marks"][3]
    line = {"phase": "long_path", "config": "sasrec_long256_flash", "batch": LONG_BATCH,
            "max_seq_len": LONG_LEN, "steps": len(loss), "epochs": LONG_EPOCHS,
            "data_setup_s": setup_s, "run_s": run_s,
            "examples_per_s": LONG_BATCH * LONG_STEPS / epoch2_s,
            "ms_per_step": epoch2_s * 1e3 / LONG_STEPS,
            "first_losses": loss[:3].tolist(), "last_losses": loss[-3:].tolist(),
            "valid": [{"result": r, "seconds": s, "users_per_s": u / s} for r, s, u in valid],
            "test": test_res, "test_users_per_s": n_test / test_s,
            "test_from_checkpoint": again, "infer_s": infer_s, "peak_mem_bytes": peak,
            "seconds": time.perf_counter() - t0, "card": card}
    emit(line)
    emit({"phase": "long_path_launches", **counts, "flash_attention_in_evaluations":
          seen["eval_flash"], "infer": infer_counts})
    if len(loss) != LONG_STEPS * LONG_EPOCHS or not np.isfinite(loss).all() \
            or not loss[-10:].mean() < loss[:10].mean():
        raise AssertionError(f"long training did not run as expected: {loss.tolist()}")
    if len(valid) != LONG_EPOCHS or not all(np.isfinite(r["ndcg@10"]) for r, _, _ in valid):
        raise AssertionError(f"a validation gave no key metric: {valid}")
    if not max(r["hit@10"] for r, _, _ in valid) >= LEARN_MIN_HIT10:
        raise AssertionError(f"the model learned nothing the validations show: {valid}")
    if again != test_res or again != result:
        raise AssertionError(f"test from the checkpoint {again} != the run's {result}")
    missing = [k for k in LONG_KERNELS if counts[k] <= 0]
    stray = [k for k in OFF_LONG_PATH if counts[k] != 0]
    if missing or stray or seen["eval_flash"] <= 0 or infer_counts["flash_attention"] <= 0:
        raise AssertionError(f"long path launches: missing {missing}, stray {stray}, "
                             f"evaluations {seen['eval_flash']}, infer {infer_counts}")
    check_infer_file(torch, out / "infer" / "sasrec_long256_flash.infer.txt", ckpt,
                     seen["trainer"])
    counts["long_infer"] = infer_counts["flash_attention"]
    return counts, seen["trainer"], seen["train_data"], ckpt


def check_infer_file(torch, path: Path, ckpt: Path, trainer):
    """task=infer's file: one finite score per real test row, each within the
    score error a user-embedding difference of LN_TOL can cause of
    model.predict through the plain versions (the file keeps 6 decimals)."""
    from unirec_tpu_torch.facility.evaluation import OnePositiveEvaluator
    from unirec_tpu_torch.utils.checkpoint import load_model_freely
    got = np.loadtxt(path)
    model, cfg = load_model_freely(str(ckpt), "cuda")
    batcher = trainer_test_batcher(trainer, dict(cfg, dataset_path=trainer.config[
        "dataset_path"]))
    with plain_versions():
        ref = OnePositiveEvaluator(cfg, model, "cuda").predict_scores(batcher)
    with torch.no_grad():
        items = model.all_item_emb().float()
    tol = LN_TOL["bfloat16"] * float(items.abs().sum(1).max()) + 1e-6
    err = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
    line = {"phase": "long_infer_check", "rows": int(got.shape[0]), "test_rows": len(ref),
            "finite": bool(np.isfinite(got).all()), "max_abs_diff_to_plain": err, "tol": tol,
            "tol_reason": "LN_TOL on the user embedding times the largest item L1 norm"}
    emit(line)
    if not (line["finite"] and err <= tol):
        raise AssertionError(f"infer file disagrees with the plain versions: {line}")


def long_serve(torch, ckpt: Path, card: str):
    """reco_topk from the long checkpoint: 4,096 users of the long data's
    histories, batch 256, top-100, bf16 catalog; rows 5 and 9 launch; the
    ids agree with the plain-version run as the serving path's check."""
    from unirec_tpu_torch.data.history import UserHistory
    from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
    from unirec_tpu_torch.utils.checkpoint import load_model_freely
    t0 = time.perf_counter()
    history = UserHistory.load(str(ROOT / "build" / "chip_smoke" / "long_data" /
                                   "user_history"), N_USERS, "user-item_seq")
    model, cfg = load_model_freely(str(ckpt), "cuda")
    cfg = dict(cfg, test_batch_size=BATCH)
    users = np.arange(1, SERVE_USERS + 1, dtype=np.int64)
    get_topk_recommendations(cfg, model, users[:BATCH], history, TOPK)   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    ids = get_topk_recommendations(cfg, model, users, history, TOPK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = launch_counts(("flash_attention", "blockmax"))
    emit({"phase": "long_serve", "users": SERVE_USERS, "batch": BATCH, "topk": TOPK,
          "max_seq_len": LONG_LEN, "users_per_s": SERVE_USERS / secs,
          "ms_per_batch": secs * 1e3 / (SERVE_USERS // BATCH), **counts,
          "seconds": time.perf_counter() - t0, "card": card})
    if min(counts.values()) <= 0:
        raise AssertionError(f"long serving never launched a kernel: {counts}")
    with torch.no_grad():
        check_main_path(torch, model, cfg, users, history, {"bf16": cfg}, {"bf16": ids},
                        phase="long_serve_check")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "unirec_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from unirec_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = smi_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in logs.items()}})
    for name, v in logs.items():
        for ln in str(v["log"]).splitlines():
            if any(k in ln for k in ("registers", "spill", "Function properties",
                                     "Compiling entry function")):
                print(f"ptxas {name}: {ln.strip()}", flush=True)

    rows = {}
    with torch.no_grad():
        rows["layer_fwd"] = kernel_layer(torch, "bfloat16")
        rows["layer_fwd_cuda_core"] = rows["layer_fwd"]["cuda_core"]
        kernel_layer(torch, "float32")
        for act in ("relu", "gelu", "tanh", "sigmoid"):
            for causal in (True, False):
                kernel_layer(torch, "float32", act, causal, timed=False)
        kernel_layer(torch, "bfloat16", "gelu", False, timed=False)
        rows["lastq_fwd"] = kernel_lastq(torch, "bfloat16")
        rows["lastq_fwd_cuda_core"] = rows["lastq_fwd"]["cuda_core"]
        kernel_lastq(torch, "float32")
        kernel_lastq(torch, "float32", "gelu", timed=False)
        rows["blockmax"] = kernel_blockmax(torch, N_ITEMS, "bfloat16")
        kernel_blockmax(torch, 1_000_000, "bfloat16")
        kernel_blockmax(torch, N_ITEMS, "float32")
        rows["blockmax_int8"] = kernel_blockmax(torch, N_ITEMS, "bfloat16", int8=True)
        kernel_blockmax(torch, 1_000_000, "bfloat16", int8=True)
        kernel_fused_topk(torch)

    counts = main_path(torch, card)

    rows.update(kernel_train_layers(torch))
    kernel_scatter(torch)
    rows["member"] = kernel_member(torch)
    torch.cuda.empty_cache()
    train_counts, _, trainer, raw, aug = train_path(torch, card)
    check_train_path(torch, trainer, raw, aug)
    profile_train_path(torch, trainer, raw, card)
    del trainer, raw, aug

    torch.cuda.empty_cache()
    with torch.no_grad():
        rows["fused_attention"], rows["fused_attention_bwd"] = kernel_fused_attention(torch)
        rows["fused_ffn"], rows["fused_ffn_bwd"], rows["fused_ffn_cuda_core"] = \
            kernel_fused_ffn(torch)
    torch.cuda.empty_cache()
    entry_counts, _, trainer, train_data = entry_path(torch, card)
    entry_scatter = []
    with scatter_capture(entry_scatter):
        ev, eval_batch = check_entry_path(torch, trainer, train_data)
    scatter_entry = kernel_scatter_path(torch, "entry", entry_scatter)
    del entry_scatter
    profile_entry_path(torch, trainer, train_data, ev, eval_batch, card)
    del trainer, train_data, ev, eval_batch

    walls = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[name] = time.perf_counter() - t0
        return out

    torch.cuda.empty_cache()
    with torch.no_grad():
        rows["flash_attention"] = timed("kernel_flash_attention", kernel_flash_attention, torch)
        timed("wide_widths", wide_widths, torch)
    torch.cuda.empty_cache()
    long_counts, trainer, train_data, ckpt = timed("long_path", long_path, torch, card)
    long_scatter = []
    with scatter_capture(long_scatter):
        ev, eval_batch = timed("long_path_check", check_entry_path, torch, trainer, train_data,
                               phase="long_path_check")
    timed("scatter_long_ids", kernel_scatter_path, torch, "long", long_scatter)
    del long_scatter
    timed("long_path_profile", profile_entry_path, torch, trainer, train_data, ev,
          eval_batch, card, phase="long_path_profile")
    del trainer, train_data, ev, eval_batch
    torch.cuda.empty_cache()
    serve_counts = timed("long_serve", long_serve, torch, ckpt, card)

    # row 6's line is the entry path's item_seq ids, its per-row body's the
    # same call's
    sc = rows["scatter_add"] = scatter_entry["item_seq"]
    rows["scatter_add_per_row"] = {**{k: sc[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                                          "library_ms")},
                                   **sc["per_row"]}
    # the serving rows keep their serving-shape numbers; launches add up
    # both paths where a kernel runs on both
    sources = {"layer_fwd": ("unirec_tpu_torch/csrc/layer_fwd.cu",
                             "unirec_tpu/ops/layer.py:279"),
               "lastq_fwd": ("unirec_tpu_torch/csrc/lastq_fwd.cu",
                             "unirec_tpu/ops/layer.py:589"),
               "blockmax": ("unirec_tpu_torch/csrc/blockmax.cu",
                            "unirec_tpu/ops/topk.py:225"),
               "blockmax_int8": ("unirec_tpu_torch/csrc/blockmax.cu",
                                 "unirec_tpu/ops/topk.py:236"),
               "layer_bwd": ("unirec_tpu_torch/csrc/layer_bwd.cu",
                             "unirec_tpu/ops/layer.py:311"),
               "lastq_bwd": ("unirec_tpu_torch/csrc/lastq_bwd.cu",
                             "unirec_tpu/ops/layer.py:638"),
               "scatter_add": ("unirec_tpu_torch/csrc/scatter_add.cu",
                               "unirec_tpu/ops/scatter_accum.py:44"),
               "scatter_add_per_row": ("unirec_tpu_torch/csrc/scatter_add.cu",
                                       "unirec_tpu/ops/scatter_accum.py:44"),
               "member": ("unirec_tpu_torch/csrc/member.cu",
                          "unirec_tpu/ops/member.py:32"),
               "fused_attention": ("unirec_tpu_torch/csrc/attention.cu",
                                   "unirec_tpu/ops/attention.py:236"),
               "fused_attention_bwd": ("unirec_tpu_torch/csrc/attention.cu",
                                       "unirec_tpu/ops/attention.py:260"),
               "fused_ffn": ("unirec_tpu_torch/csrc/ffn.cu", "unirec_tpu/ops/ffn.py:62"),
               "fused_ffn_cuda_core": ("unirec_tpu_torch/csrc/ffn.cu",
                                       "unirec_tpu/ops/ffn.py:62"),
               "layer_bwd_cuda_core": ("unirec_tpu_torch/csrc/layer_bwd.cu",
                                       "unirec_tpu/ops/layer.py:311"),
               "layer_fwd_cuda_core": ("unirec_tpu_torch/csrc/layer_fwd.cu",
                                       "unirec_tpu/ops/layer.py:279"),
               "lastq_bwd_cuda_core": ("unirec_tpu_torch/csrc/lastq_bwd.cu",
                                       "unirec_tpu/ops/layer.py:638"),
               "lastq_fwd_cuda_core": ("unirec_tpu_torch/csrc/lastq_fwd.cu",
                                       "unirec_tpu/ops/layer.py:589"),
               "fused_ffn_bwd": ("unirec_tpu_torch/csrc/ffn.cu", "unirec_tpu/ops/ffn.py:72"),
               "flash_attention": ("unirec_tpu_torch/csrc/flash_attention.cu",
                                   "unirec_tpu/ops/attention.py:44")}
    # the body each line times: rows 1-4 and 12 list their tensor-core body
    # ("mma") and their CUDA-core body, row 6 its sorted-tile body and its
    # per-row body, the older body's launches the rest of the kernel's; rows
    # 9-11 and 13 name the body their path shape takes
    split = {**{n: ("mma", "cuda_core") for n in ("layer_fwd", "layer_bwd", "lastq_fwd",
                                                  "lastq_bwd", "fused_ffn")},
             "scatter_add": ("sorted", "per_row")}
    bodies = {"fused_ffn_bwd": "mma", "fused_attention": "mma", "fused_attention_bwd": "mma",
              "flash_attention": "mma", **{n: new for n, (new, _) in split.items()},
              **{f"{n}_{old}": "cuda" if old == "cuda_core" else old
                 for n, (_, old) in split.items()}}
    paths = {"serving": counts, "training": train_counts, "entry": entry_counts,
             "long": long_counts, "long_serve": serve_counts}

    def launched(name, path):
        for base, (new, old) in split.items():
            if name == f"{base}_{old}":
                return path.get(base, 0) - path.get(f"{base}_{new}", 0)
            if name == base:
                return path.get(f"{base}_{new}", 0)
        return path.get(name, 0)

    kernels = []
    for name, (src, rep) in sources.items():
        r = rows[name]
        by_path = {k: launched(name, v) for k, v in paths.items()}
        by_path["long_infer"] = long_counts["long_infer"] if name == "flash_attention" else 0
        kernels.append({
            "name": name, "body": bodies.get(name, "cuda"), "route": "cuda", "source": src,
            "replaces": rep, "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start, "new_phases_s": walls})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
