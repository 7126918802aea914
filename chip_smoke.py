#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unirec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving path from unirec_tpu_torch/csrc
     with nvcc for sm_90a, one nvcc process per source, all at once;
  3. each kernel at the serving shapes against its plain PyTorch version on
     the same inputs, with the tolerance stated in its line, and timed:
     kernel, plain version, a PyTorch yardstick where one exists, and the
     least time the card could take (bound);
  4. the serving path: a bench-width SASRec (2 layers, d=64, 2 heads, inner
     128, L=50, 50,000 items; random weights from a seed, saved and loaded
     as a checkpoint) serves top-100 to a few thousand users of a synthetic
     100,000-user history through reco_topk.get_topk_recommendations, with
     a bf16 catalog and then an int8 one. Every serving kernel's launch
     count must rise in that run, and the ids must agree with the same model
     run through the plain versions on the card;
  5. the training kernels at bench.py's training shapes (B=32,768): the two
     forward layers with dropout 0.1, their backwards, the embedding-grad
     scatter-add and the negative-membership test, each against its plain
     version with the same inputs and dropout seeds, and timed;
  6. the training path: bench.py's workload (SASRec as above, BCE with 9
     rejection-sampled negatives, Adam, dropout 0.1, bf16, batch 32,768,
     with neg_membership_pallas on) trained through the port's
     Trainer.fit, 3 warm-up and 24 timed steps; the loss must stay finite
     and fall, and every training kernel must launch. Then one step from the
     same weights, batch and seeds through the kernels and through the plain
     versions, loss and every gradient compared; then two traced steps.
Then it prints one {"kernels": [...]} line and, last, {"ok": true, ...}.
It exits non-zero, without the "ok" line, when any phase fails, when no CUDA
card is visible, or when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
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
    if timed:
        B, Lp, D = xp.shape
        F = flat[6].shape[1]
        flops = 2 * B * Lp * (3 * D * D + D * D + 2 * D * F) + 4 * B * Lp * Lp * D
        line["kernel_ms"] = cuda_ms(lambda: LY._layer_fwd_cuda(xp, mp, flat, *args))
        line["plain_ms"] = cuda_ms(lambda: LY._layer_fwd_plain(xp, mp, flat, *args))
        line["library_ms"] = None
        line["bound_ms"], line["bound_by"] = bound_ms(nbytes(xp, mp, *flat, y), flops,
                                                      dtype_name)
    emit(line)
    if not (err <= tol and line["finite"]):
        raise AssertionError(f"layer_fwd disagrees with its plain version: {line}")
    return line


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
    emit(line)
    if not (err <= tol and line["finite"]):
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
    from unirec_tpu_torch.ops import layer as LY, member as MB, scatter_accum as SA, \
        topk as TK
    with mock.patch.object(LY, "_layer_fwd_cuda", LY._layer_fwd_plain), \
            mock.patch.object(LY, "_lastq_fwd_cuda", LY._lastq_fwd_plain), \
            mock.patch.object(LY, "_layer_bwd_cuda", LY._layer_bwd_plain), \
            mock.patch.object(LY, "_lastq_bwd_cuda", LY._lastq_bwd_plain), \
            mock.patch.object(SA, "_scatter_cuda", SA._scatter_plain), \
            mock.patch.object(MB, "_member_cuda", MB._member_plain), \
            mock.patch.object(TK, "_blockmax_cuda", TK._blockmax_plain):
        yield


def _counters():
    from unirec_tpu_torch.ops import layer as LY, member as MB, scatter_accum as SA, \
        topk as TK
    return {"layer_fwd": (LY.fused_transformer_layer, "launches"),
            "lastq_fwd": (LY.fused_last_query_layer, "launches"),
            "blockmax": (TK.catalog_blockmax, "launches"),
            "blockmax_int8": (TK.catalog_blockmax, "launches_int8"),
            "layer_bwd": (LY.layer_bwd, "launches"),
            "lastq_bwd": (LY.lastq_bwd, "launches"),
            "scatter_add": (SA.scatter_add_rows, "launches"),
            "member": (MB.member_mask, "launches")}


SERVING_KERNELS = ("layer_fwd", "lastq_fwd", "blockmax", "blockmax_int8")
TRAINING_KERNELS = ("layer_fwd", "lastq_fwd", "layer_bwd", "lastq_bwd",
                    "scatter_add", "member")


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


def check_main_path(torch, model, cfg, users, history, modes, results):
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
    du, checks = 0.0, {n: {"valid": True, "identical_rows": 0,
                           "identical_to_plain_run": 0} for n in modes}
    for start, batch in zip(range(0, SERVE_USERS, BATCH),
                            iter_infer_batches(cfg, users, history, True)):
        n = batch.pop("n_real")
        tb = to_device(batch, "cuda", torch.int64)
        u_k = model.user_emb(tb)[:n].float()
        with plain_versions():
            u_p = model.user_emb(tb)[:n].float()
        du = max(du, float((u_k - u_p).abs().max()))
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
    emit({"phase": "main_path_check", "user_emb_max_abs_diff": du,
          "user_emb_tol": LN_TOL["bfloat16"], **checks})
    if du > LN_TOL["bfloat16"] or not all(c["valid"] for c in checks.values()):
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
        emit(line)
        if not (line["max_abs_err"] <= line["tol"] and line["finite"]):
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
        emit(line)
        if not (line["max_rel_err"] <= BWD_TOL and line["finite"] and zero_sum_ok(zeros)):
            raise AssertionError(f"{which}_bwd disagrees with its plain version")
        rows[f"{which}_bwd"] = line
        del dx, grads, rdx, rgrads
    return rows


def kernel_scatter(torch):
    """The embedding-grad scatter-add at the step's two shapes: the item_seq
    gather's [B*L, 64] and the candidates' [B*10, 64] bf16 gradient rows
    into [50,000, 64]; index_add_ is the library yardstick."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    out = None
    for M in (TRAIN_BATCH * SEQ_LEN, TRAIN_BATCH * (1 + N_NEG)):
        ids = torch.randint(0, N_ITEMS, (M,), generator=g, device="cuda", dtype=torch.int32)
        rows = (torch.randn(M, EMB, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
        acc = SA._scatter_cuda(ids, rows, N_ITEMS)
        ref = SA._scatter_plain(ids, rows, N_ITEMS)
        lib_ids = ids.long()
        lib = lambda: torch.zeros(N_ITEMS, EMB, device="cuda").index_add_(  # noqa: E731
            0, lib_ids, rows.float()).to(torch.bfloat16)
        torch.cuda.synchronize()
        err = float((acc.float() - ref.float()).abs().max())
        tol = 8e-3 * float(ref.float().abs().max())
        line = {"phase": "kernel", "name": "scatter_add", "rows": M, "table": [N_ITEMS, EMB],
                "dtype": "bfloat16", "max_abs_err": err, "tol": tol,
                "tol_reason": "f32 atomics in run-dependent order, one bf16 rounding "
                              "of the sum (2^-7 relative, doubled)",
                "kernel_ms": cuda_ms(lambda: SA._scatter_cuda(ids, rows, N_ITEMS)),
                "plain_ms": cuda_ms(lambda: SA._scatter_plain(ids, rows, N_ITEMS)),
                "library_ms": cuda_ms(lib)}
        line["bound_ms"], line["bound_by"] = bound_ms(nbytes(ids, rows, acc), M * EMB,
                                                      "float32")
        emit(line)
        if not err <= tol:
            raise AssertionError("scatter_add disagrees with its plain version")
        out = out or line  # the item_seq gather's, the larger of the two
    return out


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
    """Run fn under torch.profiler: (wall ms, device busy ms, top device ops)."""
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
    return {"traced_device_ops": len(ops), "wall_ms": wall * 1e3,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / (wall * 1e3),
            "top_device_ops": [{"op": k[:90], "ms": us / 1e3, "calls": c}
                               for us, k, c in ops[:14]]}


def profile_train_path(torch, trainer, raw, card):
    from unirec_tpu_torch.utils import to_device
    batches = [to_device(b, "cuda") for _, b in zip(range(2), iter(raw))]
    torch.cuda.synchronize()
    emit({"phase": "train_path_profile", "steps": 2, "batch": TRAIN_BATCH,
          **device_profile(torch, lambda: [trainer.train_step(b) for b in batches]),
          "card": card})


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
    card = smi_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in logs.items()}})
    for name, v in logs.items():
        for ln in str(v["log"]).splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}", flush=True)

    rows = {}
    with torch.no_grad():
        rows["layer_fwd"] = kernel_layer(torch, "bfloat16")
        kernel_layer(torch, "float32")
        for act in ("relu", "gelu", "tanh", "sigmoid"):
            for causal in (True, False):
                kernel_layer(torch, "float32", act, causal, timed=False)
        kernel_layer(torch, "bfloat16", "gelu", False, timed=False)
        rows["lastq_fwd"] = kernel_lastq(torch, "bfloat16")
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
    rows["scatter_add"] = kernel_scatter(torch)
    rows["member"] = kernel_member(torch)
    torch.cuda.empty_cache()
    train_counts, _, trainer, raw, aug = train_path(torch, card)
    check_train_path(torch, trainer, raw, aug)
    profile_train_path(torch, trainer, raw, card)

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
               "member": ("unirec_tpu_torch/csrc/member.cu",
                          "unirec_tpu/ops/member.py:32")}
    kernels = []
    for name, (src, rep) in sources.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts.get(name, 0) + train_counts.get(name, 0),
            "launches_by_path": {"serving": counts.get(name, 0),
                                 "training": train_counts.get(name, 0)},
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
