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
  4. the main path: a bench-width SASRec (2 layers, d=64, 2 heads, inner
     128, L=50, 50,000 items; random weights from a seed, saved and loaded
     as a checkpoint) serves top-100 to a few thousand users of a synthetic
     100,000-user history through reco_topk.get_topk_recommendations, with
     a bf16 catalog and then an int8 one. Every kernel's launch count must
     rise in that run, and the ids must agree with the same model run
     through the plain versions on the card.
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
def synthetic_history():
    """bench.py's recipe: 100,000 users with 10..200 random items each."""
    from unirec_tpu_torch.data.history import UserHistory
    rng = np.random.default_rng(SEED)
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
    from unirec_tpu_torch.ops import layer as LY, topk as TK
    with mock.patch.object(LY, "_layer_fwd_cuda", LY._layer_fwd_plain), \
            mock.patch.object(LY, "_lastq_fwd_cuda", LY._lastq_fwd_plain), \
            mock.patch.object(TK, "_blockmax_cuda", TK._blockmax_plain):
        yield


def launch_counts():
    from unirec_tpu_torch.ops import layer as LY, topk as TK
    return {"layer_fwd": LY.fused_transformer_layer.launches,
            "lastq_fwd": LY.fused_last_query_layer.launches,
            "blockmax": TK.catalog_blockmax.launches,
            "blockmax_int8": TK.catalog_blockmax.launches_int8}


def reset_counts():
    from unirec_tpu_torch.ops import layer as LY, topk as TK
    LY.fused_transformer_layer.launches = 0
    LY.fused_last_query_layer.launches = 0
    TK.catalog_blockmax.launches = 0
    TK.catalog_blockmax.launches_int8 = 0


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
    counts = launch_counts()
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
    from unirec_tpu_torch.main.infer_embedding import iter_infer_batches, to_device
    from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
    from unirec_tpu_torch.ops import topk as TK
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
        tb = to_device(batch, "cuda")
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
    n = 4 * BATCH
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        get_topk_recommendations(cfg, model, users[:n], history, TOPK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side entries only (kernels, copies, sets); host ops would
    # count their kernels a second time
    ops = sorted(((float(e.self_device_time_total), e.key, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(us for us, _, _ in ops) / 1e3
    emit({"phase": "main_path_profile", "users": n, "traced_device_ops": len(ops),
          "wall_ms": wall * 1e3,
          "device_busy_ms": busy, "device_idle_share": 1 - busy / (wall * 1e3),
          "top_device_ops": [{"op": k[:90], "ms": us / 1e3, "calls": c}
                             for us, k, c in ops[:12]], "card": card})


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

    sources = {"layer_fwd": ("unirec_tpu_torch/csrc/layer_fwd.cu",
                             "unirec_tpu/ops/layer.py:279"),
               "lastq_fwd": ("unirec_tpu_torch/csrc/lastq_fwd.cu",
                             "unirec_tpu/ops/layer.py:589"),
               "blockmax": ("unirec_tpu_torch/csrc/blockmax.cu",
                            "unirec_tpu/ops/topk.py:225"),
               "blockmax_int8": ("unirec_tpu_torch/csrc/blockmax.cu",
                                 "unirec_tpu/ops/topk.py:236")}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name], "max_abs_err": rows[name]["max_abs_err"],
                "ms": rows[name]["kernel_ms"], "plain_ms": rows[name]["plain_ms"],
                "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
                "library_ms": rows[name]["library_ms"]}
               for name, (src, rep) in sources.items()]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
