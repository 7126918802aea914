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
     CUDA-core body timed in turns beside it (no gate at this batch); the
     catalog block-max (rows 5, 5q) over 50,000 and 1,000,000 items, bf16
     and int8, in its tensor-core body, its CUDA-core body timed in turns
     by the card's clock (traced_kernel_ms: these calls take microseconds,
     where CUDA events read the host's launch pace), at least 1.5x slower;
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
     test (its warp body against its block body, in turns by the card's
     clock, at least 1.5x faster), each against its plain version with the
     same inputs and dropout seeds, and timed; both layers' forwards and backwards in their bf16
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
     then the JAX package's opt-in XLA variants (opt_in_variants): one step
     of the same configuration under each embedding-gradient path
     (scan_embedding_grad, sorted_embedding_grad, expand_embedding_grad=4,
     embedding_grad_f32) against the default step through the plain
     versions, qkv_packed against its own step through the plain versions,
     and remat_attention against the step without it (the gradients equal
     within f32 atomics' order; rows 1 and 3 launched twice, the forward
     and the backward's recompute with the forward's dropout seeds);
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
     beside them; row 7 (scatter_add_rows2) on the item_seq ids; the
     membership test on that step's own (rows, cand), its warp body against
     its block body as above; and a traced step and eval batch; the
     tensor-core bodies of the attention pair and of both FFN directions,
     the sorted-tile scatter and the warp membership body must launch there;
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
     2 epochs of 200 steps with one-vs-all validation before each: the best
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
 11. the popularity and session path (pop_session_path): main.run(task=train)
     on bench.py's training configuration (phase 6's options, batch 32,768)
     with popularity negatives (neg_by_pop_alpha 1, the alias table on the
     device), multi-positive one-vs-all validation (T5 rows, each user's
     next 3 items), a session-wise test (T2_1: 8,192 sessions of the next
     item and 9 popularity-drawn negatives) and TensorBoard, over synthetic
     data at the entry path's scale whose walk groups are drawn by a Zipf
     law (skewed popularity); 2 epochs of 200 steps: the loss falls, the
     best validation's hit@10 reaches 0.1, task=test from the best
     checkpoint under profile=1 repeats the metrics, the TensorBoard
     events hold train/loss and valid/<key metric> at every epoch and the
     trace names rows 1 and 3's kernels; rows 1-4, 6 and 8 launch in
     training and rows 1 and 3 in the evaluations, every launch on its
     tensor-core, sorted or warp body (POP_BODIES). Then
     (pop_session_check) the share of negative slots left at 0 in one
     batch, the augmenter's popularity draws against its alias table's
     probabilities (total variation under 0.02), one validation batch
     through the kernels and the plain versions (as entry_path_check's
     eval batch), row 8 on the batch's own (rows, cand), and a traced
     step and validation batch (pop_session_profile).
 12. the sequential family (seq_family_path): main.run(task=train) of GRU,
     AvgHist, AttHist, SVDPlusPlus, ConvFormer and FASTConvFormer at
     examples/more-examples/run_seq_benchmark.sh's options (d=256, L=50,
     BCE with 19 negatives, autoregressive histories, each model's YAML
     keys) in f32 at batch 400 on the entry path's data, 12 epochs of 50
     steps at learning rate 3e-3 (AttHist 1e-2), 2,048 validation and test
     users: the loss is finite and falls (the BCE stays finite where the
     sigmoid rounds to 1.0, ops/losses.py::bce_loss), the best hit@10
     reaches ten times chance, task=test from the best checkpoint
     repeats the metrics, row 6 launches once for each table gather of
     every step on its sorted body (two a step; SVD++ three, its user and
     second item tables); one step's loss and gradients through the
     kernels against the plain versions (seq_family_check, ConvFormer's
     dropout by its keep rate), then row 6 on that SVD++ step's three
     calls at d=256 f32 (traced, index_add_ beside it);
 13. the item side inputs (side_inputs_path): bench.py's training options
     (phase 11's, uniform negatives) with two categorical feature fields
     (64 and 16 ids, a .tsv), 768-wide frozen text rows (a text file of
     50,000 rows, its write and load timed apart) and 64 time buckets on T6
     histories, through main.run for 2 epochs of 200 steps with one-vs-all
     validation and test: the pop_session gates, rows 1-4, 6 and 8 in
     training on their new bodies; then reco-topk (do_topk_reco, fused,
     bf16 catalog) of 4,096 users from the best checkpoint: rows 1, 3 and 5
     launch, every row valid and the ids against the plain versions
     (side_serve_check); then (mlp_scorer_check) Trainer.fit for 20 steps
     with distance_type mlp and one-vs-k validation and test (19
     negatives): the loss falls, one batch's scores against the plain
     versions.
 14. the CF models (cf_path): synthetic walks at amazon-book.yaml's scale
     (52,644 users, 91,600 items, 4,096 validation and test users); MF by
     train_mf_bpr.sh (BPR, 19 negatives, d=64, batch 2,048, the device
     pipeline with neg_membership_pallas; 2 epochs of 100 steps), then
     reco-topk of 4,096 users from its best checkpoint over the fused
     bf16 and int8 catalogs (mf_serve, mf_serve_check); MultiVAE at
     MultiVAE.yaml's widths by train_cf_model.sh (AERecDataset, full
     softmax, batch 1,024, 5 evaluation draws; 2 epochs of 52 steps); each
     through main.run with the shared gates (finite falling loss, best
     validation hit@10 at least ten times chance, task=test from the best
     checkpoint equal), one step through the kernels against the plain
     versions (cf_path_check) and a traced step (cf_path_profile); rows 6
     and 8 launch in MF's training (8 on its block body: 76 candidates an
     example), 5 and 5q in its serving, 6 in MultiVAE's;
 15. rows 10-13 at BST's shape (8,400 sequences of L = 21, 4 heads of 16,
     the [N, 1, 1, L] key-padding mask; the FFN at d = 64, inner 128) in
     f32 and bf16 against their plain versions, timed beside their bounds
     and scaled_dot_product_attention (addmm -> silu -> addmm for row 12);
 16. the ranking models (rank_path): prepare-adaranker through the port's
     CLI (with item2vec) on a synthetic raw file at ml-10m-adaranker.yaml's
     catalog, then AdaRanker's three stages (Base, Ada-Ranker, Ada-Ranker
     fine-tuned from the Base checkpoint) by run_adaranker_pipeline.sh; BST
     by run_bst_beauty_rank.sh at Beauty-rank.yaml's scale with
     use_fused_attention and use_fused_ffn, then task=infer; FM by
     run_fm_beauty_libfm.sh on T7 rows at Beauty-libfm.yaml's 46,557
     features; each through main.run with the shared gates (best
     validation auc at least 0.65), a step
     against the plain versions (rank_path_check) and a traced step
     (rank_path_profile); row 6 launches in AdaRanker and BST, rows 10-13
     (tensor-core bodies) in BST's training and infer, no kernel in FM;
 17. approx_topk: reco-topk of 4,096 users from the serving checkpoint over
     the entry data's histories, exact and with topk_recall_target 0.95:
     the two CSVs equal byte for byte (exact selection; recall 1.0), row 5
     launched;
 18. MoRec (morec_path): MF at amazon-electronics.yaml's width (103,317
     users, 39,575 items) on synthetic walks with an item_meta_morec.csv
     and an align_dist file from the seed; a base by run_base_model.sh
     (BPR; the family's gates), then run_morec_electronics.sh's fine-tune
     (the PI gains and beta band, fairness, alignment and revenue) once with
     PID and once with Pareto (MGDA): finite losses, beta inside its band,
     the sampler's block weights summing to 1 and moving between epochs,
     task=test from the best checkpoint equal, hit@10 at least ten times
     chance, row 6 launched exactly once a table in each objective's
     backward (one a PID step, four an MGDA step); morec_check: one batch's
     loss vector and Gram kernels against plain (1e-4 of the largest
     entry) and an MGDA step's parts timed; a traced step of each;
 19. the closed-form solvers (solver_path; no kernel, plain torch ops and
     torch.linalg in full f32): synthetic splits at gowalla.yaml's size
     (29,859 users, 40,982 items) through the port's convert-adjacency, one
     text table through fastio and pandas (equal frames), then EASE (the
     blocked inverse tier), AdmmSLIM (5 of its 100 iterations), SLIM (its
     active set, K = 256), SAR and UserCF through main.run at
     train_cf_model.sh's options, each timed by part against its f32 flop
     bound, best validation hit@10 at least ten times chance; task=test
     from EASE's and UserCF's .solver.pkl equal; |G P - I| on 256 of
     EASE's columns; EASE's LU tier on 8,000 items against the blocked
     one, SLIM's full descent on 2,000 items (10 of its 30 sweeps) and one
     sweep timed on 4,096
     (solver_tiers); the card against the port's CPU run on a cut of 8,192
     users and 2,000 items (solver_path_check); then cli sweep of SAR's
     edge_norm on a cut of 8,192 users and items; no kernel launches. The
     export of phase 20 compiles in a process of its own meanwhile;
 20. the serving export (export_path): the serving checkpoint's user_emb,
     item_emb and score through torch.export (a symbolic batch), each .pt2
     program on the card against the live model through the kernels and
     through the plain versions (emb_tol), rows 1 and 3 recorded as
     unirec::layer_fwd and unirec::lastq_fwd and launched; the score
     functions of the serving, entry (sasrec_fusedattn_ffn: rows 10 and 12)
     and long (sasrec_long256_flash, L=256: rows 9 and 12) checkpoints as
     AOTInductor packages at batch 256 (three export processes started
     beside phase 19), each served by the C++ client (g++ against the
     installed libtorch, built from the script's first minute), whose
     output equals the program's and the plain versions' (emb_tol) and
     whose printed launches are, a call, one of rows 1, 3, 9 and 10 and two
     of row 12 (one an FFN layer), on the tensor-core bodies the Python
     launchers pick; users/s of the client, the program and the package in
     Python at batch 256 beside reco-topk's; the entry checkpoint's
     user_emb program, rows 10 and 12 recorded and launched, held the same
     way;
 21. distribution (dist_path): main.run(task=train) at bench.py's training
     configuration (dropout 0, the steps of phase 6) first without a
     process group, then inside an NCCL group of one that the script brings
     up, at mesh_data=1 (the port's distributed branch: one all-reduce of
     the gradients and the loss, global loss denominators, dropout keyed
     by global example): every step's loss and the rolling checkpoint
     equal (BWD_TOL), rows 1-4, 6 and 8 on their new bodies, examples/s
     beside phase 6's; two gloo ranks on the one card (subprocesses of
     this script, ``--dist-rank``) at mesh_model=2 with shard_embeddings
     (batch 8,192, 3 steps; the item table row-sharded, its lookups summed
     over the ranks and its backward through row 6) against the same steps
     on one rank, their .dcp checkpoint reloaded in this process; MoRec
     at mesh_data=2 (dist_morec): two gloo ranks each run main.run of
     phase 18's base (BPR through the device pipeline: rows 6 and 8) and
     of its PID and MGDA fine-tunes from its base checkpoint, 3 steps each
     (batch_size 1,023 rounded up to 1,024 so no objective block is split)
     against one rank: step 1's loss vector and Gram (summed over the
     ranks) within 1e-4 of their largest entry, each step's loss within
     1e-4, both ranks bit-equal; then reco-topk of 4,096 users from a 50,002-item checkpoint over 4 logical
     shards (local_shard_topk + merge_shard_candidates; 2 padded rows in
     the last shard), bf16 and int8, rows 5 and 5q once a shard a batch,
     the ids against the unsharded run and the dense plain top-k, and the
     same at 1M items timed beside the unsharded top-k.
Every launch of rows 5, 5q and 8 on the serving, training, entry, long
and long-serving paths must be on the new bodies (NEW_BODIES), and of rows
5 and 5q on the CF path. Then it
prints its wall time (and each of phases 9-21), the card, one
{"kernels": [...]} line and, last, {"ok": true, ...}.
It exits non-zero, without the "ok" line, when any phase fails, when no CUDA
card is visible, or when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import shutil
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


class TraceDropped(AssertionError):
    """traced_kernel_ms saw fewer than half of a window's launches in every
    window it traced."""


def traced_kernel_ms(fn, kernel: str, iters: int = 50, warmup: int = 3,
                     attempts: int = 4) -> float:
    """The device time of one launch of the port's kernel ``kernel`` (its
    function's name in csrc/) inside fn, by the card's own clock: fn runs
    ``iters`` times under torch.profiler, and the kernel's summed device time
    is divided by its launches there (one a call). The tracer now and then
    drops records, some or all of a window's: a window that holds fewer than
    half of them is traced again, up to ``attempts`` windows, each retry
    twice as long as the last and opened by a millisecond's device sleep
    (a kernel of another name) before the first counted call. CUDA events
    around back-to-back calls of a kernel of some microseconds read the
    host's pace of launching them instead (cuda_ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    marks = (f"::{kernel}<", f"::{kernel}(")
    seen = []
    for attempt in range(attempts):
        n = iters << attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if attempt and hasattr(torch.cuda, "_sleep"):
                torch.cuda._sleep(2_000_000)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and any(m in e.key for m in marks)]
        calls = sum(e.count for e in hits)
        seen.append((calls, n))
        if n // 2 <= calls <= n:
            return sum(float(e.self_device_time_total) for e in hits) / calls / 1e3
    raise TraceDropped(f"{kernel}: (traced launches, calls) in each window: {seen}")


def traced_timer(kernels):
    """A ``timer`` for bodies_in_turns: each body's kernel (``kernels`` maps
    "own" and the other body's name to their csrc/ function names) timed by
    traced_kernel_ms."""
    return lambda body, fn, iters, warmup: traced_kernel_ms(fn, kernels[body], iters, warmup)


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
                    other_iters=3, timer=None):
    """The kernel's time in its own body and in its older body (the CUDA-core
    one, or ``other``), timed in turns (own, other, then other, own, ...) so
    that both meet the card at the same clocks. The own body's median goes
    to line["kernel_ms"], every run's time to line["in_turns_ms"]; returns
    the other body's median. ``selector`` names the function of ``module``
    (ops/layer.py unless given) that picks the body; ``run`` launches the
    kernel; ``timer(body, fn, iters, warmup)`` times it ("own" or ``other``;
    CUDA events unless given, traced_timer for calls of some microseconds)."""
    if module is None:
        from unirec_tpu_torch.ops import layer as module
    if timer is None:
        timer = lambda body, fn, iters, warmup: cuda_ms(fn, iters, warmup)  # noqa: E731
    times = {"own": [], other: []}
    for r in range(rounds):
        for body in ("own", other) if r % 2 == 0 else (other, "own"):
            with (mock.patch.object(module, selector, lambda *a: other) if body == other
                  else nullcontext()):
                times[body].append(timer(body, run, mma_iters, 3) if body == "own"
                                   else timer(body, run, other_iters, 1))
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


# the csrc/ functions of each body, for traced_kernel_ms
BLOCKMAX_KERNELS = {"own": "blockmax_mma_kernel", "cuda": "blockmax_kernel"}
MEMBER_KERNELS = {"own": "member_warp_kernel", "block": "member_kernel"}
NEW_BODY_GATE = 1.5   # rows 5, 5q and 8: the new body at least this much faster


def kernel_blockmax(torch, n_items, dtype_name, int8=False):
    """Rows 5 and 5q at the serving batch: the body the path takes against
    the plain version; on bf16 users (the tensor-core body) the CUDA-core
    body too, both timed by the card's clock in turns (the new body at least
    NEW_BODY_GATE times faster), the events' time beside them."""
    from unirec_tpu_torch.ops import topk as TK
    u, it = catalog(torch, n_items, dtype_name, SEED + 2)
    scale = None
    if int8:
        it, scale = TK.quantize_catalog(it)
    run = lambda: TK._blockmax_cuda(u, it, scale)  # noqa: E731
    bm = run()
    ref = TK._blockmax_plain(u, it, scale)
    body = TK._blockmax_body(u.dtype, it.dtype, u.shape[1])
    old = None
    if body == "mma":
        with mock.patch.object(TK, "_blockmax_body", lambda *a: "cuda"):
            old = run()
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
            "body": body, "max_abs_err": err, "tol": tol,
            "plain_ms": cuda_ms(lambda: TK._blockmax_plain(u, it, scale)),
            "library_ms": cuda_ms(lib)}
    line["bound_ms"], line["bound_by"] = bound_ms(
        nbytes(u, it, bm, *([scale] if int8 else [])), flops, peak)
    ok = err <= tol
    if old is None:
        line["kernel_ms"] = cuda_ms(run)
    else:
        line["event_ms"] = cuda_ms(run)
        core = bodies_in_turns(line, "_blockmax_body", run, 50, module=TK, other="cuda",
                               other_iters=20, timer=traced_timer(BLOCKMAX_KERNELS))
        line["cuda_core"] = {"max_abs_err": float((old - ref).abs().max()), "kernel_ms": core}
        line["cuda_core_over_mma"] = core / line["kernel_ms"]
        line["gate"] = NEW_BODY_GATE
        ok = (ok and line["cuda_core"]["max_abs_err"] <= tol
              and NEW_BODY_GATE * line["kernel_ms"] <= core)
    emit(line)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version or is slow: {line}")
    return line


def older_body_row(line, key, body):
    """The kernels-line row of a line's older body (``line[key]``): its own
    error and time beside the line's plain, bound and library numbers."""
    return {"body": body, **{k: line[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")}, **line[key]}


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


def write_checkpoint(torch, path: Path, n_items: int = N_ITEMS):
    from unirec_tpu_torch import config as config_mod
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint
    from unirec_tpu_torch.utils.flax_bridge import to_flax_params
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = config_mod.parse_arguments({
        "model": "SASRec", "n_users": N_USERS, "n_items": n_items,
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
            "blockmax_mma": (TK.catalog_blockmax, "launches_mma"),
            "blockmax_int8_mma": (TK.catalog_blockmax, "launches_int8_mma"),
            "layer_bwd": (LY.layer_bwd, "launches"),
            "layer_bwd_mma": (LY.layer_bwd, "launches_mma"),
            "lastq_bwd": (LY.lastq_bwd, "launches"),
            "lastq_bwd_mma": (LY.lastq_bwd, "launches_mma"),
            "scatter_add": (SA.scatter_add_rows, "launches"),
            "scatter_add_sorted": (SA.scatter_add_rows, "launches_sorted"),
            "member": (MB.member_mask, "launches"),
            "member_warp": (MB.member_mask, "launches_warp")}


# *_mma: the bf16 tensor-core bodies of rows 1-5q; scatter_add_sorted: row 6's
# sorted-tile body; member_warp: row 8's warp body
SERVING_KERNELS = ("layer_fwd", "layer_fwd_mma", "lastq_fwd", "lastq_fwd_mma", "blockmax",
                   "blockmax_int8", "blockmax_mma", "blockmax_int8_mma")
TRAINING_KERNELS = ("layer_fwd", "layer_fwd_mma", "lastq_fwd", "lastq_fwd_mma", "layer_bwd",
                    "layer_bwd_mma", "lastq_bwd", "lastq_bwd_mma", "scatter_add",
                    "scatter_add_sorted", "member", "member_warp")
# *_mma: the bf16 tensor-core bodies of rows 10, 11 (L <= 64) and 12, 13 (D <= 64)
ENTRY_KERNELS = ("fused_attention", "fused_attention_mma", "fused_attention_bwd",
                 "fused_attention_bwd_mma", "fused_ffn", "fused_ffn_mma", "fused_ffn_bwd",
                 "fused_ffn_bwd_mma", "scatter_add", "scatter_add_sorted", "member",
                 "member_warp")
LONG_KERNELS = ("flash_attention", "fused_ffn", "fused_ffn_mma", "fused_ffn_bwd",
                "fused_ffn_bwd_mma", "scatter_add", "scatter_add_sorted", "member",
                "member_warp")
# (kernel, its new body's counter): every launch of rows 5, 5q and 8 on the
# paths must be on the new body
NEW_BODIES = (("blockmax", "blockmax_mma"), ("blockmax_int8", "blockmax_int8_mma"),
              ("member", "member_warp"))
OFF_LONG_PATH = ("layer_fwd", "layer_bwd", "lastq_fwd", "lastq_bwd", "fused_attention",
                 "fused_attention_bwd")


def launch_counts(names):
    return {n: getattr(*_counters()[n]) for n in names}


def reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def on_new_bodies(path, counts, pairs=NEW_BODIES):
    """Raise unless every launch of a kernel of ``pairs`` (kernel, its new
    body's counter; NEW_BODIES unless given) in ``counts`` was on its new
    body."""
    off = {k: (counts[k], counts[n]) for k, n in pairs
           if k in counts and counts[k] != counts.get(n)}
    if off:
        raise AssertionError(f"{path}: launches (all, new body) off the new bodies: {off}")


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
    on_new_bodies("main path", counts)

    # correctness: shape/range/history, and agreement with the plain versions
    with torch.no_grad():
        check_main_path(torch, model, cfg, users, history, modes, results)
    profile_main_path(torch, model, modes["bf16"], users, history, card)
    return counts


def check_main_path(torch, model, cfg, users, history, modes, results,
                    phase="main_path_check", n_items=N_ITEMS, is_seqrec=True):
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
                            iter_infer_batches(cfg, users, history, is_seqrec)):
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
            if ids.shape != (n, TOPK) or int(ids.min()) < 1 or int(ids.max()) >= n_items:
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


def scatter_line(torch, ids, rows, what, gate=None, n_rows=N_ITEMS, traced=False):
    """One line of row 6: the sorted-tile body against the plain version and
    timed in turns with the per-row body (which must agree as well), the plain
    version and index_add_ (the library call) beside them, and the ids' share
    of id 0 and largest multiplicity. Both bodies are held to the plain
    version on the table's largest element and element by element
    (``scatter_elementwise``). With ``gate`` the sorted body must beat the
    per-row one that many times. The table is [n_rows, rows' width] in the
    rows' dtype; ``traced``: both bodies timed by the card's clock (calls of
    some microseconds), or by events where the tracer keeps dropping the
    records (``trace_dropped`` in the line)."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    M, D = ids.shape[0], rows.shape[1]
    acc = SA._scatter_cuda(ids, rows, n_rows)
    ref = SA._scatter_plain(ids, rows, n_rows)
    with mock.patch.object(SA, "_scatter_body", lambda *a: "per_row"):
        old = SA._scatter_cuda(ids, rows, n_rows)
    lib_ids = ids.long()
    lib = lambda: torch.zeros(n_rows, D, device="cuda").index_add_(  # noqa: E731
        0, lib_ids, rows.float()).to(rows.dtype)
    torch.cuda.synchronize()
    err = float((acc.float() - ref.float()).abs().max())
    tol = 8e-3 * float(ref.float().abs().max())
    valid = lib_ids[(lib_ids >= 0) & (lib_ids < n_rows)]
    line = {"phase": "kernel", "name": "scatter_add", "ids": what, "rows": M,
            "table": [n_rows, D], "dtype": str(rows.dtype).replace("torch.", ""),
            "id0_share": float((ids == 0).float().mean()),
            "max_id_multiplicity": int(torch.bincount(valid, minlength=n_rows).max()),
            "body": SA._scatter_body(rows.dtype, D, n_rows),
            "max_abs_err": err, "tol": tol,
            "tol_reason": "f32 atomics in run-dependent order, one bf16 rounding "
                          "of the sum for bf16 rows (2^-7 relative, doubled)",
            "plain_ms": cuda_ms(lambda: SA._scatter_plain(ids, rows, n_rows)),
            "library_ms": cuda_ms(lib)}
    line["bound_ms"], line["bound_by"] = bound_ms(nbytes(ids, rows, acc), M * D, "float32")

    def in_turns(timer, other_iters):
        return bodies_in_turns(line, "_scatter_body", lambda: SA._scatter_cuda(ids, rows, n_rows),
                               20, module=SA, other="per_row", other_iters=other_iters,
                               timer=timer)

    line["timed_by"] = "events"
    if traced:
        try:
            per_row = in_turns(traced_timer(SCATTER_KERNELS), 20)
            line["timed_by"] = "trace"
        except TraceDropped as e:     # timed by events, and said so
            line["trace_dropped"] = str(e)
    if line["timed_by"] == "events":
        per_row = in_turns(None, 5)
    line["per_row"] = {"max_abs_err": float((old.float() - ref.float()).abs().max()),
                       "kernel_ms": per_row}
    line["per_row_over_sorted"] = per_row / line["kernel_ms"]
    line["elementwise_worst"], line["per_row"]["elementwise_worst"] = scatter_elementwise(
        torch, (acc, old), ids, rows, n_rows)
    line["gate"] = gate
    emit(line)
    if not (err <= tol and line["per_row"]["max_abs_err"] <= tol and line["body"] == "sorted"
            and line["elementwise_worst"] <= 1.0
            and line["per_row"]["elementwise_worst"] <= 1.0
            and (gate is None or gate * line["kernel_ms"] <= per_row)):
        raise AssertionError(f"scatter_add ({what}) failed its checks: {line}")
    return line


# csrc/scatter_add.cu's functions of the two bodies, for traced timing
SCATTER_KERNELS = {"own": "scatter_sorted_kernel", "per_row": "scatter_add_kernel"}


def scatter_elementwise(torch, outs, ids, rows, n_rows=N_ITEMS):
    """Each output against the plain version element by element, as the card
    tests hold it: 1e-4 of the largest gradient element, plus 2e-5 of the sum
    of the magnitudes added into the element (f32 sums in another order),
    plus one bf16 rounding of the sum (2^-7 of it). Returns, for each output,
    the worst element's error over its tolerance (at most 1 to pass)."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    ref = SA._scatter_plain(ids, rows, n_rows).float()
    mag = SA._scatter_plain(ids, rows.float().abs(), n_rows)
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
def call_capture(module, name, store):
    """Record the tensor arguments of every call of module.<name> (a kernel
    wrapper such as scatter_accum._scatter_cuda or member._member_cuda; not
    the plain versions' calls) made inside, as detached copies."""
    real = getattr(module, name)

    def spy(*args):
        store.append(tuple(a.detach().clone() if hasattr(a, "detach") else a for a in args))
        return real(*args)
    with mock.patch.object(module, name, spy):
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
            for (ids, g, _), what in zip(calls, ("item_seq", "candidates"))}


def kernel_scatter2(torch, ids, rows):
    """Row 7: scatter_add_rows2 (the JAX package's two-accumulator entry,
    through row 6's kernel) on the entry path's item_seq ids and gradient
    rows into an even table (N_ITEMS + 1 rounded up to even), against the
    plain version on the table's largest element and element by element
    (``scatter_elementwise``); the call must launch the kernel once.
    index_add_ is the library call."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    n = N_ITEMS + 1 + (N_ITEMS + 1) % 2
    ids = ids.to(torch.int32)
    before = SA.scatter_add_rows.launches
    acc = SA.scatter_add_rows2(ids, rows, n)
    launched = SA.scatter_add_rows.launches - before
    ref = SA._scatter_plain(ids, rows, n)
    torch.cuda.synchronize()
    lib_ids = ids.long()
    lib = lambda: torch.zeros(n, EMB, device="cuda").index_add_(  # noqa: E731
        0, lib_ids, rows.float()).to(torch.bfloat16)
    err = float((acc.float() - ref.float()).abs().max())
    tol = 8e-3 * float(ref.float().abs().max())
    line = {"phase": "kernel", "name": "scatter_add2", "ids": "entry item_seq",
            "rows": ids.shape[0], "table": [n, EMB], "dtype": "bfloat16",
            "launches_in_call": launched, "max_abs_err": err, "tol": tol,
            "tol_reason": "as row 6's lines",
            "elementwise_worst": scatter_elementwise(torch, (acc,), ids, rows, n)[0],
            "kernel_ms": cuda_ms(lambda: SA.scatter_add_rows2(ids, rows, n)),
            "plain_ms": cuda_ms(lambda: SA._scatter_plain(ids, rows, n)),
            "library_ms": cuda_ms(lib)}
    line["bound_ms"], line["bound_by"] = bound_ms(nbytes(ids, rows, acc), ids.shape[0] * EMB,
                                                  "float32")
    emit(line)
    if not (launched == 1 and err <= tol and line["elementwise_worst"] <= 1.0):
        raise AssertionError(f"scatter_add_rows2 failed its checks: {line}")
    return line


def member_line(torch, rows, cand, what):
    """One line of row 8 on (rows, cand): the body the call takes against
    the plain version, exact, timed by the card's clock beside the events'
    time; the share of candidates found in their history (hit_share) and of
    padding ids in the histories (zero_share). Up to 64 candidates an
    example the warp body runs, timed in turns with the block body (which
    must agree as well; the warp body at least NEW_BODY_GATE times faster);
    more, and the block body runs, the only one that takes them."""
    from unirec_tpu_torch.ops import member as MB
    run = lambda: MB._member_cuda(rows, cand)  # noqa: E731
    out = run()
    ref = MB._member_plain(rows, cand)
    body = MB._member_body(rows.shape[1], cand.shape[1])
    torch.cuda.synchronize()
    line = {"phase": "kernel", "name": "member", "ids": what, "rows": list(rows.shape),
            "cand": list(cand.shape), "body": body, "mismatches": int((out != ref).sum()),
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            "tol": 0.0, "tol_reason": "exact", "hit_share": float(ref.float().mean()),
            "zero_share": float((rows == 0).float().mean()), "event_ms": cuda_ms(run),
            "plain_ms": cuda_ms(lambda: MB._member_plain(rows, cand)), "library_ms": None}
    # compares counted at the f32 CUDA-core rate
    line["bound_ms"], line["bound_by"] = bound_ms(
        nbytes(rows, cand, out), rows.numel() * cand.shape[1], "float32")
    if body == "block":
        line["kernel_ms"] = traced_kernel_ms(run, MEMBER_KERNELS["block"], iters=20, warmup=1)
        emit(line)
        if line["mismatches"] != 0:
            raise AssertionError(f"member ({what}) failed its checks: {line}")
        return line
    with mock.patch.object(MB, "_member_body", lambda *a: "block"):
        old = run()
    block = bodies_in_turns(line, "_member_body", run, 50, module=MB, other="block",
                            other_iters=20, timer=traced_timer(MEMBER_KERNELS))
    line["block"] = {"mismatches": int((old != ref).sum()),
                     "max_abs_err": float((old.float() - ref.float()).abs().max()),
                     "kernel_ms": block}
    line["block_over_warp"] = block / line["kernel_ms"]
    line["gate"] = NEW_BODY_GATE
    emit(line)
    if not (line["mismatches"] == 0 and line["block"]["mismatches"] == 0
            and NEW_BODY_GATE * line["kernel_ms"] <= block):
        raise AssertionError(f"member ({what}) failed its checks: {line}")
    return line


def kernel_member(torch):
    """Negative-rejection membership at bench shapes on synthetic ids:
    [B, 200] uniform histories without padding, [B, 36] candidates (9
    negatives x oversample 4), a third of them in the history."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows = torch.randint(0, N_ITEMS, (TRAIN_BATCH, HIST_CAP), generator=g,
                         device="cuda", dtype=torch.int32)
    cand = torch.randint(1, N_ITEMS, (TRAIN_BATCH, 4 * N_NEG), generator=g,
                         device="cuda", dtype=torch.int32)
    cand[:, ::3] = rows[:, :12]  # a third of the candidates are in the history
    return member_line(torch, rows, cand, "synthetic")


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
    on_new_bodies("train path", counts)
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


# The JAX package's opt-in XLA variants at bench.py's training configuration
# (train_config): the four embedding-gradient paths (ops/embedding.py, plain
# torch ops as XLA in JAX; the flags below them in the JAX precedence turn
# vmem_embedding_grad off), qkv_packed and remat_attention
OPT_IN = {"scan_embedding_grad": dict(scan_embedding_grad=1),
          "sorted_embedding_grad": dict(sorted_embedding_grad=1, vmem_embedding_grad=0),
          "expand_embedding_grad": dict(expand_embedding_grad=4, vmem_embedding_grad=0),
          "embedding_grad_f32": dict(embedding_grad_f32=1, vmem_embedding_grad=0),
          "qkv_packed": dict(qkv_packed=1)}
# remat against no remat, both through the kernels: every gradient leaf bit
# for bit, except the tables row 6 scatters into, whose f32 atomics sum in
# another order from run to run and whose sums are rounded to the table's
# bf16: one bf16 ulp of the leaf's largest entry
REMAT_TOL = 2.0 ** -8


def opt_in_variants(torch, card: str):
    """One training step at bench.py's configuration (batch 32,768, dropout
    0.1, bf16; the weights from SEED, one augmented batch, the same dropout
    seed) under each of OPT_IN: its loss and every gradient through the
    kernels against a plain counterpart (STEP_TOL bf16, each leaf to its own
    largest, a key bias to its query bias's): for an embedding-gradient
    variant the default step (vmem_embedding_grad) through the plain
    versions, its row-6 scatter an f32 index_add; for qkv_packed its own
    step through the plain versions. Then remat_attention: the step with
    each layer checkpointed against the step without, both through the
    kernels, every gradient within REMAT_TOL of its leaf's largest, the
    forward kernels of rows 1 and 3 launched twice (the forward and the
    backward's recompute, with the forward's dropout seeds), rows 2 and 4
    once; every leaf that row 6 does not scatter into equal bit for bit.
    Returns the launches of the kernel steps."""
    from unirec_tpu_torch.models.modules import DropoutRNG
    from unirec_tpu_torch.utils import to_device
    from unirec_tpu_torch.utils.registry import get_model_class
    t_phase = time.perf_counter()
    trainer, raw, aug = train_setup(torch)
    base = dict(trainer.config)
    del trainer
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    batch = aug.augment(to_device(next(iter(raw)), "cuda"), gen)

    def step(over, plain=False):
        cfg = dict(base, **over)
        model = get_model_class("SASRec")(cfg)
        model.init_weights(torch.Generator().manual_seed(SEED))
        model.to("cuda")
        params = list(model.parameters())
        with plain_versions() if plain else nullcontext():
            loss, _ = model(batch, train=True, rng=DropoutRNG(SEED + 23, "cuda"))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        names = [n for n, _ in model.named_parameters()]
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for g, p in zip(grads, params)], names

    def compare(got, ref, tol):
        (loss_k, grads_k, names), (loss_p, grads_p, _) = got, ref
        zero_sum = {i: names.index(n.replace("key.bias", "query.bias"))
                    for i, n in enumerate(names) if n.endswith("key.bias")
                    and n.replace("key.bias", "query.bias") in names}
        errs, zeros = leaf_errs(grads_k, grads_p, zero_sum)
        errs = dict(zip(names, errs))
        worst = max(errs, key=errs.get)
        return {"loss": float(loss_k), "loss_ref": float(loss_p),
                "loss_rel_diff": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
                "grad_max_rel_err": errs[worst], "grad_worst_leaf": worst, "grad_tol": tol,
                "unequal_leaves": [n for n, a, b in zip(names, grads_k, grads_p)
                                   if not torch.equal(a, b)],
                "leaves": len(errs), "zeros_ok": zero_sum_ok(zeros)}

    loss_tol, grad_tol = STEP_TOL["bfloat16"]
    lines, total, bad = {}, {}, []
    default_plain = step({}, plain=True)
    for name, over in OPT_IN.items():
        torch.cuda.synchronize()
        reset_counts()
        got = step(over)
        counts = launch_counts(TRAINING_KERNELS)
        add_counts(total, counts)
        ref = default_plain if name != "qkv_packed" else step(over, plain=True)
        line = compare(got, ref, grad_tol)
        line.update(launches={k: v for k, v in counts.items() if v})
        lines[name] = line
        # qkv_packed turns the fused layers off (as at modules.py:620, :634);
        # the embedding variants replace row 6
        off = ("layer_fwd", "layer_bwd") if name == "qkv_packed" else ("scatter_add",)
        if not (line["loss_rel_diff"] <= loss_tol and line["grad_max_rel_err"] <= grad_tol
                and line["zeros_ok"]) or any(counts[k] for k in off):
            bad.append(name)
    no_remat = step({})
    torch.cuda.synchronize()
    reset_counts()
    remat = step(dict(remat_attention=1))
    counts = launch_counts(TRAINING_KERNELS)
    add_counts(total, counts)
    line = compare(remat, no_remat, REMAT_TOL)
    line.update(launches={k: v for k, v in counts.items() if v})
    lines["remat_attention"] = line
    twice = {k: counts[k] for k in ("layer_fwd", "lastq_fwd", "layer_bwd", "lastq_bwd")}
    if not (line["loss_rel_diff"] == 0.0 and line["grad_max_rel_err"] <= REMAT_TOL) \
            or twice != {"layer_fwd": 2, "lastq_fwd": 2, "layer_bwd": 1, "lastq_bwd": 1} \
            or set(line["unequal_leaves"]) - {"item_embedding.weight"}:
        bad.append("remat_attention")
    emit({"phase": "opt_in_variants", "batch": TRAIN_BATCH, "dropout": P_DROP,
          "variants": lines, "loss_tol": loss_tol, "seconds": time.perf_counter() - t_phase,
          "card": card})
    if bad:
        raise AssertionError(f"opt_in_variants: {bad} disagree with their counterparts")
    return total


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


def slice_walks(rng, hist, group, extra, group_of=None, n_users=N_USERS, n_items=N_ITEMS):
    """Walk histories of users 1..n_users - 1 over n_items items (99,999
    and 50,000 unless given): user u has hist[0]..hist[1]-1 training items
    and ``extra`` held-out ones after them, walking the items of group
    ``group_of[u - 1]`` (u % ((n_items - 1) // group) when None; ``group`` consecutive ids, more than a history, so a
    walk never repeats an item) one id up at each step from a random start,
    wrapping inside the group; WALK_NOISE of the items are uniform over the
    catalog instead. Returns (users, n, starts, owner, items, is_train),
    each user's items at starts[u - 1] onwards."""
    users = np.arange(1, n_users)
    n = rng.integers(hist[0], hist[1], size=len(users))
    owner = np.repeat(users, n + extra)
    starts = np.concatenate([[0], np.cumsum(n + extra)[:-1]])
    pos = np.arange(len(owner)) - np.repeat(starts, n + extra)
    start = np.repeat(rng.integers(0, group, len(users)), n + extra)
    gid = owner % ((n_items - 1) // group) if group_of is None \
        else np.repeat(group_of, n + extra)
    walk = 1 + gid * group + (start + pos) % group
    items = np.where(rng.random(len(owner)) < WALK_NOISE,
                     rng.integers(1, n_items, len(owner)), walk)
    return users, n, starts, owner, items, pos < np.repeat(n, n + extra)


def write_train_tables(root: Path, rng, users, n, owner, items, is_train, rows,
                       formats, n_users=N_USERS, n_items=N_ITEMS) -> None:
    """user_history.pkl (user_id, item_seq: the training histories),
    train.pkl (``rows`` (user, item) pairs drawn from them) and data.info
    with the valid and test tables' ``formats``."""
    import json

    import pandas as pd
    root.mkdir(parents=True, exist_ok=True)
    seqs = np.split(items[is_train], np.cumsum(n)[:-1])
    pd.DataFrame({"user_id": users, "item_seq": seqs}).to_pickle(root / "user_history.pkl")
    pick = rng.choice(int(is_train.sum()), rows, replace=False)
    pd.DataFrame({"user_id": owner[is_train][pick],
                  "item_id": items[is_train][pick]}).to_pickle(root / "train.pkl")
    (root / "data.info").write_text(json.dumps({
        "n_users": n_users, "n_items": n_items, "train_file_format": "user-item",
        "valid_file_format": formats[0], "test_file_format": formats[1],
        "user_history_file_format": "user-item_seq"}))


def write_slice_data(root: Path, hist=(10, HIST_CAP), group=WALK_GROUP,
                     rows=ENTRY_STEPS * TRAIN_BATCH) -> None:
    """tests/synth.py's on-disk layout at bench.py's scale: 100,000 users
    (id 0 is padding) with hist[0]..hist[1]-1 training items each (10..199
    for the entry path) over 50,000 items, seed 0, then one valid and one
    test item per user, the walks of ``slice_walks`` (user u on group u %
    (49,999 // group)): the next item follows from the last one, which
    SASRec learns within the run's 200 steps per epoch (at 40 it learned
    only the 1-in-10 base rate), so the validations choose between scores
    that differ. train.pkl holds ``rows`` (user, item) pairs drawn from the
    histories; valid.pkl and test.pkl 8,192 users each; user_history.pkl
    (user_id, item_seq) the training histories."""
    import pandas as pd
    rng = np.random.default_rng(SEED)
    users, n, starts, owner, items, is_train = slice_walks(rng, hist, group, 2)
    write_train_tables(root, rng, users, n, owner, items, is_train, rows,
                       ("user-item", "user-item"))
    for name, off in (("valid", 0), ("test", 1)):
        who = np.sort(rng.choice(len(users), EVAL_USERS, replace=False))
        pd.DataFrame({"user_id": users[who],
                      "item_id": items[starts[who] + n[who] + off]}).to_pickle(
            root / f"{name}.pkl")


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
    on_new_bodies("entry path", counts)
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
    the user embeddings, each row's rank of the positive (of T5 rows, the
    first one) among the catalog (the one-positive evaluate_full's ranking,
    the same tie noise both ways), and the batch's metrics under ``ev``."""
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
        pos = tb["item_id"] if tb["item_id"].dim() == 1 else tb["item_id"][:, 0]
        rank = M.onepos_rank_full_catalog(scores, pos, h["items"], h["len"], gen)
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
    emit({"phase": phase, "what": f"one eval batch (one_vs_all, {type(ev).__name__})",
          "users": len(eval_batch["user_id"]), "items": N_ITEMS,
          **device_profile(torch, lambda: ev.evaluate_full([eval_batch],
                                                           trainer.user_history)),
          "card": card})


# ---------------------------------------------------------------- long path
# 200 steps an epoch, a depth cut that keeps the script's wall time near
# 1,000 s with the opt-in variants, the client packages and MoRec on the
# data mesh added (hit@10 passes 0.1 within the first epoch)
LONG_HIST, LONG_GROUP, LONG_STEPS, LONG_EPOCHS = (64, 768), 800, 200, 2


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
    on_new_bodies("long path", counts)
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
    counts = launch_counts(("flash_attention", "blockmax", "blockmax_mma"))
    emit({"phase": "long_serve", "users": SERVE_USERS, "batch": BATCH, "topk": TOPK,
          "max_seq_len": LONG_LEN, "users_per_s": SERVE_USERS / secs,
          "ms_per_batch": secs * 1e3 / (SERVE_USERS // BATCH), **counts,
          "seconds": time.perf_counter() - t0, "card": card})
    if min(counts.values()) <= 0:
        raise AssertionError(f"long serving never launched a kernel: {counts}")
    on_new_bodies("long serve", counts)
    with torch.no_grad():
        check_main_path(torch, model, cfg, users, history, {"bf16": cfg}, {"bf16": ids},
                        phase="long_serve_check")
    return counts


# --------------------------------- popularity negatives and sessions path
# each user's walk group is drawn with probability rank^-ZIPF_S over a
# random permutation of the groups (tests/synth.py:176's exponent), so the
# catalog's popularity is skewed while the next item still follows the last
ZIPF_S, POP_STEPS, POP_EPOCHS, POP_POSITIVES, SESSION_NEGS = 0.9, 200, 2, 3, 9
# draws whose histogram is held to the alias table: one batch's 1.18M
# candidates over 50,000 items read about 0.07 from sampling alone, so
# POP_TV_BATCHES of the augmenter's batches of draws are counted
POP_TV_BATCHES, POP_TV_MAX = 100, 0.02
# rows 1-4, 6 and 8 on the path, each with its new body's counter
POP_BODIES = (("layer_fwd", "layer_fwd_mma"), ("layer_bwd", "layer_bwd_mma"),
              ("lastq_fwd", "lastq_fwd_mma"), ("lastq_bwd", "lastq_bwd_mma"),
              ("scatter_add", "scatter_add_sorted"), ("member", "member_warp"))
POP_EVAL_KERNELS = ("layer_fwd", "layer_fwd_mma", "lastq_fwd", "lastq_fwd_mma")


def write_pop_session_data(root: Path, rows=POP_STEPS * TRAIN_BATCH) -> None:
    """The entry path's scale and walks (``slice_walks``, 10..199 training
    items a user, groups of 200 ids), seed SEED + 7, with each user's group
    drawn by a Zipf law (ZIPF_S) over a random permutation of the 249
    groups. valid.pkl is T5 (user_id, item_seq): 8,192 users' next
    POP_POSITIVES items; test.pkl is T2_1 (user_id, item_id, label,
    session_id): 8,192 sessions, each a user's next item (label 1) and
    SESSION_NEGS items drawn by training-history popularity (label 0)."""
    import pandas as pd
    rng = np.random.default_rng(SEED + 7)
    n_groups = (N_ITEMS - 1) // WALK_GROUP
    p = 1.0 / np.arange(1, n_groups + 1) ** ZIPF_S
    group_of = rng.permutation(n_groups)[rng.choice(n_groups, N_USERS - 1, p=p / p.sum())]
    users, n, starts, owner, items, is_train = slice_walks(
        rng, (10, HIST_CAP), WALK_GROUP, POP_POSITIVES, group_of)
    write_train_tables(root, rng, users, n, owner, items, is_train, rows,
                       ("user-item_seq", "user-item-label-session"))
    who = np.sort(rng.choice(len(users), EVAL_USERS, replace=False))
    nxt = starts[who] + n[who]
    pd.DataFrame({"user_id": users[who],
                  "item_seq": list(items[nxt[:, None] + np.arange(POP_POSITIVES)])}).to_pickle(
        root / "valid.pkl")
    who = np.sort(rng.choice(len(users), EVAL_USERS, replace=False))
    pop = np.bincount(items[is_train], minlength=N_ITEMS).astype(np.float64)
    negs = rng.choice(N_ITEMS, (EVAL_USERS, SESSION_NEGS), p=pop / pop.sum())
    cand = np.concatenate([items[starts[who] + n[who]][:, None], negs], axis=1)
    k = SESSION_NEGS + 1
    pd.DataFrame({"user_id": np.repeat(users[who], k), "item_id": cand.reshape(-1),
                  "label": np.tile(np.r_[1, np.zeros(SESSION_NEGS, np.int64)], EVAL_USERS),
                  "session_id": np.repeat(np.arange(EVAL_USERS), k)}).to_pickle(
        root / "test.pkl")


def pop_session_args(data: Path, out: Path):
    """bench.py's training configuration (``train_config``) through
    main.run, with popularity negatives (alpha 1), multi-positive one-vs-all
    validation, a session-wise test and TensorBoard."""
    return {"task": "train", "model": "SASRec", "dataloader": "SeqRecDataset",
            "dataset_path": str(data), "output_path": str(out), "exp_name": "sasrec_pop_session",
            "user_history_filename": "user_history", "max_seq_len": SEQ_LEN,
            "embedding_size": EMB, "hidden_size": EMB, "inner_size": 2 * EMB, "n_layers": 2,
            "n_heads": 2, "hidden_act": "swish", "loss_type": "bce",
            "n_sample_neg_train": N_NEG, "neg_by_pop_alpha": 1.0,
            "history_mask_mode": "autoregressive", "hidden_dropout_prob": P_DROP,
            "attn_dropout_prob": P_DROP, "dropout_bits": 8, "compute_dtype": "bfloat16",
            "last_query_only": 1, "fused_layer": 1, "fused_lastq": 1,
            "vmem_embedding_grad": 1, "neg_membership_pallas": 1, "batch_size": TRAIN_BATCH,
            "epochs": POP_EPOCHS, "learning_rate": 1e-3, "seed": SEED, "shuffle_train": 1,
            "valid_protocol": "one_vs_all", "test_protocol": "session_aware",
            "test_batch_size": EVAL_BATCH,
            "metrics": "['hit@1;10', 'ndcg@10', 'mrr@10', 'group_auc']",
            "key_metric": "ndcg@10", "early_stop": 5, "use_tensorboard": 1}


def alias_tv(torch, aug, batches=POP_TV_BATCHES):
    """The total-variation distance between the augmenter's own draws (the
    candidates before rejection, ``batches`` batches of [32,768, 36]) and
    the alias table's probabilities over the catalog, with the distance
    sampling alone gives on average (sum of sqrt(2 p / (pi N)) / 2) and one
    batch's distance beside it."""
    thresh = aug.state["alias_thresh"].double()
    probs = thresh.clone().index_add_(0, aug.state["alias_alias"].long(), 1.0 - thresh)
    probs /= len(thresh)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    counts = torch.zeros_like(probs)
    shape = (TRAIN_BATCH, N_NEG * aug.oversample)
    tv = lambda c, n: 0.5 * float((c / n - probs).abs().sum())  # noqa: E731
    for i in range(batches):
        d = aug._draw(gen, shape).long().reshape(-1)
        counts += torch.bincount(d, minlength=len(probs)).double()
        if i == 0:
            one = tv(counts, d.numel())
    n = batches * shape[0] * shape[1]
    return {"draws": n, "tv": tv(counts, n), "tv_tol": POP_TV_MAX,
            "tv_sampling_mean": 0.5 * float((2 * probs / (np.pi * n)).sqrt().sum()),
            "tv_one_batch": one, "item0_draws": int(counts[0])}


def pop_session_path(torch, card: str):
    """main.run(task=train) on bench.py's configuration with popularity
    negatives, multi-positive validation before each epoch and the
    session-wise test after; then task=test from the best checkpoint under
    profile=1. Launches are counted over the train run and over its
    evaluations alone."""
    from unirec_tpu_torch.facility.evaluation import SessionWiseEvaluator
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.main import main as main_mod
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke"
    data, out = root / "pop_data", root / "pop"
    shutil.rmtree(out, ignore_errors=True)   # events and traces of this run alone
    write_pop_session_data(data)
    setup_s = time.perf_counter() - t0
    seen = {"losses": [], "evals": [], "marks": [], "reduce_s": [],
            "eval_counts": dict.fromkeys(POP_EVAL_KERNELS, 0)}
    step, evaluate, fit = Trainer.train_step, Trainer.evaluate, Trainer.fit
    reduce = SessionWiseEvaluator.evaluate_with_scores

    def spy_step(self, batch):
        seen["losses"].append(step(self, batch))
        return seen["losses"][-1]

    def spy_eval(self, data, load_best_model=True, model_file=None, **kw):
        torch.cuda.synchronize()
        seen["marks"].append(time.perf_counter())
        n0 = launch_counts(POP_EVAL_KERNELS)
        res = evaluate(self, data, load_best_model, model_file, **kw)
        torch.cuda.synchronize()
        for k, v in launch_counts(POP_EVAL_KERNELS).items():
            seen["eval_counts"][k] += v - n0[k]
        seen["marks"].append(time.perf_counter())
        seen["evals"].append((res, seen["marks"][-1] - seen["marks"][-2], len(data.ds)))
        return res

    def spy_reduce(self, *a, **kw):
        t1 = time.perf_counter()
        res = reduce(self, *a, **kw)
        seen["reduce_s"].append(time.perf_counter() - t1)
        return res

    def spy_fit(self, train_data, valid_data=None, **kw):
        seen["trainer"], seen["train_data"] = self, train_data
        return fit(self, train_data, valid_data, **kw)

    args = pop_session_args(data, out)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with mock.patch.object(Trainer, "train_step", spy_step), \
            mock.patch.object(Trainer, "evaluate", spy_eval), \
            mock.patch.object(Trainer, "fit", spy_fit), \
            mock.patch.object(SessionWiseEvaluator, "evaluate_with_scores", spy_reduce):
        t1 = time.perf_counter()
        result = main_mod.run(dict(args))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
    counts = launch_counts(TRAINING_KERNELS)
    train_counts = {k: v - seen["eval_counts"].get(k, 0) for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    ckpt = out / "checkpoint" / "sasrec_pop_session.pkl"
    t1 = time.perf_counter()
    again = main_mod.run({"task": "test", "model_file": str(ckpt), "dataset_path": str(data),
                          "output_path": str(out / "test"), "profile": 1})
    torch.cuda.synchronize()
    profiled_test_s = time.perf_counter() - t1
    loss = torch.stack(seen["losses"]).float().cpu().numpy()
    valid, (test_res, test_s, n_test) = seen["evals"][:-1], seen["evals"][-1]
    # marks: [v0 start, v0 end, v1 start, v1 end, test start, test end]
    epoch2_s = seen["marks"][4] - seen["marks"][3]
    line = {"phase": "pop_session_path", "config": "sasrec_pop_session", "batch": TRAIN_BATCH,
            "steps": len(loss), "epochs": POP_EPOCHS, "data_setup_s": setup_s,
            "run_s": run_s, "examples_per_s": TRAIN_BATCH * POP_STEPS / epoch2_s,
            "ms_per_step": epoch2_s * 1e3 / POP_STEPS,
            "first_losses": loss[:3].tolist(), "last_losses": loss[-3:].tolist(),
            "valid": [{"result": r, "seconds": s, "users_per_s": u / s} for r, s, u in valid],
            "test": test_res, "test_rows": n_test, "test_rows_per_s": n_test / test_s,
            "session_reduce_s": seen["reduce_s"], "test_from_checkpoint": again,
            "profiled_test_s": profiled_test_s, "peak_mem_bytes": peak, "card": card}
    emit(line)
    emit({"phase": "pop_session_path_launches", "training": train_counts,
          "evaluations": seen["eval_counts"]})
    if len(loss) != POP_STEPS * POP_EPOCHS or not np.isfinite(loss).all() \
            or not loss[-10:].mean() < loss[:10].mean():
        raise AssertionError(f"training did not run as expected: {loss.tolist()}")
    if len(valid) != POP_EPOCHS or not all(np.isfinite(r["ndcg@10"]) for r, _, _ in valid):
        raise AssertionError(f"a validation gave no key metric: {valid}")
    if not max(r["hit@10"] for r, _, _ in valid) >= LEARN_MIN_HIT10:
        raise AssertionError(f"the model learned nothing the validations show: {valid}")
    if again != test_res or again != result:
        raise AssertionError(f"test from the checkpoint {again} != the run's {result}")
    missing = [k for k, _ in POP_BODIES if train_counts[k] <= 0] + \
        [k for k in ("layer_fwd", "lastq_fwd") if seen["eval_counts"][k] <= 0]
    if missing:
        raise AssertionError(f"pop_session path never launched {missing}: {line}")
    on_new_bodies("pop_session path", counts, POP_BODIES)
    check_pop_session_outputs(out, args["key_metric"])
    return counts, seen["trainer"], seen["train_data"]


def check_pop_session_outputs(out: Path, key_metric: str):
    """The run's TensorBoard events hold train/loss and valid/<key_metric>
    at every epoch, and the profiled test's trace names rows 1 and 3's
    tensor-core kernels."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(str(out / "tensorboard"))
    acc.Reload()
    steps = {t: [e.step for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}
    traces = sorted((out / "test" / "profile").glob("*.pt.trace.json"))
    names = set()
    if traces:
        with open(traces[0]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
    kernels = {k: sum(k in n for n in names) for k in ("layer_fwd_mma_kernel",
                                                       "lastq_fwd_mma_kernel")}
    line = {"phase": "pop_session_outputs", "tensorboard_steps": steps,
            "trace": str(traces[0].relative_to(ROOT)) if traces else None,
            "trace_bytes": traces[0].stat().st_size if traces else 0,
            "trace_kernel_names": len(names), "rows_1_3_in_trace": kernels}
    emit(line)
    if steps.get("train/loss") != list(range(1, POP_EPOCHS + 1)) \
            or steps.get(f"valid/{key_metric}") != list(range(POP_EPOCHS)):
        raise AssertionError(f"TensorBoard events are not the run's: {steps}")
    if not all(kernels.values()):
        raise AssertionError(f"the profiled test's trace misses rows 1 and 3: {line}")


def check_pop_session(torch, trainer, train_data, card):
    """One training batch of the path: the share of negative slots left at
    0, the alias table against the augmenter's draws, and row 8 on this
    batch's own (rows, cand); then one validation batch (T5, three
    positives a row) through the kernels and through the plain versions;
    then a traced step and validation batch."""
    from unirec_tpu_torch.data.datasets import get_dataset_class
    from unirec_tpu_torch.data.pipeline import make_eval_batcher
    from unirec_tpu_torch.facility.evaluation import MultiPositiveEvaluator
    from unirec_tpu_torch.main.main import _task_config
    from unirec_tpu_torch.ops import member as MB
    from unirec_tpu_torch.utils import to_device
    aug = trainer._augmenter
    store = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    with torch.no_grad(), call_capture(MB, "_member_cuda", store):
        batch = aug.augment(to_device(next(iter(train_data)), "cuda"), gen)
    negs = batch["item_id"][:, 1:]
    line = {"phase": "pop_session_check", "alias_table": aug.use_alias,
            "zero_slot_share": float((negs == 0).float().mean()),
            **alias_tv(torch, aug)}
    cfg = trainer.config
    vcfg = _task_config(cfg, "valid")
    ds = get_dataset_class("SeqRecDataset")(vcfg, cfg["dataset_path"], "valid")
    eval_batch = next(iter(make_eval_batcher(ds, vcfg, trainer.user_history, task="valid")))
    ev = MultiPositiveEvaluator(cfg, trainer.model, "cuda")
    line.update(eval_agreement(torch, trainer, trainer.model, ev, eval_batch))
    emit(line)
    if not (aug.use_alias and line["tv"] <= POP_TV_MAX and line["item0_draws"] == 0
            and line["user_emb_max_abs_diff"] <= line["user_emb_tol"]
            and line["rank_agree_share"] >= RANK_AGREE_SHARE
            and line["metric_max_rel_diff"] <= METRIC_REL_TOL):
        raise AssertionError(f"pop_session check failed: {line}")
    if len(store) != 1:
        raise AssertionError(f"one batch called the membership kernel {len(store)} times")
    member = member_line(torch, *store[0], "pop_session path")
    profile_entry_path(torch, trainer, train_data, ev, eval_batch, card,
                       phase="pop_session_profile")
    return member


# ------------------------------------------------ the sequential family
# examples/more-examples/run_seq_benchmark.sh's options (d=256, L=50, BCE
# with 19 negatives, autoregressive histories, the device pipeline) in f32 at
# base.yaml's batch of 400, each model's YAML keys as they are, on the entry
# path's data; cut to FAMILY_EPOCHS epochs of FAMILY_STEPS steps and
# FAMILY_EVAL_USERS validation and test users. The script's learning rate,
# 1e-3, trains up to 200 epochs; in 1,250 steps GRU and AttHist learn
# nothing at it, so the cut runs FAMILY_LR: 3e-3, and 1e-2 for AttHist,
# which learns nothing in 750 steps at 3e-3 (PERF.md §4). GRU and AttHist
# score positives above 16.6 after 364-529 steps, where the sigmoid is 1.0 in
# f32: the port's BCE stays finite there (ops/losses.py::bce_loss), so every
# step's loss must be finite.
# The script's early_stop of 10 validations, one every 50 steps.
FAMILY = ("GRU", "AvgHist", "AttHist", "SVDPlusPlus", "ConvFormer", "FASTConvFormer")
FAMILY_EMB, FAMILY_BATCH, FAMILY_NEG = 256, 400, 19
FAMILY_STEPS, FAMILY_EPOCHS, FAMILY_EVAL_USERS = 50, 12, 2048
FAMILY_LR = {"AttHist": 1e-2}     # 3e-3 for the others
FAMILY_MIN_HIT10 = 10 * 10 / N_ITEMS        # ten times chance
# the tables whose gathers a train step scatters, in call order (the
# candidates', then the user side's); the others gather the item table twice
FAMILY_TABLES = {"AvgHist": ("item_embedding", "item_dst_embedding"),
                 "SVDPlusPlus": ("item_embedding", "user_embedding", "item_dst_embedding")}
# a step's scatter calls by their ids per example: the history, the candidates, the user
FAMILY_SCATTER_IDS = {SEQ_LEN: "item_seq (item_dst_embedding)",
                      1 + FAMILY_NEG: "candidates (item_embedding)",
                      1: "user_id (user_embedding)"}


def write_family_tables(data: Path) -> None:
    """The entry path's data (written when absent) cut for the family:
    FAMILY_STEPS batches of training rows drawn from its train table, its
    first FAMILY_EVAL_USERS validation and test users."""
    import pandas as pd
    if not (data / "train.pkl").exists():
        write_slice_data(data)
    rng = np.random.default_rng(SEED + 8)
    train = pd.read_pickle(data / "train.pkl")
    pick = np.sort(rng.choice(len(train), FAMILY_STEPS * FAMILY_BATCH, replace=False))
    train.iloc[pick].reset_index(drop=True).to_pickle(data / "train_family.pkl")
    for name in ("valid", "test"):
        pd.read_pickle(data / f"{name}.pkl").iloc[:FAMILY_EVAL_USERS].to_pickle(
            data / f"{name}_family.pkl")


def family_args(name: str, data: Path, out: Path):
    return {"task": "train", "model": name, "dataloader": "SeqRecDataset",
            "dataset_path": str(data), "output_path": str(out / name), "exp_name": name,
            "user_history_filename": "user_history", "data_train_name": "train_family",
            "data_valid_name": "valid_family", "data_test_name": "test_family",
            "max_seq_len": SEQ_LEN, "embedding_size": FAMILY_EMB, "loss_type": "bce",
            "n_sample_neg_train": FAMILY_NEG, "history_mask_mode": "autoregressive",
            "device_pipeline": 1, "compute_dtype": "float32", "batch_size": FAMILY_BATCH,
            "epochs": FAMILY_EPOCHS, "learning_rate": FAMILY_LR.get(name, 3e-3), "seed": SEED,
            "shuffle_train": 1,
            "valid_protocol": "one_vs_all", "test_protocol": "one_vs_all",
            "test_batch_size": EVAL_BATCH,
            "metrics": "['hit@10', 'ndcg@10', 'mrr', 'group_auc']", "key_metric": "ndcg@10",
            "early_stop": 10}


def run_spied(torch, args, eval_counts=()):
    """main.run(args) with the train steps' losses, each evaluation's result,
    seconds and (for ``eval_counts``) launches, and the trainer and train
    batcher recorded; the counts reset just before."""
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.main import main as main_mod
    seen = {"losses": [], "evals": [], "marks": [],
            "eval_counts": dict.fromkeys(eval_counts, 0)}
    step, evaluate, fit = Trainer.train_step, Trainer.evaluate, Trainer.fit

    def spy_step(self, batch):
        seen["losses"].append(step(self, batch))
        return seen["losses"][-1]

    def spy_eval(self, data, load_best_model=True, model_file=None, **kw):
        torch.cuda.synchronize()
        seen["marks"].append(time.perf_counter())
        n0 = launch_counts(eval_counts)
        res = evaluate(self, data, load_best_model, model_file, **kw)
        torch.cuda.synchronize()
        for k, v in launch_counts(eval_counts).items():
            seen["eval_counts"][k] += v - n0[k]
        seen["marks"].append(time.perf_counter())
        seen["evals"].append((res, seen["marks"][-1] - seen["marks"][-2], len(data.ds)))
        return res

    def spy_fit(self, train_data, valid_data=None, **kw):
        seen["trainer"], seen["train_data"] = self, train_data
        return fit(self, train_data, valid_data, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with mock.patch.object(Trainer, "train_step", spy_step), \
            mock.patch.object(Trainer, "evaluate", spy_eval), \
            mock.patch.object(Trainer, "fit", spy_fit):
        t0 = time.perf_counter()
        seen["result"] = main_mod.run(dict(args))
        torch.cuda.synchronize()
        seen["run_s"] = time.perf_counter() - t0
    seen["peak"] = torch.cuda.max_memory_allocated()
    seen["loss"] = torch.stack(seen["losses"]).float().cpu().numpy()
    return seen


def learned_and_repeated(seen, args, phase, steps, min_hit10, metric="hit@10"):
    """The gates every main.run path of the script shares: the loss finite
    and falling, every validation's key metric, the best ``metric`` (hit@10
    unless given) at least ``min_hit10``, and task=test from the best
    checkpoint (run here) equal to the run's test metrics. Returns that
    test's metrics."""
    from unirec_tpu_torch.main import main as main_mod
    loss, valid = seen["loss"], seen["evals"][:-1]
    ckpt = Path(args["output_path"]) / "checkpoint" / f"{args['exp_name']}.pkl"
    again = main_mod.run({"task": "test", "model_file": str(ckpt),
                          "dataset_path": args["dataset_path"],
                          "output_path": str(Path(args["output_path"]) / "test")})
    if len(loss) != steps * args["epochs"] or not np.isfinite(loss).all() \
            or not loss[-10:].mean() < loss[:10].mean():
        raise AssertionError(f"{phase}: training did not run as expected: {loss.tolist()}")
    if len(valid) != args["epochs"] or not all(np.isfinite(r[args["key_metric"]])
                                               for r, _, _ in valid):
        raise AssertionError(f"{phase}: a validation gave no key metric: {valid}")
    if not max(r[metric] for r, _, _ in valid) >= min_hit10:
        raise AssertionError(f"{phase}: the model learned nothing the validations show: {valid}")
    if again != seen["evals"][-1][0] or again != seen["result"]:
        raise AssertionError(f"{phase}: test from the checkpoint {again} != the run's "
                             f"{seen['result']}")
    return again


# a step through the kernels against the plain versions, (loss, gradient
# leaf) of each leaf's largest: f32 apart by summation order alone
STEP_TOL = {"float32": (1e-6, 1e-4), "bfloat16": (2e-3, BWD_TOL)}   # (loss, gradient leaf)


def check_model_step(torch, phase, trainer, train_data, tables=None, **extra):
    """One training batch from the trained weights at dropout 0, through the
    kernels and through the plain versions: the loss, every gradient leaf
    (STEP_TOL of each leaf's largest; a key bias of its query bias's), and
    the batch's scores (MultiVAE: its user embeddings) within 1e-4 of the
    largest (f32) or emb_tol (bf16). With ``tables`` (the tables a step's
    gathers scatter into, in call order), the step's gathers must be those
    and row 6 must scatter once for each. Returns (the line, the kernels'
    scatter calls (ids, rows, n_rows), empty without ``tables``)."""
    from unirec_tpu_torch.facility.trainer import kl_anneal
    from unirec_tpu_torch.models.modules import DropoutRNG
    from unirec_tpu_torch.ops import scatter_accum as SA
    from unirec_tpu_torch.utils import to_device
    from unirec_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params
    from unirec_tpu_torch.utils.registry import get_model_class
    cfg = dict(trainer.config, hidden_dropout_prob=0.0, attn_dropout_prob=0.0, dropout_prob=0.0)
    model = get_model_class(cfg["model"])(cfg)
    load_flax_params(model, to_flax_params(trainer.model))
    model.to("cuda")
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    batch = to_device(next(iter(train_data)), "cuda")
    if trainer._augmenter is not None:
        batch = trainer._augmenter.augment(batch, torch.Generator(device="cuda").manual_seed(
            SEED + 90))
    if trainer._anneal_sched is not None:
        batch["anneal"] = kl_anneal(trainer._global_step, *trainer._anneal_sched)
    dtype = "bfloat16" if model.compute_dtype is not None else "float32"
    gathered, calls, gather = [], [], SA.gather_vmem
    by_ptr = {p.data_ptr(): n.rsplit(".", 1)[0] for n, p in model.named_parameters()}

    def spy_gather(table, ids):
        gathered.append(by_ptr.get(table.data_ptr(), "?"))
        return gather(table, ids)

    def run():
        loss, _ = model(batch, train=True, rng=DropoutRNG(SEED + 91, "cuda"))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            out = model.user_emb(batch) if cfg["model"] == "MultiVAE" else model.predict(batch)
        return (loss.detach(), [torch.zeros_like(p) if g is None else g
                                for g, p in zip(grads, params)], out.float())

    with (mock.patch.object(SA, "gather_vmem", spy_gather) if tables else nullcontext()), \
            (call_capture(SA, "_scatter_cuda", calls) if tables else nullcontext()):
        loss_k, grads_k, out_k = run()
    with plain_versions():
        loss_p, grads_p, out_p = run()
    # a key bias's exact gradient is zero: it takes its query bias's scale
    zero_sum = {i: names.index(n.replace("key.bias", "query.bias"))
                for i, n in enumerate(names) if n.endswith("key.bias")}
    errs, zeros = leaf_errs(grads_k, grads_p, zero_sum)
    errs = dict(zip(names, errs))
    worst = max(errs, key=errs.get)
    loss_tol, grad_tol = STEP_TOL[dtype]
    out_tol = emb_tol(out_p) if dtype == "bfloat16" else 1e-4 * float(out_p.abs().max())
    line = {"phase": phase, **extra, "dtype": dtype, "batch": len(batch["weight"]),
            "loss_kernels": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel_diff": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
            "loss_tol": loss_tol, "grad_leaves": len(errs), "grad_max_rel_err": errs[worst],
            "grad_worst_leaf": worst, "grad_tol": grad_tol,
            "key_bias_grads": {names[i]: r for i, r in zeros.items()}, "scores": list(out_k.shape),
            "score_max_abs_diff": float((out_k - out_p).abs().max()), "score_tol": out_tol,
            "finite": bool(torch.isfinite(out_k).all())}
    if tables:
        line.update(tables_gathered=gathered, scatter_calls=len(calls),
                    scatter_rows=[int(c[0].numel()) for c in calls])
    emit(line)
    if not (line["loss_rel_diff"] <= loss_tol and errs[worst] <= grad_tol and line["finite"]
            and line["score_max_abs_diff"] <= out_tol and zero_sum_ok(zeros)):
        raise AssertionError(f"{phase}: kernels disagree with the plain versions: {line}")
    if tables and not (tuple(gathered) == tuple(tables) and len(calls) == len(tables)):
        raise AssertionError(f"{phase}: the step gathered {gathered} and scattered "
                             f"{len(calls)} times, not {tables} once each")
    return line, calls


def run_and_gate(torch, args, phase, steps, min_value, card, metric="hit@10",
                 want=(), none=(), exact=None, new_bodies=NEW_BODIES, failed=None, **extra):
    """main.run(args) under run_spied and learned_and_repeated's gates; the
    run's launches of CF_KERNELS and RANK_KERNELS (each of ``want`` above 0,
    each of ``none`` 0, each of ``exact`` its count, ``new_bodies`` as
    on_new_bodies's pairs); a line with its ms a step (the last epoch: from
    the end of its validation to the test), examples/s, validation users/s
    and peak memory. A gate that fails raises, or with ``failed`` (a list)
    adds its message there. Returns (seen, the launches)."""
    seen = run_spied(torch, args)
    counts = launch_counts(sorted(set(CF_KERNELS + RANK_KERNELS)))
    errors = []
    try:
        test = learned_and_repeated(seen, args, phase, steps, min_value, metric)
    except AssertionError as e:
        test = None
        errors.append(str(e))
    last_s = seen["marks"][-2] - seen["marks"][-3]
    valid = seen["evals"][:-1]
    batch = int(args["batch_size"])
    emit({"phase": phase, **extra, "batch": batch, "learning_rate": args["learning_rate"],
          "steps": len(seen["loss"]), "epochs": args["epochs"],
          "ms_per_step": last_s * 1e3 / steps, "examples_per_s": batch * steps / last_s,
          "run_s": seen["run_s"],
          "first_losses": seen["loss"][:3].tolist(), "last_losses": seen["loss"][-3:].tolist(),
          "valid": [{"result": r, "seconds": s, "rows_per_s": n / s} for r, s, n in valid],
          "test": test, "launches": counts, "peak_mem_bytes": seen["peak"], "card": card})
    bad = [k for k in want if counts[k] <= 0] + [k for k in none if counts[k] != 0] \
        + [k for k, n in (exact or {}).items() if counts[k] != n]
    if bad:
        errors.append(f"{phase}: launches {counts}, wrong for {bad}")
    try:
        on_new_bodies(phase, counts, new_bodies)
    except AssertionError as e:
        errors.append(str(e))
    if errors and failed is None:
        raise AssertionError("; ".join(errors))
    if errors:
        failed.extend(errors)
    return seen, counts


def seq_family_path(torch, card: str):
    """main.run(task=train) of each of the six models at run_seq_benchmark.sh's
    options, then task=test from its best checkpoint, under run_and_gate
    (row 6 launched once a step for each table the step gathers, on its
    sorted body); then one step from the trained weights at dropout 0
    through the kernels and through the plain versions (check_family).
    Returns (the launches summed over the six runs, SVD++'s captured
    scatter calls)."""
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke"
    data, out = root / "slice_data", root / "family"
    shutil.rmtree(out, ignore_errors=True)
    write_family_tables(data)
    emit({"phase": "seq_family_data", "seconds": time.perf_counter() - t0})
    total, captured, failed = dict.fromkeys(("scatter_add", "scatter_add_sorted"), 0), None, []
    for name in FAMILY:
        args = family_args(name, data, out)
        n = len(FAMILY_TABLES.get(name, ("item_embedding",) * 2)) * FAMILY_STEPS * FAMILY_EPOCHS
        seen, counts = run_and_gate(torch, args, "seq_family_path", FAMILY_STEPS,
                                    FAMILY_MIN_HIT10, card, exact={"scatter_add": n,
                                                                   "scatter_add_sorted": n},
                                    failed=failed, model=name, d=FAMILY_EMB)
        for k in total:
            total[k] += counts[k]
        profile_step(torch, seen["trainer"], seen["train_data"], "seq_family_profile", card,
                     model=name)
        try:
            calls = check_family(torch, name, seen["trainer"], seen["train_data"])
        except AssertionError as e:
            failed.append(str(e))
            calls = None
        if name == "SVDPlusPlus":
            captured = calls
        del seen
        torch.cuda.empty_cache()
    emit({"phase": "seq_family_path_launches", **total,
          "seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError("; ".join(failed))
    return total, captured


def profile_step(torch, trainer, train_data, phase, card, **extra):
    """One traced train step of a trained path (after a warm one)."""
    from unirec_tpu_torch.utils import to_device
    batch = to_device(next(iter(train_data)), "cuda")
    trainer.train_step(batch)
    torch.cuda.synchronize()
    emit({"phase": phase, "what": "one train step", **extra, "batch": len(batch["weight"]),
          **device_profile(torch, lambda: trainer.train_step(batch)), "card": card})


def check_family(torch, name, trainer, train_data):
    """check_model_step on one training batch, with the tables the step's
    gathers scatter into (row 6 alone on this path), one launch each; then
    ConvFormer's hidden dropout by its keep rate on the card. Returns the
    step's scatter calls (ids, rows, n_rows)."""
    from unirec_tpu_torch.models.modules import DropoutRNG, apply_dropout
    _, calls = check_model_step(torch, "seq_family_check", trainer, train_data,
                                tables=FAMILY_TABLES.get(name, ("item_embedding",) * 2),
                                model=name)
    if name == "ConvFormer":
        p = float(trainer.config["hidden_dropout_prob"])
        x = torch.ones(4096, FAMILY_EMB, device="cuda")
        y = apply_dropout(x, p, True, DropoutRNG(SEED + 82, "cuda"))
        keep = float((y != 0).float().mean())
        line = {"phase": "seq_family_check", "model": name, "dropout": {
            "p": p, "keep_rate": keep, "kept_value": float(y.max()),
            "keep_tol": 4 * (p * (1 - p) / x.numel()) ** 0.5}}
        emit(line)
        if not (abs(keep - (1 - p)) <= line["dropout"]["keep_tol"]
                and abs(float(y[y != 0].min()) - 1 / (1 - p)) < 1e-6
                and abs(float(y.max()) - 1 / (1 - p)) < 1e-6):
            raise AssertionError(f"ConvFormer's dropout keeps the wrong share: {line}")
    return calls


# ------------------------------------------------ the item side inputs
# bench.py's training options (pop_session_args, uniform negatives) with
# two categorical fields (64 and 16 ids), 768-wide frozen text rows and
# TIME_BUCKETS time buckets on T6 histories, at the entry path's scale
SIDE_SHAPE, TEXT_DIM, TIME_BUCKETS, SIDE_STEPS, SIDE_EPOCHS = [64, 16], 768, 64, 200, 2
MLP_STEPS, MLP_NEG = 20, 19


def write_side_data(root: Path, rows=SIDE_STEPS * TRAIN_BATCH) -> dict:
    """The entry path's walks (seed SEED + 9) with T6 histories (each
    user's k-th item in time bucket 1 + k % 63), one-positive valid and
    test tables of 8,192 users, the feature file item_features.tsv (field
    one: the item's walk group mod 63, ids 1-63; field two: 64 + 1 + item
    mod 15, ids 65-79, so 0 stays the padding id of the 80-row table) and
    text_emb.tsv (``id<TAB>v1,...,v768``, normal(0, 1) at 4 decimals).
    Returns the seconds of each part."""
    import pandas as pd
    secs, t0 = {}, time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    users, n, starts, owner, items, is_train = slice_walks(rng, (10, HIST_CAP), WALK_GROUP, 2)
    write_train_tables(root, rng, users, n, owner, items, is_train, rows,
                       ("user-item", "user-item"))
    seqs = np.split(items[is_train], np.cumsum(n)[:-1])
    pd.DataFrame({"user_id": users, "item_seq": seqs,
                  "time_seq": [1 + np.arange(len(s)) % (TIME_BUCKETS - 1) for s in seqs]}
                 ).to_pickle(root / "user_history.pkl")
    info = json.loads((root / "data.info").read_text())
    info["user_history_file_format"] = "user-item_seq-time_seq"
    (root / "data.info").write_text(json.dumps(info))
    for name, off in (("valid", 0), ("test", 1)):
        who = np.sort(rng.choice(len(users), EVAL_USERS, replace=False))
        pd.DataFrame({"user_id": users[who],
                      "item_id": items[starts[who] + n[who] + off]}).to_pickle(
            root / f"{name}.pkl")
    ids = np.arange(1, N_ITEMS)
    with open(root / "item_features.tsv", "w") as f:
        f.write("item_id\tfeatures\n")
        f.writelines(f"{i}\t{1 + ((i - 1) // WALK_GROUP) % 63},{65 + i % 15}\n" for i in ids)
    secs["tables_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    text = rng.standard_normal((N_ITEMS - 1, TEXT_DIM), dtype=np.float32)
    with open(root / "text_emb.tsv", "w") as f:
        np.savetxt(f, np.column_stack([ids, text]),
                   fmt="%d\t" + ",".join(["%.4f"] * TEXT_DIM))
    secs["text_write_s"] = time.perf_counter() - t0
    secs["text_bytes"] = (root / "text_emb.tsv").stat().st_size
    return secs


def side_args(data: Path, out: Path):
    args = pop_session_args(data, out)
    for k in ("neg_by_pop_alpha", "use_tensorboard"):
        args.pop(k)
    args.update({"exp_name": "sasrec_side_inputs", "epochs": SIDE_EPOCHS,
                 "use_features": 1, "features_shape": SIDE_SHAPE,
                 "features_filepath": str(data / "item_features.tsv"),
                 "use_text_emb": 1, "text_emb_size": TEXT_DIM,
                 "text_emb_path": str(data / "text_emb.tsv"), "time_seq": TIME_BUCKETS,
                 "valid_protocol": "one_vs_all", "test_protocol": "one_vs_all",
                 "metrics": "['hit@10', 'ndcg@10', 'mrr', 'group_auc']"})
    return args


def side_inputs_path(torch, card: str):
    """main.run(task=train) on bench.py's training options with every item
    side input, then task=test from the best checkpoint, then reco-topk of
    4,096 users from it (fused, bf16 catalog). Launches: rows 1-4, 6 and 8
    over the training, rows 1 and 3 in its evaluations, rows 1, 3 and 5
    over the serving. Returns (the run's launches, the serving's, the
    trainer, its train batcher)."""
    from unirec_tpu_torch.utils import file_io
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke"
    data, out = root / "side_data", root / "side"
    shutil.rmtree(out, ignore_errors=True)
    setup = write_side_data(data)
    args = side_args(data, out)
    loads, load = [], file_io.load_pre_item_emb

    def timed_load(path):     # main.run's reads of the text file, timed apart
        t1 = time.perf_counter()
        rows = load(path)
        loads.append({"seconds": time.perf_counter() - t1, "rows": list(rows.shape)})
        return rows

    with mock.patch.object(file_io, "load_pre_item_emb", timed_load):
        seen = run_spied(torch, args, POP_EVAL_KERNELS)
        counts = launch_counts(TRAINING_KERNELS)
        train_counts = {k: v - seen["eval_counts"].get(k, 0) for k, v in counts.items()}
        test = learned_and_repeated(seen, args, "side_inputs_path", SIDE_STEPS,
                                    LEARN_MIN_HIT10)
    setup["text_loads"] = loads
    epoch2_s = seen["marks"][4] - seen["marks"][3]
    line = {"phase": "side_inputs_path", "config": "sasrec_side_inputs", "batch": TRAIN_BATCH,
            "features_shape": SIDE_SHAPE, "text_emb_size": TEXT_DIM, "time_seq": TIME_BUCKETS,
            "steps": len(seen["loss"]), "epochs": SIDE_EPOCHS, "data_setup": setup,
            "run_s": seen["run_s"], "examples_per_s": TRAIN_BATCH * SIDE_STEPS / epoch2_s,
            "ms_per_step": epoch2_s * 1e3 / SIDE_STEPS,
            "first_losses": seen["loss"][:3].tolist(), "last_losses": seen["loss"][-3:].tolist(),
            "valid": [{"result": r, "seconds": s, "users_per_s": u / s}
                      for r, s, u in seen["evals"][:-1]],
            "test": test, "peak_mem_bytes": seen["peak"], "card": card}
    emit(line)
    emit({"phase": "side_inputs_path_launches", "training": train_counts,
          "evaluations": seen["eval_counts"]})
    missing = [k for k, _ in POP_BODIES if train_counts[k] <= 0] + \
        [k for k in ("layer_fwd", "lastq_fwd") if seen["eval_counts"][k] <= 0]
    if missing:
        raise AssertionError(f"side_inputs_path never launched {missing}: {line}")
    on_new_bodies("side_inputs path", counts, POP_BODIES)
    trainer, train_data = seen["trainer"], seen["train_data"]
    del seen
    profile_step(torch, trainer, train_data, "side_inputs_profile", card)
    torch.cuda.empty_cache()
    serve_counts = side_serve(torch, out, data, card)
    return counts, serve_counts, trainer, train_data


def side_serve(torch, out: Path, data: Path, card: str):
    """reco-topk (do_topk_reco, the CLI's entry) of 4,096 users from the
    side-input checkpoint, fused over the bf16 catalog whose rows hold the
    features and text the checkpoint's constants carry: rows 1, 3 and 5
    launch, on their tensor-core bodies, every served row is valid and the
    ids agree with the plain versions as the serving path's check. Users/s
    are timed around get_topk_recommendations on the loaded model, as the
    serving path times them; the entry's seconds (checkpoint and history
    loads included) beside them."""
    from unirec_tpu_torch.data.history import UserHistory
    from unirec_tpu_torch.main.reco_topk import do_topk_reco, get_topk_recommendations
    from unirec_tpu_torch.utils.checkpoint import load_model_freely
    ckpt = out / "checkpoint" / "sasrec_side_inputs.pkl"
    users = np.arange(1, SERVE_USERS + 1, dtype=np.int64)
    np.savetxt(out / "serve_users.txt", users, fmt="%d")
    conf = {"model_file": str(ckpt), "dataset_path": str(data),
            "dataset_name": str(out / "serve_users.txt"), "topk": TOPK,
            "test_batch_size": BATCH, "output_path": str(out / "topk.csv")}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ids = do_topk_reco(dict(conf))
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    counts = launch_counts(SERVING_KERNELS)
    model, cfg = load_model_freely(str(ckpt), "cuda")
    cfg = dict(cfg, test_batch_size=BATCH)
    history = UserHistory.load(str(data / "user_history"), N_USERS, "user-item_seq-time_seq")
    get_topk_recommendations(cfg, model, users[:BATCH], history, TOPK)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = get_topk_recommendations(cfg, model, users, history, TOPK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    emit({"phase": "side_serve", "users": SERVE_USERS, "batch": BATCH, "topk": TOPK,
          "users_per_s": SERVE_USERS / secs, "entry_s": entry_s,
          "entry_equals_timed_run": bool(np.array_equal(ids, again)),
          "catalog_dtype": str(model.all_item_emb().dtype).replace("torch.", ""),
          **counts, "card": card})
    need = ("layer_fwd_mma", "lastq_fwd_mma", "blockmax_mma")
    if min(counts[k] for k in need) <= 0:
        raise AssertionError(f"side-input serving never launched {need}: {counts}")
    on_new_bodies("side serve", counts)
    with torch.no_grad():
        check_main_path(torch, model, cfg, users, history, {"bf16": cfg}, {"bf16": ids},
                        phase="side_serve_check")
    return counts


def mlp_scorer_check(torch, side_trainer, card: str):
    """Trainer.fit for MLP_STEPS steps on the side-input configuration (its
    histories, features and text rows) with distance_type mlp, one-vs-k
    validation before the epoch and test after it (MLP_NEG negatives); the
    loss finite and falling; one test batch's predict scores through the
    kernels against the plain versions."""
    from unirec_tpu_torch.data.datasets import get_dataset_class
    from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter, RawIdBatcher
    from unirec_tpu_torch.data.pipeline import make_eval_batcher
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.main.main import _task_config
    from unirec_tpu_torch.utils import to_device
    from unirec_tpu_torch.utils.registry import get_model_class
    t0 = time.perf_counter()
    side = side_trainer.config
    cfg = dict(side, distance_type="mlp", epochs=1, valid_protocol="one_vs_k",
               test_protocol="one_vs_k", n_sample_neg_valid=MLP_NEG,
               n_sample_neg_test=MLP_NEG, exp_name="sasrec_side_mlp",
               output_path=str(Path(side["output_path"]) / "mlp"),
               metrics="['hit@1;5', 'ndcg@5', 'group_auc']", key_metric="group_auc")
    history, feats = side_trainer.user_history, side["_item2features"]
    trainer = Trainer(cfg, get_model_class("SASRec")(cfg), device="cuda")
    trainer.set_user_history(history)
    ds_cls = get_dataset_class("SeqRecDataset")
    cols = ds_cls(_task_config(cfg, "train"), cfg["dataset_path"], "train").cols
    n = MLP_STEPS * TRAIN_BATCH
    batcher = RawIdBatcher(cols["user_id"][:n], cols["item_id"][:n], TRAIN_BATCH, seed=SEED)
    trainer.set_device_augmenter(DeviceAugmenter(_task_config(cfg, "train"), history,
                                                 features=feats, device="cuda"))

    def eval_batcher(task):
        ecfg = _task_config(cfg, task)
        trainer.reset_evaluator(ecfg["data_format"], ecfg["eval_protocol"])
        return make_eval_batcher(ds_cls(ecfg, cfg["dataset_path"], task), ecfg, history,
                                 task=task, features=feats)

    losses, step = [], trainer.train_step
    trainer.train_step = lambda b: losses.append(step(b)) or losses[-1]
    trainer.fit(batcher, eval_batcher("valid"))
    test_batcher = eval_batcher("test")
    test = trainer.evaluate(test_batcher, load_best_model=False)
    loss = torch.stack(losses).float().cpu().numpy()
    batch = to_device(next(iter(test_batcher)), "cuda")
    with torch.no_grad():
        s_k = trainer.model.predict(batch).float()
        with plain_versions():
            s_p = trainer.model.predict(batch).float()
    tol = max(LN_TOL["bfloat16"], 2.0 ** -6 * float(s_p.abs().max()))
    line = {"phase": "mlp_scorer_check", "steps": len(loss), "batch": TRAIN_BATCH,
            "first_losses": loss[:3].tolist(), "last_losses": loss[-3:].tolist(),
            "test": test, "scores": list(s_k.shape),
            "score_max_abs_diff": float((s_k - s_p).abs().max()), "score_tol": tol,
            "score_tol_reason": "two bf16 ulps of the largest score, or LN_TOL",
            "seconds": time.perf_counter() - t0, "card": card}
    emit(line)
    if len(loss) != MLP_STEPS or not np.isfinite(loss).all() \
            or not loss[-5:].mean() < loss[:5].mean():
        raise AssertionError(f"mlp_scorer_check: training did not run as expected: {line}")
    if not (tuple(s_k.shape) == (len(batch["user_id"]), 1 + MLP_NEG)
            and line["score_max_abs_diff"] <= tol):
        raise AssertionError(f"mlp_scorer_check: kernels disagree with the plain versions: {line}")


# ------------------------------------------------------------ the CF models
# amazon-book.yaml's catalog: 52,644 users, 91,600 items (id 0 the padding of
# both). Each user walks a group of CF_GROUP consecutive item ids for
# CF_HIST[0]..CF_HIST[1]-1 training items, then one valid and one test item;
# CF_EVAL_USERS users a split. MF: train_mf_bpr.sh's options, CF_STEPS batches
# of 2,048 of the training pairs an epoch; MultiVAE: MultiVAE.yaml's widths and
# train_cf_model.sh's options over every user's grouped history (52 batches
# of 1,024). Chance at hit@10 is 10 / 91,600. Both train at the scripts' lr
# 1e-3 for CF_EPOCHS epochs in place of 2: MF's hit@10 leaves chance in its
# third (0.0032, then 0.03), MultiVAE's in its fifth (0.023, then 0.14;
# PERF.md §4).
CF_USERS, CF_ITEMS, CF_GROUP, CF_HIST, CF_EVAL_USERS = 52_644, 91_600, 200, (4, 13), 4096
CF_STEPS, MF_BATCH, MF_NEG, VAE_BATCH = 100, 2048, 19, 1024
CF_EPOCHS = {"MF": 4, "MultiVAE": 6}
CF_MIN_HIT10 = 10 * 10 / CF_ITEMS            # ten times chance
CF_KERNELS = ("scatter_add", "scatter_add_sorted", "member", "member_warp", "blockmax",
              "blockmax_int8", "blockmax_mma", "blockmax_int8_mma")


def write_cf_data(root: Path) -> dict:
    """The walks of ``slice_walks`` at amazon-book's scale (seed SEED + 13):
    user_history.pkl and train.pkl (every training pair), train_mf.pkl (MF's
    CF_STEPS x MF_BATCH of them), valid.pkl and test.pkl (CF_EVAL_USERS users,
    the next item of the walk). T1 tables where the yaml names T5 ones: one
    held-out item a user."""
    import pandas as pd
    rng = np.random.default_rng(SEED + 13)
    users, n, starts, owner, items, is_train = slice_walks(rng, CF_HIST, CF_GROUP, 2,
                                                           n_users=CF_USERS, n_items=CF_ITEMS)
    n_train = int(is_train.sum())
    write_train_tables(root, rng, users, n, owner, items, is_train, n_train,
                       ("user-item", "user-item"), n_users=CF_USERS, n_items=CF_ITEMS)
    pd.read_pickle(root / "train.pkl").iloc[:CF_STEPS * MF_BATCH].to_pickle(root / "train_mf.pkl")
    for name, off in (("valid", 0), ("test", 1)):
        who = np.sort(rng.choice(len(users), CF_EVAL_USERS, replace=False))
        pd.DataFrame({"user_id": users[who],
                      "item_id": items[starts[who] + n[who] + off]}).to_pickle(root / f"{name}.pkl")
    return {"users": len(users), "train_pairs": n_train}


def cf_args(name: str, data: Path, out: Path):
    """MF: examples/training/train_mf_bpr.sh (BPR, 19 negatives, the user
    table, d=64, batch 2,048, lr 1e-3) with device_pipeline and
    neg_membership_pallas; MultiVAE: train_cf_model.sh (AERecDataset, full
    softmax, batch 1,024, lr 1e-3) at MultiVAE.yaml's widths (d=400, [200],
    [200], anneal_cap 0.2 over 2,000,000 steps, 5 evaluation draws). Both
    one-vs-all, evaluated 1,024 users a batch."""
    common = {"task": "train", "model": name, "dataset_path": str(data),
              "output_path": str(out / name), "exp_name": name, "seed": SEED,
              "user_history_filename": "user_history", "valid_protocol": "one_vs_all",
              "test_protocol": "one_vs_all", "learning_rate": 1e-3,
              "epochs": CF_EPOCHS[name],
              "early_stop": 10, "test_batch_size": EVAL_BATCH}
    if name == "MF":
        return {**common, "dataloader": "BaseDataset", "data_train_name": "train_mf",
                "loss_type": "bpr", "n_sample_neg_train": MF_NEG, "has_user_emb": 1,
                "metrics": "['hit@5;10', 'ndcg@5;10']", "key_metric": "ndcg@5",
                "embedding_size": 64, "batch_size": MF_BATCH, "shuffle_train": 1,
                "device_pipeline": 1, "neg_membership_pallas": 1}
    return {**common, "dataloader": "AERecDataset", "loss_type": "fullsoftmax",
            "n_sample_neg_train": 0, "metrics": "['hit@5;10;20', 'ndcg@5;10;20']",
            "key_metric": "ndcg@5", "batch_size": VAE_BATCH, "embedding_size": 400,
            "encoder_dims": [200], "decoder_dims": [200], "anneal_cap": 0.2,
            "total_anneal_steps": 2_000_000, "eval_reparameter_sampling_times": 5}


def mf_serve(torch, args, data: Path, card: str):
    """reco-topk of CF_EVAL_USERS users (top-100) from MF's best checkpoint
    through do_topk_reco, then timed through get_topk_recommendations with
    the fused bf16 and int8 catalogs (rows 5, 5q); every served row valid and
    the ids against the plain versions (mf_serve_check). Returns the
    launches."""
    from unirec_tpu_torch.data.history import UserHistory
    from unirec_tpu_torch.main.reco_topk import do_topk_reco, get_topk_recommendations
    from unirec_tpu_torch.utils.checkpoint import load_model_freely
    out = Path(args["output_path"])
    ckpt = out / "checkpoint" / "MF.pkl"
    users = np.arange(1, CF_EVAL_USERS + 1, dtype=np.int64)
    np.savetxt(out / "serve_users.txt", users, fmt="%d")
    history = UserHistory.load(str(data / "user_history"), CF_USERS, "user-item_seq")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ids = do_topk_reco({"model_file": str(ckpt), "dataset_path": str(data),
                        "dataset_name": str(out / "serve_users.txt"), "topk": TOPK,
                        "test_batch_size": BATCH, "output_path": str(out / "topk.csv")})
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    model, cfg = load_model_freely(str(ckpt), "cuda")
    modes = {"bf16": dict(cfg, test_batch_size=BATCH),
             "int8": dict(cfg, test_batch_size=BATCH, catalog_int8=1)}
    results, secs = {}, {}
    for name, c in modes.items():
        get_topk_recommendations(c, model, users[:BATCH], history, TOPK)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = get_topk_recommendations(c, model, users, history, TOPK)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    counts = launch_counts(CF_KERNELS)
    emit({"phase": "mf_serve", "users": CF_EVAL_USERS, "items": CF_ITEMS, "topk": TOPK,
          "batch": BATCH, "users_per_s": {k: CF_EVAL_USERS / v for k, v in secs.items()},
          "entry_s": entry_s, "entry_equals_timed_run": bool(np.array_equal(ids, results["bf16"])),
          "launches": counts, "card": card})
    if min(counts[k] for k in ("blockmax_mma", "blockmax_int8_mma")) <= 0:
        raise AssertionError(f"mf_serve never launched rows 5 and 5q: {counts}")
    on_new_bodies("mf_serve", counts)
    with torch.no_grad():
        check_main_path(torch, model, modes["bf16"], users, history, modes, results,
                        phase="mf_serve_check", n_items=CF_ITEMS, is_seqrec=False)
    return counts


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def cf_path(torch, card: str):
    """MF and MultiVAE through main.run on amazon-book-scale walks, each
    with the shared gates (falling finite loss, best validation hit@10 at
    least ten times chance, test from the best checkpoint equal), a step
    through the kernels against the plain versions and a traced step; MF
    then served from its checkpoint. Rows 6 and 8 in MF's training (8 on
    its block body), 5 and 5q in its serving, 6 in MultiVAE's (its history
    and every catalog row); row 8's line on one MF batch's (history,
    candidates). Returns (the path's launches, that line)."""
    from unirec_tpu_torch.ops import member as MB
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke"
    data, out = root / "cf_data", root / "cf"
    shutil.rmtree(out, ignore_errors=True)
    emit({"phase": "cf_data", **write_cf_data(data), "seconds": time.perf_counter() - t0})
    total = {}
    args = cf_args("MF", data, out)
    # MF's 19 negatives, 4 proposals each, are 76 candidates an example:
    # row 8 runs its block body (its warp body takes at most 64)
    seen, counts = run_and_gate(torch, args, "cf_path", CF_STEPS, CF_MIN_HIT10, card,
                                want=("scatter_add", "scatter_add_sorted", "member"),
                                none=("member_warp",), new_bodies=NEW_BODIES[:2], model="MF")
    add_counts(total, counts)
    store = []     # the step's one membership call: MF's (history, 76 candidates)
    with call_capture(MB, "_member_cuda", store):
        check_model_step(torch, "cf_path_check", seen["trainer"], seen["train_data"], model="MF")
    if len(store) != 1:
        raise AssertionError(f"cf_path: one MF batch called row 8 {len(store)} times, not once")
    member = member_line(torch, *store[0], "cf_path MF")
    del store
    profile_step(torch, seen["trainer"], seen["train_data"], "cf_path_profile", card, model="MF")
    del seen
    add_counts(total, mf_serve(torch, args, data, card))
    args = cf_args("MultiVAE", data, out)
    vae_steps = -(-(CF_USERS - 1) // VAE_BATCH)
    seen, counts = run_and_gate(torch, args, "cf_path", vae_steps, CF_MIN_HIT10, card,
                                want=("scatter_add", "scatter_add_sorted"), none=("member",),
                                model="MultiVAE")
    add_counts(total, counts)
    check_model_step(torch, "cf_path_check", seen["trainer"], seen["train_data"],
                     model="MultiVAE")
    profile_step(torch, seen["trainer"], seen["train_data"], "cf_path_profile", card,
                 model="MultiVAE")
    del seen
    torch.cuda.empty_cache()
    emit({"phase": "cf_path_launches", **total, "seconds": time.perf_counter() - t0})
    return total, member


# ------------------------------------------------------- the ranking models
# prepare-adaranker on ml-10m-adaranker.yaml's catalog (9,175 items, id 0 the
# padding), cut to ADA_USERS of its 69,584 users (the builder draws each
# request's negatives in a Python loop, about 1 ms a user on this host class):
# each user walks ADA_GROUP consecutive ids of the item's group for 6-10
# items, one category an item (18 of them); then AdaRanker by
# run_adaranker_pipeline.sh, RANK_STEPS batches of 256 of the training
# groups an epoch, RANK_EVAL_ROWS validation and test groups. BST at
# Beauty-rank.yaml's scale (22,364 users, 12,102 items) and FM at
# Beauty-libfm.yaml's (46,557 features), groups of 1 positive from the
# user's walk group and 20 negatives from outside it. The users' walk groups
# are drawn by a Zipf law (RANK_ZIPF_S): with uniform groups neither
# AdaRanker nor BST leaves chance in 100 steps (in both packages). Each model
# trains at its script's settings (lr 1e-3, BST 5e-4; BST.yaml's dropout 0.5)
# for RANK_EPOCHS epochs in place of 2: AdaRanker Base's best auc is 0.64 in
# 3, 0.83 in 4; BST's 0.60 in 8, 0.996 in 9 (PERF.md §4).
ADA_USERS, ADA_ITEMS, ADA_GROUP, ADA_CATES, ADA_NEG = 8192, 9176, 25, 18, 19
BEAUTY_USERS, BEAUTY_ITEMS, BEAUTY_FEATS, BEAUTY_GROUP, RANK_NEG = 22_364, 12_102, 46_557, 50, 20
RANK_STEPS, RANK_EVAL_ROWS, RANK_BATCH = 100, 4096, 400
RANK_EPOCHS = {"ada": 4, "BST": 10, "FM": 2}
RANK_MIN_AUC = 0.65                 # tests/test_rank_models.py's gate
RANK_ZIPF_S = 2.0                   # the skew of the users' walk groups
RANK_KERNELS = ("scatter_add", "scatter_add_sorted", "fused_attention", "fused_attention_mma",
                "fused_attention_bwd", "fused_attention_bwd_mma", "fused_ffn", "fused_ffn_mma",
                "fused_ffn_bwd", "fused_ffn_bwd_mma", "member")
BST_KERNELS = ("scatter_add", "scatter_add_sorted") + RANK_KERNELS[2:10]


def write_adaranker_raw(root: Path):
    """'user item item ...' lines and an item -> [category] JSON (item %
    ADA_CATES + 1): each user walks 6-10 consecutive ids of one group of
    ADA_GROUP, from a random offset, 10% of the items uniform; the first 3
    users of each group walk 10 items from offsets 0, 9 and 18 (so every
    item is walked), the others' groups are drawn by a Zipf law (RANK_ZIPF_S)
    over a random permutation of the groups (skewed popularity)."""
    import json
    rng = np.random.default_rng(SEED + 14)
    root.mkdir(parents=True, exist_ok=True)
    n_groups = (ADA_ITEMS - 1) // ADA_GROUP
    p = 1.0 / np.arange(1, n_groups + 1) ** RANK_ZIPF_S
    group_of = np.concatenate([np.repeat(np.arange(n_groups), 3), rng.permutation(n_groups)[
        rng.choice(n_groups, ADA_USERS - 3 * n_groups, p=p / p.sum())]])
    with open(root / "raw.txt", "w") as f:
        for u in range(1, ADA_USERS + 1):
            cover = u <= 3 * n_groups
            n = 10 if cover else int(rng.integers(6, 11))
            s = 9 * ((u - 1) % 3) if cover else int(rng.integers(0, ADA_GROUP))
            items = 1 + group_of[u - 1] * ADA_GROUP + (s + np.arange(n)) % ADA_GROUP
            noise = rng.random(n) < (0.0 if cover else 0.1)
            items[noise] = rng.integers(1, ADA_ITEMS, int(noise.sum()))
            f.write(f"{u} " + " ".join(map(str, items)) + "\n")
    (root / "item2cate.json").write_text(json.dumps(
        {str(i): [i % ADA_CATES + 1] for i in range(1, ADA_ITEMS)}))


def cut_rank_tables(data: Path, train_rows: int) -> None:
    """train_cut.pkl: ``train_rows`` of train.pkl (seed SEED + 15); valid_cut
    and test_cut: their first RANK_EVAL_ROWS rows."""
    import pandas as pd
    rng = np.random.default_rng(SEED + 15)
    train = pd.read_pickle(data / "train.pkl")
    pick = np.sort(rng.choice(len(train), min(train_rows, len(train)), replace=False))
    train.iloc[pick].reset_index(drop=True).to_pickle(data / "train_cut.pkl")
    for name in ("valid", "test"):
        pd.read_pickle(data / f"{name}.pkl").iloc[:RANK_EVAL_ROWS].to_pickle(
            data / f"{name}_cut.pkl")


def beauty_groups(rng, n_rows):
    """``n_rows`` ranking groups over Beauty-rank's catalog: user u walks
    BEAUTY_GROUP consecutive ids of group ``beauty_group_of`` (Zipf-drawn);
    a group's positive is an item of the user's walk group, its RANK_NEG
    negatives uniform over the other groups' items. Returns (users, items
    [n_rows, 1 + RANK_NEG], the users' walk groups, n_groups)."""
    n_groups = (BEAUTY_ITEMS - 1) // BEAUTY_GROUP
    users = rng.integers(1, BEAUTY_USERS, n_rows)
    ug = beauty_group_of(n_groups)[users]
    pos = 1 + ug * BEAUTY_GROUP + rng.integers(0, BEAUTY_GROUP, n_rows)
    negs = rng.integers(1, (n_groups - 1) * BEAUTY_GROUP + 1, (n_rows, RANK_NEG))
    negs = np.where((negs - 1) // BEAUTY_GROUP >= ug[:, None], negs + BEAUTY_GROUP, negs)
    return users, np.concatenate([pos[:, None], negs], 1), ug, n_groups


def beauty_group_of(n_groups):
    """Each Beauty user's walk group (index 0 unused): a Zipf law (RANK_ZIPF_S)
    over a random permutation of the groups, seed SEED + 18."""
    rng = np.random.default_rng(SEED + 18)
    p = 1.0 / np.arange(1, n_groups + 1) ** RANK_ZIPF_S
    return rng.permutation(n_groups)[rng.choice(n_groups, BEAUTY_USERS, p=p / p.sum())]


def write_bst_data(root: Path) -> None:
    """Beauty-rank's layout: user_history.pkl (every user's walk, 10-29
    items) and T4 train/valid/test tables of groups (beauty_groups):
    RANK_STEPS x RANK_BATCH training groups, RANK_EVAL_ROWS a held-out
    split."""
    import json

    import pandas as pd
    rng = np.random.default_rng(SEED + 16)
    root.mkdir(parents=True, exist_ok=True)
    n_groups = (BEAUTY_ITEMS - 1) // BEAUTY_GROUP
    users = np.arange(1, BEAUTY_USERS)
    lens = rng.integers(10, 30, len(users))
    group_of = beauty_group_of(n_groups)
    seqs = [1 + group_of[u] * BEAUTY_GROUP + (s + np.arange(n)) % BEAUTY_GROUP
            for u, n, s in zip(users, lens, rng.integers(0, BEAUTY_GROUP, len(users)))]
    pd.DataFrame({"user_id": users, "item_seq": seqs}).to_pickle(root / "user_history.pkl")
    label = np.zeros(1 + RANK_NEG, np.float32)
    label[0] = 1.0
    for name, rows in (("train", RANK_STEPS * RANK_BATCH), ("valid", RANK_EVAL_ROWS),
                       ("test", RANK_EVAL_ROWS)):
        u, items, _, _ = beauty_groups(rng, rows)
        pd.DataFrame({"user_id": u, "item_id_list": list(items),
                      "label_list": [label] * rows}).to_pickle(root / f"{name}.pkl")
    fmt = "user-item_group-label_group"
    (root / "data.info").write_text(json.dumps({
        "n_users": BEAUTY_USERS, "n_items": BEAUTY_ITEMS, "train_file_format": fmt,
        "valid_file_format": fmt, "test_file_format": fmt,
        "user_history_file_format": "user-item_seq"}))


def write_fm_data(root: Path) -> None:
    """Beauty-libfm's layout: T7 rows of three features each (the user's
    walk group, the item, the item's group; 1.0 values; BEAUTY_FEATS
    features in all), the groups of beauty_groups flattened positive first,
    RANK_STEPS x RANK_BATCH groups to train on, RANK_EVAL_ROWS a held-out
    split."""
    import json

    import pandas as pd
    rng = np.random.default_rng(SEED + 17)
    root.mkdir(parents=True, exist_ok=True)
    for name, rows in (("train", RANK_STEPS * RANK_BATCH), ("valid", RANK_EVAL_ROWS),
                       ("test", RANK_EVAL_ROWS)):
        _, items, ug, n_groups = beauty_groups(rng, rows)
        items = items.reshape(-1)
        idx = np.stack([1 + np.repeat(ug, 1 + RANK_NEG), 1 + n_groups + items,
                        1 + n_groups + BEAUTY_ITEMS + (items - 1) // BEAUTY_GROUP], 1)
        label = np.zeros((rows, 1 + RANK_NEG), np.float32)
        label[:, 0] = 1.0
        pd.DataFrame({"label": label.reshape(-1), "index_list": list(idx),
                      "value_list": list(np.ones(idx.shape, np.float32))}).to_pickle(
            root / f"{name}.pkl")
    fmt = "label-index_group-value_group"
    (root / "data.info").write_text(json.dumps({
        "n_users": BEAUTY_USERS, "n_items": BEAUTY_ITEMS, "n_feats": BEAUTY_FEATS,
        "train_file_format": fmt, "valid_file_format": fmt, "test_file_format": fmt}))


def rank_args(name: str, data: Path, out: Path, **over):
    """AdaRanker: run_adaranker_pipeline.sh (GRU base, d=64, L=10, dropout
    0.6, batch 256, lr 1e-3, one-vs-k, auc/group_auc); BST:
    run_bst_beauty_rank.sh (d=64, 2 layers, 4 heads, inner 128, L=20, lr
    5e-4, device_pipeline, key metric auc; BST.yaml's dropout 0.5) with
    use_fused_attention and use_fused_ffn; FM: run_fm_beauty_libfm.sh
    (RankDataset, group_size 21, d=64, lr 1e-3, auc). RANK_EPOCHS epochs;
    evaluated 400 groups a batch."""
    common = {"task": "train", "dataset_path": str(data), "output_path": str(out / name),
              "exp_name": name, "seed": SEED, "learning_rate": 1e-3,
              "valid_protocol": "one_vs_k", "test_protocol": "one_vs_k",
              "metrics": "['auc', 'group_auc']", "key_metric": "auc",
              "test_batch_size": RANK_BATCH, "embedding_size": 64, "n_sample_neg_train": 0}
    if name.startswith("ada"):
        return {**common, "model": "AdaRanker", "dataloader": "SeqRecDataset",
                "user_history_filename": "user_history", "data_train_name": "train_cut",
                "data_valid_name": "valid_cut", "data_test_name": "test_cut",
                "epochs": RANK_EPOCHS["ada"], "early_stop": 15, "batch_size": 256,
                "max_seq_len": 10,
                "dropout_prob": 0.6, "key_metric": "group_auc", "base_model": "GRU", **over}
    if name == "BST":
        return {**common, "model": "BST", "dataloader": "SeqRecDataset", "dataset": "Beauty-rank",
                "user_history_filename": "user_history", "n_layers": 2, "n_heads": 4,
                "inner_size": 128, "max_seq_len": 20, "learning_rate": 5e-4,
                "epochs": RANK_EPOCHS["BST"], "device_pipeline": 1,
                "use_fused_attention": 1, "use_fused_ffn": 1, "batch_size": RANK_BATCH}
    return {**common, "model": "FM", "dataloader": "RankDataset", "dataset": "Beauty-libfm",
            "group_size": 1 + RANK_NEG, "epochs": RANK_EPOCHS["FM"], "batch_size": RANK_BATCH}


def check_infer_rows(torch, args, rows: int):
    """task=infer from the best checkpoint: one line of 1 + RANK_NEG finite
    scores a test group."""
    from unirec_tpu_torch.main import main as main_mod
    out = Path(args["output_path"]) / "infer"
    t0 = time.perf_counter()
    main_mod.run({"task": "infer", "model_file": str(Path(args["output_path"]) / "checkpoint"
                                                     / f"{args['exp_name']}.pkl"),
                  "dataset_path": args["dataset_path"], "output_path": str(out),
                  "exp_name": "infer"})
    scores = np.loadtxt(out / "infer.infer.txt", ndmin=2)
    line = {"phase": "rank_infer", "model": args["model"], "rows": int(scores.shape[0]),
            "width": int(scores.shape[1]), "finite": bool(np.isfinite(scores).all()),
            "seconds": time.perf_counter() - t0}
    emit(line)
    if scores.shape != (rows, 1 + RANK_NEG) or not line["finite"]:
        raise AssertionError(f"rank_infer: {line}")


def rank_path(torch, card: str):
    """prepare-adaranker through the port's CLI, then AdaRanker's three
    stages (Base, Ada-Ranker, Ada-Ranker fine-tuned from the Base
    checkpoint), BST (then task=infer) and FM through main.run, each with the
    shared gates (best validation auc at least RANK_MIN_AUC), a step through
    the kernels against the plain versions and a traced step. Row 6 in
    AdaRanker and BST, rows 10-13 in BST, no kernel in FM. Returns the
    path's launches."""
    from unirec_tpu_torch import cli
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke"
    raw, ada, out = root / "ada_raw", root / "ada_data", root / "rank"
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(ada, ignore_errors=True)
    write_adaranker_raw(raw)
    t1 = time.perf_counter()
    if cli.main(["prepare-adaranker", "--infile", str(raw / "raw.txt"), "--item2cate_file",
                 str(raw / "item2cate.json"), "--out_dir", str(ada), "--n_neg_k", str(ADA_NEG),
                 "--pretrain_item_emb", "1", "--embedding_size", "64"]) != 0:
        raise AssertionError("prepare-adaranker failed")
    prep_s = time.perf_counter() - t1
    cut_rank_tables(ada, RANK_STEPS * 256)
    info = __import__("json").loads((ada / "data.info").read_text())
    emit({"phase": "rank_data", "adaranker": info, "prepare_adaranker_s": prep_s,
          "item_emb_rows": sum(1 for _ in open(ada / "item_emb_64.txt")),
          "seconds": time.perf_counter() - t0})
    if info["n_items"] != ADA_ITEMS:
        raise AssertionError(f"prepare-adaranker: {info}")
    total = {}
    stages = (("ada_base", {"train_type": "Base"}), ("ada_ranker", {"train_type": "Ada-Ranker"}),
              ("ada_finetune", {"train_type": "Ada-Ranker", "load_pretrained_model": 1,
                                "model_file": str(out / "ada_base" / "checkpoint"
                                                  / "ada_base.pkl")}))
    for name, over in stages:
        args = rank_args(name, ada, out, **over)
        seen, counts = run_and_gate(torch, args, "rank_path", RANK_STEPS, RANK_MIN_AUC, card,
                                    metric="auc", want=("scatter_add", "scatter_add_sorted"),
                                    none=BST_KERNELS[2:] + ("member",), model=name)
        add_counts(total, counts)
        check_model_step(torch, "rank_path_check", seen["trainer"], seen["train_data"],
                         model=name)
        if name == "ada_ranker":
            profile_step(torch, seen["trainer"], seen["train_data"], "rank_path_profile", card,
                         model=name)
        del seen
    t1 = time.perf_counter()
    bst, fm = root / "bst_data", root / "fm_data"
    write_bst_data(bst)
    write_fm_data(fm)
    emit({"phase": "rank_data", "beauty_s": time.perf_counter() - t1})
    args = rank_args("BST", bst, out)
    seen, counts = run_and_gate(torch, args, "rank_path", RANK_STEPS, RANK_MIN_AUC, card,
                                metric="auc", want=BST_KERNELS, none=("member",), model="BST")
    add_counts(total, counts)
    check_model_step(torch, "rank_path_check", seen["trainer"], seen["train_data"], model="BST")
    profile_step(torch, seen["trainer"], seen["train_data"], "rank_path_profile", card,
                 model="BST")
    del seen
    reset_counts()
    check_infer_rows(torch, args, RANK_EVAL_ROWS)
    infer_counts = launch_counts(RANK_KERNELS)
    if infer_counts["fused_attention_mma"] <= 0 or infer_counts["fused_ffn_mma"] <= 0:
        raise AssertionError(f"BST's infer never launched rows 10 and 12: {infer_counts}")
    add_counts(total, infer_counts)
    args = rank_args("FM", fm, out)
    seen, counts = run_and_gate(torch, args, "rank_path", RANK_STEPS, RANK_MIN_AUC, card,
                                metric="auc", none=tuple(sorted(set(CF_KERNELS + RANK_KERNELS))),
                                model="FM")
    check_model_step(torch, "rank_path_check", seen["trainer"], seen["train_data"], model="FM")
    profile_step(torch, seen["trainer"], seen["train_data"], "rank_path_profile", card,
                 model="FM")
    del seen
    torch.cuda.empty_cache()
    emit({"phase": "rank_path_launches", **total, "seconds": time.perf_counter() - t0})
    return total


def kernel_bst_shape(torch):
    """Rows 10-13 at BST's training shape: 400 groups of 21 candidates =
    8,400 sequences of L = 21 (the history of 20 and the candidate), 4 heads
    of 16, the key-padding mask [N, 1, 1, L]; the FFN over their 176,400
    tokens at d = 64, inner 128, swish; each in f32 and bf16, each against
    its plain version, timed, with its bound and the library call
    (scaled_dot_product_attention, forward and forward + backward;
    addmm -> silu -> addmm for row 12). Returns the bf16 lines by row."""
    import torch.nn.functional as F
    from unirec_tpu_torch.models.modules import causal_attention_mask
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.ops import ffn as FF
    g = torch.Generator(device="cuda").manual_seed(SEED + 95)
    N, H, L, hd, D, Fi = RANK_BATCH * (1 + RANK_NEG), 4, 21, 16, 64, 128
    seq = torch.randint(0, 4, (N, L), generator=g, device="cuda")
    seq[:, -1] = 1
    mask = causal_attention_mask(seq, bidirectional=True)
    rows = {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        tol = ATT_TOL if dt == "bfloat16" else 1e-5
        q, k, v, do = (torch.randn(N, H, L, hd, generator=g, device="cuda").to(dtype)
                       for _ in range(4))
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        lib_mask = mask.to(dtype)

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=lib_mask)
            torch.autograd.grad(o, (qs, ks, vs), do)

        with torch.enable_grad():
            lib_bwd = cuda_ms(lib_fwd_bwd, iters=10)
        out, ref = AT._fwd_cuda(q, k, v, mask), AT._fwd_plain(q, k, v, mask)
        flops = 4 * N * H * L * L * hd
        line = {"phase": "kernel", "name": "fused_attention", "what": "BST", "dtype": dt,
                "body": AT._fwd_body(dtype, L, hd), "shape": [N, H, L, hd],
                "mask": list(mask.shape),
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                "tol": tol * float(ref.float().abs().max()),
                "kernel_ms": cuda_ms(lambda: AT._fwd_cuda(q, k, v, mask)),
                "plain_ms": cuda_ms(lambda: AT._fwd_plain(q, k, v, mask), iters=5),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=lib_mask))}
        line["bound_ms"], line["bound_by"] = bound_ms(nbytes(q, k, v, mask, out), flops, dt)
        got, refb = AT._bwd_cuda(q, k, v, mask, do), AT._bwd_plain(q, k, v, mask, do)
        errs, _ = leaf_errs(got, refb)
        line_b = {"phase": "kernel", "name": "fused_attention_bwd", "what": "BST", "dtype": dt,
                  "body": AT._bwd_body(dtype, L, hd), "shape": [N, H, L, hd],
                  "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(got, refb)),
                  "max_rel_err": max(errs), "tol": BWD_TOL if dt == "bfloat16" else 1e-4,
                  "kernel_ms": cuda_ms(lambda: AT._bwd_cuda(q, k, v, mask, do), iters=10),
                  "plain_ms": cuda_ms(lambda: AT._bwd_plain(q, k, v, mask, do), iters=3),
                  "library_ms": lib_bwd,
                  "library_note": "scaled_dot_product_attention forward plus backward"}
        line_b["bound_ms"], line_b["bound_by"] = bound_ms(nbytes(q, k, v, mask, do, *got),
                                                          5 * flops // 2, dt)
        del q, k, v, do, qs, ks, vs, out, ref, got, refb
        rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device="cuda") * std).to(dtype)  # noqa: E731
        T = N * L
        x, w1, b1, w2, b2, dy = (rn(T, D), rn(D, Fi, std=0.2), rn(Fi, std=0.1),
                                 rn(Fi, D, std=0.2), rn(D, std=0.1), rn(T, D))
        y, yr = FF._fwd_cuda(x, w1, b1, w2, b2, "swish"), FF._fwd_plain(x, w1, b1, w2, b2, "swish")
        fl = 4 * T * D * Fi
        line_f = {"phase": "kernel", "name": "fused_ffn", "what": "BST", "dtype": dt,
                  "body": FF._fwd_body(dtype, D, Fi), "tokens": T, "d": D, "inner": Fi,
                  "max_abs_err": float((y.float() - yr.float()).abs().max()),
                  "tol": tol * float(yr.float().abs().max()),
                  "kernel_ms": cuda_ms(lambda: FF._fwd_cuda(x, w1, b1, w2, b2, "swish")),
                  "plain_ms": cuda_ms(lambda: FF._fwd_plain(x, w1, b1, w2, b2, "swish"), iters=5),
                  "library_ms": cuda_ms(lambda: torch.addmm(b2, F.silu(torch.addmm(b1, x, w1)),
                                                            w2)),
                  "library_note": "addmm -> silu -> addmm, three calls"}
        line_f["bound_ms"], line_f["bound_by"] = bound_ms(nbytes(x, w1, b1, w2, b2, y), fl, dt)
        gb, gr = FF.fused_ffn_bwd(x, w1, b1, w2, b2, dy, "swish"), \
            FF._bwd_plain(x, w1, b1, w2, b2, dy, "swish")
        errs, _ = leaf_errs(gb, gr)
        line_fb = {"phase": "kernel", "name": "fused_ffn_bwd", "what": "BST", "dtype": dt,
                   "body": FF._bwd_body(dtype, D, Fi), "tokens": T,
                   "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                      for a, b in zip(gb, gr)),
                   "max_rel_err": max(errs), "tol": BWD_TOL if dt == "bfloat16" else 1e-4,
                   "kernel_ms": cuda_ms(lambda: FF.fused_ffn_bwd(x, w1, b1, w2, b2, dy, "swish"),
                                        iters=10),
                   "plain_ms": cuda_ms(lambda: FF._bwd_plain(x, w1, b1, w2, b2, dy, "swish"),
                                       iters=3),
                   "library_ms": None}
        line_fb["bound_ms"], line_fb["bound_by"] = bound_ms(
            nbytes(x, w1, b1, w2, b2, dy, *gb), 3 * fl, dt)
        bad = []
        for ln in (line, line_b, line_f, line_fb):
            emit(ln)
            err = ln.get("max_rel_err", ln["max_abs_err"])
            if not err <= ln["tol"]:
                bad.append(ln["name"] + " " + dt)
        if bad:
            raise AssertionError(f"rows 10-13 at BST's shape disagree: {bad}")
        rows[dt] = {"fused_attention": line, "fused_attention_bwd": line_b,
                    "fused_ffn": line_f, "fused_ffn_bwd": line_fb}
        del x, w1, b1, w2, b2, dy, y, yr, gb, gr
        torch.cuda.empty_cache()
    return rows["bfloat16"]


# --------------------------------------------------------- serving export
# export_path: the serving checkpoint main_path wrote (bench.py's widths,
# fused_layer and fused_lastq, bf16) through torch.export on the card, each
# .pt2 function held against the live model through the kernels and through
# the plain versions; the ``score`` functions of that checkpoint, of the
# entry path's best checkpoint (use_fused_attention, use_fused_ffn) and of
# the long path's (use_pallas at L=256) as AOTInductor packages at batch
# 256, each served by the C++ client, whose launches of rows 1 and 3, 10
# and 12, 9 and 12 it prints; the entry checkpoint's user_emb program, rows
# 10 and 12 recorded and launched. Two builds run in the background, their
# seconds reported as measured there: the client's g++ in a thread from the
# script's first minute (beside the kernels' nvcc), and the three exports
# with their AOTInductor compiles (some 90 s of host compilation each on
# the card's machine) in processes started before solver_path, whose work
# is on the card (export_path runs after it).
EXPORT_ATOL = 2.0 ** -4     # the exporter's own check, artifact against live model (bf16)
EXPORT_REPEAT = 50          # timed calls of each serving form at batch 256
EXPORT_CANDIDATES = 32
EXPORT_KERNELS = ("layer_fwd", "layer_fwd_mma", "lastq_fwd", "lastq_fwd_mma",
                  "fused_attention", "fused_attention_mma", "fused_ffn", "fused_ffn_mma")
# the operators each package's graph calls (sorted, as export_model lists them)
CLIENT_OPS = {"bench": ["unirec::lastq_fwd", "unirec::layer_fwd"],
              "entry": ["unirec::attention_fwd", "unirec::ffn_fwd"],
              "long": ["unirec::ffn_fwd", "unirec::flash_fwd"]}
# the client's operator names -> the kernels' counter names
CLIENT_COUNTERS = (("unirec::layer_fwd", "layer_fwd"), ("unirec::lastq_fwd", "lastq_fwd"),
                   ("unirec::attention_fwd", "fused_attention"),
                   ("unirec::ffn_fwd", "fused_ffn"), ("unirec::flash_fwd", "flash_attention"))


def start_client_build():
    """g++ of serving/cpp/unirec_serve.cc in a thread: it runs while the
    kernels build and the first phases run. Returns the box client_build
    waits on."""
    import threading

    from unirec_tpu_torch.serving.cpp import build as CB
    box = {}

    def run():
        try:
            box["build"] = CB.build_client()
        except BaseException as e:     # noqa: BLE001 (re-raised by client_build)
            box["error"] = e

    box["thread"] = threading.Thread(target=run, daemon=True)
    box["thread"].start()
    return box


def client_build(box):
    box["thread"].join()
    if "error" in box:
        raise box["error"]
    return box["build"]


# the checkpoints export_path exports, each to a score package served by the
# C++ client: main_path's (rows 1, 3), entry_path's (rows 10, 12) and
# long_path's (rows 9, 12)
EXPORTS = {"bench": ("sasrec_bench.pkl", SEQ_LEN),
           "entry": ("slice/checkpoint/sasrec_fusedattn_ffn.pkl", SEQ_LEN),
           "long": ("long/checkpoint/sasrec_long256_flash.pkl", LONG_LEN)}


def start_export_compile():
    """Export each checkpoint of EXPORTS with its score package
    (export_model, which checks every artifact against the live model), one
    process each, all at once. Returns the box export_path waits on."""
    out = ROOT / "build" / "chip_smoke" / "export"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from unirec_tpu_torch.serving.export import export_model; "
            "export_model(sys.argv[2], sys.argv[3], aoti=['score'], aoti_batch=int(sys.argv[4]), "
            "atol=float(sys.argv[5]), device='cuda')")
    procs = {}
    for name, (ckpt, _) in EXPORTS.items():
        log = open(out / f"export_{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", code, str(ROOT),
             str(ROOT / "build" / "chip_smoke" / ckpt), str(out / name), str(BATCH),
             str(EXPORT_ATOL)], stdout=log, stderr=subprocess.STDOUT), log)
    return {"procs": procs, "t0": time.perf_counter(), "out": out}


def export_done(box) -> dict:
    """Wait for the export processes; raise with a log if one failed.
    Returns the wall seconds until the last ended."""
    failed = []
    for name, (proc, log) in box["procs"].items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} ({rc}):\n"
                          + (box["out"] / f"export_{name}.log").read_text()[-6000:])
    if failed:
        raise AssertionError("export_path: an export process failed: " + "\n".join(failed))
    return time.perf_counter() - box["t0"]


def stop_background(background) -> None:
    """Wait for the client's g++; end the export processes that still run
    (a failed phase): no process outlives the script."""
    if "client" in background:
        background["client"]["thread"].join()
    box = background.get("export")
    for proc, _ in (box or {}).get("procs", {}).values():
        if proc.poll() is None:
            proc.terminate()
            proc.wait()


def export_inputs(history, L=SEQ_LEN):
    """Batch-256 serving requests: users 1..256 with their history windows
    of length L, 32 random candidates each."""
    users = np.arange(1, BATCH + 1, dtype=np.int32)
    seq, lens = history.window(users, L)
    cands = np.random.default_rng(SEED + 150).integers(1, N_ITEMS, (BATCH, EXPORT_CANDIDATES))
    seq, lens, cands = (a.astype(np.int32) for a in (seq, lens, cands))
    return {"user_emb": (users, seq, lens), "item_emb": (users,),
            "score": (users, seq, lens, cands)}


def hold_artifact(torch, serve, model, name, args, want=()):
    """One function of an exported artifact on the card: its launches
    (each of ``want`` above 0), its output against the live model through
    the kernels and through the plain versions, each within emb_tol of the
    reference. Returns (line, the artifact's output)."""
    from unirec_tpu_torch.serving.export import ServeFunction
    module = ServeFunction(model, name)
    ids = [torch.as_tensor(a, device="cuda") for a in args]
    torch.cuda.synchronize()
    reset_counts()
    got = torch.as_tensor(getattr(serve, name)(*args))
    counts = launch_counts(EXPORT_KERNELS)
    with torch.no_grad():
        live = module(*ids).float().cpu()
        with plain_versions():
            plain = module(*ids).float().cpu()
    line = {"function": name, "shape": list(got.shape), "launches": counts,
            "max_abs_diff_live": float((got - live).abs().max()), "tol_live": emb_tol(live),
            "max_abs_diff_plain": float((got - plain).abs().max()), "tol_plain": emb_tol(plain),
            "finite": bool(torch.isfinite(got).all())}
    bad = [k for k in want if counts[k] <= 0]
    if bad or not (line["finite"] and line["max_abs_diff_live"] <= line["tol_live"]
                   and line["max_abs_diff_plain"] <= line["tol_plain"]):
        raise AssertionError(f"export_path: {name} disagrees or missed {bad}: {line}")
    return line, got


def timed_calls(torch, fn, n=EXPORT_REPEAT):
    """Seconds a call of fn over n calls after one, synced on both sides."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def export_path(torch, card: str, background):
    """The serving export on the card (module comment above). Returns
    (the Python artifacts' launches, the client's launches)."""
    from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
    from unirec_tpu_torch.serving.cpp import build as CB
    from unirec_tpu_torch.serving.export import ServingModel
    from unirec_tpu_torch.utils.checkpoint import load_model_freely
    t_phase = time.perf_counter()
    export_all_s = export_done(background["export"])
    out = background["export"]["out"]
    ckpt = ROOT / "build" / "chip_smoke" / "sasrec_bench.pkl"
    man = json.loads((out / "bench" / "manifest.json").read_text())
    fns = man["functions"]
    want = ["unirec::lastq_fwd", "unirec::layer_fwd"]
    if fns["user_emb"]["custom_ops"] != want or fns["score"]["aoti"]["custom_ops"] != want:
        raise AssertionError(f"export_path: the graphs call {fns}, not {want}")
    history = synthetic_history()
    reqs = export_inputs(history)
    model, cfg = load_model_freely(str(ckpt), "cuda")
    serve = ServingModel(str(out / "bench"))
    total = dict.fromkeys(EXPORT_KERNELS, 0)
    lines, outs = [], {}
    for name in ("user_emb", "item_emb", "score"):
        line, outs[name] = hold_artifact(
            torch, serve, model, name, reqs[name],
            want=() if name == "item_emb" else ("layer_fwd_mma", "lastq_fwd_mma"))
        add_counts(total, line["launches"])
        lines.append(line)
    # the C++ client on each AOTInductor package: rows 1 and 3 (bench), 10
    # and 12 (entry), 9 and 12 (long) from its shims
    build = client_build(background["client"])
    libs = CB.kernel_libs()
    clients, client, entry_line = {}, None, None
    for name, (ckpt_name, L) in EXPORTS.items():
        man_n = json.loads((out / name / "manifest.json").read_text())
        want_n = CLIENT_OPS[name]
        if man_n["functions"]["score"]["aoti"]["custom_ops"] != want_n:
            raise AssertionError(f"export_path: the {name} package calls "
                                 f"{man_n['functions']['score']['aoti']['custom_ops']}, "
                                 f"not {want_n}")
        model_n = model if name == "bench" else load_model_freely(
            str(ROOT / "build" / "chip_smoke" / ckpt_name), "cuda")[0]
        serve_n = serve if name == "bench" else ServingModel(str(out / name))
        req = reqs if name == "bench" else export_inputs(history, L)
        if name == "entry":
            # the program's user_emb on the card, rows 10 and 12 recorded
            entry_line, _ = hold_artifact(torch, serve_n, model_n, "user_emb", req["user_emb"],
                                          want=("fused_attention_mma", "fused_ffn_mma"))
            add_counts(total, entry_line["launches"])
        score = outs["score"] if name == "bench" else torch.as_tensor(
            serve_n.score(*req["score"]))
        res = CB.run_client(build["binary"], out / name / "score.aoti.pt2", req["score"],
                            libs=libs, repeat=EXPORT_REPEAT, timeout=600)
        c_out = torch.as_tensor(res["outputs"][0])
        with torch.no_grad(), plain_versions():
            from unirec_tpu_torch.serving.export import ServeFunction
            plain = ServeFunction(model_n, "score")(
                *[torch.as_tensor(a, device="cuda") for a in req["score"]]).float().cpu()
        calls = res["calls"]
        line = {"package": name, "max_seq_len": L, "device": res["device"], "calls": calls,
                "launches": res["launches"], "launches_mma": res["launches_mma"],
                "max_abs_diff_artifact": float((c_out - score).abs().max()),
                "tol_artifact": emb_tol(score),
                "max_abs_diff_plain": float((c_out - plain).abs().max()),
                "tol_plain": emb_tol(plain), "ms_per_call": res["seconds_per_call"] * 1e3}
        # each row once a layer that runs it, a call: the last-query layer's
        # attention is plain, the FFN runs in both layers
        per_call = {op: 2 if op == "unirec::ffn_fwd" else 1 for op in want_n}
        bad = [op for op in want_n if res["launches"].get(op) != per_call[op] * calls
               or res["launches_mma"].get(op) != per_call[op] * calls]
        if res["device"] != "cuda" or bad or not (
                line["max_abs_diff_artifact"] <= line["tol_artifact"]
                and line["max_abs_diff_plain"] <= line["tol_plain"]):
            raise AssertionError(f"export_path: the C++ client disagrees on the {name} "
                                 f"package or missed {bad}: {line}")
        clients[name] = line
        if name == "bench":
            client = res
        else:
            del model_n
    client_line = clients.pop("bench")
    # users/s at batch 256: the client, the .pt2 program and the package in
    # Python (inputs on the card), and reco-topk's top-100 over the catalog
    pkg = out / "bench" / "score.aoti.pt2"
    ids = [torch.as_tensor(a, device="cuda") for a in reqs["score"]]
    pt2 = serve._fns["score"]
    aoti = torch._inductor.aoti_load_package(str(pkg))
    with torch.no_grad():
        s_pt2 = timed_calls(torch, lambda: pt2(*ids))
        s_aoti = timed_calls(torch, lambda: aoti(*ids))
    users = np.arange(1, SERVE_USERS + 1, dtype=np.int64)
    get_topk_recommendations(cfg, model, users[:BATCH], history, TOPK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    get_topk_recommendations(cfg, model, users, history, TOPK)
    torch.cuda.synchronize()
    topk_s = time.perf_counter() - t0
    man2 = json.loads((out / "entry" / "manifest.json").read_text())
    emit({"phase": "export_path", "functions": lines, "batch": BATCH,
          "export_s": {k: v["export_s"] for k, v in fns.items()},
          "export_process_s": export_all_s, "aoti_cxx": fns["score"]["aoti"]["cxx"],
          "aoti_compile_s": fns["score"]["aoti"]["compile_s"],
          "client_build_s": build["seconds"], "client": client_line,
          "score_users_per_s": {"cpp_client": BATCH / client["seconds_per_call"],
                                "pt2_python": BATCH / s_pt2, "aoti_python": BATCH / s_aoti},
          "score_ms_per_batch": {"cpp_client": client["seconds_per_call"] * 1e3,
                                 "pt2_python": s_pt2 * 1e3, "aoti_python": s_aoti * 1e3},
          "reco_topk_users_per_s": SERVE_USERS / topk_s,
          "fused_attention_ffn": {"export_s": {k: v["export_s"]
                                               for k, v in man2["functions"].items()},
                                  **entry_line},
          "client_packages": clients,
          "launches": total, "seconds": time.perf_counter() - t_phase, "card": card})
    # the client's launches of every package, under the kernels' counter names
    client_counts = {}
    for res in [client] + [{"launches": v["launches"], "launches_mma": v["launches_mma"]}
                           for v in clients.values()]:
        add_counts(client_counts, {c: res["launches"].get(op, 0) for op, c in CLIENT_COUNTERS})
        add_counts(client_counts, {f"{c}_mma": res["launches_mma"].get(op, 0)
                                   for op, c in CLIENT_COUNTERS})
    return total, client_counts


def approx_topk(torch, card: str):
    """reco-topk (do_topk_reco) of 4,096 users from the serving checkpoint
    over the entry data's histories, exact and then with
    topk_recall_target 0.95: the two CSVs must be equal byte for byte (the
    port selects exactly; recall 1.0) and row 5 must launch. Returns the
    approximate run's launches."""
    from unirec_tpu_torch.main.reco_topk import do_topk_reco
    out = ROOT / "build" / "chip_smoke" / "approx"
    out.mkdir(parents=True, exist_ok=True)
    users = np.arange(1, SERVE_USERS + 1, dtype=np.int64)
    np.savetxt(out / "users.txt", users, fmt="%d")
    conf = {"model_file": str(ROOT / "build" / "chip_smoke" / "sasrec_bench.pkl"),
            "dataset_path": str(ROOT / "build" / "chip_smoke" / "slice_data"),
            "dataset_name": str(out / "users.txt"), "topk": TOPK, "test_batch_size": BATCH,
            "user_history_filename": "user_history",
            "user_history_file_format": "user-item_seq"}
    secs, counts = {}, {}
    for name, extra in (("exact", {}), ("approx", {"topk_recall_target": 0.95})):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        do_topk_reco(dict(conf, output_path=str(out / f"{name}.csv"), **extra))
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts[name] = launch_counts(SERVING_KERNELS)
    same = (out / "exact.csv").read_bytes() == (out / "approx.csv").read_bytes()
    emit({"phase": "approx_topk", "users": SERVE_USERS, "topk": TOPK, "batch": BATCH,
          "recall_target": 0.95, "csv_equal": same, "recall": 1.0 if same else None,
          "entry_users_per_s": {k: SERVE_USERS / v for k, v in secs.items()},
          "launches": counts["approx"], "card": card})
    if not same or counts["approx"]["blockmax_mma"] <= 0:
        raise AssertionError(f"approx_topk: CSV equal {same}, launches {counts['approx']}")
    return counts["approx"]


# -------------------------------------------------------------------- MoRec
# MF at amazon-electronics.yaml's width (103,317 users, 39,575 items) on
# synthetic walks (cf_path's recipe, groups of 200 ids; 4,096 validation and
# test users) with an item_meta_morec.csv from the seed: prices uniform in
# [1, 50], fair groups the walk group mod 10 (plus 1), align groups the
# training popularity's deciles, and an align_dist file (the deciles'
# square-root-flattened shares). run_base_model.sh's base (9 negatives, the
# user table, lr 1e-3; BPR, as tests/test_morec.py's pretrain and the
# fine-tune, where the script names BCE) for MOREC_BASE_EPOCHS epochs of
# 100 batches of 2,048, then run_morec_electronics.sh's fine-tune (BPR, the
# PI gains and beta band, [0.1, 0.1, 0.8] inner weights, objectives
# fairness, alignment and revenue with morec_ngroup [10, 10, -1]) for
# MOREC_EPOCHS epochs of MOREC_STEPS MoRec batches (4 blocks of MOREC_BATCH
# rows), once with PID (the fused PI step) and once with Pareto (MGDA: the
# Gram from 4 backward passes). Cuts: 6 and 2 epochs in place of 100 and 30,
# the training table cut to the steps, no TensorBoard.
MOREC_USERS, MOREC_ITEMS, MOREC_BATCH, MOREC_STEPS = 103_317, 39_575, 1024, 50
MOREC_BASE_EPOCHS, MOREC_EPOCHS = 6, 2
MOREC_METRICS = "['hit@10', 'ndcg@10', 'rhit@10', 'rndcg@10', 'pop-kl@10', 'least-misery']"
MOREC_MIN_HIT10 = 10 * 10 / MOREC_ITEMS          # ten times chance
MOREC_TOL = 1e-4     # loss vector and Gram, kernels against plain, of the largest entry


def write_morec_data(root: Path) -> dict:
    import pandas as pd
    rng = np.random.default_rng(SEED + 170)
    users, n, starts, owner, items, is_train = slice_walks(
        rng, CF_HIST, CF_GROUP, 2, n_users=MOREC_USERS, n_items=MOREC_ITEMS)
    write_train_tables(root, rng, users, n, owner, items, is_train, CF_STEPS * MF_BATCH,
                       ("user-item", "user-item"), n_users=MOREC_USERS, n_items=MOREC_ITEMS)
    pd.read_pickle(root / "train.pkl").iloc[:MOREC_STEPS * MOREC_BATCH].to_pickle(
        root / "train_morec.pkl")
    for name, off in (("valid", 0), ("test", 1)):
        who = np.sort(rng.choice(len(users), CF_EVAL_USERS, replace=False))
        pd.DataFrame({"user_id": users[who],
                      "item_id": items[starts[who] + n[who] + off]}).to_pickle(root / f"{name}.pkl")
    ids = np.arange(1, MOREC_ITEMS)
    pop = np.bincount(items[is_train], minlength=MOREC_ITEMS)[1:]
    align = np.empty(len(ids), np.int64)
    for g, bucket in enumerate(np.array_split(np.argsort(-pop, kind="stable"), 10), start=1):
        align[bucket] = g
    pd.DataFrame({"item_id": ids, "weight": np.round(rng.uniform(1.0, 50.0, len(ids)), 2),
                  "fair_group": (ids - 1) // CF_GROUP % 10 + 1,
                  "align_group": align}).to_csv(root / "item_meta_morec.csv", index=False)
    share = np.sqrt(np.array([pop[align == g].sum() for g in range(1, 11)], np.float64))
    pd.DataFrame({"group_id": np.arange(10), "proportion": share / share.sum()}).to_csv(
        root / "align_dist.tsv", index=False)
    return {"users": len(users), "train_pairs": int(is_train.sum())}


def morec_args(data: Path, out: Path, controller=None, base_ckpt=None):
    """run_base_model.sh's base, or with ``controller``
    run_morec_electronics.sh's fine-tune from ``base_ckpt``."""
    common = {"task": "train", "model": "MF", "dataloader": "BaseDataset",
              "dataset_path": str(data), "seed": SEED, "has_user_emb": 1,
              "user_history_filename": "user_history", "valid_protocol": "one_vs_all",
              "test_protocol": "one_vs_all", "test_batch_size": EVAL_BATCH,
              "learning_rate": 1e-3, "metrics": MOREC_METRICS, "key_metric": "ndcg@10",
              "item_meta_morec_filename": "item_meta_morec.csv", "shuffle_train": 1}
    if controller is None:
        return {**common, "output_path": str(out / "base"), "exp_name": "morec-base",
                "loss_type": "bpr", "n_sample_neg_train": 9, "batch_size": MF_BATCH,
                "epochs": MOREC_BASE_EPOCHS, "early_stop": 10, "embedding_size": 64,
                "neg_membership_pallas": 1}
    return {**common, "output_path": str(out / controller), "exp_name": f"morec-{controller}",
            "load_pretrained_model": 1, "model_file": str(base_ckpt), "enable_morec": 1,
            "data_train_name": "train_morec", "morec_objective_controller": controller,
            "morec_objectives": ["fairness", "alignment", "revenue"],
            "morec_ngroup": [10, 10, -1], "morec_alpha": 0.01, "morec_lambda": 0.2,
            "morec_expect_loss": 0.25, "morec_beta_min": 0.1, "morec_beta_max": 1.5,
            "morec_K_p": 0.05, "morec_K_i": 0.001, "morec_objective_weights": "[0.1,0.1,0.8]",
            "align_dist_filename": "align_dist.tsv", "loss_type": "bpr",
            "batch_size": MOREC_BATCH, "epochs": MOREC_EPOCHS, "early_stop": -1}


def morec_check(torch, trainer, batch, card):
    """One MoRec batch at the trained weights: the loss vector and the Gram
    of its 4 per-objective gradients through the kernels and through the
    plain versions (MOREC_TOL of each's largest entry), row 6 launched once
    for each gathered table in each objective's backward; then the
    breakdown of one MGDA step (forward, the 4 backward passes, the Gram,
    the update) synced part by part, and a traced step."""
    from unirec_tpu_torch.facility.morec import integration as TI
    n_blocks = trainer._morec_sampler.n_blocks

    def vec_and_gram():
        vec = TI.loss_vector(trainer, batch, SEED + 93, n_blocks)
        return vec.detach(), TI.gram(TI.objective_grads(trainer.params, vec))

    torch.cuda.synchronize()
    reset_counts()
    vec_k, gram_k = vec_and_gram()
    scatter = launch_counts(("scatter_add", "scatter_add_sorted"))
    with plain_versions():
        vec_p, gram_p = vec_and_gram()
    # one plain backward of the same batch: the tables a backward scatters into
    reset_counts()
    torch.autograd.grad(TI.loss_vector(trainer, batch, SEED + 93, n_blocks).sum(),
                        trainer.params, allow_unused=True)
    tables = launch_counts(("scatter_add",))["scatter_add"]
    line = {"phase": "morec_check", "rows": int(batch["weight"].shape[0]), "blocks": n_blocks,
            "loss_vector": vec_k.cpu().tolist(),
            "loss_max_rel_diff": float((vec_k - vec_p).abs().max() / vec_p.abs().max()),
            "gram_max_rel_diff": float((gram_k - gram_p).abs().max() / gram_p.abs().max()),
            "tol": MOREC_TOL, "scatter_launches": scatter, "tables_per_backward": tables}
    torch.cuda.synchronize()
    parts = {}
    t0 = time.perf_counter()
    vec = TI.loss_vector(trainer, batch, SEED + 94, n_blocks)
    torch.cuda.synchronize()
    parts["forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = TI.objective_grads(trainer.params, vec)
    torch.cuda.synchronize()
    parts["backward_x4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    G = TI.gram(rows).cpu()
    parts["gram"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.apply_update(vec.detach().sum(), TI.combine(rows, [0.25] * n_blocks))
    torch.cuda.synchronize()
    parts["update"] = time.perf_counter() - t0
    step = sum(parts.values())
    line.update(step_ms_parts={k: v * 1e3 for k, v in parts.items()}, step_ms=step * 1e3,
                gram_share=parts["gram"] / step,
                gram_and_backwards_share=(parts["gram"] + parts["backward_x4"]) / step,
                gram_finite=bool(torch.isfinite(G).all()), card=card)
    emit(line)
    if not (line["loss_max_rel_diff"] <= MOREC_TOL and line["gram_max_rel_diff"] <= MOREC_TOL
            and scatter["scatter_add"] == n_blocks * tables and tables > 0
            and scatter["scatter_add_sorted"] == scatter["scatter_add"]):
        raise AssertionError(f"morec_check: kernels disagree with the plain versions or row 6 "
                             f"did not launch once a table in each objective's backward: {line}")


def morec_path(torch, card: str):
    """The MoRec path (module comment above): the base through run_and_gate;
    each fine-tune through run_spied with the beta band (PID), the
    sampler's weights (summing to 1 and moving between epochs), finite
    losses, task=test from the best checkpoint equal, best validation
    hit@10 at least ten times chance, and row 6's launches exactly once a
    table in each backward (PID one a step, MGDA four); morec_check on an
    MGDA batch; ms a step and a traced step of each. Returns the launches."""
    from unirec_tpu_torch.facility.morec import integration as TI
    from unirec_tpu_torch.facility.morec.sampler import MoRecBatcher
    from unirec_tpu_torch.main import main as main_mod
    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke"
    data, out = root / "morec_data", root / "morec"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    emit({"phase": "morec_data", **write_morec_data(data), "seconds": time.perf_counter() - t0})
    total = {}
    seen, counts = run_and_gate(torch, morec_args(data, out), "morec_base", CF_STEPS,
                                MOREC_MIN_HIT10, card, want=("scatter_add", "member"))
    add_counts(total, counts)
    del seen
    base_ckpt = out / "base" / "checkpoint" / "morec-base.pkl"
    tables = 2                          # MF's gathers: the user and the item table
    for controller, backwards in (("PID", 1), ("Pareto", 4)):
        args = morec_args(data, out, controller, base_ckpt)
        betas, weights, batches = [], [], []
        pi, refresh, assemble = TI.pi_update, MoRecBatcher.refresh_weights, \
            MoRecBatcher._assemble

        def spy_pi(state, acc, cfg):
            beta, new = pi(state, acc, cfg)
            betas.append(beta)
            return beta, new

        def spy_refresh(self):
            refresh(self)
            weights.append({k: v.copy() for k, v in self.group2weights.items()})

        def spy_assemble(self, idx, weight, rng):
            b = assemble(self, idx, weight, rng)
            if not batches:
                batches.append(b)
            return b

        with mock.patch.object(TI, "pi_update", spy_pi), \
                mock.patch.object(MoRecBatcher, "refresh_weights", spy_refresh), \
                mock.patch.object(MoRecBatcher, "_assemble", spy_assemble):
            seen = run_spied(torch, args)
        counts = launch_counts(sorted(set(CF_KERNELS + RANK_KERNELS)))
        add_counts(total, counts)
        loss, valid = seen["loss"], seen["evals"][:-1]
        again = main_mod.run({"task": "test", "model_file": str(
            Path(args["output_path"]) / "checkpoint" / f"{args['exp_name']}.pkl"),
            "dataset_path": args["dataset_path"],
            "output_path": str(Path(args["output_path"]) / "test")})
        beta = torch.stack(betas).float().cpu().numpy() if betas else np.zeros(0)
        # weights[0]: the peek at fit's start (no parameters yet: unchanged);
        # then one refresh an epoch
        moved = {k: [float(np.abs(b[k] - a[k]).sum()) for a, b in zip(weights, weights[1:])]
                 for k in weights[0]}
        sums = {k: [float(w[k].sum()) for w in weights] for k in weights[0]}
        last_s = seen["marks"][-2] - seen["marks"][-3]
        line = {"phase": "morec_path", "controller": controller, "steps": len(loss),
                "epochs": MOREC_EPOCHS, "rows_per_step": 4 * MOREC_BATCH,
                "ms_per_step": last_s * 1e3 / MOREC_STEPS,
                "examples_per_s": 4 * MOREC_BATCH * MOREC_STEPS / last_s,
                "first_losses": loss[:3].tolist(), "last_losses": loss[-3:].tolist(),
                "beta_min_max": [float(beta.min()), float(beta.max())] if len(beta) else None,
                "weight_sums": sums, "weight_moves": moved,
                "valid": [{"result": r, "seconds": s} for r, s, _ in valid],
                "test": seen["result"], "test_from_checkpoint_equal": again == seen["result"],
                "launches": counts, "run_s": seen["run_s"], "card": card}
        emit(line)
        want_scatter = len(loss) * backwards * tables
        errors = []
        if len(loss) != MOREC_STEPS * MOREC_EPOCHS or not np.isfinite(loss).all():
            errors.append(f"losses {loss.tolist()}")
        if controller == "PID" and not (len(beta) == len(loss) and beta.min() >= 0.1
                                        and beta.max() <= 1.5):
            errors.append(f"beta left [0.1, 1.5]: {beta.tolist()}")
        if not all(abs(s - 1.0) < 1e-6 for v in sums.values() for s in v) or \
                not any(m > 0 for k in ("fairness", "alignment") for m in moved[k][1:]):
            errors.append(f"sampler weights: sums {sums}, moves {moved}")
        if again != seen["result"]:
            errors.append(f"test from the checkpoint {again} != {seen['result']}")
        if not max(r["hit@10"] for r, _, _ in valid) >= MOREC_MIN_HIT10:
            errors.append(f"validations {valid}")
        if counts["scatter_add"] != want_scatter or \
                counts["scatter_add_sorted"] != want_scatter:
            errors.append(f"row 6 launched {counts['scatter_add']} times, not {want_scatter} "
                          f"({backwards} backward(s) a step, {tables} tables)")
        if errors:
            raise AssertionError(f"morec_path {controller}: " + "; ".join(errors))
        from unirec_tpu_torch.utils import to_device
        batch = to_device(batches[0], "cuda")
        trainer = seen["trainer"]
        trainer.train_step(batch)
        torch.cuda.synchronize()
        emit({"phase": "morec_profile", "controller": controller, "what": "one train step",
              **device_profile(torch, lambda: trainer.train_step(batch)), "card": card})
        if controller == "Pareto":
            morec_check(torch, trainer, batch, card)
        del seen, trainer, batch, batches
        torch.cuda.empty_cache()
    emit({"phase": "morec_path_launches", **total, "seconds": time.perf_counter() - t_phase})
    return total


# ---------------------------------------------------------- the solver models
# gowalla.yaml's CF benchmark at its published size: 29,859 users and 40,982
# items once convert-adjacency has shifted the 0-based ids of the split files
# up by one. Synthetic walks (seed SEED + 14) of SOLVER_ITEMS[0]..[1]-1 items a
# user through groups of SOLVER_GROUP consecutive ids (WALK_NOISE of them
# uniform), about 27 training items a user as gowalla's ~810k training
# interactions, split 8:1:1 per user in order as run_prepare_data-CF_8_1_1.sh
# splits them and written as train.txt / val.txt / test.txt "user item item
# ..." lines. The users' groups are drawn by a Zipf law (SOLVER_ZIPF_S), as
# check-ins concentrate on popular places: SLIM.yaml's l1 keeps a weight only
# where two items co-occur more than n l1 = 119 times (n the users), and over
# uniform groups no pair does (about 20 at most), so every SLIM weight is 0,
# in both packages. Each solver trains through main.run at train_cf_model.sh's
# options. Depth cuts, to keep the phase near 150 s: AdmmSLIM runs ADMM_ITERS
# of its 100 iterations (each one f32 [N, N] @ [N, N], at least 2.1 s at 67
# TFLOP/s), SLIM's full descent on SOLVER_CUT items SLIM_FULL_SWEEPS of its 30.
GOWALLA_USERS, GOWALLA_ITEMS = 29_859, 40_982
SOLVER_ITEMS, SOLVER_GROUP, SOLVER_ZIPF_S = (20, 49), 200, 1.0
SOLVERS = ("EASE", "AdmmSLIM", "SLIM", "SAR", "UserCF")
ADMM_ITERS, SLIM_FULL_SWEEPS = 5, 10
SWEEP_SIZE = 8_192       # users and items of the cli sweep's cut
# the cross-check of the card against the port's CPU run: the first
# SOLVER_CUT items of the first SOLVER_CUT_USERS users; EASE's LU tier on the
# first LU_CUT items; one full SLIM sweep timed at SLIM_SWEEP_N items
SOLVER_CUT, SOLVER_CUT_USERS, LU_CUT, SLIM_SWEEP_N, SLIM_K = 2000, 8192, 8000, 4096, 256
# card against CPU, each matrix's largest difference over its largest entry:
# f32 on both sides, summed in another order (the Gram products and the
# inverse), with the iterations of AdmmSLIM and SLIM carrying the roundings
SOLVER_TOL = {"EASE": 1e-4, "SAR": 1e-4, "UserCF": 1e-4, "AdmmSLIM": 1e-3, "SLIM": 1e-3,
              "SLIM_active_set": 1e-3, "EASE_lu_vs_blocked": 1e-4}
EASE_RESIDUAL_TOL = 1e-3          # |G P[:, S] - I[:, S]|_max, 256 sampled columns S


def write_gowalla_splits(raw: Path, users: int = GOWALLA_USERS,
                         catalog: int = GOWALLA_ITEMS) -> dict:
    """train.txt / val.txt / test.txt of 0-based "user item item ..." lines
    (gowalla's width unless ``users`` and ``catalog`` say otherwise):
    every user walks its group (drawn with probability 1 / rank^SOLVER_ZIPF_S)
    one id up at each step from a random start, wrapping inside the group;
    repeats are dropped in order;
    the first 80% of a user's items train, the next 10% validate, the rest
    test. The catalog's last id is the last user's last test item."""
    rng = np.random.default_rng(SEED + 14)
    n_users, n_items = users - 1, catalog - 1
    n = rng.integers(*SOLVER_ITEMS, size=n_users)
    owner = np.repeat(np.arange(n_users), n)
    starts = np.concatenate([[0], np.cumsum(n)[:-1]])
    pos = np.arange(len(owner)) - np.repeat(starts, n)
    start = np.repeat(rng.integers(0, SOLVER_GROUP, n_users), n)
    p = 1.0 / np.arange(1, n_items // SOLVER_GROUP + 1) ** SOLVER_ZIPF_S
    group = np.repeat(rng.choice(len(p), n_users, p=p / p.sum()), n)
    items = group * SOLVER_GROUP + (start + pos) % SOLVER_GROUP
    items = np.where(rng.random(len(owner)) < WALK_NOISE,
                     rng.integers(0, n_items, len(owner)), items)
    items[-1] = n_items - 1
    raw.mkdir(parents=True, exist_ok=True)
    counts = {"train": 0, "valid": 0, "test": 0}
    with open(raw / "train.txt", "w") as ft, open(raw / "val.txt", "w") as fv, \
            open(raw / "test.txt", "w") as fs:
        for u, seq in enumerate(np.split(items, starts[1:])):
            seq = list(dict.fromkeys(seq.tolist()))
            k = len(seq)
            a = int(round(0.8 * k))
            b = a + max(1, int(round(0.1 * k)))
            for f, part, key in ((ft, seq[:a], "train"), (fv, seq[a:b], "valid"),
                                 (fs, seq[b:], "test")):
                f.write(f"{u} {' '.join(map(str, part))}\n")
                counts[key] += len(part)
    return {"users": n_users, **counts, "valid_positives_per_user": counts["valid"] / n_users}


def check_fastio(data: Path, card: str):
    """One text table (the training histories as "user_id, item_seq" rows)
    read by the native parser and by pandas: equal frames, both timed."""
    import os

    import pandas as pd

    from unirec_tpu_torch.utils import fastio, file_io
    hist = pd.read_pickle(data / "user_history.pkl")
    path = data / "train_seq.tsv"
    with open(path, "w") as f:
        f.write("user_id\titem_seq\n")
        f.writelines(f"{u}\t{','.join(map(str, s))}\n"
                     for u, s in zip(hist["user_id"], hist["item_seq"]))
    t0 = time.perf_counter()
    fastio.get_lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = fastio.load_txt_table_native(str(path), file_io._LIST_INT_COLS,
                                          file_io._LIST_FLOAT_COLS)
    native_s = time.perf_counter() - t0
    with mock.patch.dict(os.environ, {"UNIREC_FASTIO": "0"}):
        t0 = time.perf_counter()
        ref = file_io.load_txt_table(str(path))
        pandas_s = time.perf_counter() - t0
    same = native is not None and list(native.columns) == list(ref.columns) \
        and np.array_equal(native["user_id"].to_numpy(), ref["user_id"].to_numpy()) \
        and native["user_id"].dtype == ref["user_id"].dtype \
        and all(np.array_equal(x, y) and x.dtype == y.dtype
                for x, y in zip(native["item_seq"], ref["item_seq"]))
    emit({"phase": "solver_fastio", "rows": len(ref), "bytes": path.stat().st_size,
          "build_s": build_s, "native_s": native_s, "pandas_s": pandas_s, "equal": bool(same),
          "library": fastio.library_path().name, "card": card})
    if not same:
        raise AssertionError("solver_fastio: the native parser's frame differs from pandas'")


def solver_args(name: str, data: Path, out: Path, **over):
    """examples/training/train_cf_model.sh for a solver model: AERecDataset,
    no sampled negatives, one-vs-all validation and test, hit and ndcg at 5,
    10 and 20 (the SGD options it also passes are read by no solver);
    AdmmSLIM at ADMM_ITERS iterations."""
    return {"task": "train", "model": name, "dataloader": "AERecDataset",
            "dataset_path": str(data), "output_path": str(out / name), "exp_name": name,
            "seed": SEED, "learning_rate": 1e-3, "early_stop": 10, "batch_size": 1024,
            "epochs": ADMM_ITERS if name == "AdmmSLIM" else 100, "embedding_size": 64,
            "test_protocol": "one_vs_all", "valid_protocol": "one_vs_all",
            "metrics": "['hit@5;10;20', 'ndcg@5;10;20']", "key_metric": "ndcg@5",
            "user_history_filename": "user_history", "n_sample_neg_train": 0, **over}


@contextmanager
def solver_spies(torch, seen, keep_cols=None):
    """Time main.run's solver parts (each synced on both sides) into
    ``seen``: the solve, the Gram products, the inverse, SLIM's candidates
    and descent, each evaluation (seconds and rows) and the save (seconds
    and bytes); with ``keep_cols`` (column ids), keep those columns of the
    inverse P as it leaves ``_regularized_inverse``."""
    from unirec_tpu_torch.facility.solver import Solver
    from unirec_tpu_torch.models import solvers as SV
    seen.setdefault("parts", {})
    seen.setdefault("evals", [])

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seen["parts"][name] = seen["parts"].get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    inverse, fit, evaluate, save = (SV._regularized_inverse, Solver.fit, Solver.evaluate,
                                    Solver.save_model)

    def spy_inverse(G, cfg, spd=True):
        P = inverse(G, cfg, spd)
        if keep_cols is not None:
            seen["P_cols"] = P[:, keep_cols].clone()
        return P

    def spy_fit(self, graph, valid_data=None, **kw):
        seen["graph"], seen["l2_coef"] = graph, self.config.get("l2_coef")
        self.model.solve = timed("solve", self.model.solve)
        try:
            return fit(self, graph, valid_data, **kw)
        finally:
            del self.model.solve

    def spy_eval(self, data, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate(self, data, *args, **kw)
        torch.cuda.synchronize()
        seen["evals"].append((res, time.perf_counter() - t0, len(data.ds)))
        return res

    def spy_save(self, filename):
        t0 = time.perf_counter()
        save(self, filename)
        seen["save_s"] = time.perf_counter() - t0
        seen["pkl_bytes"] = Path(filename).stat().st_size

    with mock.patch.object(SV, "_gram", timed("gram", SV._gram)), \
            mock.patch.object(SV, "_regularized_inverse", timed("inverse", spy_inverse)), \
            mock.patch.object(SV.SLIM, "_candidates",
                              staticmethod(timed("candidates", SV.SLIM._candidates))), \
            mock.patch.object(SV.SLIM, "_solve_active_set",
                              staticmethod(timed("descent", SV.SLIM._solve_active_set))), \
            mock.patch.object(SV.SLIM, "_solve_full",
                              staticmethod(timed("descent", SV.SLIM._solve_full))), \
            mock.patch.object(Solver, "fit", spy_fit), \
            mock.patch.object(Solver, "evaluate", spy_eval), \
            mock.patch.object(Solver, "save_model", spy_save):
        yield seen


def solver_flops(name, U, N):
    """Each part's least operations: the Gram products 2 U N^2 (UserCF's
    A A^T 2 U^2 N), an SPD inverse N^3 (Cholesky, triangular inverse and
    X^T X, a third each; the blocked tier does 5/3 N^3, its X^T X slabs N^3),
    an LU inverse 2 N^3, ADMM 2 N^3 an iteration plus P X^T X, SLIM's
    active-set descent 2 N K^2 a sweep."""
    gram = 2 * U * U * N if name == "UserCF" else 2 * U * N * N
    out = {"gram": gram}
    if name in ("EASE", "AdmmSLIM"):
        out["inverse"] = N ** 3 if N > 12_000 else 2 * N ** 3
    if name == "AdmmSLIM":
        out["iterations"] = 2 * N ** 3 * (ADMM_ITERS + 1)
    if name == "SLIM":
        out["descent"] = 2 * N * SLIM_K * SLIM_K * 30
    return out


def run_solver(torch, args, chance, card, keep_cols=None):
    """main.run(args) of one solver under solver_spies; gates: every metric
    finite, the best (only) validation hit@10 at least ten times ``chance``.
    Returns (seen, the line)."""
    from unirec_tpu_torch.main import main as main_mod
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seen = {}
    with solver_spies(torch, seen, keep_cols):
        t0 = time.perf_counter()
        seen["result"] = main_mod.run(dict(args))
        torch.cuda.synchronize()
        seen["run_s"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts(list(_counters()))
    name = args["model"]
    U, N = seen["graph"].shape
    parts = dict(seen["parts"])
    rest = parts["solve"] - sum(v for k, v in parts.items() if k != "solve")
    parts["iterations" if name == "AdmmSLIM" else "finish"] = rest
    flops = solver_flops(name, U, N)
    (valid, valid_s, valid_rows), (test, test_s, test_rows) = seen["evals"]
    line = {"phase": "solver_path", "model": name, "users": U, "items": N,
            "graph_nnz": int(seen["graph"].nnz), "solve_s": parts.pop("solve"),
            "parts_s": parts,
            "parts_flops": flops,
            "parts_bound_s": {k: v / PEAK_FLOPS["float32"] for k, v in flops.items()},
            "valid": valid, "valid_s": valid_s, "valid_users_per_s": valid_rows / valid_s,
            "test": test, "test_s": test_s, "save_s": seen["save_s"],
            "pkl_bytes": seen["pkl_bytes"], "run_s": seen["run_s"], "peak_mem_bytes": peak,
            "chance_hit10": chance, "launches": sum(counts.values()), "card": card}
    emit(line)
    if not all(np.isfinite(v) for r in (valid, test) for v in r.values()):
        raise AssertionError(f"solver_path {name}: a metric is not finite: {line}")
    if not valid["hit@10"] >= 10 * chance:
        raise AssertionError(f"solver_path {name}: validation hit@10 {valid['hit@10']} "
                             f"< 10x chance {chance}")
    if any(counts.values()):
        raise AssertionError(f"solver_path {name}: a kernel launched: {counts}")
    return seen, line


def solver_cross_check(torch, graph, card):
    """Every solver on the cut graph on the card and on the CPU (the port's
    plain torch ops there), each matrix against the CPU's by its largest
    entry (SOLVER_TOL); SLIM's full descent at 2 sweeps, its active set at
    K = SLIM_K on the candidates the card chose, given to both."""
    from unirec_tpu_torch.models import solvers as SV
    cut = graph[:SOLVER_CUT_USERS, :SOLVER_CUT].tocsr()
    U, N = cut.shape
    rows, bad = {}, []
    for name in SOLVERS:
        cfg = {"n_users": U, "n_items": N, "epochs": ADMM_ITERS if name == "AdmmSLIM" else 2}
        mats, secs = [], []
        for dev in ("cuda", "cpu"):
            model = getattr(SV, name)(dict(cfg)).to(dev)
            t0 = time.perf_counter()
            model.solve(cut)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            mats.append((model.user_similarity if name == "UserCF"
                         else model.item_similarity).float().cpu())
        rows[name] = (mats, secs)
    G = SV._gram(cut, "cuda")
    cand = SV.SLIM._candidates(G, SLIM_K)
    mats, secs = [], []
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        mats.append(SV.SLIM._solve_active_set(G.to(dev), float(U), 0.004, 0.098, 30,
                                              cand.to(dev)).cpu())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    rows["SLIM_active_set"] = (mats, secs)
    del G
    out = {}
    for name, ((card_m, cpu_m), (card_s, cpu_s)) in rows.items():
        rel = float((card_m - cpu_m).abs().max() / cpu_m.abs().max().clamp_min(1e-30))
        out[name] = {"rel_max_diff": rel, "tol": SOLVER_TOL[name], "card_s": card_s,
                     "cpu_s": cpu_s, "nonzero": int((cpu_m != 0).sum())}
        if not rel <= SOLVER_TOL[name]:
            bad.append(name)
    emit({"phase": "solver_path_check", "users": U, "items": N, "solvers": out,
          "cpu_threads": torch.get_num_threads(), "card": card})
    if bad:
        raise AssertionError(f"solver_path_check: the card disagrees with the CPU for {bad}")


def solver_tiers(torch, graph, card):
    """EASE on the first LU_CUT items (N <= 12,000: the LU tier) against the
    blocked tier on the same graph; SLIM's full descent (SLIM_FULL_SWEEPS) on the
    first SOLVER_CUT items; one sweep timed at SLIM_SWEEP_N items."""
    from unirec_tpu_torch.models import solvers as SV
    U = graph.shape[0]
    lu_graph = graph[:, :LU_CUT].tocsr()
    mats, secs = [], []
    for over in ({}, {"solver_device_inverse_max": 4096}):
        model = SV.EASE({"n_users": U, "n_items": LU_CUT, **over}).to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.solve(lu_graph)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mats.append(model.item_similarity)
    rel = float((mats[0] - mats[1]).abs().max() / mats[1].abs().max())
    del mats, model
    slim = SV.SLIM({"n_users": U, "n_items": SOLVER_CUT, "epochs": SLIM_FULL_SWEEPS}).to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slim.solve(graph[:, :SOLVER_CUT].tocsr())
    torch.cuda.synchronize()
    slim_s = time.perf_counter() - t0
    nz = int((slim.item_similarity > 0).sum())
    del slim
    G = SV._gram(graph[:, :SLIM_SWEEP_N].tocsr(), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    SV.SLIM._solve_full(G, float(U), 0.004, 0.098, 1)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    del G
    line = {"phase": "solver_tiers", "ease_items": LU_CUT, "ease_lu_s": secs[0],
            "ease_blocked_s": secs[1], "ease_lu_vs_blocked": rel,
            "tol": SOLVER_TOL["EASE_lu_vs_blocked"], "slim_full_items": SOLVER_CUT,
            "slim_full_sweeps": SLIM_FULL_SWEEPS, "slim_full_s": slim_s, "slim_full_nonzero": nz,
            "slim_one_sweep_items": SLIM_SWEEP_N, "slim_one_sweep_s": sweep_s, "card": card}
    emit(line)
    if not rel <= SOLVER_TOL["EASE_lu_vs_blocked"] or nz == 0:
        raise AssertionError(f"solver_tiers: {line}")


def solver_path(torch, card: str):
    """gowalla-width splits through the port's convert-adjacency, one text
    table through fastio and pandas, each solver through main.run (EASE's
    blocked inverse tier, AdmmSLIM, SLIM's active set, SAR, UserCF) with its
    gates, task=test from EASE's and UserCF's .solver.pkl, EASE's inverse
    against the Gram on sampled columns, the tiers (solver_tiers), the card
    against the CPU on a cut (solver_cross_check), then cli sweep of SAR's
    edge_norm. Every model's output directory goes once its checks pass.
    Returns the launches (none)."""
    import pandas as pd

    from unirec_tpu_torch import cli
    from unirec_tpu_torch.main import main as main_mod
    from unirec_tpu_torch.models import solvers as SV
    from unirec_tpu_torch.ops.linalg import full_f32
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke"
    raw, data, out = root / "gowalla_raw", root / "gowalla_data", root / "solvers"
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(data, ignore_errors=True)
    splits = write_gowalla_splits(raw)
    t1 = time.perf_counter()
    if cli.main(["convert-adjacency", "--split_dir", str(raw), "--out_dir", str(data)]) != 0:
        raise AssertionError("convert-adjacency failed")
    info = json.loads((data / "data.info").read_text())
    emit({"phase": "solver_data", **splits, "info": info,
          "convert_adjacency_s": time.perf_counter() - t1,
          "seconds": time.perf_counter() - t0})
    if (info["n_users"], info["n_items"]) != (GOWALLA_USERS, GOWALLA_ITEMS):
        raise AssertionError(f"convert-adjacency: {info}")
    check_fastio(data, card)
    valid = pd.read_pickle(data / "valid.pkl")
    chance = 10 * float(np.mean([len(s) for s in valid["item_seq"]])) / GOWALLA_ITEMS
    lines = {}
    for name in SOLVERS:
        args = solver_args(name, data, out)
        cols = np.sort(np.random.default_rng(SEED + 15).choice(GOWALLA_ITEMS, 256, False)) \
            if name == "EASE" else None
        seen, lines[name] = run_solver(torch, args, chance, card, keep_cols=None if cols is None
                                       else torch.tensor(cols, device="cuda"))
        if name in ("EASE", "UserCF"):
            pkl = Path(args["output_path"]) / "checkpoint" / f"{name}.solver.pkl"
            t1 = time.perf_counter()
            again = main_mod.run({"task": "test", "model_file": str(pkl),
                                  "dataset_path": str(data),
                                  "output_path": str(Path(args["output_path"]) / "test")})
            emit({"phase": "solver_path_test", "model": name, "equal": again == seen["result"],
                  "test_from_pkl_s": time.perf_counter() - t1, "card": card})
            if again != seen["result"]:
                raise AssertionError(f"solver_path {name}: test from {pkl.name} {again} != "
                                     f"the run's {seen['result']}")
        if name == "EASE":
            G = SV._gram(seen["graph"], "cuda")
            G.diagonal().add_(float(seen["l2_coef"]))
            eye = torch.zeros(GOWALLA_ITEMS, len(cols), device="cuda")
            eye[torch.tensor(cols, device="cuda"), torch.arange(len(cols), device="cuda")] = 1.0
            with full_f32():
                resid = float((G @ seen["P_cols"] - eye).abs().max())
            del G, eye
            emit({"phase": "solver_path_residual", "model": name, "columns": len(cols),
                  "max_abs": resid, "tol": EASE_RESIDUAL_TOL, "card": card})
            if not resid <= EASE_RESIDUAL_TOL:
                raise AssertionError(f"solver_path EASE: |G P - I| = {resid}")
        graph = seen["graph"]
        del seen
        shutil.rmtree(out / name, ignore_errors=True)
        torch.cuda.empty_cache()
    solver_tiers(torch, graph, card)
    torch.cuda.empty_cache()
    solver_cross_check(torch, graph, card)
    torch.cuda.empty_cache()
    # the sweep's two SAR trials on a cut of SWEEP_SIZE users and items (at
    # gowalla's width each trial writes a 6.7 GB pickle)
    sweep = out / "sweep"
    sweep.mkdir(parents=True, exist_ok=True)
    t1 = time.perf_counter()
    write_gowalla_splits(root / "sweep_raw", SWEEP_SIZE, SWEEP_SIZE)
    shutil.rmtree(root / "sweep_data", ignore_errors=True)
    if cli.main(["convert-adjacency", "--split_dir", str(root / "sweep_raw"),
                 "--out_dir", str(root / "sweep_data")]) != 0:
        raise AssertionError("convert-adjacency failed on the sweep's cut")
    (sweep / "sweep.yaml").write_text("method: grid\nmetric: {name: ndcg@5, goal: maximize}\n"
                                      "parameters:\n  edge_norm: {values: [sqrt_degree, none]}\n")
    argv = ["sweep", "--sweep_file", str(sweep / "sweep.yaml")]
    for k, v in solver_args("SAR", root / "sweep_data", sweep, exp_name="sar_sweep").items():
        if k not in ("task", "output_path"):
            argv += [f"--{k}", str(v)]
    if cli.main(argv + ["--output_path", str(sweep)]) != 0:
        raise AssertionError("cli sweep failed")
    tsv = pd.read_csv(sweep / "sweep_results.tsv", sep="\t")
    emit({"phase": "solver_sweep", "users_and_items": SWEEP_SIZE,
          "trials": tsv.to_dict("records"), "seconds": time.perf_counter() - t1, "card": card})
    if list(tsv["edge_norm"]) != ["sqrt_degree", "none"] or not np.isfinite(tsv["ndcg@5"]).all():
        raise AssertionError(f"solver_sweep: {tsv}")
    shutil.rmtree(out, ignore_errors=True)
    counts = launch_counts(list(_counters()))
    emit({"phase": "solver_path_launches", **counts, "seconds": time.perf_counter() - t0})
    return counts


# --------------------------------------------------- distribution (dist_path)
DIST_GLOO_BATCH, DIST_GLOO_STEPS, DIST_SHARDS = 8192, 3, 4
DIST_ITEMS = N_ITEMS + 2          # 4 shards of 12,501 rows: 2 padded rows in the last
DIST_RANK_TIMEOUT = 300           # seconds, each gloo rank
# the gloo ranks' per-step losses against the one rank's, relative: the same
# batches and weights, the sums taken in another order (1.7e-7 measured on
# an NVIDIA H100 80GB HBM3 at 700 W)
DIST_LOSS_TOL = 1e-5


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def write_dist_data(slice_data: Path, root: Path) -> None:
    """The entry path's histories with a training table of the steps
    train_path takes (no valid or test table: main.run only trains)."""
    import pandas as pd
    root.mkdir(parents=True, exist_ok=True)
    for name in ("user_history.pkl", "data.info"):
        shutil.copyfile(slice_data / name, root / name)
    rows = TRAIN_BATCH * (WARMUP_STEPS + TIMED_STEPS)
    pd.read_pickle(slice_data / "train.pkl").iloc[:rows].to_pickle(root / "train.pkl")


def dist_args(data: Path, out: Path):
    """bench.py's training configuration (``train_config``) through main.run
    at dropout 0, one epoch, with auto_resume's rolling checkpoint."""
    return {"task": "train", "model": "SASRec", "dataloader": "SeqRecDataset",
            "dataset_path": str(data), "output_path": str(out), "exp_name": "sasrec_dist",
            "user_history_filename": "user_history", "max_seq_len": SEQ_LEN,
            "embedding_size": EMB, "hidden_size": EMB, "inner_size": 2 * EMB, "n_layers": 2,
            "n_heads": 2, "hidden_act": "swish", "loss_type": "bce",
            "n_sample_neg_train": N_NEG, "history_mask_mode": "autoregressive",
            "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0, "dropout_bits": 8,
            "compute_dtype": "bfloat16", "last_query_only": 1, "fused_layer": 1,
            "fused_lastq": 1, "vmem_embedding_grad": 1, "neg_membership_pallas": 1,
            "batch_size": TRAIN_BATCH, "epochs": 1, "learning_rate": 1e-3, "seed": SEED,
            "shuffle_train": 1, "auto_resume": 1}


def spied_train_run(torch, args):
    """main.run(args) on the card: (each step's loss, seconds of the timed
    steps: from a sync before step 4 to a sync after the last)."""
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.main import main as main_mod
    losses, marks, step = [], {}, Trainer.train_step

    def spy(self, batch):
        if len(losses) == WARMUP_STEPS:
            torch.cuda.synchronize()
            marks["t0"] = time.perf_counter()
        losses.append(step(self, batch))
        if len(losses) == WARMUP_STEPS + TIMED_STEPS:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
        return losses[-1]

    with mock.patch.object(Trainer, "train_step", spy):
        main_mod.run(dict(args), device="cuda")
    return torch.stack(losses).float().cpu().numpy(), marks["t1"] - marks["t0"]


def tree_errs(torch, got, ref):
    """Each parameter's error over its reference's largest magnitude, a key
    bias over its query bias's (``leaf_errs``): {flax path: error}."""
    flat_g, flat_r = dict(flat_tree(got)), dict(flat_tree(ref))
    names = sorted(flat_r)
    if sorted(flat_g) != names:
        raise AssertionError(f"parameter trees differ: {sorted(flat_g)} / {names}")
    zero_sum = {i: names.index(n.replace("key/bias", "query/bias"))
                for i, n in enumerate(names) if n.endswith("key/bias")}
    errs, _ = leaf_errs([torch.from_numpy(np.asarray(flat_g[n], np.float32)) for n in names],
                        [torch.from_numpy(np.asarray(flat_r[n], np.float32)) for n in names],
                        zero_sum)
    return dict(zip(names, errs))


def flat_tree(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from flat_tree(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def gloo_train(torch, out: Path, n_model: int):
    """DIST_GLOO_STEPS steps of bench.py's training configuration at batch
    DIST_GLOO_BATCH (dropout 0) on a 1 x ``n_model`` mesh of the process
    group that is up, the item table row-sharded over ``model``
    (shard_embeddings); with n_model > 1 the .dcp checkpoint is written.
    Returns {losses, params (whole), ms_per_step of steps 2-3, launches,
    item_grad: (first row, step 1's item-table gradient rows as the
    optimizer receives them: this rank's shard, or the whole table)}."""
    from unirec_tpu_torch.data.device_pipeline import DeviceAugmenter, RawIdBatcher
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.utils import to_device
    from unirec_tpu_torch.utils.flax_bridge import to_flax_params
    from unirec_tpu_torch.utils.registry import get_model_class
    rng = np.random.default_rng(SEED + 16)
    history = synthetic_history(rng)
    cfg = dict(train_config(torch), hidden_dropout_prob=0.0, attn_dropout_prob=0.0,
               shard_embeddings=1, mesh_data=1, mesh_model=n_model,
               output_path=str(out), exp_name=f"gloo{n_model}")
    trainer = Trainer(cfg, get_model_class("SASRec")(cfg), device="cuda")
    trainer.set_device_augmenter(DeviceAugmenter(cfg, history, device="cuda"))
    trainer.init_params()
    item = dict(trainer.model.named_parameters())["item_embedding.weight"]
    at = next(i for i, p in enumerate(trainer.params) if p is item)
    apply, seen = trainer.apply_update, {}

    def spy(loss, grads):
        if not seen:
            shard = getattr(item, "row_shard", None)
            seen["item_grad"] = (shard.offset if shard is not None else 0,
                                 grads[at].float().cpu().numpy())
        return apply(loss, grads)

    trainer.apply_update = spy
    rows = DIST_GLOO_BATCH * DIST_GLOO_STEPS
    raw = RawIdBatcher(rng.integers(1, N_USERS, rows), rng.integers(1, N_ITEMS, rows),
                       DIST_GLOO_BATCH, shuffle=False)
    reset_counts()
    losses = []
    for i, b in enumerate(raw):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(float(trainer.train_step(to_device(trainer.mesh.pad_batch(b), "cuda"))))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (DIST_GLOO_STEPS - 1)
    trainer.apply_update = apply
    counts = launch_counts(TRAINING_KERNELS)
    params = to_flax_params(trainer.model)
    sharded = sorted(n for n, p in trainer.model.named_parameters()
                     if getattr(p, "row_shard", None) is not None)
    if n_model > 1:
        trainer.config["checkpoint_backend"] = "orbax"
        trainer.save_model(str(out / "gloo.pkl"), quiet=True)
    return {"losses": losses, "params": params, "ms_per_step": ms, "launches": counts,
            "sharded": sharded, "item_grad": seen["item_grad"]}


# MoRec on a data mesh: 3 steps each of morec_path's base (BPR through the
# device pipeline) and of its PID and MGDA fine-tunes from its base
# checkpoint, on tables cut to 3 batches; at mesh_data=2 the fine-tunes ask
# for batch_size MOREC_BATCH - 1, which build_morec rounds up to MOREC_BATCH
MOREC_DP_STEPS = 3
MOREC_DP_RUNS = ("base", "PID", "Pareto")


def write_morec_dp_tables(data: Path) -> None:
    """The base's and the fine-tunes' training tables cut to
    MOREC_DP_STEPS batches."""
    import pandas as pd
    for name, rows in (("train", MF_BATCH), ("train_morec", MOREC_BATCH)):
        pd.read_pickle(data / f"{name}.pkl").iloc[:MOREC_DP_STEPS * rows].to_pickle(
            data / f"{name}_dp.pkl")


def morec_dp_runs(torch, out: Path, n_data: int):
    """main.run of each of MOREC_DP_RUNS at mesh_data=n_data in the process
    group that is up (on morec_path's data and base checkpoint). Returns,
    by run: each step's loss, the parameters after, the test metrics, rows
    6 and 8's launches and, for the fine-tunes, step 1's global loss vector
    and Gram (the shares and the per-objective gradients summed over the
    ranks), the sampler's batch size and its weights after the epoch's
    refresh."""
    from unirec_tpu_torch.facility.morec import integration as TI
    from unirec_tpu_torch.facility.trainer import Trainer
    from unirec_tpu_torch.utils.flax_bridge import to_flax_params
    root = ROOT / "build" / "chip_smoke"
    data = root / "morec_data"
    base_ckpt = root / "morec" / "base" / "checkpoint" / "morec-base.pkl"
    res = {}
    for name in MOREC_DP_RUNS:
        if name == "base":
            args = dict(morec_args(data, out), data_train_name="train_dp",
                        output_path=str(out / "base"))
        else:
            args = dict(morec_args(data, out, name, base_ckpt), data_train_name="train_morec_dp",
                        batch_size=MOREC_BATCH - 1 if n_data > 1 else MOREC_BATCH)
        first, step, fit = {}, TI.morec_train_step, Trainer.fit

        def spy(trainer, batch, drop_seed):
            if "vec" not in first:
                vec = TI.loss_vector(trainer, batch, drop_seed, trainer._morec_sampler.n_blocks)
                first["vec"] = TI.global_vector(trainer, vec).cpu().numpy()
                first["gram"] = TI.gram(TI.objective_grads(trainer.params, vec,
                                                           TI.data_mesh(trainer))).cpu().numpy()
            return step(trainer, batch, drop_seed)

        def spy_fit(self, *a, **kw):
            out_ = fit(self, *a, **kw)
            # the trained weights: the test that follows loads the best
            # checkpoint, the validation's before the epoch
            first["params"] = to_flax_params(self.model)
            return out_

        with mock.patch.object(TI, "morec_train_step", spy), \
                mock.patch.object(Trainer, "fit", spy_fit):
            seen = run_spied(torch, dict(args, epochs=1, mesh_data=n_data))
        trainer = seen["trainer"]
        sampler = trainer._morec_sampler
        res[name] = {"losses": seen["loss"].tolist(), "test": seen["result"], **first,
                     "launches": launch_counts(("scatter_add", "scatter_add_sorted", "member",
                                                "member_warp")),
                     "batch_size": None if sampler is None else sampler.batch_size,
                     "weights": None if sampler is None else
                     {k: np.asarray(v).tolist() for k, v in sampler.group2weights.items()}}
        del seen, trainer, sampler
        torch.cuda.empty_cache()
    return res


def dist_rank_main(rank: int, out: str, kind: str) -> int:
    """One gloo rank of dist_path (``chip_smoke.py --dist-rank R OUT KIND``):
    the script brings gloo up itself (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT from the environment), the port's initialize_distributed
    takes that group, and the rank trains on cuda:0 beside the other: KIND
    "sasrec" gloo_train at mesh_model=2, "morec" morec_dp_runs at
    mesh_data=2."""
    import pickle

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from unirec_tpu_torch.core.distributed import GROUP_TIMEOUT, initialize_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", timeout=GROUP_TIMEOUT)
    if not initialize_distributed({}, "cuda") or dist.get_backend() != "gloo":
        raise AssertionError("the port did not take the gloo group")
    res = gloo_train(torch, Path(out), 2) if kind == "sasrec" else \
        morec_dp_runs(torch, Path(out), 2)
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    return 0


def run_gloo_ranks(out: Path, kind: str = "sasrec"):
    """The two gloo ranks on the one card (NCCL takes one rank a device),
    each a subprocess with its own timeout; raises with a rank's output
    tail when it fails (a collective gloo refuses on CUDA tensors among
    them)."""
    import os
    import pickle
    port = free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", LOCAL_RANK="0")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank",
                               str(r), str(out), kind], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DIST_RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"gloo rank {r} exited {p.returncode}: {log[-3000:]}")
    res = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def sharded_serving(torch, card: str):
    """reco-topk of SERVE_USERS users (batch 256, top-100) through
    DIST_SHARDS logical shards of one table (local_shard_topk +
    merge_shard_candidates), bf16 and int8, from a checkpoint of DIST_ITEMS
    items (2 padded rows in the last shard) and one of 1,000,002: the ids
    against the unsharded run's and the dense plain top-k's (topk_agrees),
    ms a batch sharded and unsharded in turns. A shard fetches k + C + 1 =
    301 candidates (C the history's 200), so at 12,501 rows a shard
    fused_catalog_topk scores it densely (its rule N <= 4 k 16, the JAX
    package's too) and at 250,001 through rows 5 and 5q, once a shard a
    batch; the history-free top-100 over the 50,002 items launches them
    once a shard. Returns the launches."""
    from unirec_tpu_torch.main.infer_embedding import iter_infer_batches
    from unirec_tpu_torch.main.reco_topk import get_topk_recommendations
    from unirec_tpu_torch.ops import topk as TK
    from unirec_tpu_torch.utils import to_device
    from unirec_tpu_torch.utils.checkpoint import load_model_freely
    history = synthetic_history()
    users = np.arange(1, SERVE_USERS + 1, dtype=np.int64)
    n_batches = -(-SERVE_USERS // BATCH)
    total = {}
    for n_items in (DIST_ITEMS, 1_000_002):
        ckpt = ROOT / "build" / "chip_smoke" / f"sasrec_dist_serve_{n_items}.pkl"
        write_checkpoint(torch, ckpt, n_items)
        model, cfg = load_model_freely(str(ckpt), "cuda")
        with torch.no_grad():
            item_emb = model.all_item_emb()
            q, qs = TK.quantize_catalog(item_emb)
            catalogs = {"bf16": item_emb, "int8": (q, qs)}
            for name, extra in (("bf16", {}), ("int8", {"catalog_int8": 1})):
                c = dict(cfg, **extra)

                def serve(shards=None, c=c):
                    out = get_topk_recommendations(c, model, users, history, TOPK,
                                                   n_shards=shards)
                    torch.cuda.synchronize()
                    return out

                serve(DIST_SHARDS), serve()                  # warm-up
                ms = {"sharded": [], "unsharded": []}
                for order in (("sharded", "unsharded"), ("unsharded", "sharded")):
                    for kind in order:
                        if kind == "sharded":
                            reset_counts()
                        t0 = time.perf_counter()
                        res = serve(DIST_SHARDS if kind == "sharded" else None)
                        ms[kind].append((time.perf_counter() - t0) * 1e3 / n_batches)
                        if kind == "sharded":
                            got, counts = res, launch_counts(SERVING_KERNELS)
                        else:
                            ref = res
                add_counts(total, counts)
                valid, same, same_unsharded = True, 0, 0
                for start, batch in zip(range(0, SERVE_USERS, BATCH),
                                        iter_infer_batches(cfg, users, history, True)):
                    n = batch.pop("n_real")
                    u = model.user_emb(to_device(batch, "cuda", torch.int64))[:n].float()
                    hist, hlen = history.gather(batch["user_id"][:n])
                    h = torch.from_numpy(np.where(np.arange(hist.shape[1])[None] < hlen[:, None],
                                                  hist, 0).astype(np.int64)).cuda()
                    items = catalogs[name] if name == "bf16" \
                        else catalogs[name][0].float() * catalogs[name][1][:, None]
                    scores = (u @ items.float().T).scatter(1, h, float("-inf"))
                    scores[:, 0] = float("-inf")
                    ids = torch.from_numpy(got[start:start + n]).cuda()
                    ok, rows = topk_agrees(ids, scores, TOPK, 1e-3 * float(
                        scores[torch.isfinite(scores)].abs().max()))
                    valid &= ok
                    same += rows
                    same_unsharded += int((np.sort(got[start:start + n], 1)
                                           == np.sort(ref[start:start + n], 1)).all(1).sum())
                    del scores
                key = "blockmax_mma" if name == "bf16" else "blockmax_int8_mma"
                want = DIST_SHARDS * n_batches if n_items > 4 * (TOPK + HIST_CAP + 1) * 16 \
                    * DIST_SHARDS else 0
                line = {"phase": "dist_serve", "catalog": name, "items": n_items,
                        "shards": DIST_SHARDS, "users": SERVE_USERS, "batch": BATCH,
                        "topk": TOPK, "ms_per_batch_sharded": ms["sharded"],
                        "ms_per_batch_unsharded": ms["unsharded"], "launches": counts,
                        "blockmax_launches_expected": want, "rows_valid": valid,
                        "rows_identical_to_dense": same,
                        "rows_identical_to_unsharded": same_unsharded, "card": card}
                emit(line)
                if not valid or counts[key] != want \
                        or counts["blockmax"] + counts["blockmax_int8"] != counts[key]:
                    raise AssertionError(f"sharded serving failed: {line}")
            if n_items == DIST_ITEMS:
                # the history-free top-100 of one batch: row 5 once a shard
                u = model.user_emb(to_device(next(iter(iter_infer_batches(
                    cfg, users, history, True))), "cuda", torch.int64))
                padded, _ = TK.place_item_table(item_emb, DIST_SHARDS)
                reset_counts()
                _, ids = TK.sharded_catalog_topk(u, padded, TOPK, n_real=n_items,
                                                 n_shards=DIST_SHARDS)
                counts = launch_counts(SERVING_KERNELS)
                add_counts(total, counts)
                _, whole = TK.fused_catalog_topk(u, item_emb, TOPK)
                same = int((ids.sort(1).values == whole.sort(1).values).all(1).sum())
                line = {"phase": "dist_serve", "catalog": "bf16", "items": n_items,
                        "shards": DIST_SHARDS, "users": BATCH, "topk": TOPK,
                        "history": False, "launches": counts,
                        "rows_identical_to_unsharded": same, "card": card}
                emit(line)
                if counts["blockmax_mma"] != DIST_SHARDS or same != BATCH:
                    raise AssertionError(f"sharded top-k without history failed: {line}")
        del model, item_emb, q, qs, catalogs
        torch.cuda.empty_cache()
    return total


def morec_dp(torch, base: Path, card: str):
    """MoRec at mesh_data=2 (dist_path's part 3): morec_dp_runs in two gloo
    ranks on the card against one rank in this process's NCCL group of
    one: step 1's loss vector and Gram within MOREC_TOL of their largest
    entry, every step's loss within MOREC_TOL, the parameters within
    BWD_TOL, both ranks bit-equal (losses, parameters, sampler weights),
    the fine-tunes' batch size rounded to MOREC_BATCH, rows 6 and 8
    launched on each rank. Returns the one rank's launches."""
    out = base / "dist_morec"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    write_morec_dp_tables(base / "morec_data")
    t0 = time.perf_counter()
    ref = morec_dp_runs(torch, out / "one", 1)
    one_s = time.perf_counter() - t0
    counts = {k: sum(r["launches"][k] for r in ref.values()) for k in ref["base"]["launches"]}
    t0 = time.perf_counter()
    ranks = run_gloo_ranks(out, "morec")
    gloo_s = time.perf_counter() - t0
    lines, bad = {}, []
    for name in MOREC_DP_RUNS:
        r0, r1, want = ranks[0][name], ranks[1][name], ref[name]
        errs = {r: tree_errs(torch, res[name]["params"], want["params"])
                for r, res in enumerate(ranks)}
        loss_err = max(abs(a - b) / abs(b) for r in (r0, r1)
                       for a, b in zip(r["losses"], want["losses"]))
        equal = r0["losses"] == r1["losses"] and r0["weights"] == r1["weights"] and all(
            np.array_equal(np.asarray(a), np.asarray(b)) for (_, a), (_, b) in zip(
                flat_tree(r0["params"]), flat_tree(r1["params"])))
        line = {"losses": [r0["losses"], r1["losses"]], "losses_one_rank": want["losses"],
                "loss_max_rel_diff": loss_err, "ranks_bit_equal": equal,
                "params_max_rel_err": max(max(e.values()) for e in errs.values()),
                "test": [r0["test"], want["test"]],
                "launches": [r0["launches"], r1["launches"]],
                "batch_size": [r0["batch_size"], want["batch_size"]]}
        if name != "base":
            line.update({f"{k}_max_rel_diff": max(
                float(np.abs(r[k] - want[k]).max() / np.abs(want[k]).max()) for r in (r0, r1))
                for k in ("vec", "gram")}, loss_vector=r0["vec"].tolist())
        lines[name] = line
        idle = [k for r in (r0, r1) for k in ("scatter_add", "member" if name == "base"
                                              else "scatter_add") if r["launches"][k] <= 0]
        if len(want["losses"]) != MOREC_DP_STEPS or not equal or idle \
                or not loss_err <= MOREC_TOL or line["params_max_rel_err"] > BWD_TOL \
                or (name != "base" and not (line["vec_max_rel_diff"] <= MOREC_TOL
                                            and line["gram_max_rel_diff"] <= MOREC_TOL
                                            and r0["batch_size"] == MOREC_BATCH)):
            bad.append(name)
    emit({"phase": "dist_morec", "ranks": 2, "backend": "gloo", "mesh": "2x1",
          "steps": MOREC_DP_STEPS, "runs": lines, "tol": MOREC_TOL, "params_tol": BWD_TOL,
          "one_rank_s": one_s, "seconds_with_start": gloo_s, "card": card})
    if bad:
        raise AssertionError(f"dist_morec: two gloo ranks disagree with one on {bad}")
    return counts


def dist_path(torch, card: str, train_examples_per_s: float):
    """Distribution on the card. (1) main.run(task=train) at bench.py's
    training configuration (dropout 0, batch 32,768, the steps train_path
    takes) without a process group, then inside an NCCL group of one at
    mesh_data=1: the same loss at every step (BWD_TOL), rows 1-4, 6 and 8
    on their new bodies, the same rolling checkpoint, examples/s beside
    train_path's (``train_examples_per_s``, dropout 0.1 there). (2) Two
    gloo ranks on the card at mesh_model=2 with shard_embeddings (batch
    8,192, 3 steps; the item table row-sharded, its lookup summed and its
    backward through row 6) against the same 3 steps at 1 x 1 in the NCCL
    group; the .dcp checkpoint reloaded in this process. (3)
    sharded_serving. The group is destroyed at the end. Returns the
    launches of (1) and (3)."""
    import torch.distributed as dist

    from unirec_tpu_torch.core.distributed import GROUP_TIMEOUT
    from unirec_tpu_torch.utils.checkpoint import load_checkpoint
    base = ROOT / "build" / "chip_smoke"
    data = base / "dist_data"
    write_dist_data(base / "slice_data", data)
    args = dist_args(data, base / "dist_one")
    for d in ("dist_one", "dist_group", "dist_gloo"):
        shutil.rmtree(base / d, ignore_errors=True)
    one, one_s = spied_train_run(torch, args)
    dist.init_process_group("cuda:nccl,cpu:gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1, timeout=GROUP_TIMEOUT)
    try:
        torch.cuda.synchronize()
        reset_counts()
        group, group_s = spied_train_run(torch, dict(args, output_path=str(base / "dist_group"),
                                                      mesh_data=1))
        counts = launch_counts(TRAINING_KERNELS)
        loss_err = float(np.abs(group - one).max() / np.abs(one).max())
        ck = {n: load_checkpoint(str(base / n / "checkpoint" / "sasrec_dist.pkl.last"))
              for n in ("dist_one", "dist_group")}
        errs = tree_errs(torch, ck["dist_group"]["params"], ck["dist_one"]["params"])
        worst = max(errs, key=errs.get)
        line = {"phase": "dist_path", "world_size": 1, "backend": dist.get_backend(),
                "batch": TRAIN_BATCH, "steps": len(group), "timed_steps": TIMED_STEPS,
                "examples_per_s": TRAIN_BATCH * TIMED_STEPS / group_s,
                "ms_per_step": group_s * 1e3 / TIMED_STEPS,
                "examples_per_s_without_group": TRAIN_BATCH * TIMED_STEPS / one_s,
                "train_path_examples_per_s": train_examples_per_s,
                "loss_max_rel_diff": loss_err, "checkpoint_max_rel_err": errs[worst],
                "checkpoint_worst_leaf": worst, "tol": BWD_TOL,
                "first_loss": float(group[0]), "last_loss": float(group[-1]), "card": card}
        emit(line)
        emit({"phase": "dist_path_launches", **counts})
        missing = [k for k, v in counts.items() if v <= 0]
        if len(group) != len(one) or not loss_err <= BWD_TOL or not errs[worst] <= BWD_TOL \
                or missing:
            raise AssertionError(f"world size 1 disagrees with one process: {line}, "
                                 f"never launched {missing}")
        on_new_bodies("dist path", counts, POP_BODIES)

        out = base / "dist_gloo"
        out.mkdir(parents=True)
        ref = gloo_train(torch, out, 1)
        t0 = time.perf_counter()
        ranks = run_gloo_ranks(out)
        gloo_s = time.perf_counter() - t0
        dcp = load_checkpoint(str(out / "gloo.pkl"))
        errs = {r: tree_errs(torch, res["params"], ref["params"]) for r, res in enumerate(ranks)}
        worst = {r: max(e, key=e.get) for r, e in errs.items()}
        dcp_same = all(np.array_equal(np.asarray(a), np.asarray(b)) for (_, a), (_, b) in zip(
            flat_tree(dcp["params"]), flat_tree(ranks[0]["params"])))
        # the ranks are replicas: the same losses and parameters, bit for bit
        ranks_equal = ranks[0]["losses"] == ranks[1]["losses"] and all(
            np.array_equal(np.asarray(a), np.asarray(b)) for (_, a), (_, b) in zip(
                flat_tree(ranks[0]["params"]), flat_tree(ranks[1]["params"])))
        loss_err = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r["losses"], ref["losses"]))
        # step 1's item-table gradient, the shards' rows put together, against
        # the one rank's: a gradient scaled by the lookup's backward (an
        # all-reduce there multiplies it by n_model) would be off by 100%,
        # which Adam's scale-free update would hide from the parameters
        shards = sorted(r["item_grad"] for r in ranks)
        grad = np.concatenate([g for _, g in shards])
        want = ref["item_grad"][1]
        grad_err = float(np.abs(grad - want).max() / np.abs(want).max()) \
            if grad.shape == want.shape and [o for o, _ in shards] == [0, len(shards[0][1])] \
            else float("inf")
        line = {"phase": "dist_gloo", "ranks": 2, "backend": "gloo", "mesh": "1x2",
                "batch": DIST_GLOO_BATCH, "steps": DIST_GLOO_STEPS,
                "sharded": ranks[0]["sharded"],
                "ms_per_step": [r["ms_per_step"] for r in ranks],
                "ms_per_step_one_rank": ref["ms_per_step"],
                "losses": [r["losses"] for r in ranks], "losses_one_rank": ref["losses"],
                "loss_max_rel_diff": loss_err, "loss_tol": DIST_LOSS_TOL,
                "item_grad_step1_max_rel_err": grad_err, "ranks_bit_equal": ranks_equal,
                "max_rel_err": [errs[r][worst[r]] for r in errs],
                "worst_leaf": [worst[r] for r in worst], "tol": BWD_TOL,
                "dcp_reload_equal": dcp_same, "launches": [r["launches"] for r in ranks],
                "seconds_with_start": gloo_s, "card": card}
        emit(line)
        idle = [k for r in ranks for k, v in r["launches"].items() if v <= 0]
        for r, res in enumerate(ranks):
            on_new_bodies(f"gloo rank {r}", res["launches"], POP_BODIES)
        if ranks[0]["sharded"] != ["item_embedding.weight"] or not dcp_same or idle \
                or max(line["max_rel_err"]) > BWD_TOL or not ranks_equal \
                or not loss_err <= DIST_LOSS_TOL or not grad_err <= BWD_TOL:
            raise AssertionError(f"two gloo ranks disagree with one: {line}")
        add_counts(counts, morec_dp(torch, base, card))
        add_counts(counts, sharded_serving(torch, card))
    finally:
        dist.destroy_process_group()
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
    background = {"client": start_client_build()}   # g++ of the C++ client beside nvcc
    try:
        return run_phases(torch, _build, card, background, t_start)
    finally:
        stop_background(background)


def run_phases(torch, _build, card: str, background, t_start: float) -> int:
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
        for name, int8 in (("blockmax", False), ("blockmax_int8", True)):
            rows[name] = kernel_blockmax(torch, N_ITEMS, "bfloat16", int8)
            rows[f"{name}_cuda_core"] = older_body_row(rows[name], "cuda_core", "cuda")
            kernel_blockmax(torch, 1_000_000, "bfloat16", int8)
        kernel_blockmax(torch, N_ITEMS, "float32")
        kernel_fused_topk(torch)

    counts = main_path(torch, card)

    rows.update(kernel_train_layers(torch))
    kernel_scatter(torch)
    kernel_member(torch)
    torch.cuda.empty_cache()
    train_counts, train_line, trainer, raw, aug = train_path(torch, card)
    check_train_path(torch, trainer, raw, aug)
    profile_train_path(torch, trainer, raw, card)
    del trainer, raw, aug
    torch.cuda.empty_cache()
    opt_in_counts = opt_in_variants(torch, card)

    torch.cuda.empty_cache()
    with torch.no_grad():
        rows["fused_attention"], rows["fused_attention_bwd"] = kernel_fused_attention(torch)
        rows["fused_ffn"], rows["fused_ffn_bwd"], rows["fused_ffn_cuda_core"] = \
            kernel_fused_ffn(torch)
    torch.cuda.empty_cache()
    entry_counts, _, trainer, train_data = entry_path(torch, card)
    from unirec_tpu_torch.ops import member as MB, scatter_accum as SA
    entry_scatter, entry_member = [], []
    with call_capture(SA, "_scatter_cuda", entry_scatter), \
            call_capture(MB, "_member_cuda", entry_member):
        ev, eval_batch = check_entry_path(torch, trainer, train_data)
    scatter_entry = kernel_scatter_path(torch, "entry", entry_scatter)
    ids, grads, _ = max(entry_scatter, key=lambda c: c[0].numel())   # the item_seq call
    rows["scatter_add2"] = kernel_scatter2(torch, ids, grads)
    # row 8's line is one real batch of the entry path's (rows, cand)
    rows["member"] = member_line(torch, *entry_member[0], "entry path")
    del entry_scatter, entry_member, ids, grads
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
    with call_capture(SA, "_scatter_cuda", long_scatter):
        ev, eval_batch = timed("long_path_check", check_entry_path, torch, trainer, train_data,
                               phase="long_path_check")
    timed("scatter_long_ids", kernel_scatter_path, torch, "long", long_scatter)
    del long_scatter
    timed("long_path_profile", profile_entry_path, torch, trainer, train_data, ev,
          eval_batch, card, phase="long_path_profile")
    del trainer, train_data, ev, eval_batch
    torch.cuda.empty_cache()
    serve_counts = timed("long_serve", long_serve, torch, ckpt, card)
    torch.cuda.empty_cache()
    pop_counts, trainer, train_data = timed("pop_session_path", pop_session_path, torch, card)
    timed("pop_session_check", check_pop_session, torch, trainer, train_data, card)
    del trainer, train_data
    torch.cuda.empty_cache()
    family_counts, svd_calls = timed("seq_family_path", seq_family_path, torch, card)
    for ids, g, n_rows in svd_calls:     # row 6 on one SVD++ step's three tables
        what = FAMILY_SCATTER_IDS.get(ids.numel() // FAMILY_BATCH, "?")
        scatter_line(torch, ids.to(torch.int32), g, f"seq_family SVDPlusPlus {what}",
                     n_rows=n_rows, traced=True)
    del svd_calls
    torch.cuda.empty_cache()
    side_counts, side_serve_counts, trainer, _ = timed("side_inputs_path", side_inputs_path,
                                                       torch, card)
    timed("mlp_scorer_check", mlp_scorer_check, torch, trainer, card)
    del trainer
    torch.cuda.empty_cache()
    # row 8's block body runs on MF's 76 candidates an example alone
    cf_counts, rows["member_block"] = timed("cf_path", cf_path, torch, card)
    torch.cuda.empty_cache()
    with torch.no_grad():
        timed("kernel_bst_shape", kernel_bst_shape, torch)
    rank_counts = timed("rank_path", rank_path, torch, card)
    torch.cuda.empty_cache()
    approx_counts = timed("approx_topk", approx_topk, torch, card)
    morec_counts = timed("morec_path", morec_path, torch, card)
    torch.cuda.empty_cache()
    background["export"] = start_export_compile()   # its host compilation beside the solvers
    solver_counts = timed("solver_path", solver_path, torch, card)
    torch.cuda.empty_cache()
    export_counts, client_counts = timed("export_path", export_path, torch, card, background)
    torch.cuda.empty_cache()
    dist_counts = timed("dist_path", dist_path, torch, card, train_line["examples_per_s"])

    # row 6's line is the entry path's item_seq ids, its per-row body's the
    # same call's
    sc = rows["scatter_add"] = scatter_entry["item_seq"]
    rows["scatter_add_per_row"] = older_body_row(sc, "per_row", "per_row")
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
               "blockmax_cuda_core": ("unirec_tpu_torch/csrc/blockmax.cu",
                                      "unirec_tpu/ops/topk.py:225"),
               "blockmax_int8_cuda_core": ("unirec_tpu_torch/csrc/blockmax.cu",
                                           "unirec_tpu/ops/topk.py:236"),
               "layer_bwd": ("unirec_tpu_torch/csrc/layer_bwd.cu",
                             "unirec_tpu/ops/layer.py:311"),
               "lastq_bwd": ("unirec_tpu_torch/csrc/lastq_bwd.cu",
                             "unirec_tpu/ops/layer.py:638"),
               "scatter_add": ("unirec_tpu_torch/csrc/scatter_add.cu",
                               "unirec_tpu/ops/scatter_accum.py:44"),
               "scatter_add_per_row": ("unirec_tpu_torch/csrc/scatter_add.cu",
                                       "unirec_tpu/ops/scatter_accum.py:44"),
               "scatter_add2": ("unirec_tpu_torch/csrc/scatter_add.cu",
                                "unirec_tpu/ops/scatter_accum.py:146"),
               "member": ("unirec_tpu_torch/csrc/member.cu",
                          "unirec_tpu/ops/member.py:32"),
               "member_block": ("unirec_tpu_torch/csrc/member.cu",
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
    # the body each line times: rows 1-5q and 12 list their tensor-core body
    # ("mma") and their CUDA-core body, row 6 its sorted-tile body and its
    # per-row body, row 8 its warp body (the entry path's ids) and its block
    # body (cf_path MF's, the one path that takes it), the older body's
    # launches the rest of the kernel's; rows 9-11 and 13 name the body their
    # path shape takes; row 7 (not wired, as in JAX) launches row 6's kernel
    split = {**{n: ("mma", "cuda_core") for n in ("layer_fwd", "layer_bwd", "lastq_fwd",
                                                  "lastq_bwd", "fused_ffn", "blockmax",
                                                  "blockmax_int8")},
             "scatter_add": ("sorted", "per_row"), "member": ("warp", "block")}
    bodies = {"fused_ffn_bwd": "mma", "fused_attention": "mma", "fused_attention_bwd": "mma",
              "flash_attention": "mma", "scatter_add2": "sorted",
              **{n: new for n, (new, _) in split.items()},
              **{f"{n}_{old}": "cuda" if old == "cuda_core" else old
                 for n, (_, old) in split.items()}}
    paths = {"serving": counts, "training": train_counts, "entry": entry_counts,
             "long": long_counts, "long_serve": serve_counts, "pop_session": pop_counts,
             "seq_family": family_counts, "side_inputs": side_counts,
             "side_serve": side_serve_counts, "cf": cf_counts, "rank": rank_counts,
             "export": export_counts, "cpp_client": client_counts, "approx_topk": approx_counts,
             "morec": morec_counts, "solver": solver_counts, "dist": dist_counts,
             "opt_in": opt_in_counts}

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
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
