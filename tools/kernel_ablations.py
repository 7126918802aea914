#!/usr/bin/env python3
"""What holds the redesigned kernels back, on one NVIDIA card.

    python3 tools/kernel_ablations.py [source ...]

Builds scratch copies of unirec_tpu_torch/csrc/flash_attention.cu (row 9),
csrc/attention.cu (rows 10 and 11), csrc/ffn.cu (rows 12 and 13) and
csrc/layer_bwd.cu (row 2), csrc/layer_fwd.cu (row 1), csrc/lastq_bwd.cu
(row 4), csrc/lastq_fwd.cu (row 3), csrc/scatter_add.cu (row 6),
csrc/member.cu (row 8) and csrc/blockmax.cu (rows 5 and 5q) with one
part of the new body removed (csrc/layer_strip.cuh written
into the copy, so its helpers can be changed too), each with the port's nvcc flags into
build/ablations/, and times every copy against the unmodified kernel, in
turns, at the shapes of the paths chip_smoke.py drives: flash attention at
B=8,192, H=2, L=256, hd=32 with the long path's mask; the fused-attention
backward and forward at B=32,768, H=2, L=50, hd=32, at dropout 0 and 0.1;
the FFN backward and forward at 1,638,400 tokens, D=64, F=128, swish; the
whole-layer backward at B=32,768, L=50 (Lp=56), D=64, 2 heads, F=128,
dropout 0.1 (its variants: copies alone, no activation math, no Philox
draws, no per-example weight-gradient flush into the block's slab, the cost
of that design choice); the whole-layer forward and the last-query backward
at the same shape (copies alone, no Philox draws, no activation math and,
for the backward, no weight-gradient products); the last-query forward at
the same shape (copies alone, no Philox draws, no activation math, no
attention, no batched row phase); the scatter-add's sorted-tile body at the
entry path's 1,638,400 rows on uniform ids and on ids 40% of which are the
padding id 0 (no sort, no reductions, no row loads, and reductions only:
neither sort nor loads); the membership test's warp body at B=32,768,
C=200, K=36 on uniform ids (no history loads: the lanes hold register
values; no filter: no bits set, so nothing is flagged or compared; no
compares: the flagged candidates are not verified); the catalog
block-max's tensor-core body at B=256, D=64 over 50,000 and 1,000,000
items, bf16 and int8 (no MMA, no cross-lane maxima, neither, no next-tile
loads, no output write). Those two kernels take
some microseconds a call, so they are timed by the card's clock
(chip_smoke.py::traced_kernel_ms), the others by CUDA events. Naming
sources (``lastq_fwd scatter_add``) runs those kernels' variants alone. A
copy computes
wrong results by design; only its time means anything. Beside them it
times a copy of the inputs (the bytes' floor on this card). Prints the
card, then one JSON line per kernel with the median of each variant's
times in ms.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablations"
ROUNDS = 3

# (name, source, [(text in the kernel, replacement)])
VARIANTS = [
    ("flash_no_lo", "flash_attention", [
        ("mma_bf16(acc[2 * dp], lo, bv[0], bv[1]);", ""),
        ("mma_bf16(acc[2 * dp + 1], lo, bv[2], bv[3]);", "")]),
    ("flash_no_exp", "flash_attention", [
        ("s[n][e] = exp2_fast((s[n][e] - m_use[e >> 1]) * kLog2e);",
         "s[n][e] = s[n][e] - m_use[e >> 1];")]),
    ("flash_no_mask_copy", "flash_attention", [
        ("for (int w = threadIdx.x; w < nm * kMQ * ch; w += blockDim.x) {",
         "for (int w = threadIdx.x; w < 0; w += blockDim.x) {")]),
    ("flash_copies_only", "flash_attention", [
        ("      if (active) {\n        const __nv_bfloat16* K",
         "      if (false) {\n        const __nv_bfloat16* K")]),
    ("bwd_no_transposed_products", "attention", [
        ("  if (warp * 16 < Lp) {\n    const int j0", "  if (false) {\n    const int j0")]),
    ("fwd_no_keep_bits", "attention", [
        ("const uint32_t keep = strip_keep(seed, thresh, h, b, i0, L, ntile, lane);\n"
         "      float o[NDT][4];",
         "const uint32_t keep = 0xffffffffu;\n      float o[NDT][4];")]),
    ("fwd_no_pv", "attention", [
        ("      strip_av<HD16>(o, [&](int kc, uint32_t a[4]) {\n#pragma unroll\n"
         "        for (int r = 0; r < 4; ++r) {",
         "      if (false) strip_av<HD16>(o, [&](int kc, uint32_t a[4]) {\n#pragma unroll\n"
         "        for (int r = 0; r < 4; ++r) {")]),
    ("fwd_copies_only", "attention", [
        ("for (int u = warp; u < ng * nstrip; u += nwarps) {",
         "for (int u = warp; u < 0; u += nwarps) {")]),
    ("ffn_bwd_no_activation", "ffn", [
        ("act_pair<A>(pre[n][e] + b1s[(half * 8 + n) * 8 + 2 * t + (e & 1)], h, d);",
         "h = d = pre[n][e] + b1s[(half * 8 + n) * 8 + 2 * t + (e & 1)];")]),
    ("ffn_bwd_no_weight_grads", "ffn", [
        ("    if (strip < D16) {\n#pragma unroll\n      for (int kc", "    if (false) {\n#pragma unroll\n      for (int kc"),
        ("    if (warp * 16 < fc) {\n#pragma unroll\n      for (int kc", "    if (false) {\n#pragma unroll\n      for (int kc")]),
    ("ffn_bwd_copies_only", "ffn", [
        ("    // pre = X W1 + b1 and dz = dY W2^T for this warp's strip and half chunk\n    {",
         "    if (false) {"),
        ("    // dx = rnd(dh) W1^T for this warp's strip and half of D\n    {", "    if (false) {"),
        ("    if (strip < D16) {\n#pragma unroll\n      for (int kc", "    if (false) {\n#pragma unroll\n      for (int kc"),
        ("    if (warp * 16 < fc) {\n#pragma unroll\n      for (int kc", "    if (false) {\n#pragma unroll\n      for (int kc")]),
    ("ffn_fwd_no_activation", "ffn", [
        ("act_pair<A>(pre[n][e] + b1s[kc * 16 + n * 8 + 2 * t + (e & 1)], h[n][e], d);",
         "h[n][e] = pre[n][e] + b1s[kc * 16 + n * 8 + 2 * t + (e & 1)]; d = 0.0f;")]),
    ("ffn_fwd_copies_only", "ffn", [
        ("    for (int ch = 0; ch < nch; ++ch) {\n      if (nch > 1) {  // every warp",
         "    for (int ch = 0; ch < 0; ++ch) {\n      if (nch > 1) {  // every warp")]),
    # row 2: the per-example weight-gradient flush into the block's slab
    # (the weight-gradient products and their slab round trips), the design
    # chosen because the 134 KB of f32 sums fit neither beside the weights
    # and tiles in shared memory nor in registers. On an NVIDIA H100 80GB
    # HBM3 at 700 W, B=32,768, dropout 0.1: 14.12 ms with it, 11.48 without.
    ("layer_bwd_no_weight_flush", "layer_bwd", [
        ("  for (int base = warp; base < tiles; base += kMmaWarps * kFlushBatch) {",
         "  for (int base = warp; base < 0; base += kMmaWarps * kFlushBatch) {")]),
    ("layer_bwd_no_philox", "layer_bwd", [
        ("      eps, dr);\n  return (int)cudaGetLastError();",
         "      eps, Drop{dr.seed, 0u, 0u, dr.inv_attn, dr.inv_hidden});\n"
         "  return (int)cudaGetLastError();")]),
    ("layer_bwd_no_activation", "layer_bwd", [
        ("              act_pair<A>(u0, h0, d);\n              act_pair<A>(u1, h1, d);",
         "              h0 = u0; h1 = u1; d = 0.0f;"),
        ("              act_pair<A>(bfv(p), h, d0);\n              act_pair<A>(bfv(p + 1), h, d1);",
         "              d0 = bfv(p); d1 = bfv(p + 1); h = 0.0f;")]),
    ("layer_bwd_copies_only", "layer_bwd", [
        ("  const bool active = i0 < Mp;", "  const bool active = false;"),
        ("  for (int base = warp; base < tiles; base += kMmaWarps * kFlushBatch) {",
         "  for (int base = warp; base < 0; base += kMmaWarps * kFlushBatch) {")]),
    # row 1's tensor-core forward
    ("layer_fwd_copies_only", "layer_fwd", [
        ("  const bool active = i0 < Mp;", "  const bool active = false;")]),
    ("layer_fwd_no_philox", "layer_fwd", [
        ("(bf16*)y, B, Lp, F, act, causal, eps, dr);",
         "(bf16*)y, B, Lp, F, act, causal, eps,\n"
         "      Drop{dr.seed, 0u, 0u, dr.inv_attn, dr.inv_hidden});")]),
    ("layer_fwd_no_activation", "layer_fwd", [
        ("act_pair<A>(rb(rb(pre[n][e]) + bfv(b1 + f0 + n * 8 + 2 * t + (e & 1))), hh[n][e], d);",
         "hh[n][e] = rb(rb(pre[n][e]) + bfv(b1 + f0 + n * 8 + 2 * t + (e & 1))); d = 0.0f;")]),
    # row 4's tensor-core backward; no_weight_flush: neither the dWk|dWv MMAs
    # into registers nor the rank-1 gradients' 16-deep MMAs into the slab
    ("lastq_bwd_copies_only", "lastq_bwd", [
        ("    const bf16* DY = DYs(st);\n",
         "    const bf16* DY = DYs(st);\n    if (b >= 0) {\n      __syncthreads();\n"
         "      continue;\n    }\n")]),
    ("lastq_bwd_no_philox", "lastq_bwd", [
        ("      eps, dr);\n  return (int)cudaGetLastError();",
         "      eps, Drop{dr.seed, 0u, 0u, dr.inv_attn, dr.inv_hidden});\n"
         "  return (int)cudaGetLastError();")]),
    ("lastq_bwd_no_activation", "lastq_bwd", [
        ("        act_pair<A>(uu, h, d);", "        h = uu; d = 0.0f;"),
        ("        act_pair<A>(u[f], h, d);", "        h = 0.0f; d = u[f];")]),
    ("lastq_bwd_no_weight_flush", "lastq_bwd", [
        ("      flush_wgrad(XQg, LDD, D, DQg, LDD, D, 1, slab, warp, lane);\n"
         "      flush_wgrad(CTg, LDD, D, DOg, LDD, D, 1, slab + o_wo, warp, lane);\n"
         "      flush_wgrad(X1g, LDD, D, DUg, LDF, F, 1, slab + o_w1, warp, lane);\n"
         "      flush_wgrad(HMg, LDF, F, DHg, LDD, D, 1, slab + o_w2, warp, lane);\n", ""),
        ("    if (wkv_mine) {\n      for (int kc = 0;", "    if (false) {\n      for (int kc = 0;")]),
    # row 3's tensor-core forward; no_row_phase: neither the batched
    # out-projection and FFN products nor the LayerNorms (y is never written)
    ("lastq_fwd_copies_only", "lastq_fwd", [
        ("    const bf16* X = Xs(st);\n    const float* M = Ms(st);\n",
         "    const bf16* X = Xs(st);\n    const float* M = Ms(st);\n    if (b >= 0) continue;\n")]),
    ("lastq_fwd_no_philox", "lastq_fwd", [
        ("(bf16*)y, B, Lp, F, qi, act, eps, dr);",
         "(bf16*)y, B, Lp, F, qi, act, eps,\n"
         "      Drop{dr.seed, 0u, 0u, dr.inv_attn, dr.inv_hidden});")]),
    ("lastq_fwd_no_activation", "lastq_fwd", [
        ("            act_pair<A>(rb(rb(acc[n2][2 * r]) + ba), h0, d);\n"
         "            act_pair<A>(rb(rb(acc[n2][2 * r + 1]) + bb), h1, d);",
         "            h0 = rb(rb(acc[n2][2 * r]) + ba);\n"
         "            h1 = rb(rb(acc[n2][2 * r + 1]) + bb);\n            d = 0.0f;")]),
    ("lastq_fwd_no_attention", "lastq_fwd", [
        ("    if (gw < NH) {\n      const int h = gw;\n      float sc[2], p[2];",
         "    if (false) {\n      const int h = gw;\n      float sc[2], p[2];")]),
    ("lastq_fwd_no_row_phase", "lastq_fwd", [
        ("      row_phase(slot);\n", "")]),
    # row 6's sorted-tile body; atomics_only: the keys staged, then every
    # row's (or run's) reductions of zeros, neither sorted nor loaded
    ("scatter_no_sort", "scatter_add", [("  bitonic_sort(keys, tile);\n", "")]),
    ("scatter_no_reductions", "scatter_add", [
        ("      atomicAdd(reinterpret_cast<float4*>(acc + (size_t)cur * D + 4 * c),\n"
         "                make_float4(s[0], s[1], s[2], s[3]));",
         "      if (s[0] == 1234.5f) acc[(size_t)cur * D + 4 * c] = s[1] + s[2] + s[3];")]),
    ("scatter_no_loads", "scatter_add", [
        ("v[u] = __ldg(reinterpret_cast<const V*>(gt + (size_t)(k[u] & (kMaxTile - 1)) * D));",
         "v[u] = V{};")]),
    ("scatter_atomics_only", "scatter_add", [
        ("  bitonic_sort(keys, tile);\n", ""),
        ("v[u] = __ldg(reinterpret_cast<const V*>(gt + (size_t)(k[u] & (kMaxTile - 1)) * D));",
         "v[u] = V{};")]),
    # row 8's warp body; no_filter: no bits set, so nothing is flagged or
    # compared; no_compares: the flagged candidates are not verified
    ("member_no_history_loads", "member", [
        ("h[s] = j < C ? __ldg(hrow + j) : 0;", "h[s] = j < C ? j + 1 : 0;")]),
    ("member_no_filter", "member", [
        ("        atomicOr(filt + (x >> 5), 1u << (x & 31u));\n", "")]),
    ("member_no_compares", "member", [("  if (m0 | m1) {\n", "  if (false) {\n")]),
    # rows 5 and 5q's tensor-core body; no_maxima: no cross-lane reduction;
    # no_compute: neither products nor maxima (the tiles still load and the
    # staged maxima still leave)
    ("blockmax_no_mma", "blockmax", [
        ("            if (nt < nact) mma_bf16(acc[nt], a, bfr[nt][ks][0], bfr[nt][ks][1]);",
         "            ;")]),
    ("blockmax_no_maxima", "blockmax", [
        ("        Os[r * kOsLd + m] = max_over_rows(x, lane);",
         "        if (x[0] == 1234.5f) Os[r * kOsLd + m] = x[1];")]),
    ("blockmax_no_compute", "blockmax", [("    if (nact > 0) {\n", "    if (false) {\n")]),
    ("blockmax_no_prefetch", "blockmax", [
        ("    if (jn < ntiles) prefetch(jn);", "    if (false) prefetch(jn);")]),
    ("blockmax_no_output_write", "blockmax", [
        ("if (r < nu && c0 + c < nb) out[(size_t)(u0 + r) * nb + c0 + c] = Os[r * kOsLd + c];",
         "if (r < nu && c0 + c < nb && Os[r * kOsLd + c] == 1234.5f)\n"
         "        out[(size_t)(u0 + r) * nb + c0 + c] = 0;")]),
]


def variant_source(src: str, reps) -> str:
    """csrc/<src>.cu with csrc/layer_strip.cuh written into it (its helpers,
    the flush among them, are then the copy's to change), each (old, new)
    replaced; raises if the kernel no longer holds an old text."""
    from unirec_tpu_torch.ops import _build
    text = (_build.CSRC / f"{src}.cu").read_text()
    strip = (_build.CSRC / "layer_strip.cuh").read_text().replace("#pragma once\n", "")
    text = text.replace('#include "layer_strip.cuh"\n', strip)
    for old, new in reps:
        if old not in text:
            raise RuntimeError(f"{src}: the kernel no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(sources):
    sys.path.insert(0, str(ROOT))
    from unirec_tpu_torch.ops import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src, reps in VARIANTS:
        if src not in sources:
            continue
        path = OUT / f"{name}.cu"
        path.write_text(variant_source(src, reps))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(OUT / f"lib{name}.so"), str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_variants(torch, lib_name, entry, names, fn, timer=None):
    """Median ms of fn with the kernel library swapped for each variant's,
    in turns with the unmodified kernel ("kernel"); ``timer(fn)`` times it
    (CUDA events unless given)."""
    timer = timer or (lambda f: cuda_ms(torch, f))
    from unirec_tpu_torch.ops import _build
    real = _build.library
    times = {}
    try:
        for rnd in range(ROUNDS):
            order = ["kernel", *names] if rnd % 2 == 0 else [*names, "kernel"]
            for name in order:
                entry.cache_clear()
                _build.library = real if name == "kernel" else (
                    lambda n, _p=str(OUT / f"lib{name}.so"): ctypes.CDLL(_p)
                    if n == lib_name else real(n))
                times.setdefault(name, []).append(timer(fn))
    finally:
        _build.library = real
        entry.cache_clear()
    return {k: statistics.median(v) for k, v in times.items()}


SOURCES = ("flash_attention", "attention", "ffn", "layer_bwd", "layer_fwd", "lastq_bwd",
           "lastq_fwd", "scatter_add", "member", "blockmax")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_ablations: no CUDA device", file=sys.stderr)
        return 2
    sources = set(argv) or set(SOURCES)
    if not sources <= set(SOURCES):
        print(f"kernel_ablations: sources are {SOURCES}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from card_cases import path_layer_case
    from chip_smoke import smi_line
    from unirec_tpu_torch.ops import layer as LY
    print(smi_line(), flush=True)
    build_variants(sources)
    if "flash_attention" in sources:
        flash_variants(torch)
    if "attention" in sources:
        attention_variants(torch)
    if "ffn" in sources:
        ffn_variants(torch)
    if sources & {"layer_bwd", "layer_fwd", "lastq_bwd", "lastq_fwd"}:
        # rows 1-4 at the training path's shape, dropout 0.1 on every site
        xp, mp, params = path_layer_case("cuda", torch.bfloat16, 32768, 10)
        fargs = (2, "swish", 1e-10, True, LY.drop_params(0.1, 0.1, True, 12345))
        layer_variants(torch, sources, xp, mp, params, fargs)
    if "scatter_add" in sources:
        scatter_variants(torch)
    if "member" in sources:
        member_variants(torch)
    if "blockmax" in sources:
        blockmax_variants(torch)
    return 0


def flash_variants(torch):
    from card_cases import att_case
    from unirec_tpu_torch.ops import attention as AT
    q, k, v, mask = att_case("cuda", torch.bfloat16, B=8192, L=256)
    names = [n for n, src, _ in VARIANTS if src == "flash_attention"]
    line = timed_variants(torch, "flash_attention", AT._flash_entry, names,
                          lambda: AT._flash_fwd_cuda(q, k, v, mask))
    line["copy_of_q_k_v_mask"] = cuda_ms(torch, lambda: [t.clone() for t in (q, k, v, mask)])
    print(json.dumps({"kernel": "flash_attention", "shape": list(q.shape), "ms": line}),
          flush=True)


def attention_variants(torch):
    from card_cases import att_case
    from unirec_tpu_torch.ops import attention as AT
    from unirec_tpu_torch.ops import layer as LY
    q, k, v, mask = att_case("cuda", torch.bfloat16, B=32768, L=50)
    do = torch.randn_like(q.float()).to(torch.bfloat16)
    for kind in ("bwd", "fwd"):
        names = [n for n, src, _ in VARIANTS if src == "attention" and n.startswith(kind)]
        for p in (0.0, 0.1):
            drop = LY.drop_params(p, 0.0, True, 777)
            fn = (lambda: AT._bwd_cuda(q, k, v, mask, do, drop)) if kind == "bwd" else (
                lambda: AT._fwd_cuda(q, k, v, mask, drop))
            line = timed_variants(torch, "attention", AT._entry, names, fn)
            line["copy_of_inputs"] = cuda_ms(torch, lambda: [
                t.clone() for t in ((q, k, v, do, mask) if kind == "bwd" else (q, k, v, mask))])
            print(json.dumps({"kernel": f"fused_attention_{kind}", "p_drop": p,
                              "shape": list(q.shape), "ms": line}), flush=True)


def ffn_variants(torch):
    from unirec_tpu_torch.ops import ffn as FF
    g = torch.Generator(device="cuda").manual_seed(40)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device="cuda") * std).to(  # noqa: E731
        torch.bfloat16)
    T = 32768 * 50
    x, dy, w1, b1 = rn(T, 64), rn(T, 64), rn(64, 128, std=0.1), rn(128, std=0.02)
    w2, b2 = rn(128, 64, std=0.1), rn(64, std=0.02)
    names = [n for n, src, _ in VARIANTS if src == "ffn" and n.startswith("ffn_bwd")]
    line = timed_variants(torch, "ffn", FF._entry, names,
                          lambda: FF._bwd_cuda(x, w1, b1, w2, b2, dy, "swish"))
    line["copy_of_x_dy"] = cuda_ms(torch, lambda: [t.clone() for t in (x, dy)])
    print(json.dumps({"kernel": "fused_ffn_bwd", "tokens": T, "dims": [64, 128], "ms": line}),
          flush=True)
    names = [n for n, src, _ in VARIANTS if src == "ffn" and n.startswith("ffn_fwd")]
    line = timed_variants(torch, "ffn", FF._entry, names,
                          lambda: FF._fwd_cuda(x, w1, b1, w2, b2, "swish"))
    line["copy_of_x"] = cuda_ms(torch, lambda: x.clone())
    line["addmm_silu_addmm"] = cuda_ms(torch, lambda: torch.addmm(
        b2, torch.nn.functional.silu(torch.addmm(b1, x, w1)), w2))
    print(json.dumps({"kernel": "fused_ffn", "tokens": T, "dims": [64, 128], "ms": line}),
          flush=True)


def layer_variants(torch, sources, xp, mp, params, fargs):
    from unirec_tpu_torch.ops import layer as LY
    g = torch.Generator(device="cuda").manual_seed(40)
    flat = LY._layer_weights(params, torch.bfloat16)
    qflat = LY._lastq_weights(params, torch.bfloat16)
    qargs = (49, *fargs[:3], fargs[4])  # (q index, nh, act, eps, dropout)
    if "layer_bwd" in sources:
        dyl = torch.randn(xp.shape, generator=g, device="cuda").to(torch.bfloat16)
        names = [n for n, src, _ in VARIANTS if src == "layer_bwd"]
        line = timed_variants(torch, "layer_bwd", LY._entry, names,
                              lambda: LY._layer_bwd_cuda(xp, mp, flat, dyl, *fargs))
        line["copy_of_x_dy"] = cuda_ms(torch, lambda: [t.clone() for t in (xp, dyl)])
        print(json.dumps({"kernel": "layer_bwd", "shape": list(xp.shape), "p_drop": 0.1,
                          "ms": line}), flush=True)
        del dyl
    runs = {"layer_fwd": lambda: LY._layer_fwd_cuda(xp, mp, flat, *fargs),
            "lastq_fwd": lambda: LY._lastq_fwd_cuda(xp, mp, qflat, *qargs)}
    if "lastq_bwd" in sources:
        dyq = torch.randn(xp.shape[0], xp.shape[2], generator=g, device="cuda").to(torch.bfloat16)
        runs["lastq_bwd"] = lambda: LY._lastq_bwd_cuda(xp, mp, qflat, dyq, *qargs)
    for src in ("layer_fwd", "lastq_bwd", "lastq_fwd"):
        if src not in sources:
            continue
        names = [n for n, s, _ in VARIANTS if s == src]
        line = timed_variants(torch, src, LY._entry, names, runs[src])
        line["copy_of_x"] = cuda_ms(torch, lambda: xp.clone())
        print(json.dumps({"kernel": src, "shape": list(xp.shape), "p_drop": 0.1, "ms": line}),
              flush=True)


def scatter_variants(torch):
    """Row 6 at the entry path's item_seq shape on uniform ids and on ids 40%
    of which are the padding id 0."""
    from unirec_tpu_torch.ops import scatter_accum as SA
    g = torch.Generator(device="cuda").manual_seed(41)
    M, N = 1_638_400, 50_000
    rows = (torch.randn(M, 64, generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    uniform = torch.randint(0, N, (M,), generator=g, device="cuda", dtype=torch.int32)
    pad = torch.rand(M, generator=g, device="cuda") < 0.4
    names = [n for n, src, _ in VARIANTS if src == "scatter_add"]
    for what, ids in (("uniform", uniform), ("40% id 0", torch.where(pad, 0, uniform))):
        line = timed_variants(torch, "scatter_add", SA._lib, names,
                              lambda: SA._scatter_cuda(ids, rows, N))
        line["copy_of_rows"] = cuda_ms(torch, lambda: rows.clone())
        print(json.dumps({"kernel": "scatter_add", "ids": what, "rows": M, "table": [N, 64],
                          "ms": line}), flush=True)


def member_variants(torch):
    """Row 8's warp body at the training shape on uniform ids (a third of the
    candidates from the history), by the card's clock."""
    from chip_smoke import traced_kernel_ms
    from unirec_tpu_torch.ops import member as MB
    g = torch.Generator(device="cuda").manual_seed(42)
    rows = torch.randint(0, 50_000, (32768, 200), generator=g, device="cuda", dtype=torch.int32)
    cand = torch.randint(1, 50_000, (32768, 36), generator=g, device="cuda", dtype=torch.int32)
    cand[:, ::3] = rows[:, :12]
    names = [n for n, src, _ in VARIANTS if src == "member"]
    line = timed_variants(torch, "member", MB._lib, names, lambda: MB._member_cuda(rows, cand),
                          lambda f: traced_kernel_ms(f, "member_warp_kernel"))
    print(json.dumps({"kernel": "member", "rows": [32768, 200], "cand": [32768, 36],
                      "timer": "traced", "ms": line}), flush=True)


def blockmax_variants(torch):
    """Rows 5 and 5q's tensor-core body at the serving batch, by the card's
    clock."""
    from chip_smoke import traced_kernel_ms
    from unirec_tpu_torch.ops import topk as TK
    g = torch.Generator(device="cuda").manual_seed(43)
    u = torch.randn(256, 64, generator=g, device="cuda").to(torch.bfloat16)
    names = [n for n, src, _ in VARIANTS if src == "blockmax"]
    for n_items in (50_000, 1_000_000):
        it = (torch.randn(n_items, 64, generator=g, device="cuda") * 0.05).to(torch.bfloat16)
        for kind, (items, scale) in (("bf16", (it, None)), ("int8", TK.quantize_catalog(it))):
            line = timed_variants(torch, "blockmax", TK._blockmax_lib, names,
                                  lambda: TK._blockmax_cuda(u, items, scale),
                                  lambda f: traced_kernel_ms(f, "blockmax_mma_kernel"))
            print(json.dumps({"kernel": "blockmax", "users": 256, "items": n_items, "dim": 64,
                              "item_dtype": kind, "timer": "traced", "ms": line}), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
