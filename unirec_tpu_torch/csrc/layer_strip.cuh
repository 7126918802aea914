// Strip helpers of the bf16 tensor-core layer bodies: csrc/layer_bwd.cu
// (row 2), csrc/layer_fwd.cu (row 1) and csrc/lastq_bwd.cu (row 4), so the
// forward, its recompute in the backward and the last-query backward cannot
// drift apart (the attention strip code itself is csrc/strip.cuh).
//
// A block's rows are cut into 16-row strips; two warps own a strip, each a
// half of its columns, and exchange LayerNorm row sums through shared memory
// under a 64-thread named barrier (ids 1.., one a strip). Operands are bf16
// rows in shared memory (leading dims in elements, rows 16-byte aligned).
#pragma once

#include "strip.cuh"

namespace unirec {

constexpr int kStrips = 4;                // 16-row strips of a block's 64 rows
constexpr int kMmaWarps = 2 * kStrips;    // two warps a strip, one a column half
constexpr int kMmaRows = 16 * kStrips;    // Mp, at most
constexpr int kMmaMaxD = 64;              // ops/layer.py::_MMA_MAX_D
constexpr int kSmemLimit = 232448;
using bf16 = __nv_bfloat16;

// The widths every bf16 tensor-core layer body takes (each adds its own
// shared-memory test; ops/layer.py::_mma_widths_take holds a copy): bf16,
// Lp <= 64 and a multiple of 8, D and the head width D / nh multiples of 16
// up to 64, F a multiple of 16.
__host__ __device__ inline bool mma_widths_take(int dtype, int Lp, int D, int F, int nh) {
  return dtype == 1 && Lp >= 1 && Lp <= kMmaRows && Lp % 8 == 0 && D >= 16 && D <= kMmaMaxD &&
         D % 16 == 0 && nh >= 1 && D % nh == 0 && (D / nh) % 16 == 0 && F >= 16 && F % 16 == 0;
}

// the (D / 16, head width / 16) pairs each tensor-core layer body is
// instantiated for: X(D16, HD16) for every width mma_widths_take admits
#define UNIREC_MMA_PAIRS(X) X(1, 1) X(2, 1) X(2, 2) X(3, 1) X(3, 3) X(4, 1) X(4, 2) X(4, 4)

__device__ __forceinline__ float rb(float v) { return rnd<bf16>(v); }
__device__ __forceinline__ float bfv(const bf16* p) { return __bfloat162float(*p); }

// acc (NT tiles of 16 x 8, nn of them used) = A B for the strip of A rows
// i0.., ks * 16 deep: A bf16 [rows][lda]; B bf16 [k][n] (BT false: x W) or
// [n][k] (BT true: x W^T), columns n0..
template <int NT, bool BT>
__device__ __forceinline__ void strip_mm(float acc[NT][4], const bf16* A, int lda, int i0, int ks,
                                         const bf16* B, int ldb, int n0, int nn, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  for (int kc = 0; kc < ks; ++kc) {
    uint32_t a[4];
    frag_a(a, A, lda, i0, kc * 16, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np >= nn) break;
      uint32_t b[4];
      if (BT)
        frag_b(b, B, ldb, n0 + np * 16, kc * 16, lane);
      else
        frag_b_t(b, B, ldb, n0 + np * 16, kc * 16, lane);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// sums over a strip row's quad (a row's values are spread over lanes
// 4g..4g+3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the two warps of strip `strip` wait for each other (named barrier 1 +
// strip; a block with several groups of strips numbers them on)
__device__ __forceinline__ void pair_bar(int strip) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + strip), "r"(64) : "memory");
}

// Per-row totals of the strip's two warps: own = this warp's row sums of
// rows g and g + 8 (over its columns, already summed over the quad); xch =
// the strip's [2 halves][8][2] exchange slots. Half 0's part is added
// first in both warps, so both get the same bits.
__device__ __forceinline__ void pair_sum(float own[2], float* xch, int strip, int half,
                                         int lane) {
  const int g = lane >> 2;
  if ((lane & 3) == 0) {
    xch[(half * 8 + g) * 2] = own[0];
    xch[(half * 8 + g) * 2 + 1] = own[1];
  }
  pair_bar(strip);
  const float o0 = xch[((half ^ 1) * 8 + g) * 2], o1 = xch[((half ^ 1) * 8 + g) * 2 + 1];
  pair_bar(strip);  // the slots are free again
  own[0] = half ? o0 + own[0] : own[0] + o0;
  own[1] = half ? o1 + own[1] : own[1] + o1;
}

// In place over the strip's rows in accumulator layout, this warp holding nd
// of their column tiles and its partner the rest of the D columns: the f32
// LayerNorm statistics, v -> xhat = (v - mean) * rs, rs[r] of rows g, g+8
template <int NT>
__device__ __forceinline__ void strip_ln(float v[NT][4], int nd, float rs[2], float eps,
                                         float inv_d, float* xch, int strip, int half,
                                         int lane) {
  float mu[2] = {0.0f, 0.0f}, var[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) mu[e >> 1] += v[n][e];
  mu[0] = quad_sum(mu[0]);
  mu[1] = quad_sum(mu[1]);
  pair_sum(mu, xch, strip, half, lane);
  mu[0] *= inv_d;
  mu[1] *= inv_d;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[n][e] - mu[e >> 1];
        var[e >> 1] += d * d;
      }
  var[0] = quad_sum(var[0]);
  var[1] = quad_sum(var[1]);
  pair_sum(var, xch, strip, half, lane);
#pragma unroll
  for (int r = 0; r < 2; ++r) rs[r] = rsqrtf(var[r] * inv_d + eps);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[n][e] = (v[n][e] - mu[e >> 1]) * rs[e >> 1];
}

// LayerNorm backward in place over the same split: dv (the upstream
// gradient) becomes dr = rs * (dv*g - mean(dv*g) - xhat * mean(dv*g*xhat))
// (ops/layer.py::_ln_bwd); columns c0 + n * 8 + 2t + (e & 1)
template <int NT>
__device__ __forceinline__ void strip_ln_bwd(float dv[NT][4], const float xh[NT][4], int nd,
                                             int c0, const float rs[2],
                                             const float* __restrict__ gam, float inv_d,
                                             float* xch, int strip, int half, int lane) {
  const int t = lane & 3;
  float m1[2] = {0.0f, 0.0f}, m2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv[n][e] *= __ldg(gam + c0 + n * 8 + 2 * t + (e & 1));
        m1[e >> 1] += dv[n][e];
        m2[e >> 1] += dv[n][e] * xh[n][e];
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m1[r] = quad_sum(m1[r]);
    m2[r] = quad_sum(m2[r]);
  }
  pair_sum(m1, xch, strip, half, lane);
  pair_sum(m2, xch, strip, half, lane);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dv[n][e] = rs[e >> 1] * (dv[n][e] - m1[e >> 1] * inv_d - xh[n][e] * (m2[e >> 1] * inv_d));
}

// dst[c] += the strip's column sums of f(n, e) over its 16 rows, for the nn
// tiles' columns c = n * 8 + 2t + (e & 1) (dst: this strip's own row of
// sums, and this warp's own columns of it, so no two warps write one
// address)
template <int NT, typename FV>
__device__ __forceinline__ void strip_colsum(FV f, int nn, float* dst, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= nn) break;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = f(n, c) + f(n, 2 + c);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) dst[n * 8 + 2 * t + c] += v;
    }
  }
}

// two values to the bf16 row r (leading dim ld) at column c, rounded
__device__ __forceinline__ void put2(bf16* p, int ld, int r, int c, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p + r * ld + c) = __floats2bfloat162_rn(v0, v1);
}

// slab[m][n] (leading dim N) += sum over nk16 * 16 tokens r of A[r][m] *
// Bm[r][n], for every 16 x 16 tile of the M x N gradient, the tiles dealt
// round robin to the block's warps: each loads kFlushBatch tiles' f32 sums
// from the block's own slab at once (one L2 round trip for the batch),
// adds the example by MMA (A^T through ldmatrix.trans) and stores them back
constexpr int kFlushBatch = 4;

__device__ __forceinline__ void flush_wgrad(const bf16* A, int lda, int M, const bf16* Bm, int ldb,
                                            int N, int nk16, float* __restrict__ slab, int warp,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3, tn = N / 16, tiles = (M / 16) * tn;
  for (int base = warp; base < tiles; base += kMmaWarps * kFlushBatch) {
    float acc[kFlushBatch][2][4];
    float* p[kFlushBatch];
#pragma unroll
    for (int q = 0; q < kFlushBatch; ++q) {
      const int tile = min(base + q * kMmaWarps, tiles - 1);
      p[q] = slab + (size_t)((tile / tn) * 16 + g) * N + (tile % tn) * 16 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 lo = *reinterpret_cast<const float2*>(p[q] + h * 8);
        const float2 hi = *reinterpret_cast<const float2*>(p[q] + (size_t)8 * N + h * 8);
        acc[q][h][0] = lo.x;
        acc[q][h][1] = lo.y;
        acc[q][h][2] = hi.x;
        acc[q][h][3] = hi.y;
      }
    }
    for (int kc = 0; kc < nk16; ++kc) {
#pragma unroll
      for (int q = 0; q < kFlushBatch; ++q) {
        const int tile = min(base + q * kMmaWarps, tiles - 1);
        uint32_t a[4], b[4];
        frag_a_t(a, A, lda, (tile / tn) * 16, kc * 16, lane);
        frag_b_t(b, Bm, ldb, (tile % tn) * 16, kc * 16, lane);
        mma_bf16(acc[q][0], a, b[0], b[1]);
        mma_bf16(acc[q][1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < kFlushBatch; ++q) {
      if (base + q * kMmaWarps >= tiles) break;  // a clamped duplicate: not stored
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(p[q] + h * 8) = make_float2(acc[q][h][0], acc[q][h][1]);
        *reinterpret_cast<float2*>(p[q] + (size_t)8 * N + h * 8) =
            make_float2(acc[q][h][2], acc[q][h][3]);
      }
    }
  }
}

}  // namespace unirec
