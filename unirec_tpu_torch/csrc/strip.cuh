// Warp-strip attention on the tensor cores, shared by the bf16 bodies of
// csrc/attention.cu (rows 10 and 11) and csrc/layer_bwd.cu (row 2), so the
// forward, its replay in the backward and the whole-layer backward cannot
// drift apart.
//
// A warp owns a 16-row strip of queries of one head, with at most kNT * 8 =
// 64 keys: the strip's scores live in its registers in the mma.sync m16n8
// accumulator layout (lane = 4g + t): element (n, e) is row i0 + g + (e >>
// 1) * 8 and key n * 8 + 2t + (e & 1). Operands are bf16 rows in shared
// memory (leading dims in elements, rows 16-byte aligned), with the key and
// head-width dims padded to multiples of 16 by zeros.
#pragma once

#include "common.cuh"

namespace unirec {

constexpr int kNT = 8;  // key tiles of 8 that a strip's registers hold

// acc = A B^T for the strip's rows of A and every key row of B (S = Q K^T,
// or dZ = dO V^T), HD16 * 16 columns deep, f32 sums
template <int HD16>
__device__ __forceinline__ void strip_abt(float acc[kNT][4], const __nv_bfloat16* A, int lda,
                                          const __nv_bfloat16* B, int ldb, int i0, int ntile,
                                          int lane) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < HD16; ++kc) {
    uint32_t a[4];
    ldmatrix_x4(a, A + (i0 + (lane & 15)) * lda + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      if (2 * np >= ntile) break;
      uint32_t bk[4];
      ldmatrix_x4(bk, B + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb + kc * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], a, bk[0], bk[1]);
      mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
    }
  }
}

// s: the strip's Q K^T -> the f32 softmax y of s * scale + mask(i, j) over
// each real row (i, j < L); keys and rows past L get y = 0 exactly
template <typename MF>
__device__ __forceinline__ void strip_softmax(float s[kNT][4], MF mask, int i0, int L, int ntile,
                                              float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >> 1) * 8, j = n * 8 + 2 * t + (e & 1);
      s[n][e] = n < ntile && i < L && j < L ? s[n][e] * scale + mask(i, j) : -CUDART_INF_F;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = s[n][e] == -CUDART_INF_F ? 0.0f : expf(s[n][e] - mx[e >> 1]);
      sum[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (s[n][e] != 0.0f) s[n][e] /= sum[e >> 1];
}

// the strip's dropout keep bits, bit n * 4 + e: philox_bits(seed, site, b, i
// * L + j) >= thresh, drawn once per real element (the forward's keying,
// which the backward replays; thresh 0 keeps every one and draws nothing)
__device__ __forceinline__ uint32_t strip_keep(uint32_t seed, uint32_t thresh, int site, int b,
                                               int i0, int L, int ntile, int lane) {
  // without dropout every bit is set: a padded element's y, dZ and z are 0
  // whatever its bit
  if (thresh == 0u) return 0xffffffffu;
  const int g = lane >> 2, t = lane & 3;
  uint32_t keep = 0u;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >> 1) * 8, j = n * 8 + 2 * t + (e & 1);
      const bool kp = n < ntile && i < L && j < L && kept(seed, thresh, site, b, i * L + j);
      keep |= (uint32_t)kp << (n * 4 + e);
    }
  return keep;
}

// z = keep ? y / (1 - p) : 0 of element (n, e), in f32 (rounded to bf16 by
// the caller)
__device__ __forceinline__ float dropped(const float s[kNT][4], uint32_t keep, int n, int e,
                                         float inv) {
  return (keep >> (n * 4 + e)) & 1u ? s[n][e] * inv : 0.0f;
}

// acc[d] (16 x 8 output columns d) += A B for the strip, A (16 x keys) given
// as 16-key A fragments by afrag(kc, a), B = [keys][HD16 * 16] bf16 rows
// (leading dim ldb) through ldmatrix.trans (O = z V, or dQ = ds K)
template <int HD16, typename AF>
__device__ __forceinline__ void strip_av(float acc[HD16 * 2][4], AF afrag,
                                         const __nv_bfloat16* B, int ldb, int ntile, int lane) {
#pragma unroll
  for (int kc = 0; kc < kNT / 2; ++kc) {
    if (2 * kc >= ntile) break;
    uint32_t a[4];
    afrag(kc, a);
#pragma unroll
    for (int dp = 0; dp < HD16; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, B + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + dp * 16 +
                                (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
      mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
    }
  }
}

// The transposed products of the attention backward for 16 key rows j0..
// (a warp's share, summed over every query strip in one pass, so no
// atomics and one order): av = Z^T dO and ak = dS^T Q, with Z, dS [queries][ldz]
// (query rows x keys) and dO, Q [queries][HD16 * 16] (leading dims ldo, ldq)
// in bf16, over nq16 strips of 16 queries
template <int HD16>
__device__ __forceinline__ void key_strip_grads(float av[HD16 * 2][4], float ak[HD16 * 2][4],
                                                const __nv_bfloat16* Zs,
                                                const __nv_bfloat16* DSs, int ldz,
                                                const __nv_bfloat16* DO, int ldo,
                                                const __nv_bfloat16* Q, int ldq, int j0,
                                                int nq16, int lane) {
#pragma unroll
  for (int d = 0; d < HD16 * 2; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[d][e] = ak[d][e] = 0.0f;
  for (int ic = 0; ic < nq16; ++ic) {
    uint32_t za[4], sa[4];
    const int off = (ic * 16 + (lane & 7) + (lane >> 4) * 8) * ldz + j0 + ((lane >> 3) & 1) * 8;
    ldmatrix_x4_trans(za, Zs + off);
    ldmatrix_x4_trans(sa, DSs + off);
#pragma unroll
    for (int dp = 0; dp < HD16; ++dp) {
      const int r = ic * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, c = dp * 16 + (lane >> 4) * 8;
      uint32_t bo[4], bq[4];
      ldmatrix_x4_trans(bo, DO + r * ldo + c);
      ldmatrix_x4_trans(bq, Q + r * ldq + c);
      mma_bf16(av[2 * dp], za, bo[0], bo[1]);
      mma_bf16(av[2 * dp + 1], za, bo[2], bo[3]);
      mma_bf16(ak[2 * dp], sa, bq[0], bq[1]);
      mma_bf16(ak[2 * dp + 1], sa, bq[2], bq[3]);
    }
  }
}

}  // namespace unirec
