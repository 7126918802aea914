// Helpers shared by the port's hand-written Hopper kernels.
//
// Storage types: float or __nv_bfloat16 ("T" below). Every kernel computes
// in f32 and rounds to T at exactly the points where the JAX/Pallas kernels
// cast to the input dtype, so the plain PyTorch versions beside the
// wrappers (unirec_tpu_torch/ops/*.py) reproduce the arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace unirec {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// value of v after a cast to T and back (identity for float)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// activation codes, in the order of ops/layer.py::SUPPORTED_ACTS; leakyrelu
// (slope 0.01) only in ops/ffn.py::ACTS
enum Act {
  ACT_RELU = 0, ACT_SWISH = 1, ACT_GELU = 2, ACT_TANH = 3, ACT_SIGMOID = 4,
  ACT_LEAKYRELU = 5
};

__device__ __forceinline__ float activate(int act, float u) {
  switch (act) {
    case ACT_RELU: return fmaxf(u, 0.0f);
    case ACT_SWISH: return u / (1.0f + expf(-u));
    case ACT_GELU: return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
    case ACT_TANH: return tanhf(u);
    case ACT_LEAKYRELU: return u >= 0.0f ? u : 0.01f * u;
    default: return 1.0f / (1.0f + expf(-u));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C[r, c] = rnd(rnd(sum_k A[r, k] * W[k, c]) + bias[c]) for r < rows, c < N.
// A: f32 rows in shared memory (leading dim lda); W: [K, N] row-major in
// global memory (the flax kernel layout); C: shared memory (leading dim ldc).
// A thread owns one column and RB consecutive rows, so each weight it loads
// feeds RB products; neighbouring threads read neighbouring columns.
template <typename T, int RB>
__device__ void dense_rows(const float* A, int lda, int rows, int K,
                           const T* __restrict__ W, int N,
                           const T* __restrict__ bias, float* C, int ldc) {
  const int nrb = (rows + RB - 1) / RB;
  for (int w = threadIdx.x; w < nrb * N; w += blockDim.x) {
    const int c = w % N;
    const int r0 = (w / N) * RB;
    int rr[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) rr[i] = min(r0 + i, rows - 1) * lda;
    float acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float wv = to_f<T>(W[(size_t)k * N + c]);
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[i] = fmaf(A[rr[i] + k], wv, acc[i]);
    }
    const float bv = to_f<T>(bias[c]);
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if (r0 + i < rows) C[(r0 + i) * ldc + c] = rnd<T>(rnd<T>(acc[i]) + bv);
  }
}

// In place over `rows` rows of width D (leading dim ld), one warp per row:
// the f32 LayerNorm y = (r - mean) * rsqrt(var + eps) * g + b, rounded to T.
template <typename T>
__device__ void layer_norm_rows(float* R, int ld, int rows, int D,
                                const float* __restrict__ g,
                                const float* __restrict__ b, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < rows; r += nwarps) {
    float* row = R + r * ld;
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += row[c];
    const float mu = warp_sum(s) / D;
    float v = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = row[c] - mu;
      v += d * d;
    }
    const float rs = rsqrtf(warp_sum(v) / D + eps);
    for (int c = lane; c < D; c += 32) row[c] = rnd<T>((row[c] - mu) * rs * g[c] + b[c]);
  }
}

// Philox4x32-10 (Salmon et al., SC'11), word 0 of the block for
// counter (elem, b, 0, 0) and key (seed, site). Dropout masks are keyed by
// (seed, dropout site, example index b, element index within the example),
// so a mask depends on no block or grid size: the forward and backward
// kernels regenerate identical masks whatever their launch shapes. The
// plain versions (ops/layer.py::philox_bits) compute the same words in
// int64 arithmetic.
__device__ __forceinline__ uint32_t philox_bits(uint32_t seed, uint32_t site,
                                                uint32_t b, uint32_t elem) {
  uint32_t c0 = elem, c1 = b, c2 = 0u, c3 = 0u, k0 = seed, k1 = site;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

// Dropout parameters of one kernel call. thresh = round(p * 2^32): an
// element is kept iff its bits are >= thresh (the JAX package's 32-bit rule,
// unirec_tpu/ops/common.py::keep_mask); thresh 0 keeps everything and draws
// no bits. inv = 1 / (1 - p). b0 is the global index of the call's
// first example: a rank of a data-parallel run holds rows [b0, b0 + B) of
// the global batch and keys its masks by b0 + b, so that its examples draw
// the masks they draw in a one-process run (rows 1-4; 0 elsewhere).
struct Drop {
  uint32_t seed, t_attn, t_hidden;
  float inv_attn, inv_hidden;
  uint32_t b0 = 0u;
};

__device__ __forceinline__ bool kept(uint32_t seed, uint32_t thresh, int site,
                                     int b, int elem) {
  return thresh == 0u || philox_bits(seed, (uint32_t)site, (uint32_t)b,
                                     (uint32_t)elem) >= thresh;
}

// Hidden dropout of a value already rounded to T: kept values are scaled
// by 1/(1-p) in f32 and rounded to T again, dropped ones become 0.
template <typename T>
__device__ __forceinline__ float drop_hidden(float v, const Drop& dr, int site,
                                             int b, int elem) {
  return kept(dr.seed, dr.t_hidden, site, dr.b0 + b, elem) ? rnd<T>(v * dr.inv_hidden) : 0.0f;
}

// In place softmax over each of `rows` rows of length n (leading dim ld),
// one warp per row, left in f32 (the pre-dropout probabilities).
__device__ __forceinline__ void softmax_rows(float* S, int ld, int rows, int n) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < rows; r += nwarps) {
    float* row = S + r * ld;
    float m = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < n; j += 32) row[j] = row[j] / s;
  }
}

// The f32 LayerNorm statistics of `rows` rows of width D (leading dim ld),
// one warp per row: R becomes xhat = (r - mean) * rs in place, rs[r] the
// reciprocal standard deviation (what the backward needs).
__device__ __forceinline__ void ln_stats_rows(float* R, int ld, int rows, int D,
                                              float* rs, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < rows; r += nwarps) {
    float* row = R + r * ld;
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += row[c];
    const float mu = warp_sum(s) / D;
    float v = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = row[c] - mu;
      v += d * d;
    }
    const float r_s = rsqrtf(warp_sum(v) / D + eps);
    for (int c = lane; c < D; c += 32) row[c] = (row[c] - mu) * r_s;
    if (lane == 0) rs[r] = r_s;
  }
}

// LayerNorm backward of `rows` rows in place, one warp per row: DY holds
// the upstream gradient and becomes dr = rs * (dy*g - mean(dy*g)
// - xhat * mean(dy*g*xhat)) (unirec_tpu/ops/layer.py::_ln_bwd).
__device__ __forceinline__ void ln_bwd_rows(float* DY, int ld, const float* XH,
                                            int ldh, const float* rs, int rows,
                                            int D, const float* __restrict__ g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < rows; r += nwarps) {
    float* dy = DY + r * ld;
    const float* xh = XH + r * ldh;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = dy[c] * g[c];
      s1 += d;
      s2 += d * xh[c];
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    for (int c = lane; c < D; c += 32)
      dy[c] = rs[r] * (dy[c] * g[c] - m1 - xh[c] * m2);
  }
}

// C[r, c] = sum_k A[r, k] * W(k, c) in f32, handed to epi(r, c, acc) for
// r < rows, c < N. A: f32 rows in shared memory (leading dim lda); W(k, c)
// = W[k * wsk + c * wsn] in global memory, so (wsk, wsn) = (N, 1) is a
// flax [K, N] kernel and (1, K) its transpose.
template <typename T, int RB, typename Epi>
__device__ void mm_rows(const float* A, int lda, int rows, int K,
                        const T* __restrict__ W, int wsk, int wsn, int N, Epi epi) {
  const int nrb = (rows + RB - 1) / RB;
  for (int w = threadIdx.x; w < nrb * N; w += blockDim.x) {
    const int c = w % N;
    const int r0 = (w / N) * RB;
    int rr[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) rr[i] = min(r0 + i, rows - 1) * lda;
    float acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float wv = to_f<T>(W[(size_t)k * wsk + (size_t)c * wsn]);
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[i] = fmaf(A[rr[i] + k], wv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if (r0 + i < rows) epi(r0 + i, c, acc[i]);
  }
}

// Weight gradient of one example into this block's f32 slab:
// slab[k * N + n] += sum_r A(r, k) * B(r, n) over r < rows, where A(r, k)
// = a(r, k) and B(r, n) = Bm[r * ldb + n]. No atomics: the slab is the
// block's own.
template <typename FA>
__device__ void wgrad(FA a, int K, const float* Bm, int ldb, int N, int rows,
                      float* slab) {
  for (int w = threadIdx.x; w < K * N; w += blockDim.x) {
    const int k = w / N, n = w % N;
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc = fmaf(a(r, k), Bm[r * ldb + n], acc);
    slab[w] += acc;
  }
}

// slab[n] += sum_r B(r, n): a bias gradient (or a LayerNorm parameter's
// gradient when fb is a product).
template <typename FB>
__device__ void colsum(FB fb, int N, int rows, float* slab) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc += fb(r, n);
    slab[n] += acc;
  }
}

// ------------------------------------------------- tensor-core building blocks
// mma.sync.m16n8k16 bf16 -> f32 fragments, per lane (g = lane / 4, t = lane
// % 4): A (16 x 16, row) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g,
// 2t+8..), a3 = (g+8, 2t+8..); B (16 x 8, col) b0 = (k 2t..2t+1, n g), b1 =
// (k 2t+8.., n g); C (16 x 8) c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).
// Each 32-bit register holds two bf16, the lower column in the low half.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled (src not read)
// when !pred. dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed on the way into the registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of a 16-wide k step from bf16 arrays in shared memory (leading
// dim ld, rows 16-byte aligned). A (16 x 16) of rows m0.. and columns k0..:
// frag_a from an [m][k] array, frag_a_t from a [k][m] one (transposed on the
// way in). B for two n-tiles (n0.. and n0 + 8..; b[0], b[1] the first, b[2],
// b[3] the second): frag_b from an [n][k] array, frag_b_t from a [k][n] one.
__device__ __forceinline__ void frag_a(uint32_t a[4], const __nv_bfloat16* p, int ld, int m0,
                                       int k0, int lane) {
  ldmatrix_x4(a, p + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

__device__ __forceinline__ void frag_a_t(uint32_t a[4], const __nv_bfloat16* p, int ld, int m0,
                                         int k0, int lane) {
  ldmatrix_x4_trans(a, p + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 + ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void frag_b(uint32_t b[4], const __nv_bfloat16* p, int ld, int n0,
                                       int k0, int lane) {
  ldmatrix_x4(b, p + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void frag_b_t(uint32_t b[4], const __nv_bfloat16* p, int ld, int n0,
                                         int k0, int lane) {
  ldmatrix_x4_trans(b, p + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// two f32 rounded to bf16 (nearest even) in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Activation derivative act'(u) in f32 (unirec_tpu/ops/layer.py::_act_pair).
__device__ __forceinline__ float activate_grad(int act, float u) {
  switch (act) {
    case ACT_RELU: return u > 0.0f ? 1.0f : 0.0f;
    case ACT_SWISH: {
      const float s = 1.0f / (1.0f + expf(-u));
      return s * (1.0f + u * (1.0f - s));
    }
    case ACT_GELU: {
      const float cdf = 0.5f * (1.0f + erff(u * 0.70710678118654752f));
      const float pdf = expf(-0.5f * u * u) * 0.39894228040143268f;
      return cdf + u * pdf;
    }
    case ACT_TANH: {
      const float t = tanhf(u);
      return 1.0f - t * t;
    }
    case ACT_LEAKYRELU: return u > 0.0f ? 1.0f : 0.01f;
    default: {
      const float s = 1.0f / (1.0f + expf(-u));
      return s * (1.0f - s);
    }
  }
}

// act(u) and act'(u) in f32 together, sharing their exponential or erf
// (the same functions as activate and activate_grad); A a compile-time code
template <int A>
__device__ __forceinline__ void act_pair(float u, float& h, float& d) {
  if (A == ACT_RELU) {
    h = fmaxf(u, 0.0f);
    d = u > 0.0f ? 1.0f : 0.0f;
  } else if (A == ACT_SWISH) {
    const float s = __frcp_rn(1.0f + expf(-u));
    h = u * s;
    d = s * (1.0f + u * (1.0f - s));
  } else if (A == ACT_GELU) {
    const float cdf = 0.5f * (1.0f + erff(u * 0.70710678118654752f));
    h = u * cdf;
    d = cdf + u * (expf(-0.5f * u * u) * 0.39894228040143268f);
  } else if (A == ACT_TANH) {
    h = tanhf(u);
    d = 1.0f - h * h;
  } else if (A == ACT_LEAKYRELU) {
    h = u >= 0.0f ? u : 0.01f * u;
    d = u > 0.0f ? 1.0f : 0.01f;
  } else {
    h = __frcp_rn(1.0f + expf(-u));
    d = h * (1.0f - h);
  }
}

template <int A> struct ActTag {
  static constexpr int value = A;
};

// f(ActTag<act>{}) for a run-time activation code: the switch stays outside
// f, whose loops then see one activation at compile time
template <typename F>
__device__ __forceinline__ void with_act(int act, F f) {
  switch (act) {
    case ACT_RELU: f(ActTag<ACT_RELU>{}); break;
    case ACT_SWISH: f(ActTag<ACT_SWISH>{}); break;
    case ACT_GELU: f(ActTag<ACT_GELU>{}); break;
    case ACT_TANH: f(ActTag<ACT_TANH>{}); break;
    case ACT_LEAKYRELU: f(ActTag<ACT_LEAKYRELU>{}); break;
    default: f(ActTag<ACT_SIGMOID>{}); break;
  }
}

}  // namespace unirec
