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

// activation codes, in the order of ops/layer.py::SUPPORTED_ACTS
enum Act { ACT_RELU = 0, ACT_SWISH = 1, ACT_GELU = 2, ACT_TANH = 3, ACT_SIGMOID = 4 };

__device__ __forceinline__ float activate(int act, float u) {
  switch (act) {
    case ACT_RELU: return fmaxf(u, 0.0f);
    case ACT_SWISH: return u / (1.0f + expf(-u));
    case ACT_GELU: return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
    case ACT_TANH: return tanhf(u);
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

// In place softmax over each of `rows` rows of length n (leading dim ld),
// one warp per row, then rounded to T (the probabilities enter P @ V in T).
template <typename T>
__device__ void softmax_rows(float* S, int ld, int rows, int n) {
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
    for (int j = lane; j < n; j += 32) row[j] = rnd<T>(row[j] / s);
  }
}

}  // namespace unirec
