// lastq_fwd: the final post-LN transformer layer for one query row, with
// dropout in train mode.
//
// Replaces the TPU kernel unirec_tpu/ops/layer.py::_lastq_fwd_kernel
// (launched by _fused_lastq_fwd_impl, public entry fused_last_query_layer):
// K and V for every row, q for row qi only (the last REAL row of a
// left-padded window, not Lp-1), one-row attention per head over the
// additive key-pad row madd (-1e30 on fake Lp-padding keys), out-proj,
// +x[qi], LN1, FFN on that row, LN2. Output [B, D]. Dropout sites as in
// layer_fwd.cu (head h, nh, nh+1), element j for the one probability row
// and c for the hidden row.
//
// Bound on an H100: at the serving shapes (B=256, Lp=56, D=64, F=128) it
// reads 1.8 MB of bf16 activations, writes 32 KB and does 0.24 GFLOP; the
// memory bound (~0.6 us) dominates. Design: one block per example; the
// [Lp, 2D] keys and values and every per-row vector stay in shared memory,
// so device memory sees x once and y once. The products run on the CUDA
// cores in f32; the K/V projection is most of the work.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int lastq_smem_floats(int Lp, int D, int F, int nh) {
  return Lp * (D + 1) + Lp * (2 * D + 1) + Lp + nh * Lp + 5 * D + F;
}

// kDrop false: the eval instance (both thresholds 0), which leaves the
// Philox code out; ptxas then schedules it as the kernel without dropout.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
lastq_fwd_kernel(const T* __restrict__ x, const float* __restrict__ madd,
                 const T* __restrict__ wq, const T* __restrict__ bq,
                 const T* __restrict__ wk, const T* __restrict__ bk,
                 const T* __restrict__ wv, const T* __restrict__ bv,
                 const T* __restrict__ wo, const T* __restrict__ bo,
                 const float* __restrict__ g1, const float* __restrict__ c1,
                 const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2,
                 const float* __restrict__ g2, const float* __restrict__ c2,
                 T* __restrict__ y, int Lp, int D, int F, int nh, int qi,
                 int act, float eps, Drop dr) {
  extern __shared__ float smem[];
  const int hd = D / nh;
  const int ldx = D + 1, ldkv = 2 * D + 1;
  float* X = smem;               // [Lp, D]
  float* KV = X + Lp * ldx;      // [Lp, 2D]  k | v
  float* M = KV + Lp * ldkv;     // [Lp]
  float* P = M + Lp;             // [nh, Lp]  scores / probs per head
  float* q = P + nh * Lp;        // [D]
  float* ctx = q + D;            // [D]
  float* x1 = ctx + D;           // [D]  out-proj -> residual -> LN1
  float* h2 = x1 + D;            // [D]  dense2 -> residual -> LN2
  float* xq = h2 + D;            // [D]  x[qi]
  float* u = xq + D;             // [F]
  const int b = blockIdx.x;
  const size_t base = (size_t)b * Lp * D;

  for (int i = threadIdx.x; i < Lp * D; i += blockDim.x)
    X[(i / D) * ldx + i % D] = to_f<T>(x[base + i]);
  for (int j = threadIdx.x; j < Lp; j += blockDim.x)
    M[j] = madd[(size_t)blockIdx.x * Lp + j];
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) xq[c] = X[qi * ldx + c];

  dense_rows<T, 4>(X, ldx, Lp, D, wk, D, bk, KV, ldkv);
  dense_rows<T, 4>(X, ldx, Lp, D, wv, D, bv, KV + D, ldkv);
  dense_rows<T, 1>(X + qi * ldx, ldx, 1, D, wq, D, bq, q, D);
  __syncthreads();

  const float scale = (float)(1.0 / sqrt((double)hd));  // as ops/layer.py:602
  for (int w = threadIdx.x; w < nh * Lp; w += blockDim.x) {
    const int h = w / Lp, j = w % Lp;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d)
      acc = fmaf(q[h * hd + d], KV[j * ldkv + h * hd + d], acc);
    P[h * Lp + j] = acc * scale + M[j];
  }
  __syncthreads();
  softmax_rows(P, Lp, nh, Lp);
  __syncthreads();
  for (int w = threadIdx.x; w < nh * Lp; w += blockDim.x) {
    const float p = P[w];
    P[w] = rnd<T>(!kDrop || kept(dr.seed, dr.t_attn, w / Lp, b, w % Lp)
                      ? p * dr.inv_attn : 0.0f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const int h = c / hd;
    float acc = 0.0f;
    for (int j = 0; j < Lp; ++j) acc = fmaf(P[h * Lp + j], KV[j * ldkv + D + c], acc);
    ctx[c] = rnd<T>(acc);
  }
  __syncthreads();

  dense_rows<T, 1>(ctx, D, 1, D, wo, D, bo, x1, D);
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x)
    x1[c] = rnd<T>((kDrop ? drop_hidden<T>(x1[c], dr, nh, b, c)
                          : rnd<T>(x1[c] * dr.inv_hidden)) + xq[c]);
  __syncthreads();
  layer_norm_rows<T>(x1, D, 1, D, g1, c1, eps);
  __syncthreads();
  dense_rows<T, 1>(x1, D, 1, D, w1, F, b1, u, F);
  __syncthreads();
  for (int c = threadIdx.x; c < F; c += blockDim.x) u[c] = rnd<T>(activate(act, u[c]));
  __syncthreads();
  dense_rows<T, 1>(u, F, 1, F, w2, D, b2, h2, D);
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x)
    h2[c] = rnd<T>((kDrop ? drop_hidden<T>(h2[c], dr, nh + 1, b, c)
                          : rnd<T>(h2[c] * dr.inv_hidden)) + x1[c]);
  __syncthreads();
  layer_norm_rows<T>(h2, D, 1, D, g2, c2, eps);
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x)
    y[(size_t)blockIdx.x * D + c] = from_f<T>(h2[c]);
}

template <typename T>
int launch(const void* x, const float* madd, const void* wq, const void* bq,
           const void* wk, const void* bk, const void* wv, const void* bv,
           const void* wo, const void* bo, const float* g1, const float* c1,
           const void* w1, const void* b1, const void* w2, const void* b2,
           const float* g2, const float* c2, void* y, int B, int Lp, int D,
           int F, int nh, int qi, int act, float eps, Drop dr,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * lastq_smem_floats(Lp, D, F, nh);
  const bool drop = dr.t_attn != 0u || dr.t_hidden != 0u;
  auto kernel = drop ? lastq_fwd_kernel<T, true> : lastq_fwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, stream>>>(
      (const T*)x, madd, (const T*)wq, (const T*)bq, (const T*)wk,
      (const T*)bk, (const T*)wv, (const T*)bv, (const T*)wo, (const T*)bo,
      g1, c1, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, g2, c2,
      (T*)y, Lp, D, F, nh, qi, act, eps, dr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int unirec_lastq_fwd_smem_bytes(int Lp, int D, int F, int nh) {
  return (int)sizeof(float) * lastq_smem_floats(Lp, D, F, nh);
}

// dtype: 0 = float32, 1 = bfloat16 (x, y, weights and biases); madd and
// the LayerNorm parameters are float32. Dropout arguments as in
// unirec_layer_fwd. Returns a cudaError_t.
int unirec_lastq_fwd(int dtype, const void* x, const float* madd,
                     const void* wq, const void* bq, const void* wk,
                     const void* bk, const void* wv, const void* bv,
                     const void* wo, const void* bo, const float* g1,
                     const float* c1, const void* w1, const void* b1,
                     const void* w2, const void* b2, const float* g2,
                     const float* c2, void* y, int B, int Lp, int D, int F,
                     int nh, int qi, int act, float eps, unsigned seed,
                     unsigned t_attn, unsigned t_hidden, float inv_attn,
                     float inv_hidden, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr{seed, t_attn, t_hidden, inv_attn, inv_hidden};
  if (dtype == 0)
    return launch<float>(x, madd, wq, bq, wk, bk, wv, bv, wo, bo, g1, c1, w1,
                         b1, w2, b2, g2, c2, y, B, Lp, D, F, nh, qi, act, eps,
                         dr, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, madd, wq, bq, wk, bk, wv, bv, wo, bo, g1,
                                 c1, w1, b1, w2, b2, g2, c2, y, B, Lp, D, F,
                                 nh, qi, act, eps, dr, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
