// layer_fwd: one whole post-LN transformer layer, with dropout in train mode.
//
// Replaces the TPU kernel unirec_tpu/ops/layer.py::_layer_fwd_kernel
// (launched by _fused_layer_fwd_impl, public entry fused_transformer_layer):
//   qkv = x Wqkv + b -> per head: softmax(q k^T / sqrt(hd) + mask) v
//   -> out-proj -> +x -> LN1 -> dense1 -> act -> dense2 -> +x1 -> LN2
// with dropout on the attention probabilities (site h = head), the
// attention output (site nh) and the FFN output (site nh+1), as
// ops/layer.py:304,335,349,387 number them; masks from common.cuh's
// Philox keyed by (seed, site, example, element), element i*Lp+j for
// probabilities and i*D+c for hidden values.
// The mask is rebuilt as the TPU kernel builds it (ops/layer.py:204-216):
// the additive key-pad row madd, elementwise MIN with the causal -1e4
// triangle (so a row whose keys are all masked stays uniform, never -2e4),
// with fake Lp-padding keys carrying a hard -1e30 in madd.
//
// Bound on an H100: at the serving shapes (B=256, Lp=56, D=64, F=128) the
// layer reads 1.8 MB and writes 1.8 MB in bf16 and does 1.2 GFLOP, so both
// the memory and the tensor-core bound are about a microsecond. Design: one
// block per example keeps every intermediate ([Lp, 3D] qkv, one head's
// [Lp, Lp] scores, [Lp, F] FFN activation) in shared memory, so device
// memory sees x once and y once; weights are read through L1/L2, which all
// blocks share. The products run on the CUDA cores in f32 (no tensor
// cores yet), which makes this kernel compute-bound far above its bound:
// a later PR moves the matmuls to wgmma.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 256;
constexpr float kMaskValue = -1e4f;  // reference additive mask (sasrec.py:56)

// shared-memory floats one example needs; the host wrapper checks the total
__host__ __device__ inline int layer_smem_floats(int Lp, int D, int F) {
  const int ldx = D + 1, ldq = 3 * D + 1, ldu = F + 1;
  const int big = ldq > ldu ? ldq : ldu;
  return Lp * ldx * 3 + Lp * big + Lp * (Lp + 1) + Lp;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_fwd_kernel(const T* __restrict__ x, const float* __restrict__ madd,
                 const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                 const T* __restrict__ wo, const T* __restrict__ bo,
                 const float* __restrict__ g1, const float* __restrict__ c1,
                 const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2,
                 const float* __restrict__ g2, const float* __restrict__ c2,
                 T* __restrict__ y, int Lp, int D, int F, int nh, int act,
                 int causal, float eps, Drop dr) {
  extern __shared__ float smem[];
  const int hd = D / nh;
  const int ldx = D + 1, ldq = 3 * D + 1, ldu = F + 1, lds = Lp + 1;
  const int big = ldq > ldu ? ldq : ldu;
  float* X = smem;               // [Lp, D]   layer input (residual 1)
  float* QKV = X + Lp * ldx;     // [Lp, 3D]  q|k|v, later the FFN's [Lp, F]
  float* S = QKV + Lp * big;     // [Lp, Lp]  one head's scores / probs
  float* CTX = S + Lp * lds;     // [Lp, D]   attention output, later dense2
  float* X1 = CTX + Lp * ldx;    // [Lp, D]   out-proj -> residual -> LN1
  float* M = X1 + Lp * ldx;      // [Lp]      key-pad row
  const int b = blockIdx.x;
  const size_t base = (size_t)b * Lp * D;

  for (int i = threadIdx.x; i < Lp * D; i += blockDim.x)
    X[(i / D) * ldx + i % D] = to_f<T>(x[base + i]);
  for (int j = threadIdx.x; j < Lp; j += blockDim.x)
    M[j] = madd[(size_t)blockIdx.x * Lp + j];
  __syncthreads();

  dense_rows<T, 4>(X, ldx, Lp, D, wqkv, 3 * D, bqkv, QKV, ldq);
  __syncthreads();

  const float scale = (float)(1.0 / sqrt((double)hd));  // as ops/layer.py:203
  for (int h = 0; h < nh; ++h) {
    const float* Q = QKV + h * hd;
    const float* K = QKV + D + h * hd;
    const float* V = QKV + 2 * D + h * hd;
    for (int w = threadIdx.x; w < Lp * Lp; w += blockDim.x) {
      const int i = w / Lp, j = w % Lp;
      float acc = 0.0f;
      for (int d = 0; d < hd; ++d) acc = fmaf(Q[i * ldq + d], K[j * ldq + d], acc);
      float m = M[j];
      if (causal) m = fminf(m, j > i ? kMaskValue : 0.0f);
      S[i * lds + j] = acc * scale + m;
    }
    __syncthreads();
    softmax_rows(S, lds, Lp, Lp);
    __syncthreads();
    for (int w = threadIdx.x; w < Lp * Lp; w += blockDim.x) {
      const int i = w / Lp, j = w % Lp;
      const float p = S[i * lds + j];
      S[i * lds + j] = rnd<T>(kept(dr.seed, dr.t_attn, h, b, w) ? p * dr.inv_attn : 0.0f);
    }
    __syncthreads();
    for (int w = threadIdx.x; w < Lp * hd; w += blockDim.x) {
      const int i = w / hd, d = w % hd;
      float acc = 0.0f;
      for (int j = 0; j < Lp; ++j) acc = fmaf(S[i * lds + j], V[j * ldq + d], acc);
      CTX[i * ldx + h * hd + d] = rnd<T>(acc);
    }
    __syncthreads();
  }

  dense_rows<T, 4>(CTX, ldx, Lp, D, wo, D, bo, X1, ldx);
  __syncthreads();
  for (int i = threadIdx.x; i < Lp * D; i += blockDim.x) {
    const int o = (i / D) * ldx + i % D;
    X1[o] = rnd<T>(drop_hidden<T>(X1[o], dr, nh, b, i) + X[o]);
  }
  __syncthreads();
  layer_norm_rows<T>(X1, ldx, Lp, D, g1, c1, eps);
  __syncthreads();

  float* U = QKV;  // q|k|v are dead now
  dense_rows<T, 4>(X1, ldx, Lp, D, w1, F, b1, U, ldu);
  __syncthreads();
  for (int i = threadIdx.x; i < Lp * F; i += blockDim.x) {
    const int o = (i / F) * ldu + i % F;
    U[o] = rnd<T>(activate(act, U[o]));
  }
  __syncthreads();
  float* H2 = CTX;
  dense_rows<T, 4>(U, ldu, Lp, F, w2, D, b2, H2, ldx);
  __syncthreads();
  for (int i = threadIdx.x; i < Lp * D; i += blockDim.x) {
    const int o = (i / D) * ldx + i % D;
    H2[o] = rnd<T>(drop_hidden<T>(H2[o], dr, nh + 1, b, i) + X1[o]);
  }
  __syncthreads();
  layer_norm_rows<T>(H2, ldx, Lp, D, g2, c2, eps);
  __syncthreads();
  for (int i = threadIdx.x; i < Lp * D; i += blockDim.x)
    y[base + i] = from_f<T>(H2[(i / D) * ldx + i % D]);
}

template <typename T>
int launch(const void* x, const float* madd, const void* wqkv, const void* bqkv,
           const void* wo, const void* bo, const float* g1, const float* c1,
           const void* w1, const void* b1, const void* w2, const void* b2,
           const float* g2, const float* c2, void* y, int B, int Lp, int D,
           int F, int nh, int act, int causal, float eps, Drop dr,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * layer_smem_floats(Lp, D, F);
  cudaError_t err = cudaFuncSetAttribute(
      layer_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  layer_fwd_kernel<T><<<B, kThreads, smem, stream>>>(
      (const T*)x, madd, (const T*)wqkv, (const T*)bqkv, (const T*)wo,
      (const T*)bo, g1, c1, (const T*)w1, (const T*)b1, (const T*)w2,
      (const T*)b2, g2, c2, (T*)y, Lp, D, F, nh, act, causal, eps, dr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one block needs (the wrapper's gate)
int unirec_layer_fwd_smem_bytes(int Lp, int D, int F) {
  return (int)sizeof(float) * layer_smem_floats(Lp, D, F);
}

// dtype: 0 = float32, 1 = bfloat16 (x, y, weights and biases); madd and
// the LayerNorm parameters are float32. Dropout: seed, the keep thresholds
// round(p * 2^32) of the attention and hidden sites (0: no dropout) and
// their 1/(1-p). Returns a cudaError_t.
int unirec_layer_fwd(int dtype, const void* x, const float* madd,
                     const void* wqkv, const void* bqkv, const void* wo,
                     const void* bo, const float* g1, const float* c1,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, const float* g2, const float* c2, void* y,
                     int B, int Lp, int D, int F, int nh, int act, int causal,
                     float eps, unsigned seed, unsigned t_attn,
                     unsigned t_hidden, float inv_attn, float inv_hidden,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr{seed, t_attn, t_hidden, inv_attn, inv_hidden};
  if (dtype == 0)
    return launch<float>(x, madd, wqkv, bqkv, wo, bo, g1, c1, w1, b1, w2, b2,
                         g2, c2, y, B, Lp, D, F, nh, act, causal, eps, dr, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, madd, wqkv, bqkv, wo, bo, g1, c1, w1, b1,
                                 w2, b2, g2, c2, y, B, Lp, D, F, nh, act,
                                 causal, eps, dr, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
