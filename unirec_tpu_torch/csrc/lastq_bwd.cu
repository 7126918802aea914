// lastq_bwd: backward of lastq_fwd (the final layer for one query row).
//
// Replaces the TPU kernel unirec_tpu/ops/layer.py::_lastq_bwd_kernel
// (launched by _fused_lastq_bwd, the custom_vjp of fused_last_query_layer).
// It recomputes the layer from x (K/V for every row, q for row qi only),
// regenerates the forward's dropout masks from the seed, and emits dx
// [B, Lp, D] and every weight and bias gradient. Row qi of dx also takes
// the q-projection and residual gradients, summed in the Pallas kernel's
// order: (dk Wk^T + dv Wv^T) + (dq Wq^T + dr1).
//
// Weight gradients as in layer_bwd.cu: a persistent grid whose blocks loop
// over examples and accumulate into their own f32 slab, summed outside.
// The per-example working set is small ([Lp, D] x and [Lp, 2D] k|v, then
// dk|dv in place, plus row vectors: 44 KB at Lp=56, D=64, F=128), so
// several blocks share an SM.
//
// Bound on an H100: at the training shapes (B=32768, Lp=56, D=64, F=128)
// it reads x (235 MB bf16) and writes dx of the same size; the K/V
// projections and their gradients are most of its ~2.4 GFLOP, so the
// memory bound dominates. The products run on the CUDA cores in f32.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int lastq_bwd_smem_floats(int Lp, int D, int F, int nh) {
  return Lp * (D + 1) + Lp * (2 * D + 1) + Lp + 2 * nh * Lp + 10 * D + 3 * F + 2;
}

// floats of one block's slab: the 16 leaves in the flat-weight order
// (wq, bq, wk, bk, wv, bv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2)
__host__ __device__ inline int lastq_slab_floats(int D, int F) {
  return 4 * (D * D + D) + 2 * D + D * F + F + F * D + D + 2 * D;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lastq_bwd_kernel(const T* __restrict__ x, const float* __restrict__ madd,
                 const T* __restrict__ wq, const T* __restrict__ bq,
                 const T* __restrict__ wk, const T* __restrict__ bk,
                 const T* __restrict__ wv, const T* __restrict__ bv,
                 const T* __restrict__ wo, const T* __restrict__ bo,
                 const float* __restrict__ g1, const float* __restrict__ c1,
                 const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2,
                 const float* __restrict__ g2, const float* __restrict__ c2,
                 const T* __restrict__ wqT, const T* __restrict__ wkT,
                 const T* __restrict__ wvT, const T* __restrict__ woT,
                 const T* __restrict__ w1T, const T* __restrict__ w2T,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ slabs, int B, int Lp, int D, int F,
                 int nh, int qi, int act, float eps, Drop dr) {
  extern __shared__ float smem[];
  const int hd = D / nh;
  const int ldx = D + 1, ldkv = 2 * D + 1;
  float* X = smem;               // [Lp, D]
  float* KV = X + Lp * ldx;      // [Lp, 2D]  k | v, then dk | dv
  float* M = KV + Lp * ldkv;     // [Lp]
  float* P = M + Lp;             // [nh, Lp]  pre-dropout probs, sign = dropped
  float* DS = P + nh * Lp;       // [nh, Lp]  dp, then ds
  float* q = DS + nh * Lp;       // [D]
  float* ctx = q + D;            // [D]
  float* xq = ctx + D;           // [D]  x[qi]
  float* x1 = xq + D;            // [D]  LN1 output (T)
  float* xh1 = x1 + D;           // [D]  xhat1
  float* xh2 = xh1 + D;          // [D]  xhat2, then dctx
  float* r = xh2 + D;            // [D]  dy -> dr2 -> dx1 -> dr1
  float* dh = r + D;             // [D]  dh2, then do
  float* dq = dh + D;            // [D]
  float* dxq = dq + D;           // [D]  dq Wq^T + dr1 (row qi)
  float* u = dxq + D;            // [F]  u (T)
  float* hm = u + F;             // [F]  act(u) (T)
  float* du = hm + F;            // [F]
  float* rs = du + F;            // [2]

  const int DD = D * D;
  const int o_bq = DD, o_wk = o_bq + D, o_bk = o_wk + DD, o_wv = o_bk + D;
  const int o_bv = o_wv + DD, o_wo = o_bv + D, o_bo = o_wo + DD;
  const int o_g1 = o_bo + D, o_c1 = o_g1 + D, o_w1 = o_c1 + D, o_b1 = o_w1 + D * F;
  const int o_w2 = o_b1 + F, o_b2 = o_w2 + F * D, o_g2 = o_b2 + D, o_c2 = o_g2 + D;
  float* slab = slabs + (size_t)blockIdx.x * lastq_slab_floats(D, F);
  for (int i = threadIdx.x; i < lastq_slab_floats(D, F); i += blockDim.x) slab[i] = 0.0f;

  const float scale = (float)(1.0 / sqrt((double)hd));
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t base = (size_t)b * Lp * D;
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x)
      X[(i / D) * ldx + i % D] = to_f<T>(x[base + i]);
    for (int j = threadIdx.x; j < Lp; j += blockDim.x) M[j] = madd[(size_t)b * Lp + j];
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) xq[c] = X[qi * ldx + c];

    // ---- recompute the forward
    mm_rows<T, 4>(X, ldx, Lp, D, wk, D, 1, D, [&](int rr, int c, float a) {
      KV[rr * ldkv + c] = rnd<T>(rnd<T>(a) + to_f<T>(bk[c]));
    });
    mm_rows<T, 4>(X, ldx, Lp, D, wv, D, 1, D, [&](int rr, int c, float a) {
      KV[rr * ldkv + D + c] = rnd<T>(rnd<T>(a) + to_f<T>(bv[c]));
    });
    mm_rows<T, 1>(X + qi * ldx, ldx, 1, D, wq, D, 1, D, [&](int, int c, float a) {
      q[c] = rnd<T>(rnd<T>(a) + to_f<T>(bq[c]));
    });
    __syncthreads();
    for (int w = threadIdx.x; w < nh * Lp; w += blockDim.x) {
      const int h = w / Lp, j = w % Lp;
      float acc = 0.0f;
      for (int d = 0; d < hd; ++d) acc = fmaf(q[h * hd + d], KV[j * ldkv + h * hd + d], acc);
      P[w] = acc * scale + M[j];
    }
    __syncthreads();
    softmax_rows(P, Lp, nh, Lp);
    __syncthreads();
    for (int w = threadIdx.x; w < nh * Lp; w += blockDim.x)
      if (!kept(dr.seed, dr.t_attn, w / Lp, b, w % Lp)) P[w] = -P[w];
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      const int h = c / hd;
      float acc = 0.0f;
      for (int j = 0; j < Lp; ++j) {
        const float pv = P[h * Lp + j];
        const float pz = signbit(pv) ? 0.0f : rnd<T>(pv * dr.inv_attn);
        acc = fmaf(pz, KV[j * ldkv + D + c], acc);
      }
      ctx[c] = rnd<T>(acc);
    }
    __syncthreads();
    mm_rows<T, 1>(ctx, D, 1, D, wo, D, 1, D, [&](int, int c, float a) {
      const float o = rnd<T>(rnd<T>(a) + to_f<T>(bo[c]));
      xh1[c] = rnd<T>(drop_hidden<T>(o, dr, nh, b, c) + xq[c]);
    });
    __syncthreads();
    ln_stats_rows(xh1, D, 1, D, rs, eps);
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) x1[c] = rnd<T>(xh1[c] * g1[c] + c1[c]);
    __syncthreads();
    mm_rows<T, 1>(x1, D, 1, D, w1, F, 1, F, [&](int, int c, float a) {
      u[c] = rnd<T>(rnd<T>(a) + to_f<T>(b1[c]));
      hm[c] = rnd<T>(activate(act, u[c]));
    });
    __syncthreads();
    mm_rows<T, 1>(hm, F, 1, F, w2, D, 1, D, [&](int, int c, float a) {
      const float h2 = rnd<T>(rnd<T>(a) + to_f<T>(b2[c]));
      xh2[c] = rnd<T>(drop_hidden<T>(h2, dr, nh + 1, b, c) + x1[c]);
    });
    __syncthreads();
    ln_stats_rows(xh2, D, 1, D, rs + 1, eps);
    for (int c = threadIdx.x; c < D; c += blockDim.x) r[c] = to_f<T>(dy[(size_t)b * D + c]);
    __syncthreads();

    // ---- LN2, FFN
    colsum([&](int, int n) { return r[n] * xh2[n]; }, D, 1, slab + o_g2);
    colsum([&](int, int n) { return r[n]; }, D, 1, slab + o_c2);
    __syncthreads();
    ln_bwd_rows(r, D, xh2, D, rs + 1, 1, D, g2);
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x)
      dh[c] = rnd<T>(kept(dr.seed, dr.t_hidden, nh + 1, b, c) ? r[c] * dr.inv_hidden : 0.0f);
    __syncthreads();
    wgrad([&](int, int k) { return hm[k]; }, F, dh, 0, D, 1, slab + o_w2);
    colsum([&](int, int n) { return dh[n]; }, D, 1, slab + o_b2);
    mm_rows<T, 1>(dh, D, 1, D, w2T, F, 1, F, [&](int, int c, float a) {
      du[c] = rnd<T>(a * activate_grad(act, u[c]));
    });
    __syncthreads();
    wgrad([&](int, int k) { return x1[k]; }, D, du, 0, F, 1, slab + o_w1);
    colsum([&](int, int n) { return du[n]; }, F, 1, slab + o_b1);
    mm_rows<T, 1>(du, F, 1, F, w1T, D, 1, D, [&](int, int c, float a) { r[c] += a; });
    __syncthreads();

    // ---- LN1, attention output
    colsum([&](int, int n) { return r[n] * xh1[n]; }, D, 1, slab + o_g1);
    colsum([&](int, int n) { return r[n]; }, D, 1, slab + o_c1);
    __syncthreads();
    ln_bwd_rows(r, D, xh1, D, rs, 1, D, g1);
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x)
      dh[c] = rnd<T>(kept(dr.seed, dr.t_hidden, nh, b, c) ? r[c] * dr.inv_hidden : 0.0f);
    __syncthreads();
    wgrad([&](int, int k) { return ctx[k]; }, D, dh, 0, D, 1, slab + o_wo);
    colsum([&](int, int n) { return dh[n]; }, D, 1, slab + o_bo);
    float* dctx = xh2;
    mm_rows<T, 1>(dh, D, 1, D, woT, D, 1, D, [&](int, int c, float a) { dctx[c] = rnd<T>(a); });
    __syncthreads();

    // ---- attention (all heads at once: they own disjoint columns)
    for (int w = threadIdx.x; w < nh * Lp; w += blockDim.x) {
      const int h = w / Lp, j = w % Lp;
      float acc = 0.0f;
      for (int d = 0; d < hd; ++d)
        acc = fmaf(dctx[h * hd + d], KV[j * ldkv + D + h * hd + d], acc);
      DS[w] = signbit(P[w]) ? 0.0f : acc * dr.inv_attn;
    }
    __syncthreads();
    {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int h = warp; h < nh; h += blockDim.x / 32) {
        float t = 0.0f;
        for (int j = lane; j < Lp; j += 32) t += DS[h * Lp + j] * fabsf(P[h * Lp + j]);
        t = warp_sum(t);
        for (int j = lane; j < Lp; j += 32) {
          const float p = fabsf(P[h * Lp + j]);
          DS[h * Lp + j] = rnd<T>(p * (DS[h * Lp + j] - t) * scale);
        }
      }
    }
    for (int w = threadIdx.x; w < Lp * D; w += blockDim.x) {
      const int j = w / D, c = w % D;
      const float pv = P[(c / hd) * Lp + j];
      const float pz = signbit(pv) ? 0.0f : rnd<T>(pv * dr.inv_attn);
      KV[j * ldkv + D + c] = rnd<T>(pz * dctx[c]);  // dv
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      const int h = c / hd;
      float acc = 0.0f;
      for (int j = 0; j < Lp; ++j) acc = fmaf(DS[h * Lp + j], KV[j * ldkv + c], acc);
      dq[c] = rnd<T>(acc);
    }
    __syncthreads();
    for (int w = threadIdx.x; w < Lp * D; w += blockDim.x) {
      const int j = w / D, c = w % D;
      KV[j * ldkv + c] = rnd<T>(DS[(c / hd) * Lp + j] * q[c]);  // dk
    }
    mm_rows<T, 1>(dq, D, 1, D, wqT, D, 1, D, [&](int, int c, float a) { dxq[c] = a + r[c]; });
    __syncthreads();

    // ---- projections and dx
    wgrad([&](int, int k) { return xq[k]; }, D, dq, 0, D, 1, slab);
    colsum([&](int, int n) { return dq[n]; }, D, 1, slab + o_bq);
    wgrad([&](int rr, int k) { return X[rr * ldx + k]; }, D, KV, ldkv, D, Lp, slab + o_wk);
    colsum([&](int rr, int n) { return KV[rr * ldkv + n]; }, D, Lp, slab + o_bk);
    wgrad([&](int rr, int k) { return X[rr * ldx + k]; }, D, KV + D, ldkv, D, Lp, slab + o_wv);
    colsum([&](int rr, int n) { return KV[rr * ldkv + D + n]; }, D, Lp, slab + o_bv);
    for (int w = threadIdx.x; w < Lp * D; w += blockDim.x) {
      const int j = w / D, c = w % D;
      float ak = 0.0f, av = 0.0f;
      for (int e = 0; e < D; ++e) {
        ak = fmaf(KV[j * ldkv + e], to_f<T>(wkT[(size_t)e * D + c]), ak);
        av = fmaf(KV[j * ldkv + D + e], to_f<T>(wvT[(size_t)e * D + c]), av);
      }
      float v = ak + av;
      if (j == qi) v += dxq[c];
      dx[base + w] = from_f<T>(v);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const float* madd, const void* const* w,
           const float* const* ln, const void* dy, void* dx, float* slabs,
           int nblocks, int B, int Lp, int D, int F, int nh, int qi, int act,
           float eps, Drop dr, cudaStream_t stream) {
  const size_t smem = sizeof(float) * lastq_bwd_smem_floats(Lp, D, F, nh);
  cudaError_t err = cudaFuncSetAttribute(
      lastq_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lastq_bwd_kernel<T><<<nblocks, kThreads, smem, stream>>>(
      (const T*)x, madd, (const T*)w[0], (const T*)w[1], (const T*)w[2],
      (const T*)w[3], (const T*)w[4], (const T*)w[5], (const T*)w[6],
      (const T*)w[7], ln[0], ln[1], (const T*)w[8], (const T*)w[9],
      (const T*)w[10], (const T*)w[11], ln[2], ln[3], (const T*)w[12],
      (const T*)w[13], (const T*)w[14], (const T*)w[15], (const T*)w[16],
      (const T*)w[17], (const T*)dy, (T*)dx,
      slabs, B, Lp, D, F, nh, qi, act, eps, dr);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks(int B, int Lp, int D, int F, int nh) {
  const size_t smem = sizeof(float) * lastq_bwd_smem_floats(Lp, D, F, nh);
  cudaError_t err = cudaFuncSetAttribute(
      lastq_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lastq_bwd_kernel<T>, kThreads, smem)) != cudaSuccess)
    return -(int)err;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  return n < B ? n : B;
}

}  // namespace

extern "C" {

int unirec_lastq_bwd_smem_bytes(int Lp, int D, int F, int nh) {
  return (int)sizeof(float) * lastq_bwd_smem_floats(Lp, D, F, nh);
}

int unirec_lastq_bwd_slab_floats(int D, int F) { return lastq_slab_floats(D, F); }

int unirec_lastq_bwd_blocks(int dtype, int B, int Lp, int D, int F, int nh) {
  if (dtype == 0) return blocks<float>(B, Lp, D, F, nh);
  if (dtype == 1) return blocks<__nv_bfloat16>(B, Lp, D, F, nh);
  return -(int)cudaErrorInvalidValue;
}

// Arguments as unirec_layer_bwd, with the 16 flat weights of lastq_fwd,
// the transposes of its six matmul weights, dy [B, D] and the query row qi.
// Returns a cudaError_t.
int unirec_lastq_bwd(int dtype, const void* x, const float* madd,
                     const void* wq, const void* bq, const void* wk,
                     const void* bk, const void* wv, const void* bv,
                     const void* wo, const void* bo, const float* g1,
                     const float* c1, const void* w1, const void* b1,
                     const void* w2, const void* b2, const float* g2,
                     const float* c2, const void* wqT, const void* wkT,
                     const void* wvT, const void* woT, const void* w1T,
                     const void* w2T, const void* dy, void* dx, float* slabs,
                     int nblocks, int B, int Lp, int D, int F, int nh, int qi,
                     int act, float eps, unsigned seed, unsigned t_attn,
                     unsigned t_hidden, float inv_attn, float inv_hidden,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr{seed, t_attn, t_hidden, inv_attn, inv_hidden};
  const void* w[18] = {wq, bq, wk, bk, wv, bv, wo, bo, w1, b1, w2, b2,
                       wqT, wkT, wvT, woT, w1T, w2T};
  const float* ln[4] = {g1, c1, g2, c2};
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp, D, F,
                         nh, qi, act, eps, dr, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp,
                                 D, F, nh, qi, act, eps, dr, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
