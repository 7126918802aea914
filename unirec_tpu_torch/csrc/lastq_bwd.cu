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
// over examples and accumulate into their own f32 slab, summed outside; no
// atomics, so the result is deterministic.
//
// Bound on an H100: at the training shapes (B=32768, Lp=56, D=64, F=128)
// it reads x (235 MB bf16) and writes dx of the same size; the K/V
// projections and their gradients are most of its 96 GFLOP (the forward's
// 32 recomputed, two more per product), so the memory bound dominates
// (0.144 ms against 0.097 on the tensor cores).
//
// Two bodies; the rule mma_takes picks one (ops/layer.py::_lastq_bwd_body
// holds a copy, checked against unirec_lastq_bwd_mma_takes).
//
// CUDA-core body (f32, and bf16 at widths the tensor-core body does not
// take; lastq_bwd_kernel): 256-thread blocks, several a SM, with x, k|v
// and the row vectors in f32 shared memory (44 KB at Lp=56, D=64, F=128);
// every product is a scalar fmaf loop reading the weights (and transposed
// copies the wrapper makes) through L1/L2, and the rank-1 weight gradients
// are added per example into the slab: 23.1 ms at B=32,768 on an H100
// (80GB HBM3, 700 W), 160x its bound.
//
// Tensor-core body (bf16; Lp <= 64, D and the head width multiples of 16 up
// to 64, F a multiple of 16 whose buffers fit a block; lastq_bwd_mma_kernel
// below). Per example three [64 x D] x [D x 2D]-sized products are nearly
// all the work: K|V = x [Wk|Wv], dx = dK Wk^T + dV Wv^T and dWk|dWv += x^T
// [dK|dV]; they run as mma.sync m16n8k16 (bf16 operands, f32 sums, the
// Pallas kernel's rounding points) on a persistent grid of 8-warp blocks,
// one a SM, that hold wq, wk|wv, wo, w1 and w2 in bf16 shared memory for
// the block's life (70 KB at D=64, F=128), read through ldmatrix(.trans),
// so no transposed copy is made; x, dy and madd rows arrive by cp.async
// into a two-stage ring while the previous example computes. dK = rnd(ds
// q) and dV = rnd(z dctx) are formed and rounded element by element before
// their products, as in the Pallas kernel. dWk|dWv (2 D^2 f32) stay in the
// warps' registers across all of the block's examples (32 floats a thread
// at D=64) and are stored once. The one query row's chain (q, per-head
// scores and softmax, ctx, out-proj, LN1, FFN, LN2 and their backward down
// to dctx, dq and ds) is about 5% of the work: a warp per head for the
// attention, a thread per output column for the row products on the
// resident weights, one warp for each LayerNorm. Its rank-1 weight
// gradients (dWq, dWo, dW1, dW2) gather as bf16 row vectors of a group of
// 16 examples and are added as one 16-deep MMA product per group into the
// block's own slab (csrc/layer_strip.cuh::flush_wgrad). The bias and
// LayerNorm sums stay in shared memory, each element owned by one thread.
// Lp = 56 pads to 64 rows: rows past Lp load as zero x, their keys get
// probability 0, so their dK, dV and every sum over them are 0.
#include "layer_strip.cuh"

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
      if (!kept(dr.seed, dr.t_attn, w / Lp, dr.b0 + b, w % Lp)) P[w] = -P[w];
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
      dh[c] = rnd<T>(kept(dr.seed, dr.t_hidden, nh + 1, dr.b0 + b, c) ? r[c] * dr.inv_hidden : 0.0f);
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
      dh[c] = rnd<T>(kept(dr.seed, dr.t_hidden, nh, dr.b0 + b, c) ? r[c] * dr.inv_hidden : 0.0f);
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

// ------------------------------------------------ bf16 tensor-core body
// See the note at the top of this file.
constexpr int kGather = 16;  // examples whose rank-1 gradients one MMA adds

// f32: z and ds of every head [nh][64]; the row vectors q, ctx, xhat1, x1,
// xhat2, r, dh2, do, dctx, dq, dxq and the two hidden keep masks (13 of D),
// u, hm, du (3 of F), the two reciprocal deviations; the bias and LayerNorm
// sums (7 D + F); the dbk|dbv partial sums (at most 256)
__host__ __device__ inline int mma_floats(int D, int F, int nh) {
  return 2 * nh * kMmaRows + 13 * D + 3 * F + 2 + 7 * D + F + 256;
}

// bf16: wq [D][D + 8], wk|wv [D][2D + 8], wo [D][D + 8], w1 [D][F + 8], w2
// [F][D + 8]; two stages of x [64][D + 8], the f32 madd row [64] and dy
// [D]; k|v [64][2D + 8]; the gathered rows of 16 examples, x[qi], dq, ctx,
// do, x1, dh2 [16][D + 8] and du, hm [16][F + 8]; then the f32 above
__host__ __device__ inline int mma_smem_bytes(int D, int F, int nh) {
  const int ldd = D + 8, ldkv = 2 * D + 8, ldf = F + 8;
  return 2 * (D * ldd + D * ldkv + D * ldd + D * ldf + F * ldd) +
         2 * (2 * kMmaRows * ldd + 4 * kMmaRows + 2 * D) + 2 * kMmaRows * ldkv +
         2 * kGather * (6 * ldd + 2 * ldf) + 4 * mma_floats(D, F, nh);
}

__host__ __device__ inline bool mma_takes(int dtype, int Lp, int D, int F, int nh) {
  return mma_widths_take(dtype, Lp, D, F, nh) && mma_smem_bytes(D, F, nh) <= kSmemLimit;
}

// out[n] = epi(n, sum_k v[k] W[k][n]) for n < N, a thread a column: v f32
// in shared memory, W bf16 [K][ldw] in shared memory (x W)
template <typename Epi>
__device__ __forceinline__ void row_mm(const float* v, int K, const bf16* W, int ldw, int N,
                                       Epi epi) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < K; k += 4)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = fmaf(v[k + q], bfv(W + (k + q) * ldw + n), a[q]);
    epi(n, (a[0] + a[1]) + (a[2] + a[3]));
  }
}

// out[n] = epi(n, sum_k v[k] W[n][k]) for n < N (x W^T): W's row n read 16
// bytes at a time, so a quarter warp's rows fall in distinct banks
template <typename Epi>
__device__ __forceinline__ void row_mm_t(const float* v, int K, const bf16* W, int ldw, int N,
                                         Epi epi) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float a[2] = {0.0f, 0.0f};
    for (int k = 0; k < K; k += 8) {
      const uint4 w8 = *reinterpret_cast<const uint4*>(W + n * ldw + k);
      const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&w8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(w2[q]);
        a[q & 1] = fmaf(v[k + 2 * q], f.x, a[q & 1]);
        a[q & 1] = fmaf(v[k + 2 * q + 1], f.y, a[q & 1]);
      }
    }
    epi(n, a[0] + a[1]);
  }
}

// slabs: zeroed by the caller; this block adds into its own
template <int D16, int HD16>
__global__ void __launch_bounds__(32 * kMmaWarps, 1)
lastq_bwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ madd,
                     const bf16* __restrict__ wq, const bf16* __restrict__ bq,
                     const bf16* __restrict__ wk, const bf16* __restrict__ bk,
                     const bf16* __restrict__ wv, const bf16* __restrict__ bv,
                     const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                     const float* __restrict__ g1, const float* __restrict__ c1,
                     const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                     const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                     const float* __restrict__ g2, const float* __restrict__ c2,
                     const bf16* __restrict__ dy, bf16* __restrict__ dx,
                     float* __restrict__ slabs, int B, int Lp, int F, int qi, int act,
                     float eps, Drop dr) {
  constexpr int D = D16 * 16, LDD = D + 8, LDKV = 2 * D + 8, D8 = D / 8;
  constexpr int HD = HD16 * 16, NH = D / HD;
  constexpr int DG0 = (D16 + 1) / 2, NTH = 2 * DG0, NT1 = 2 * D16 - NTH;
  // dWk|dWv [D][2D] in registers: warp w owns the 16 rows (w % D16) * 16..
  // and NP 16-column pairs from (w / D16) * NP, over WG groups of warps
  constexpr int WG = kMmaWarps / D16, N16 = 2 * D16, NP = (N16 + WG - 1) / WG;
  constexpr int CPT = 32 * kMmaWarps / (2 * D);  // threads a column of dK|dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDF = F + 8, Mp = (Lp + 15) / 16 * 16;
  bf16* Wq = reinterpret_cast<bf16*>(smem_raw);  // [D][LDD]
  bf16* Wkv = Wq + D * LDD;                      // [D][LDKV]  wk | wv
  bf16* Wo = Wkv + D * LDKV;                     // [D][LDD]
  bf16* W1 = Wo + D * LDD;                       // [D][LDF]
  bf16* W2 = W1 + D * LDF;                       // [F][LDD]
  unsigned char* ring = reinterpret_cast<unsigned char*>(W2 + F * LDD);
  const int stage_bytes = 2 * kMmaRows * LDD + 4 * kMmaRows + 2 * D;
  auto Xs = [&](int st) { return reinterpret_cast<bf16*>(ring + st * stage_bytes); };
  auto Ms = [&](int st) { return reinterpret_cast<float*>(Xs(st) + kMmaRows * LDD); };
  auto DYs = [&](int st) { return reinterpret_cast<bf16*>(Ms(st) + kMmaRows); };
  bf16* KV = reinterpret_cast<bf16*>(ring + 2 * stage_bytes);  // [64][LDKV]
  bf16* XQg = KV + kMmaRows * LDKV;                             // [16][LDD] each
  bf16* DQg = XQg + kGather * LDD;
  bf16* CTg = DQg + kGather * LDD;
  bf16* DOg = CTg + kGather * LDD;
  bf16* X1g = DOg + kGather * LDD;
  bf16* DHg = X1g + kGather * LDD;
  bf16* DUg = DHg + kGather * LDD;                              // [16][LDF] each
  bf16* HMg = DUg + kGather * LDF;
  float* Z = reinterpret_cast<float*>(HMg + kGather * LDF);     // [NH][64]
  float* DS = Z + NH * kMmaRows;                                // [NH][64]
  float* q = DS + NH * kMmaRows;                                // [D] each
  float* ctx = q + D;
  float* xh1 = ctx + D;   // o + x[qi], then xhat1
  float* x1 = xh1 + D;
  float* xh2 = x1 + D;    // h2 + x1, then xhat2
  float* r = xh2 + D;     // dy -> dr2 -> dx1 -> dr1
  float* dh2 = r + D;
  float* dov = dh2 + D;
  float* dctx = dov + D;
  float* dq = dctx + D;
  float* dxq = dq + D;
  float* ko = dxq + D;    // the hidden keep masks of sites nh, nh + 1 (1 / 0)
  float* k2 = ko + D;
  float* u = k2 + D;      // [F] each
  float* hm = u + F;
  float* du = hm + F;
  float* rs = du + F;     // [2]
  float* sums = rs + 2;   // [7D + F] dbq, dbo, dg1, dc1, db1, db2, dg2, dc2
  float* bkv = sums + 7 * D + F;  // [CPT][2D] dbk|dbv partial sums
  float* s_bq = sums;
  float* s_bo = s_bq + D;
  float* s_g1 = s_bo + D;
  float* s_c1 = s_g1 + D;
  float* s_b1 = s_c1 + D;
  float* s_b2 = s_b1 + F;
  float* s_g2 = s_b2 + D;
  float* s_c2 = s_g2 + D;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int strip = warp % kStrips, half = warp / kStrips, i0 = strip * 16;
  const bool active = i0 < Mp;
  const int nd = half ? NT1 : NTH, dc0 = half ? 16 * DG0 : 0;
  const int mt = warp % D16, n16 = (warp / D16) * NP;
  const bool wkv_mine = warp / D16 < WG;
  const int kc_col = tid % (2 * D), kc_row = tid / (2 * D);  // this thread's dK|dV column
  const bool kv_mine = tid < CPT * 2 * D;
  // the slab in the flat-weight order (wq, bq, wk, bk, wv, bv, wo, bo, g1,
  // c1, w1, b1, w2, b2, g2, c2)
  const int DD = D * D;
  const int o_bq = DD, o_wk = o_bq + D, o_bk = o_wk + DD, o_wv = o_bk + D;
  const int o_bv = o_wv + DD, o_wo = o_bv + D, o_bo = o_wo + DD;
  const int o_g1 = o_bo + D, o_c1 = o_g1 + D, o_w1 = o_c1 + D, o_b1 = o_w1 + D * F;
  const int o_w2 = o_b1 + F, o_b2 = o_w2 + F * D, o_g2 = o_b2 + D, o_c2 = o_g2 + D;
  float* slab = slabs + (size_t)blockIdx.x * lastq_slab_floats(D, F);
  const float scale = (float)(1.0 / sqrt((double)HD));

  for (int i = tid; i < 7 * D + F; i += blockDim.x) sums[i] = 0.0f;
  // the gathered rows start (and restart after each flush) at zero, so a
  // partial group adds nothing for its missing examples
  auto zero_gather = [&]() {
    const int nvec = kGather * (6 * LDD + 2 * LDF) / 8;
    for (int i = tid; i < nvec; i += blockDim.x)
      reinterpret_cast<uint4*>(XQg)[i] = make_uint4(0, 0, 0, 0);
  };
  zero_gather();
  // the weights, once
  auto load_w = [&](bf16* dst, int ld, const bf16* src, int rows, int cols) {
    const int ch = cols / 8;
    for (int w = tid; w < rows * ch; w += blockDim.x)
      cp_async16(dst + (w / ch) * ld + (w % ch) * 8, src + (size_t)(w / ch) * cols + (w % ch) * 8,
                 true);
  };
  load_w(Wq, LDD, wq, D, D);
  load_w(Wkv, LDKV, wk, D, D);
  load_w(Wkv + D, LDKV, wv, D, D);
  load_w(Wo, LDD, wo, D, D);
  load_w(W1, LDF, w1, D, F);
  load_w(W2, LDD, w2, F, D);
  // example b's x rows (rows Lp..Mp-1 zero-filled), madd row and dy row
  auto load = [&](int b, int st) {
    const size_t base = (size_t)b * Lp * D;
    for (int w = tid; w < Mp * D8; w += blockDim.x) {
      const int i = w / D8, c = w % D8;
      const bool in = i < Lp;
      cp_async16(Xs(st) + i * LDD + c * 8, x + base + (size_t)(in ? i : 0) * D + c * 8, in);
    }
    for (int w = tid; w < Lp / 4; w += blockDim.x)
      cp_async16(Ms(st) + 4 * w, madd + (size_t)b * Lp + 4 * w, true);
    for (int w = tid; w < D8; w += blockDim.x)
      cp_async16(DYs(st) + 8 * w, dy + (size_t)b * D + 8 * w, true);
  };
  float wacc[2 * NP][4];  // dWk|dWv, this warp's tiles, over every example
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) wacc[n][0] = wacc[n][1] = wacc[n][2] = wacc[n][3] = 0.0f;
  float bkv_acc = 0.0f;   // dbk|dbv column kc_col over this thread's rows
  int b = blockIdx.x, slot = 0;
  if (b < B) load(b, 0);
  cp_async_commit();

  for (int st = 0; b < B; b += gridDim.x, st ^= 1) {
    if (b + (int)gridDim.x < B) load(b + gridDim.x, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this example (and, first, the weights) have landed
    __syncthreads();
    bf16* X = Xs(st);
    const float* M = Ms(st);
    const bf16* DY = DYs(st);

    // ---- k|v = rnd(rnd(x [Wk|Wv]) + [bk|bv]) for every row: half 0 k, half 1
    // v; q = rnd(rnd(x[qi] Wq) + bq) from the MMA of the strip holding qi
    if (active) {
      const bf16* bb = half ? bv : bk;
      for (int c0 = 0; c0 < D; c0 += 64) {
        const int nn = min(8, (D - c0) / 8);
        float acc[8][4];
        strip_mm<8, false>(acc, X, LDD, i0, D16, Wkv, LDKV, half * D + c0, nn, lane);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n >= nn) break;
          const int c = c0 + n * 8 + 2 * t;
          const float bb0 = bfv(bb + c), bb1 = bfv(bb + c + 1);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            put2(KV, LDKV, i0 + g + 8 * rr, half * D + c, rb(rb(acc[n][2 * rr]) + bb0),
                 rb(rb(acc[n][2 * rr + 1]) + bb1));
        }
      }
      if (strip == qi / 16) {
        float acc[NTH][4];
        strip_mm<NTH, false>(acc, X, LDD, i0, D16, Wq, LDD, dc0, nd, lane);
#pragma unroll
        for (int n = 0; n < NTH; ++n)
          if (n < nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = dc0 + n * 8 + 2 * t + (e & 1);
              if (i0 + g + (e >> 1) * 8 == qi) q[c] = rb(rb(acc[n][e]) + bfv(bq + c));
            }
      }
    }
    if (tid < D8)  // x[qi], gathered for dWq
      reinterpret_cast<uint4*>(XQg + slot * LDD)[tid] =
          reinterpret_cast<const uint4*>(X + qi * LDD)[tid];
    __syncthreads();

    // ---- attention of the query row, a warp per head: lanes hold keys j =
    // lane, lane + 32; their probabilities and keep bits stay in registers for
    // the backward
    float p[2] = {0.0f, 0.0f};
    bool kp[2] = {false, false};
    if (warp < NH) {
      const int h = warp;
      float sc[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = lane + 32 * rr;
        sc[rr] = -CUDART_INF_F;
        if (j < Lp) {
          float a = 0.0f;
          for (int d = 0; d < HD; d += 8) {
            const uint4 k8 = *reinterpret_cast<const uint4*>(KV + j * LDKV + h * HD + d);
            const __nv_bfloat162* k2v = reinterpret_cast<const __nv_bfloat162*>(&k8);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(k2v[e]);
              a = fmaf(q[h * HD + d + 2 * e], f.x, a);
              a = fmaf(q[h * HD + d + 2 * e + 1], f.y, a);
            }
          }
          sc[rr] = a * scale + M[j];
        }
      }
      const float mx = warp_max(fmaxf(sc[0], sc[1]));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) p[rr] = sc[rr] == -CUDART_INF_F ? 0.0f : expf(sc[rr] - mx);
      const float sum = warp_sum(p[0] + p[1]);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = lane + 32 * rr;
        p[rr] /= sum;
        kp[rr] = j < Lp && kept(dr.seed, dr.t_attn, h, dr.b0 + b, j);
        Z[h * kMmaRows + j] = kp[rr] ? rb(p[rr] * dr.inv_attn) : 0.0f;
      }
      __syncwarp();
      // ctx = rnd(z V) for the head's columns
      for (int d = lane; d < HD; d += 32) {
        float a = 0.0f;
        for (int j = 0; j < Lp; ++j) a = fmaf(Z[h * kMmaRows + j], bfv(KV + j * LDKV + D + h * HD + d), a);
        ctx[h * HD + d] = rb(a);
        CTg[slot * LDD + h * HD + d] = __float2bfloat16(a);
      }
    }
    __syncthreads();

    // ---- the row's out-proj, dropout (site nh), + x[qi], LN1, FFN, LN2
    row_mm(ctx, D, Wo, LDD, D, [&](int c, float a) {
      float o = rb(rb(a) + bfv(bo + c));
      const bool k = kept(dr.seed, dr.t_hidden, NH, dr.b0 + b, c);
      ko[c] = k ? 1.0f : 0.0f;
      o = k ? rb(o * dr.inv_hidden) : 0.0f;
      xh1[c] = rb(o + bfv(X + qi * LDD + c));
    });
    __syncthreads();
    ln_stats_rows(xh1, D, 1, D, rs, eps);
    __syncthreads();
    for (int c = tid; c < D; c += blockDim.x) {
      x1[c] = rb(xh1[c] * g1[c] + c1[c]);
      X1g[slot * LDD + c] = __float2bfloat16(x1[c]);
    }
    __syncthreads();
    with_act(act, [&](auto tag) {
      constexpr int A = decltype(tag)::value;
      row_mm(x1, D, W1, LDF, F, [&](int f, float a) {
        const float uu = rb(rb(a) + bfv(b1 + f));
        float h, d;
        act_pair<A>(uu, h, d);
        u[f] = uu;
        hm[f] = rb(h);
        HMg[slot * LDF + f] = __float2bfloat16(h);
      });
    });
    __syncthreads();
    row_mm(hm, F, W2, LDD, D, [&](int c, float a) {
      float h2 = rb(rb(a) + bfv(b2 + c));
      const bool k = kept(dr.seed, dr.t_hidden, NH + 1, dr.b0 + b, c);
      k2[c] = k ? 1.0f : 0.0f;
      h2 = k ? rb(h2 * dr.inv_hidden) : 0.0f;
      xh2[c] = rb(h2 + x1[c]);
      r[c] = bfv(DY + c);
    });
    __syncthreads();

    // ---- backward: LN2 (dg2, dc2), dh2 = rnd(dropout(dr2))
    ln_stats_rows(xh2, D, 1, D, rs + 1, eps);
    __syncthreads();
    if (warp == 0) {  // the warp that then runs the LayerNorm backward in place
      for (int c = lane; c < D; c += 32) {
        s_g2[c] += r[c] * xh2[c];
        s_c2[c] += r[c];
      }
      __syncwarp();
    }
    ln_bwd_rows(r, D, xh2, D, rs + 1, 1, D, g2);
    __syncthreads();
    for (int c = tid; c < D; c += blockDim.x) {
      const float h = rb(k2[c] != 0.0f ? r[c] * dr.inv_hidden : 0.0f);
      dh2[c] = h;
      DHg[slot * LDD + c] = __float2bfloat16(h);
      s_b2[c] += h;
    }
    __syncthreads();
    // du = rnd((dh2 W2^T) act'(u))
    with_act(act, [&](auto tag) {
      constexpr int A = decltype(tag)::value;
      row_mm_t(dh2, D, W2, LDD, F, [&](int f, float a) {
        float h, d;
        act_pair<A>(u[f], h, d);
        const float v = rb(a * d);
        du[f] = v;
        DUg[slot * LDF + f] = __float2bfloat16(v);
        s_b1[f] += v;
      });
    });
    __syncthreads();
    // dx1 = dr2 + du W1^T; LN1 (dg1, dc1); do = rnd(dropout(dr1))
    row_mm_t(du, F, W1, LDF, D, [&](int c, float a) {
      const float v = r[c] + a;
      r[c] = v;
      s_g1[c] += v * xh1[c];
      s_c1[c] += v;
    });
    __syncthreads();
    ln_bwd_rows(r, D, xh1, D, rs, 1, D, g1);
    __syncthreads();
    for (int c = tid; c < D; c += blockDim.x) {
      const float h = rb(ko[c] != 0.0f ? r[c] * dr.inv_hidden : 0.0f);
      dov[c] = h;
      DOg[slot * LDD + c] = __float2bfloat16(h);
      s_bo[c] += h;
    }
    __syncthreads();
    row_mm_t(dov, D, Wo, LDD, D, [&](int c, float a) { dctx[c] = rb(a); });
    __syncthreads();

    // ---- attention backward, a warp per head: dp, ds = rnd(p (dp - t)
    // scale), dq = rnd(ds K)
    if (warp < NH) {
      const int h = warp;
      float dp[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = lane + 32 * rr;
        dp[rr] = 0.0f;
        if (kp[rr]) {
          float a = 0.0f;
          for (int d = 0; d < HD; d += 8) {
            const uint4 v8 = *reinterpret_cast<const uint4*>(KV + j * LDKV + D + h * HD + d);
            const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v8);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(v2[e]);
              a = fmaf(dctx[h * HD + d + 2 * e], f.x, a);
              a = fmaf(dctx[h * HD + d + 2 * e + 1], f.y, a);
            }
          }
          dp[rr] = a * dr.inv_attn;
        }
      }
      const float tsum = warp_sum(fmaf(dp[0], p[0], dp[1] * p[1]));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) DS[h * kMmaRows + lane + 32 * rr] = rb(p[rr] * (dp[rr] - tsum) * scale);
      __syncwarp();
      for (int d = lane; d < HD; d += 32) {
        float a = 0.0f;
        for (int j = 0; j < Lp; ++j) a = fmaf(DS[h * kMmaRows + j], bfv(KV + j * LDKV + h * HD + d), a);
        const float v = rb(a);
        dq[h * HD + d] = v;
        DQg[slot * LDD + h * HD + d] = __float2bfloat16(v);
        s_bq[h * HD + d] += v;
      }
    }
    __syncthreads();

    // ---- dK = rnd(ds q), dV = rnd(z dctx) over k|v (rows past Lp: 0), their
    // column sums; dxq = dq Wq^T + dr1 for row qi
    if (kv_mine) {
      const int c = kc_col, hh = (c % D) / HD;
      const float* ph = c < D ? DS + hh * kMmaRows : Z + hh * kMmaRows;
      const float m = c < D ? q[c] : dctx[c - D];
      for (int j = kc_row; j < Mp; j += CPT) {
        const float v = rb(ph[j] * m);
        KV[j * LDKV + c] = __float2bfloat16(v);
        bkv_acc += v;
      }
    }
    row_mm_t(dq, D, Wq, LDD, D, [&](int c, float a) { dxq[c] = a + r[c]; });
    __syncthreads();

    // ---- dWk|dWv += x^T [dK|dV] into this warp's registers
    if (wkv_mine) {
      for (int kc = 0; kc < Mp / 16; ++kc) {
        uint32_t a[4];
        frag_a_t(a, X, LDD, mt * 16, kc * 16, lane);
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          if (n16 + np >= N16) break;
          uint32_t bb[4];
          frag_b_t(bb, KV, LDKV, (n16 + np) * 16, kc * 16, lane);
          mma_bf16(wacc[2 * np], a, bb[0], bb[1]);
          mma_bf16(wacc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    // ---- dx = rnd(dK Wk^T + dV Wv^T (+ dxq on row qi)) through the strip's x rows
    float dxa[NTH][4];
    if (active) strip_mm<NTH, true>(dxa, KV, LDKV, i0, 2 * D16, Wkv, LDKV, dc0, nd, lane);
    __syncthreads();  // x is read no more
    if (active) {
#pragma unroll
      for (int n = 0; n < NTH; ++n) {
        if (n >= nd) break;
        const int c = dc0 + n * 8 + 2 * t;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = i0 + g + 8 * rr;
          const bool at_q = i == qi;
          put2(X, LDD, i, c, dxa[n][2 * rr] + (at_q ? dxq[c] : 0.0f),
               dxa[n][2 * rr + 1] + (at_q ? dxq[c + 1] : 0.0f));
        }
      }
      pair_bar(strip);  // dx rows whole
      const size_t base = (size_t)b * Lp * D;
      for (int w = half * 32 + lane; w < 16 * D8; w += 64) {
        const int i = i0 + w / D8, cc = w % D8;
        if (i < Lp)
          *reinterpret_cast<uint4*>(dx + base + (size_t)i * D + cc * 8) =
              *reinterpret_cast<const uint4*>(X + i * LDD + cc * 8);
      }
    }
    // ---- every kGather examples (and after the block's last): dWq += x[qi]^T
    // dq, dWo += ctx^T do, dW1 += x1^T du, dW2 += hm^T dh2, one 16-deep MMA each
    if (++slot == kGather || b + (int)gridDim.x >= B) {
      __syncthreads();
      flush_wgrad(XQg, LDD, D, DQg, LDD, D, 1, slab, warp, lane);
      flush_wgrad(CTg, LDD, D, DOg, LDD, D, 1, slab + o_wo, warp, lane);
      flush_wgrad(X1g, LDD, D, DUg, LDF, F, 1, slab + o_w1, warp, lane);
      flush_wgrad(HMg, LDF, F, DHg, LDD, D, 1, slab + o_w2, warp, lane);
      __syncthreads();
      zero_gather();
      slot = 0;
    }
    __syncthreads();  // this stage, k|v and the row vectors are consumed
  }
  cp_async_wait<0>();
  // dWk|dWv from the registers; the bias and LayerNorm sums; dbk|dbv
  if (wkv_mine) {
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      if (n16 + np >= N16) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = (n16 + np) * 16 + hh * 8 + 2 * t;
        float* dst = slab + (n < D ? o_wk + n : o_wv + n - D);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<float2*>(dst + (mt * 16 + g + 8 * rr) * D) =
              make_float2(wacc[2 * np + hh][2 * rr], wacc[2 * np + hh][2 * rr + 1]);
      }
    }
  }
  if (kv_mine) bkv[kc_row * 2 * D + kc_col] = bkv_acc;
  __syncthreads();
  for (int c = tid; c < 2 * D; c += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < CPT; ++k) s += bkv[k * 2 * D + c];
    slab[c < D ? o_bk + c : o_bv + c - D] += s;
  }
  const int s_off[8] = {0, D, 2 * D, 3 * D, 4 * D, 4 * D + F, 5 * D + F, 6 * D + F};
  const int o_off[8] = {o_bq, o_bo, o_g1, o_c1, o_b1, o_b2, o_g2, o_c2};
  for (int k = 0; k < 8; ++k) {
    const int len = (k < 7 ? s_off[k + 1] : 7 * D + F) - s_off[k];
    for (int c = tid; c < len; c += blockDim.x) slab[o_off[k] + c] += sums[s_off[k] + c];
  }
}

template <int D16, int HD16>
int launch_mma(const void* x, const float* madd, const void* const* w, const float* const* ln,
               const void* dy, void* dx, float* slabs, int nblocks, int B, int Lp, int F, int qi,
               int act, float eps, Drop dr, cudaStream_t stream) {
  const int smem = mma_smem_bytes(D16 * 16, F, D16 / HD16);
  cudaError_t err = cudaFuncSetAttribute(lastq_bwd_mma_kernel<D16, HD16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lastq_bwd_mma_kernel<D16, HD16><<<nblocks, 32 * kMmaWarps, smem, stream>>>(
      (const bf16*)x, madd, (const bf16*)w[0], (const bf16*)w[1], (const bf16*)w[2],
      (const bf16*)w[3], (const bf16*)w[4], (const bf16*)w[5], (const bf16*)w[6],
      (const bf16*)w[7], ln[0], ln[1], (const bf16*)w[8], (const bf16*)w[9], (const bf16*)w[10],
      (const bf16*)w[11], ln[2], ln[3], (const bf16*)dy, (bf16*)dx, slabs, B, Lp, F, qi, act,
      eps, dr);
  return (int)cudaGetLastError();
}

template <int D16, int HD16>
int blocks_mma(int B, int F) {
  const int smem = mma_smem_bytes(D16 * 16, F, D16 / HD16);
  cudaError_t err = cudaFuncSetAttribute(lastq_bwd_mma_kernel<D16, HD16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lastq_bwd_mma_kernel<D16, HD16>, 32 * kMmaWarps, smem)) != cudaSuccess)
    return -(int)err;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  return n < B ? n : B;
}

int dispatch_launch_mma(int D, int nh, const void* x, const float* madd, const void* const* w,
                        const float* const* ln, const void* dy, void* dx, float* slabs,
                        int nblocks, int B, int Lp, int F, int qi, int act, float eps, Drop dr,
                        cudaStream_t s) {
  const int d16 = D / 16, h16 = D / nh / 16;
#define UNIREC_CASE(a, h)                                                                     \
  if (d16 == a && h16 == h)                                                                   \
    return launch_mma<a, h>(x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp, F, qi, act, eps, \
                            dr, s);
  UNIREC_MMA_PAIRS(UNIREC_CASE)
#undef UNIREC_CASE
  return (int)cudaErrorInvalidValue;
}

int dispatch_blocks_mma(int B, int D, int F, int nh) {
  const int d16 = D / 16, h16 = D / nh / 16;
#define UNIREC_CASE(a, h) \
  if (d16 == a && h16 == h) return blocks_mma<a, h>(B, F);
  UNIREC_MMA_PAIRS(UNIREC_CASE)
#undef UNIREC_CASE
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int unirec_lastq_bwd_smem_bytes(int Lp, int D, int F, int nh) {
  return (int)sizeof(float) * lastq_bwd_smem_floats(Lp, D, F, nh);
}

int unirec_lastq_bwd_slab_floats(int D, int F) { return lastq_slab_floats(D, F); }

// 1 when the backward runs the bf16 tensor-core body (dtype 1, Lp <= 64, D
// and the head width D / nh multiples of 16 up to 64, F a multiple of 16,
// its shared memory within a block's; ops/layer.py::_lastq_bwd_body holds a
// copy of the rule), and that body's bytes of dynamic shared memory
int unirec_lastq_bwd_mma_takes(int dtype, int Lp, int D, int F, int nh) {
  return (int)mma_takes(dtype, Lp, D, F, nh);
}

int unirec_lastq_bwd_mma_smem_bytes(int D, int F, int nh) { return mma_smem_bytes(D, F, nh); }

// The persistent grid's block count for a batch of B (SMs x resident
// blocks per SM, at most B) of the tensor-core body (mma 1) or the
// CUDA-core body (mma 0), or minus a cudaError_t.
int unirec_lastq_bwd_blocks(int dtype, int B, int Lp, int D, int F, int nh, int mma) {
  if (mma) {
    if (!mma_takes(dtype, Lp, D, F, nh)) return -(int)cudaErrorInvalidValue;
    return dispatch_blocks_mma(B, D, F, nh);
  }
  if (dtype == 0) return blocks<float>(B, Lp, D, F, nh);
  if (dtype == 1) return blocks<__nv_bfloat16>(B, Lp, D, F, nh);
  return -(int)cudaErrorInvalidValue;
}

// Arguments as unirec_layer_bwd, with the 16 flat weights of lastq_fwd,
// the transposes of its six matmul weights, dy [B, D] and the query row qi.
// mma 1 runs the tensor-core body, which takes only what
// unirec_lastq_bwd_mma_takes admits, ignores the transposes (null is fine),
// takes zeroed slabs, and x, dy, dx, madd and the five matmul weights
// 16-byte aligned; mma 0 the CUDA-core body, whose slabs are written whole;
// nblocks from unirec_lastq_bwd_blocks with the same mma. Returns a
// cudaError_t.
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
                     int act, int mma, float eps, unsigned seed, unsigned t_attn,
                     unsigned t_hidden, float inv_attn, float inv_hidden,
                     unsigned b0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr{seed, t_attn, t_hidden, inv_attn, inv_hidden, b0};
  const void* w[18] = {wq, bq, wk, bk, wv, bv, wo, bo, w1, b1, w2, b2,
                       wqT, wkT, wvT, woT, w1T, w2T};
  const float* ln[4] = {g1, c1, g2, c2};
  if (nblocks <= 0 || qi < 0 || qi >= Lp) return (int)cudaErrorInvalidValue;
  if (mma) {
    if (!mma_takes(dtype, Lp, D, F, nh)) return (int)cudaErrorInvalidValue;
    return dispatch_launch_mma(D, nh, x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp, F, qi, act,
                               eps, dr, s);
  }
  if (dtype == 0)
    return launch<float>(x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp, D, F,
                         nh, qi, act, eps, dr, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp,
                                 D, F, nh, qi, act, eps, dr, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
