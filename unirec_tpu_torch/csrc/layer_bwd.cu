// layer_bwd: backward of layer_fwd (one whole post-LN layer, with dropout).
//
// Replaces the TPU kernel unirec_tpu/ops/layer.py::_layer_bwd_kernel
// (launched by _fused_layer_bwd, the custom_vjp of fused_transformer_layer).
// Like it, this kernel saves nothing from the forward but x: it recomputes
// the layer from x, regenerates the forward's dropout masks from the seed
// (common.cuh's Philox, keyed by example and element, so the masks are
// those layer_fwd.cu drew), and emits dx and every weight and bias
// gradient, rounding to T where the Pallas kernel casts to the input
// dtype (dh2, du, do, dctx, ds and the dq|dk|dv block).
//
// Weight gradients: the TPU kernel writes one partial slab per grid step
// and sums them outside. Blocks here do not run in order and one slab per
// example would be several GB at B=32768, so the grid is persistent (a few
// blocks per SM, ops/layer.py asks unirec_layer_bwd_blocks for the count)
// and each block loops over examples b = blockIdx.x, blockIdx.x + grid, ...
// accumulating into its OWN f32 slab in device memory: no atomics, so the
// result is deterministic; the wrapper sums the slabs (layer.py:569).
//
// Shared memory per block (f32): x, q|k|v, the pre-dropout probabilities
// of every head (the sign bit marks a dropped entry, so the backward reads
// the mask without drawing it again), one [Lp, Lp] dp/ds buffer, ctx, x1,
// xhat1, u, xhat2 and two [Lp, D] gradient buffers: 213,024 bytes at
// Lp=56, D=64, F=128, nh=2, one block per SM. q|k|v is overwritten by
// dq|dk|dv head by head; u holds hm, then du (u is recomputed from x1
// rather than kept, for lack of room).
//
// Bound on an H100: at the training shapes (B=32768, Lp=56, D=64, F=128)
// the backward reads x, dy and writes dx (bf16, 0.7 GB in all) and does
// about 3x the forward's 154 GFLOP; the products run on the CUDA cores in
// f32, so it is compute-bound far above its bound. wgmma is a later PR.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 512;
constexpr float kMaskValue = -1e4f;  // reference additive mask (sasrec.py:56)

__host__ __device__ inline int layer_bwd_smem_floats(int Lp, int D, int F, int nh) {
  const int ldx = D + 1, ldq = 3 * D + 1, ldu = F + 1, lds = Lp + 1;
  return 7 * Lp * ldx + Lp * ldq + (nh + 1) * Lp * lds + Lp * ldu + 3 * Lp;
}

// floats of one block's slab: the 12 leaves in the flat-weight order
// (wqkv, bqkv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2)
__host__ __device__ inline int layer_slab_floats(int D, int F) {
  return 3 * D * D + 3 * D + D * D + D + 2 * D + D * F + F + F * D + D + 2 * D;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_bwd_kernel(const T* __restrict__ x, const float* __restrict__ madd,
                 const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                 const T* __restrict__ wo, const T* __restrict__ bo,
                 const float* __restrict__ g1, const float* __restrict__ c1,
                 const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2,
                 const float* __restrict__ g2, const float* __restrict__ c2,
                 const T* __restrict__ wqkvT, const T* __restrict__ woT,
                 const T* __restrict__ w1T, const T* __restrict__ w2T,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ slabs, int B, int Lp, int D, int F,
                 int nh, int act, int causal, float eps, Drop dr) {
  extern __shared__ float smem[];
  const int hd = D / nh;
  const int ldx = D + 1, ldq = 3 * D + 1, ldu = F + 1, lds = Lp + 1;
  float* X = smem;               // [Lp, D]   x
  float* QKV = X + Lp * ldx;     // [Lp, 3D]  q|k|v, then dq|dk|dv
  float* P = QKV + Lp * ldq;     // [nh, Lp, Lp] pre-dropout probs, sign = dropped
  float* S = P + nh * Lp * lds;  // [Lp, Lp]  dp, then ds
  float* CTX = S + Lp * lds;     // [Lp, D]   attention output (T)
  float* X1 = CTX + Lp * ldx;    // [Lp, D]   LN1 output (T)
  float* XH1 = X1 + Lp * ldx;    // [Lp, D]   xhat1
  float* U = XH1 + Lp * ldx;     // [Lp, F]   u -> hm -> dhm -> du
  float* XH2 = U + Lp * ldu;     // [Lp, D]   xhat2, then dctx
  float* R = XH2 + Lp * ldx;     // [Lp, D]   dy -> dr2 -> dx1 -> dr1
  float* DH = R + Lp * ldx;      // [Lp, D]   dh2, then do, then dq_h|dk_h
  float* M = DH + Lp * ldx;      // [Lp]      key-pad row
  float* RS1 = M + Lp;           // [Lp]      LN1 reciprocal std
  float* RS2 = RS1 + Lp;         // [Lp]      LN2 reciprocal std

  const int o_bqkv = 3 * D * D, o_wo = o_bqkv + 3 * D, o_bo = o_wo + D * D;
  const int o_g1 = o_bo + D, o_c1 = o_g1 + D, o_w1 = o_c1 + D;
  const int o_b1 = o_w1 + D * F, o_w2 = o_b1 + F, o_b2 = o_w2 + F * D;
  const int o_g2 = o_b2 + D, o_c2 = o_g2 + D;
  float* slab = slabs + (size_t)blockIdx.x * layer_slab_floats(D, F);
  for (int i = threadIdx.x; i < layer_slab_floats(D, F); i += blockDim.x) slab[i] = 0.0f;

  const float scale = (float)(1.0 / sqrt((double)hd));
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t base = (size_t)b * Lp * D;
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x)
      X[(i / D) * ldx + i % D] = to_f<T>(x[base + i]);
    for (int j = threadIdx.x; j < Lp; j += blockDim.x) M[j] = madd[(size_t)b * Lp + j];
    __syncthreads();

    // ---- recompute the forward
    mm_rows<T, 4>(X, ldx, Lp, D, wqkv, 3 * D, 1, 3 * D, [&](int r, int c, float a) {
      QKV[r * ldq + c] = rnd<T>(rnd<T>(a) + to_f<T>(bqkv[c]));
    });
    __syncthreads();
    for (int h = 0; h < nh; ++h) {
      float* Ph = P + h * Lp * lds;
      const float* Q = QKV + h * hd;
      const float* K = QKV + D + h * hd;
      const float* V = QKV + 2 * D + h * hd;
      for (int w = threadIdx.x; w < Lp * Lp; w += blockDim.x) {
        const int i = w / Lp, j = w % Lp;
        float acc = 0.0f;
        for (int d = 0; d < hd; ++d) acc = fmaf(Q[i * ldq + d], K[j * ldq + d], acc);
        float m = M[j];
        if (causal) m = fminf(m, j > i ? kMaskValue : 0.0f);
        Ph[i * lds + j] = acc * scale + m;
      }
      __syncthreads();
      softmax_rows(Ph, lds, Lp, Lp);
      __syncthreads();
      for (int w = threadIdx.x; w < Lp * Lp; w += blockDim.x) {
        float* e = Ph + (w / Lp) * lds + w % Lp;
        if (!kept(dr.seed, dr.t_attn, h, b, w)) *e = -*e;  // -0.0 for 0: sign bit set
      }
      __syncthreads();
      for (int w = threadIdx.x; w < Lp * hd; w += blockDim.x) {
        const int i = w / hd, d = w % hd;
        float acc = 0.0f;
        for (int j = 0; j < Lp; ++j) {
          const float pv = Ph[i * lds + j];
          const float pz = signbit(pv) ? 0.0f : rnd<T>(pv * dr.inv_attn);
          acc = fmaf(pz, V[j * ldq + d], acc);
        }
        CTX[i * ldx + h * hd + d] = rnd<T>(acc);
      }
      __syncthreads();
    }
    mm_rows<T, 4>(CTX, ldx, Lp, D, wo, D, 1, D, [&](int r, int c, float a) {
      const float o = rnd<T>(rnd<T>(a) + to_f<T>(bo[c]));
      XH1[r * ldx + c] = rnd<T>(drop_hidden<T>(o, dr, nh, b, r * D + c) + X[r * ldx + c]);
    });
    __syncthreads();
    ln_stats_rows(XH1, ldx, Lp, D, RS1, eps);
    __syncthreads();
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x) {
      const int o = (i / D) * ldx + i % D, c = i % D;
      X1[o] = rnd<T>(XH1[o] * g1[c] + c1[c]);
    }
    __syncthreads();
    mm_rows<T, 4>(X1, ldx, Lp, D, w1, F, 1, F, [&](int r, int c, float a) {
      U[r * ldu + c] = rnd<T>(activate(act, rnd<T>(rnd<T>(a) + to_f<T>(b1[c]))));
    });
    __syncthreads();
    mm_rows<T, 4>(U, ldu, Lp, F, w2, D, 1, D, [&](int r, int c, float a) {
      const float h2 = rnd<T>(rnd<T>(a) + to_f<T>(b2[c]));
      XH2[r * ldx + c] = rnd<T>(drop_hidden<T>(h2, dr, nh + 1, b, r * D + c) + X1[r * ldx + c]);
    });
    __syncthreads();
    ln_stats_rows(XH2, ldx, Lp, D, RS2, eps);
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x)
      R[(i / D) * ldx + i % D] = to_f<T>(dy[base + i]);
    __syncthreads();

    // ---- LN2, FFN
    colsum([&](int r, int n) { return R[r * ldx + n] * XH2[r * ldx + n]; }, D, Lp, slab + o_g2);
    colsum([&](int r, int n) { return R[r * ldx + n]; }, D, Lp, slab + o_c2);
    __syncthreads();
    ln_bwd_rows(R, ldx, XH2, ldx, RS2, Lp, D, g2);
    __syncthreads();
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x) {
      const int o = (i / D) * ldx + i % D;
      DH[o] = rnd<T>(kept(dr.seed, dr.t_hidden, nh + 1, b, i) ? R[o] * dr.inv_hidden : 0.0f);
    }
    __syncthreads();
    wgrad([&](int r, int k) { return U[r * ldu + k]; }, F, DH, ldx, D, Lp, slab + o_w2);
    colsum([&](int r, int n) { return DH[r * ldx + n]; }, D, Lp, slab + o_b2);
    __syncthreads();
    mm_rows<T, 4>(DH, ldx, Lp, D, w2T, F, 1, F, [&](int r, int c, float a) {
      U[r * ldu + c] = a;  // dhm = dh2 @ w2^T
    });
    __syncthreads();
    mm_rows<T, 4>(X1, ldx, Lp, D, w1, F, 1, F, [&](int r, int c, float a) {
      const float u = rnd<T>(rnd<T>(a) + to_f<T>(b1[c]));
      U[r * ldu + c] = rnd<T>(U[r * ldu + c] * activate_grad(act, u));
    });
    __syncthreads();
    wgrad([&](int r, int k) { return X1[r * ldx + k]; }, D, U, ldu, F, Lp, slab + o_w1);
    colsum([&](int r, int n) { return U[r * ldu + n]; }, F, Lp, slab + o_b1);
    mm_rows<T, 4>(U, ldu, Lp, F, w1T, D, 1, D, [&](int r, int c, float a) {
      R[r * ldx + c] += a;  // dx1 = dr2 + du @ w1^T
    });
    __syncthreads();

    // ---- LN1, attention output
    colsum([&](int r, int n) { return R[r * ldx + n] * XH1[r * ldx + n]; }, D, Lp, slab + o_g1);
    colsum([&](int r, int n) { return R[r * ldx + n]; }, D, Lp, slab + o_c1);
    __syncthreads();
    ln_bwd_rows(R, ldx, XH1, ldx, RS1, Lp, D, g1);
    __syncthreads();
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x) {
      const int o = (i / D) * ldx + i % D;
      DH[o] = rnd<T>(kept(dr.seed, dr.t_hidden, nh, b, i) ? R[o] * dr.inv_hidden : 0.0f);
    }
    __syncthreads();
    wgrad([&](int r, int k) { return CTX[r * ldx + k]; }, D, DH, ldx, D, Lp, slab + o_wo);
    colsum([&](int r, int n) { return DH[r * ldx + n]; }, D, Lp, slab + o_bo);
    float* DCTX = XH2;
    mm_rows<T, 4>(DH, ldx, Lp, D, woT, D, 1, D, [&](int r, int c, float a) {
      DCTX[r * ldx + c] = rnd<T>(a);
    });
    __syncthreads();

    // ---- attention, head by head
    for (int h = 0; h < nh; ++h) {
      const float* Ph = P + h * Lp * lds;
      float* Q = QKV + h * hd;
      float* K = QKV + D + h * hd;
      float* V = QKV + 2 * D + h * hd;
      const float* dch = DCTX + h * hd;
      for (int w = threadIdx.x; w < Lp * Lp; w += blockDim.x) {
        const int i = w / Lp, j = w % Lp;
        float acc = 0.0f;
        for (int d = 0; d < hd; ++d) acc = fmaf(dch[i * ldx + d], V[j * ldq + d], acc);
        S[i * lds + j] = signbit(Ph[i * lds + j]) ? 0.0f : acc * dr.inv_attn;
      }
      __syncthreads();
      for (int w = threadIdx.x; w < Lp * hd; w += blockDim.x) {
        const int j = w / hd, d = w % hd;
        float acc = 0.0f;
        for (int i = 0; i < Lp; ++i) {
          const float pv = Ph[i * lds + j];
          const float pz = signbit(pv) ? 0.0f : rnd<T>(pv * dr.inv_attn);
          acc = fmaf(pz, dch[i * ldx + d], acc);
        }
        V[j * ldq + d] = rnd<T>(acc);  // dv; v_h is dead once dp is formed
      }
      {
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        for (int i = warp; i < Lp; i += blockDim.x / 32) {
          float t = 0.0f;
          for (int j = lane; j < Lp; j += 32) t += S[i * lds + j] * fabsf(Ph[i * lds + j]);
          t = warp_sum(t);
          for (int j = lane; j < Lp; j += 32) {
            const float p = fabsf(Ph[i * lds + j]);
            S[i * lds + j] = rnd<T>(p * (S[i * lds + j] - t) * scale);
          }
        }
      }
      __syncthreads();
      for (int w = threadIdx.x; w < Lp * hd; w += blockDim.x) {
        const int r = w / hd, d = w % hd;
        float aq = 0.0f, ak = 0.0f;
        for (int j = 0; j < Lp; ++j) {
          aq = fmaf(S[r * lds + j], K[j * ldq + d], aq);
          ak = fmaf(S[j * lds + r], Q[j * ldq + d], ak);
        }
        DH[r * ldx + d] = rnd<T>(aq);
        DH[r * ldx + hd + d] = rnd<T>(ak);
      }
      __syncthreads();
      for (int w = threadIdx.x; w < Lp * hd; w += blockDim.x) {
        const int r = w / hd, d = w % hd;
        Q[r * ldq + d] = DH[r * ldx + d];
        K[r * ldq + d] = DH[r * ldx + hd + d];
      }
      __syncthreads();
    }

    // ---- q|k|v projection and dx
    wgrad([&](int r, int k) { return X[r * ldx + k]; }, D, QKV, ldq, 3 * D, Lp, slab);
    colsum([&](int r, int n) { return QKV[r * ldq + n]; }, 3 * D, Lp, slab + o_bqkv);
    mm_rows<T, 4>(QKV, ldq, Lp, 3 * D, wqkvT, D, 1, D, [&](int r, int c, float a) {
      dx[base + (size_t)r * D + c] = from_f<T>(R[r * ldx + c] + a);
    });
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const float* madd, const void* const* w,
           const float* const* ln, const void* dy, void* dx, float* slabs,
           int nblocks, int B, int Lp, int D, int F, int nh, int act, int causal,
           float eps, Drop dr, cudaStream_t stream) {
  const size_t smem = sizeof(float) * layer_bwd_smem_floats(Lp, D, F, nh);
  cudaError_t err = cudaFuncSetAttribute(
      layer_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  layer_bwd_kernel<T><<<nblocks, kThreads, smem, stream>>>(
      (const T*)x, madd, (const T*)w[0], (const T*)w[1], (const T*)w[2],
      (const T*)w[3], ln[0], ln[1], (const T*)w[4], (const T*)w[5],
      (const T*)w[6], (const T*)w[7], ln[2], ln[3], (const T*)w[8], (const T*)w[9],
      (const T*)w[10], (const T*)w[11], (const T*)dy, (T*)dx,
      slabs, B, Lp, D, F, nh, act, causal, eps, dr);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks(int B, int Lp, int D, int F, int nh) {
  const size_t smem = sizeof(float) * layer_bwd_smem_floats(Lp, D, F, nh);
  cudaError_t err = cudaFuncSetAttribute(
      layer_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, layer_bwd_kernel<T>, kThreads, smem)) != cudaSuccess)
    return -(int)err;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  return n < B ? n : B;
}

}  // namespace

extern "C" {

int unirec_layer_bwd_smem_bytes(int Lp, int D, int F, int nh) {
  return (int)sizeof(float) * layer_bwd_smem_floats(Lp, D, F, nh);
}

int unirec_layer_bwd_slab_floats(int D, int F) { return layer_slab_floats(D, F); }

// The persistent grid's block count for a batch of B (SMs x resident
// blocks per SM, at most B), or minus a cudaError_t.
int unirec_layer_bwd_blocks(int dtype, int B, int Lp, int D, int F, int nh) {
  if (dtype == 0) return blocks<float>(B, Lp, D, F, nh);
  if (dtype == 1) return blocks<__nv_bfloat16>(B, Lp, D, F, nh);
  return -(int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (x, dy, dx, weights and biases); madd
// and the LayerNorm parameters are float32. wqkvT, woT, w1T, w2T: the
// transposes of the four matmul weights, contiguous, so that the products
// with W^T read the weights coalesced. slabs: [nblocks, slab floats]
// f32, written whole (each block zeroes its own). Dropout arguments as in
// unirec_layer_fwd. Returns a cudaError_t.
int unirec_layer_bwd(int dtype, const void* x, const float* madd,
                     const void* wqkv, const void* bqkv, const void* wo,
                     const void* bo, const float* g1, const float* c1,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, const float* g2, const float* c2,
                     const void* wqkvT, const void* woT, const void* w1T,
                     const void* w2T, const void* dy, void* dx, float* slabs,
                     int nblocks, int B,
                     int Lp, int D, int F, int nh, int act, int causal,
                     float eps, unsigned seed, unsigned t_attn,
                     unsigned t_hidden, float inv_attn, float inv_hidden,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr{seed, t_attn, t_hidden, inv_attn, inv_hidden};
  const void* w[12] = {wqkv, bqkv, wo, bo, w1, b1, w2, b2, wqkvT, woT, w1T, w2T};
  const float* ln[4] = {g1, c1, g2, c2};
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp, D, F,
                         nh, act, causal, eps, dr, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp,
                                 D, F, nh, act, causal, eps, dr, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
