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
// Bound on an H100: at the training shapes (B=32,768, Lp=56, D=64, F=128)
// the layer reads and writes 235 MB of bf16 each way and does 147 GFLOP:
// bound by operations on the bf16 tensor cores (0.148 ms); at the serving
// shapes (B=256) both bounds are about a microsecond.
//
// Two bodies; the rule fwd_mma_takes picks one (ops/layer.py::
// _layer_fwd_body holds a copy, checked against unirec_layer_fwd_mma_takes).
//
// CUDA-core body (f32, and bf16 at widths the tensor-core body does not
// take; layer_fwd_kernel): one 256-thread block per example keeps every
// intermediate in f32 shared memory ([Lp, 3D] qkv, one head's [Lp, Lp]
// scores, [Lp, F] FFN activation) and reads the weights through L1/L2;
// every product is a scalar fmaf loop: 25.9 ms at B=32,768 on an H100
// (80GB HBM3, 700 W), 175x its bound.
//
// Tensor-core body (bf16; Lp <= 64, D and the head width multiples of 16 up
// to 64, F a multiple of 16 whose buffers fit a block; layer_fwd_mma_kernel
// below). Every product of the Pallas kernel takes bf16 operands with f32
// sums, which is what mma.sync m16n8k16 computes; only the order of the f32
// sums differs, and every rounding point stays: _dense rounds the product,
// then adds the bias in bf16; softmax and LayerNorm run in f32. It is row
// 2's recompute (csrc/layer_bwd.cu) with what row 2's ablations taught
// about latency: a persistent grid of 16-warp blocks, one a SM, holding
// wqkv, wo, w1 and w2 once in bf16 shared memory (69 KB at D=64, F=128),
// read through ldmatrix(.trans); two groups of 8 warps, each with its own
// example, its own two-stage cp.async ring of x and madd rows and its own
// named barriers, so two examples are in flight a SM and one group's
// barriers and chains hide under the other's work. In a group, two warps
// own a 16-row strip (csrc/layer_strip.cuh), each half of its columns and
// every other head: the q|k|v projection, per head S = Q K^T, the f32
// softmax, the keep bits and P V (csrc/strip.cuh, the code of rows 10, 11
// and 2), the output projection, LN1 (row statistics by quad shuffles and
// one exchange between the pair), then the FFN: each warp takes half of F,
// 16 columns at a time, u = x1 W1 by MMA, h = act(u) on the accumulator
// fragments, repacked in registers as the A fragment of y += h W2 (as row
// 12 does), so u and h never touch shared memory; the two halves' f32 sums
// of y meet once through shared memory (q|k|v's room, free after the
// attention), then LN2, and y leaves through the strip's own x rows as
// 16-byte stores. Each keep bit is drawn once, where its element is made.
// Lp = 56 pads to 64-row tiles as row 2 does: keys past Lp get probability
// 0 exactly, rows past Lp are zero-filled by cp.async and never stored.
#include "layer_strip.cuh"

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
      S[i * lds + j] = rnd<T>(kept(dr.seed, dr.t_attn, h, dr.b0 + b, w) ? p * dr.inv_attn : 0.0f);
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

// ------------------------------------------------ bf16 tensor-core body
// See the note at the top of this file.
constexpr int kGroups = 2;                      // examples in flight a block
constexpr int kFwdWarps = kGroups * kMmaWarps;  // 16

// one group's bytes: two stages of x [64][D + 8] and the f32 madd row [64];
// q|k|v [64][3D + 8], later the f32 partial sums of y the two warps of a
// strip exchange ([4 strips][16][D], which fit in it at every D); ctx and x1
// [64][D + 8]; the row statistics its strip pairs exchange [4][2][8][2]
__host__ __device__ inline int fwd_group_bytes(int D) {
  const int ldd = D + 8, ldq = 3 * D + 8;
  return 2 * (2 * kMmaRows * ldd + 4 * kMmaRows) + 2 * kMmaRows * ldq + 2 * 2 * kMmaRows * ldd +
         4 * kStrips * 2 * 8 * 2;
}

// the bf16 weights wqkv [D][3D + 8], wo [D][D + 8], w1 [D][F + 8], w2
// [F][D + 8] once, then the groups' buffers; every row a multiple of 16
// bytes (the +8 also keeps ldmatrix free of bank conflicts)
__host__ __device__ inline int fwd_mma_smem_bytes(int D, int F) {
  const int ldd = D + 8, ldq = 3 * D + 8, ldf = F + 8;
  return 2 * (D * ldq + D * ldd + D * ldf + F * ldd) + kGroups * fwd_group_bytes(D);
}

__host__ __device__ inline bool fwd_mma_takes(int dtype, int Lp, int D, int F, int nh) {
  return mma_widths_take(dtype, Lp, D, F, nh) && fwd_mma_smem_bytes(D, F) <= kSmemLimit;
}

// one group's named barrier (ids past the strip pairs' 1..8)
__device__ __forceinline__ void group_bar(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kGroups * kStrips + grp), "r"(32 * kMmaWarps)
               : "memory");
}

template <int D16, int HD16>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
layer_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ madd,
                     const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
                     const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                     const float* __restrict__ g1, const float* __restrict__ c1,
                     const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                     const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                     const float* __restrict__ g2, const float* __restrict__ c2,
                     bf16* __restrict__ y, int B, int Lp, int F, int act, int causal, float eps,
                     Drop dr) {
  constexpr int D = D16 * 16, LDD = D + 8, LDQ = 3 * D + 8, D8 = D / 8;
  constexpr int HD = HD16 * 16, NH = D / HD, NHT = HD16 * 2;
  // the two warps of a strip split D (and F, 3D) in 16-column groups, half
  // 0 taking the larger share; NTH tiles of 8 columns at most
  constexpr int DG0 = (D16 + 1) / 2, NTH = 2 * DG0, NT1 = 2 * D16 - NTH, KH = (NH + 1) / 2;
  constexpr float inv_d = 1.0f / D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDF = F + 8, Mp = (Lp + 15) / 16 * 16, ntile = Mp / 8;
  bf16* Wq = reinterpret_cast<bf16*>(smem_raw);  // [D][LDQ]
  bf16* Wo = Wq + D * LDQ;                       // [D][LDD]
  bf16* W1 = Wo + D * LDD;                       // [D][LDF]
  bf16* W2 = W1 + D * LDF;                       // [F][LDD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int grp = warp / kMmaWarps, gw = warp % kMmaWarps, gtid = threadIdx.x % (32 * kMmaWarps);
  const int strip = gw % kStrips, half = gw / kStrips, i0 = strip * 16;
  const int sid = grp * kStrips + strip;  // the strip pair's barrier and exchange slots
  const bool active = i0 < Mp;
  unsigned char* gbase = reinterpret_cast<unsigned char*>(W2 + F * LDD) + grp * fwd_group_bytes(D);
  const int stage_bytes = 2 * kMmaRows * LDD + 4 * kMmaRows;
  auto Xs = [&](int st) { return reinterpret_cast<bf16*>(gbase + st * stage_bytes); };
  auto Ms = [&](int st) { return reinterpret_cast<float*>(Xs(st) + kMmaRows * LDD); };
  bf16* QKV = reinterpret_cast<bf16*>(gbase + 2 * stage_bytes);  // [64][LDQ]
  bf16* CTX = QKV + kMmaRows * LDQ;                              // [64][LDD]
  bf16* X1 = CTX + kMmaRows * LDD;                               // [64][LDD]
  float* xch = reinterpret_cast<float*>(X1 + kMmaRows * LDD) + strip * 2 * 8 * 2;
  float* part = reinterpret_cast<float*>(QKV) + strip * 16 * D;  // [16][D] f32, after attention
  // this warp's columns: of D (nd tiles from dc0), of F (fc0..fc1) and of 3D
  // (qc0..qc1)
  const int nd = half ? NT1 : NTH, dc0 = half ? 16 * DG0 : 0;
  const int fg = F / 16, fc0 = half ? 16 * ((fg + 1) / 2) : 0,
            fc1 = half ? F : 16 * ((fg + 1) / 2);
  const int qc0 = half ? 16 * ((3 * D16 + 1) / 2) : 0,
            qc1 = half ? 3 * D : 16 * ((3 * D16 + 1) / 2);
  const float scale = (float)(1.0 / sqrt((double)HD));  // as ops/layer.py:203

  // the weights, once, by every thread of the block
  auto load_w = [&](bf16* dst, int ld, const bf16* src, int rows, int cols) {
    const int ch = cols / 8;
    for (int w = threadIdx.x; w < rows * ch; w += blockDim.x)
      cp_async16(dst + (w / ch) * ld + (w % ch) * 8, src + (size_t)(w / ch) * cols + (w % ch) * 8,
                 true);
  };
  load_w(Wq, LDQ, wqkv, D, 3 * D);
  load_w(Wo, LDD, wo, D, D);
  load_w(W1, LDF, w1, D, F);
  load_w(W2, LDD, w2, F, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // example b's x rows (rows Lp..Mp-1 zero-filled) and madd row, by its group
  auto load = [&](int b, int st) {
    const size_t base = (size_t)b * Lp * D;
    for (int w = gtid; w < Mp * D8; w += 32 * kMmaWarps) {
      const int i = w / D8, c = w % D8;
      const bool in = i < Lp;
      cp_async16(Xs(st) + i * LDD + c * 8, x + base + (size_t)(in ? i : 0) * D + c * 8, in);
    }
    for (int w = gtid; w < Lp / 4; w += 32 * kMmaWarps)
      cp_async16(Ms(st) + 4 * w, madd + (size_t)b * Lp + 4 * w, true);
  };
  const int stride = gridDim.x * kGroups;
  int b = blockIdx.x * kGroups + grp;
  if (b < B) load(b, 0);
  cp_async_commit();

  for (int st = 0; b < B; b += stride, st ^= 1) {
    if (b + stride < B) load(b + stride, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this example has landed
    group_bar(grp);
    bf16* X = Xs(st);
    const float* M = Ms(st);

    // ---- q|k|v = rnd(rnd(x Wqkv) + bqkv), every row (the other strips' keys)
    if (active) {
      for (int c0 = qc0; c0 < qc1; c0 += 64) {
        const int nn = min(8, (qc1 - c0) / 8);
        float acc[8][4];
        strip_mm<8, false>(acc, X, LDD, i0, D16, Wq, LDQ, c0, nn, lane);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n >= nn) break;
          const int c = c0 + n * 8 + 2 * t;
          const float bb0 = bfv(bqkv + c), bb1 = bfv(bqkv + c + 1);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            put2(QKV, LDQ, i0 + g + 8 * r, c, rb(rb(acc[n][2 * r]) + bb0),
                 rb(rb(acc[n][2 * r + 1]) + bb1));
        }
      }
    }
    group_bar(grp);

    // ---- attention, head by head: half 0 takes heads 0, 2, .., half 1 heads 1, 3, ..
    if (active) {
      const auto mask = [&](int i, int j) {
        const float m = M[j];
        return causal ? fminf(m, j > i ? kMaskValue : 0.0f) : m;
      };
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const int h = 2 * k + half;
        if (h >= NH) break;
        float s[kNT][4];
        strip_abt<HD16>(s, QKV + h * HD, LDQ, QKV + D + h * HD, LDQ, i0, ntile, lane);
        strip_softmax(s, mask, i0, Lp, ntile, scale, lane);
        const uint32_t keep = strip_keep(dr.seed, dr.t_attn, h, dr.b0 + b, i0, Lp, ntile, lane);
        float o[NHT][4];
#pragma unroll
        for (int d = 0; d < NHT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
        strip_av<HD16>(o, [&](int kc, uint32_t a[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int n = 2 * kc + r / 2, e = 2 * (r & 1);
            a[r] = pack_bf16(dropped(s, keep, n, e, dr.inv_attn),
                             dropped(s, keep, n, e + 1, dr.inv_attn));
          }
        }, QKV + 2 * D + h * HD, LDQ, ntile, lane);
#pragma unroll
        for (int d = 0; d < NHT; ++d)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            put2(CTX, LDD, i0 + g + 8 * r, h * HD + d * 8 + 2 * t, o[d][2 * r], o[d][2 * r + 1]);
      }
    }
    group_bar(grp);  // ctx rows whole; no strip reads q|k|v any more

    if (active) {
      // ---- o = rnd(rnd(ctx Wo) + bo), dropout (site nh), + x, LN1, x1
      float xh[NTH][4], rs[2];
      strip_mm<NTH, false>(xh, CTX, LDD, i0, D16, Wo, LDD, dc0, nd, lane);
#pragma unroll
      for (int n = 0; n < NTH; ++n)
        if (n < nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + (e >> 1) * 8, c = dc0 + n * 8 + 2 * t + (e & 1);
            float o = rb(rb(xh[n][e]) + bfv(bo + c));
            if (i < Lp) o = kept(dr.seed, dr.t_hidden, NH, dr.b0 + b, i * D + c) ? rb(o * dr.inv_hidden) : 0.0f;
            xh[n][e] = rb(o + bfv(X + i * LDD + c));
          }
      strip_ln<NTH>(xh, nd, rs, eps, inv_d, xch, sid, half, lane);
#pragma unroll
      for (int n = 0; n < NTH; ++n) {
        if (n >= nd) break;
        const int c = dc0 + n * 8 + 2 * t;
        const float ga = __ldg(g1 + c), gb = __ldg(g1 + c + 1), ca = __ldg(c1 + c),
                    cb = __ldg(c1 + c + 1);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          put2(X1, LDD, i0 + g + 8 * r, c, xh[n][2 * r] * ga + ca, xh[n][2 * r + 1] * gb + cb);
      }
      pair_bar(sid);  // x1 rows whole

      // ---- FFN over this warp's half of F, 16 columns at a time: u = rnd(rnd(x1
      // W1) + b1), h = rnd(act(u)) repacked as the A fragment of y += h W2; y's
      // f32 partial sums over the half for every column of D in registers
      uint32_t ax[D16][4];
#pragma unroll
      for (int kd = 0; kd < D16; ++kd) frag_a(ax[kd], X1, LDD, i0, kd * 16, lane);
      float ya[2 * D16][4];
#pragma unroll
      for (int n = 0; n < 2 * D16; ++n) ya[n][0] = ya[n][1] = ya[n][2] = ya[n][3] = 0.0f;
      with_act(act, [&](auto tag) {
        constexpr int A = decltype(tag)::value;
        for (int f0 = fc0; f0 < fc1; f0 += 16) {
          float pre[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int kd = 0; kd < D16; ++kd) {
            uint32_t bw[4];
            frag_b_t(bw, W1, LDF, f0, kd * 16, lane);
            mma_bf16(pre[0], ax[kd], bw[0], bw[1]);
            mma_bf16(pre[1], ax[kd], bw[2], bw[3]);
          }
          float hh[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float d;
              act_pair<A>(rb(rb(pre[n][e]) + bfv(b1 + f0 + n * 8 + 2 * t + (e & 1))), hh[n][e], d);
            }
          const uint32_t ah[4] = {pack_bf16(hh[0][0], hh[0][1]), pack_bf16(hh[0][2], hh[0][3]),
                                  pack_bf16(hh[1][0], hh[1][1]), pack_bf16(hh[1][2], hh[1][3])};
#pragma unroll
          for (int np = 0; np < D16; ++np) {
            uint32_t bw[4];
            frag_b_t(bw, W2, LDD, np * 16, f0, lane);
            mma_bf16(ya[2 * np], ah, bw[0], bw[1]);
            mma_bf16(ya[2 * np + 1], ah, bw[2], bw[3]);
          }
        }
      });
      // the partner's columns of this warp's sums to shared memory; then this
      // warp's own columns, its sums + the partner's (column tiles NTH.. are
      // half 1's)
      auto put_part = [&](int n) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(part + (g + 8 * r) * D + n * 8 + 2 * t) =
              make_float2(ya[n][2 * r], ya[n][2 * r + 1]);
      };
      auto add_part = [&](int n, float v[4]) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 p = *reinterpret_cast<const float2*>(part + (g + 8 * r) * D + n * 8 + 2 * t);
          v[2 * r] = ya[n][2 * r] + p.x;
          v[2 * r + 1] = ya[n][2 * r + 1] + p.y;
        }
      };
      if (half) {
#pragma unroll
        for (int n = 0; n < NTH; ++n) put_part(n);
      } else {
#pragma unroll
        for (int n = NTH; n < 2 * D16; ++n) put_part(n);
      }
      pair_bar(sid);
      if (half) {
#pragma unroll
        for (int n = 0; n < NT1; ++n) add_part(NTH + n, xh[n]);
      } else {
#pragma unroll
        for (int n = 0; n < NTH; ++n) add_part(n, xh[n]);
      }
      // ---- h2 = rnd(sum + b2), dropout (site nh + 1), + x1, LN2, y
#pragma unroll
      for (int n = 0; n < NTH; ++n)
        if (n < nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + (e >> 1) * 8, c = dc0 + n * 8 + 2 * t + (e & 1);
            float h2 = rb(rb(xh[n][e]) + bfv(b2 + c));
            if (i < Lp)
              h2 = kept(dr.seed, dr.t_hidden, NH + 1, dr.b0 + b, i * D + c) ? rb(h2 * dr.inv_hidden) : 0.0f;
            xh[n][e] = rb(h2 + bfv(X1 + i * LDD + c));
          }
      strip_ln<NTH>(xh, nd, rs, eps, inv_d, xch, sid, half, lane);
      // y through the strip's own x rows (dead since the residual), then out
      // as 16-byte stores
#pragma unroll
      for (int n = 0; n < NTH; ++n) {
        if (n >= nd) break;
        const int c = dc0 + n * 8 + 2 * t;
        const float ga = __ldg(g2 + c), gb = __ldg(g2 + c + 1), ca = __ldg(c2 + c),
                    cb = __ldg(c2 + c + 1);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          put2(X, LDD, i0 + g + 8 * r, c, xh[n][2 * r] * ga + ca, xh[n][2 * r + 1] * gb + cb);
      }
      pair_bar(sid);  // y rows whole
      const size_t base = (size_t)b * Lp * D;
      for (int w = half * 32 + lane; w < 16 * D8; w += 64) {
        const int i = i0 + w / D8, cc = w % D8;
        if (i < Lp)
          *reinterpret_cast<uint4*>(y + base + (size_t)i * D + cc * 8) =
              *reinterpret_cast<const uint4*>(X + i * LDD + cc * 8);
      }
    }
    group_bar(grp);  // this stage and q|k|v are consumed before the next copies
  }
  cp_async_wait<0>();
}

template <int D16, int HD16>
int launch_mma(const void* x, const float* madd, const void* const* w, const float* const* ln,
               void* y, int B, int Lp, int F, int act, int causal, float eps, Drop dr,
               cudaStream_t stream) {
  const int smem = fwd_mma_smem_bytes(D16 * 16, F);
  cudaError_t err = cudaFuncSetAttribute(layer_fwd_mma_kernel<D16, HD16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int need = (B + kGroups - 1) / kGroups, grid = sms < need ? sms : need;
  if (grid < 1) return (int)cudaSuccess;
  layer_fwd_mma_kernel<D16, HD16><<<grid, 32 * kFwdWarps, smem, stream>>>(
      (const bf16*)x, madd, (const bf16*)w[0], (const bf16*)w[1], (const bf16*)w[2],
      (const bf16*)w[3], ln[0], ln[1], (const bf16*)w[4], (const bf16*)w[5], (const bf16*)w[6],
      (const bf16*)w[7], ln[2], ln[3], (bf16*)y, B, Lp, F, act, causal, eps, dr);
  return (int)cudaGetLastError();
}

int dispatch_launch_mma(int D, int nh, const void* x, const float* madd, const void* const* w,
                        const float* const* ln, void* y, int B, int Lp, int F, int act,
                        int causal, float eps, Drop dr, cudaStream_t s) {
  const int d16 = D / 16, h16 = D / nh / 16;
#define UNIREC_CASE(a, h) \
  if (d16 == a && h16 == h) return launch_mma<a, h>(x, madd, w, ln, y, B, Lp, F, act, causal, eps, dr, s);
  UNIREC_MMA_PAIRS(UNIREC_CASE)
#undef UNIREC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one block of the CUDA-core body needs (the
// wrapper's gate)
int unirec_layer_fwd_smem_bytes(int Lp, int D, int F) {
  return (int)sizeof(float) * layer_smem_floats(Lp, D, F);
}

// 1 when the forward runs the bf16 tensor-core body (dtype 1, Lp <= 64, D
// and the head width D / nh multiples of 16 up to 64, F a multiple of 16,
// its shared memory within a block's; ops/layer.py::_layer_fwd_body holds a
// copy of the rule), and that body's bytes of dynamic shared memory
int unirec_layer_fwd_mma_takes(int dtype, int Lp, int D, int F, int nh) {
  return (int)fwd_mma_takes(dtype, Lp, D, F, nh);
}

int unirec_layer_fwd_mma_smem_bytes(int D, int F) { return fwd_mma_smem_bytes(D, F); }

// dtype: 0 = float32, 1 = bfloat16 (x, y, weights and biases); madd and
// the LayerNorm parameters are float32. mma 1 runs the tensor-core body,
// which takes only what unirec_layer_fwd_mma_takes admits, with x, madd and
// the four matmul weights 16-byte aligned; mma 0 the CUDA-core body.
// Dropout: seed, the keep thresholds round(p * 2^32) of the attention and
// hidden sites (0: no dropout), their 1/(1-p), and b0, the global index of
// x's first example (a data-parallel rank's row offset; common.cuh::Drop).
// Returns a cudaError_t.
int unirec_layer_fwd(int dtype, const void* x, const float* madd,
                     const void* wqkv, const void* bqkv, const void* wo,
                     const void* bo, const float* g1, const float* c1,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, const float* g2, const float* c2, void* y,
                     int B, int Lp, int D, int F, int nh, int act, int causal,
                     int mma, float eps, unsigned seed, unsigned t_attn,
                     unsigned t_hidden, float inv_attn, float inv_hidden,
                     unsigned b0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr{seed, t_attn, t_hidden, inv_attn, inv_hidden, b0};
  if (mma) {
    if (!fwd_mma_takes(dtype, Lp, D, F, nh)) return (int)cudaErrorInvalidValue;
    const void* w[8] = {wqkv, bqkv, wo, bo, w1, b1, w2, b2};
    const float* ln[4] = {g1, c1, g2, c2};
    return dispatch_launch_mma(D, nh, x, madd, w, ln, y, B, Lp, F, act, causal, eps, dr, s);
  }
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
