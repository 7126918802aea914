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
// Bound on an H100: at the training shapes (B=32768, Lp=56, D=64, F=128) it
// reads 235 MB of bf16 x and does 31 GFLOP, nearly all of it the K|V
// projection: 0.074 ms of memory time (0.031 on the tensor cores); at the
// serving B=256 about 0.6 us.
//
// Two bodies; the rule mma_takes picks one (ops/layer.py::_lastq_fwd_body
// holds a copy, checked against unirec_lastq_fwd_mma_takes).
//
// CUDA-core body (f32, and bf16 at widths the tensor-core body does not
// take; lastq_fwd_kernel): one block per example; the [Lp, 2D] keys and
// values and every per-row vector stay in f32 shared memory, so device
// memory sees x once and y once; every product is a scalar fmaf loop (the
// K|V projection most of the work) and the one-row chain runs behind 14
// block barriers an example: 4.2 ms at B=32,768 on an H100 (80GB HBM3,
// 700 W), 56x its bound.
//
// Tensor-core body (bf16; Lp <= 64, D and the head width multiples of 16 up
// to 64, F a multiple of 16 whose buffers fit a block; lastq_fwd_mma_kernel
// below). A persistent grid of 16-warp blocks, one a SM, holds wq, wk|wv,
// wo, w1 and w2 once in bf16 shared memory (70 KB at D=64, F=128); two
// groups of 8 warps each take their own examples through their own
// two-stage cp.async ring of x and madd rows and their own named barriers,
// so one group's barriers and serial chains hide under the other's work.
// Per example, two warps a 16-row strip: K|V = x [Wk|Wv] on mma.sync bf16
// with f32 sums (one warp the k half, one the v half), q from the MMA of
// the strip holding qi; then a warp a head: the query row's scores s = q
// K^T and ctx = rnd(z V) as mma.sync products whose A tile holds the query
// row as its row 0, and between them the f32 softmax and the keep bits a
// lane a key. The one-row chain that is left, out-projection, LN1, the FFN
// and LN2, is batched: the ctx and x[qi] rows of 16 examples gather in
// shared memory and run as
// M = 16 products on the tensor cores once a group (o = ctx Wo, u = x1 W1,
// h2 = act(u) W2), each warp a 16-column slice, with the LayerNorms a warp
// a row. A partial last group runs with rows it never stores. Every
// rounding point stays the Pallas kernel's (and the CUDA-core body's):
// k, v, q, o, u, h2 rounded to bf16 after the f32 product, the bias added
// in bf16, softmax and LayerNorm in f32; the keep bits keep their keying,
// so row 4's backward replays them. Lp = 56 pads to 64 rows: rows past Lp
// are zero-filled by cp.async and their keys get probability 0.
#include "layer_strip.cuh"

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

// ------------------------------------------------ bf16 tensor-core body
// See the note at the top of this file.
constexpr int kGroups = 2;                      // groups of 8 warps a block
constexpr int kFwdWarps = kGroups * kMmaWarps;  // 16
constexpr int kGather = 16;                     // examples a row phase takes

// one group's room that k|v of an example and the row phase share: k|v
// [64][2D + 8], or x1 [16][D + 8] and hm [16][F + 8] in bf16 and the f32
// pre-LayerNorm rows [16][D]
__host__ __device__ inline int mma_kv_bytes(int D, int F) {
  const int kv = 2 * kMmaRows * (2 * D + 8);
  const int rows = 2 * kGather * ((D + 8) + (F + 8)) + 4 * kGather * D;
  return kv > rows ? kv : rows;
}

// one group's bytes: two stages of x [64][D + 8] and the f32 madd row [64];
// the shared room above; the gathered x[qi] and ctx rows [16][D + 8]; then
// f32 q [D] and z [nh][64], and the example index of each gathered row
__host__ __device__ inline int mma_group_bytes(int D, int F, int nh) {
  return 2 * (2 * kMmaRows * (D + 8) + 4 * kMmaRows) + mma_kv_bytes(D, F) +
         2 * 2 * kGather * (D + 8) + 4 * (D + nh * kMmaRows) + 4 * kGather;
}

// the bf16 weights wq [D][D + 8], wk|wv [D][2D + 8], wo [D][D + 8], w1
// [D][F + 8], w2 [F][D + 8] once, then the two groups' bytes
__host__ __device__ inline int mma_smem_bytes(int D, int F, int nh) {
  const int ldd = D + 8, ldkv = 2 * D + 8, ldf = F + 8;
  return 2 * (D * ldd + D * ldkv + D * ldd + D * ldf + F * ldd) +
         kGroups * mma_group_bytes(D, F, nh);
}

__host__ __device__ inline bool mma_takes(int dtype, int Lp, int D, int F, int nh) {
  return mma_widths_take(dtype, Lp, D, F, nh) && mma_smem_bytes(D, F, nh) <= kSmemLimit;
}

// one group's named barrier (ids past the strip pairs' 1..8)
__device__ __forceinline__ void group_bar(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kGroups * kStrips + grp), "r"(32 * kMmaWarps)
               : "memory");
}

template <int D16, int HD16>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
lastq_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ madd,
                     const bf16* __restrict__ wq, const bf16* __restrict__ bq,
                     const bf16* __restrict__ wk, const bf16* __restrict__ bk,
                     const bf16* __restrict__ wv, const bf16* __restrict__ bv,
                     const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                     const float* __restrict__ g1, const float* __restrict__ c1,
                     const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                     const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                     const float* __restrict__ g2, const float* __restrict__ c2,
                     bf16* __restrict__ y, int B, int Lp, int F, int qi, int act, float eps,
                     Drop dr) {
  constexpr int D = D16 * 16, LDD = D + 8, LDKV = 2 * D + 8, D8 = D / 8;
  constexpr int HD = HD16 * 16, NH = D / HD;
  constexpr int DG0 = (D16 + 1) / 2, NTH = 2 * DG0, NT1 = 2 * D16 - NTH;
  constexpr float inv_d = 1.0f / D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDF = F + 8, Mp = (Lp + 15) / 16 * 16;
  bf16* Wq = reinterpret_cast<bf16*>(smem_raw);  // [D][LDD]
  bf16* Wkv = Wq + D * LDD;                      // [D][LDKV]  wk | wv
  bf16* Wo = Wkv + D * LDKV;                     // [D][LDD]
  bf16* W1 = Wo + D * LDD;                       // [D][LDF]
  bf16* W2 = W1 + D * LDF;                       // [F][LDD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int grp = warp / kMmaWarps, gw = warp % kMmaWarps, gtid = threadIdx.x % (32 * kMmaWarps);
  const int strip = gw % kStrips, half = gw / kStrips, i0 = strip * 16;
  const bool active = i0 < Mp;
  const int nd = half ? NT1 : NTH, dc0 = half ? 16 * DG0 : 0;
  unsigned char* gbase =
      reinterpret_cast<unsigned char*>(W2 + F * LDD) + grp * mma_group_bytes(D, F, NH);
  const int stage_bytes = 2 * kMmaRows * LDD + 4 * kMmaRows;
  auto Xs = [&](int st) { return reinterpret_cast<bf16*>(gbase + st * stage_bytes); };
  auto Ms = [&](int st) { return reinterpret_cast<float*>(Xs(st) + kMmaRows * LDD); };
  unsigned char* room = gbase + 2 * stage_bytes;
  bf16* KV = reinterpret_cast<bf16*>(room);                  // [64][LDKV] k | v
  bf16* X1g = reinterpret_cast<bf16*>(room);                 // the row phase: [16][LDD]
  bf16* HMg = X1g + kGather * LDD;                           // [16][LDF]
  float* Vr = reinterpret_cast<float*>(HMg + kGather * LDF);  // [16][D] f32
  bf16* XQg = reinterpret_cast<bf16*>(room + mma_kv_bytes(D, F));  // [16][LDD] x[qi]
  bf16* CTg = XQg + kGather * LDD;                                  // [16][LDD] ctx
  float* q = reinterpret_cast<float*>(CTg + kGather * LDD);         // [D]
  float* Z = q + D;                                                 // [NH][64]
  int* exb = reinterpret_cast<int*>(Z + NH * kMmaRows);             // [16]
  const float scale = (float)(1.0 / sqrt((double)HD));  // as ops/layer.py:602

  // the gathered rows start at zero: a partial group's missing rows stay finite
  for (int i = gtid; i < 2 * kGather * LDD / 8; i += 32 * kMmaWarps)
    reinterpret_cast<uint4*>(XQg)[i] = make_uint4(0, 0, 0, 0);
  // the weights, once, by every thread of the block
  auto load_w = [&](bf16* dst, int ld, const bf16* src, int rows, int cols) {
    const int ch = cols / 8;
    for (int w = threadIdx.x; w < rows * ch; w += blockDim.x)
      cp_async16(dst + (w / ch) * ld + (w % ch) * 8, src + (size_t)(w / ch) * cols + (w % ch) * 8,
                 true);
  };
  load_w(Wq, LDD, wq, D, D);
  load_w(Wkv, LDKV, wk, D, D);
  load_w(Wkv + D, LDKV, wv, D, D);
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
  // the f32 LayerNorm of the row phase's 16 rows (Vr), a warp a row, lane l
  // holding columns 2l, 2l + 1: out(i, c, y[c], y[c + 1])
  auto ln_rows = [&](const float* __restrict__ gam, const float* __restrict__ bet, auto out) {
    for (int i = gw; i < kGather; i += kMmaWarps) {
      const int c = 2 * lane;
      const bool in = c < D;
      const float2 v = in ? *reinterpret_cast<const float2*>(Vr + i * D + c) : make_float2(0.f, 0.f);
      const float mu = warp_sum(v.x + v.y) * inv_d;
      const float d0 = in ? v.x - mu : 0.0f, d1 = in ? v.y - mu : 0.0f;
      const float rs = rsqrtf(warp_sum(d0 * d0 + d1 * d1) * inv_d + eps);
      if (in) out(i, c, d0 * rs * gam[c] + bet[c], d1 * rs * gam[c + 1] + bet[c + 1]);
    }
  };
  // the row phase over the n gathered examples: o = rnd(rnd(ctx Wo) + bo),
  // dropout (site nh), + x[qi], LN1 -> x1; u = rnd(rnd(x1 W1) + b1), hm =
  // rnd(act(u)); h2 = rnd(rnd(hm W2) + b2), dropout (site nh + 1), + x1,
  // LN2 -> y. Each product a 16-column slice a warp, M = 16 rows deep.
  auto row_phase = [&](int n) {
    auto hidden = [&](float acc[2][4], const bf16* __restrict__ bias, int site, const bf16* res,
                      int c0) {
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = g + (e >> 1) * 8, c = c0 + n2 * 8 + 2 * t + (e & 1);
          float o = rb(rb(acc[n2][e]) + bfv(bias + c));
          if (i < n) o = kept(dr.seed, dr.t_hidden, site, exb[i], c) ? rb(o * dr.inv_hidden) : 0.0f;
          Vr[i * D + c] = rb(o + bfv(res + i * LDD + c));
        }
    };
    for (int cg = gw; cg < D16; cg += kMmaWarps) {
      float acc[2][4];
      strip_mm<2, false>(acc, CTg, LDD, 0, D16, Wo, LDD, cg * 16, 2, lane);
      hidden(acc, bo, NH, XQg, cg * 16);
    }
    group_bar(grp);
    ln_rows(g1, c1, [&](int i, int c, float v0, float v1) { put2(X1g, LDD, i, c, v0, v1); });
    group_bar(grp);
    with_act(act, [&](auto tag) {
      constexpr int A = decltype(tag)::value;
      for (int fg = gw; fg < F / 16; fg += kMmaWarps) {
        float acc[2][4];
        strip_mm<2, false>(acc, X1g, LDD, 0, D16, W1, LDF, fg * 16, 2, lane);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          const int f = fg * 16 + n2 * 8 + 2 * t;
          const float ba = bfv(b1 + f), bb = bfv(b1 + f + 1);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float h0, h1, d;
            act_pair<A>(rb(rb(acc[n2][2 * r]) + ba), h0, d);
            act_pair<A>(rb(rb(acc[n2][2 * r + 1]) + bb), h1, d);
            put2(HMg, LDF, g + 8 * r, f, h0, h1);
          }
        }
      }
    });
    group_bar(grp);
    for (int cg = gw; cg < D16; cg += kMmaWarps) {
      float acc[2][4];
      strip_mm<2, false>(acc, HMg, LDF, 0, F / 16, W2, LDD, cg * 16, 2, lane);
      hidden(acc, b2, NH + 1, X1g, cg * 16);
    }
    group_bar(grp);
    ln_rows(g2, c2, [&](int i, int c, float v0, float v1) {
      if (i < n)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)exb[i] * D + c) =
            __floats2bfloat162_rn(v0, v1);
    });
  };

  const int stride = gridDim.x * kGroups;
  int b = blockIdx.x * kGroups + grp, slot = 0;
  if (b < B) load(b, 0);
  cp_async_commit();
  for (int st = 0; b < B; b += stride, st ^= 1) {
    cp_async_wait<0>();  // this example has landed
    group_bar(grp);      // for the whole group, and every warp is done with the
                         // previous example: its k|v (or the row phase's room)
                         // and its stage, madd row included, are free
    if (b + stride < B) load(b + stride, st ^ 1);
    cp_async_commit();
    const bf16* X = Xs(st);
    const float* M = Ms(st);

    // ---- k|v = rnd(rnd(x [Wk|Wv]) + [bk|bv]) for every row: half 0 k, half 1
    // v; q = rnd(rnd(x[qi] Wq) + bq) from the MMA of the strip holding qi
    if (active) {
      const bf16* bb = half ? bv : bk;
      float acc[8][4];
      strip_mm<8, false>(acc, X, LDD, i0, D16, Wkv, LDKV, half * D, 2 * D16, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n >= 2 * D16) break;
        const int c = n * 8 + 2 * t;
        const float bb0 = bfv(bb + c), bb1 = bfv(bb + c + 1);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          put2(KV, LDKV, i0 + g + 8 * rr, half * D + c, rb(rb(acc[n][2 * rr]) + bb0),
               rb(rb(acc[n][2 * rr + 1]) + bb1));
      }
      if (strip == qi / 16) {
        float qa[NTH][4];
        strip_mm<NTH, false>(qa, X, LDD, i0, D16, Wq, LDD, dc0, nd, lane);
#pragma unroll
        for (int n = 0; n < NTH; ++n)
          if (n < nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = dc0 + n * 8 + 2 * t + (e & 1);
              if (i0 + g + (e >> 1) * 8 == qi) q[c] = rb(rb(qa[n][e]) + bfv(bq + c));
            }
      }
    }
    if (gtid < D8)  // x[qi], gathered as the residual of the out-projection
      reinterpret_cast<uint4*>(XQg + slot * LDD)[gtid] =
          reinterpret_cast<const uint4*>(X + qi * LDD)[gtid];
    if (gtid == 0) exb[slot] = b;
    group_bar(grp);

    // ---- the query row's attention, a warp a head. Scores and ctx run on
    // the tensor cores with the query row as row 0 of a 16-row tile (lanes
    // 0-3 hold row 0's fragments; the other rows are zero): s = q K^T into
    // z's room, then a lane a key (j = lane, lane + 32) for the f32
    // softmax and the keep bits, then ctx = rnd(z V) into the gathered rows
    if (gw < NH) {
      const int h = gw;
      float sc[2], p[2];
      float* zh = Z + h * kMmaRows;
      const bool row0 = g == 0;
      {
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
        for (int kc = 0; kc < HD16; ++kc) {
          const float* qk = q + h * HD + kc * 16 + 2 * t;
          const uint32_t a[4] = {row0 ? pack_bf16(qk[0], qk[1]) : 0u, 0u,
                                 row0 ? pack_bf16(qk[8], qk[9]) : 0u, 0u};
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (16 * np >= Mp) break;
            uint32_t bk4[4];
            frag_b(bk4, KV + h * HD, LDKV, np * 16, kc * 16, lane);
            mma_bf16(s[2 * np], a, bk4[0], bk4[1]);
            mma_bf16(s[2 * np + 1], a, bk4[2], bk4[3]);
          }
        }
        if (row0)
#pragma unroll
          for (int n = 0; n < 8; ++n) *reinterpret_cast<float2*>(zh + n * 8 + 2 * t) =
                                          make_float2(s[n][0], s[n][1]);
      }
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = lane + 32 * rr;
        sc[rr] = j < Lp ? zh[j] * scale + M[j] : -CUDART_INF_F;
      }
      const float mx = warp_max(fmaxf(sc[0], sc[1]));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) p[rr] = sc[rr] == -CUDART_INF_F ? 0.0f : expf(sc[rr] - mx);
      const float sum = warp_sum(p[0] + p[1]);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = lane + 32 * rr;
        const bool kp = j < Lp && kept(dr.seed, dr.t_attn, h, b, j);
        zh[j] = kp ? rb(p[rr] / sum * dr.inv_attn) : 0.0f;
      }
      __syncwarp();
      float o[2 * HD16][4];
#pragma unroll
      for (int n = 0; n < 2 * HD16; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
      for (int kc = 0; kc < Mp / 16; ++kc) {
        const float* zk = zh + kc * 16 + 2 * t;
        const uint32_t a[4] = {row0 ? pack_bf16(zk[0], zk[1]) : 0u, 0u,
                               row0 ? pack_bf16(zk[8], zk[9]) : 0u, 0u};
#pragma unroll
        for (int np = 0; np < HD16; ++np) {
          uint32_t bv4[4];
          frag_b_t(bv4, KV + D + h * HD, LDKV, np * 16, kc * 16, lane);
          mma_bf16(o[2 * np], a, bv4[0], bv4[1]);
          mma_bf16(o[2 * np + 1], a, bv4[2], bv4[3]);
        }
      }
      if (row0)
#pragma unroll
        for (int n = 0; n < 2 * HD16; ++n)
          put2(CTg, LDD, slot, h * HD + n * 8 + 2 * t, o[n][0], o[n][1]);
    }

    // ---- every kGather examples (and after the group's last): the row phase
    if (++slot == kGather || b + stride >= B) {
      group_bar(grp);  // the ctx rows are whole; k|v is read no more
      row_phase(slot);
      slot = 0;
    }
  }
  cp_async_wait<0>();
}

template <int D16, int HD16>
int launch_mma(const void* x, const float* madd, const void* const* w, const float* const* ln,
               void* y, int B, int Lp, int F, int qi, int act, float eps, Drop dr,
               cudaStream_t stream) {
  const int smem = mma_smem_bytes(D16 * 16, F, D16 / HD16);
  cudaError_t err = cudaFuncSetAttribute(lastq_fwd_mma_kernel<D16, HD16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int need = (B + kGroups - 1) / kGroups, grid = sms < need ? sms : need;
  if (grid < 1) return (int)cudaSuccess;
  lastq_fwd_mma_kernel<D16, HD16><<<grid, 32 * kFwdWarps, smem, stream>>>(
      (const bf16*)x, madd, (const bf16*)w[0], (const bf16*)w[1], (const bf16*)w[2],
      (const bf16*)w[3], (const bf16*)w[4], (const bf16*)w[5], (const bf16*)w[6],
      (const bf16*)w[7], ln[0], ln[1], (const bf16*)w[8], (const bf16*)w[9], (const bf16*)w[10],
      (const bf16*)w[11], ln[2], ln[3], (bf16*)y, B, Lp, F, qi, act, eps, dr);
  return (int)cudaGetLastError();
}

int dispatch_launch_mma(int D, int nh, const void* x, const float* madd, const void* const* w,
                        const float* const* ln, void* y, int B, int Lp, int F, int qi, int act,
                        float eps, Drop dr, cudaStream_t s) {
  const int d16 = D / 16, h16 = D / nh / 16;
#define UNIREC_CASE(a, h)                                                                  \
  if (d16 == a && h16 == h)                                                                \
    return launch_mma<a, h>(x, madd, w, ln, y, B, Lp, F, qi, act, eps, dr, s);
  UNIREC_MMA_PAIRS(UNIREC_CASE)
#undef UNIREC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int unirec_lastq_fwd_smem_bytes(int Lp, int D, int F, int nh) {
  return (int)sizeof(float) * lastq_smem_floats(Lp, D, F, nh);
}

// 1 when the forward runs the bf16 tensor-core body (dtype 1, Lp <= 64, D
// and the head width D / nh multiples of 16 up to 64, F a multiple of 16,
// its shared memory within a block's; ops/layer.py::_lastq_fwd_body holds a
// copy of the rule), and that body's bytes of dynamic shared memory
int unirec_lastq_fwd_mma_takes(int dtype, int Lp, int D, int F, int nh) {
  return (int)mma_takes(dtype, Lp, D, F, nh);
}

int unirec_lastq_fwd_mma_smem_bytes(int D, int F, int nh) { return mma_smem_bytes(D, F, nh); }

// dtype: 0 = float32, 1 = bfloat16 (x, y, weights and biases); madd and
// the LayerNorm parameters are float32. Dropout arguments as in
// unirec_layer_fwd. mma 1 runs the tensor-core body, which takes only what
// unirec_lastq_fwd_mma_takes admits, with x, madd and the six matmul
// weights 16-byte aligned; mma 0 the CUDA-core body. Returns a cudaError_t.
int unirec_lastq_fwd(int dtype, const void* x, const float* madd,
                     const void* wq, const void* bq, const void* wk,
                     const void* bk, const void* wv, const void* bv,
                     const void* wo, const void* bo, const float* g1,
                     const float* c1, const void* w1, const void* b1,
                     const void* w2, const void* b2, const float* g2,
                     const float* c2, void* y, int B, int Lp, int D, int F,
                     int nh, int qi, int act, int mma, float eps, unsigned seed,
                     unsigned t_attn, unsigned t_hidden, float inv_attn,
                     float inv_hidden, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr{seed, t_attn, t_hidden, inv_attn, inv_hidden};
  if (qi < 0 || qi >= Lp) return (int)cudaErrorInvalidValue;
  if (mma) {
    if (!mma_takes(dtype, Lp, D, F, nh)) return (int)cudaErrorInvalidValue;
    const void* w[12] = {wq, bq, wk, bk, wv, bv, wo, bo, w1, b1, w2, b2};
    const float* ln[4] = {g1, c1, g2, c2};
    return dispatch_launch_mma(D, nh, x, madd, w, ln, y, B, Lp, F, qi, act, eps, dr, s);
  }
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
