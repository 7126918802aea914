// ffn: the fused pointwise feed-forward y = act(x W1 + b1) W2 + b2,
// forward and backward, with the [T, F] inner activation kept on chip.
//
// Replaces the TPU kernels unirec_tpu/ops/ffn.py::_fwd_kernel and
// ::_bwd_kernel (launched by _call_fwd / _fused_ffn_bwd, public entry
// fused_ffn), with their rounding points (ffn.py:62-101):
//   forward  pre = x W1 (f32 sums) + b1, h = act(pre) in f32,
//            y = rnd(h) W2 (f32 sums) + b2, rounded to x's dtype
//   backward recompute pre and h; dh = (dy W2^T) * act'(pre) in f32;
//            dx = rnd(dh) W1^T; dW1 = x^T rnd(dh); db1 = sum dh;
//            dW2 = rnd(h)^T dy; db2 = sum dy (weight gradients in f32)
// where rnd rounds to x's dtype (the identity for f32).
//
// The TPU runs the backward's grid in order and carries dW1, db1, dW2, db2
// in resident VMEM blocks ("arbitrary", ffn.py:74-79). Hopper blocks run in
// no order, so the backward is a persistent grid (SMs x resident blocks):
// each block walks token tiles and adds into its own f32 slab, and the
// wrapper sums the slabs. No atomics, so the sums are deterministic. The
// TPU pads T to a multiple of its block with zero rows; here the last tile
// is ragged instead (a zero dy row adds nothing either way).
//
// Bound on an H100 (T = 1,638,400 tokens, D=64, F=128, bf16): the forward
// reads x (0.21 GB) and writes y (0.21 GB), 0.13 ms at 3.35 TB/s, against
// 54 GFLOP of products (0.05 ms on the bf16 tensor cores): bound by bytes;
// the backward reads x and dy and writes dx, 0.19 ms, against 134 GFLOP
// (0.14 ms): bound by bytes too.
//
// CUDA-core bodies (both directions in f32 and at widths the tensor-core
// bodies do not take). A block stages a tile of tokens in
// shared memory as f32 and computes the tile's activation there, never
// writing it out, reading the weights through L1/L2 (transposed copies for
// the products with W^T, so a warp's loads stay coalesced). The products
// run on the CUDA cores in f32 (common.cuh::mm_rows, colsum). They hold at
// most kFc = 128 columns of F at once: y (forward) and dx (backward) sum
// over the F chunks in an f32 [rows, D] buffer, and the row tile shrinks
// from 64 (forward) or 32 (backward) tokens as D grows, so shared memory
// does not grow with F and every D <= 2048 launches at any F (ffn_rows;
// ops/ffn.py::_rows holds a copy of the rule).
//
// bf16 backward at D <= 64 (ffn_bwd_mma_kernel): the CUDA-core backward
// spent 17.6 ms at 1.64M tokens on five f32 products (134 GFLOP) behind six
// barriers a 32-row tile, 93x its bound. Every product of the Pallas
// backward takes bf16 operands with f32 sums, which is what mma.sync
// m16n8k16 computes; only the order of the f32 sums differs. A persistent
// block of eight warps owns one chunk of at most kMmaFc = 128 columns of F
// (F / 128 chunks, so a block's weight-gradient sums fit its registers):
// its W1 and W2 columns stay in bf16 shared memory for the block's life,
// loaded once (the products with W^T read them through ldmatrix without a
// transposed copy), and tiles of 64 tokens of x and dy stream through a
// two-stage cp.async ring. Per tile: pre = X W1 + b1 and dY W2^T by MMA (a
// warp per 16 rows and half the chunk), h, dh and the db1 sums in f32
// registers, rnd(h) and rnd(dh) to shared memory as bf16; then dx = rnd(dh)
// W1^T by MMA, and dW1 += X^T rnd(dh) and dW2 += rnd(h)^T dY by MMA with
// ldmatrix.trans A fragments into f32 sums that stay in registers (32 + 32
// a thread) for the block's life and are written once into its slab. With
// one chunk the block writes dx in bf16; with several each writes its f32
// part and the wrapper sums the parts.
//
// bf16 forward at D <= 64 (ffn_fwd_mma_kernel, the backward's rule): the
// CUDA-core forward spends 4.75 ms at 1.64M tokens on an H100 (80GB HBM3,
// 700 W), 38x its bound, on f32
// scalar products with the weights read through L1/L2, an f32 token tile in
// shared memory, two barriers per F chunk and the activation written to
// shared memory and read back. Here a persistent grid of 8-warp blocks
// keeps W1 and W2 (one chunk of at most 128 columns of F) in bf16 shared
// memory for the block's life, and 128-token tiles of x arrive through a
// two-stage cp.async ring. A warp owns 16 rows: its x stays in registers as
// A fragments; for each 16 columns of F, pre = x W1 by MMA into f32
// registers, + b1, h = act(pre) in f32 on the accumulator fragments
// (act_pair), and the m16n8 accumulator pair is repacked in registers as
// the A fragment of y += rnd(h) W2 (the layout of C tiles n and n+1 is the
// layout of one 16-wide A tile), so h never touches shared memory. y's f32
// sums stay in registers across the F chunks; + b2, rounded, out through
// the strip's own x rows as 16-byte stores. The pre-activation is not
// rounded before act, as ffn.py:66 (unlike the layer kernels' _dense).
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 256;
constexpr int kFwdRows = 64;  // tokens per forward tile, at most
constexpr int kBwdRows = 32;  // tokens per backward tile, at most
constexpr int kFc = 128;      // columns of F the CUDA-core bodies hold at once
constexpr int kSmemLimit = 232448;

__host__ __device__ inline int fc_cols(int F) { return F < kFc ? F : kFc; }

// X [rows, D], H [rows, fc] and, with more than one F chunk, the f32 y sums
// [rows, D]
__host__ __device__ inline int fwd_smem_floats(int rows, int D, int F) {
  return rows * (D + 1) + rows * (fc_cols(F) + 1) + (F > kFc ? rows * (D + 1) : 0);
}

// X, DY [rows, D], P, DH [rows, fc] and, with more than one F chunk, the f32
// dx sums [rows, D]
__host__ __device__ inline int bwd_smem_floats(int rows, int D, int F) {
  return 2 * rows * (D + 1) + 2 * rows * (fc_cols(F) + 1) + (F > kFc ? rows * (D + 1) : 0);
}

// tokens per tile: the most, halving from kFwdRows or kBwdRows, whose
// shared memory fits a block; 0 if not even one row does
__host__ __device__ inline int ffn_rows(int bwd, int D, int F) {
  for (int r = bwd ? kBwdRows : kFwdRows; r >= 1; r /= 2)
    if (4 * (bwd ? bwd_smem_floats(r, D, F) : fwd_smem_floats(r, D, F)) <= kSmemLimit) return r;
  return 0;
}

__host__ __device__ inline int slab_floats(int D, int F) {
  return D * F + F + F * D + D;  // dW1, db1, dW2, db2
}

template <typename T>
__device__ void stage_rows(float* dst, int ld, const T* __restrict__ src,
                           int r0, int n, int D) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x)
    dst[(i / D) * ld + i % D] = to_f<T>(src[(size_t)r0 * D + i]);
}

// slab[k * lds + n] += sum_r A(r, k) * Bm[r * ldb + n] over r < rows: a
// weight gradient's block of K rows and N columns in this block's slab
template <typename FA>
__device__ void wgrad_block(FA a, int K, const float* Bm, int ldb, int N, int rows,
                            float* slab, int lds) {
  for (int w = threadIdx.x; w < K * N; w += blockDim.x) {
    const int k = w / N, n = w % N;
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc = fmaf(a(r, k), Bm[r * ldb + n], acc);
    slab[k * lds + n] += acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2,
               const T* __restrict__ b2, T* __restrict__ y, int Tn, int D,
               int F, int act, int rows) {
  extern __shared__ float smem[];
  const int ldx = D + 1, ldh = fc_cols(F) + 1;
  float* X = smem;             // [rows, D]
  float* Hs = X + rows * ldx;  // [rows, fc]  rnd(act(pre)) of one F chunk
  float* Y = Hs + rows * ldh;  // [rows, D]   f32 sums of y over the chunks
  const int r0 = blockIdx.x * rows;
  const int n = min(rows, Tn - r0);

  stage_rows<T>(X, ldx, x, r0, n, D);
  // each thread owns the same (r, c) outputs in every chunk
  for (int f0 = 0; f0 < F; f0 += kFc) {
    const int nf = min(kFc, F - f0);
    const bool first = f0 == 0, last = f0 + kFc >= F;
    __syncthreads();
    mm_rows<T, 4>(X, ldx, n, D, w1 + f0, F, 1, nf, [&](int r, int c, float acc) {
      Hs[r * ldh + c] = rnd<T>(activate(act, acc + to_f<T>(b1[f0 + c])));
    });
    __syncthreads();
    mm_rows<T, 4>(Hs, ldh, n, nf, w2 + (size_t)f0 * D, D, 1, D, [&](int r, int c, float acc) {
      const float s = first ? acc : Y[r * ldx + c] + acc;
      if (last)
        y[(size_t)(r0 + r) * D + c] = from_f<T>(s + to_f<T>(b2[c]));
      else
        Y[r * ldx + c] = s;
    });
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ w1t, const T* __restrict__ w2t,
               T* __restrict__ dx, float* __restrict__ slabs, int Tn, int D,
               int F, int act, int rows) {
  extern __shared__ float smem[];
  const int ldx = D + 1, ldh = fc_cols(F) + 1;
  float* X = smem;               // [rows, D]
  float* DY = X + rows * ldx;    // [rows, D]
  float* P = DY + rows * ldx;    // [rows, fc]  pre, then rnd(h), of one F chunk
  float* DH = P + rows * ldh;    // [rows, fc]  dh, then rnd(dh)
  float* DX = DH + rows * ldh;   // [rows, D]   f32 sums of dx over the chunks
  float* slab = slabs + (size_t)blockIdx.x * slab_floats(D, F);
  float* dW1 = slab;
  float* db1 = dW1 + D * F;
  float* dW2 = db1 + F;
  float* db2 = dW2 + F * D;

  for (int i = threadIdx.x; i < slab_floats(D, F); i += blockDim.x) slab[i] = 0.0f;
  const int tiles = (Tn + rows - 1) / rows;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = t * rows;
    const int n = min(rows, Tn - r0);
    stage_rows<T>(X, ldx, x, r0, n, D);
    stage_rows<T>(DY, ldx, dy, r0, n, D);
    __syncthreads();
    colsum([&](int r, int c) { return DY[r * ldx + c]; }, D, n, db2);
    // each thread owns the same (r, c) dx sums in every chunk
    for (int f0 = 0; f0 < F; f0 += kFc) {
      const int nf = min(kFc, F - f0);
      const bool first = f0 == 0, last = f0 + kFc >= F;
      mm_rows<T, 4>(X, ldx, n, D, w1 + f0, F, 1, nf, [&](int r, int c, float acc) {
        P[r * ldh + c] = acc + to_f<T>(b1[f0 + c]);
      });
      __syncthreads();
      // dh = (dy W2^T) * act'(pre); W2^T is the contiguous [D, F] copy
      mm_rows<T, 4>(DY, ldx, n, D, w2t + f0, F, 1, nf, [&](int r, int c, float acc) {
        DH[r * ldh + c] = acc * activate_grad(act, P[r * ldh + c]);
      });
      __syncthreads();
      colsum([&](int r, int c) { return DH[r * ldh + c]; }, nf, n, db1 + f0);
      __syncthreads();
      for (int i = threadIdx.x; i < n * nf; i += blockDim.x) {
        const int o = (i / nf) * ldh + i % nf;
        DH[o] = rnd<T>(DH[o]);
        P[o] = rnd<T>(activate(act, P[o]));
      }
      __syncthreads();
      // dx = rnd(dh) W1^T; W1^T is the contiguous [F, D] copy
      mm_rows<T, 4>(DH, ldh, n, nf, w1t + (size_t)f0 * D, D, 1, D, [&](int r, int c, float acc) {
        const float s = first ? acc : DX[r * ldx + c] + acc;
        if (last)
          dx[(size_t)(r0 + r) * D + c] = from_f<T>(s);
        else
          DX[r * ldx + c] = s;
      });
      wgrad_block([&](int r, int kk) { return X[r * ldx + kk]; }, D, DH, ldh, nf, n,
                  dW1 + f0, F);
      wgrad_block([&](int r, int kk) { return P[r * ldh + kk]; }, nf, DY, ldx, D, n,
                  dW2 + (size_t)f0 * D, D);
      __syncthreads();
    }
  }
}

// ------------------------------------- bf16 tensor-core backward (D <= 64)
// See the note at the top of this file.
constexpr int kMmaRows = 64;   // tokens per tile: four 16-row strips
constexpr int kMmaFc = 128;    // columns of F a block owns, at most
constexpr int kMmaMaxD = 64;   // ops/ffn.py::MMA_MAX_D
constexpr int kMmaWarps = 8;

__host__ __device__ inline bool mma_takes(int dtype, int D, int F) {
  return dtype == 1 && D >= 16 && D <= kMmaMaxD && D % 16 == 0 && F >= 16 && F % 16 == 0;
}

__host__ __device__ inline int mma_chunks(int F) { return (F + kMmaFc - 1) / kMmaFc; }

// W1 [D][fc + 8] and W2 [fc][D + 8] bf16 (fc = min(F, kMmaFc)); two stages
// of X and DY [64][D + 8]; rnd(h) and rnd(dh) [64][fc + 8]; then f32 b1
// [kMmaFc], the db1 parts of the four strips [4][kMmaFc], db1 [kMmaFc] and
// db2 [kMmaMaxD] (the +8 keeps ldmatrix free of bank conflicts)
__host__ __device__ inline int mma_smem_bytes(int D, int F) {
  const int fc = F < kMmaFc ? F : kMmaFc;
  return 2 * (D * (fc + 8) + fc * (D + 8) + 2 * 2 * kMmaRows * (D + 8) +
              2 * kMmaRows * (fc + 8)) +
         4 * (kMmaFc + 4 * kMmaFc + kMmaFc + kMmaMaxD);
}

// dxp: [chunks, Tn, D] f32 dx parts when F has more than one chunk, else
// unused (dx is written in bf16)
template <int D16>
__global__ void __launch_bounds__(32 * kMmaWarps, 1)
ffn_bwd_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                   const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
                   const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ dxp, float* __restrict__ slabs, int Tn, int F,
                   int act) {
  constexpr int D = D16 * 16, LDX = D + 8, D8 = D / 8;
  constexpr int DH16 = (D16 + 1) / 2;  // 16-column groups of dx per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nch = mma_chunks(F), chunk = blockIdx.x % nch, per = gridDim.x / nch;
  const int f0 = chunk * kMmaFc, fc = min(kMmaFc, F - f0), fcmax = min(F, kMmaFc);
  const int LDF = fcmax + 8;
  __nv_bfloat16* W1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [D][LDF]
  __nv_bfloat16* W2s = W1s + D * LDF;                                 // [fc][LDX]
  __nv_bfloat16* XY = W2s + fcmax * LDX;        // [2 stages][X, DY][64][LDX]
  __nv_bfloat16* Hs = XY + 2 * 2 * kMmaRows * LDX;  // [64][LDF] rnd(h)
  __nv_bfloat16* DHs = Hs + kMmaRows * LDF;         // [64][LDF] rnd(dh)
  float* b1s = reinterpret_cast<float*>(DHs + kMmaRows * LDF);  // [kMmaFc]
  float* db1p = b1s + kMmaFc;                   // [4][kMmaFc] per-strip sums
  float* db1s = db1p + 4 * kMmaFc;              // [kMmaFc]
  float* db2s = db1s + kMmaFc;                  // [kMmaMaxD]
  auto Xs = [&](int st) { return XY + st * 2 * kMmaRows * LDX; };
  auto DYs = [&](int st) { return XY + (st * 2 + 1) * kMmaRows * LDX; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int strip = warp & 3, half = warp >> 2, i0 = strip * 16;
  const int tiles = (Tn + kMmaRows - 1) / kMmaRows;

  auto load_tile = [&](int tile, int st) {
    const int r0 = tile * kMmaRows;
    for (int w = threadIdx.x; w < 2 * kMmaRows * D8; w += blockDim.x) {
      const int which = w / (kMmaRows * D8), i = (w / D8) % kMmaRows, c = w % D8;
      const bool in = r0 + i < Tn;
      const __nv_bfloat16* src = (which ? dy : x) + (size_t)(in ? r0 + i : 0) * D + c * 8;
      cp_async16((which ? DYs(st) : Xs(st)) + i * LDX + c * 8, src, in);
    }
  };
  // this chunk's weights, once: W1[:, f0:f0+fc] and W2[f0:f0+fc, :]
  for (int w = threadIdx.x; w < D * (fc / 8); w += blockDim.x) {
    const int d = w / (fc / 8), c = w % (fc / 8);
    cp_async16(W1s + d * LDF + c * 8, w1 + (size_t)d * F + f0 + c * 8, true);
  }
  for (int w = threadIdx.x; w < fc * D8; w += blockDim.x) {
    const int f = w / D8, c = w % D8;
    cp_async16(W2s + f * LDX + c * 8, w2 + (size_t)(f0 + f) * D + c * 8, true);
  }
  for (int i = threadIdx.x; i < kMmaFc; i += blockDim.x) {
    b1s[i] = i < fc ? __bfloat162float(b1[f0 + i]) : 0.0f;
    db1s[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < kMmaMaxD; i += blockDim.x) db2s[i] = 0.0f;
  int tile = blockIdx.x / nch;
  if (tile < tiles) load_tile(tile, 0);
  cp_async_commit();

  // the block's weight-gradient sums: dW1 rows 16 * strip.. (columns of this
  // warp's half of the chunk) and dW2 rows 16 * warp.. (all D columns)
  float gw1[8][4], gw2[D8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) gw1[n][0] = gw1[n][1] = gw1[n][2] = gw1[n][3] = 0.0f;
#pragma unroll
  for (int n = 0; n < D8; ++n) gw2[n][0] = gw2[n][1] = gw2[n][2] = gw2[n][3] = 0.0f;

  for (int st = 0; tile < tiles; tile += per, st ^= 1) {
    if (tile + per < tiles) load_tile(tile + per, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, first, the weights) have landed
    __syncthreads();
    const __nv_bfloat16* X = Xs(st);
    const __nv_bfloat16* DY = DYs(st);
    const int r0 = tile * kMmaRows;

    // pre = X W1 + b1 and dz = dY W2^T for this warp's strip and half chunk
    {
      float pre[8][4], dz[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pre[n][e] = dz[n][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < D16; ++kc) {
        uint32_t ax[4], ad[4];
        frag_a(ax, X, LDX, i0, kc * 16, lane);
        frag_a(ad, DY, LDX, i0, kc * 16, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int c0 = (half * 4 + np) * 16;
          if (c0 >= fc) break;
          uint32_t bw[4], bt[4];
          frag_b_t(bw, W1s, LDF, c0, kc * 16, lane);
          frag_b(bt, W2s, LDX, c0, kc * 16, lane);
          mma_bf16(pre[2 * np], ax, bw[0], bw[1]);
          mma_bf16(pre[2 * np + 1], ax, bw[2], bw[3]);
          mma_bf16(dz[2 * np], ad, bt[0], bt[1]);
          mma_bf16(dz[2 * np + 1], ad, bt[2], bt[3]);
        }
      }
      // h = act(pre + b1) into pre and dh = dz act'(pre + b1) into dz, in
      // f32, with the activation fixed at compile time inside the loops
      with_act(act, [&](auto tag) {
        constexpr int A = decltype(tag)::value;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float h, d;
            act_pair<A>(pre[n][e] + b1s[(half * 8 + n) * 8 + 2 * t + (e & 1)], h, d);
            pre[n][e] = h;
            dz[n][e] *= d;
          }
      });
      // the column sums of dh over the strip's rows; rnd(h), rnd(dh) to
      // shared memory
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = (half * 8 + n) * 8 + 2 * t;
        if (c >= fc) break;
        float cs[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) cs[e] = dz[n][e] + dz[n][2 + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + g + r * 8;
          *reinterpret_cast<__nv_bfloat162*>(Hs + i * LDF + c) =
              __floats2bfloat162_rn(pre[n][2 * r], pre[n][2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(DHs + i * LDF + c) =
              __floats2bfloat162_rn(dz[n][2 * r], dz[n][2 * r + 1]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 4);
          cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 8);
          cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 16);
        }
        if (g == 0) {
          db1p[strip * kMmaFc + c] = cs[0];
          db1p[strip * kMmaFc + c + 1] = cs[1];
        }
      }
    }
    __syncthreads();

    // dx = rnd(dh) W1^T for this warp's strip and half of D
    {
      float ax[2 * DH16][4];
#pragma unroll
      for (int n = 0; n < 2 * DH16; ++n) ax[n][0] = ax[n][1] = ax[n][2] = ax[n][3] = 0.0f;
      for (int kc = 0; kc < fc / 16; ++kc) {
        uint32_t a[4];
        frag_a(a, DHs, LDF, i0, kc * 16, lane);
#pragma unroll
        for (int np = 0; np < DH16; ++np) {
          const int d0 = (half * DH16 + np) * 16;
          if (d0 >= D) break;
          uint32_t b[4];
          frag_b(b, W1s, LDF, d0, kc * 16, lane);
          mma_bf16(ax[2 * np], a, b[0], b[1]);
          mma_bf16(ax[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * DH16; ++n) {
        const int d = half * DH16 * 16 + n * 8 + 2 * t;
        if (d >= D) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r0 + i0 + g + r * 8;
          if (i >= Tn) continue;
          if (nch == 1)
            *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)i * D + d) =
                __floats2bfloat162_rn(ax[n][2 * r], ax[n][2 * r + 1]);
          else
            *reinterpret_cast<float2*>(dxp + ((size_t)chunk * Tn + i) * D + d) =
                make_float2(ax[n][2 * r], ax[n][2 * r + 1]);
        }
      }
    }
    // dW1 += X^T rnd(dh): rows 16 * strip of D, this warp's half of the chunk
    if (strip < D16) {
#pragma unroll
      for (int kc = 0; kc < kMmaRows / 16; ++kc) {
        uint32_t a[4];
        frag_a_t(a, X, LDX, strip * 16, kc * 16, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int c0 = (half * 4 + np) * 16;
          if (c0 >= fc) break;
          uint32_t b[4];
          frag_b_t(b, DHs, LDF, c0, kc * 16, lane);
          mma_bf16(gw1[2 * np], a, b[0], b[1]);
          mma_bf16(gw1[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    // dW2 += rnd(h)^T dY: rows 16 * warp of the chunk, all D columns
    if (warp * 16 < fc) {
#pragma unroll
      for (int kc = 0; kc < kMmaRows / 16; ++kc) {
        uint32_t a[4];
        frag_a_t(a, Hs, LDF, warp * 16, kc * 16, lane);
#pragma unroll
        for (int np = 0; np < D16; ++np) {
          uint32_t b[4];
          frag_b_t(b, DY, LDX, np * 16, kc * 16, lane);
          mma_bf16(gw2[2 * np], a, b[0], b[1]);
          mma_bf16(gw2[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    // db1 += the four strips' sums (one order); db2 += sum dy (chunk 0)
    for (int c = threadIdx.x; c < fc; c += blockDim.x)
      db1s[c] += ((db1p[c] + db1p[kMmaFc + c]) + db1p[2 * kMmaFc + c]) + db1p[3 * kMmaFc + c];
    if (chunk == 0)
      for (int c = threadIdx.x; c < D; c += blockDim.x) {
        float s = 0.0f;
        for (int i = 0; i < kMmaRows; ++i) s += __bfloat162float(DY[i * LDX + c]);
        db2s[c] += s;
      }
    __syncthreads();  // this stage and rnd(h), rnd(dh) are consumed
  }
  cp_async_wait<0>();

  // the sums into this block's slab (zeroed by the caller): dW1 [D, F],
  // db1 [F], dW2 [F, D], db2 [D]
  float* slab = slabs + (size_t)blockIdx.x * slab_floats(D, F);
  float* dW1 = slab;
  float* db1 = dW1 + D * F;
  float* dW2 = db1 + F;
  float* db2 = dW2 + F * D;
  if (strip < D16) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = (half * 8 + n) * 8 + 2 * t;
      if (c >= fc) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = strip * 16 + g + r * 8;
        dW1[(size_t)d * F + f0 + c] = gw1[n][2 * r];
        dW1[(size_t)d * F + f0 + c + 1] = gw1[n][2 * r + 1];
      }
    }
  }
  if (warp * 16 < fc) {
#pragma unroll
    for (int n = 0; n < D8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int f = f0 + warp * 16 + g + r * 8, d = n * 8 + 2 * t;
        dW2[(size_t)f * D + d] = gw2[n][2 * r];
        dW2[(size_t)f * D + d + 1] = gw2[n][2 * r + 1];
      }
  }
  for (int c = threadIdx.x; c < fc; c += blockDim.x) db1[f0 + c] = db1s[c];
  if (chunk == 0)
    for (int c = threadIdx.x; c < D; c += blockDim.x) db2[c] = db2s[c];
}

// --------------------------------------- bf16 tensor-core forward (D <= 64)
// See the note at the top of this file. Same rule as the backward
// (mma_takes); the weights of one chunk of at most kMmaFc columns of F stay
// in shared memory, loaded once when F has one chunk, and again for every
// tile when it has several (widths no path runs).
constexpr int kFwdMmaWarps = 8;
constexpr int kFwdMmaRows = 16 * kFwdMmaWarps;  // tokens per tile: a strip a warp

// W1 [D][fc + 8] and W2 [fc][D + 8] bf16 (fc = min(F, kMmaFc)); two stages
// of X [128][D + 8] bf16; b1 of the chunk, f32 [kMmaFc]
__host__ __device__ inline int fwd_mma_smem_bytes(int D, int F) {
  const int fc = F < kMmaFc ? F : kMmaFc;
  return 2 * (D * (fc + 8) + fc * (D + 8) + 2 * kFwdMmaRows * (D + 8)) + 4 * kMmaFc;
}

template <int D16>
__global__ void __launch_bounds__(32 * kFwdMmaWarps, 2)
ffn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                   const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ y, int Tn,
                   int F, int act) {
  constexpr int D = D16 * 16, LDX = D + 8, D8 = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fcmax = min(F, kMmaFc), LDF = fcmax + 8, nch = mma_chunks(F);
  __nv_bfloat16* W1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [D][LDF]
  __nv_bfloat16* W2s = W1s + D * LDF;                                 // [fc][LDX]
  __nv_bfloat16* Xr = W2s + fcmax * LDX;              // [2 stages][128][LDX]
  float* b1s = reinterpret_cast<float*>(Xr + 2 * kFwdMmaRows * LDX);  // [kMmaFc]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int i0 = warp * 16;
  const int tiles = (Tn + kFwdMmaRows - 1) / kFwdMmaRows;

  auto load_tile = [&](int tile, int st) {
    const int r0 = tile * kFwdMmaRows;
    __nv_bfloat16* dst = Xr + st * kFwdMmaRows * LDX;
    for (int w = threadIdx.x; w < kFwdMmaRows * D8; w += blockDim.x) {
      const int i = w / D8, c = w % D8;
      const bool in = r0 + i < Tn;
      cp_async16(dst + i * LDX + c * 8, x + (size_t)(in ? r0 + i : 0) * D + c * 8, in);
    }
  };
  // chunk ch's weights W1[:, f0:f0+fc], W2[f0:f0+fc, :] and b1[f0:f0+fc]
  auto load_chunk = [&](int ch) {
    const int f0 = ch * kMmaFc, fc = min(kMmaFc, F - f0);
    for (int w = threadIdx.x; w < D * (fc / 8); w += blockDim.x) {
      const int d = w / (fc / 8), c = w % (fc / 8);
      cp_async16(W1s + d * LDF + c * 8, w1 + (size_t)d * F + f0 + c * 8, true);
    }
    for (int w = threadIdx.x; w < fc * D8; w += blockDim.x) {
      const int f = w / D8, c = w % D8;
      cp_async16(W2s + f * LDX + c * 8, w2 + (size_t)(f0 + f) * D + c * 8, true);
    }
    for (int i = threadIdx.x; i < kMmaFc; i += blockDim.x)
      b1s[i] = i < fc ? __bfloat162float(b1[f0 + i]) : 0.0f;
  };
  // this thread's output columns' b2
  float b2r[D8][2];
#pragma unroll
  for (int n = 0; n < D8; ++n) {
    b2r[n][0] = __bfloat162float(b2[n * 8 + 2 * t]);
    b2r[n][1] = __bfloat162float(b2[n * 8 + 2 * t + 1]);
  }
  if (nch == 1) load_chunk(0);
  int tile = blockIdx.x;
  if (tile < tiles) load_tile(tile, 0);
  cp_async_commit();

  for (int st = 0; tile < tiles; tile += gridDim.x, st ^= 1) {
    if (tile + (int)gridDim.x < tiles) load_tile(tile + gridDim.x, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, first, the weights) have landed
    __syncthreads();
    __nv_bfloat16* X = Xr + st * kFwdMmaRows * LDX;
    // the strip's x as A fragments, held for every F column
    uint32_t ax[D16][4];
#pragma unroll
    for (int kc = 0; kc < D16; ++kc) frag_a(ax[kc], X, LDX, i0, kc * 16, lane);
    float acc[D8][4];
#pragma unroll
    for (int n = 0; n < D8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) {  // every warp is past the previous chunk's weights
        __syncthreads();
        load_chunk(ch);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      const int fc = min(kMmaFc, F - ch * kMmaFc);
      with_act(act, [&](auto tag) {
        constexpr int A = decltype(tag)::value;
        // 16 columns of F at a time: pre = x W1 + b1 in f32 registers, h =
        // act(pre), rnd(h) repacked in registers as the A fragment of y += h W2
        for (int kc = 0; kc < fc / 16; ++kc) {
          float pre[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int kd = 0; kd < D16; ++kd) {
            uint32_t bw[4];
            frag_b_t(bw, W1s, LDF, kc * 16, kd * 16, lane);
            mma_bf16(pre[0], ax[kd], bw[0], bw[1]);
            mma_bf16(pre[1], ax[kd], bw[2], bw[3]);
          }
          float h[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float d;
              act_pair<A>(pre[n][e] + b1s[kc * 16 + n * 8 + 2 * t + (e & 1)], h[n][e], d);
            }
          // A fragment: a0 = (g, 2t..), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..),
          // a3 = (g + 8, 2t + 8..): accumulator tile n = 0 gives columns
          // 2t.., tile 1 columns 2t + 8..
          const uint32_t ah[4] = {pack_bf16(h[0][0], h[0][1]), pack_bf16(h[0][2], h[0][3]),
                                  pack_bf16(h[1][0], h[1][1]), pack_bf16(h[1][2], h[1][3])};
#pragma unroll
          for (int np = 0; np < D16; ++np) {
            uint32_t b[4];
            frag_b_t(b, W2s, LDX, np * 16, kc * 16, lane);
            mma_bf16(acc[2 * np], ah, b[0], b[1]);
            mma_bf16(acc[2 * np + 1], ah, b[2], b[3]);
          }
        }
      });
    }
    // y = rnd(sum + b2) through the strip's own X rows (this warp alone
    // reads them), then out as 16-byte stores
    __syncwarp();
#pragma unroll
    for (int n = 0; n < D8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(X + (i0 + g + r * 8) * LDX + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * r] + b2r[n][0], acc[n][2 * r + 1] + b2r[n][1]);
    __syncwarp();
    const int r0 = tile * kFwdMmaRows + i0;
    for (int c = lane; c < 16 * D8; c += 32) {
      const int i = c / D8, cc = c % D8;
      if (r0 + i < Tn)
        *reinterpret_cast<uint4*>(y + (size_t)(r0 + i) * D + cc * 8) =
            *reinterpret_cast<const uint4*>(X + (i0 + i) * LDX + cc * 8);
    }
    __syncthreads();  // this stage is consumed before the next copy into it
  }
  cp_async_wait<0>();
}

template <int D16>
int launch_fwd_mma_d(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* y, int Tn, int F, int act, cudaStream_t stream) {
  const int smem = fwd_mma_smem_bytes(D16 * 16, F);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_mma_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ffn_fwd_mma_kernel<D16>,
                                                           32 * kFwdMmaWarps, smem)) != cudaSuccess)
    return (int)err;
  const int tiles = (Tn + kFwdMmaRows - 1) / kFwdMmaRows;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (grid > tiles) grid = tiles;
  if (grid < 1) return (int)cudaSuccess;  // no tokens
  ffn_fwd_mma_kernel<D16><<<grid, 32 * kFwdMmaWarps, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1, (const __nv_bfloat16*)b1,
      (const __nv_bfloat16*)w2, (const __nv_bfloat16*)b2, (__nv_bfloat16*)y, Tn, F, act);
  return (int)cudaGetLastError();
}

template <int D16>
int mma_blocks_d(int Tn, int F) {
  const int smem = mma_smem_bytes(D16 * 16, F);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_mma_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ffn_bwd_mma_kernel<D16>,
                                                           32 * kMmaWarps, smem)) != cudaSuccess)
    return -(int)err;
  const int nch = mma_chunks(F), tiles = (Tn + kMmaRows - 1) / kMmaRows;
  int per = sms * (per_sm > 0 ? per_sm : 1) / nch;
  if (per < 1) per = 1;
  if (per > tiles) per = tiles;
  return nch * per;
}

template <int D16>
int launch_bwd_mma_d(const void* x, const void* dy, const void* w1, const void* b1,
                     const void* w2, void* dx, float* dxp, float* slabs, int nblocks, int Tn,
                     int F, int act, cudaStream_t stream) {
  const int smem = mma_smem_bytes(D16 * 16, F);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_mma_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_mma_kernel<D16><<<nblocks, 32 * kMmaWarps, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (const __nv_bfloat16*)w1,
      (const __nv_bfloat16*)b1, (const __nv_bfloat16*)w2, (__nv_bfloat16*)dx, dxp, slabs, Tn,
      F, act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* y, int Tn, int D, int F, int act,
               cudaStream_t stream) {
  const int rows = ffn_rows(0, D, F);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * fwd_smem_floats(rows, D, F);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (Tn + rows - 1) / rows;
  ffn_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
      (T*)y, Tn, D, F, act, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* w1, const void* b1,
               const void* w1t, const void* w2t, void* dx, float* slabs,
               int nblocks, int Tn, int D, int F, int act, cudaStream_t stream) {
  const int rows = ffn_rows(1, D, F);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * bwd_smem_floats(rows, D, F);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_kernel<T><<<nblocks, kThreads, smem, stream>>>(
      (const T*)x, (const T*)dy, (const T*)w1, (const T*)b1, (const T*)w1t,
      (const T*)w2t, (T*)dx, slabs, Tn, D, F, act, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks(int Tn, int D, int F) {
  const int rows = ffn_rows(1, D, F);
  if (rows == 0) return -(int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * bwd_smem_floats(rows, D, F);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, ffn_bwd_kernel<T>, kThreads, smem)) != cudaSuccess)
    return -(int)err;
  const int tiles = (Tn + rows - 1) / rows;
  const int nb = sms * (per_sm > 0 ? per_sm : 1);
  return nb < tiles ? nb : tiles;
}

}  // namespace

extern "C" {

// tokens per tile of the CUDA-core forward (bwd 0) or backward (bwd 1) at
// widths D, F (0: no tile fits), and that tile's bytes of dynamic shared
// memory (ops/ffn.py::_rows and _smem_bytes hold copies of the rule)
int unirec_ffn_rows(int bwd, int D, int F) { return ffn_rows(bwd, D, F); }

int unirec_ffn_smem_bytes(int bwd, int rows, int D, int F) {
  return 4 * (bwd ? bwd_smem_floats(rows, D, F) : fwd_smem_floats(rows, D, F));
}

// 1 when the backward runs the bf16 tensor-core body (dtype 1, D a multiple
// of 16 up to 64, F a multiple of 16; ops/ffn.py::_bwd_body holds a copy of
// the rule), and its bytes of dynamic shared memory
int unirec_ffn_bwd_mma_takes(int dtype, int D, int F) { return (int)mma_takes(dtype, D, F); }

int unirec_ffn_bwd_mma_smem_bytes(int D, int F) { return mma_smem_bytes(D, F); }

// the bf16 tensor-core forward's bytes of dynamic shared memory; it runs
// where unirec_ffn_bwd_mma_takes says so (ops/ffn.py::_fwd_body and
// _fwd_mma_smem_bytes hold copies)
int unirec_ffn_fwd_mma_smem_bytes(int D, int F) { return fwd_mma_smem_bytes(D, F); }

// The backward's persistent grid for Tn tokens, or minus a cudaError_t: the
// CUDA-core body's (SMs x resident blocks per SM, at most one block per
// tile), or, where unirec_ffn_bwd_mma_takes says so, the tensor-core body's
// (the same number spread over the F chunks, a multiple of their count)
int unirec_ffn_bwd_blocks(int dtype, int Tn, int D, int F) {
  if (mma_takes(dtype, D, F)) {
    switch (D / 16) {
      case 1: return mma_blocks_d<1>(Tn, F);
      case 2: return mma_blocks_d<2>(Tn, F);
      case 3: return mma_blocks_d<3>(Tn, F);
      case 4: return mma_blocks_d<4>(Tn, F);
    }
  }
  if (dtype == 0) return blocks<float>(Tn, D, F);
  if (dtype == 1) return blocks<__nv_bfloat16>(Tn, D, F);
  return -(int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (x, y and the weights, all contiguous;
// w1 [D, F], w2 [F, D] in the flax layout). act: an index of
// ops/ffn.py::ACTS. mma 1 runs the bf16 tensor-core body, which takes only
// what unirec_ffn_bwd_mma_takes admits (x, w1, w2 and y 16-byte aligned);
// mma 0 the CUDA-core body, which takes every dtype and width. Returns a
// cudaError_t.
int unirec_ffn_fwd(int dtype, const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* y, int Tn, int D, int F,
                   int act, int mma, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mma) {
    if (!mma_takes(dtype, D, F)) return (int)cudaErrorInvalidValue;
    switch (D / 16) {
      case 1: return launch_fwd_mma_d<1>(x, w1, b1, w2, b2, y, Tn, F, act, s);
      case 2: return launch_fwd_mma_d<2>(x, w1, b1, w2, b2, y, Tn, F, act, s);
      case 3: return launch_fwd_mma_d<3>(x, w1, b1, w2, b2, y, Tn, F, act, s);
      case 4: return launch_fwd_mma_d<4>(x, w1, b1, w2, b2, y, Tn, F, act, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch_fwd<float>(x, w1, b1, w2, b2, y, Tn, D, F, act, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w1, b1, w2, b2, y, Tn, D, F, act, s);
  return (int)cudaErrorInvalidValue;
}

// slabs: [nblocks, D*F + F + F*D + D] f32 (dW1, db1, dW2, db2). The
// CUDA-core body takes w1t [F, D] and w2t [D, F], contiguous transposes of
// w1 and w2, and each block zeroes and fills its own slab. The tensor-core
// body (where unirec_ffn_bwd_mma_takes says so) ignores w1t and w2t, takes
// zeroed slabs, each block filling its F chunk's entries, and, with more
// than one chunk (F > 128), dxp [F chunks, Tn, D] f32 for the dx parts, dx
// being left to the caller. x, dy, w1 and w2 16-byte aligned. Returns a
// cudaError_t.
int unirec_ffn_bwd(int dtype, const void* x, const void* dy, const void* w1,
                   const void* b1, const void* w2, const void* w1t, const void* w2t,
                   void* dx, float* dxp, float* slabs, int nblocks, int Tn, int D, int F,
                   int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  if (mma_takes(dtype, D, F)) {
    if (nblocks % mma_chunks(F) != 0 || (mma_chunks(F) > 1 && dxp == nullptr))
      return (int)cudaErrorInvalidValue;
    switch (D / 16) {
      case 1: return launch_bwd_mma_d<1>(x, dy, w1, b1, w2, dx, dxp, slabs, nblocks, Tn, F, act, s);
      case 2: return launch_bwd_mma_d<2>(x, dy, w1, b1, w2, dx, dxp, slabs, nblocks, Tn, F, act, s);
      case 3: return launch_bwd_mma_d<3>(x, dy, w1, b1, w2, dx, dxp, slabs, nblocks, Tn, F, act, s);
      case 4: return launch_bwd_mma_d<4>(x, dy, w1, b1, w2, dx, dxp, slabs, nblocks, Tn, F, act, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return launch_bwd<float>(x, dy, w1, b1, w1t, w2t, dx, slabs, nblocks, Tn, D,
                             F, act, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, dy, w1, b1, w1t, w2t, dx, slabs, nblocks,
                                     Tn, D, F, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
