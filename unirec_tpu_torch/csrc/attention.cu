// attention: short-sequence fused attention, forward and backward, with
// in-kernel dropout on the attention probabilities.
//
// Replaces the TPU kernels unirec_tpu/ops/attention.py::_fused_fwd_kernel
// and ::_fused_bwd_kernel (launched by _fused_call / _fused_attention_bwd,
// public entry fused_attention):
//   forward  S = Q K^T (f32 sums of input-dtype values) * scale + mask
//            -> f32 softmax y -> dropout z -> O = rnd(z) V
//   backward recompute S and y, replay the dropout mask, dZ = dO V^T,
//            dy = dropout(dZ), ds = rnd(y * (dy - sum(dy * y))),
//            dV = rnd(z)^T dO, dQ = ds K * scale, dK = ds^T Q * scale
// rounding to the input dtype exactly where the Pallas kernels cast
// (attention.py:213, :250-257, :296-308).
//
// Layout: q, k, v, dO and the outputs are [B, H, L, hd] tensors addressed
// through strides (b, h, row; the last axis contiguous), so the [B, L, H*hd]
// projections feed the kernel without a transposed copy and the outputs are
// written in [B, L, H, hd] order. The additive mask is [B, Hm, L, L] f32
// with Hm = 1 or H. The TPU wrapper pads L to a multiple of 8 and bans the
// padded keys with -1e30, which gives them probability exactly 0; the port
// does not pad, which leaves every real row's arithmetic the same.
//
// Dropout: the TPU draws on its hardware PRNG per grid program; here an
// element (query row i, key j) of head h of example b is kept iff
// philox_bits(seed, h, b0 + b, i * L + j) >= thresh (common.cuh), b0 the
// global index of the call's first example; it depends on no launch shape,
// so the backward replays the forward's mask without storing it.
//
// Bound on an H100 (B=32,768, H=2, L=50, hd=32, bf16, mask [B,1,L,L] f32):
// the forward reads q, k, v (0.63 GB) and the 0.33 GB mask and writes 0.21
// GB, about 0.35 ms at 3.35 TB/s, against 21 GFLOP of products (0.02 ms on
// the bf16 tensor cores): bound by bytes. Design: one block per (example,
// head) stages K and V in shared memory as f32 and walks the query rows in
// tiles of kRows, so only q, k, v, the mask and the output cross device
// memory, as in the TPU kernel; the products run on the CUDA cores in f32.
// The backward keeps dK and dV as f32 sums in shared memory over the tiles
// and writes each output once.
//
// Long sequences and wide heads. Whole K and V (and their f32 gradients)
// fit a block's shared memory only up to L = 285 at head width 32, while
// the JAX gate takes L <= 512 at any head width. Beyond the whole-sequence
// kernels' reach the tiled pair runs instead: the query tile's score rows
// stay in shared memory as before (so the softmax is the same exact
// two-pass one), but K and V stream through a tile of kKeys rows, the
// head width through chunks of at most kDc = 128 columns (Q, dO, the dQ
// and output sums and the K, V tiles alike), the output row accumulates in
// shared memory one column chunk at a time, and the backward sums dK and dV
// in an f32 scratch in device memory that the block owns ([B*H, L, hd]
// each, zeroed by the block). A score's f32 sum is carried across the
// column chunks and takes the scale and mask after the last one, so each
// sum runs over the same terms in the same order as in the whole-sequence
// kernels, and these two CUDA-core bodies give bit-identical results where
// both fit. Shared memory no longer grows with the head width: every L <=
// 512 runs at every head width (213,888 bytes for the backward at L = 512).
//
// bf16 forward at L <= 64, hd <= 64 (attn_fwd_mma_kernel): the CUDA-core
// forward above spent 4.0 ms at the path's shape (B=32,768, L=50) on scalar
// f32 products behind synchronous loads, against a 0.35 ms bound of bytes,
// and read a [B, 1, L, L] mask once per head. Every product of the Pallas
// forward takes bf16 operands with f32 sums and the dropped probabilities
// cast to bf16 before P V, which is what mma.sync m16n8k16 computes; only
// the order of the f32 sums differs. A persistent grid walks work items of
// one example and all its heads (as many as keep a stage within 48 KB), so
// the shared mask crosses device memory once per example; each block holds
// two stages, and the next item's q, k, v and mask copies (cp.async) are in
// flight while this one computes. A warp takes a 16-row query strip of one
// head, with L and hd padded to multiples of 16 by zeros: S = Q K^T by MMA,
// the f32 softmax in registers, the keep bits drawn once per element by the
// keying the backward replays, z = rnd(keep ? y / (1 - p) : 0) straight
// from the registers as the A fragments of O = z V (V by ldmatrix.trans),
// and rnd(O) out through the strip's own Q rows to 16-byte stores. The
// strip code (csrc/strip.cuh: strip_abt, strip_softmax, strip_keep,
// strip_av, key_strip_grads) is shared with the backward and with the
// whole-layer backward (csrc/layer_bwd.cu), so they cannot drift apart.
//
// bf16 backward at L <= 64, hd <= 64 (attn_bwd_mma_kernel): the backward
// above spends its time on five f32 CUDA-core products per (example, head)
// (about 52 GFLOP at B=32,768, L=50) and 48 KB of f32 shared memory. Every
// product of the Pallas backward takes bf16 operands with f32 sums (S, dZ,
// rnd(z)^T dO, rnd(ds) K, rnd(ds)^T Q), which is what mma.sync m16n8k16
// computes; only the order of the f32 sums differs. One block of four
// warps per (example, head) holds Q, K, V, dO in bf16 shared memory with L
// and hd padded to multiples of 16 by zeros (padded keys get y = 0 exactly,
// padded query rows contribute nothing). Each warp owns a 16-row strip of
// queries: S = Q K^T and dZ = dO V^T by MMA, the f32 softmax y in
// registers (row max and sum over the quad), the keep bit drawn once per
// element, dy, t = sum dy y, z = rnd(keep ? y/(1-p) : 0) and ds = rnd(y (dy
// - t)); dQ = ds K * scale by MMA with ds straight from the registers. z
// and ds go to shared memory as bf16, and the transposed products dV = z^T
// dO and dK = ds^T Q * scale run by MMA with the warps split over key rows:
// no atomics, one summation order. Both tensor-core bodies are held to the
// plain versions within their tolerances, not bit for bit; their dropout
// masks are the plain version's bit for bit. f32 inputs and longer or wider
// sequences keep the CUDA-core bodies.
#include "strip.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // query rows per tile (ops/attention.py::_ROWS)
constexpr int kKeys = 32;  // key rows per tile of the tiled kernels (_KEYS)
constexpr int kDc = 128;   // head-width columns the tiled kernels hold at once (_DC)

__host__ __device__ inline int cols(int hd) { return hd < kDc ? hd : kDc; }

__host__ __device__ inline int fwd_smem_floats(int L, int hd) {
  return 2 * L * (hd + 1) + kRows * (hd + 1) + kRows * (L + 1);
}

__host__ __device__ inline int bwd_smem_floats(int L, int hd) {
  return 4 * L * (hd + 1) + 2 * kRows * (hd + 1) + 2 * kRows * (L + 1);
}

// tiled forward: Qt and Ot [kRows, dc], S [kRows, L], one K-or-V tile [kKeys,
// dc] (dc = min(hd, kDc) columns of the head width)
__host__ __device__ inline int fwd_tiled_smem_floats(int L, int hd) {
  return 2 * kRows * (cols(hd) + 1) + kRows * (L + 1) + kKeys * (cols(hd) + 1);
}

// tiled backward: Qt, DOt, DQt [kRows, dc], Y and G [kRows, L], K and V tiles
__host__ __device__ inline int bwd_tiled_smem_floats(int L, int hd) {
  return 3 * kRows * (cols(hd) + 1) + 2 * kRows * (L + 1) + 2 * kKeys * (cols(hd) + 1);
}

struct Strides {
  long long b, h, r;  // element strides of the batch, head and row axes
};

__device__ __forceinline__ size_t at(const Strides& s, int b, int h, int r) {
  return (size_t)b * s.b + (size_t)h * s.h + (size_t)r * s.r;
}

// columns [d0, d0 + nd) of rows [r0, r0 + n) of one head's [L, hd] operand
// into shared memory as f32 (leading dim ld, one more than the columns held,
// so column walks do not collide on a bank)
template <typename T>
__device__ void stage(float* dst, int ld, const T* __restrict__ src, const Strides& s,
                      int b, int h, int r0, int n, int d0, int nd) {
  for (int w = threadIdx.x; w < n * nd; w += blockDim.x) {
    const int i = w / nd, d = w % nd;
    dst[i * ld + d] = to_f<T>(src[at(s, b, h, r0 + i) + d0 + d]);
  }
}

// S[i, j] = sum_d Qt[i, d] K[j, d] * scale + mask[r0 + i, j] for the tile's
// n rows, then the f32 softmax of each row (the pre-dropout y)
__device__ void scores_softmax(float* S, const float* Qt, const float* K,
                               const float* __restrict__ mrow, int n, int L,
                               int hd, float scale) {
  const int lds = L + 1, ldh = hd + 1;
  for (int w = threadIdx.x; w < n * L; w += blockDim.x) {
    const int i = w / L, j = w % L;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) acc = fmaf(Qt[i * ldh + d], K[j * ldh + d], acc);
    S[i * lds + j] = acc * scale + mrow[(size_t)i * L + j];
  }
  __syncthreads();
  softmax_rows(S, lds, n, L);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, Strides sin,
                const float* __restrict__ mask, int Hm, T* __restrict__ out,
                Strides sout, int H, int L, int hd, float scale,
                uint32_t seed, uint32_t thresh, float inv, uint32_t b0) {
  extern __shared__ float smem[];
  const int ldh = hd + 1, lds = L + 1;
  float* K = smem;              // [L, hd]
  float* V = K + L * ldh;       // [L, hd]
  float* Qt = V + L * ldh;      // [kRows, hd]  this tile's queries
  float* S = Qt + kRows * ldh;  // [kRows, L]   scores -> probabilities
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* mbase = mask + ((size_t)b * Hm + (Hm > 1 ? h : 0)) * L * L;

  stage<T>(K, ldh, k, sin, b, h, 0, L, 0, hd);
  stage<T>(V, ldh, v, sin, b, h, 0, L, 0, hd);
  for (int r0 = 0; r0 < L; r0 += kRows) {
    const int n = min(kRows, L - r0);
    stage<T>(Qt, ldh, q, sin, b, h, r0, n, 0, hd);
    __syncthreads();
    scores_softmax(S, Qt, K, mbase + (size_t)r0 * L, n, L, hd, scale);
    for (int w = threadIdx.x; w < n * L; w += blockDim.x) {
      const int i = w / L, j = w % L;
      const float y = S[i * lds + j];
      S[i * lds + j] =
          rnd<T>(kept(seed, thresh, h, b0 + b, (r0 + i) * L + j) ? y * inv : 0.0f);
    }
    __syncthreads();
    for (int w = threadIdx.x; w < n * hd; w += blockDim.x) {
      const int i = w / hd, d = w % hd;
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) acc = fmaf(S[i * lds + j], V[j * ldh + d], acc);
      out[at(sout, b, h, r0 + i) + d] = from_f<T>(acc);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, Strides sin,
                const float* __restrict__ mask, int Hm,
                const T* __restrict__ dout, Strides sdo, T* __restrict__ dq,
                T* __restrict__ dk, T* __restrict__ dv, Strides sout, int H,
                int L, int hd, float scale, uint32_t seed, uint32_t thresh,
                float inv, uint32_t b0) {
  extern __shared__ float smem[];
  const int ldh = hd + 1, lds = L + 1;
  float* K = smem;                // [L, hd]
  float* V = K + L * ldh;         // [L, hd]
  float* DK = V + L * ldh;        // [L, hd]  f32 sums over the tiles
  float* DV = DK + L * ldh;       // [L, hd]
  float* Qt = DV + L * ldh;       // [kRows, hd]
  float* DOt = Qt + kRows * ldh;  // [kRows, hd]
  float* Y = DOt + kRows * ldh;   // [kRows, L]  y, then rnd(z)
  float* G = Y + kRows * lds;     // [kRows, L]  dZ, then dy, then rnd(ds)
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* mbase = mask + ((size_t)b * Hm + (Hm > 1 ? h : 0)) * L * L;

  stage<T>(K, ldh, k, sin, b, h, 0, L, 0, hd);
  stage<T>(V, ldh, v, sin, b, h, 0, L, 0, hd);
  for (int w = threadIdx.x; w < L * ldh; w += blockDim.x) DK[w] = DV[w] = 0.0f;
  for (int r0 = 0; r0 < L; r0 += kRows) {
    const int n = min(kRows, L - r0);
    stage<T>(Qt, ldh, q, sin, b, h, r0, n, 0, hd);
    stage<T>(DOt, ldh, dout, sdo, b, h, r0, n, 0, hd);
    __syncthreads();
    scores_softmax(Y, Qt, K, mbase + (size_t)r0 * L, n, L, hd, scale);
    for (int w = threadIdx.x; w < n * L; w += blockDim.x) {
      const int i = w / L, j = w % L;
      float acc = 0.0f;
      for (int d = 0; d < hd; ++d) acc = fmaf(DOt[i * ldh + d], V[j * ldh + d], acc);
      G[i * lds + j] = acc;
    }
    __syncthreads();
    // one warp per row: dy = dropout(dZ), t = sum_j dy y, then ds and z
    {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int i = warp; i < n; i += blockDim.x / 32) {
        float* y = Y + i * lds;
        float* g = G + i * lds;
        float t = 0.0f;
        for (int j = lane; j < L; j += 32) {
          const bool keep = kept(seed, thresh, h, b0 + b, (r0 + i) * L + j);
          const float dy = keep ? g[j] * inv : 0.0f;
          g[j] = dy;
          t = fmaf(dy, y[j], t);
        }
        t = warp_sum(t);
        for (int j = lane; j < L; j += 32) {
          const bool keep = kept(seed, thresh, h, b0 + b, (r0 + i) * L + j);
          const float yj = y[j];
          g[j] = rnd<T>(yj * (g[j] - t));
          y[j] = rnd<T>(keep ? yj * inv : 0.0f);
        }
      }
    }
    __syncthreads();
    // dV += z^T dO and dK += ds^T Q over this tile's rows
    for (int w = threadIdx.x; w < L * hd; w += blockDim.x) {
      const int j = w / hd, d = w % hd;
      float av = 0.0f, ak = 0.0f;
      for (int i = 0; i < n; ++i) {
        av = fmaf(Y[i * lds + j], DOt[i * ldh + d], av);
        ak = fmaf(G[i * lds + j], Qt[i * ldh + d], ak);
      }
      DV[j * ldh + d] += av;
      DK[j * ldh + d] += ak;
    }
    // dQ = ds K * scale for this tile's rows
    for (int w = threadIdx.x; w < n * hd; w += blockDim.x) {
      const int i = w / hd, d = w % hd;
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) acc = fmaf(G[i * lds + j], K[j * ldh + d], acc);
      dq[at(sout, b, h, r0 + i) + d] = from_f<T>(acc * scale);
    }
    __syncthreads();
  }
  for (int w = threadIdx.x; w < L * hd; w += blockDim.x) {
    const int j = w / hd, d = w % hd;
    dk[at(sout, b, h, j) + d] = from_f<T>(DK[j * ldh + d] * scale);
    dv[at(sout, b, h, j) + d] = from_f<T>(DV[j * ldh + d]);
  }
}

// ------------------------------------------------------------- tiled pair
// The whole-sequence kernels' arithmetic with K and V streamed in tiles of
// kKeys rows and the head width in chunks of kDc columns (see the note at
// the top of this file).
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, Strides sin,
                      const float* __restrict__ mask, int Hm, T* __restrict__ out,
                      Strides sout, int H, int L, int hd, float scale,
                      uint32_t seed, uint32_t thresh, float inv, uint32_t b0) {
  extern __shared__ float smem[];
  const int ldh = cols(hd) + 1, lds = L + 1, nch = (hd + kDc - 1) / kDc;
  float* Qt = smem;              // [kRows, dc]  a column chunk of the tile's queries
  float* Ot = Qt + kRows * ldh;  // [kRows, dc]  f32 output sums of one column chunk
  float* S = Ot + kRows * ldh;   // [kRows, L]   scores -> probabilities
  float* KV = S + kRows * lds;   // [kKeys, dc]  a K tile, then a V tile
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* mbase = mask + ((size_t)b * Hm + (Hm > 1 ? h : 0)) * L * L;

  for (int r0 = 0; r0 < L; r0 += kRows) {
    const int n = min(kRows, L - r0);
    if (nch == 1) stage<T>(Qt, ldh, q, sin, b, h, r0, n, 0, hd);
    // scores: one f32 sum per score carried over the column chunks (each
    // thread owns the same scores in every chunk), scale and mask after
    // the last
    for (int c0 = 0; c0 < L; c0 += kKeys) {
      const int nk = min(kKeys, L - c0);
      for (int ch = 0; ch < nch; ++ch) {
        const int d0 = ch * kDc, nd = min(kDc, hd - d0);
        const bool last = ch == nch - 1;
        __syncthreads();
        if (nch > 1) stage<T>(Qt, ldh, q, sin, b, h, r0, n, d0, nd);
        stage<T>(KV, ldh, k, sin, b, h, c0, nk, d0, nd);
        __syncthreads();
        for (int w = threadIdx.x; w < n * nk; w += blockDim.x) {
          const int i = w / nk, j = w % nk;
          float acc = ch == 0 ? 0.0f : S[i * lds + c0 + j];
          for (int d = 0; d < nd; ++d) acc = fmaf(Qt[i * ldh + d], KV[j * ldh + d], acc);
          S[i * lds + c0 + j] =
              last ? acc * scale + mbase[(size_t)(r0 + i) * L + c0 + j] : acc;
        }
      }
    }
    __syncthreads();
    softmax_rows(S, lds, n, L);
    __syncthreads();
    for (int w = threadIdx.x; w < n * L; w += blockDim.x) {
      const int i = w / L, j = w % L;
      const float y = S[i * lds + j];
      S[i * lds + j] =
          rnd<T>(kept(seed, thresh, h, b0 + b, (r0 + i) * L + j) ? y * inv : 0.0f);
    }
    // one output column chunk at a time; each thread owns the same (i, d)
    // outputs in every loop of a chunk
    for (int ch = 0; ch < nch; ++ch) {
      const int d0 = ch * kDc, nd = min(kDc, hd - d0);
      for (int w = threadIdx.x; w < n * nd; w += blockDim.x)
        Ot[(w / nd) * ldh + w % nd] = 0.0f;
      for (int c0 = 0; c0 < L; c0 += kKeys) {
        const int nk = min(kKeys, L - c0);
        __syncthreads();
        stage<T>(KV, ldh, v, sin, b, h, c0, nk, d0, nd);
        __syncthreads();
        for (int w = threadIdx.x; w < n * nd; w += blockDim.x) {
          const int i = w / nd, d = w % nd;
          float acc = Ot[i * ldh + d];
          for (int j = 0; j < nk; ++j) acc = fmaf(S[i * lds + c0 + j], KV[j * ldh + d], acc);
          Ot[i * ldh + d] = acc;
        }
      }
      for (int w = threadIdx.x; w < n * nd; w += blockDim.x) {
        const int i = w / nd, d = w % nd;
        out[at(sout, b, h, r0 + i) + d0 + d] = from_f<T>(Ot[i * ldh + d]);
      }
    }
    __syncthreads();
  }
}

// scratch: [2, B*H, L, hd] f32, the dK and dV sums (this block's slices)
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, Strides sin,
                      const float* __restrict__ mask, int Hm,
                      const T* __restrict__ dout, Strides sdo, T* __restrict__ dq,
                      T* __restrict__ dk, T* __restrict__ dv, Strides sout,
                      float* __restrict__ scratch, int B, int H, int L, int hd,
                      float scale, uint32_t seed, uint32_t thresh, float inv, uint32_t b0) {
  extern __shared__ float smem[];
  const int ldh = cols(hd) + 1, lds = L + 1, nch = (hd + kDc - 1) / kDc;
  float* Qt = smem;                // [kRows, dc]
  float* DOt = Qt + kRows * ldh;   // [kRows, dc]
  float* DQt = DOt + kRows * ldh;  // [kRows, dc]  f32 dQ sums of one column chunk
  float* Y = DQt + kRows * ldh;    // [kRows, L]   y, then rnd(z)
  float* G = Y + kRows * lds;      // [kRows, L]   dZ, then dy, then rnd(ds)
  float* Kt = G + kRows * lds;     // [kKeys, dc]
  float* Vt = Kt + kKeys * ldh;    // [kKeys, dc]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* mbase = mask + ((size_t)b * Hm + (Hm > 1 ? h : 0)) * L * L;
  float* DK = scratch + (size_t)blockIdx.x * L * hd;       // [L, hd]
  float* DV = DK + (size_t)B * H * L * hd;                 // [L, hd]

  for (int w = threadIdx.x; w < L * hd; w += blockDim.x) DK[w] = DV[w] = 0.0f;
  for (int r0 = 0; r0 < L; r0 += kRows) {
    const int n = min(kRows, L - r0);
    if (nch == 1) {
      stage<T>(Qt, ldh, q, sin, b, h, r0, n, 0, hd);
      stage<T>(DOt, ldh, dout, sdo, b, h, r0, n, 0, hd);
    }
    // S and dZ, each one f32 sum carried over the column chunks
    for (int c0 = 0; c0 < L; c0 += kKeys) {
      const int nk = min(kKeys, L - c0);
      for (int ch = 0; ch < nch; ++ch) {
        const int d0 = ch * kDc, nd = min(kDc, hd - d0);
        const bool last = ch == nch - 1;
        __syncthreads();
        if (nch > 1) {
          stage<T>(Qt, ldh, q, sin, b, h, r0, n, d0, nd);
          stage<T>(DOt, ldh, dout, sdo, b, h, r0, n, d0, nd);
        }
        stage<T>(Kt, ldh, k, sin, b, h, c0, nk, d0, nd);
        stage<T>(Vt, ldh, v, sin, b, h, c0, nk, d0, nd);
        __syncthreads();
        for (int w = threadIdx.x; w < n * nk; w += blockDim.x) {
          const int i = w / nk, j = w % nk;
          float acc = ch == 0 ? 0.0f : Y[i * lds + c0 + j];
          float az = ch == 0 ? 0.0f : G[i * lds + c0 + j];
          for (int d = 0; d < nd; ++d) {
            acc = fmaf(Qt[i * ldh + d], Kt[j * ldh + d], acc);
            az = fmaf(DOt[i * ldh + d], Vt[j * ldh + d], az);
          }
          Y[i * lds + c0 + j] =
              last ? acc * scale + mbase[(size_t)(r0 + i) * L + c0 + j] : acc;
          G[i * lds + c0 + j] = az;
        }
      }
    }
    __syncthreads();
    softmax_rows(Y, lds, n, L);
    __syncthreads();
    // one warp per row: dy = dropout(dZ), t = sum_j dy y, then ds and z
    {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int i = warp; i < n; i += blockDim.x / 32) {
        float* y = Y + i * lds;
        float* g = G + i * lds;
        float t = 0.0f;
        for (int j = lane; j < L; j += 32) {
          const bool keep = kept(seed, thresh, h, b0 + b, (r0 + i) * L + j);
          const float dy = keep ? g[j] * inv : 0.0f;
          g[j] = dy;
          t = fmaf(dy, y[j], t);
        }
        t = warp_sum(t);
        for (int j = lane; j < L; j += 32) {
          const bool keep = kept(seed, thresh, h, b0 + b, (r0 + i) * L + j);
          const float yj = y[j];
          g[j] = rnd<T>(yj * (g[j] - t));
          y[j] = rnd<T>(keep ? yj * inv : 0.0f);
        }
      }
    }
    __syncthreads();
    // per column chunk: dV += z^T dO and dK += ds^T Q over this tile's rows
    // (each thread owns the same (j, d) sums in every tile), then dQ = ds K
    // * scale for this tile's rows, K streamed again
    for (int ch = 0; ch < nch; ++ch) {
      const int d0 = ch * kDc, nd = min(kDc, hd - d0);
      if (nch > 1) {
        stage<T>(Qt, ldh, q, sin, b, h, r0, n, d0, nd);
        stage<T>(DOt, ldh, dout, sdo, b, h, r0, n, d0, nd);
        __syncthreads();
      }
      for (int w = threadIdx.x; w < L * nd; w += blockDim.x) {
        const int j = w / nd, d = w % nd;
        float av = 0.0f, ak = 0.0f;
        for (int i = 0; i < n; ++i) {
          av = fmaf(Y[i * lds + j], DOt[i * ldh + d], av);
          ak = fmaf(G[i * lds + j], Qt[i * ldh + d], ak);
        }
        DV[j * hd + d0 + d] += av;
        DK[j * hd + d0 + d] += ak;
      }
      for (int w = threadIdx.x; w < n * nd; w += blockDim.x)
        DQt[(w / nd) * ldh + w % nd] = 0.0f;
      for (int c0 = 0; c0 < L; c0 += kKeys) {
        const int nk = min(kKeys, L - c0);
        __syncthreads();
        stage<T>(Kt, ldh, k, sin, b, h, c0, nk, d0, nd);
        __syncthreads();
        for (int w = threadIdx.x; w < n * nd; w += blockDim.x) {
          const int i = w / nd, d = w % nd;
          float acc = DQt[i * ldh + d];
          for (int j = 0; j < nk; ++j) acc = fmaf(G[i * lds + c0 + j], Kt[j * ldh + d], acc);
          DQt[i * ldh + d] = acc;
        }
      }
      for (int w = threadIdx.x; w < n * nd; w += blockDim.x) {
        const int i = w / nd, d = w % nd;
        dq[at(sout, b, h, r0 + i) + d0 + d] = from_f<T>(DQt[i * ldh + d] * scale);
      }
      __syncthreads();
    }
  }
  for (int w = threadIdx.x; w < L * hd; w += blockDim.x) {
    const int j = w / hd, d = w % hd;
    dk[at(sout, b, h, j) + d] = from_f<T>(DK[w] * scale);
    dv[at(sout, b, h, j) + d] = from_f<T>(DV[w]);
  }
}

// ------------------------------- bf16 tensor-core bodies (L <= 64, hd <= 64)
// See the notes at the top of this file.
constexpr int kMmaMaxLen = 64;       // ops/attention.py::MMA_MAX_LEN
constexpr int kMmaMaxHd = 64;        // ::MMA_MAX_HEAD_DIM
static_assert(kNT * 8 == kMmaMaxLen, "a strip's registers hold every key");
constexpr int kMmaWarps = 8;         // warps of a forward block, at most
constexpr int kStageBudget = 48 * 1024;  // bytes of one forward stage, at most

__host__ __device__ inline bool mma_takes(int dtype, int L, int hd) {
  return dtype == 1 && L >= 1 && L <= kMmaMaxLen && hd >= 1 && hd <= kMmaMaxHd;
}

// the f32 mask [L * L] (rounded up to 16 bytes), then Q, K, V, dO [Lp][hdp
// + 8] and Z, dS [Lp][Lp + 8] bf16 (Lp, hdp: L and hd padded to multiples
// of 16; the +8 keeps ldmatrix free of bank conflicts)
__host__ __device__ inline int mma_mask_bytes(int L) { return (L * L + 3) / 4 * 16; }

__host__ __device__ inline int mma_bwd_smem_bytes(int L, int hd) {
  const int Lp = (L + 15) / 16 * 16, ldh = (hd + 15) / 16 * 16 + 8;
  return mma_mask_bytes(L) + 2 * (4 * Lp * ldh + 2 * Lp * (Lp + 8));
}

// One stage of the forward: one (example, group of G heads) work item's f32
// masks [MG][L * L] (MG = G for a mask per head, else 1), then Q, K, V
// [3][G][Lp][hdp + 8] bf16 (every part a multiple of 16 bytes).
__host__ __device__ inline int mma_fwd_stage_bytes(int L, int hd, int G, int MG) {
  const int Lp = (L + 15) / 16 * 16, ldh = (hd + 15) / 16 * 16 + 8;
  return MG * mma_mask_bytes(L) + 3 * G * Lp * ldh * 2;
}

// heads a forward work item takes: all H of the example where one stage
// stays within kStageBudget (so a [B, 1, L, L] mask crosses device memory
// once per example), else as many as fit (at least one: 44 KB at L = hd =
// 64)
__host__ __device__ inline int mma_fwd_group(int L, int hd, int H, bool mask_heads) {
  int g = H;
  while (g > 1 && mma_fwd_stage_bytes(L, hd, g, mask_heads ? g : 1) > kStageBudget) --g;
  return g;
}

__host__ __device__ inline int mma_fwd_smem_bytes(int L, int hd, int H, bool mask_heads) {
  const int G = mma_fwd_group(L, hd, H, mask_heads);
  return 2 * mma_fwd_stage_bytes(L, hd, G, mask_heads ? G : 1);
}

// flags of the tensor-core bodies: which copies may move 16 bytes at a time
constexpr int kVecOperands = 1;  // hd % 8 == 0, q/k/v/dO rows 16-byte aligned
constexpr int kVecMask = 2;      // L * L % 4 == 0, the mask 16-byte aligned
constexpr int kPairOut = 4;      // hd even, dq/dk/dv rows 4-byte aligned
constexpr int kVecOut = 8;       // hd % 8 == 0, out rows 16-byte aligned

// one head's [L, hd] bf16 operand into dst [Lp][HDP + 8] with zeros past L
// and hd: 16-byte cp.async copies when vec, else element loads
template <int HDP>
__device__ void stage_bf16(__nv_bfloat16* dst, int Lp, const __nv_bfloat16* __restrict__ src,
                           const Strides& s, int b, int h, int L, int hd, bool vec) {
  constexpr int ldh = HDP + 8, ch = HDP / 8;
  if (vec) {
    for (int w = threadIdx.x; w < Lp * ch; w += blockDim.x) {
      const int i = w / ch, c = w % ch;
      const bool in = i < L && c * 8 < hd;
      cp_async16(dst + i * ldh + c * 8, src + at(s, b, h, in ? i : 0) + (in ? c * 8 : 0), in);
    }
    return;
  }
  for (int w = threadIdx.x; w < Lp * HDP; w += blockDim.x) {
    const int i = w / HDP, d = w % HDP;
    dst[i * ldh + d] = i < L && d < hd ? src[at(s, b, h, i) + d] : __float2bfloat16(0.0f);
  }
}

// one head's [L, L] f32 mask into dst: 16-byte cp.async copies when vec
__device__ void stage_mask(float* dst, const float* __restrict__ src, int L, bool vec) {
  if (vec) {
    for (int w = threadIdx.x; w < L * L / 4; w += blockDim.x) cp_async16(dst + 4 * w, src + 4 * w, true);
  } else {
    for (int w = threadIdx.x; w < L * L; w += blockDim.x) dst[w] = src[w];
  }
}

// The forward (row 10). A persistent grid walks work items (example b, group
// of G heads); two shared-memory stages hold one item's Q, K, V and mask
// each, and the next item's copies are in flight (cp.async) while this one
// computes. Each warp takes 16-row query strips of the item's heads: S by
// MMA, the f32 softmax, the keep bits, z = rnd(keep ? y / (1 - p) : 0) from
// the registers as the A fragments of O = z V by MMA, and out = rnd(O)
// through the strip's own Q rows to 16-byte stores in [B, L, H, hd] order.
template <int HD16>
__global__ void __launch_bounds__(32 * kMmaWarps, 2)
attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, Strides sin,
                    const float* __restrict__ mask, int Hm, __nv_bfloat16* __restrict__ out,
                    Strides sout, int H, int L, int hd, float scale, uint32_t seed,
                    uint32_t thresh, float inv, uint32_t b0, int G, int nwork, int flags) {
  constexpr int HDP = HD16 * 16, LDH = HDP + 8, NDT = HD16 * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = (L + 15) / 16 * 16, ntile = Lp / 8, nstrip = Lp / 16;
  const int MG = Hm > 1 ? G : 1, ngr = (H + G - 1) / G;
  const int mask_floats = mma_mask_bytes(L) / 4, opnd = Lp * LDH;
  const int stage_bytes = mma_fwd_stage_bytes(L, hd, G, MG);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x / 32;
  const bool vec = flags & kVecOperands;
  auto Ms = [&](int st) { return reinterpret_cast<float*>(smem_raw + st * stage_bytes); };
  // Q, K, V of head hh of the group: operand o's [Lp][LDH] at (o * G + hh)
  auto Ops = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + st * stage_bytes + MG * mma_mask_bytes(L));
  };
  auto load = [&](int w, int st) {
    const int b = w / ngr, h0 = (w % ngr) * G, ng = min(G, H - h0);
    __nv_bfloat16* O = Ops(st);
    for (int hh = 0; hh < ng; ++hh) {
      stage_bf16<HDP>(O + hh * opnd, Lp, q, sin, b, h0 + hh, L, hd, vec);
      stage_bf16<HDP>(O + (G + hh) * opnd, Lp, k, sin, b, h0 + hh, L, hd, vec);
      stage_bf16<HDP>(O + (2 * G + hh) * opnd, Lp, v, sin, b, h0 + hh, L, hd, vec);
    }
    for (int mh = 0; mh < (Hm > 1 ? ng : 1); ++mh)
      stage_mask(Ms(st) + mh * mask_floats,
                 mask + ((size_t)b * Hm + (Hm > 1 ? h0 + mh : 0)) * L * L, L, flags & kVecMask);
  };

  if ((int)blockIdx.x < nwork) load(blockIdx.x, 0);
  cp_async_commit();
  int st = 0;
  for (int w = blockIdx.x; w < nwork; w += gridDim.x, st ^= 1) {
    if (w + (int)gridDim.x < nwork) load(w + gridDim.x, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this item's copies have landed
    __syncthreads();
    const int b = w / ngr, h0 = (w % ngr) * G, ng = min(G, H - h0);
    for (int u = warp; u < ng * nstrip; u += nwarps) {
      const int hh = u / nstrip, i0 = (u % nstrip) * 16, h = h0 + hh;
      __nv_bfloat16* Qh = Ops(st) + hh * opnd;
      const __nv_bfloat16* Vh = Ops(st) + (2 * G + hh) * opnd;
      float s[kNT][4];
      strip_abt<HD16>(s, Qh, LDH, Ops(st) + (G + hh) * opnd, LDH, i0, ntile, lane);
      const float* Mh = Ms(st) + (Hm > 1 ? hh : 0) * mask_floats;
      strip_softmax(s, [&](int i, int j) { return Mh[i * L + j]; }, i0, L, ntile, scale, lane);
      const uint32_t keep = strip_keep(seed, thresh, h, b0 + b, i0, L, ntile, lane);
      float o[NDT][4];
#pragma unroll
      for (int d = 0; d < NDT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
      // A fragment r: key tile 2kc + r / 2, rows g (r even) or g + 8 (r odd)
      strip_av<HD16>(o, [&](int kc, uint32_t a[4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 2 * kc + r / 2, e = 2 * (r & 1);
          a[r] = pack_bf16(dropped(s, keep, n, e, inv), dropped(s, keep, n, e + 1, inv));
        }
      }, Vh, LDH, ntile, lane);
      // out = rnd(O) through the strip's Q rows (this warp alone reads them)
      __syncwarp();
#pragma unroll
      for (int d = 0; d < NDT; ++d)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<__nv_bfloat162*>(Qh + (i0 + g + r * 8) * LDH + d * 8 + 2 * t) =
              __floats2bfloat162_rn(o[d][2 * r], o[d][2 * r + 1]);
      __syncwarp();
      if (flags & kVecOut) {
        const int ch = hd / 8;
        for (int c = lane; c < 16 * ch; c += 32) {
          const int i = i0 + c / ch, cc = c % ch;
          if (i < L)
            *reinterpret_cast<uint4*>(out + at(sout, b, h, i) + cc * 8) =
                *reinterpret_cast<const uint4*>(Qh + i * LDH + cc * 8);
        }
      } else {
        for (int c = lane; c < 16 * hd; c += 32) {
          const int i = i0 + c / hd, d = c % hd;
          if (i < L) out[at(sout, b, h, i) + d] = Qh[i * LDH + d];
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next copy into it
  }
  cp_async_wait<0>();
}

// The backward (row 11): one block of four warps per (example, head).
template <int HD16>
__global__ void __launch_bounds__(kThreads)
attn_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, Strides sin,
                    const float* __restrict__ mask, int Hm,
                    const __nv_bfloat16* __restrict__ dout, Strides sdo,
                    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, Strides sout, int H, int L, int hd,
                    float scale, uint32_t seed, uint32_t thresh, float inv, uint32_t b0,
                    int flags) {
  constexpr int LDH = HD16 * 16 + 8, NDT = HD16 * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = (L + 15) / 16 * 16, ldz = Lp + 8, ntile = Lp / 8;
  float* Ms = reinterpret_cast<float*>(smem_raw);  // [L, L] this head's mask
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + mma_mask_bytes(L));
  __nv_bfloat16* Ks = Qs + Lp * LDH;
  __nv_bfloat16* Vs = Ks + Lp * LDH;
  __nv_bfloat16* DOs = Vs + Lp * LDH;
  __nv_bfloat16* Zs = DOs + Lp * LDH;  // [Lp][ldz] rnd(z), query rows x keys
  __nv_bfloat16* DSs = Zs + Lp * ldz;  // [Lp][ldz] rnd(ds)
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* mbase = mask + ((size_t)b * Hm + (Hm > 1 ? h : 0)) * L * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  // row[c], row[c + 1] = rnd(x0), rnd(x1) for c < hd (c even); one 4-byte
  // store where the output rows allow it
  auto put2 = [hd, flags](__nv_bfloat16* row, int c, float x0, float x1) {
    if (c >= hd) return;
    if (flags & kPairOut) {
      *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x0, x1);
    } else {
      row[c] = __float2bfloat16(x0);
      if (c + 1 < hd) row[c + 1] = __float2bfloat16(x1);
    }
  };

  // every copy of the block in flight at once, then one wait
  const bool vec = flags & kVecOperands;
  stage_bf16<HD16 * 16>(Qs, Lp, q, sin, b, h, L, hd, vec);
  stage_bf16<HD16 * 16>(Ks, Lp, k, sin, b, h, L, hd, vec);
  stage_bf16<HD16 * 16>(Vs, Lp, v, sin, b, h, L, hd, vec);
  stage_bf16<HD16 * 16>(DOs, Lp, dout, sdo, b, h, L, hd, vec);
  stage_mask(Ms, mbase, L, flags & kVecMask);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // per 16-row strip of queries: S, dZ, y, the keep bits, z, ds and dQ
  if (warp * 16 < Lp) {
    const int i0 = warp * 16;
    float s[kNT][4], dz[kNT][4];
    strip_abt<HD16>(s, Qs, LDH, Ks, LDH, i0, ntile, lane);
    strip_abt<HD16>(dz, DOs, LDH, Vs, LDH, i0, ntile, lane);
    strip_softmax(s, [&](int i, int j) { return Ms[i * L + j]; }, i0, L, ntile, scale, lane);
    // dy = dropout(dZ) with the forward's keep bits, t = sum dy y
    const uint32_t keep = strip_keep(seed, thresh, h, b0 + b, i0, L, ntile, lane);
    float tsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dz[n][e] = (keep >> (n * 4 + e)) & 1u ? dz[n][e] * inv : 0.0f;
        tsum[e >> 1] = fmaf(dz[n][e], s[n][e], tsum[e >> 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 1);
      tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 2);
    }
    // z = rnd(keep ? y / (1 - p) : 0) and ds = rnd(y (dy - t)) into shared
    // memory for the transposed products; ds stays in s for dQ
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n >= ntile) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + r * 8, j = n * 8 + 2 * t;
        float z[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c;
          z[c] = dropped(s, keep, n, e, inv);
          s[n][e] = __bfloat162float(__float2bfloat16(s[n][e] * (dz[n][e] - tsum[r])));
        }
        *reinterpret_cast<__nv_bfloat162*>(Zs + i * ldz + j) = __floats2bfloat162_rn(z[0], z[1]);
        *reinterpret_cast<__nv_bfloat162*>(DSs + i * ldz + j) =
            __floats2bfloat162_rn(s[n][2 * r], s[n][2 * r + 1]);
      }
    }
    // dQ = ds K * scale, ds straight from the registers as A fragments
    float aq[NDT][4];
#pragma unroll
    for (int d = 0; d < NDT; ++d) aq[d][0] = aq[d][1] = aq[d][2] = aq[d][3] = 0.0f;
    strip_av<HD16>(aq, [&](int kc, uint32_t a[4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = pack_bf16(s[2 * kc + r / 2][2 * (r & 1)], s[2 * kc + r / 2][2 * (r & 1) + 1]);
    }, Ks, LDH, ntile, lane);
#pragma unroll
    for (int d = 0; d < NDT; ++d)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + r * 8;
        if (i < L)
          put2(dq + at(sout, b, h, i), d * 8 + 2 * t, aq[d][2 * r] * scale,
               aq[d][2 * r + 1] * scale);
      }
  }
  __syncthreads();

  // dV = z^T dO and dK = ds^T Q * scale: a warp per 16 key rows, summed over
  // every query strip in one pass (no atomics, one order)
  if (warp * 16 < Lp) {
    const int j0 = warp * 16;
    float av[NDT][4], ak[NDT][4];
    key_strip_grads<HD16>(av, ak, Zs, DSs, ldz, DOs, LDH, Qs, LDH, j0, Lp / 16, lane);
#pragma unroll
    for (int d = 0; d < NDT; ++d)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + g + r * 8;
        if (j < L) {
          put2(dk + at(sout, b, h, j), d * 8 + 2 * t, ak[d][2 * r] * scale,
               ak[d][2 * r + 1] * scale);
          put2(dv + at(sout, b, h, j), d * 8 + 2 * t, av[d][2 * r], av[d][2 * r + 1]);
        }
      }
  }
}

bool rows16(const void* p, const Strides& s) {
  return (uintptr_t)p % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 && s.r % 8 == 0;
}

bool rows4(const void* p, const Strides& s) {
  return (uintptr_t)p % 4 == 0 && s.b % 2 == 0 && s.h % 2 == 0 && s.r % 2 == 0;
}

int mask_flag(const float* mask, int L) {
  return (uintptr_t)mask % 16 == 0 && L * L % 4 == 0 ? kVecMask : 0;
}

template <int HD16>
int launch_fwd_mma_hd(const void* q, const void* k, const void* v, Strides sin,
                      const float* mask, int Hm, void* out, Strides sout, int B, int H, int L,
                      int hd, float scale, uint32_t seed, uint32_t thresh, float inv,
                      uint32_t b0, int flags, cudaStream_t stream) {
  const int G = mma_fwd_group(L, hd, H, Hm > 1);
  const int smem = mma_fwd_smem_bytes(L, hd, H, Hm > 1);
  const int Lp = (L + 15) / 16 * 16, threads = 32 * min(kMmaWarps, G * Lp / 16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_mma_kernel<HD16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_fwd_mma_kernel<HD16>,
                                                           threads, smem)) != cudaSuccess)
    return (int)err;
  const long long nwork = (long long)B * ((H + G - 1) / G);
  if (nwork > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(nwork < resident ? nwork : resident);
  attn_fwd_mma_kernel<HD16><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, sin, mask, Hm,
      (__nv_bfloat16*)out, sout, H, L, hd, scale, seed, thresh, inv, b0, G, (int)nwork, flags);
  return (int)cudaGetLastError();
}

int launch_fwd_mma(const void* q, const void* k, const void* v, Strides sin, const float* mask,
                   int Hm, void* out, Strides sout, int B, int H, int L, int hd, float scale,
                   uint32_t seed, uint32_t thresh, float inv, uint32_t b0,
                   cudaStream_t stream) {
  const int flags =
      (hd % 8 == 0 && rows16(q, sin) && rows16(k, sin) && rows16(v, sin) ? kVecOperands : 0) |
      mask_flag(mask, L) | (hd % 8 == 0 && rows16(out, sout) ? kVecOut : 0);
  switch ((hd + 15) / 16) {
#define UNIREC_FWD_HD(n)                                                                      \
  case n:                                                                                     \
    return launch_fwd_mma_hd<n>(q, k, v, sin, mask, Hm, out, sout, B, H, L, hd, scale, seed, \
                                thresh, inv, b0, flags, stream);
    UNIREC_FWD_HD(1) UNIREC_FWD_HD(2) UNIREC_FWD_HD(3) UNIREC_FWD_HD(4)
#undef UNIREC_FWD_HD
  }
  return (int)cudaErrorInvalidValue;
}

template <int HD16>
int launch_bwd_mma_hd(const void* q, const void* k, const void* v, Strides sin,
                      const float* mask, int Hm, const void* dout, Strides sdo, void* dq,
                      void* dk, void* dv, Strides sout, int B, int H, int L, int hd,
                      float scale, uint32_t seed, uint32_t thresh, float inv, uint32_t b0,
                      int flags, cudaStream_t stream) {
  const int smem = mma_bwd_smem_bytes(L, hd);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_mma_kernel<HD16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_mma_kernel<HD16><<<B * H, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, sin, mask,
      Hm, (const __nv_bfloat16*)dout, sdo, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, sout, H, L, hd, scale, seed, thresh, inv, b0, flags);
  return (int)cudaGetLastError();
}

int launch_bwd_mma(const void* q, const void* k, const void* v, Strides sin,
                   const float* mask, int Hm, const void* dout, Strides sdo, void* dq,
                   void* dk, void* dv, Strides sout, int B, int H, int L, int hd,
                   float scale, uint32_t seed, uint32_t thresh, float inv, uint32_t b0,
                   cudaStream_t stream) {
  const int flags =
      (hd % 8 == 0 && rows16(q, sin) && rows16(k, sin) && rows16(v, sin) && rows16(dout, sdo)
           ? kVecOperands
           : 0) |
      mask_flag(mask, L) |
      (hd % 2 == 0 && rows4(dq, sout) && rows4(dk, sout) && rows4(dv, sout) ? kPairOut : 0);
  switch ((hd + 15) / 16) {
#define UNIREC_BWD_HD(n)                                                                  \
  case n:                                                                                 \
    return launch_bwd_mma_hd<n>(q, k, v, sin, mask, Hm, dout, sdo, dq, dk, dv, sout, B, H, \
                                L, hd, scale, seed, thresh, inv, b0, flags, stream);
    UNIREC_BWD_HD(1) UNIREC_BWD_HD(2) UNIREC_BWD_HD(3) UNIREC_BWD_HD(4)
#undef UNIREC_BWD_HD
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, Strides sin,
               const float* mask, int Hm, void* out, Strides sout, int B, int H,
               int L, int hd, float scale, uint32_t seed, uint32_t thresh,
               float inv, uint32_t b0, int tiled, cudaStream_t stream) {
  auto kern = tiled ? &attn_fwd_tiled_kernel<T> : &attn_fwd_kernel<T>;
  const size_t smem = sizeof(float) * (tiled ? fwd_tiled_smem_floats(L, hd)
                                             : fwd_smem_floats(L, hd));
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, sin,
                                          mask, Hm, (T*)out, sout, H, L, hd, scale,
                                          seed, thresh, inv, b0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, Strides sin,
               const float* mask, int Hm, const void* dout, Strides sdo,
               void* dq, void* dk, void* dv, Strides sout, float* scratch, int B,
               int H, int L, int hd, float scale, uint32_t seed, uint32_t thresh,
               float inv, uint32_t b0, cudaStream_t stream) {
  if (scratch == nullptr) {
    const size_t smem = sizeof(float) * bwd_smem_floats(L, hd);
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, sin, mask, Hm, (const T*)dout, sdo,
        (T*)dq, (T*)dk, (T*)dv, sout, H, L, hd, scale, seed, thresh, inv, b0);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * bwd_tiled_smem_floats(L, hd);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_tiled_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, sin, mask, Hm, (const T*)dout, sdo,
      (T*)dq, (T*)dk, (T*)dv, sout, scratch, B, H, L, hd, scale, seed, thresh, inv, b0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory of one block of the CUDA-core bodies
// (ops/attention.py::_tiled holds a copy; tests/test_torch_gpu.py holds the
// two together)
int unirec_attention_fwd_smem_bytes(int L, int hd) {
  return (int)sizeof(float) * fwd_smem_floats(L, hd);
}

int unirec_attention_bwd_smem_bytes(int L, int hd) {
  return (int)sizeof(float) * bwd_smem_floats(L, hd);
}

int unirec_attention_fwd_tiled_smem_bytes(int L, int hd) {
  return (int)sizeof(float) * fwd_tiled_smem_floats(L, hd);
}

int unirec_attention_bwd_tiled_smem_bytes(int L, int hd) {
  return (int)sizeof(float) * bwd_tiled_smem_floats(L, hd);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out). s_*: element strides
// (batch, head, row) of q/k/v (shared) and of out; the last axis is
// contiguous. mask: [B, Hm, L, L] f32, contiguous. Dropout: seed, keep
// threshold round(p * 2^32) (0: none), 1/(1-p), and b0, the global index of
// the first example, by which the masks are keyed (common.cuh::Drop). The bf16 tensor-core
// body runs where unirec_attention_bwd_mma_takes says so (and ignores
// tiled); otherwise tiled: 1 runs the tiled kernel. Returns a cudaError_t.
int unirec_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                         long long sib, long long sih, long long sir,
                         const float* mask, int Hm, void* out, long long sob,
                         long long soh, long long sor, int B, int H, int L,
                         int hd, float scale, unsigned seed, unsigned thresh,
                         float inv, unsigned b0, int tiled, void* stream) {
  const Strides sin{sib, sih, sir}, sout{sob, soh, sor};
  cudaStream_t s = (cudaStream_t)stream;
  if (mma_takes(dtype, L, hd))
    return launch_fwd_mma(q, k, v, sin, mask, Hm, out, sout, B, H, L, hd, scale, seed, thresh,
                          inv, b0, s);
  if (dtype == 0)
    return launch_fwd<float>(q, k, v, sin, mask, Hm, out, sout, B, H, L, hd,
                             scale, seed, thresh, inv, b0, tiled, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(q, k, v, sin, mask, Hm, out, sout, B, H, L,
                                     hd, scale, seed, thresh, inv, b0, tiled, s);
  return (int)cudaErrorInvalidValue;
}

// 1 when the forward and the backward run their bf16 tensor-core bodies
// (dtype 1, L <= 64, hd <= 64; ops/attention.py::_bwd_body and _fwd_body
// hold a copy of the rule), and their bytes of dynamic shared memory (the
// forward's for H heads and a mask per head, mask_heads != 0, or shared)
int unirec_attention_bwd_mma_takes(int dtype, int L, int hd) {
  return (int)mma_takes(dtype, L, hd);
}

int unirec_attention_bwd_mma_smem_bytes(int L, int hd) { return mma_bwd_smem_bytes(L, hd); }

int unirec_attention_fwd_mma_smem_bytes(int L, int hd, int H, int mask_heads) {
  return mma_fwd_smem_bytes(L, hd, H, mask_heads != 0);
}

// As unirec_attention_fwd, plus dout (strides s_d*) and the three outputs
// dq, dk, dv (sharing the strides s_o*), each written whole. The bf16
// tensor-core body runs where unirec_attention_bwd_mma_takes says so (and
// ignores scratch); otherwise scratch is null for the whole-sequence
// kernel, else [2, B*H, L, hd] f32 for the tiled one.
int unirec_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                         long long sib, long long sih, long long sir,
                         const float* mask, int Hm, const void* dout,
                         long long sdb, long long sdh, long long sdr, void* dq,
                         void* dk, void* dv, long long sob, long long soh,
                         long long sor, float* scratch, int B, int H, int L, int hd,
                         float scale, unsigned seed, unsigned thresh, float inv,
                         unsigned b0, void* stream) {
  const Strides sin{sib, sih, sir}, sdo{sdb, sdh, sdr}, sout{sob, soh, sor};
  cudaStream_t s = (cudaStream_t)stream;
  if (mma_takes(dtype, L, hd))
    return launch_bwd_mma(q, k, v, sin, mask, Hm, dout, sdo, dq, dk, dv, sout, B, H, L, hd,
                          scale, seed, thresh, inv, b0, s);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, sin, mask, Hm, dout, sdo, dq, dk, dv, sout,
                             scratch, B, H, L, hd, scale, seed, thresh, inv, b0, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, sin, mask, Hm, dout, sdo, dq, dk,
                                     dv, sout, scratch, B, H, L, hd, scale, seed,
                                     thresh, inv, b0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
