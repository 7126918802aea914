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
// philox_bits(seed, h, b, i * L + j) >= thresh (common.cuh), which depends
// on no launch shape, so the backward replays the forward's mask without
// storing it.
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
// Long sequences. Whole K and V (and their f32 gradients) fit a block's
// shared memory only up to L = 285 at head width 32, while the JAX gate
// takes L <= 512. Beyond the whole-sequence kernels' reach the tiled pair
// runs instead: the query tile's score rows stay in shared memory as before
// (so the softmax is the same exact two-pass one), but K and V stream
// through a tile of kKeys rows, the output row accumulates in shared
// memory, and the backward sums dK and dV in an f32 scratch in device
// memory that the block owns ([B*H, L, hd] each, zeroed by the block). Each
// sum runs over the same terms in the same order as in the whole-sequence
// kernels, so the two give bit-identical results where both fit.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // query rows per tile (ops/attention.py::_ROWS)
constexpr int kKeys = 32;  // key rows per tile of the tiled kernels (_KEYS)

__host__ __device__ inline int fwd_smem_floats(int L, int hd) {
  return 2 * L * (hd + 1) + kRows * (hd + 1) + kRows * (L + 1);
}

__host__ __device__ inline int bwd_smem_floats(int L, int hd) {
  return 4 * L * (hd + 1) + 2 * kRows * (hd + 1) + 2 * kRows * (L + 1);
}

// tiled forward: Qt and Ot [kRows, hd], S [kRows, L], one K-or-V tile
__host__ __device__ inline int fwd_tiled_smem_floats(int L, int hd) {
  return 2 * kRows * (hd + 1) + kRows * (L + 1) + kKeys * (hd + 1);
}

// tiled backward: Qt, DOt, DQt [kRows, hd], Y and G [kRows, L], K and V tiles
__host__ __device__ inline int bwd_tiled_smem_floats(int L, int hd) {
  return 3 * kRows * (hd + 1) + 2 * kRows * (L + 1) + 2 * kKeys * (hd + 1);
}

struct Strides {
  long long b, h, r;  // element strides of the batch, head and row axes
};

__device__ __forceinline__ size_t at(const Strides& s, int b, int h, int r) {
  return (size_t)b * s.b + (size_t)h * s.h + (size_t)r * s.r;
}

// rows [0, n) of one head's [L, hd] operand into shared memory as f32
// (leading dim hd + 1, so column walks do not collide on a bank)
template <typename T>
__device__ void stage(float* dst, const T* __restrict__ src, const Strides& s,
                      int b, int h, int r0, int n, int hd) {
  for (int w = threadIdx.x; w < n * hd; w += blockDim.x) {
    const int i = w / hd, d = w % hd;
    dst[i * (hd + 1) + d] = to_f<T>(src[at(s, b, h, r0 + i) + d]);
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
                uint32_t seed, uint32_t thresh, float inv) {
  extern __shared__ float smem[];
  const int ldh = hd + 1, lds = L + 1;
  float* K = smem;              // [L, hd]
  float* V = K + L * ldh;       // [L, hd]
  float* Qt = V + L * ldh;      // [kRows, hd]  this tile's queries
  float* S = Qt + kRows * ldh;  // [kRows, L]   scores -> probabilities
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* mbase = mask + ((size_t)b * Hm + (Hm > 1 ? h : 0)) * L * L;

  stage<T>(K, k, sin, b, h, 0, L, hd);
  stage<T>(V, v, sin, b, h, 0, L, hd);
  for (int r0 = 0; r0 < L; r0 += kRows) {
    const int n = min(kRows, L - r0);
    stage<T>(Qt, q, sin, b, h, r0, n, hd);
    __syncthreads();
    scores_softmax(S, Qt, K, mbase + (size_t)r0 * L, n, L, hd, scale);
    for (int w = threadIdx.x; w < n * L; w += blockDim.x) {
      const int i = w / L, j = w % L;
      const float y = S[i * lds + j];
      S[i * lds + j] =
          rnd<T>(kept(seed, thresh, h, b, (r0 + i) * L + j) ? y * inv : 0.0f);
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
                float inv) {
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

  stage<T>(K, k, sin, b, h, 0, L, hd);
  stage<T>(V, v, sin, b, h, 0, L, hd);
  for (int w = threadIdx.x; w < L * ldh; w += blockDim.x) DK[w] = DV[w] = 0.0f;
  for (int r0 = 0; r0 < L; r0 += kRows) {
    const int n = min(kRows, L - r0);
    stage<T>(Qt, q, sin, b, h, r0, n, hd);
    stage<T>(DOt, dout, sdo, b, h, r0, n, hd);
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
          const bool keep = kept(seed, thresh, h, b, (r0 + i) * L + j);
          const float dy = keep ? g[j] * inv : 0.0f;
          g[j] = dy;
          t = fmaf(dy, y[j], t);
        }
        t = warp_sum(t);
        for (int j = lane; j < L; j += 32) {
          const bool keep = kept(seed, thresh, h, b, (r0 + i) * L + j);
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
// kKeys rows (see the note at the top of this file).
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, Strides sin,
                      const float* __restrict__ mask, int Hm, T* __restrict__ out,
                      Strides sout, int H, int L, int hd, float scale,
                      uint32_t seed, uint32_t thresh, float inv) {
  extern __shared__ float smem[];
  const int ldh = hd + 1, lds = L + 1;
  float* Qt = smem;              // [kRows, hd]
  float* Ot = Qt + kRows * ldh;  // [kRows, hd]  f32 output sums
  float* S = Ot + kRows * ldh;   // [kRows, L]   scores -> probabilities
  float* KV = S + kRows * lds;   // [kKeys, hd]  a K tile, then a V tile
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* mbase = mask + ((size_t)b * Hm + (Hm > 1 ? h : 0)) * L * L;

  for (int r0 = 0; r0 < L; r0 += kRows) {
    const int n = min(kRows, L - r0);
    stage<T>(Qt, q, sin, b, h, r0, n, hd);
    for (int c0 = 0; c0 < L; c0 += kKeys) {
      const int nk = min(kKeys, L - c0);
      __syncthreads();
      stage<T>(KV, k, sin, b, h, c0, nk, hd);
      __syncthreads();
      for (int w = threadIdx.x; w < n * nk; w += blockDim.x) {
        const int i = w / nk, j = w % nk;
        float acc = 0.0f;
        for (int d = 0; d < hd; ++d) acc = fmaf(Qt[i * ldh + d], KV[j * ldh + d], acc);
        S[i * lds + c0 + j] = acc * scale + mbase[(size_t)(r0 + i) * L + c0 + j];
      }
    }
    __syncthreads();
    softmax_rows(S, lds, n, L);
    __syncthreads();
    for (int w = threadIdx.x; w < n * L; w += blockDim.x) {
      const int i = w / L, j = w % L;
      const float y = S[i * lds + j];
      S[i * lds + j] =
          rnd<T>(kept(seed, thresh, h, b, (r0 + i) * L + j) ? y * inv : 0.0f);
    }
    // each thread owns the same (i, d) outputs in every loop below
    for (int w = threadIdx.x; w < n * hd; w += blockDim.x)
      Ot[(w / hd) * ldh + w % hd] = 0.0f;
    for (int c0 = 0; c0 < L; c0 += kKeys) {
      const int nk = min(kKeys, L - c0);
      __syncthreads();
      stage<T>(KV, v, sin, b, h, c0, nk, hd);
      __syncthreads();
      for (int w = threadIdx.x; w < n * hd; w += blockDim.x) {
        const int i = w / hd, d = w % hd;
        float acc = Ot[i * ldh + d];
        for (int j = 0; j < nk; ++j) acc = fmaf(S[i * lds + c0 + j], KV[j * ldh + d], acc);
        Ot[i * ldh + d] = acc;
      }
    }
    for (int w = threadIdx.x; w < n * hd; w += blockDim.x) {
      const int i = w / hd, d = w % hd;
      out[at(sout, b, h, r0 + i) + d] = from_f<T>(Ot[i * ldh + d]);
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
                      float scale, uint32_t seed, uint32_t thresh, float inv) {
  extern __shared__ float smem[];
  const int ldh = hd + 1, lds = L + 1;
  float* Qt = smem;                // [kRows, hd]
  float* DOt = Qt + kRows * ldh;   // [kRows, hd]
  float* DQt = DOt + kRows * ldh;  // [kRows, hd]  f32 dQ sums
  float* Y = DQt + kRows * ldh;    // [kRows, L]   y, then rnd(z)
  float* G = Y + kRows * lds;      // [kRows, L]   dZ, then dy, then rnd(ds)
  float* Kt = G + kRows * lds;     // [kKeys, hd]
  float* Vt = Kt + kKeys * ldh;    // [kKeys, hd]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* mbase = mask + ((size_t)b * Hm + (Hm > 1 ? h : 0)) * L * L;
  float* DK = scratch + (size_t)blockIdx.x * L * hd;       // [L, hd]
  float* DV = DK + (size_t)B * H * L * hd;                 // [L, hd]

  // each thread owns the same (j, d) sums in every loop over L * hd
  for (int w = threadIdx.x; w < L * hd; w += blockDim.x) DK[w] = DV[w] = 0.0f;
  for (int r0 = 0; r0 < L; r0 += kRows) {
    const int n = min(kRows, L - r0);
    stage<T>(Qt, q, sin, b, h, r0, n, hd);
    stage<T>(DOt, dout, sdo, b, h, r0, n, hd);
    for (int c0 = 0; c0 < L; c0 += kKeys) {
      const int nk = min(kKeys, L - c0);
      __syncthreads();
      stage<T>(Kt, k, sin, b, h, c0, nk, hd);
      stage<T>(Vt, v, sin, b, h, c0, nk, hd);
      __syncthreads();
      for (int w = threadIdx.x; w < n * nk; w += blockDim.x) {
        const int i = w / nk, j = w % nk;
        float acc = 0.0f, az = 0.0f;
        for (int d = 0; d < hd; ++d) {
          acc = fmaf(Qt[i * ldh + d], Kt[j * ldh + d], acc);
          az = fmaf(DOt[i * ldh + d], Vt[j * ldh + d], az);
        }
        Y[i * lds + c0 + j] = acc * scale + mbase[(size_t)(r0 + i) * L + c0 + j];
        G[i * lds + c0 + j] = az;
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
          const bool keep = kept(seed, thresh, h, b, (r0 + i) * L + j);
          const float dy = keep ? g[j] * inv : 0.0f;
          g[j] = dy;
          t = fmaf(dy, y[j], t);
        }
        t = warp_sum(t);
        for (int j = lane; j < L; j += 32) {
          const bool keep = kept(seed, thresh, h, b, (r0 + i) * L + j);
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
      DV[w] += av;
      DK[w] += ak;
    }
    // dQ = ds K * scale for this tile's rows, K streamed again
    for (int w = threadIdx.x; w < n * hd; w += blockDim.x)
      DQt[(w / hd) * ldh + w % hd] = 0.0f;
    for (int c0 = 0; c0 < L; c0 += kKeys) {
      const int nk = min(kKeys, L - c0);
      __syncthreads();
      stage<T>(Kt, k, sin, b, h, c0, nk, hd);
      __syncthreads();
      for (int w = threadIdx.x; w < n * hd; w += blockDim.x) {
        const int i = w / hd, d = w % hd;
        float acc = DQt[i * ldh + d];
        for (int j = 0; j < nk; ++j) acc = fmaf(G[i * lds + c0 + j], Kt[j * ldh + d], acc);
        DQt[i * ldh + d] = acc;
      }
    }
    for (int w = threadIdx.x; w < n * hd; w += blockDim.x) {
      const int i = w / hd, d = w % hd;
      dq[at(sout, b, h, r0 + i) + d] = from_f<T>(DQt[i * ldh + d] * scale);
    }
    __syncthreads();
  }
  for (int w = threadIdx.x; w < L * hd; w += blockDim.x) {
    const int j = w / hd, d = w % hd;
    dk[at(sout, b, h, j) + d] = from_f<T>(DK[w] * scale);
    dv[at(sout, b, h, j) + d] = from_f<T>(DV[w]);
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, Strides sin,
               const float* mask, int Hm, void* out, Strides sout, int B, int H,
               int L, int hd, float scale, uint32_t seed, uint32_t thresh,
               float inv, int tiled, cudaStream_t stream) {
  auto kern = tiled ? &attn_fwd_tiled_kernel<T> : &attn_fwd_kernel<T>;
  const size_t smem = sizeof(float) * (tiled ? fwd_tiled_smem_floats(L, hd)
                                             : fwd_smem_floats(L, hd));
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, sin,
                                          mask, Hm, (T*)out, sout, H, L, hd, scale,
                                          seed, thresh, inv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, Strides sin,
               const float* mask, int Hm, const void* dout, Strides sdo,
               void* dq, void* dk, void* dv, Strides sout, float* scratch, int B,
               int H, int L, int hd, float scale, uint32_t seed, uint32_t thresh,
               float inv, cudaStream_t stream) {
  if (scratch == nullptr) {
    const size_t smem = sizeof(float) * bwd_smem_floats(L, hd);
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, sin, mask, Hm, (const T*)dout, sdo,
        (T*)dq, (T*)dk, (T*)dv, sout, H, L, hd, scale, seed, thresh, inv);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * bwd_tiled_smem_floats(L, hd);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_tiled_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, sin, mask, Hm, (const T*)dout, sdo,
      (T*)dq, (T*)dk, (T*)dv, sout, scratch, B, H, L, hd, scale, seed, thresh, inv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory of one block (ops/attention.py::kernels_take
// holds a copy; tests/test_torch_gpu.py holds the two together)
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
// threshold round(p * 2^32) (0: none) and 1/(1-p). tiled: 1 runs the tiled
// kernel. Returns a cudaError_t.
int unirec_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                         long long sib, long long sih, long long sir,
                         const float* mask, int Hm, void* out, long long sob,
                         long long soh, long long sor, int B, int H, int L,
                         int hd, float scale, unsigned seed, unsigned thresh,
                         float inv, int tiled, void* stream) {
  const Strides sin{sib, sih, sir}, sout{sob, soh, sor};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd<float>(q, k, v, sin, mask, Hm, out, sout, B, H, L, hd,
                             scale, seed, thresh, inv, tiled, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(q, k, v, sin, mask, Hm, out, sout, B, H, L,
                                     hd, scale, seed, thresh, inv, tiled, s);
  return (int)cudaErrorInvalidValue;
}

// As unirec_attention_fwd, plus dout (strides s_d*) and the three outputs
// dq, dk, dv (sharing the strides s_o*), each written whole. scratch: null
// for the whole-sequence kernel, else [2, B*H, L, hd] f32 for the tiled one.
int unirec_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                         long long sib, long long sih, long long sir,
                         const float* mask, int Hm, const void* dout,
                         long long sdb, long long sdh, long long sdr, void* dq,
                         void* dk, void* dv, long long sob, long long soh,
                         long long sor, float* scratch, int B, int H, int L, int hd,
                         float scale, unsigned seed, unsigned thresh, float inv,
                         void* stream) {
  const Strides sin{sib, sih, sir}, sdo{sdb, sdh, sdr}, sout{sob, soh, sor};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, sin, mask, Hm, dout, sdo, dq, dk, dv, sout,
                             scratch, B, H, L, hd, scale, seed, thresh, inv, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, sin, mask, Hm, dout, sdo, dq, dk,
                                     dv, sout, scratch, B, H, L, hd, scale, seed,
                                     thresh, inv, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
