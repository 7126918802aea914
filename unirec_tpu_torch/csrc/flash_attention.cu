// flash_attention: blockwise (online-softmax) attention forward with a
// general additive mask, returning the output and the row logsumexp.
//
// Replaces the TPU kernel unirec_tpu/ops/attention.py::_fwd_kernel
// (launched by _pallas_fwd, public entry flash_attention):
//   per query row i:  s_j = (f32(q_i) * scale) . f32(k_j) + mask[i, j]
//                     online softmax over key tiles from m = -inf
//   out_i = rnd(acc_i / l_i),  lse_i = m_i + log(l_i)
// The backward of the JAX package is plain XLA outside any kernel; the
// port's is plain torch ops (ops/attention.py::_flash_bwd).
//
// Layout: q, k, v are [B, H, L, hd] tensors addressed through strides
// (batch, head, row; the last axis contiguous), so the head split of the
// [B, L, H*hd] projections needs no copy, and out is written in [B, L, H,
// hd] order through its own strides. The mask is f32 addressed through
// (batch, head, row) strides as well: a model mask [B, 1, L, L] has head
// stride 0, so the [B, H, L, L] broadcast the TPU wrapper makes (the whole
// mask again per head) is never built. lse is [B, H, L] f32, contiguous.
//
// The mask is general: a row whose keys are all at the soft -1e4 attends
// uniformly over every key, so no key tile is ever skipped, and a causal
// structure is not assumed. Keys past L in a ragged last tile score -inf;
// a row whose scores are all -inf so far keeps m = -inf and adds nothing
// (the exponent is taken against 0 instead of -inf).
//
// Bound on an H100 (B=8,192, H=2, L=256, hd=32, bf16, mask [B,1,L,L] f32):
// the kernel reads q, k, v (1.07 GB with out), the 2.15 GB mask once and
// writes lse: about 0.97 ms at 3.35 TB/s; its 137 GFLOP of products take
// 0.14 ms on the bf16 tensor cores: bound by bytes, two thirds of them the
// mask. Design: one block per (example, head, tile of kQ query rows); the
// scaled query tile and the f32 accumulator stay in shared memory while
// key/value tiles of kK rows stream through it, so each q, k, v, mask
// element crosses device memory once per query tile (k and v once per
// query tile of their (example, head), from L2 after the first). Products
// run in f32 on the CUDA cores, as the TPU kernel computes them in f32.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 32;       // query rows per block
constexpr int kK = 32;       // keys per tile: one per lane of a warp
constexpr int kMaxHd = 128;  // ops/attention.py::FLASH_MAX_HEAD_DIM

__host__ __device__ inline int smem_floats(int hd) {
  // Qs, O [kQ, hd+1]; K, V [kK, hd+1]; S [kQ, kK+1]; m, l, alpha [kQ]
  return 2 * kQ * (hd + 1) + 2 * kK * (hd + 1) + kQ * (kK + 1) + 3 * kQ;
}

struct Strides {
  long long b, h, r;  // element strides of the batch, head and row axes
};

__device__ __forceinline__ size_t at(const Strides& s, int b, int h, int r) {
  return (size_t)b * s.b + (size_t)h * s.h + (size_t)r * s.r;
}

// rows [r0, r0 + n) of one head's [L, hd] operand into shared memory as f32
// times mul (leading dim hd + 1: column walks do not collide on a bank)
template <typename T>
__device__ void stage(float* dst, const T* __restrict__ src, const Strides& s,
                      int b, int h, int r0, int n, int hd, float mul) {
  for (int w = threadIdx.x; w < n * hd; w += blockDim.x) {
    const int i = w / hd, d = w % hd;
    dst[i * (hd + 1) + d] = to_f<T>(src[at(s, b, h, r0 + i) + d]) * mul;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, Strides sin,
                 const float* __restrict__ mask, Strides smask,
                 T* __restrict__ out, Strides sout, float* __restrict__ lse,
                 int H, int L, int hd, float scale) {
  extern __shared__ float smem[];
  const int ldh = hd + 1, lds = kK + 1;
  float* Qs = smem;              // [kQ, hd]  f32(q) * scale
  float* O = Qs + kQ * ldh;      // [kQ, hd]  f32 accumulator
  float* K = O + kQ * ldh;       // [kK, hd]
  float* V = K + kK * ldh;       // [kK, hd]
  float* S = V + kK * ldh;       // [kQ, kK]  scores -> exp(s - m)
  float* M = S + kQ * lds;       // [kQ]      running max
  float* Lsum = M + kQ;          // [kQ]      running sum
  float* Alpha = Lsum + kQ;      // [kQ]      this tile's rescale
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * kQ, n = min(kQ, L - r0);
  const float* mbase = mask + (size_t)b * smask.b + (size_t)h * smask.h;

  stage<T>(Qs, q, sin, b, h, r0, n, hd, scale);
  for (int w = threadIdx.x; w < kQ * ldh; w += blockDim.x) O[w] = 0.0f;
  for (int i = threadIdx.x; i < kQ; i += blockDim.x) {
    M[i] = -CUDART_INF_F;
    Lsum[i] = 0.0f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c0 = 0; c0 < L; c0 += kK) {
    const int nk = min(kK, L - c0);
    __syncthreads();  // the previous tile's K, V and S are consumed
    stage<T>(K, k, sin, b, h, c0, nk, hd, 1.0f);
    stage<T>(V, v, sin, b, h, c0, nk, hd, 1.0f);
    __syncthreads();
    // a warp takes one query row, a lane one key: Qs broadcasts, K rows
    // (stride hd + 1) hit distinct banks, the mask row reads coalesced
    for (int w = threadIdx.x; w < kQ * kK; w += blockDim.x) {
      const int i = w / kK, j = w % kK;
      float s = -CUDART_INF_F;
      if (i < n && j < nk) {
        float acc = 0.0f;
        for (int d = 0; d < hd; ++d) acc = fmaf(Qs[i * ldh + d], K[j * ldh + d], acc);
        s = acc + mbase[(size_t)(r0 + i) * smask.r + c0 + j];
      }
      S[i * lds + j] = s;
    }
    __syncthreads();
    // online softmax, one warp per row and one key per lane
    for (int i = warp; i < n; i += kThreads / 32) {
      const float s = S[i * lds + lane];
      const float m_old = M[i];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float m_use = m_new == -CUDART_INF_F ? 0.0f : m_new;
      const float p = expf(s - m_use);
      S[i * lds + lane] = p;
      const float rs = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        Alpha[i] = alpha;
        Lsum[i] = Lsum[i] * alpha + rs;
        M[i] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p V: a warp takes one row, a lane one column
    for (int w = threadIdx.x; w < n * hd; w += blockDim.x) {
      const int i = w / hd, d = w % hd;
      float acc = O[i * ldh + d] * Alpha[i];
      for (int j = 0; j < nk; ++j) acc = fmaf(S[i * lds + j], V[j * ldh + d], acc);
      O[i * ldh + d] = acc;
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n * hd; w += blockDim.x) {
    const int i = w / hd, d = w % hd;
    out[at(sout, b, h, r0 + i) + d] = from_f<T>(O[i * ldh + d] / Lsum[i]);
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    lse[(size_t)bh * L + r0 + i] = M[i] + logf(Lsum[i]);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, Strides sin,
           const float* mask, Strides smask, void* out, Strides sout, float* lse,
           int B, int H, int L, int hd, float scale, cudaStream_t stream) {
  if (hd < 1 || hd > kMaxHd || L < 1 || (L + kQ - 1) / kQ > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + kQ - 1) / kQ);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, sin, mask, smask, (T*)out, sout, lse,
      H, L, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory of one block at head width hd
int unirec_flash_fwd_smem_bytes(int hd) { return (int)sizeof(float) * smem_floats(hd); }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out). s_i*: element strides
// (batch, head, row) shared by q, k and v; s_m*: the f32 mask's (0 where it
// broadcasts); s_o*: out's. The last axis of each is contiguous. lse: [B,
// H, L] f32. scale multiplies f32(q) before the products. Returns a
// cudaError_t.
int unirec_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                     long long sib, long long sih, long long sir, const float* mask,
                     long long smb, long long smh, long long smr, void* out,
                     long long sob, long long soh, long long sor, float* lse, int B,
                     int H, int L, int hd, float scale, void* stream) {
  const Strides sin{sib, sih, sir}, smask{smb, smh, smr}, sout{sob, soh, sor};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, sin, mask, smask, out, sout, lse, B, H, L, hd,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, sin, mask, smask, out, sout, lse, B, H, L,
                                 hd, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
