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
// mask.
//
// Two bodies.
//
// bf16 inputs at head widths up to kMaxHd = 128 (flash_fwd_mma_kernel):
// one block per (example, tile of kMQ = 64 query rows) takes a group of
// heads of that example at once (all of them at head width <= 32 and H <=
// 4/hd16), so a [B, 1, L, L] mask tile
// crosses device memory once however many heads share it; a [B, H, L, L]
// mask is read per head. Four warps serve each head of the group, a warp 16
// query rows of it. Key tiles of kMK = 64 keys stream through a ring of two
// shared-memory stages filled by cp.async: K, V of the group's heads and
// the f32 mask tile of tile j+1 are in flight while tile j computes.
// Nothing else takes shared memory (the query tile comes in through a K
// buffer, the output leaves through one; the mask tile is unpadded and
// swizzled against bank conflicts), so at the path's shape two blocks of 8
// warps share an SM. S = Q K^T by mma.sync m16n8k16 (bf16 operands, f32
// sums; ldmatrix fragments), then times scale in f32 (the Pallas kernel
// scales f32 q before the product; bf16 products are exact in f32, so the
// two orders differ at f32 rounding only), plus the mask, and the online
// softmax in registers (row max over the 4 lanes of a quad; the row sum is
// kept per lane and summed over the quad at the end). P V keeps p in f32 as
// the Pallas kernel does, to about 16 bits: p = p_hi + p_lo, both bf16, two
// MMAs against bf16 V, with the score accumulators reused as the A
// fragments (P never goes to shared memory) and V through ldmatrix.trans.
// The copies move the head width padded to a multiple of 16 (the chunks
// past hd zero-filled); keys past L (ragged last tile) score -inf. The
// output goes through shared memory to 16-byte stores in [B, L, H, hd]
// order.
//
// f32 inputs, the reproducible path, and bf16 heads wider than 128
// (flash_fwd_kernel) keep the CUDA-core body of the first port, templated
// on the dtype: one block per (example, head, tile of kQ query rows); the
// scaled query tile and the f32 accumulator stay in shared memory while
// key/value tiles of kK rows stream through it; products in f32 on the CUDA
// cores, as the TPU kernel computes them in f32. It holds at most kDc = 128
// head-width columns at once, so its shared memory does not grow with the
// head width: the scores sum over column chunks of Q and K (one f32 sum per
// score carried across the chunks in the unchunked order, the mask added
// after the last chunk), and a grid axis over output-column chunks has each
// block produce kDc columns of the output, recomputing the scores; the
// first chunk's blocks write lse. At head widths up to kDc it is the first
// port's body unchanged.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 32;       // query rows per block
constexpr int kK = 32;       // keys per tile: one per lane of a warp
constexpr int kDc = 128;     // head-width columns the CUDA-core body holds at once
constexpr int kMaxHd = 128;  // the bf16 tensor-core body (ops/attention.py::_flash_body)

__host__ __device__ inline int smem_floats(int hd) {
  // Qs, O [kQ, dc+1]; K, V [kK, dc+1]; S [kQ, kK+1]; m, l, alpha [kQ]
  const int dc = hd < kDc ? hd : kDc;
  return 2 * kQ * (dc + 1) + 2 * kK * (dc + 1) + kQ * (kK + 1) + 3 * kQ;
}

struct Strides {
  long long b, h, r;  // element strides of the batch, head and row axes
};

__device__ __forceinline__ size_t at(const Strides& s, int b, int h, int r) {
  return (size_t)b * s.b + (size_t)h * s.h + (size_t)r * s.r;
}

// columns [d0, d0 + nd) of rows [r0, r0 + n) of one head's [L, hd] operand
// into shared memory as f32 times mul (leading dim ld = dc + 1: column
// walks do not collide on a bank)
template <typename T>
__device__ void stage(float* dst, int ld, const T* __restrict__ src, const Strides& s,
                      int b, int h, int r0, int n, int d0, int nd, float mul) {
  for (int w = threadIdx.x; w < n * nd; w += blockDim.x) {
    const int i = w / nd, d = w % nd;
    dst[i * ld + d] = to_f<T>(src[at(s, b, h, r0 + i) + d0 + d]) * mul;
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
  const int dc = min(hd, kDc), ldh = dc + 1, lds = kK + 1;
  float* Qs = smem;              // [kQ, dc]  a column chunk of f32(q) * scale
  float* O = Qs + kQ * ldh;      // [kQ, dc]  f32 accumulator of this block's columns
  float* K = O + kQ * ldh;       // [kK, dc]
  float* V = K + kK * ldh;       // [kK, dc]
  float* S = V + kK * ldh;       // [kQ, kK]  scores -> exp(s - m)
  float* M = S + kQ * lds;       // [kQ]      running max
  float* Lsum = M + kQ;          // [kQ]      running sum
  float* Alpha = Lsum + kQ;      // [kQ]      this tile's rescale
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * kQ, n = min(kQ, L - r0);
  const int nch = (hd + kDc - 1) / kDc;                    // column chunks of the scores
  const int o0 = blockIdx.z * kDc, no = min(kDc, hd - o0);  // this block's output columns
  const float* mbase = mask + (size_t)b * smask.b + (size_t)h * smask.h;

  if (nch == 1) stage<T>(Qs, ldh, q, sin, b, h, r0, n, 0, hd, scale);
  for (int w = threadIdx.x; w < kQ * ldh; w += blockDim.x) O[w] = 0.0f;
  for (int i = threadIdx.x; i < kQ; i += blockDim.x) {
    M[i] = -CUDART_INF_F;
    Lsum[i] = 0.0f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c0 = 0; c0 < L; c0 += kK) {
    const int nk = min(kK, L - c0);
    for (int ch = 0; ch < nch; ++ch) {
      const int d0 = ch * kDc, nd = min(kDc, hd - d0);
      const bool last = ch == nch - 1;
      __syncthreads();  // the previous chunk's or tile's Qs, K, V and S are consumed
      if (nch > 1) stage<T>(Qs, ldh, q, sin, b, h, r0, n, d0, nd, scale);
      stage<T>(K, ldh, k, sin, b, h, c0, nk, d0, nd, 1.0f);
      if (last) stage<T>(V, ldh, v, sin, b, h, c0, nk, o0, no, 1.0f);
      __syncthreads();
      // a warp takes one query row, a lane one key: Qs broadcasts, K rows
      // (stride dc + 1) hit distinct banks, the mask row reads coalesced;
      // each thread owns the same scores in every chunk
      for (int w = threadIdx.x; w < kQ * kK; w += blockDim.x) {
        const int i = w / kK, j = w % kK;
        if (i < n && j < nk) {
          float acc = ch == 0 ? 0.0f : S[i * lds + j];
          for (int d = 0; d < nd; ++d) acc = fmaf(Qs[i * ldh + d], K[j * ldh + d], acc);
          S[i * lds + j] = last ? acc + mbase[(size_t)(r0 + i) * smask.r + c0 + j] : acc;
        } else if (last) {
          S[i * lds + j] = -CUDART_INF_F;
        }
      }
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
    for (int w = threadIdx.x; w < n * no; w += blockDim.x) {
      const int i = w / no, d = w % no;
      float acc = O[i * ldh + d] * Alpha[i];
      for (int j = 0; j < nk; ++j) acc = fmaf(S[i * lds + j], V[j * ldh + d], acc);
      O[i * ldh + d] = acc;
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n * no; w += blockDim.x) {
    const int i = w / no, d = w % no;
    out[at(sout, b, h, r0 + i) + o0 + d] = from_f<T>(O[i * ldh + d] / Lsum[i]);
  }
  if (blockIdx.z == 0)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      lse[(size_t)bh * L + r0 + i] = M[i] + logf(Lsum[i]);
}

template <typename T>
int launch_cuda_cores(const void* q, const void* k, const void* v, Strides sin,
                      const float* mask, Strides smask, void* out, Strides sout, float* lse,
                      int B, int H, int L, int hd, float scale, cudaStream_t stream) {
  if (hd < 1 || L < 1 || (L + kQ - 1) / kQ > 65535 || (hd + kDc - 1) / kDc > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (L + kQ - 1) / kQ, (hd + kDc - 1) / kDc);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, sin, mask, smask, (T*)out, sout, lse, H, L, hd,
      scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 body
constexpr int kMQ = 64;  // query rows per block: 4 warps x 16
constexpr int kMK = 64;  // keys per tile (== kMQ: Q and the output use a K buffer)
constexpr float kLog2e = 1.4426950408889634f;

// heads one block takes at once at head width 16 * hd16: the accumulators
// of the group stay at 16 rows x 64 columns f32 per warp
__host__ __device__ constexpr int head_group(int hd16) { return hd16 >= 4 ? 1 : 4 / hd16; }

// two stages of [G][kMK][ldh] bf16 K and V and [MG][kMQ][kMK] f32 mask tiles
__host__ __device__ inline int mma_smem_bytes(int hd, int H, bool mask_heads) {
  const int hd16 = (hd + 15) / 16, ldh = hd16 * 16 + 8;
  const int G = head_group(hd16) < H ? head_group(hd16) : H, MG = mask_heads ? G : 1;
  return 2 * (2 * G * kMK * ldh * 2 + MG * kMQ * kMK * 4);
}

// The f32 mask tile keeps rows of kMK floats unpadded; its 16-byte chunks
// are swizzled so that a quad's float2 reads of 4 rows hit distinct banks.
__device__ __forceinline__ int mask_at(int i, int j) {
  return i * kMK + ((((j >> 2) ^ ((i & 3) << 1))) << 2) + (j & 3);
}

// 2^x in one instruction (relative error about 2^-22; results below 2^-126
// flush to 0, which no sum of probabilities can see)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + kMK) of nh heads' [., hd] bf16 operand into dst [nh][kMK]
// [ldh], one 16-byte chunk per thread and step over CH chunks a row (the
// padded head width, known at compile time); rows past L and the chunks
// past hd are zero-filled.
// A second operand with the same strides (V beside K) rides on the same
// index arithmetic when src2 is given.
template <int CH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, __nv_bfloat16* dst2, int ldh,
                                          const __nv_bfloat16* __restrict__ src,
                                          const __nv_bfloat16* __restrict__ src2,
                                          const Strides& s, int b, int h0, int nh, int r0,
                                          int L, int hd) {
  constexpr int per_head = kMK * CH;
  for (int w = threadIdx.x; w < nh * per_head; w += blockDim.x) {
    const int hh = w / per_head, i = (w / CH) % kMK, c = w % CH, r = r0 + i;
    const bool in = r < L && c * 8 < hd;
    const int to = (hh * kMK + i) * ldh + c * 8;
    const size_t from = at(s, b, h0 + hh, in ? r : 0) + (in ? c * 8 : 0);
    cp_async16(dst + to, src + from, in);
    if (src2 != nullptr) cp_async16(dst2 + to, src2 + from, in);
  }
}

// A block has four warps per head of its group; each warp owns 16 query
// rows of one head. At head width 32 and H = 2 that is 8 warps and 72 KB of
// shared memory, two blocks per SM with registers held to 128 a thread; at
// head widths 33-64 (one head a block) three blocks of 4 warps.
template <int HD16>
__global__ void __launch_bounds__(kThreads * head_group(HD16),
                                  HD16 == 1 ? 1 : HD16 == 2 ? 2 : HD16 <= 4 ? 3 : 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, Strides sin,
                     const float* __restrict__ mask, Strides smask,
                     __nv_bfloat16* __restrict__ out, Strides sout,
                     float* __restrict__ lse, int H, int L, int hd, float scale) {
  constexpr int HG = head_group(HD16), HDP = HD16 * 16, LDH = HDP + 8, NDT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = min(HG, H);
  const bool mask_heads = smask.h != 0;
  const int MG = mask_heads ? G : 1;
  const size_t kv = (size_t)G * kMK * LDH;  // elements of one K or V stage
  const size_t stage_bytes = 2 * kv * 2 + (size_t)MG * kMQ * kMK * 4;
  auto Ks = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * stage_bytes); };
  auto Vs = [&](int s) { return Ks(s) + kv; };
  auto Ms = [&](int s) { return reinterpret_cast<float*>(Vs(s) + kv); };
  // the query tile arrives in stage 1's K buffer, whose tile is copied only
  // after the fragments are read; the output leaves through stage 0's
  __nv_bfloat16* Qs = Ks(1);
  __nv_bfloat16* Os = Ks(0);

  const int nqt = (L + kMQ - 1) / kMQ;
  const int b = blockIdx.x / nqt, r0 = (blockIdx.x % nqt) * kMQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int hh = warp >> 2, row0 = (warp & 3) * 16;  // this warp's head in the group, rows
  const int nkt = (L + kMK - 1) / kMK;

  for (int h0 = 0; h0 < H; h0 += G) {
    const int ng = min(G, H - h0);
    const int nm = mask_heads ? ng : 1;
    const bool active = hh < ng;  // the last group may hold fewer heads
    auto load_tile = [&](int s, int kt) {
      const int c0 = kt * kMK;
      load_rows<2 * HD16>(Ks(s), Vs(s), LDH, k, v, sin, b, h0, ng, c0, L, hd);
      float* M = Ms(s);
      constexpr int ch = kMK / 4;  // 16-byte chunks of a mask tile row
      for (int w = threadIdx.x; w < nm * kMQ * ch; w += blockDim.x) {
        const int mh = w / (kMQ * ch), i = (w / ch) % kMQ, c = w % ch;
        const int r = r0 + i, col = c0 + 4 * c;
        const bool in = r < L && col < L;
        const float* src = mask + (size_t)b * smask.b + (size_t)(h0 + mh) * smask.h +
                           (size_t)(in ? r : 0) * smask.r + (in ? col : 0);
        cp_async16(M + mh * kMQ * kMK + mask_at(i, 4 * c), src, in);
      }
    };
    load_rows<2 * HD16>(Qs, nullptr, LDH, q, nullptr, sin, b, h0, ng, r0, L, hd);
    load_tile(0, 0);
    cp_async_commit();

    uint32_t qf[HD16][4];
    float acc[NDT][4], mrow[2] = {-CUDART_INF_F, -CUDART_INF_F}, lrow[2] = {0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d < NDT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;

    for (int kt = 0; kt < nkt; ++kt) {
      if (kt == 0) {  // the query tile and key tile 0 have landed
        cp_async_wait<0>();
        __syncthreads();
        if (active)
#pragma unroll
          for (int kc = 0; kc < HD16; ++kc)
            ldmatrix_x4(qf[kc], Qs + (hh * kMQ + row0 + (lane & 15)) * LDH + kc * 16 +
                                    (lane >> 4) * 8);
        __syncthreads();  // Qs is read: stage 1 may take tile 1
      }
      if (kt + 1 < nkt) {
        load_tile((kt + 1) & 1, kt + 1);
        cp_async_commit();
      }
      if (kt > 0) {
        if (kt + 1 < nkt)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        __syncthreads();
      }
      if ((kt + 1) * kMK > L) {  // a ragged last tile: keys past L score -inf
        const int nk = L - kt * kMK, wide = kMK - nk;
        float* M = Ms(kt & 1);
        for (int w = threadIdx.x; w < nm * kMQ * wide; w += blockDim.x) {
          const int mh = w / (kMQ * wide), i = (w / wide) % kMQ;
          M[mh * kMQ * kMK + mask_at(i, nk + w % wide)] = -CUDART_INF_F;
        }
        __syncthreads();
      }
      if (active) {
        const __nv_bfloat16* K = Ks(kt & 1) + hh * kMK * LDH;
        const __nv_bfloat16* V = Vs(kt & 1) + hh * kMK * LDH;
        const float* Mh = Ms(kt & 1) + (mask_heads ? hh : 0) * kMQ * kMK;
        // S = Q K^T: 8 key tiles of 8, k over the padded head width
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
        for (int kc = 0; kc < HD16; ++kc)
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bk[4];
            ldmatrix_x4(bk, K + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDH + kc * 16 +
                                ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qf[kc], bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qf[kc], bk[2], bk[3]);
          }
        // scale, mask; the tile's row max over the quad
        float tmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = row0 + g + r * 8, j = n * 8 + 2 * t;
            const float2 mk = *reinterpret_cast<const float2*>(Mh + mask_at(i, j));
            s[n][2 * r] = s[n][2 * r] * scale + mk.x;
            s[n][2 * r + 1] = s[n][2 * r + 1] * scale + mk.y;
            tmax[r] = fmaxf(tmax[r], fmaxf(s[n][2 * r], s[n][2 * r + 1]));
          }
        float alpha[2], m_use[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
          const float m_new = fmaxf(mrow[r], tmax[r]);
          m_use[r] = m_new == -CUDART_INF_F ? 0.0f : m_new;
          alpha[r] = exp2_fast((mrow[r] - m_use[r]) * kLog2e);
          mrow[r] = m_new;
          lrow[r] *= alpha[r];
        }
        // exp(x) as exp2(x log2 e): the difference x - m is exact as before,
        // its product with log2 e adds 2^-24 of it (|x - m| < 20 where p
        // counts)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = exp2_fast((s[n][e] - m_use[e >> 1]) * kLog2e);
            lrow[e >> 1] += s[n][e];
          }
#pragma unroll
        for (int d = 0; d < NDT; ++d) {
          acc[d][0] *= alpha[0];
          acc[d][1] *= alpha[0];
          acc[d][2] *= alpha[1];
          acc[d][3] *= alpha[1];
        }
        // acc += p_hi V + p_lo V, 16 keys per step
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          // A fragment r: tile 2kc + r/2, rows g (r even) or g+8 (r odd)
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x0 = s[2 * kc + r / 2][2 * (r & 1)];
            const float x1 = s[2 * kc + r / 2][2 * (r & 1) + 1];
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
            hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
            lo[r] = pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
          }
#pragma unroll
          for (int dp = 0; dp < HD16; ++dp) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, V + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH +
                                      dp * 16 + (lane >> 4) * 8);
            mma_bf16(acc[2 * dp], hi, bv[0], bv[1]);
            mma_bf16(acc[2 * dp], lo, bv[0], bv[1]);
            mma_bf16(acc[2 * dp + 1], hi, bv[2], bv[3]);
            mma_bf16(acc[2 * dp + 1], lo, bv[2], bv[3]);
          }
        }
      }
      __syncthreads();  // this stage is consumed before the next copy into it
    }

    // out = rnd(acc / l) through Os (every stage is consumed), lse
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = lrow[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int i = row0 + g + r * 8;
#pragma unroll
        for (int d = 0; d < NDT; ++d)
          *reinterpret_cast<__nv_bfloat162*>(Os + (hh * kMQ + i) * LDH + d * 8 + 2 * t) =
              __floats2bfloat162_rn(acc[d][2 * r] / l, acc[d][2 * r + 1] / l);
        if (t == 0 && r0 + i < L)
          lse[((size_t)b * H + h0 + hh) * L + r0 + i] = mrow[r] + logf(l);
      }
    }
    __syncthreads();
    constexpr int ch = 2 * HD16;  // 16-byte chunks of an output row
    for (int w = threadIdx.x; w < ng * kMQ * ch; w += blockDim.x) {
      const int oh = w / (kMQ * ch), i = (w / ch) % kMQ, c = w % ch;
      if (r0 + i < L && c * 8 < hd)
        *reinterpret_cast<uint4*>(out + at(sout, b, h0 + oh, r0 + i) + c * 8) =
            *reinterpret_cast<const uint4*>(Os + (oh * kMQ + i) * LDH + c * 8);
    }
    __syncthreads();  // the stages are free for the next head group
  }
}

template <int HD16>
int launch_mma_hd(const void* q, const void* k, const void* v, Strides sin,
                  const float* mask, Strides smask, void* out, Strides sout, float* lse,
                  int B, int H, int L, int hd, float scale, cudaStream_t stream) {
  const int smem = mma_smem_bytes(hd, H, smask.h != 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * ((L + kMQ - 1) / kMQ);
  const int threads = kThreads * (head_group(HD16) < H ? head_group(HD16) : H);
  flash_fwd_mma_kernel<HD16><<<(unsigned)blocks, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, sin, mask,
      smask, (__nv_bfloat16*)out, sout, lse, H, L, hd, scale);
  return (int)cudaGetLastError();
}

// The copies move 16 bytes: q, k, v, out and the mask need 16-byte aligned
// rows (ops/attention.py::_flash_fwd_cuda copies an operand that has none).
int launch_bf16(const void* q, const void* k, const void* v, Strides sin,
                const float* mask, Strides smask, void* out, Strides sout, float* lse,
                int B, int H, int L, int hd, float scale, cudaStream_t stream) {
  if (hd > kMaxHd)
    return launch_cuda_cores<__nv_bfloat16>(q, k, v, sin, mask, smask, out, sout, lse, B, H,
                                            L, hd, scale, stream);
  if (hd < 8 || hd % 8 || L < 1 || L % 4) return (int)cudaErrorInvalidValue;
  switch ((hd + 15) / 16) {
#define UNIREC_FLASH_HD(n) \
  case n:                  \
    return launch_mma_hd<n>(q, k, v, sin, mask, smask, out, sout, lse, B, H, L, hd, scale, stream);
    UNIREC_FLASH_HD(1) UNIREC_FLASH_HD(2) UNIREC_FLASH_HD(3) UNIREC_FLASH_HD(4)
    UNIREC_FLASH_HD(5) UNIREC_FLASH_HD(6) UNIREC_FLASH_HD(7) UNIREC_FLASH_HD(8)
#undef UNIREC_FLASH_HD
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory of one block: the CUDA-core body's (f32,
// and bf16 above head width kMaxHd) at head width hd, or the bf16
// tensor-core body's at head width hd with H heads and a mask per head
// (mask_heads != 0) or shared by the heads (ops/attention.py::_flash_body
// and _flash_smem_bytes hold copies of the rule)
int unirec_flash_fwd_smem_bytes(int dtype, int hd, int H, int mask_heads) {
  return dtype == 0 || hd > kMaxHd ? (int)sizeof(float) * smem_floats(hd)
                                   : mma_smem_bytes(hd, H, mask_heads != 0);
}

// 1 when the bf16 tensor-core body runs (dtype 1, head width up to kMaxHd;
// ops/attention.py::_flash_body holds a copy of the rule): its operands need
// 16-byte aligned rows
int unirec_flash_fwd_mma_takes(int dtype, int hd) { return dtype == 1 && hd <= kMaxHd; }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out). s_i*: element strides
// (batch, head, row) shared by q, k and v; s_m*: the f32 mask's (0 where it
// broadcasts); s_o*: out's. The last axis of each is contiguous. lse: [B,
// H, L] f32. scale multiplies f32(q) before the products (the CUDA-core
// body) or the f32 scores (the bf16 tensor-core body). Returns a
// cudaError_t.
int unirec_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                     long long sib, long long sih, long long sir, const float* mask,
                     long long smb, long long smh, long long smr, void* out,
                     long long sob, long long soh, long long sor, float* lse, int B,
                     int H, int L, int hd, float scale, void* stream) {
  const Strides sin{sib, sih, sir}, smask{smb, smh, smr}, sout{sob, soh, sor};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_cuda_cores<float>(q, k, v, sin, mask, smask, out, sout, lse, B, H, L, hd,
                                    scale, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, sin, mask, smask, out, sout, lse, B, H, L, hd, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
