// blockmax: per-16-item-chunk maxima of user x item scores, [B, ceil(N/16)].
//
// Replaces the TPU kernels unirec_tpu/ops/topk.py::_blockmax_kernel and
// _blockmax_kernel_q (launched by catalog_blockmax, pass 1 of
// fused_catalog_topk): out[b, c] = max over items i of chunk c of
// u[b] . item[i], accumulated in f32, without writing the [B, N] scores.
// The int8 bodies convert items exactly (to bf16 or f32) and multiply each
// item's dot product by its per-row scale before the max, as
// _blockmax_kernel_q does. Items past N (the ragged last chunk) never enter
// a max; the TPU's [items, users] transposed layout is not needed here.
//
// Bound on an H100: reading the catalog once per call (6.4 MB of bf16 at
// N=50,000, D=64) plus writing [B, N/16] f32 (3.2 MB at B=256) is ~2.9 us;
// the 1.6 GFLOP of products is ~1.7 us on the bf16 tensor cores. The output
// is a third of those bytes.
//
// Two bodies; the rule mma_takes picks one (ops/topk.py::_blockmax_body
// holds a copy, checked against unirec_blockmax_mma_takes).
//
// Tensor-core body (blockmax_mma_kernel), for bf16 users with bf16 or int8
// items and D <= 128: mma.sync m16n8k16 with the items as the M side, so
// one m16 tile is exactly one 16-item chunk and the chunk's max is the
// tile's column max: a thread takes the max of its two accumulator rows,
// then the warp reduces its 8 values a lane (4 n-tiles x 2 users) over
// lane bits 2-4 as a transpose, each step halving the values a lane holds
// (4 + 2 + 1 shuffles a chunk, not 3 for each of the 8), and every lane
// ends with one user's maximum. The users are the N side and D the K side, zero-
// padded in shared memory to a multiple of 16 (exact), so D=65 (the item
// bias column) takes it too. A block holds 256 users (32 a warp, their B
// fragments in registers for the whole call) and walks item tiles of 128
// (8 chunks) with a stride of the grid, which comes from the SM count, not
// from N: any catalog size launches. Each thread loads its share of the
// next tile as 16-byte words into registers while the warps multiply the
// current one (int8 words become bf16 on their way into shared memory,
// exact: bf16 x bf16 products of 8-bit mantissas sum exactly in f32, as in
// the JAX kernel). A tile's maxima are staged in shared memory and leave as
// each user's run of 8 consecutive chunks (32 bytes).
//
// CUDA-core body (blockmax_kernel), the first port's, for f32 users or f32
// items and wider D: a block scores a tile of 64 users x 256 items (16
// chunks), staged in shared memory in 32-wide slices of D; a thread owns 4
// users x one whole 16-item chunk, so the chunk max is a register
// reduction. The products run on the CUDA cores in f32, so it is bound by
// arithmetic, well above the memory bound, and its grid's y dimension
// holds at most 65,535 x 256 items.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kChunk = 16;                     // items per chunk
constexpr int kChunksPerBlock = 16;            // -> 256 items per block
constexpr int kItems = kChunk * kChunksPerBlock;
constexpr int kUsersPerThread = 4;
constexpr int kUserGroups = 16;                // threads per chunk
constexpr int kUsers = kUsersPerThread * kUserGroups;  // 64 users per block
constexpr int kThreads = kChunksPerBlock * kUserGroups;  // 256
constexpr int kSlice = 32;                     // D staged 32 columns at a time
constexpr int kLd = kSlice + 1;

template <typename TU, typename TI, bool kScaled>
__global__ void __launch_bounds__(kThreads)
blockmax_kernel(const TU* __restrict__ u, const TI* __restrict__ items,
                const float* __restrict__ scale, float* __restrict__ out,
                int B, int N, int D, int nb) {
  __shared__ float Is[kItems * kLd];
  __shared__ float Us[kUsers * kLd];
  __shared__ float Os[kUsers * (kChunksPerBlock + 1)];
  const int u0 = blockIdx.x * kUsers;
  const int i0 = blockIdx.y * kItems;
  const int chunk = threadIdx.x / kUserGroups;  // 0..15
  const int g = threadIdx.x % kUserGroups;      // users g, g+16, g+32, g+48

  float acc[kUsersPerThread][kChunk];
#pragma unroll
  for (int j = 0; j < kUsersPerThread; ++j)
#pragma unroll
    for (int i = 0; i < kChunk; ++i) acc[j][i] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += kSlice) {
    for (int t = threadIdx.x; t < kItems * kSlice; t += kThreads) {
      const int r = t / kSlice, c = t % kSlice;
      const int item = i0 + r, k = k0 + c;
      Is[r * kLd + c] = (item < N && k < D) ? to_f<TI>(items[(size_t)item * D + k]) : 0.0f;
    }
    for (int t = threadIdx.x; t < kUsers * kSlice; t += kThreads) {
      const int r = t / kSlice, c = t % kSlice;
      const int user = u0 + r, k = k0 + c;
      Us[r * kLd + c] = (user < B && k < D) ? to_f<TU>(u[(size_t)user * D + k]) : 0.0f;
    }
    __syncthreads();
    const float* it = Is + chunk * kChunk * kLd;
#pragma unroll 4
    for (int c = 0; c < kSlice; ++c) {
      float uv[kUsersPerThread];
#pragma unroll
      for (int j = 0; j < kUsersPerThread; ++j) uv[j] = Us[(g + kUserGroups * j) * kLd + c];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float iv = it[i * kLd + c];
#pragma unroll
        for (int j = 0; j < kUsersPerThread; ++j) acc[j][i] = fmaf(uv[j], iv, acc[j][i]);
      }
    }
    __syncthreads();
  }

  const int first = i0 + chunk * kChunk;
#pragma unroll
  for (int j = 0; j < kUsersPerThread; ++j) {
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (first + i < N) {
        const float s = kScaled ? acc[j][i] * scale[first + i] : acc[j][i];
        m = fmaxf(m, s);
      }
    }
    Os[(g + kUserGroups * j) * (kChunksPerBlock + 1) + chunk] = m;
  }
  __syncthreads();
  const int c0 = blockIdx.y * kChunksPerBlock;
  for (int t = threadIdx.x; t < kUsers * kChunksPerBlock; t += kThreads) {
    const int r = t / kChunksPerBlock, c = t % kChunksPerBlock;
    if (u0 + r < B && c0 + c < nb)
      out[(size_t)(u0 + r) * nb + c0 + c] = Os[r * (kChunksPerBlock + 1) + c];
  }
}

template <typename TU, typename TI, bool kScaled>
int launch_cuda(const void* u, const void* items, const float* scale, float* out,
           int B, int N, int D, cudaStream_t stream) {
  const int nb = (N + kChunk - 1) / kChunk;
  dim3 grid((B + kUsers - 1) / kUsers, (N + kItems - 1) / kItems);
  blockmax_kernel<TU, TI, kScaled><<<grid, kThreads, 0, stream>>>(
      (const TU*)u, (const TI*)items, scale, out, B, N, D, nb);
  return (int)cudaGetLastError();
}

template <typename TU>
int dispatch_items(int item_dtype, const void* u, const void* items,
                   const float* scale, float* out, int B, int N, int D,
                   cudaStream_t s) {
  if (item_dtype == 0) return launch_cuda<TU, float, false>(u, items, scale, out, B, N, D, s);
  if (item_dtype == 1)
    return launch_cuda<TU, __nv_bfloat16, false>(u, items, scale, out, B, N, D, s);
  if (item_dtype == 2) return launch_cuda<TU, int8_t, true>(u, items, scale, out, B, N, D, s);
  return (int)cudaErrorInvalidValue;
}


// ------------------------------------------------------ tensor-core body
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaUsers = 32 * kMmaWarps;         // 32 a warp: 4 n-tiles
constexpr int kTileItems = 128;                   // items a tile
constexpr int kTileChunks = kTileItems / kChunk;  // 8 m-tiles
constexpr int kOsLd = kTileChunks + 1;            // staged maxima, padded against conflicts
constexpr int kMmaMaxD = 128;
constexpr int kMaxDevices = 64;

// 1 when the tensor-core body takes user_dtype / item_dtype (the codes of
// unirec_blockmax) at width D
inline bool mma_takes(int udt, int idt, int D) {
  return udt == 1 && (idt == 1 || idt == 2) && D >= 1 && D <= kMmaMaxD;
}

// row stride of the bf16 user and item tiles in shared memory, in elements:
// D padded to KS * 16, plus 8, so ldmatrix's eight rows fall in distinct banks
__host__ __device__ constexpr int mma_ld(int KS) { return KS * 16 + 8; }

__host__ __device__ constexpr int mma_smem_bytes(int KS) {
  return (kMmaUsers + kTileItems) * mma_ld(KS) * 2 + (kMmaUsers * kOsLd + kTileItems) * 4;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// element j of a 16-byte word of ES-byte elements (2: bf16 bits, 1: int8),
// as bf16
template <int ES>
__device__ __forceinline__ __nv_bfloat16 elem_of(const uint4& v, int j) {
  const uint32_t w = word_of(v, (j * ES) >> 2);
  if (ES == 2) return __ushort_as_bfloat16((unsigned short)(w >> (16 * (j & 1))));
  return __float2bfloat16((float)(int8_t)((w >> (8 * (j & 3))) & 0xffu));
}

// This thread's V 16-byte words of a flat run of ES-byte elements at src
// (16-byte aligned), of which the first `lim` exist; the rest read as zero.
// Word q = i * kMmaThreads + tid.
template <int ES, int V>
__device__ __forceinline__ void load_words(uint4 (&v)[V], const unsigned char* src, int lim) {
  constexpr int EV = 16 / ES;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e0 = (i * kMmaThreads + threadIdx.x) * EV;
    if (e0 + EV <= lim) {
      v[i] = __ldg(reinterpret_cast<const uint4*>(src + e0 * ES));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < EV; ++j) {
        if (e0 + j < lim) {
          const uint32_t x = ES == 2
              ? (uint32_t)*reinterpret_cast<const unsigned short*>(src + (e0 + j) * 2)
              : (uint32_t)src[e0 + j];
          w[(j * ES) >> 2] |= x << (8 * ((j * ES) & 3));
        }
      }
      v[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The words of load_words into rows of D bf16 at dst (row stride LD), n
// elements. A word within one row (D a multiple of its element count) is
// one or two 16-byte stores; else element by element.
template <int ES, int V>
__device__ __forceinline__ void store_words(const uint4 (&v)[V], __nv_bfloat16* dst, int LD,
                                            int D, int n) {
  constexpr int EV = 16 / ES;
  const bool whole = D % EV == 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e0 = (i * kMmaThreads + threadIdx.x) * EV;
    if (e0 >= n) continue;
    int r = e0 / D, c = e0 - r * D;
    if (whole) {
      if (ES == 2) {
        *reinterpret_cast<uint4*>(dst + r * LD + c) = v[i];
      } else {
        uint32_t p[8];
#pragma unroll
        for (int h = 0; h < 8; ++h)
          p[h] = pack_bf16(__bfloat162float(elem_of<ES>(v[i], 2 * h)),
                           __bfloat162float(elem_of<ES>(v[i], 2 * h + 1)));
        uint4* q = reinterpret_cast<uint4*>(dst + r * LD + c);
        q[0] = make_uint4(p[0], p[1], p[2], p[3]);
        q[1] = make_uint4(p[4], p[5], p[6], p[7]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < EV; ++j) {
        if (e0 + j < n) dst[r * LD + c] = elem_of<ES>(v[i], j);
        if (++c == D) {
          c = 0;
          ++r;
        }
      }
    }
  }
}

// KS: D padded to KS * 16; ES: bytes of an item element (2: bf16, 1: int8
// with a scale). Grid: x walks item tiles with stride gridDim.x, y the
// groups of 256 users.
// max over lane bits 2-4 (the accumulator row group g) of each of x[0..7],
// as a transpose: lane g ends with the maximum of x[g]
__device__ __forceinline__ float max_over_rows(const float (&x)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float y[4], z[2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = fmaxf(b4 ? x[j + 4] : x[j],
                 __shfl_xor_sync(0xffffffffu, b4 ? x[j] : x[j + 4], 16));
#pragma unroll
  for (int j = 0; j < 2; ++j)
    z[j] = fmaxf(b3 ? y[j + 2] : y[j],
                 __shfl_xor_sync(0xffffffffu, b3 ? y[j] : y[j + 2], 8));
  return fmaxf(b2 ? z[1] : z[0], __shfl_xor_sync(0xffffffffu, b2 ? z[0] : z[1], 4));
}

template <int KS, int ES>
__global__ void __launch_bounds__(kMmaThreads, 2)
blockmax_mma_kernel(const __nv_bfloat16* __restrict__ u, const unsigned char* __restrict__ items,
                    const float* __restrict__ scale, float* __restrict__ out, int B, int N,
                    int D, int nb) {
  constexpr int LD = mma_ld(KS), DP = KS * 16;
  constexpr int kUserWords = (kMmaUsers * DP * 2 / 16 + kMmaThreads - 1) / kMmaThreads;
  constexpr int kItemWords = (kTileItems * DP * ES / 16 + kMmaThreads - 1) / kMmaThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Us = reinterpret_cast<__nv_bfloat16*>(smem);  // [kMmaUsers][LD]
  __nv_bfloat16* Is = Us + kMmaUsers * LD;                     // [kTileItems][LD]
  float* Os = reinterpret_cast<float*>(Is + kTileItems * LD);  // [kMmaUsers][kOsLd]
  float* Ss = Os + kMmaUsers * kOsLd;                          // [kTileItems] int8 scales
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int u0 = blockIdx.y * kMmaUsers;
  const int nu = min(kMmaUsers, B - u0);

  // this group's users (zero rows past B), and zero columns D..DP of both
  // tiles, which the item stores never touch
  {
    uint4 w[kUserWords];
    load_words<2, kUserWords>(w, reinterpret_cast<const unsigned char*>(u + (size_t)u0 * D),
                              nu * D);
    store_words<2, kUserWords>(w, Us, LD, D, kMmaUsers * D);
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int e = tid; e < (kMmaUsers + kTileItems) * (DP - D); e += kMmaThreads)
    Us[(e / (DP - D)) * LD + D + e % (DP - D)] = zero;
  __syncthreads();

  // the warp's 32 users as B fragments, for the whole call
  uint32_t bfr[4][KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b4[4];
      frag_b(b4, Us, LD, warp * 32 + np * 16, ks * 16, lane);
      bfr[2 * np][ks][0] = b4[0];
      bfr[2 * np][ks][1] = b4[1];
      bfr[2 * np + 1][ks][0] = b4[2];
      bfr[2 * np + 1][ks][1] = b4[3];
    }
  const int nact = max(0, min(4, (nu - warp * 32 + 7) / 8));  // n-tiles holding a user

  const int ntiles = (N + kTileItems - 1) / kTileItems;
  const long long total = (long long)N * D;
  const int tile_elems = kTileItems * D;
  // elements of tile jj that exist (the last one may be short)
  const auto tile_lim = [&](int jj) {
    return (int)min((long long)tile_elems, total - (long long)jj * tile_elems);
  };
  // the next tile's share of this thread: item words, and (int8) one scale
  uint4 v[kItemWords];
  float sv = 0.0f;
  const auto prefetch = [&](int jj) {
    load_words<ES, kItemWords>(v, items + (long long)jj * tile_elems * ES, tile_lim(jj));
    if (ES == 1) {
      const int i = jj * kTileItems + tid;
      sv = tid < kTileItems && i < N ? __ldg(scale + i) : 0.0f;
    }
  };
  int j = blockIdx.x;
  if (j < ntiles) prefetch(j);
  for (; j < ntiles; j += gridDim.x) {
    store_words<ES, kItemWords>(v, Is, LD, D, tile_elems);
    if (ES == 1 && tid < kTileItems) Ss[tid] = sv;
    __syncthreads();  // the tile is in; the last tile's maxima have left
    const int jn = j + gridDim.x;
    if (jn < ntiles) prefetch(jn);  // in flight during the products
    if (nact > 0) {
      for (int m = 0; m < kTileChunks; ++m) {
        const int i0 = j * kTileItems + m * kChunk;  // the chunk's first item
        if (i0 >= N) break;
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t a[4];
          frag_a(a, Is, LD, m * kChunk, ks * 16, lane);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            if (nt < nact) mma_bf16(acc[nt], a, bfr[nt][ks][0], bfr[nt][ks][1]);
        }
        // rows g and g + 8 of the chunk, scaled for int8; an item at or past
        // N never wins (masks only in the last, short chunk)
        float sa = 1.0f, sb = 1.0f;
        if (ES == 1) {
          sa = Ss[m * kChunk + g];
          sb = Ss[m * kChunk + g + 8];
        }
        float x[8];  // x[2 nt + e]: user 32 warp + 8 nt + 2 t + e
        if (i0 + kChunk <= N) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              x[2 * nt + e] = fmaxf(acc[nt][e] * sa, acc[nt][2 + e] * sb);
        } else {
          const bool va = i0 + g < N, vb = i0 + g + 8 < N;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              x[2 * nt + e] = fmaxf(va ? acc[nt][e] * sa : -CUDART_INF_F,
                                    vb ? acc[nt][2 + e] * sb : -CUDART_INF_F);
        }
        const int r = warp * 32 + (g >> 1) * 8 + 2 * t + (g & 1);
        Os[r * kOsLd + m] = max_over_rows(x, lane);
      }
    }
    __syncthreads();  // the maxima are staged; the tile may be overwritten
    // each user's run of kTileChunks maxima, 32 bytes, four users a warp store
    const int c0 = j * kTileChunks;
#pragma unroll
    for (int i = 0; i < kMmaUsers * kTileChunks / kMmaThreads; ++i) {
      const int e = i * kMmaThreads + tid, r = e / kTileChunks, c = e % kTileChunks;
      if (r < nu && c0 + c < nb) out[(size_t)(u0 + r) * nb + c0 + c] = Os[r * kOsLd + c];
    }
  }
}

// blocks of the tensor-core body that fit on the card at once: set its
// shared-memory attribute and read its occupancy once per device
template <int KS, int ES>
cudaError_t mma_resident_blocks(int* blocks) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  const int smem = mma_smem_bytes(KS);
  if ((err = cudaFuncSetAttribute(blockmax_mma_kernel<KS, ES>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, blockmax_mma_kernel<KS, ES>,
                                                           kMmaThreads, smem)) != cudaSuccess)
    return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

template <int KS, int ES>
int launch_mma(const void* u, const void* items, const float* scale, float* out, int B, int N,
               int D, cudaStream_t stream) {
  const int nb = (N + kChunk - 1) / kChunk;
  const int ntiles = (N + kTileItems - 1) / kTileItems;
  const int groups = (B + kMmaUsers - 1) / kMmaUsers;
  if (ntiles == 0) return (int)cudaSuccess;  // no items: out has no columns
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = mma_resident_blocks<KS, ES>(&blocks);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(max(1, min(ntiles, blocks / groups)), groups);
  blockmax_mma_kernel<KS, ES><<<grid, kMmaThreads, mma_smem_bytes(KS), stream>>>(
      (const __nv_bfloat16*)u, (const unsigned char*)items, scale, out, B, N, D, nb);
  return (int)cudaGetLastError();
}

template <int ES>
int dispatch_mma(const void* u, const void* items, const float* scale, float* out, int B,
                 int N, int D, cudaStream_t s) {
  switch ((D + 15) / 16) {
    case 1: return launch_mma<1, ES>(u, items, scale, out, B, N, D, s);
    case 2: return launch_mma<2, ES>(u, items, scale, out, B, N, D, s);
    case 3: return launch_mma<3, ES>(u, items, scale, out, B, N, D, s);
    case 4: return launch_mma<4, ES>(u, items, scale, out, B, N, D, s);
    case 5: return launch_mma<5, ES>(u, items, scale, out, B, N, D, s);
    case 6: return launch_mma<6, ES>(u, items, scale, out, B, N, D, s);
    case 7: return launch_mma<7, ES>(u, items, scale, out, B, N, D, s);
    default: return launch_mma<8, ES>(u, items, scale, out, B, N, D, s);
  }
}

}  // namespace

extern "C" {

// 1 when the tensor-core body takes user_dtype / item_dtype (codes below)
// at width D
int unirec_blockmax_mma_takes(int user_dtype, int item_dtype, int D) {
  return (int)mma_takes(user_dtype, item_dtype, D);
}

// user_dtype: 0 = float32, 1 = bfloat16; item_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 with a float32 per-item scale. out: [B, ceil(N/16)]
// float32. mma 1 runs the tensor-core body, which takes only what
// unirec_blockmax_mma_takes admits, with u and items 16-byte aligned; mma 0
// the CUDA-core body. Returns a cudaError_t.
int unirec_blockmax(int user_dtype, int item_dtype, const void* u,
                    const void* items, const float* scale, float* out, int B,
                    int N, int D, int mma, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return 0;
  if (mma) {
    if (!mma_takes(user_dtype, item_dtype, D)) return (int)cudaErrorInvalidValue;
    if (item_dtype == 1) return dispatch_mma<2>(u, items, scale, out, B, N, D, s);
    return dispatch_mma<1>(u, items, scale, out, B, N, D, s);
  }
  if (user_dtype == 0) return dispatch_items<float>(item_dtype, u, items, scale, out, B, N, D, s);
  if (user_dtype == 1)
    return dispatch_items<__nv_bfloat16>(item_dtype, u, items, scale, out, B, N, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
