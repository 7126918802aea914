// blockmax: per-16-item-chunk maxima of user x item scores, [B, ceil(N/16)].
//
// Replaces the TPU kernels unirec_tpu/ops/topk.py::_blockmax_kernel and
// _blockmax_kernel_q (launched by catalog_blockmax, pass 1 of
// fused_catalog_topk): out[b, c] = max over items i of chunk c of
// u[b] . item[i], accumulated in f32, without writing the [B, N] scores.
// The int8 body converts items to f32 in registers (exact) and multiplies
// each item's dot product by its per-row scale before the max, as
// _blockmax_kernel_q does. Items past N (the ragged last chunk) are skipped;
// the TPU's [items, users] transposed layout is not needed here.
//
// Bound on an H100: reading the catalog once per call (6.4 MB of bf16 at
// N=50,000, D=64) plus writing [B, N/16] f32 (3.2 MB at B=256) is ~2.9 us;
// the 1.6 GFLOP of products is ~1.7 us on the bf16 tensor cores. Design:
// a block scores a tile of 64 users x 256 items (16 chunks), staged in
// shared memory in 32-wide slices of D; a thread owns 4 users x one whole
// 16-item chunk, so the chunk max is a register reduction and no score
// leaves the SM. The four user tiles of a 256-user batch are the fastest
// grid dimension, so the blocks that share an item tile run together and
// the catalog streams from device memory about once. The products run on
// the CUDA cores in f32 (no tensor cores yet), so this version is bound
// by arithmetic, well above the memory bound.
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
int launch(const void* u, const void* items, const float* scale, float* out,
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
  if (item_dtype == 0) return launch<TU, float, false>(u, items, scale, out, B, N, D, s);
  if (item_dtype == 1) return launch<TU, __nv_bfloat16, false>(u, items, scale, out, B, N, D, s);
  if (item_dtype == 2) return launch<TU, int8_t, true>(u, items, scale, out, B, N, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// user_dtype: 0 = float32, 1 = bfloat16; item_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 with a float32 per-item scale. out: [B, ceil(N/16)]
// float32. Returns a cudaError_t.
int unirec_blockmax(int user_dtype, int item_dtype, const void* u,
                    const void* items, const float* scale, float* out, int B,
                    int N, int D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (user_dtype == 0) return dispatch_items<float>(item_dtype, u, items, scale, out, B, N, D, s);
  if (user_dtype == 1)
    return dispatch_items<__nv_bfloat16>(item_dtype, u, items, scale, out, B, N, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
