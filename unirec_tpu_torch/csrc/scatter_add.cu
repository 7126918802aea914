// scatter_add: the embedding-gradient scatter-add, acc[ids[i], :] += g[i, :].
//
// Replaces the TPU kernel unirec_tpu/ops/scatter_accum.py::_scatter_kernel
// (scatter_add_rows, the backward of gather_vmem) and serves its packed
// two-accumulator variant _scatter2_kernel (scatter_add_rows2) as well:
// both compute the same sum. The TPU kernel keeps the whole [N, D] table in
// VMEM and runs a sequential read-modify-write per gradient row, summing in
// the table dtype. Hopper has no 12 MB scratchpad; the table lives in device
// memory as an f32 accumulator (the 50 MB L2 holds a [50000, 64] one) that
// the wrapper zeroes first and casts to the table dtype afterwards, so the
// sum is taken in f32, more exact than the TPU's bf16 accumulation. Ids
// outside [0, N) add nothing.
//
// Bound on an H100: at the paths' largest call (1.64M item_seq rows of 64
// bf16 into [50000, 64]) the kernel reads 210 MB of gradient rows and 6.6 MB
// of ids: 0.065 ms of memory time.
//
// Two bodies; the rule sorted_takes picks one (ops/scatter_accum.py::
// _scatter_body holds a copy, checked against unirec_scatter_add_sorted_takes).
//
// Per-row body (scatter_add_kernel; D not a multiple of 4, or a catalog of
// 2^21 rows or more): one warp per gradient row, lane l adding columns l,
// l+32, ... by scalar f32 atomicAdd. Every row with the
// same id adds to the same D addresses with nothing combined first, and the
// models send one zero row to id 0 for every left-padding position of a
// history window (models/base.py::_masked_gather), up to most of a call's
// rows: those atomics serialise on one row of the table.
//
// Sorted-tile body (scatter_sorted_kernel): a block takes a tile of up to
// 2048 consecutive rows (the TPU kernel's block), packs each row's (id, row
// in the tile) into one 32-bit key in shared memory and sorts the keys
// (bitonic), so equal ids become runs. The sorted tile is cut into equal
// spans, one per walker: a walker is the W lanes of a warp that cover a row
// in 4-column chunks (W = 16 for 64 columns), lane l taking the chunks l,
// l + W, .. in turn, one pass over the span each. It reads its span's rows
// in sorted order and sums each run in f32 registers; a run leaves as one
// float4 atomicAdd (red.global.add.v4.f32, sm_90) per chunk, the walker's
// lanes on consecutive addresses. So a hot id costs at most one reduction
// per chunk and walker its run touches, whatever id it is: nothing here
// knows that padding is id 0. The order within a tile is fixed (keys are
// unique), the order across tiles is the atomics', so the sum is not
// bit-reproducible from run to run; neither was the per-row one.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int* __restrict__ ids, const T* __restrict__ g,
                   float* __restrict__ acc, long long M, int D, int N) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long i = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
       i < M; i += warps) {
    const int id = ids[i];
    if (id < 0 || id >= N) continue;
    const T* row = g + i * D;
    float* dst = acc + (size_t)id * D;
    for (int c = lane; c < D; c += 32) atomicAdd(dst + c, to_f<T>(row[c]));
  }
}

template <typename T>
int launch(const int* ids, const void* g, float* acc, long long M, int D, int N,
           cudaStream_t stream) {
  if (M == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = (M + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = (int)(need < 8LL * sms ? need : 8LL * sms);
  scatter_add_kernel<T><<<grid, kThreads, 0, stream>>>(ids, (const T*)g, acc, M, D, N);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ sorted-tile body
// See the note at the top of this file.
constexpr int kRowBits = 11;
constexpr int kMaxTile = 1 << kRowBits;  // rows a block sorts at most
constexpr int kMinTile = 256;
constexpr int kMaxIds = (1 << (32 - kRowBits)) - 1;  // N < 2^21: the key below stays free
constexpr unsigned kNone = 0xffffffffu;  // key of an id outside [0, N), or of no row

// lanes of a walker: the row's 4-column chunks rounded up to a power of
// two, at most 32
inline int walker_lanes(int D) {
  int w = 1;
  while (w < 32 && w < D / 4) w *= 2;
  return w;
}

// 1 when the sorted-tile body takes the call (ops/scatter_accum.py::
// _scatter_body holds a copy): f32 or bf16 rows of whole 4-column chunks
// into fewer than 2^21 table rows
inline bool sorted_takes(int dtype, int D, int N) {
  return (dtype == 0 || dtype == 1) && D > 0 && D % 4 == 0 && N >= 1 && N <= kMaxIds;
}

// four columns of a row: 16 bytes of f32, 8 of bf16
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  using V = uint4;
  __device__ static void add(float* s, V v) {
    s[0] += __uint_as_float(v.x);
    s[1] += __uint_as_float(v.y);
    s[2] += __uint_as_float(v.z);
    s[3] += __uint_as_float(v.w);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  using V = uint2;
  __device__ static void add(float* s, V v) {
    s[0] += __uint_as_float(v.x << 16);
    s[1] += __uint_as_float(v.x & 0xffff0000u);
    s[2] += __uint_as_float(v.y << 16);
    s[3] += __uint_as_float(v.y & 0xffff0000u);
  }
};

// the tile's keys (tile a power of two) sorted ascending in place; every
// thread of the block calls it
__device__ __forceinline__ void bitonic_sort(unsigned* keys, int tile) {
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < tile / 2; i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1)), hi = lo + j;
        const unsigned a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Lane wl of a walker walks its span once for each of its chunks c = wl,
// wl + W, .. of a row, so the walker's lanes read, and reduce into,
// consecutive addresses: W * 16 bytes of f32 a reduction instruction.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_sorted_kernel(const int* __restrict__ ids, const T* __restrict__ g,
                      float* __restrict__ acc, long long M, int D, int N, int tile, int W) {
  using V = typename Chunk<T>::V;
  constexpr int U = 8;  // rows a walker has in flight
  __shared__ unsigned keys[kMaxTile];
  const long long r0 = (long long)blockIdx.x * tile;
  const int n = (int)(M - r0 < tile ? M - r0 : tile);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    unsigned k = kNone;
    if (i < n) {
      const int id = __ldg(ids + r0 + i);
      if (id >= 0 && id < N) k = ((unsigned)id << kRowBits) | (unsigned)i;
    }
    keys[i] = k;
  }
  __syncthreads();
  bitonic_sort(keys, tile);

  // this thread's walker and its span of the sorted keys
  const int wl = threadIdx.x % W, walkers = blockDim.x / W;
  const int per = tile / walkers, p0 = (threadIdx.x / W) * per, p1 = p0 + per;
  for (int c = wl; c < D / 4; c += W) {
    const T* gt = g + r0 * D + 4 * c;
    float s[4];
    int cur = -1;
    auto flush = [&]() {
      atomicAdd(reinterpret_cast<float4*>(acc + (size_t)cur * D + 4 * c),
                make_float4(s[0], s[1], s[2], s[3]));
    };
    for (int p = p0; p < p1; p += U) {
      unsigned k[U];
      V v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        k[u] = p + u < p1 ? keys[p + u] : kNone;
        if (k[u] != kNone)
          v[u] = __ldg(reinterpret_cast<const V*>(gt + (size_t)(k[u] & (kMaxTile - 1)) * D));
      }
      if (k[0] == kNone) break;  // the rest of the span holds no row
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k[u] == kNone) break;
        const int id = (int)(k[u] >> kRowBits);
        if (id != cur) {
          if (cur >= 0) flush();
          cur = id;
          s[0] = s[1] = s[2] = s[3] = 0.0f;
        }
        Chunk<T>::add(s, v[u]);
      }
    }
    if (cur >= 0) flush();
  }
}

template <typename T>
int launch_sorted(const int* ids, const void* g, float* acc, long long M, int D, int N,
                  cudaStream_t stream) {
  if (M == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // the largest tile that still gives every SM two blocks
  int tile = kMaxTile;
  while (tile > kMinTile && (M + tile - 1) / tile < 2LL * sms) tile >>= 1;
  const long long grid = (M + tile - 1) / tile;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scatter_sorted_kernel<T><<<(int)grid, kThreads, 0, stream>>>(ids, (const T*)g, acc, M, D, N,
                                                                tile, walker_lanes(D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when the sorted-tile body takes dtype (0 = float32, 1 = bfloat16) rows
// of width D into an N-row table (ops/scatter_accum.py::_scatter_body holds
// a copy of the rule)
int unirec_scatter_add_sorted_takes(int dtype, int D, int N) {
  return (int)sorted_takes(dtype, D, N);
}

// dtype of g: 0 = float32, 1 = bfloat16. ids [M] int32, g [M, D], acc
// [N, D] float32 (zeroed by the caller). sorted 1 runs the sorted-tile
// body, which takes only what unirec_scatter_add_sorted_takes admits, with
// g and acc 16-byte aligned; sorted 0 the per-row body. Returns a
// cudaError_t.
int unirec_scatter_add(int dtype, const int* ids, const void* g, float* acc,
                       long long M, int D, int N, int sorted, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (sorted) {
    if (!sorted_takes(dtype, D, N)) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch_sorted<float>(ids, g, acc, M, D, N, s);
    return launch_sorted<__nv_bfloat16>(ids, g, acc, M, D, N, s);
  }
  if (dtype == 0) return launch<float>(ids, g, acc, M, D, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(ids, g, acc, M, D, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
