// member: the negative-sampling membership test,
// out[b, k] = cand[b, k] > 0 and cand[b, k] is one of rows[b, :].
//
// Replaces the TPU kernel unirec_tpu/ops/member.py::_member_kernel. Its fix
// was a traffic fix: XLA's broadcast compare streamed the [B, C] history
// rows from HBM once per candidate group, while the kernel loads a block's
// rows once and runs all K compares on chip. Device memory sees rows and
// cand read once and out written once here too.
//
// Bound on an H100: at bench shapes (B=32768, C=200, K=36) that is 26 MB of
// history, 4.7 MB of candidates and 1.2 MB of output, 0.0096 ms at
// 3.35 TB/s. Comparing every candidate with every id is 236M compares,
// which run at the integer-compare rate (64 a clock an SM): about 0.017 ms,
// above that bound, so the warp body compares only what a filter flags.
//
// Two bodies; the rule warp_takes picks one (ops/member.py::_member_body
// holds a copy, checked against unirec_member_warp_takes).
//
// Warp body (member_warp_kernel), for K <= 64: one warp per example, no
// block barrier. The warp reads the example's history into registers, S
// ids a lane (lane j holds ids j, j+32, ..., each load 128 contiguous bytes
// a warp; up to 256 ids a pass, longer histories in passes), and its K
// candidates once, two a lane (k and k+32). Each lane sets its ids' bits in
// the warp's 4,096-bit filter in shared memory (a multiplicative hash of the
// id), then tests its candidates' bits: a clear bit proves a candidate is
// not in the history. Only flagged candidates (members, and about 5% of the
// others at C=200) are compared exactly: a shuffle broadcasts one, every
// lane compares it with the ids it holds, and one vote answers. The K bytes
// of out leave as one coalesced store a warp.
//
// Block body (member_kernel), the first port's, for K > 64: a block stages
// kRows examples' histories in shared memory, then each thread takes one
// (example, candidate) pair and scans that example's C ids there, one
// scalar shared-memory load and compare an id.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;        // examples per block (block body)
constexpr int kMaxSmem = 232448;
constexpr int kWarpMaxK = 64;   // candidates a warp holds, two a lane
constexpr int kMaxSlots = 8;    // history ids a lane holds a pass: 256 a warp
constexpr int kFilterBits = 12;  // a warp's filter: 4,096 bits
constexpr int kFilterWords = (1 << kFilterBits) / 32;

// 1 when the warp body takes K candidates an example (any history length)
inline bool warp_takes(int C, int K) { return C >= 0 && K >= 0 && K <= kWarpMaxK; }

// ------------------------------------------------------------ warp body
__device__ __forceinline__ uint32_t filter_bit(int id) {
  return ((uint32_t)id * 2654435761u) >> (32 - kFilterBits);  // Fibonacci hashing
}

// ids base + 32 s + lane of the history row; 0 past C (a 0 matches only a
// 0 candidate, which is never kept)
template <int S>
__device__ __forceinline__ void load_ids(int (&h)[S], const int* hrow, int base, int C,
                                         int lane) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = base + 32 * s + lane;
    h[s] = j < C ? __ldg(hrow + j) : 0;
  }
}

// bit k set for each candidate k of `mask` (lane k's c) that is one of the
// ids the warp's lanes hold in h; mask is the same in every lane
template <int S>
__device__ __forceinline__ uint32_t verify(int c, uint32_t mask, const int (&h)[S]) {
  uint32_t bits = 0u;
  while (mask) {
    const int k = __ffs(mask) - 1;
    mask &= mask - 1u;
    const int x = __shfl_sync(0xffffffffu, c, k);
    bool hit = false;
#pragma unroll
    for (int s = 0; s < S; ++s) hit |= h[s] == x;
    if (__any_sync(0xffffffffu, hit)) bits |= 1u << k;
  }
  return bits;
}

template <int S>
__global__ void __launch_bounds__(kThreads)
member_warp_kernel(const int* __restrict__ rows, const int* __restrict__ cand,
                   bool* __restrict__ out, int B, int C, int K) {
  __shared__ uint32_t filters[kThreads / 32][kFilterWords];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (b >= B) return;  // the whole warp: b is the warp's
  uint32_t* filt = filters[threadIdx.x / 32];
  const int* hrow = rows + (size_t)b * C;
  const int* crow = cand + (size_t)b * K;
  const int c0 = lane < K ? __ldg(crow + lane) : 0;
  const int c1 = lane + 32 < K ? __ldg(crow + lane + 32) : 0;
  int h[S];
  load_ids<S>(h, hrow, 0, C, lane);
#pragma unroll
  for (int i = 0; i < kFilterWords / 32; ++i) filt[32 * i + lane] = 0u;
  __syncwarp();
  for (int base = 0;;) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (h[s] > 0) {
        const uint32_t x = filter_bit(h[s]);
        atomicOr(filt + (x >> 5), 1u << (x & 31u));
      }
    }
    base += 32 * S;
    if (base >= C) break;
    load_ids<S>(h, hrow, base, C, lane);
  }
  __syncwarp();
  // candidates whose bit is set: the members, and the others that share a bit
  const auto flagged = [&](int c) {
    if (c <= 0) return false;
    const uint32_t x = filter_bit(c);
    return ((filt[x >> 5] >> (x & 31u)) & 1u) != 0u;
  };
  const uint32_t m0 = __ballot_sync(0xffffffffu, flagged(c0));
  const uint32_t m1 = __ballot_sync(0xffffffffu, flagged(c1));
  uint32_t hit0 = 0u, hit1 = 0u;
  if (m0 | m1) {
    // one pass: h still holds the whole history
    for (int base = 0; base < C; base += 32 * S) {
      if (C > 32 * S) load_ids<S>(h, hrow, base, C, lane);
      hit0 |= verify<S>(c0, m0 & ~hit0, h);
      hit1 |= verify<S>(c1, m1 & ~hit1, h);
    }
  }
  bool* orow = out + (size_t)b * K;
  if (lane < K) orow[lane] = (hit0 >> lane) & 1u;
  if (lane + 32 < K) orow[lane + 32] = (hit1 >> lane) & 1u;
}

template <int S>
int launch_warp(const int* rows, const int* cand, bool* out, int B, int C, int K,
                cudaStream_t stream) {
  const int per_block = kThreads / 32;
  member_warp_kernel<S><<<(B + per_block - 1) / per_block, kThreads, 0, stream>>>(
      rows, cand, out, B, C, K);
  return (int)cudaGetLastError();
}

// ids a lane holds a pass: ceil(C / 32), at least 1, at most kMaxSlots
int warp_slots(int C) { return C <= 32 ? 1 : min(kMaxSlots, (C + 31) / 32); }

int dispatch_warp(const int* rows, const int* cand, bool* out, int B, int C, int K,
                  cudaStream_t s) {
  switch (warp_slots(C)) {
    case 1: return launch_warp<1>(rows, cand, out, B, C, K, s);
    case 2: return launch_warp<2>(rows, cand, out, B, C, K, s);
    case 3: return launch_warp<3>(rows, cand, out, B, C, K, s);
    case 4: return launch_warp<4>(rows, cand, out, B, C, K, s);
    case 5: return launch_warp<5>(rows, cand, out, B, C, K, s);
    case 6: return launch_warp<6>(rows, cand, out, B, C, K, s);
    case 7: return launch_warp<7>(rows, cand, out, B, C, K, s);
    default: return launch_warp<8>(rows, cand, out, B, C, K, s);
  }
}

// ----------------------------------------------------------- block body
__global__ void __launch_bounds__(kThreads)
member_kernel(const int* __restrict__ rows, const int* __restrict__ cand,
              bool* __restrict__ out, int B, int C, int K) {
  extern __shared__ int hist[];  // [kRows, C]
  const int b0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - b0);
  for (int i = threadIdx.x; i < nr * C; i += blockDim.x)
    hist[i] = rows[(size_t)b0 * C + i];
  __syncthreads();
  for (int w = threadIdx.x; w < nr * K; w += blockDim.x) {
    const int r = w / K;
    const int c = cand[(size_t)b0 * K + w];
    bool hit = false;
    if (c > 0) {
      const int* h = hist + r * C;
      for (int j = 0; j < C; ++j) hit |= (h[j] == c);
    }
    out[(size_t)b0 * K + w] = hit;
  }
}

int launch_block(const int* rows, const int* cand, bool* out, int B, int C, int K,
                 cudaStream_t stream) {
  const size_t smem = sizeof(int) * (size_t)kRows * C;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above the default dynamic limit only
    const cudaError_t err = cudaFuncSetAttribute(
        member_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  member_kernel<<<(B + kRows - 1) / kRows, kThreads, smem, stream>>>(rows, cand, out, B, C, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when the warp body takes histories of C ids and K candidates an example
int unirec_member_warp_takes(int C, int K) { return (int)warp_takes(C, K); }

// rows [B, C] int32, cand [B, K] int32, out [B, K] bool. warp 1 runs the
// warp body, which takes only what unirec_member_warp_takes admits; warp 0
// the block body. Returns a cudaError_t.
int unirec_member(const int* rows, const int* cand, bool* out, int B, int C,
                  int K, int warp, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (warp) {
    if (!warp_takes(C, K)) return (int)cudaErrorInvalidValue;
    return dispatch_warp(rows, cand, out, B, C, K, s);
  }
  return launch_block(rows, cand, out, B, C, K, s);
}

}  // extern "C"
