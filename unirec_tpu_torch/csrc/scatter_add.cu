// scatter_add: the embedding-gradient scatter-add, acc[ids[i], :] += g[i, :].
//
// Replaces the TPU kernel unirec_tpu/ops/scatter_accum.py::_scatter_kernel
// (scatter_add_rows, the backward of gather_vmem) and serves its packed
// two-accumulator variant _scatter2_kernel (scatter_add_rows2) as well:
// both compute the same sum. The TPU kernel keeps the whole [N, D] table in
// VMEM and runs a sequential read-modify-write per gradient row, summing in
// the table dtype. Hopper has no 12 MB scratchpad; the table lives in device
// memory (the 50 MB L2 holds a [50000, 64] f32 accumulator) and rows land
// through f32 atomicAdd: one warp per gradient row, lane l adding columns
// l, l+32, ... The sum is therefore taken in f32, more exact than the TPU's
// bf16 accumulation, and in atomic order, so it is not bit-reproducible
// from run to run. The wrapper zeroes the accumulator and casts it to the
// table dtype afterwards.
//
// Bound on an H100: at bench shapes (1.64M item_seq rows of 64 bf16 into
// [50000, 64]) the kernel reads 210 MB of gradient rows and 6.6 MB of ids,
// so the memory bound is 0.065 ms; the atomics' L2 throughput is the real
// limit. Ids outside [0, N) are skipped.
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

}  // namespace

extern "C" {

// dtype of g: 0 = float32, 1 = bfloat16. ids [M] int32, g [M, D], acc
// [N, D] float32 (zeroed by the caller). Returns a cudaError_t.
int unirec_scatter_add(int dtype, const int* ids, const void* g, float* acc,
                       long long M, int D, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(ids, g, acc, M, D, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(ids, g, acc, M, D, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
