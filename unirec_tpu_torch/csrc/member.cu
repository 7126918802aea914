// member: the negative-sampling membership test,
// out[b, k] = cand[b, k] > 0 and cand[b, k] is one of rows[b, :].
//
// Replaces the TPU kernel unirec_tpu/ops/member.py::_member_kernel. Its fix
// was a traffic fix: XLA's broadcast compare streamed the [B, C] history
// rows from HBM once per candidate group, while the kernel loads a block's
// rows once and runs all K compares on chip. Same design here: a block
// stages kRows examples' histories in shared memory once, then each thread
// takes one (example, candidate) pair and scans that example's C ids
// there. Device memory sees rows and cand read once and out written once.
//
// Bound on an H100: at bench shapes (B=32768, C=200, K=36) that is 26 MB of
// history, 4.7 MB of candidates and 1.2 MB of output, 0.0096 ms at
// 3.35 TB/s; the 236M compares are not the limit.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // examples per block

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

}  // namespace

extern "C" {

// rows [B, C] int32, cand [B, K] int32, out [B, K] bool. Returns a
// cudaError_t.
int unirec_member(const int* rows, const int* cand, bool* out, int B, int C,
                  int K, void* stream) {
  if (B == 0) return 0;
  const size_t smem = sizeof(int) * (size_t)kRows * C;
  cudaError_t err = cudaFuncSetAttribute(
      member_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRows - 1) / kRows;
  member_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(rows, cand, out, B, C, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
