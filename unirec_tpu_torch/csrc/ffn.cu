// ffn: the fused pointwise feed-forward y = act(x W1 + b1) W2 + b2,
// forward and backward, with the [T, F] inner activation kept on chip.
//
// Replaces the TPU kernels unirec_tpu/ops/ffn.py::_fwd_kernel and
// ::_bwd_kernel (launched by _call_fwd / _fused_ffn_bwd, public entry
// fused_ffn), with their rounding points (ffn.py:62-101):
//   forward  pre = x W1 (f32 sums) + b1, h = act(pre) in f32,
//            y = rnd(h) W2 (f32 sums) + b2, rounded to x's dtype
//   backward recompute pre and h; dh = (dy W2^T) * act'(pre) in f32;
//            dx = rnd(dh) W1^T; dW1 = x^T rnd(dh); db1 = sum dh;
//            dW2 = rnd(h)^T dy; db2 = sum dy (weight gradients in f32)
// where rnd rounds to x's dtype (the identity for f32).
//
// The TPU runs the backward's grid in order and carries dW1, db1, dW2, db2
// in resident VMEM blocks ("arbitrary", ffn.py:74-79). Hopper blocks run in
// no order, so the backward is a persistent grid (SMs x resident blocks):
// each block walks token tiles and adds into its own f32 slab, and the
// wrapper sums the slabs. No atomics, so the sums are deterministic. The
// TPU pads T to a multiple of its block with zero rows; here the last tile
// is ragged instead (a zero dy row adds nothing either way).
//
// Bound on an H100 (T = 1,638,400 tokens, D=64, F=128, bf16): the forward
// reads x (0.21 GB) and writes y (0.21 GB), 0.13 ms at 3.35 TB/s, against
// 54 GFLOP of products (0.05 ms on the bf16 tensor cores): bound by bytes.
// Design: a block stages a tile of tokens in shared memory as f32, computes
// the tile's [rows, F] activation there and never writes it out, reading
// the weights through L1/L2 (transposed copies for the products with W^T,
// so a warp's loads stay coalesced). The products run on the CUDA cores in
// f32 (common.cuh::mm_rows, wgrad, colsum).
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 256;
constexpr int kFwdRows = 64;  // tokens per forward tile
constexpr int kBwdRows = 32;  // tokens per backward tile

__host__ __device__ inline int fwd_smem_floats(int D, int F) {
  return kFwdRows * (D + 1) + kFwdRows * (F + 1);
}

__host__ __device__ inline int bwd_smem_floats(int D, int F) {
  return 2 * kBwdRows * (D + 1) + 2 * kBwdRows * (F + 1);
}

__host__ __device__ inline int slab_floats(int D, int F) {
  return D * F + F + F * D + D;  // dW1, db1, dW2, db2
}

template <typename T>
__device__ void stage_rows(float* dst, int ld, const T* __restrict__ src,
                           int r0, int n, int D) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x)
    dst[(i / D) * ld + i % D] = to_f<T>(src[(size_t)r0 * D + i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2,
               const T* __restrict__ b2, T* __restrict__ y, int Tn, int D,
               int F, int act) {
  extern __shared__ float smem[];
  const int ldx = D + 1, ldh = F + 1;
  float* X = smem;                // [rows, D]
  float* Hs = X + kFwdRows * ldx;  // [rows, F]  rnd(act(pre))
  const int r0 = blockIdx.x * kFwdRows;
  const int n = min(kFwdRows, Tn - r0);

  stage_rows<T>(X, ldx, x, r0, n, D);
  __syncthreads();
  mm_rows<T, 4>(X, ldx, n, D, w1, F, 1, F, [&](int r, int c, float acc) {
    Hs[r * ldh + c] = rnd<T>(activate(act, acc + to_f<T>(b1[c])));
  });
  __syncthreads();
  mm_rows<T, 4>(Hs, ldh, n, F, w2, D, 1, D, [&](int r, int c, float acc) {
    y[(size_t)(r0 + r) * D + c] = from_f<T>(acc + to_f<T>(b2[c]));
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ w1t, const T* __restrict__ w2t,
               T* __restrict__ dx, float* __restrict__ slabs, int Tn, int D,
               int F, int act) {
  extern __shared__ float smem[];
  const int ldx = D + 1, ldh = F + 1;
  float* X = smem;                  // [rows, D]
  float* DY = X + kBwdRows * ldx;   // [rows, D]
  float* P = DY + kBwdRows * ldx;   // [rows, F]  pre, then rnd(h)
  float* DH = P + kBwdRows * ldh;   // [rows, F]  dh, then rnd(dh)
  float* slab = slabs + (size_t)blockIdx.x * slab_floats(D, F);
  float* dW1 = slab;
  float* db1 = dW1 + D * F;
  float* dW2 = db1 + F;
  float* db2 = dW2 + F * D;

  for (int i = threadIdx.x; i < slab_floats(D, F); i += blockDim.x) slab[i] = 0.0f;
  const int tiles = (Tn + kBwdRows - 1) / kBwdRows;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = t * kBwdRows;
    const int n = min(kBwdRows, Tn - r0);
    stage_rows<T>(X, ldx, x, r0, n, D);
    stage_rows<T>(DY, ldx, dy, r0, n, D);
    __syncthreads();
    mm_rows<T, 4>(X, ldx, n, D, w1, F, 1, F, [&](int r, int c, float acc) {
      P[r * ldh + c] = acc + to_f<T>(b1[c]);
    });
    __syncthreads();
    // dh = (dy W2^T) * act'(pre); W2^T is the contiguous [D, F] copy
    mm_rows<T, 4>(DY, ldx, n, D, w2t, F, 1, F, [&](int r, int c, float acc) {
      DH[r * ldh + c] = acc * activate_grad(act, P[r * ldh + c]);
    });
    __syncthreads();
    colsum([&](int r, int c) { return DH[r * ldh + c]; }, F, n, db1);
    colsum([&](int r, int c) { return DY[r * ldx + c]; }, D, n, db2);
    __syncthreads();
    for (int i = threadIdx.x; i < n * F; i += blockDim.x) {
      const int o = (i / F) * ldh + i % F;
      DH[o] = rnd<T>(DH[o]);
      P[o] = rnd<T>(activate(act, P[o]));
    }
    __syncthreads();
    // dx = rnd(dh) W1^T; W1^T is the contiguous [F, D] copy
    mm_rows<T, 4>(DH, ldh, n, F, w1t, D, 1, D, [&](int r, int c, float acc) {
      dx[(size_t)(r0 + r) * D + c] = from_f<T>(acc);
    });
    wgrad([&](int r, int kk) { return X[r * ldx + kk]; }, D, DH, ldh, F, n, dW1);
    wgrad([&](int r, int kk) { return P[r * ldh + kk]; }, F, DY, ldx, D, n, dW2);
    __syncthreads();
  }
}

template <typename T>
int launch_fwd(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* y, int Tn, int D, int F, int act,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats(D, F);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (Tn + kFwdRows - 1) / kFwdRows;
  ffn_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
      (T*)y, Tn, D, F, act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* w1, const void* b1,
               const void* w1t, const void* w2t, void* dx, float* slabs,
               int nblocks, int Tn, int D, int F, int act, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats(D, F);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_kernel<T><<<nblocks, kThreads, smem, stream>>>(
      (const T*)x, (const T*)dy, (const T*)w1, (const T*)b1, (const T*)w1t,
      (const T*)w2t, (T*)dx, slabs, Tn, D, F, act);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks(int Tn, int D, int F) {
  const size_t smem = sizeof(float) * bwd_smem_floats(D, F);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, ffn_bwd_kernel<T>, kThreads, smem)) != cudaSuccess)
    return -(int)err;
  const int tiles = (Tn + kBwdRows - 1) / kBwdRows;
  const int nb = sms * (per_sm > 0 ? per_sm : 1);
  return nb < tiles ? nb : tiles;
}

}  // namespace

extern "C" {

// The backward's persistent grid for Tn tokens (SMs x resident blocks per
// SM, at most one block per tile), or minus a cudaError_t.
int unirec_ffn_bwd_blocks(int dtype, int Tn, int D, int F) {
  if (dtype == 0) return blocks<float>(Tn, D, F);
  if (dtype == 1) return blocks<__nv_bfloat16>(Tn, D, F);
  return -(int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (x, y and the weights, all contiguous;
// w1 [D, F], w2 [F, D] in the flax layout). act: an index of
// ops/ffn.py::ACTS. Returns a cudaError_t.
int unirec_ffn_fwd(int dtype, const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* y, int Tn, int D, int F,
                   int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_fwd<float>(x, w1, b1, w2, b2, y, Tn, D, F, act, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w1, b1, w2, b2, y, Tn, D, F, act, s);
  return (int)cudaErrorInvalidValue;
}

// w1t [F, D] and w2t [D, F]: contiguous transposes of w1 and w2. slabs:
// [nblocks, D*F + F + F*D + D] f32 (dW1, db1, dW2, db2), each block
// zeroing and filling its own row. Returns a cudaError_t.
int unirec_ffn_bwd(int dtype, const void* x, const void* dy, const void* w1,
                   const void* b1, const void* w1t, const void* w2t, void* dx,
                   float* slabs, int nblocks, int Tn, int D, int F, int act,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(x, dy, w1, b1, w1t, w2t, dx, slabs, nblocks, Tn, D,
                             F, act, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, dy, w1, b1, w1t, w2t, dx, slabs, nblocks,
                                     Tn, D, F, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
