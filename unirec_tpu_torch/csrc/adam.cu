// adam: the whole Adam update of every leaf, NaN guard included, in place,
// in one launch (or one a table of kMaxLeaves leaves), with no host read.
//
// Replaces no TPU kernel: the JAX package's optax chain (clip, decayed
// weights, scale_by_adam, scale by -lr) was fused by XLA into its jitted
// step. The port's first update (core/optim.py::Optimizer.update, then the
// guarded copies of facility/trainer.py::Trainer.apply_update, which the CPU
// still runs) was about 12 small launches a leaf, about 450 a SASRec step,
// behind a blocking host copy of b1 and b2: the card idled 11-13 ms a step
// around 1 ms of work.
//
// Bound on an H100: memory. Each element is read as p, g, mu, nu and
// written as p, mu, nu: 28 bytes, a few dozen f32 operations. At the SASRec
// cells' leaves (3.27M values at d=64, 4.14M at d=256) 91.6 and 115.9 MB:
// 0.027 and 0.035 ms at 3.35 TB/s.
//
// Design.
// - The leaves' addresses go as the launch's argument struct (Leaves, passed
//   by value, as multi_tensor_apply passes its table): the gradients' change
//   every step, so the table is rebuilt on the host each call and costs no
//   copy. A leaf is cut into chunks of kChunk elements; first_chunk holds
//   the prefix sums, and a block takes chunk after chunk (grid-stride),
//   finding its leaf by a scan of the table.
// - Each element in f32, in optax's order (not torch.optim.Adam's):
//     g  = clip ? (gnorm < clip ? g : g / gnorm * clip) : g
//     g += wd p                              (mode 1: adam, sparse_adam)
//     mu = (1 - b1) g + b1 mu
//     nu = (1 - b2) g^2 + b2 nu
//     c1 = 1 - b1^(count+1),  c2 = 1 - b2^(count+1)
//     u  = (mu / c1) / (sqrt(nu / c2) + eps)
//     u += wd p                              (mode 2: adamw, decoupled)
//     p += (-u) lr
//   every product, sum, quotient and root rounded on its own (__fmul_rn,
//   __fadd_rn, __fdiv_rn, __fsqrt_rn), as PyTorch's element-wise kernels
//   round them, so nvcc's contraction cannot move the result off the plain
//   path's; the weight-decay terms are one fused multiply-add
//   (__fmaf_rn), as PyTorch's add with alpha computes them on the card. The
//   hyperparameters come as doubles and are rounded to f32 once, 1 - b1 and
//   1 - b2 after the subtraction in double, as PyTorch rounds a Python
//   scalar: (float)(1.0 - 0.9), not 1 - (float)0.9.
// - 16-byte loads and stores where all four of a leaf's arrays are 16-byte
//   aligned (the chunk's float4 part), scalar ones for the rest of the
//   chunk and for a leaf that is not aligned.
// - The NaN guard: every block reads isfinite(loss) first and, when the loss
//   is not finite, writes nothing, so p, mu, nu and count stay bit-equal, as
//   torch.where(finite, new, old) leaves them.
// - count: each block's thread 0 reads it, then takes a ticket
//   (atomicInc, which wraps to 0 at gridDim.x - 1, so the word is 0 again
//   after every launch); the block that draws the last ticket writes
//   count + 1. Every block has read count before it takes its ticket, so
//   none can see the new value. A last-block ticket rather than a one-thread
//   second launch: one launch an update, and no launch that the host has to
//   issue and the card to wait for. When the leaves fill several tables,
//   only the last launch bumps count (stream order puts it after the others).
// - Clipping: the global norm (gnorm) is computed on the card by the caller
//   and read through a pointer; no host read.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;           // elements: 4 float4 a thread
constexpr int kMaxLeaves = 48;         // 2.1 KB of the launch's 4 KB of arguments

struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  long long numel[kMaxLeaves];
  int first_chunk[kMaxLeaves + 1];
  int n;
};

struct Hyper {
  float b1, b2, omb1, omb2, eps, wd, clip;
  int mode;                            // 0 no weight decay, 1 L2, 2 decoupled
};

struct Step {
  float c1, c2, lr, gnorm;
  bool scale;                          // the clip scales g
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v,
                                          const Hyper& h, const Step& s) {
  if (s.scale) g = __fmul_rn(__fdiv_rn(g, s.gnorm), h.clip);
  if (h.mode == 1) g = __fmaf_rn(h.wd, p, g);
  m = __fadd_rn(__fmul_rn(g, h.omb1), __fmul_rn(m, h.b1));
  v = __fadd_rn(__fmul_rn(__fmul_rn(g, g), h.omb2), __fmul_rn(v, h.b2));
  float u = __fdiv_rn(__fdiv_rn(m, s.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), h.eps));
  if (h.mode == 2) u = __fmaf_rn(h.wd, p, u);
  p = __fadd_rn(p, __fmul_rn(-u, s.lr));
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<unsigned long long>(a) & 15ULL) == 0;
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const Leaves L, const Hyper h, const float* __restrict__ loss,
            const float* __restrict__ lr, const float* __restrict__ gnorm,
            int* count, unsigned* ticket, int bump) {
  if (!isfinite(*loss)) return;        // the guard: nothing is written
  __shared__ int s_count;
  if (threadIdx.x == 0) {
    const int c = *reinterpret_cast<volatile int*>(count);
    s_count = c;
    if (bump) {
      __threadfence();
      if (atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1) *count = c + 1;
    }
  }
  __syncthreads();
  const float t = (float)(s_count + 1);
  Step s;
  s.c1 = __fsub_rn(1.0f, powf(h.b1, t));
  s.c2 = __fsub_rn(1.0f, powf(h.b2, t));
  s.lr = *lr;
  s.gnorm = h.clip > 0.0f ? *gnorm : 1.0f;
  s.scale = h.clip > 0.0f && !(s.gnorm < h.clip);

  const int chunks = L.first_chunk[L.n];
  int leaf = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (L.first_chunk[leaf + 1] <= c) ++leaf;   // c only grows
    float* p = L.p[leaf];
    const float* g = L.g[leaf];
    float* mu = L.mu[leaf];
    float* nu = L.nu[leaf];
    const long long base = (long long)(c - L.first_chunk[leaf]) * kChunk;
    const long long left = L.numel[leaf] - base;
    const int len = (int)(left < kChunk ? left : kChunk);
    int scalar_from = 0;
    if (aligned16(p) && aligned16(g) && aligned16(mu) && aligned16(nu)) {
      const int vecs = len / 4;
      float4* p4 = reinterpret_cast<float4*>(p + base);
      const float4* g4 = reinterpret_cast<const float4*>(g + base);
      float4* m4 = reinterpret_cast<float4*>(mu + base);
      float4* v4 = reinterpret_cast<float4*>(nu + base);
      for (int i = threadIdx.x; i < vecs; i += kThreads) {
        float4 pp = p4[i], mm = m4[i], vv = v4[i];
        const float4 gg = __ldg(g4 + i);
        adam_elem(pp.x, gg.x, mm.x, vv.x, h, s);
        adam_elem(pp.y, gg.y, mm.y, vv.y, h, s);
        adam_elem(pp.z, gg.z, mm.z, vv.z, h, s);
        adam_elem(pp.w, gg.w, mm.w, vv.w, h, s);
        p4[i] = pp;
        m4[i] = mm;
        v4[i] = vv;
      }
      scalar_from = vecs * 4;
    }
    for (int i = scalar_from + threadIdx.x; i < len; i += kThreads) {
      float pp = p[base + i], mm = mu[base + i], vv = nu[base + i];
      adam_elem(pp, __ldg(g + base + i), mm, vv, h, s);
      p[base + i] = pp;
      mu[base + i] = mm;
      nu[base + i] = vv;
    }
  }
}

}  // namespace

extern "C" {

// The most leaves one launch's table holds (ops/adam.py reads it).
int unirec_adam_max_leaves() { return kMaxLeaves; }

// The Adam update of n float32 leaves, in place. ptrs holds 4 n device
// addresses, leaf by leaf: p, g, mu, nu; numels their element counts. loss,
// lr, gnorm: 0-d float32 on the device (gnorm read only when clip > 0);
// count: 0-d int32, bumped by one when the loss is finite; ticket: one
// 32-bit word, zero before the first call and zero again after each; b1,
// b2, eps, wd, clip as the caller's doubles (rounded here). mode 0:
// no weight decay, 1: L2 (grad += wd p), 2: decoupled (adamw). One launch
// for every kMaxLeaves leaves, all on ``stream``. Returns a CUDA error code.
int unirec_adam(int n, const unsigned long long* ptrs, const long long* numels,
                const float* loss, const float* lr, const float* gnorm, int* count,
                unsigned* ticket, double b1, double b2, double eps, double wd, double clip,
                int mode, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Hyper h;
  h.b1 = (float)b1;
  h.b2 = (float)b2;
  h.omb1 = (float)(1.0 - b1);
  h.omb2 = (float)(1.0 - b2);
  h.eps = (float)eps;
  h.wd = (float)wd;
  h.clip = (float)clip;
  h.mode = mode;
  int lo = 0;
  do {                                 // n == 0 still launches once: count moves
    const int hi = n - lo > kMaxLeaves ? lo + kMaxLeaves : n;
    Leaves L;
    L.n = hi - lo;
    L.first_chunk[0] = 0;
    for (int i = 0; i < L.n; ++i) {
      const unsigned long long* a = ptrs + 4 * (size_t)(lo + i);
      L.p[i] = reinterpret_cast<float*>(a[0]);
      L.g[i] = reinterpret_cast<const float*>(a[1]);
      L.mu[i] = reinterpret_cast<float*>(a[2]);
      L.nu[i] = reinterpret_cast<float*>(a[3]);
      L.numel[i] = numels[lo + i];
      const long long ch = (numels[lo + i] + kChunk - 1) / kChunk;
      if (L.first_chunk[i] + ch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      L.first_chunk[i + 1] = L.first_chunk[i] + (int)ch;
    }
    const int chunks = L.first_chunk[L.n];
    const int cap = 8 * sms;
    const int grid = chunks < 1 ? 1 : (chunks < cap ? chunks : cap);
    adam_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        L, h, loss, lr, gnorm, count, ticket, (int)(hi == n));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lo = hi;
  } while (lo < n);
  return 0;
}

}  // extern "C"
