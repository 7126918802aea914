// hstu_attention: causal pointwise attention with a learned relative-position
// bias, the attention of HSTU (Zhai et al., "Actions Speak Louder than
// Words", ICML 2024), forward and backward.
//
// Replaces no TPU kernel: the JAX package has no HSTU. It was added because
// no kernel of the port computes this function (rows 9-11 compute softmax
// attention), and its plain body stores [B, H, L, L] f32 scores: 2.6 GB a
// layer at B = 8,192, L = 200, two heads, before SiLU and its gradient.
//
//   per example b, head h, query row i, key j (i, j < L):
//     s_ij = q_i . k_j + rab[j - i + L - 1]
//     z_ij = SiLU(s_ij) / L   where j <= i and key j is not padding, else 0
//     o_i  = sum_j rnd(z_ij) v_j
//   backward, with g_i the output's gradient:
//     dz_ij = g_i . v_j,  ds_ij = dz_ij SiLU'(s_ij) / L (0 where z is 0)
//     dv_j = sum_i rnd(z_ij) g_i,  dq_i = sum_j rnd(ds_ij) k_j,
//     dk_j = sum_i rnd(ds_ij) q_i,  drab[j - i + L - 1] = sum_{b,h,i,j} ds_ij
// rnd() rounds to bf16, the operand type of the tensor-core products; s, z,
// ds and the table's gradient are f32 (ops/hstu_attention.py::_fwd_plain and
// _bwd_plain round at the same places).
//
// Layout: q, k, v, the output and the gradients are [B, L, H, hd] bf16
// addressed through (batch, row, head) strides with a contiguous last axis,
// so the model's U, V, Q, K split of one [B, L, H (2 dv + 2 dqk)] projection
// is read in place. Those heads start on 2-byte boundaries (head width 25),
// so tiles come in by 2-byte loads; keys [B, L] is 1 for a key that is not
// padding; rab [2L - 1] f32.
//
// Bound on an H100 (B = 8,192, H = 2, L = 200, head width 25, bf16): the
// forward reads q, k, v (0.49 GB) and writes o (0.16 GB), 0.20 ms at 3.35
// TB/s; its causal products, 2 * 20,100 pairs * (2 dqk + 2 dv) a head, are
// 33 GFLOP, 0.033 ms on the bf16 tensor cores: bound by bytes. The backward
// reads q, k, v, g and writes dq, dk, dv: 0.34 ms.
//
// Design. No [L, L] tile reaches device memory: every score lives in the
// registers of an mma.sync m16n8k16 accumulator and is recomputed where the
// backward needs it. Tiles of kT = 64 rows; a block has four warps, a warp
// 16 rows of the block's tile, and works through 16-key (or 16-query)
// sub-blocks, skipping the ones that lie wholly above the diagonal, so the
// causal products are all that is computed, to within the diagonal
// sub-block. The head width is padded to a multiple of 16 with zeros in
// shared memory (HD16 = 1..4: head widths up to 64, L up to kMaxLen).
//
// - forward (hstu_fwd_kernel): one block a (query tile, example, head),
//   the longest rows first; key and value tiles 0..qt stream through shared
//   memory; S = Q K^T, then the bias (the table sits in shared memory),
//   SiLU, 1/L and the masks in registers; the accumulators are reused as
//   the A fragments of Z V (no shared-memory round trip).
// - dQ and the table's gradient (hstu_bwd_dq_kernel): the same walk, with
//   dZ = G V^T beside S, and dQ += dS K. Each 16 x 16 dS passes through a
//   warp's scratch in shared memory, where lane d sums diagonal d into the
//   warp's own slot of the table (no two lanes, and no two warps, touch one
//   float: no atomics). The grid is one wave of resident blocks that walk
//   the (query tile, example, head) items, so each block writes one partial
//   table into the caller's workspace (unirec_hstu_bwd_workspace sizes it);
//   hstu_rab_reduce_kernel sums the partials, column by column.
// - dK and dV (hstu_bwd_dkv_kernel): one block a (key tile, example, head),
//   the longest columns first; a warp owns 16 keys and computes S^T = K Q^T
//   and dZ^T = V G^T over the query tiles qt >= kt, then dV += rnd(Z)^T G
//   and dK += rnd(dS)^T Q, again from the accumulators.
// The two backward kernels each recompute S and dZ: seven products a pair
// against the five of a kernel that would sum dQ with atomics, for sums in
// a fixed order.
// Capacity: L up to kMaxLen and head widths up to 16 kMaxHd16, bf16
// operands; past it the entries return kPastCapacity and
// ops/hstu_attention.py raises (it refuses other dtypes itself).
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kT = 64;         // rows of a query or key tile
constexpr int kWarps = 4;      // a warp: 16 rows of the tile
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHd16 = 4;    // head widths up to 64
constexpr int kMaxLen = 512;
constexpr int kScratch = 16 * 17;  // a warp's 16 x 16 f32 tile, rows padded to 17
constexpr int kPastCapacity = -1;  // the entries' code for a shape past capacity

struct Strides {
  long long b, l, h;  // element strides of the batch, row and head axes
};

__device__ __forceinline__ size_t at(const Strides& s, int b, int r, int h) {
  return (size_t)b * s.b + (size_t)r * s.l + (size_t)h * s.h;
}

__host__ __device__ inline int table_floats(int L) { return (2 * L - 1 + 3) & ~3; }

// Rows [r0, r0 + kT) of head h of example b into dst [kT][ld] bf16, columns
// past hd and rows past L zero. 2-byte loads: a head's row need not start on
// 4 bytes.
template <int HDP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* __restrict__ src,
                                          const Strides& s, int b, int h, int r0, int L,
                                          int hd) {
  const unsigned short* in = reinterpret_cast<const unsigned short*>(src);
  unsigned short* out = reinterpret_cast<unsigned short*>(dst);
  for (int w = threadIdx.x; w < kT * HDP; w += kThreads) {
    const int i = w / HDP, c = w % HDP, r = r0 + i;
    out[i * ld + c] = (r < L && c < hd) ? __ldg(in + at(s, b, r, h) + c) : (unsigned short)0;
  }
}

// kok[j] = 1 for key c0 + j when it exists and is not padding
__device__ __forceinline__ void load_keys(float* kok, const uint8_t* __restrict__ keys, int b,
                                          int c0, int L) {
  for (int j = threadIdx.x; j < kT; j += kThreads) {
    const int c = c0 + j;
    kok[j] = (c < L && keys[(size_t)b * L + c]) ? 1.0f : 0.0f;
  }
}

__device__ __forceinline__ void load_table(float* R, const float* __restrict__ rab, int L) {
  for (int x = threadIdx.x; x < 2 * L - 1; x += kThreads) R[x] = rab[x];
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + __expf(-x)); }

// a 16 x 16 accumulator pair (two n-tiles of 8) as the A fragment of the
// next product, rounded to bf16
__device__ __forceinline__ void as_a(uint32_t a[4], const float s[2][4]) {
  a[0] = pack_bf16(s[0][0], s[0][1]);
  a[1] = pack_bf16(s[0][2], s[0][3]);
  a[2] = pack_bf16(s[1][0], s[1][1]);
  a[3] = pack_bf16(s[1][2], s[1][3]);
}

// acc (16 x 16) += A (16 x 16d) B^T for B the 16 rows r0.. of an [n][k]
// shared array (rows of the sub-block as the n side), over HD16 k steps
template <int HD16>
__device__ __forceinline__ void mma_nt(float acc[2][4], const uint32_t a[HD16][4],
                                       const __nv_bfloat16* Bs, int ld, int r0, int lane) {
#pragma unroll
  for (int kc = 0; kc < HD16; ++kc) {
    uint32_t bk[4];
    ldmatrix_x4(bk, Bs + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + kc * 16 +
                        ((lane >> 3) & 1) * 8);
    mma_bf16(acc[0], a[kc], bk[0], bk[1]);
    mma_bf16(acc[1], a[kc], bk[2], bk[3]);
  }
}

// acc (16 x 16 HD16) += A (16 x 16) B for B the 16 rows r0.. of a [k][n]
// shared array (the sub-block's rows as the k side)
template <int HD16>
__device__ __forceinline__ void mma_nn(float acc[][4], const uint32_t a[4],
                                       const __nv_bfloat16* Bs, int ld, int r0, int lane) {
#pragma unroll
  for (int dp = 0; dp < HD16; ++dp) {
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, Bs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + dp * 16 +
                              (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
    mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
  }
}

template <int HD16>
__device__ __forceinline__ void load_frags(uint32_t f[HD16][4], const __nv_bfloat16* S, int ld,
                                           int r0, int lane) {
#pragma unroll
  for (int kc = 0; kc < HD16; ++kc)
    ldmatrix_x4(f[kc], S + (r0 + (lane & 15)) * ld + kc * 16 + (lane >> 4) * 8);
}

// the warp's 16 rows i0.. of an accumulator [NDT][4] to a [B, L, H, hd]
// bf16 tensor, columns below hd and rows below L
template <int NDT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, const Strides& s,
                                           const float acc[NDT][4], int b, int h, int i0,
                                           int L, int hd, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    if (i >= L) continue;
    __nv_bfloat16* row = dst + at(s, b, i, h);
#pragma unroll
    for (int d = 0; d < NDT; ++d)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = d * 8 + 2 * t + c;
        if (col < hd) row[col] = __float2bfloat16(acc[d][2 * r + c]);
      }
  }
}

__host__ __device__ inline int fwd_smem_bytes(int hd16, int L) {
  const int ldh = 16 * hd16 + 8;
  return 3 * kT * ldh * 2 + (table_floats(L) + kT) * 4;
}

__host__ __device__ inline int dq_smem_bytes(int hd16, int L) {
  const int ldh = 16 * hd16 + 8;
  return 4 * kT * ldh * 2 + ((1 + kWarps) * table_floats(L) + kT + kWarps * kScratch) * 4;
}

__host__ __device__ inline int dkv_smem_bytes(int hd16, int L) {
  const int ldh = 16 * hd16 + 8;
  return 4 * kT * ldh * 2 + (table_floats(L) + kT) * 4;
}

template <int HD16>
__global__ void __launch_bounds__(kThreads)
hstu_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                const uint8_t* __restrict__ keys, const float* __restrict__ rab,
                __nv_bfloat16* __restrict__ out, Strides so, int B, int H, int L, int dqk,
                int dv, float inv_len) {
  constexpr int HDP = 16 * HD16, LDH = HDP + 8, NDT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kT * LDH;
  __nv_bfloat16* Vs = Ks + kT * LDH;
  float* R = reinterpret_cast<float*>(Vs + kT * LDH);
  float* kok = R + table_floats(L);

  const int nqt = (L + kT - 1) / kT;
  const long long nbh = (long long)B * H;
  const int qt = nqt - 1 - (int)(blockIdx.x / nbh);  // the longest rows first
  const long long bh = blockIdx.x % nbh;
  const int b = (int)(bh / H), h = (int)(bh % H), r0 = qt * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int i0 = r0 + 16 * warp;
  const bool active = i0 < L;

  load_table(R, rab, L);
  load_tile<HDP>(Qs, LDH, q, sq, b, h, r0, L, dqk);
  uint32_t qf[HD16][4];
  float acc[NDT][4];
#pragma unroll
  for (int d = 0; d < NDT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int c0 = kt * kT;
    __syncthreads();  // the previous key tile is consumed
    load_tile<HDP>(Ks, LDH, k, sk, b, h, c0, L, dqk);
    load_tile<HDP>(Vs, LDH, v, sv, b, h, c0, L, dv);
    load_keys(kok, keys, b, c0, L);
    __syncthreads();
    if (!active) continue;
    if (kt == 0) load_frags<HD16>(qf, Qs, LDH, 16 * warp, lane);
    for (int kb = 0; kb < kT / 16; ++kb) {
      const int j0 = c0 + 16 * kb;
      if (j0 > i0 + 15) break;  // every key of the sub-block follows every row
      float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      mma_nt<HD16>(s, qf, Ks, LDH, 16 * kb, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + 8 * (e >> 1), j = j0 + 8 * n + 2 * t + (e & 1);
          float z = 0.0f;
          if (j <= i && i < L && kok[j - c0] != 0.0f) {
            const float x = s[n][e] + R[j - i + L - 1];
            z = x * sigmoid(x) * inv_len;
          }
          s[n][e] = z;
        }
      uint32_t a[4];
      as_a(a, s);
      mma_nn<HD16>(acc, a, Vs, LDH, 16 * kb, lane);
    }
  }
  if (active) store_rows<NDT>(out, so, acc, b, h, i0, L, dv, lane);
}

template <int HD16>
__global__ void __launch_bounds__(kThreads)
hstu_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                   const __nv_bfloat16* __restrict__ gout, Strides sg,
                   const uint8_t* __restrict__ keys, const float* __restrict__ rab,
                   __nv_bfloat16* __restrict__ dq, Strides sdq, float* __restrict__ partial,
                   int B, int H, int L, int dqk, int dv, float inv_len) {
  constexpr int HDP = 16 * HD16, LDH = HDP + 8, NDT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + kT * LDH;
  __nv_bfloat16* Ks = Gs + kT * LDH;
  __nv_bfloat16* Vs = Ks + kT * LDH;
  const int TF = table_floats(L), NT = 2 * L - 1;
  float* R = reinterpret_cast<float*>(Vs + kT * LDH);
  float* Gt = R + TF;                  // [kWarps][TF]: each warp's table gradient
  float* kok = Gt + kWarps * TF;
  float* W = kok + kT;                 // [kWarps][16][17]: each warp's dS tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  float* Gw = Gt + warp * TF;
  float* Ww = W + warp * kScratch;
  load_table(R, rab, L);
  for (int x = threadIdx.x; x < kWarps * TF; x += kThreads) Gt[x] = 0.0f;

  const int nqt = (L + kT - 1) / kT;
  const long long nbh = (long long)B * H, items = nbh * nqt;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int qt = nqt - 1 - (int)(item / nbh);
    const long long bh = item % nbh;
    const int b = (int)(bh / H), h = (int)(bh % H), r0 = qt * kT;
    const int i0 = r0 + 16 * warp;
    const bool active = i0 < L;
    __syncthreads();  // the previous item's tiles are consumed
    load_tile<HDP>(Qs, LDH, q, sq, b, h, r0, L, dqk);
    load_tile<HDP>(Gs, LDH, gout, sg, b, h, r0, L, dv);
    uint32_t qf[HD16][4], gf[HD16][4];
    float acc[NDT][4];
#pragma unroll
    for (int d = 0; d < NDT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;

    for (int kt = 0; kt <= qt; ++kt) {
      const int c0 = kt * kT;
      __syncthreads();
      load_tile<HDP>(Ks, LDH, k, sk, b, h, c0, L, dqk);
      load_tile<HDP>(Vs, LDH, v, sv, b, h, c0, L, dv);
      load_keys(kok, keys, b, c0, L);
      __syncthreads();
      if (!active) continue;
      if (kt == 0) {
        load_frags<HD16>(qf, Qs, LDH, 16 * warp, lane);
        load_frags<HD16>(gf, Gs, LDH, 16 * warp, lane);
      }
      for (int kb = 0; kb < kT / 16; ++kb) {
        const int j0 = c0 + 16 * kb;
        if (j0 > i0 + 15) break;
        float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        float dz[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        mma_nt<HD16>(s, qf, Ks, LDH, 16 * kb, lane);
        mma_nt<HD16>(dz, gf, Vs, LDH, 16 * kb, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
            const int i = i0 + r, j = j0 + c;
            float ds = 0.0f;
            if (j <= i && i < L && kok[j - c0] != 0.0f) {
              const float x = s[n][e] + R[j - i + L - 1], sg = sigmoid(x);
              ds = dz[n][e] * sg * (1.0f + x * (1.0f - sg)) * inv_len;
            }
            s[n][e] = ds;
            Ww[r * 17 + c] = ds;
          }
        __syncwarp();
        // lane d + 15 sums diagonal d (key - row = d) of the tile into the
        // warp's slot of the table
        if (lane < 31) {
          const int d = lane - 15, x = j0 - i0 + d + L - 1;
          float sum = 0.0f;
          for (int r = d < 0 ? -d : 0; r < (d > 0 ? 16 - d : 16); ++r) sum += Ww[r * 17 + r + d];
          if (x >= 0 && x < NT) Gw[x] += sum;
        }
        __syncwarp();
        uint32_t a[4];
        as_a(a, s);
        mma_nn<HD16>(acc, a, Ks, LDH, 16 * kb, lane);
      }
    }
    if (active) store_rows<NDT>(dq, sdq, acc, b, h, i0, L, dqk, lane);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < NT; x += kThreads) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += Gt[w * TF + x];
    partial[(size_t)blockIdx.x * NT + x] = sum;
  }
}

template <int HD16>
__global__ void __launch_bounds__(kThreads)
hstu_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                    const __nv_bfloat16* __restrict__ gout, Strides sg,
                    const uint8_t* __restrict__ keys, const float* __restrict__ rab,
                    __nv_bfloat16* __restrict__ dk, Strides sdk,
                    __nv_bfloat16* __restrict__ dvo, Strides sdv, int B, int H, int L,
                    int dqk, int dv, float inv_len) {
  constexpr int HDP = 16 * HD16, LDH = HDP + 8, NDT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kT * LDH;
  __nv_bfloat16* Qs = Vs + kT * LDH;
  __nv_bfloat16* Gs = Qs + kT * LDH;
  float* R = reinterpret_cast<float*>(Gs + kT * LDH);
  float* kok = R + table_floats(L);

  const int nqt = (L + kT - 1) / kT;
  const long long nbh = (long long)B * H;
  const int kt = (int)(blockIdx.x / nbh);  // key tile 0 has the most query tiles: first
  const long long bh = blockIdx.x % nbh;
  const int b = (int)(bh / H), h = (int)(bh % H), c0 = kt * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int j0 = c0 + 16 * warp;  // this warp's first key
  const bool active = j0 < L;

  load_table(R, rab, L);
  load_tile<HDP>(Ks, LDH, k, sk, b, h, c0, L, dqk);
  load_tile<HDP>(Vs, LDH, v, sv, b, h, c0, L, dv);
  load_keys(kok, keys, b, c0, L);
  uint32_t kf[HD16][4], vf[HD16][4];
  float dka[NDT][4], dva[NDT][4];
#pragma unroll
  for (int d = 0; d < NDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.0f;

  for (int qt = kt; qt < nqt; ++qt) {
    const int r0 = qt * kT;
    __syncthreads();  // the previous query tile is consumed
    load_tile<HDP>(Qs, LDH, q, sq, b, h, r0, L, dqk);
    load_tile<HDP>(Gs, LDH, gout, sg, b, h, r0, L, dv);
    __syncthreads();
    if (!active) continue;
    if (qt == kt) {
      load_frags<HD16>(kf, Ks, LDH, 16 * warp, lane);
      load_frags<HD16>(vf, Vs, LDH, 16 * warp, lane);
    }
    for (int ib = 0; ib < kT / 16; ++ib) {
      const int i0 = r0 + 16 * ib;
      if (i0 >= L) break;
      if (i0 + 15 < j0) continue;  // every row of the sub-block precedes every key
      float st[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      float dzt[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      mma_nt<HD16>(st, kf, Qs, LDH, 16 * ib, lane);
      mma_nt<HD16>(dzt, vf, Gs, LDH, 16 * ib, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + g + 8 * (e >> 1), i = i0 + 8 * n + 2 * t + (e & 1);
          float z = 0.0f, ds = 0.0f;
          if (j <= i && i < L && kok[j - c0] != 0.0f) {
            const float x = st[n][e] + R[j - i + L - 1], sgm = sigmoid(x);
            z = x * sgm * inv_len;
            ds = dzt[n][e] * sgm * (1.0f + x * (1.0f - sgm)) * inv_len;
          }
          st[n][e] = z;
          dzt[n][e] = ds;
        }
      uint32_t az[4], ad[4];
      as_a(az, st);
      as_a(ad, dzt);
      mma_nn<HD16>(dva, az, Gs, LDH, 16 * ib, lane);
      mma_nn<HD16>(dka, ad, Qs, LDH, 16 * ib, lane);
    }
  }
  if (active) {
    store_rows<NDT>(dk, sdk, dka, b, h, j0, L, dqk, lane);
    store_rows<NDT>(dvo, sdv, dva, b, h, j0, L, dv, lane);
  }
}

// drab[x] = the sum of the blocks' partial tables at x, in block order
__global__ void hstu_rab_reduce_kernel(const float* __restrict__ partial, int nblk, int n,
                                       float* __restrict__ drab) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  float sum = 0.0f;
  for (int p = 0; p < nblk; ++p) sum += partial[(size_t)p * n + x];
  drab[x] = sum;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD16>
int launch_fwd(const void* q, const void* k, const void* v, Strides sq, Strides sk,
               Strides sv, const uint8_t* keys, const float* rab, void* out, Strides so,
               int B, int H, int L, int dqk, int dv, cudaStream_t stream) {
  const int smem = fwd_smem_bytes(HD16, L);
  cudaError_t err = allow_smem(hstu_fwd_kernel<HD16>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((L + kT - 1) / kT);
  hstu_fwd_kernel<HD16><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, sq, sk, sv,
      keys, rab, (__nv_bfloat16*)out, so, B, H, L, dqk, dv, 1.0f / (float)L);
  return (int)cudaGetLastError();
}

// The dQ kernel's grid: one wave of its resident blocks on the current
// device, at most its B H ceil(L / kT) items.
template <int HD16>
cudaError_t dq_grid(int B, int H, int L, int* grid) {
  const int smem = dq_smem_bytes(HD16, L);
  cudaError_t err = allow_smem(hstu_bwd_dq_kernel<HD16>, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hstu_bwd_dq_kernel<HD16>,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)B * H * ((L + kT - 1) / kT);
  const long long wave = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = (int)(items < wave ? items : wave);
  return cudaSuccess;
}

// bytes of the dQ kernel's partial tables: one [2L - 1] f32 table a block
inline long long workspace_bytes(int grid, int L) { return (long long)grid * (2 * L - 1) * 4; }

template <int HD16>
int launch_bwd(const void* q, const void* k, const void* v, Strides sq, Strides sk,
               Strides sv, const void* gout, Strides sg, const uint8_t* keys,
               const float* rab, void* dq, Strides sdq, void* dk, Strides sdk, void* dvo,
               Strides sdv, float* partial, long long ws_bytes, float* drab, int B, int H,
               int L, int dqk, int dv, cudaStream_t stream) {
  const float inv_len = 1.0f / (float)L;
  const int smem_q = dq_smem_bytes(HD16, L), smem_kv = dkv_smem_bytes(HD16, L);
  int nblk = 0;
  cudaError_t err = dq_grid<HD16>(B, H, L, &nblk);
  if (err == cudaSuccess) err = allow_smem(hstu_bwd_dkv_kernel<HD16>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  if (partial == nullptr || ws_bytes < workspace_bytes(nblk, L))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * H * ((L + kT - 1) / kT);
  hstu_bwd_dq_kernel<HD16><<<(unsigned)nblk, kThreads, smem_q, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, sq, sk, sv,
      (const __nv_bfloat16*)gout, sg, keys, rab, (__nv_bfloat16*)dq, sdq, partial, B, H, L,
      dqk, dv, inv_len);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  hstu_bwd_dkv_kernel<HD16><<<(unsigned)blocks, kThreads, smem_kv, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, sq, sk, sv,
      (const __nv_bfloat16*)gout, sg, keys, rab, (__nv_bfloat16*)dk, sdk, (__nv_bfloat16*)dvo,
      sdv, B, H, L, dqk, dv, inv_len);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n = 2 * L - 1;
  hstu_rab_reduce_kernel<<<(n + 127) / 128, 128, 0, stream>>>(partial, nblk, n, drab);
  return (int)cudaGetLastError();
}

bool takes(int L, int dqk, int dv) {
  return L >= 1 && L <= kMaxLen && dqk >= 1 && dv >= 1 && dqk <= 16 * kMaxHd16 &&
         dv <= 16 * kMaxHd16;
}

int hd16_of(int dqk, int dv) { return ((dqk > dv ? dqk : dv) + 15) / 16; }

}  // namespace

extern "C" {

// *bytes: the device memory the backward needs as its workspace (the dQ
// kernel's partial tables of the table's gradient) at this shape on the
// current device. Returns kPastCapacity (-1) for a shape past the kernels'
// capacity, else a cudaError_t.
int unirec_hstu_bwd_workspace(int B, int H, int L, int dqk, int dv, long long* bytes) {
  if (!takes(L, dqk, dv)) return kPastCapacity;
  if (B < 1 || H < 1 || bytes == nullptr) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (hd16_of(dqk, dv)) {
    case 1: err = dq_grid<1>(B, H, L, &grid); break;
    case 2: err = dq_grid<2>(B, H, L, &grid); break;
    case 3: err = dq_grid<3>(B, H, L, &grid); break;
    case 4: err = dq_grid<4>(B, H, L, &grid); break;
  }
  if (err == cudaSuccess) *bytes = workspace_bytes(grid, L);
  return (int)err;
}

// q, k [B, L, H, dqk], v and out [B, L, H, dv], bf16, each through its
// (batch, row, head) element strides with a contiguous last axis; keys
// [B, L] uint8; rab [2L - 1] f32. Returns kPastCapacity (-1) for a shape
// past the kernels' capacity, else a cudaError_t.
int unirec_hstu_fwd(const void* q, long long sqb, long long sql, long long sqh, const void* k,
                    long long skb, long long skl, long long skh, const void* v,
                    long long svb, long long svl, long long svh, const uint8_t* keys,
                    const float* rab, void* out, long long sob, long long sol, long long soh,
                    int B, int H, int L, int dqk, int dv, void* stream) {
  if (!takes(L, dqk, dv)) return kPastCapacity;
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh}, so{sob, sol, soh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd16_of(dqk, dv)) {
#define UNIREC_HSTU_FWD(n) \
  case n:                  \
    return launch_fwd<n>(q, k, v, sq, sk, sv, keys, rab, out, so, B, H, L, dqk, dv, s);
    UNIREC_HSTU_FWD(1) UNIREC_HSTU_FWD(2) UNIREC_HSTU_FWD(3) UNIREC_HSTU_FWD(4)
#undef UNIREC_HSTU_FWD
  }
  return (int)cudaErrorInvalidValue;
}

// The backward: dq [B, L, H, dqk], dk likewise, dv [B, L, H, dv] (bf16,
// through their strides), the table's gradient drab [2L - 1] f32, from the
// output's gradient gout [B, L, H, dv]. ws: ws_bytes of device memory, at
// least what unirec_hstu_bwd_workspace gives. Returns kPastCapacity (-1) for
// a shape past the kernels' capacity, else a cudaError_t.
int unirec_hstu_bwd(const void* q, long long sqb, long long sql, long long sqh, const void* k,
                    long long skb, long long skl, long long skh, const void* v,
                    long long svb, long long svl, long long svh, const void* gout,
                    long long sgb, long long sgl, long long sgh, const uint8_t* keys,
                    const float* rab, void* dq, long long sdqb, long long sdql,
                    long long sdqh, void* dk, long long sdkb, long long sdkl, long long sdkh,
                    void* dvo, long long sdvb, long long sdvl, long long sdvh, void* ws,
                    long long ws_bytes, float* drab, int B, int H, int L, int dqk, int dv,
                    void* stream) {
  if (!takes(L, dqk, dv)) return kPastCapacity;
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh}, sg{sgb, sgl, sgh};
  const Strides sdq{sdqb, sdql, sdqh}, sdk{sdkb, sdkl, sdkh}, sdv{sdvb, sdvl, sdvh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd16_of(dqk, dv)) {
#define UNIREC_HSTU_BWD(n)                                                                 \
  case n:                                                                                  \
    return launch_bwd<n>(q, k, v, sq, sk, sv, gout, sg, keys, rab, dq, sdq, dk, sdk, dvo, \
                         sdv, (float*)ws, ws_bytes, drab, B, H, L, dqk, dv, s);
    UNIREC_HSTU_BWD(1) UNIREC_HSTU_BWD(2) UNIREC_HSTU_BWD(3) UNIREC_HSTU_BWD(4)
#undef UNIREC_HSTU_BWD
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
