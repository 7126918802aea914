// layer_bwd: backward of layer_fwd (one whole post-LN layer, with dropout).
//
// Replaces the TPU kernel unirec_tpu/ops/layer.py::_layer_bwd_kernel
// (launched by _fused_layer_bwd, the custom_vjp of fused_transformer_layer).
// Like it, this kernel saves nothing from the forward but x: it recomputes
// the layer from x, regenerates the forward's dropout masks from the seed
// (common.cuh's Philox, keyed by example and element, so the masks are
// those layer_fwd.cu drew), and emits dx and every weight and bias
// gradient, rounding to T where the Pallas kernel casts to the input
// dtype (dh2, du, do, dctx, ds and the dq|dk|dv block).
//
// Weight gradients: the TPU kernel writes one partial slab per grid step
// and sums them outside. Blocks here do not run in order and one slab per
// example would be several GB at B=32768, so the grid is persistent (a few
// blocks per SM, ops/layer.py asks unirec_layer_bwd_blocks for the count)
// and each block loops over examples b = blockIdx.x, blockIdx.x + grid, ...
// accumulating into its OWN f32 slab in device memory: no atomics, so the
// result is deterministic; the wrapper sums the slabs (layer.py:569).
//
// Two bodies; the rule mma_takes picks one (ops/layer.py::_layer_bwd_body
// holds a copy).
//
// CUDA-core body (f32, and bf16 at widths the tensor-core body does not
// take): one example per 512-thread block, everything in f32 shared memory:
// x, q|k|v, the pre-dropout probabilities of every head (the sign bit marks
// a dropped entry, so the backward reads the mask without drawing it
// again), one [Lp, Lp] dp/ds buffer, ctx, x1, xhat1, u, xhat2 and two
// [Lp, D] gradient buffers: 213,024 bytes at Lp=56, D=64, F=128, nh=2, one
// block per SM. q|k|v is overwritten by dq|dk|dv head by head; u holds hm,
// then du (u is recomputed from x1 rather than kept, for lack of room).
// Every product is a scalar fmaf loop: 103 ms at B=32,768 (bench.py's
// training batch) on an H100 (80GB HBM3, 700 W), 232x its bound.
//
// Tensor-core body (bf16; Lp <= 64, D and the head width multiples of 16 up
// to 64, F a multiple of 16 whose buffers fit a block; layer_bwd_mma_kernel
// below). Every product of the Pallas kernel takes input-dtype operands
// with f32 sums, which is what mma.sync m16n8k16 computes in bf16; only the
// order of the f32 sums differs, and every rounding point stays: _dense
// rounds the product, then adds the bias in bf16; LayerNorm and softmax run
// in f32; dh2, du, do, dctx, ds and dq|dk|dv are rounded before their
// products. A persistent grid of 8-warp blocks, one a SM: wqkv, wo, w1 and
// w2 stay in bf16 shared memory for the block's life (64 KB at D=64,
// F=128), loaded once and read through ldmatrix / ldmatrix.trans, so the
// products with W^T need no transposed copy (the wrapper makes none). Each
// example's x, dy and madd rows arrive by cp.async into a two-stage ring
// while the previous example computes. Two warps own a strip of 16 rows
// (csrc/layer_strip.cuh, shared with rows 1 and 4), each half of its
// columns (and every other head), and carry it through the whole recompute
// and the row-local backward in registers (the mma.sync accumulator
// layout), exchanging LayerNorm row sums through shared memory
// under a 64-thread named barrier: the QKV projection; per head
// S = Q K^T, the f32 softmax, the keep bits and P V (csrc/strip.cuh, the
// code of rows 10 and 11); the output projection, LN1, the FFN, LN2 (row
// statistics by quad shuffles); then dy through LN2, dh2, du, dx1, LN1, do
// and dctx. The keep bits of the three dropout sites are drawn once, in
// the recompute, and kept in registers for the backward. The attention
// backward follows row 11, two heads at once: per head the strip's scores,
// z and ds go to shared memory, a warp per 16 key rows forms dV = z^T dctx
// and dK = ds^T q, and dQ = ds K comes from the registers. dx =
// dr1 + dqkv Wqkv^T leaves through the strip's own dy rows as 16-byte
// stores. Weight gradients are products over tokens (ldmatrix.trans A
// fragments) into the block's own f32 slab.
//
// Where the design had to give:
// 1. Lp = 56 is not a multiple of 16. The MMA tiles take Mp = 64 rows and
//    keys (Lp rounded up to 16). Keys Lp..Mp-1 are excluded from the
//    softmax (strip_softmax: score -inf, probability exactly 0, as the hard
//    -1e30 ban that _pad_L puts on keys L..Lp-1 through madd gives those);
//    the soft -1e4 key-padding mask stays on the keys within Lp, so a fully
//    masked row still attends uniformly over the real keys. Rows Lp..Mp-1
//    load as zero x and zero dy (cp.async zero fill). Their forward values
//    are finite and never leave the block, and a zero dy row contributes
//    nothing to any gradient, as rows L..Lp-1 already do: dy = 0 makes dr2,
//    dh2, du, dx1, dr1, do, dctx and that query's ds, dq zero, and keys
//    past Lp have probability 0, so their ds, dk, dv are zero too; every
//    weight-gradient sum over tokens and every bias sum then gets 0 from
//    those rows.
// 2. Dropout keying is bit-identical with layer_fwd.cu: sites h (the
//    attention probabilities of head h), nh (attention output) and nh + 1
//    (FFN output), element i * Lp + j and i * D + c counted in the example's
//    Lp layout, not the padded one. The keep bits are drawn again with
//    philox_bits (strip_keep, as row 11), where the CUDA-core body marks
//    dropped probabilities with the sign bit; rows past Lp draw nothing.
// 3. The weight-gradient sums do not fit beside everything else: one slab
//    (layer_slab_floats(64, 128) = 33,472 f32, 134 KB) plus 64 KB of weights
//    and about 80 KB of per-example bf16 tiles passes a block's 227 KB, and
//    spread over the eight warps' registers it is 131 floats a thread. So
//    each example's weight-gradient products flush into the block's own f32
//    slab in device memory (132 slabs, 17.7 MB, stay in the 50 MB L2): a
//    warp loads four of its 16 x 16 output tiles' sums at once (one L2
//    round trip), adds the example's 64 tokens by MMA and stores them
//    back; no atomics, one order, so the
//    result is deterministic and the wrapper still sums the slabs. The bias
//    and LayerNorm sums (9D + F floats) stay in shared memory, one row per
//    strip. The cost of the flush is measured by tools/kernel_ablations.py
//    (layer_bwd_no_weight_flush).
// 4. Registers: a strip's row quantities (xhat1, xhat2, dr1, an
//    accumulator) cost 16 f32 a thread each at D = 64 once two warps split
//    the columns; 8 warps a block at 255 registers at most. chip_smoke.py
//    prints ptxas's registers and spills for every instantiation.
//
// Bound on an H100: at the training shapes (B=32768, Lp=56, D=64, F=128)
// the backward reads x, dy and writes dx (bf16, 0.7 GB in all) and does
// about 3x the forward's 154 GFLOP: bound by operations on the bf16 tensor
// cores (0.445 ms).
#include "layer_strip.cuh"

using namespace unirec;

namespace {

constexpr int kThreads = 512;
constexpr float kMaskValue = -1e4f;  // reference additive mask (sasrec.py:56)

__host__ __device__ inline int layer_bwd_smem_floats(int Lp, int D, int F, int nh) {
  const int ldx = D + 1, ldq = 3 * D + 1, ldu = F + 1, lds = Lp + 1;
  return 7 * Lp * ldx + Lp * ldq + (nh + 1) * Lp * lds + Lp * ldu + 3 * Lp;
}

// floats of one block's slab: the 12 leaves in the flat-weight order
// (wqkv, bqkv, wo, bo, g1, c1, w1, b1, w2, b2, g2, c2)
__host__ __device__ inline int layer_slab_floats(int D, int F) {
  return 3 * D * D + 3 * D + D * D + D + 2 * D + D * F + F + F * D + D + 2 * D;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_bwd_kernel(const T* __restrict__ x, const float* __restrict__ madd,
                 const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                 const T* __restrict__ wo, const T* __restrict__ bo,
                 const float* __restrict__ g1, const float* __restrict__ c1,
                 const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2,
                 const float* __restrict__ g2, const float* __restrict__ c2,
                 const T* __restrict__ wqkvT, const T* __restrict__ woT,
                 const T* __restrict__ w1T, const T* __restrict__ w2T,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ slabs, int B, int Lp, int D, int F,
                 int nh, int act, int causal, float eps, Drop dr) {
  extern __shared__ float smem[];
  const int hd = D / nh;
  const int ldx = D + 1, ldq = 3 * D + 1, ldu = F + 1, lds = Lp + 1;
  float* X = smem;               // [Lp, D]   x
  float* QKV = X + Lp * ldx;     // [Lp, 3D]  q|k|v, then dq|dk|dv
  float* P = QKV + Lp * ldq;     // [nh, Lp, Lp] pre-dropout probs, sign = dropped
  float* S = P + nh * Lp * lds;  // [Lp, Lp]  dp, then ds
  float* CTX = S + Lp * lds;     // [Lp, D]   attention output (T)
  float* X1 = CTX + Lp * ldx;    // [Lp, D]   LN1 output (T)
  float* XH1 = X1 + Lp * ldx;    // [Lp, D]   xhat1
  float* U = XH1 + Lp * ldx;     // [Lp, F]   u -> hm -> dhm -> du
  float* XH2 = U + Lp * ldu;     // [Lp, D]   xhat2, then dctx
  float* R = XH2 + Lp * ldx;     // [Lp, D]   dy -> dr2 -> dx1 -> dr1
  float* DH = R + Lp * ldx;      // [Lp, D]   dh2, then do, then dq_h|dk_h
  float* M = DH + Lp * ldx;      // [Lp]      key-pad row
  float* RS1 = M + Lp;           // [Lp]      LN1 reciprocal std
  float* RS2 = RS1 + Lp;         // [Lp]      LN2 reciprocal std

  const int o_bqkv = 3 * D * D, o_wo = o_bqkv + 3 * D, o_bo = o_wo + D * D;
  const int o_g1 = o_bo + D, o_c1 = o_g1 + D, o_w1 = o_c1 + D;
  const int o_b1 = o_w1 + D * F, o_w2 = o_b1 + F, o_b2 = o_w2 + F * D;
  const int o_g2 = o_b2 + D, o_c2 = o_g2 + D;
  float* slab = slabs + (size_t)blockIdx.x * layer_slab_floats(D, F);
  for (int i = threadIdx.x; i < layer_slab_floats(D, F); i += blockDim.x) slab[i] = 0.0f;

  const float scale = (float)(1.0 / sqrt((double)hd));
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t base = (size_t)b * Lp * D;
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x)
      X[(i / D) * ldx + i % D] = to_f<T>(x[base + i]);
    for (int j = threadIdx.x; j < Lp; j += blockDim.x) M[j] = madd[(size_t)b * Lp + j];
    __syncthreads();

    // ---- recompute the forward
    mm_rows<T, 4>(X, ldx, Lp, D, wqkv, 3 * D, 1, 3 * D, [&](int r, int c, float a) {
      QKV[r * ldq + c] = rnd<T>(rnd<T>(a) + to_f<T>(bqkv[c]));
    });
    __syncthreads();
    for (int h = 0; h < nh; ++h) {
      float* Ph = P + h * Lp * lds;
      const float* Q = QKV + h * hd;
      const float* K = QKV + D + h * hd;
      const float* V = QKV + 2 * D + h * hd;
      for (int w = threadIdx.x; w < Lp * Lp; w += blockDim.x) {
        const int i = w / Lp, j = w % Lp;
        float acc = 0.0f;
        for (int d = 0; d < hd; ++d) acc = fmaf(Q[i * ldq + d], K[j * ldq + d], acc);
        float m = M[j];
        if (causal) m = fminf(m, j > i ? kMaskValue : 0.0f);
        Ph[i * lds + j] = acc * scale + m;
      }
      __syncthreads();
      softmax_rows(Ph, lds, Lp, Lp);
      __syncthreads();
      for (int w = threadIdx.x; w < Lp * Lp; w += blockDim.x) {
        float* e = Ph + (w / Lp) * lds + w % Lp;
        if (!kept(dr.seed, dr.t_attn, h, dr.b0 + b, w)) *e = -*e;  // -0.0 for 0: sign bit set
      }
      __syncthreads();
      for (int w = threadIdx.x; w < Lp * hd; w += blockDim.x) {
        const int i = w / hd, d = w % hd;
        float acc = 0.0f;
        for (int j = 0; j < Lp; ++j) {
          const float pv = Ph[i * lds + j];
          const float pz = signbit(pv) ? 0.0f : rnd<T>(pv * dr.inv_attn);
          acc = fmaf(pz, V[j * ldq + d], acc);
        }
        CTX[i * ldx + h * hd + d] = rnd<T>(acc);
      }
      __syncthreads();
    }
    mm_rows<T, 4>(CTX, ldx, Lp, D, wo, D, 1, D, [&](int r, int c, float a) {
      const float o = rnd<T>(rnd<T>(a) + to_f<T>(bo[c]));
      XH1[r * ldx + c] = rnd<T>(drop_hidden<T>(o, dr, nh, b, r * D + c) + X[r * ldx + c]);
    });
    __syncthreads();
    ln_stats_rows(XH1, ldx, Lp, D, RS1, eps);
    __syncthreads();
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x) {
      const int o = (i / D) * ldx + i % D, c = i % D;
      X1[o] = rnd<T>(XH1[o] * g1[c] + c1[c]);
    }
    __syncthreads();
    mm_rows<T, 4>(X1, ldx, Lp, D, w1, F, 1, F, [&](int r, int c, float a) {
      U[r * ldu + c] = rnd<T>(activate(act, rnd<T>(rnd<T>(a) + to_f<T>(b1[c]))));
    });
    __syncthreads();
    mm_rows<T, 4>(U, ldu, Lp, F, w2, D, 1, D, [&](int r, int c, float a) {
      const float h2 = rnd<T>(rnd<T>(a) + to_f<T>(b2[c]));
      XH2[r * ldx + c] = rnd<T>(drop_hidden<T>(h2, dr, nh + 1, b, r * D + c) + X1[r * ldx + c]);
    });
    __syncthreads();
    ln_stats_rows(XH2, ldx, Lp, D, RS2, eps);
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x)
      R[(i / D) * ldx + i % D] = to_f<T>(dy[base + i]);
    __syncthreads();

    // ---- LN2, FFN
    colsum([&](int r, int n) { return R[r * ldx + n] * XH2[r * ldx + n]; }, D, Lp, slab + o_g2);
    colsum([&](int r, int n) { return R[r * ldx + n]; }, D, Lp, slab + o_c2);
    __syncthreads();
    ln_bwd_rows(R, ldx, XH2, ldx, RS2, Lp, D, g2);
    __syncthreads();
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x) {
      const int o = (i / D) * ldx + i % D;
      DH[o] = rnd<T>(kept(dr.seed, dr.t_hidden, nh + 1, dr.b0 + b, i) ? R[o] * dr.inv_hidden : 0.0f);
    }
    __syncthreads();
    wgrad([&](int r, int k) { return U[r * ldu + k]; }, F, DH, ldx, D, Lp, slab + o_w2);
    colsum([&](int r, int n) { return DH[r * ldx + n]; }, D, Lp, slab + o_b2);
    __syncthreads();
    mm_rows<T, 4>(DH, ldx, Lp, D, w2T, F, 1, F, [&](int r, int c, float a) {
      U[r * ldu + c] = a;  // dhm = dh2 @ w2^T
    });
    __syncthreads();
    mm_rows<T, 4>(X1, ldx, Lp, D, w1, F, 1, F, [&](int r, int c, float a) {
      const float u = rnd<T>(rnd<T>(a) + to_f<T>(b1[c]));
      U[r * ldu + c] = rnd<T>(U[r * ldu + c] * activate_grad(act, u));
    });
    __syncthreads();
    wgrad([&](int r, int k) { return X1[r * ldx + k]; }, D, U, ldu, F, Lp, slab + o_w1);
    colsum([&](int r, int n) { return U[r * ldu + n]; }, F, Lp, slab + o_b1);
    mm_rows<T, 4>(U, ldu, Lp, F, w1T, D, 1, D, [&](int r, int c, float a) {
      R[r * ldx + c] += a;  // dx1 = dr2 + du @ w1^T
    });
    __syncthreads();

    // ---- LN1, attention output
    colsum([&](int r, int n) { return R[r * ldx + n] * XH1[r * ldx + n]; }, D, Lp, slab + o_g1);
    colsum([&](int r, int n) { return R[r * ldx + n]; }, D, Lp, slab + o_c1);
    __syncthreads();
    ln_bwd_rows(R, ldx, XH1, ldx, RS1, Lp, D, g1);
    __syncthreads();
    for (int i = threadIdx.x; i < Lp * D; i += blockDim.x) {
      const int o = (i / D) * ldx + i % D;
      DH[o] = rnd<T>(kept(dr.seed, dr.t_hidden, nh, dr.b0 + b, i) ? R[o] * dr.inv_hidden : 0.0f);
    }
    __syncthreads();
    wgrad([&](int r, int k) { return CTX[r * ldx + k]; }, D, DH, ldx, D, Lp, slab + o_wo);
    colsum([&](int r, int n) { return DH[r * ldx + n]; }, D, Lp, slab + o_bo);
    float* DCTX = XH2;
    mm_rows<T, 4>(DH, ldx, Lp, D, woT, D, 1, D, [&](int r, int c, float a) {
      DCTX[r * ldx + c] = rnd<T>(a);
    });
    __syncthreads();

    // ---- attention, head by head
    for (int h = 0; h < nh; ++h) {
      const float* Ph = P + h * Lp * lds;
      float* Q = QKV + h * hd;
      float* K = QKV + D + h * hd;
      float* V = QKV + 2 * D + h * hd;
      const float* dch = DCTX + h * hd;
      for (int w = threadIdx.x; w < Lp * Lp; w += blockDim.x) {
        const int i = w / Lp, j = w % Lp;
        float acc = 0.0f;
        for (int d = 0; d < hd; ++d) acc = fmaf(dch[i * ldx + d], V[j * ldq + d], acc);
        S[i * lds + j] = signbit(Ph[i * lds + j]) ? 0.0f : acc * dr.inv_attn;
      }
      __syncthreads();
      for (int w = threadIdx.x; w < Lp * hd; w += blockDim.x) {
        const int j = w / hd, d = w % hd;
        float acc = 0.0f;
        for (int i = 0; i < Lp; ++i) {
          const float pv = Ph[i * lds + j];
          const float pz = signbit(pv) ? 0.0f : rnd<T>(pv * dr.inv_attn);
          acc = fmaf(pz, dch[i * ldx + d], acc);
        }
        V[j * ldq + d] = rnd<T>(acc);  // dv; v_h is dead once dp is formed
      }
      {
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        for (int i = warp; i < Lp; i += blockDim.x / 32) {
          float t = 0.0f;
          for (int j = lane; j < Lp; j += 32) t += S[i * lds + j] * fabsf(Ph[i * lds + j]);
          t = warp_sum(t);
          for (int j = lane; j < Lp; j += 32) {
            const float p = fabsf(Ph[i * lds + j]);
            S[i * lds + j] = rnd<T>(p * (S[i * lds + j] - t) * scale);
          }
        }
      }
      __syncthreads();
      for (int w = threadIdx.x; w < Lp * hd; w += blockDim.x) {
        const int r = w / hd, d = w % hd;
        float aq = 0.0f, ak = 0.0f;
        for (int j = 0; j < Lp; ++j) {
          aq = fmaf(S[r * lds + j], K[j * ldq + d], aq);
          ak = fmaf(S[j * lds + r], Q[j * ldq + d], ak);
        }
        DH[r * ldx + d] = rnd<T>(aq);
        DH[r * ldx + hd + d] = rnd<T>(ak);
      }
      __syncthreads();
      for (int w = threadIdx.x; w < Lp * hd; w += blockDim.x) {
        const int r = w / hd, d = w % hd;
        Q[r * ldq + d] = DH[r * ldx + d];
        K[r * ldq + d] = DH[r * ldx + hd + d];
      }
      __syncthreads();
    }

    // ---- q|k|v projection and dx
    wgrad([&](int r, int k) { return X[r * ldx + k]; }, D, QKV, ldq, 3 * D, Lp, slab);
    colsum([&](int r, int n) { return QKV[r * ldq + n]; }, 3 * D, Lp, slab + o_bqkv);
    mm_rows<T, 4>(QKV, ldq, Lp, 3 * D, wqkvT, D, 1, D, [&](int r, int c, float a) {
      dx[base + (size_t)r * D + c] = from_f<T>(R[r * ldx + c] + a);
    });
    __syncthreads();
  }
}

// ------------------------------------------------ bf16 tensor-core body
// See the note at the top of this file.
constexpr int kLdz = kMmaRows + 8;        // z and ds rows: every key, padded

__host__ __device__ inline int mma_sums(int D, int F) { return 9 * D + F; }

// bf16: wqkv [D][3D + 8], wo [D][D + 8], w1 [D][F + 8], w2 [F][D + 8]; two
// stages of x, dy [64][D + 8] and the f32 madd row [64]; q|k|v [64][3D + 8];
// dctx [64][D + 8]; ctx, x1, dh2, do [64][D + 8] and u, hm [64][F + 8],
// later z and ds [64][72] of up to two heads at once (the larger of the
// two); then f32: the bias and LayerNorm sums [4 strips][9D + F] and the
// row statistics the two warps of a strip exchange [4][2][8][2]. Every row
// a multiple of 16 bytes (the +8 also keeps ldmatrix free of bank
// conflicts).
__host__ __device__ inline int mma_tiles_bytes(int D, int F, int nh) {
  const int ldd = D + 8, ldf = F + 8, heads = nh < 2 ? nh : 2;
  const int ffn = 2 * kMmaRows * (4 * ldd + 2 * ldf), zs = heads * 2 * 2 * kMmaRows * kLdz;
  return ffn > zs ? ffn : zs;
}

__host__ __device__ inline int mma_smem_bytes(int D, int F, int nh) {
  const int ldd = D + 8, ldq = 3 * D + 8, ldf = F + 8;
  return 2 * (D * ldq + D * ldd + D * ldf + F * ldd) + 2 * (2 * 2 * kMmaRows * ldd + 4 * kMmaRows) +
         2 * kMmaRows * (ldq + ldd) + mma_tiles_bytes(D, F, nh) + 4 * kStrips * mma_sums(D, F) +
         4 * kStrips * 2 * 8 * 2;
}

__host__ __device__ inline bool mma_takes(int dtype, int Lp, int D, int F, int nh) {
  return mma_widths_take(dtype, Lp, D, F, nh) && mma_smem_bytes(D, F, nh) <= kSmemLimit;
}

// slabs: zeroed by the caller; this block adds into its own
template <int D16, int HD16>
__global__ void __launch_bounds__(32 * kMmaWarps, 1)
layer_bwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ madd,
                     const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
                     const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                     const float* __restrict__ g1, const float* __restrict__ c1,
                     const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                     const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                     const float* __restrict__ g2, const float* __restrict__ c2,
                     const bf16* __restrict__ dy, bf16* __restrict__ dx,
                     float* __restrict__ slabs, int B, int Lp, int F, int act, int causal,
                     float eps, Drop dr) {
  constexpr int D = D16 * 16, LDD = D + 8, LDQ = 3 * D + 8, D8 = D / 8;
  constexpr int HD = HD16 * 16, NH = D / HD, NHT = HD16 * 2;
  // the two warps of a strip split D (and F, 3D) in 16-column groups, half
  // 0 taking the larger share; NTH tiles of 8 columns at most
  constexpr int DG0 = (D16 + 1) / 2, NTH = 2 * DG0, KH = (NH + 1) / 2;
  constexpr float inv_d = 1.0f / D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDF = F + 8, Mp = (Lp + 15) / 16 * 16, ntile = Mp / 8, nk16 = Mp / 16;
  const int NS = mma_sums(D, F);
  bf16* Wq = reinterpret_cast<bf16*>(smem_raw);  // [D][LDQ]
  bf16* Wo = Wq + D * LDQ;                       // [D][LDD]
  bf16* W1 = Wo + D * LDD;                       // [D][LDF]
  bf16* W2 = W1 + D * LDF;                       // [F][LDD]
  unsigned char* ring = reinterpret_cast<unsigned char*>(W2 + F * LDD);
  const int stage_bytes = 2 * 2 * kMmaRows * LDD + 4 * kMmaRows;
  auto Xs = [&](int st) { return reinterpret_cast<bf16*>(ring + st * stage_bytes); };
  auto DYs = [&](int st) { return Xs(st) + kMmaRows * LDD; };
  auto Ms = [&](int st) { return reinterpret_cast<float*>(DYs(st) + kMmaRows * LDD); };
  bf16* QKV = reinterpret_cast<bf16*>(ring + 2 * stage_bytes);  // [64][LDQ]
  bf16* DCTX = QKV + kMmaRows * LDQ;                             // [64][LDD]
  bf16* CTX = DCTX + kMmaRows * LDD;                             // [64][LDD]
  bf16* X1 = CTX + kMmaRows * LDD;
  bf16* DH = X1 + kMmaRows * LDD;
  bf16* DO = DH + kMmaRows * LDD;
  bf16* U = DO + kMmaRows * LDD;   // [64][LDF] u, then du
  bf16* HM = U + kMmaRows * LDF;   // [64][LDF]
  float* sums = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(CTX) +
                                         mma_tiles_bytes(D, F, NH));  // [4][NS]
  float* xchg = sums + kStrips * NS;                                   // [4][2][8][2]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int strip = warp % kStrips, half = warp / kStrips, i0 = strip * 16;
  const bool active = i0 < Mp;
  float* xch = xchg + strip * 2 * 8 * 2;
  // this warp's columns: of D (nd tiles from dc0), of F (16-column groups
  // from fc0) and of 3D (from qc0)
  const int nd = half ? 2 * (D16 / 2) : NTH, dc0 = half ? 16 * DG0 : 0;
  const int fg = F / 16, fc0 = half ? 16 * ((fg + 1) / 2) : 0,
            fc1 = half ? F : 16 * ((fg + 1) / 2);
  const int qc0 = half ? 16 * ((3 * D16 + 1) / 2) : 0,
            qc1 = half ? 3 * D : 16 * ((3 * D16 + 1) / 2);
  // z and ds of the two heads a block takes at once: [half][64][kLdz] each
  bf16* Zs = CTX + half * 2 * kMmaRows * kLdz;
  bf16* DSs = Zs + kMmaRows * kLdz;
  // offsets: the slab in the flat-weight order; the sums [bqkv 3D, bo, g1,
  // c1 D each, b1 F, b2, g2, c2 D each]
  const int o_bqkv = 3 * D * D, o_wo = o_bqkv + 3 * D, o_bo = o_wo + D * D;
  const int o_g1 = o_bo + D, o_c1 = o_g1 + D, o_w1 = o_c1 + D;
  const int o_b1 = o_w1 + D * F, o_w2 = o_b1 + F, o_b2 = o_w2 + F * D;
  const int o_g2 = o_b2 + D, o_c2 = o_g2 + D;
  const int s_bo = 3 * D, s_g1 = 4 * D, s_c1 = 5 * D, s_b1 = 6 * D, s_b2 = 6 * D + F,
            s_g2 = 7 * D + F, s_c2 = 8 * D + F;
  float* slab = slabs + (size_t)blockIdx.x * layer_slab_floats(D, F);
  float* part = sums + strip * NS;
  const float scale = (float)(1.0 / sqrt((double)HD));
  auto mask = [&](const float* M) {
    return [=](int i, int j) {
      const float m = M[j];
      return causal ? fminf(m, j > i ? kMaskValue : 0.0f) : m;
    };
  };

  for (int i = threadIdx.x; i < kStrips * NS; i += blockDim.x) sums[i] = 0.0f;
  // the weights, once
  auto load_w = [&](bf16* dst, int ld, const bf16* src, int rows, int cols) {
    const int ch = cols / 8;
    for (int w = threadIdx.x; w < rows * ch; w += blockDim.x)
      cp_async16(dst + (w / ch) * ld + (w % ch) * 8, src + (size_t)(w / ch) * cols + (w % ch) * 8,
                 true);
  };
  load_w(Wq, LDQ, wqkv, D, 3 * D);
  load_w(Wo, LDD, wo, D, D);
  load_w(W1, LDF, w1, D, F);
  load_w(W2, LDD, w2, F, D);
  // example b's x and dy rows (rows Lp..Mp-1 zero-filled) and madd row
  auto load = [&](int b, int st) {
    const size_t base = (size_t)b * Lp * D;
    for (int w = threadIdx.x; w < 2 * Mp * D8; w += blockDim.x) {
      const int which = w / (Mp * D8), i = (w / D8) % Mp, c = w % D8;
      const bool in = i < Lp;
      cp_async16((which ? DYs(st) : Xs(st)) + i * LDD + c * 8,
                 (which ? dy : x) + base + (size_t)(in ? i : 0) * D + c * 8, in);
    }
    for (int w = threadIdx.x; w < Lp / 4; w += blockDim.x)
      cp_async16(Ms(st) + 4 * w, madd + (size_t)b * Lp + 4 * w, true);
  };
  int b = blockIdx.x;
  if (b < B) load(b, 0);
  cp_async_commit();

  for (int st = 0; b < B; b += gridDim.x, st ^= 1) {
    if (b + (int)gridDim.x < B) load(b + gridDim.x, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this example (and, first, the weights) have landed
    __syncthreads();
    bf16* X = Xs(st);
    bf16* DY = DYs(st);
    const float* M = Ms(st);

    // ---- q|k|v = rnd(rnd(x Wqkv) + bqkv), every row (the other strips' keys)
    if (active) {
      for (int c0 = qc0; c0 < qc1; c0 += 64) {
        const int nn = min(8, (qc1 - c0) / 8);
        float acc[8][4];
        strip_mm<8, false>(acc, X, LDD, i0, D16, Wq, LDQ, c0, nn, lane);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n >= nn) break;
          const int c = c0 + n * 8 + 2 * t;
          const float bb0 = bfv(bqkv + c), bb1 = bfv(bqkv + c + 1);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            put2(QKV, LDQ, i0 + g + 8 * r, c, rb(rb(acc[n][2 * r]) + bb0),
                 rb(rb(acc[n][2 * r + 1]) + bb1));
        }
      }
    }
    __syncthreads();

    // ---- the strip's recompute and row-local backward, in registers; the
    // two warps of a strip split its columns, and its heads
    float xh1[NTH][4], rs1[2], rg[NTH][4];  // rg: dy -> dr2 -> dx1 -> dr1
    uint32_t keep_a[KH], keep_o = 0u, keep_2 = 0u;  // the forward's keep bits
    if (active) {
      // attention forward, head by head (row 10's strip code)
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const int h = 2 * k + half;
        keep_a[k] = 0u;
        if (h >= NH) break;
        float s[kNT][4];
        strip_abt<HD16>(s, QKV + h * HD, LDQ, QKV + D + h * HD, LDQ, i0, ntile, lane);
        strip_softmax(s, mask(M), i0, Lp, ntile, scale, lane);
        const uint32_t keep = strip_keep(dr.seed, dr.t_attn, h, dr.b0 + b, i0, Lp, ntile, lane);
        keep_a[k] = keep;
        float o[NHT][4];
#pragma unroll
        for (int d = 0; d < NHT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
        strip_av<HD16>(o, [&](int kc, uint32_t a[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int n = 2 * kc + r / 2, e = 2 * (r & 1);
            a[r] = pack_bf16(dropped(s, keep, n, e, dr.inv_attn),
                             dropped(s, keep, n, e + 1, dr.inv_attn));
          }
        }, QKV + 2 * D + h * HD, LDQ, ntile, lane);
#pragma unroll
        for (int d = 0; d < NHT; ++d)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            put2(CTX, LDD, i0 + g + 8 * r, h * HD + d * 8 + 2 * t, o[d][2 * r], o[d][2 * r + 1]);
      }
      pair_bar(strip);  // ctx rows whole
      // o = rnd(rnd(ctx Wo) + bo), dropout (site nh), + x, LN1
      strip_mm<NTH, false>(xh1, CTX, LDD, i0, D16, Wo, LDD, dc0, nd, lane);
#pragma unroll
      for (int n = 0; n < NTH; ++n)
        if (n < nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + (e >> 1) * 8, c = dc0 + n * 8 + 2 * t + (e & 1);
            float o = rb(rb(xh1[n][e]) + bfv(bo + c));
            if (i < Lp) {
              const bool kp = kept(dr.seed, dr.t_hidden, NH, dr.b0 + b, i * D + c);
              keep_o |= (uint32_t)kp << (n * 4 + e);
              o = kp ? rb(o * dr.inv_hidden) : 0.0f;
            }
            xh1[n][e] = rb(o + bfv(X + i * LDD + c));
          }
      strip_ln<NTH>(xh1, nd, rs1, eps, inv_d, xch, strip, half, lane);
#pragma unroll
      for (int n = 0; n < NTH; ++n) {
        if (n >= nd) break;
        const int c = dc0 + n * 8 + 2 * t;
        const float ga = __ldg(g1 + c), gb = __ldg(g1 + c + 1), ca = __ldg(c1 + c),
                    cb = __ldg(c1 + c + 1);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          put2(X1, LDD, i0 + g + 8 * r, c, xh1[n][2 * r] * ga + ca, xh1[n][2 * r + 1] * gb + cb);
      }
      pair_bar(strip);  // x1 rows whole
      // u = rnd(rnd(x1 W1) + b1) and hm = rnd(act(u)), 64 columns of F at a time
      for (int f0 = fc0; f0 < fc1; f0 += 64) {
        const int nn = min(8, (fc1 - f0) / 8);
        float acc[8][4];
        strip_mm<8, false>(acc, X1, LDD, i0, D16, W1, LDF, f0, nn, lane);
        with_act(act, [&](auto tag) {
          constexpr int A = decltype(tag)::value;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            if (n >= nn) break;
            const int c = f0 + n * 8 + 2 * t;
            const float bb0 = bfv(b1 + c), bb1 = bfv(b1 + c + 1);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float u0 = rb(rb(acc[n][2 * r]) + bb0), u1 = rb(rb(acc[n][2 * r + 1]) + bb1);
              float h0, h1, d;
              act_pair<A>(u0, h0, d);
              act_pair<A>(u1, h1, d);
              put2(U, LDF, i0 + g + 8 * r, c, u0, u1);
              put2(HM, LDF, i0 + g + 8 * r, c, h0, h1);
            }
          }
        });
      }
      pair_bar(strip);  // hm rows whole
      // h2 = rnd(rnd(hm W2) + b2), dropout (site nh + 1), + x1, LN2
      float xh2[NTH][4], rs2[2];
      strip_mm<NTH, false>(xh2, HM, LDF, i0, F / 16, W2, LDD, dc0, nd, lane);
#pragma unroll
      for (int n = 0; n < NTH; ++n)
        if (n < nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + (e >> 1) * 8, c = dc0 + n * 8 + 2 * t + (e & 1);
            float h2 = rb(rb(xh2[n][e]) + bfv(b2 + c));
            if (i < Lp) {
              const bool kp = kept(dr.seed, dr.t_hidden, NH + 1, dr.b0 + b, i * D + c);
              keep_2 |= (uint32_t)kp << (n * 4 + e);
              h2 = kp ? rb(h2 * dr.inv_hidden) : 0.0f;
            }
            xh2[n][e] = rb(h2 + bfv(X1 + i * LDD + c));
          }
      strip_ln<NTH>(xh2, nd, rs2, eps, inv_d, xch, strip, half, lane);

      // ---- backward: LN2 (dg2, dc2), dh2 = rnd(dropout(dr2)) with the
      // forward's keep bits (rows past Lp: dy = 0, kept)
#pragma unroll
      for (int n = 0; n < NTH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rg[n][e] = n < nd ? bfv(DY + (i0 + g + (e >> 1) * 8) * LDD + dc0 + n * 8 + 2 * t +
                                  (e & 1))
                            : 0.0f;
      strip_colsum<NTH>([&](int n, int e) { return rg[n][e] * xh2[n][e]; }, nd,
                        part + s_g2 + dc0, lane);
      strip_colsum<NTH>([&](int n, int e) { return rg[n][e]; }, nd, part + s_c2 + dc0, lane);
      strip_ln_bwd<NTH>(rg, xh2, nd, dc0, rs2, g2, inv_d, xch, strip, half, lane);
      float hv[NTH][4];  // dh2, then do
#pragma unroll
      for (int n = 0; n < NTH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + (e >> 1) * 8;
          const bool kp = i >= Lp || ((keep_2 >> (n * 4 + e)) & 1u);
          hv[n][e] = rb(kp ? rg[n][e] * dr.inv_hidden : 0.0f);
        }
#pragma unroll
      for (int n = 0; n < NTH; ++n) {
        if (n >= nd) break;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          put2(DH, LDD, i0 + g + 8 * r, dc0 + n * 8 + 2 * t, hv[n][2 * r], hv[n][2 * r + 1]);
      }
      strip_colsum<NTH>([&](int n, int e) { return hv[n][e]; }, nd, part + s_b2 + dc0, lane);
      pair_bar(strip);  // dh2 rows whole
      // du = rnd((dh2 W2^T) act'(u)) over U, in place
      for (int f0 = fc0; f0 < fc1; f0 += 64) {
        const int nn = min(8, (fc1 - f0) / 8);
        float acc[8][4];
        strip_mm<8, true>(acc, DH, LDD, i0, D16, W2, LDD, f0, nn, lane);
        with_act(act, [&](auto tag) {
          constexpr int A = decltype(tag)::value;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            if (n >= nn) break;
            const int c = f0 + n * 8 + 2 * t;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              bf16* p = U + (i0 + g + 8 * r) * LDF + c;
              float h, d0, d1;
              act_pair<A>(bfv(p), h, d0);
              act_pair<A>(bfv(p + 1), h, d1);
              acc[n][2 * r] = rb(acc[n][2 * r] * d0);
              acc[n][2 * r + 1] = rb(acc[n][2 * r + 1] * d1);
              put2(U, LDF, i0 + g + 8 * r, c, acc[n][2 * r], acc[n][2 * r + 1]);
            }
          }
        });
        strip_colsum<8>([&](int n, int e) { return acc[n][e]; }, nn, part + s_b1 + f0, lane);
      }
      pair_bar(strip);  // du rows whole
      // dx1 = dr2 + du W1^T; LN1 (dg1, dc1); do = rnd(dropout(dr1))
      {
        float acc[NTH][4];
        strip_mm<NTH, true>(acc, U, LDF, i0, F / 16, W1, LDF, dc0, nd, lane);
#pragma unroll
        for (int n = 0; n < NTH; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) rg[n][e] += acc[n][e];
      }
      strip_colsum<NTH>([&](int n, int e) { return rg[n][e] * xh1[n][e]; }, nd,
                        part + s_g1 + dc0, lane);
      strip_colsum<NTH>([&](int n, int e) { return rg[n][e]; }, nd, part + s_c1 + dc0, lane);
      strip_ln_bwd<NTH>(rg, xh1, nd, dc0, rs1, g1, inv_d, xch, strip, half, lane);
#pragma unroll
      for (int n = 0; n < NTH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + (e >> 1) * 8;
          const bool kp = i >= Lp || ((keep_o >> (n * 4 + e)) & 1u);
          hv[n][e] = rb(kp ? rg[n][e] * dr.inv_hidden : 0.0f);
        }
#pragma unroll
      for (int n = 0; n < NTH; ++n) {
        if (n >= nd) break;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          put2(DO, LDD, i0 + g + 8 * r, dc0 + n * 8 + 2 * t, hv[n][2 * r], hv[n][2 * r + 1]);
      }
      strip_colsum<NTH>([&](int n, int e) { return hv[n][e]; }, nd, part + s_bo + dc0, lane);
      pair_bar(strip);  // do rows whole
      // dctx = rnd(do Wo^T)
      strip_mm<NTH, true>(hv, DO, LDD, i0, D16, Wo, LDD, dc0, nd, lane);
#pragma unroll
      for (int n = 0; n < NTH; ++n) {
        if (n >= nd) break;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          put2(DCTX, LDD, i0 + g + 8 * r, dc0 + n * 8 + 2 * t, hv[n][2 * r], hv[n][2 * r + 1]);
      }
    }
    __syncthreads();

    // ---- dW2 += hm^T dh2, dW1 += x1^T du, dWo += ctx^T do (every strip's rows)
    flush_wgrad(HM, LDF, F, DH, LDD, D, nk16, slab + o_w2, warp, lane);
    flush_wgrad(X1, LDD, D, U, LDF, F, nk16, slab + o_w1, warp, lane);
    flush_wgrad(CTX, LDD, D, DO, LDD, D, nk16, slab + o_wo, warp, lane);
    __syncthreads();  // ctx, x1, ... are free for z and ds

    // ---- attention backward (row 11's strip code), two heads at once: the
    // warps of half 0 take heads 0, 2, ..., those of half 1 heads 1, 3, ...
#pragma unroll
    for (int k = 0; k < KH; ++k) {
      const int h = 2 * k + half;
      const bool mine = active && h < NH;
      bf16* Qh = QKV + h * HD;
      bf16* Kh = QKV + D + h * HD;
      bf16* Vh = QKV + 2 * D + h * HD;
      float aq[NHT][4];
      if (mine) {
        float s[kNT][4], dz[kNT][4];
        strip_abt<HD16>(s, Qh, LDQ, Kh, LDQ, i0, ntile, lane);
        strip_abt<HD16>(dz, DCTX + h * HD, LDD, Vh, LDQ, i0, ntile, lane);
        strip_softmax(s, mask(M), i0, Lp, ntile, scale, lane);
        const uint32_t keep = keep_a[k];
        float tsum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dz[n][e] = (keep >> (n * 4 + e)) & 1u ? dz[n][e] * dr.inv_attn : 0.0f;
            tsum[e >> 1] = fmaf(dz[n][e], s[n][e], tsum[e >> 1]);
          }
        tsum[0] = quad_sum(tsum[0]);
        tsum[1] = quad_sum(tsum[1]);
        // z = rnd(keep ? y / (1 - p) : 0) and ds = rnd(y (dy - t) scale) to
        // shared memory; ds stays in s for dq
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n >= ntile) break;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float z[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 2 * r + c;
              z[c] = dropped(s, keep, n, e, dr.inv_attn);
              s[n][e] = rb(s[n][e] * (dz[n][e] - tsum[r]) * scale);
            }
            put2(Zs, kLdz, i0 + g + 8 * r, n * 8 + 2 * t, z[0], z[1]);
            put2(DSs, kLdz, i0 + g + 8 * r, n * 8 + 2 * t, s[n][2 * r], s[n][2 * r + 1]);
          }
        }
        // dq = ds K, ds straight from the registers as A fragments
#pragma unroll
        for (int d = 0; d < NHT; ++d) aq[d][0] = aq[d][1] = aq[d][2] = aq[d][3] = 0.0f;
        strip_av<HD16>(aq, [&](int kc, uint32_t a[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[r] = pack_bf16(s[2 * kc + r / 2][2 * (r & 1)], s[2 * kc + r / 2][2 * (r & 1) + 1]);
        }, Kh, LDQ, ntile, lane);
      }
      __syncthreads();
      // dv = z^T dctx, dk = ds^T q for this warp's 16 key rows, over K and V
      if (mine) {
        float av[NHT][4], ak[NHT][4];
        key_strip_grads<HD16>(av, ak, Zs, DSs, kLdz, DCTX + h * HD, LDD, Qh, LDQ, i0, nk16,
                              lane);
#pragma unroll
        for (int d = 0; d < NHT; ++d)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            put2(Kh, LDQ, i0 + g + 8 * r, d * 8 + 2 * t, ak[d][2 * r], ak[d][2 * r + 1]);
            put2(Vh, LDQ, i0 + g + 8 * r, d * 8 + 2 * t, av[d][2 * r], av[d][2 * r + 1]);
          }
      }
      __syncthreads();  // q is read no more: dq over it
      if (mine) {
#pragma unroll
        for (int d = 0; d < NHT; ++d)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            put2(Qh, LDQ, i0 + g + 8 * r, d * 8 + 2 * t, aq[d][2 * r], aq[d][2 * r + 1]);
      }
    }
    __syncthreads();  // dq|dk|dv whole

    // ---- dx = rnd(dr1 + dqkv Wqkv^T) through the strip's dy rows; dbqkv
    if (active) {
      float acc[NTH][4];
      strip_mm<NTH, true>(acc, QKV, LDQ, i0, 3 * D16, Wq, LDQ, dc0, nd, lane);
#pragma unroll
      for (int n = 0; n < NTH; ++n) {
        if (n >= nd) break;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          put2(DY, LDD, i0 + g + 8 * r, dc0 + n * 8 + 2 * t, rg[n][2 * r] + acc[n][2 * r],
               rg[n][2 * r + 1] + acc[n][2 * r + 1]);
      }
      for (int c = qc0 + lane; c < qc1; c += 32) {
        float sdq = 0.0f;
        for (int r = 0; r < 16; ++r) sdq += bfv(QKV + (i0 + r) * LDQ + c);
        part[c] += sdq;
      }
      pair_bar(strip);  // dx rows whole
      const size_t base = (size_t)b * Lp * D;
      for (int w = half * 32 + lane; w < 16 * D8; w += 64) {
        const int i = i0 + w / D8, cc = w % D8;
        if (i < Lp)
          *reinterpret_cast<uint4*>(dx + base + (size_t)i * D + cc * 8) =
              *reinterpret_cast<const uint4*>(DY + i * LDD + cc * 8);
      }
    }
    // ---- dWqkv += x^T dqkv
    flush_wgrad(X, LDD, D, QKV, LDQ, 3 * D, nk16, slab + 0, warp, lane);
    __syncthreads();  // this stage and q|k|v are consumed
  }
  cp_async_wait<0>();
  __syncthreads();
  // the bias and LayerNorm sums, the four strips' rows in one order
  const int s_off[8] = {0, s_bo, s_g1, s_c1, s_b1, s_b2, s_g2, s_c2};
  const int o_off[8] = {o_bqkv, o_bo, o_g1, o_c1, o_b1, o_b2, o_g2, o_c2};
  for (int q = 0; q < 8; ++q) {
    const int len = (q < 7 ? s_off[q + 1] : NS) - s_off[q];
    for (int c = threadIdx.x; c < len; c += blockDim.x) {
      const float* p = sums + s_off[q] + c;
      slab[o_off[q] + c] += ((p[0] + p[NS]) + p[2 * NS]) + p[3 * NS];
    }
  }
}

template <int D16, int HD16>
int launch_mma(const void* x, const float* madd, const void* const* w, const float* const* ln,
               const void* dy, void* dx, float* slabs, int nblocks, int B, int Lp, int F,
               int act, int causal, float eps, Drop dr, cudaStream_t stream) {
  const int smem = mma_smem_bytes(D16 * 16, F, D16 / HD16);
  cudaError_t err = cudaFuncSetAttribute(layer_bwd_mma_kernel<D16, HD16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  layer_bwd_mma_kernel<D16, HD16><<<nblocks, 32 * kMmaWarps, smem, stream>>>(
      (const bf16*)x, madd, (const bf16*)w[0], (const bf16*)w[1], (const bf16*)w[2],
      (const bf16*)w[3], ln[0], ln[1], (const bf16*)w[4], (const bf16*)w[5], (const bf16*)w[6],
      (const bf16*)w[7], ln[2], ln[3], (const bf16*)dy, (bf16*)dx, slabs, B, Lp, F, act, causal,
      eps, dr);
  return (int)cudaGetLastError();
}

template <int D16, int HD16>
int blocks_mma(int B, int F) {
  const int smem = mma_smem_bytes(D16 * 16, F, D16 / HD16);
  cudaError_t err = cudaFuncSetAttribute(layer_bwd_mma_kernel<D16, HD16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, layer_bwd_mma_kernel<D16, HD16>, 32 * kMmaWarps, smem)) != cudaSuccess)
    return -(int)err;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  return n < B ? n : B;
}

int dispatch_launch_mma(int D, int nh, const void* x, const float* madd, const void* const* w,
                        const float* const* ln, const void* dy, void* dx, float* slabs,
                        int nblocks, int B, int Lp, int F, int act, int causal, float eps,
                        Drop dr, cudaStream_t s) {
  const int d16 = D / 16, h16 = D / nh / 16;
#define UNIREC_CASE(a, h)                                                                    \
  if (d16 == a && h16 == h)                                                                  \
    return launch_mma<a, h>(x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp, F, act, causal, \
                            eps, dr, s);
  UNIREC_MMA_PAIRS(UNIREC_CASE)
#undef UNIREC_CASE
  return (int)cudaErrorInvalidValue;
}

int dispatch_blocks_mma(int B, int D, int F, int nh) {
  const int d16 = D / 16, h16 = D / nh / 16;
#define UNIREC_CASE(a, h) \
  if (d16 == a && h16 == h) return blocks_mma<a, h>(B, F);
  UNIREC_MMA_PAIRS(UNIREC_CASE)
#undef UNIREC_CASE
  return -(int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* x, const float* madd, const void* const* w,
           const float* const* ln, const void* dy, void* dx, float* slabs,
           int nblocks, int B, int Lp, int D, int F, int nh, int act, int causal,
           float eps, Drop dr, cudaStream_t stream) {
  const size_t smem = sizeof(float) * layer_bwd_smem_floats(Lp, D, F, nh);
  cudaError_t err = cudaFuncSetAttribute(
      layer_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  layer_bwd_kernel<T><<<nblocks, kThreads, smem, stream>>>(
      (const T*)x, madd, (const T*)w[0], (const T*)w[1], (const T*)w[2],
      (const T*)w[3], ln[0], ln[1], (const T*)w[4], (const T*)w[5],
      (const T*)w[6], (const T*)w[7], ln[2], ln[3], (const T*)w[8], (const T*)w[9],
      (const T*)w[10], (const T*)w[11], (const T*)dy, (T*)dx,
      slabs, B, Lp, D, F, nh, act, causal, eps, dr);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks(int B, int Lp, int D, int F, int nh) {
  const size_t smem = sizeof(float) * layer_bwd_smem_floats(Lp, D, F, nh);
  cudaError_t err = cudaFuncSetAttribute(
      layer_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, layer_bwd_kernel<T>, kThreads, smem)) != cudaSuccess)
    return -(int)err;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  return n < B ? n : B;
}

}  // namespace

extern "C" {

int unirec_layer_bwd_smem_bytes(int Lp, int D, int F, int nh) {
  return (int)sizeof(float) * layer_bwd_smem_floats(Lp, D, F, nh);
}

int unirec_layer_bwd_slab_floats(int D, int F) { return layer_slab_floats(D, F); }

// 1 when the backward runs the bf16 tensor-core body (dtype 1, Lp <= 64, D
// and the head width D / nh multiples of 16 up to 64, F a multiple of 16,
// its shared memory within a block's; ops/layer.py::_layer_bwd_body holds a
// copy of the rule), and that body's bytes of dynamic shared memory
int unirec_layer_bwd_mma_takes(int dtype, int Lp, int D, int F, int nh) {
  return (int)mma_takes(dtype, Lp, D, F, nh);
}

int unirec_layer_bwd_mma_smem_bytes(int D, int F, int nh) { return mma_smem_bytes(D, F, nh); }

// The persistent grid's block count for a batch of B (SMs x resident
// blocks per SM, at most B) of the tensor-core body (mma 1) or the
// CUDA-core body (mma 0), or minus a cudaError_t.
int unirec_layer_bwd_blocks(int dtype, int B, int Lp, int D, int F, int nh, int mma) {
  if (mma) {
    if (!mma_takes(dtype, Lp, D, F, nh)) return -(int)cudaErrorInvalidValue;
    return dispatch_blocks_mma(B, D, F, nh);
  }
  if (dtype == 0) return blocks<float>(B, Lp, D, F, nh);
  if (dtype == 1) return blocks<__nv_bfloat16>(B, Lp, D, F, nh);
  return -(int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (x, dy, dx, weights and biases); madd
// and the LayerNorm parameters are float32. mma 1 runs the tensor-core
// body, which takes only what unirec_layer_bwd_mma_takes admits; mma 0 the
// CUDA-core body, which takes every shape the wrappers' gate admits, in
// both dtypes; nblocks from unirec_layer_bwd_blocks with the same mma. The
// CUDA-core body takes
// wqkvT, woT, w1T, w2T, the transposes of the four matmul weights,
// contiguous, so that the products with W^T read the weights coalesced,
// and slabs [nblocks, slab floats] f32, written whole (each block zeroes
// its own). The tensor-core body (where unirec_layer_bwd_mma_takes says so)
// ignores the transposes (null is fine), takes zeroed slabs, and x, dy, dx,
// madd and the four matmul weights 16-byte aligned. Dropout arguments as in
// unirec_layer_fwd. Returns a cudaError_t.
int unirec_layer_bwd(int dtype, const void* x, const float* madd,
                     const void* wqkv, const void* bqkv, const void* wo,
                     const void* bo, const float* g1, const float* c1,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, const float* g2, const float* c2,
                     const void* wqkvT, const void* woT, const void* w1T,
                     const void* w2T, const void* dy, void* dx, float* slabs,
                     int nblocks, int B,
                     int Lp, int D, int F, int nh, int act, int causal,
                     int mma, float eps, unsigned seed, unsigned t_attn,
                     unsigned t_hidden, float inv_attn, float inv_hidden,
                     unsigned b0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop dr{seed, t_attn, t_hidden, inv_attn, inv_hidden, b0};
  const void* w[12] = {wqkv, bqkv, wo, bo, w1, b1, w2, b2, wqkvT, woT, w1T, w2T};
  const float* ln[4] = {g1, c1, g2, c2};
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  if (mma) {
    if (!mma_takes(dtype, Lp, D, F, nh)) return (int)cudaErrorInvalidValue;
    return dispatch_launch_mma(D, nh, x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp, F, act,
                               causal, eps, dr, s);
  }
  if (dtype == 0)
    return launch<float>(x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp, D, F,
                         nh, act, causal, eps, dr, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, madd, w, ln, dy, dx, slabs, nblocks, B, Lp,
                                 D, F, nh, act, causal, eps, dr, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
