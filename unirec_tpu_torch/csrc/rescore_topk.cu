// rescore_topk: pass 2 of the catalog top-k in one launch. For each user b,
// the kp chunks of 16 items that pass 1 kept (blk[b, :], the chunks with the
// largest block maxima) are re-scored in place, every ban of
// ops/topk.py::_ban_candidates is applied, and the top k of the surviving
// scores leave as values [B, k] f32 (descending) and ids [B, k] int64.
//
// Replaces no TPU kernel: pass 2 of unirec_tpu/ops/topk.py::fused_catalog_topk
// was XLA's gather, batched product and top_k. The port's first version ran
// the same plain tensor code (now ops/topk.py::_rescore_topk_plain, which
// the CPU runs and the tests compare against): it gathered the [B, kp*16, D]
// candidate rows into device memory, cast them to f32, scored them as B
// GEMVs, sorted the history to search it, and only then selected: at the
// serving shape (B=4,096, kp=301, D=64) 2.5 GB of bf16 gathered and 5 GB of
// f32 written and read again, to score rows of a 6.4 MB catalog.
//
// Bound on an H100: device memory carries only the users, the chunk ids,
// the histories and the output (28 MB at the serving shape, 0.0084 ms at
// 3.35 TB/s), and the 2.5 GFLOP of f32 products take about 0.04 ms on the
// CUDA cores. The candidate rows, 616 KB a user (4,816 rows of 128 bytes),
// 2.5 GB a request, come from the 50 MB L2 (the catalog fits many times
// over) or from L1, where rows that several users of one SM read hit again;
// how many bytes must cross from L2 depends on which users share an SM, so
// no L2 floor is counted. Tensor cores buy nothing: every user reads
// different rows.
//
// Design: one block of 256 threads a user, the user's working set in
// shared memory (4 kp 16 + 4 kp bytes of scores and chunk ids, the history
// as a hash set, the user row in f32, the k selected: 25 KB at the serving
// shape, so several users share an SM and their L2 reads overlap).
//   1. The user row is converted to f32 once; the valid history (t <
//      hist_len, minus keep_ids, minus what another ban already covers) goes
//      into an open-addressing hash set of at least twice its size (a
//      multiplicative hash, linear probing, atomicCAS inserts).
//   2. Re-scoring, three bodies (body_of picks one from the shapes and the
//      table's address):
//      - vector, for rows of whole 16-byte words from a 16-byte aligned
//        table (bf16 D % 8 == 0, f32 D % 4 == 0, int8 D % 16 == 0, up to 128
//        words): G lanes a row (the words a row rounded up to a power of
//        two, at most 32), each lane holding its words' user values in
//        registers, two rows a lane group in flight; one 16-byte load, 4-16
//        exact conversions and FMAs a word, log2 G shuffles a row;
//      - scalar, for any other D (D = 65, the item-bias column of
//        main/reco_topk.py, has 130-byte rows): a warp a row, one element a
//        lane a step, the user row read from shared memory;
//      - spill, for a working set past the block's 227 KB of shared memory
//        (a long history, a large k): the scalar body with the working set
//        in a global workspace the wrapper allocates, kSpillBlocks blocks
//        that each take user after user (the workspace is theirs, not B
//        users'), only the radix histogram in shared memory. Every step
//        below runs unchanged over it.
//      Products accumulate in f32 from the stored bf16, f32 or int8 values,
//      as the plain version's f32 bmm does; int8 rows are then multiplied
//      by their scale. An id past the table is read as its last row and
//      banned.
//   3. Bans turn a score into -inf: ids at or past min(N, invalid_from), id
//      0 under exclude_pad_item, ids in the hash set.
//   4. Selection: the scores become order-preserving 32-bit keys in place;
//      a radix select of four 8-bit digits (a shared-memory histogram a
//      digit, one warp scanning it from the top) finds the k-th largest key
//      T exactly; one pass then collects every key above T and, of the keys
//      equal to T, the `need` first in candidate order (a block prefix sum
//      of the tie flags, 256 candidates a step), so the same inputs select
//      the same ids; a rank sort of those k (value descending, ties by
//      candidate position, k^2 / 256 comparisons a thread) writes the
//      output. This reads the user's scores six times and needs no sort of
//      all kp 16.
// Capacity: every shape whose candidate ids fit in 32 bits (N at most
// kMaxN) and whose working set has fewer than 2^31 words; past it the
// entry returns kPastCapacity and ops/topk.py raises.
#include "common.cuh"

using namespace unirec;

namespace {

constexpr int kChunk = 16;          // items per chunk (csrc/blockmax.cu::kChunk)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;          // one radix digit
constexpr int kFixedWords = kBins + 3 + kWarps;  // histogram, scalars, a count a warp
constexpr int kSmemMax = 232448;    // an H100 block's dynamic shared memory
constexpr int kMaxVecWords = 128;   // 16-byte words a row for the vector body: 32 lanes x 4
constexpr int kMaxN = 2147483647 - kChunk;  // candidate ids stay in int
constexpr long long kMaxWords = 2147483647;  // a working set's words stay in int
constexpr int kSpillBlocks = 1056;  // 8 blocks of 256 threads on each of 132 SMs
constexpr int kMaxDevices = 64;
constexpr int kEmpty = -1;          // a free slot of the hash set
constexpr int kPastCapacity = -1;   // the entry's code for a shape past capacity

enum Body { kRefused = 0, kScalar = 1, kVector = 2, kSpill = 3 };

inline int item_bytes(int item_dtype) { return item_dtype == 0 ? 4 : item_dtype == 1 ? 2 : 1; }

// slots of the history's hash set: a power of two, at least 32 and 2 hcap
inline long long hash_slots(long long hcap) {
  if (hcap <= 0) return 0;
  long long s = 32;
  while (s < 2 * hcap) s <<= 1;
  return s;
}

// 32-bit words of one user's working set: the kp 16 scores (then keys), the
// kp chunk ids, the hash set, the user row, the k selected keys and positions
inline long long user_words(long long kp, long long k, long long hcap, long long D) {
  return kp * kChunk + kp + hash_slots(hcap) + D + 2 * k;
}

inline bool past_capacity(long long N, long long D, long long kp, long long k, long long hcap) {
  return N > kMaxN || user_words(kp, k, hcap, D) > kMaxWords;
}

int body_of(int item_dtype, int D, int kp, int k, int hcap, int N, int aligned) {
  if (item_dtype < 0 || item_dtype > 2 || D < 1 || kp < 1 || hcap < 0 || N < 1 || k < 1 ||
      (long long)k > (long long)kp * kChunk || past_capacity(N, D, kp, k, hcap))
    return kRefused;
  if (4 * (kFixedWords + user_words(kp, k, hcap, D)) > kSmemMax) return kSpill;
  const long long row = (long long)D * item_bytes(item_dtype);
  if (aligned && row % 16 == 0 && row / 16 <= kMaxVecWords) return kVector;
  return kScalar;
}

// bytes of global workspace a call needs: 0 unless its working set spills
long long workspace_bytes(int B, int D, int kp, int k, int hcap) {
  if (B < 1 || D < 1 || kp < 1 || k < 1 || hcap < 0) return 0;
  const long long w = user_words(kp, k, hcap, D);
  if (w > kMaxWords || 4 * (kFixedWords + w) <= kSmemMax) return 0;
  return 4 * w * (long long)min(B, kSpillBlocks);
}

struct Args {
  const void* u;
  const void* items;
  const float* scale;      // int8 items only
  const int64_t* blk;      // [B, kp] chunk ids
  const int64_t* hist;     // [B, hcap] or null
  const int64_t* hist_len; // [B] or null
  const int64_t* keep;     // [B] or null
  float* out_v;            // [B, k]
  int64_t* out_i;          // [B, k]
  uint32_t* ws;            // the spill body's workspace: a working set a block
  int B, user_f32, N, D, kp, k, hcap, slots, shift, exclude_pad, limit, words;
  int lanes, row_words;    // vector body: lanes a row, 16-byte words a row
};

// order-preserving map of a float to 32 bits (every NaN above +inf, as
// torch.topk ranks NaN first)
__device__ __forceinline__ uint32_t to_key(float f) {
  if (f != f) return 0xffffffffu;
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ uint32_t slot_of(int id, int shift) {
  return ((uint32_t)id * 2654435761u) >> shift;  // Fibonacci hashing
}

__device__ __forceinline__ bool in_set(const int* set, int slots, int shift, int id) {
  uint32_t s = slot_of(id, shift);
  while (true) {
    const int v = set[s];
    if (v == id) return true;
    if (v == kEmpty) return false;
    s = (s + 1) & (slots - 1);
  }
}

// the elements of one 16-byte word of items, exactly, dotted with u
template <typename TI> struct Word;
template <> struct Word<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static float dot(uint4 v, const float (&u)[n], float acc) {
    acc = fmaf(__uint_as_float(v.x), u[0], acc);
    acc = fmaf(__uint_as_float(v.y), u[1], acc);
    acc = fmaf(__uint_as_float(v.z), u[2], acc);
    return fmaf(__uint_as_float(v.w), u[3], acc);
  }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static float dot(uint4 v, const float (&u)[n], float acc) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 pair, the first element in the low half
      acc = fmaf(__uint_as_float(w[i] << 16), u[2 * i], acc);
      acc = fmaf(__uint_as_float(w[i] & 0xffff0000u), u[2 * i + 1], acc);
    }
    return acc;
  }
};
template <> struct Word<int8_t> {
  static constexpr int n = 16;
  __device__ __forceinline__ static float dot(uint4 v, const float (&u)[n], float acc) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)  // byte j, sign-extended
        acc = fmaf((float)((int32_t)(w[i] << (24 - 8 * j)) >> 24), u[4 * i + j], acc);
    return acc;
  }
};

// the catalog row candidate r reads (the last row for an id past it)
__device__ __forceinline__ size_t row_of(const int* blk, int r, int N) {
  const int c = blk[r >> 4];
  const int iid = c < 0 ? 0 : c * kChunk + (r & (kChunk - 1));
  return (size_t)min(iid, N - 1);
}

template <typename TI>
__device__ __forceinline__ float scaled(float acc, const Args& a, size_t row) {
  if constexpr (sizeof(TI) == 1) return acc * __ldg(a.scale + row);
  return acc;
}

// 2. vector body: G = a.lanes lanes a row, WPL words a lane at most
template <typename TI, int WPL>
__device__ void score_vector(const Args& a, const int* blk, const float* us, float* sc, int M) {
  constexpr int E = Word<TI>::n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = a.lanes, R = 32 / G, W = a.row_words;
  const int lg = lane & (G - 1), grp = lane / G;
  float ur[WPL][E];
#pragma unroll
  for (int j = 0; j < WPL; ++j) {
    const int w = lg + G * j;
#pragma unroll
    for (int e = 0; e < E; ++e) ur[j][e] = w < W ? us[w * E + e] : 0.0f;
  }
  const uint4* rows = reinterpret_cast<const uint4*>(a.items);
  for (int r0 = warp * 2 * R; r0 < M; r0 += kWarps * 2 * R) {  // uniform in the warp
    uint4 v[2][WPL];
    size_t row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * R + grp;
      row[h] = r < M ? row_of(blk, r, a.N) : 0;
#pragma unroll
      for (int j = 0; j < WPL; ++j) {
        const int w = lg + G * j;
        v[h][j] = (r < M && w < W) ? __ldg(rows + row[h] * W + w) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < WPL; ++j) acc = Word<TI>::dot(v[h][j], ur[j], acc);
      for (int o = G >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      const int r = r0 + h * R + grp;
      if (lg == 0 && r < M) sc[r] = scaled<TI>(acc, a, row[h]);
    }
  }
}

// 2. scalar body: a warp a row, any D and alignment
template <typename TI>
__device__ void score_scalar(const Args& a, const int* blk, const float* us, float* sc, int M) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TI* items = reinterpret_cast<const TI*>(a.items);
  for (int r0 = warp * 2; r0 < M; r0 += kWarps * 2) {
    size_t row[2];
    float acc[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) row[h] = r0 + h < M ? row_of(blk, r0 + h, a.N) : 0;
    for (int e = lane; e < a.D; e += 32) {
      const float ue = us[e];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 + h < M) acc[h] = fmaf(to_f<TI>(items[row[h] * a.D + e]), ue, acc[h]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s = warp_sum(acc[h]);
      if (lane == 0 && r0 + h < M) sc[r0 + h] = scaled<TI>(s, a, row[h]);
    }
  }
}

// one user's pass 2, on its working set (shared memory, or the workspace)
template <typename TI, int WPL>
__device__ void rescore_user(const Args& a, int b, uint32_t* hist, int* misc, uint32_t* keys) {
  const int M = a.kp * kChunk;
  int* blk = reinterpret_cast<int*>(keys + M);          // [kp]
  int* set = blk + a.kp;                                // [slots]
  float* us = reinterpret_cast<float*>(set + a.slots);  // [D]
  uint32_t* sel_key = reinterpret_cast<uint32_t*>(us + a.D);  // [k]
  int* sel_idx = reinterpret_cast<int*>(sel_key + a.k);  // [k]
  int* wties = misc + 3;                                // [kWarps]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = (a.N + kChunk - 1) / kChunk;

  // 1. the user row in f32, the chunk ids, the banned history as a hash set
  for (int i = tid; i < a.D; i += kThreads)
    us[i] = a.user_f32 ? reinterpret_cast<const float*>(a.u)[(size_t)b * a.D + i]
                       : __bfloat162float(
                             reinterpret_cast<const __nv_bfloat16*>(a.u)[(size_t)b * a.D + i]);
  for (int i = tid; i < a.kp; i += kThreads) {
    const int64_t c = a.blk[(size_t)b * a.kp + i];
    blk[i] = (c >= 0 && c < nb) ? (int)c : -1;  // a chunk id out of range bans its 16 ids
  }
  for (int i = tid; i < a.slots; i += kThreads) set[i] = kEmpty;
  __syncthreads();
  if (a.hcap) {
    const int64_t len = a.hist_len[b];
    const bool keeps = a.keep != nullptr;
    const int64_t keep = keeps ? a.keep[b] : 0;
    for (int t = tid; t < a.hcap && t < len; t += kThreads) {
      const int64_t h = a.hist[(size_t)b * a.hcap + t];
      // ids another ban covers, or that no candidate has, stay out
      if ((keeps && h == keep) || h < 0 || h >= a.limit || (a.exclude_pad && h == 0)) continue;
      const int id = (int)h;
      uint32_t s = slot_of(id, a.shift);
      while (true) {
        const int old = atomicCAS(set + s, kEmpty, id);
        if (old == kEmpty || old == id) break;
        s = (s + 1) & (a.slots - 1);
      }
    }
  }

  // 2. re-score the user's kp 16 candidates
  float* sc = reinterpret_cast<float*>(keys);
  if constexpr (WPL == 0) score_scalar<TI>(a, blk, us, sc, M);
  else score_vector<TI, WPL>(a, blk, us, sc, M);
  __syncthreads();

  // 3. the bans, and the scores as keys
  for (int i = tid; i < M; i += kThreads) {
    const int c = blk[i >> 4];
    const int iid = c < 0 ? -1 : c * kChunk + (i & (kChunk - 1));
    const bool banned = iid < 0 || iid >= a.limit || (a.exclude_pad && iid == 0) ||
                        (a.slots && in_set(set, a.slots, a.shift, iid));
    keys[i] = to_key(banned ? -CUDART_INF_F : sc[i]);
  }

  // 4. radix select of the k-th largest key T, one 8-bit digit a pass
  uint32_t prefix = 0, mask = 0, need = (uint32_t)a.k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < M; i += kThreads) {
      const uint32_t key = keys[i];
      if ((key & mask) == prefix) atomicAdd(hist + ((key >> shift) & (kBins - 1)), 1u);
    }
    __syncthreads();
    if (warp == 0) {  // lane l scans digits 255 - 8 l down to 248 - 8 l
      uint32_t c[8], tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) tot += (c[j] = hist[kBins - 1 - 8 * lane - j]);
      uint32_t incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += n;
      }
      uint32_t above = incl - tot;
      if (above < need && need <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above < need && need <= above + c[j]) {
            misc[0] = kBins - 1 - 8 * lane - j;
            misc[1] = (int)(need - above);
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)misc[0] << shift;
    mask |= (uint32_t)(kBins - 1) << shift;
    need = (uint32_t)misc[1];  // keys of this prefix still to take
  }

  // 5. the k - need keys above T, and the need first keys equal to it in
  // candidate order: tie flags summed over the block, 256 candidates a step
  if (tid == 0) misc[2] = 0;
  __syncthreads();
  const int above = a.k - (int)need;
  int taken = 0;  // ties taken before this step: the same in every thread
  for (int i0 = 0; i0 < M; i0 += kThreads) {
    const int i = i0 + tid;
    const uint32_t key = i < M ? keys[i] : 0u;
    if (i < M && key > prefix) {
      const int s = atomicAdd(misc + 2, 1);
      sel_key[s] = key;
      sel_idx[s] = i;
    }
    if (taken < (int)need) {  // uniform in the block
      const bool tie = i < M && key == prefix;
      const uint32_t bal = __ballot_sync(0xffffffffu, tie);
      if (lane == 0) wties[warp] = __popc(bal);
      __syncthreads();
      int before = taken + __popc(bal & ((1u << lane) - 1u)), total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int n = wties[w];
        before += w < warp ? n : 0;
        total += n;
      }
      if (tie && before < (int)need) {
        sel_key[above + before] = key;
        sel_idx[above + before] = i;
      }
      taken += total;
      __syncthreads();  // wties is read before the next step writes it
    }
  }
  __syncthreads();

  // 6. rank sort (value descending, ties by position) and the output
  for (int t = tid; t < a.k; t += kThreads) {
    const uint32_t key = sel_key[t];
    const int idx = sel_idx[t];
    int rank = 0;
    for (int j = 0; j < a.k; ++j) {
      const uint32_t kj = sel_key[j];
      rank += kj > key || (kj == key && sel_idx[j] < idx);
    }
    const int c = blk[idx >> 4];
    const size_t o = (size_t)b * a.k + rank;
    a.out_v[o] = from_key(key);
    a.out_i[o] = c < 0 ? -1 : (int64_t)c * kChunk + (idx & (kChunk - 1));
  }
}

// WPL 0: the scalar body; Spill: the working set in a.ws, a block a user
// after user
template <typename TI, int WPL, bool Spill>
__global__ void __launch_bounds__(kThreads) rescore_topk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);  // [kBins]
  int* misc = reinterpret_cast<int*>(hist + kBins);     // [3 + kWarps]
  uint32_t* keys = Spill ? a.ws + (size_t)blockIdx.x * a.words
                         : reinterpret_cast<uint32_t*>(misc + 3 + kWarps);
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    rescore_user<TI, WPL>(a, b, hist, misc, keys);
    __syncthreads();  // the working set is read before the next user writes it
  }
}

template <typename TI, int WPL, bool Spill>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = 4 * (kFixedWords + (Spill ? 0 : a.words));
  if constexpr (!Spill) {
    static bool ready[kMaxDevices] = {false};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || !ready[dev]) {
      err = cudaFuncSetAttribute(rescore_topk_kernel<TI, WPL, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) ready[dev] = true;
    }
  }
  const int grid = Spill ? min(a.B, kSpillBlocks) : a.B;
  rescore_topk_kernel<TI, WPL, Spill><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TI>
int dispatch(const Args& a, int body, cudaStream_t s) {
  if (body == kSpill) return launch<TI, 0, true>(a, s);
  if (body == kScalar) return launch<TI, 0, false>(a, s);
  const int wpl = (a.row_words + a.lanes - 1) / a.lanes;
  if (wpl == 1) return launch<TI, 1, false>(a, s);
  if (wpl == 2) return launch<TI, 2, false>(a, s);
  return launch<TI, 4, false>(a, s);
}

}  // namespace

extern "C" {

// the body that takes a call (0 = refused: invalid or past capacity,
// 1 = scalar, 2 = vector, 3 = spill); item_dtype as below, aligned: the
// table's address is a multiple of 16 bytes
int unirec_rescore_topk_body(int item_dtype, int D, int kp, int k, int hcap, int N,
                             int aligned) {
  return body_of(item_dtype, D, kp, k, hcap, N, aligned);
}

// bytes of device workspace unirec_rescore_topk needs for these shapes (0:
// the users' working sets fit in shared memory)
long long unirec_rescore_topk_workspace(int B, int D, int kp, int k, int hcap) {
  return workspace_bytes(B, D, kp, k, hcap);
}

// user_dtype: 0 = float32, 1 = bfloat16; item_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 with a float32 per-item scale. blk [B, kp], hist
// [B, hcap], hist_len [B], keep [B]: int64 (hist and hist_len only with
// hcap > 0, keep null for no exemption). limit bans every id from it on
// (min(N, invalid_from)); exclude_pad bans id 0. out_v [B, k] float32 and
// out_i [B, k] int64. ws: at least unirec_rescore_topk_workspace bytes of
// device memory. Picks the body itself. Returns kPastCapacity (-1) for a
// shape past the kernel's capacity, else a cudaError_t.
int unirec_rescore_topk(int user_dtype, int item_dtype, const void* u, const void* items,
                        const float* scale, const int64_t* blk, const int64_t* hist,
                        const int64_t* hist_len, const int64_t* keep, float* out_v,
                        int64_t* out_i, int B, int N, int D, int kp, int k, int hcap,
                        int exclude_pad, int limit, void* ws, long long ws_bytes,
                        void* stream) {
  if (past_capacity(N, D, kp, k, hcap)) return kPastCapacity;
  const int aligned = (int)(reinterpret_cast<uintptr_t>(items) % 16 == 0);
  const int body = body_of(item_dtype, D, kp, k, hcap, N, aligned);
  if (body == kRefused || (user_dtype != 0 && user_dtype != 1) ||
      (item_dtype == 2) != (scale != nullptr) ||
      (hcap > 0 && (hist == nullptr || hist_len == nullptr)) || limit < 0 || limit > N ||
      B < 0 || (B > 0 && ws_bytes < workspace_bytes(B, D, kp, k, hcap)) ||
      (body == kSpill && ws == nullptr && B > 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.u = u;
  a.items = items;
  a.scale = scale;
  a.blk = blk;
  a.hist = hcap > 0 ? hist : nullptr;
  a.hist_len = hcap > 0 ? hist_len : nullptr;
  a.keep = keep;
  a.out_v = out_v;
  a.out_i = out_i;
  a.ws = static_cast<uint32_t*>(ws);
  a.B = B;
  a.user_f32 = user_dtype == 0;
  a.N = N;
  a.D = D;
  a.kp = kp;
  a.k = k;
  a.hcap = hcap;
  a.slots = (int)hash_slots(hcap);
  a.shift = 32;
  for (int s = a.slots; s > 1; s >>= 1) --a.shift;
  a.exclude_pad = exclude_pad != 0;
  a.limit = limit;
  a.words = (int)user_words(kp, k, hcap, D);
  a.row_words = D * item_bytes(item_dtype) / 16;
  a.lanes = 1;
  while (a.lanes < 32 && a.lanes < a.row_words) a.lanes <<= 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (item_dtype == 0) return dispatch<float>(a, body, s);
  if (item_dtype == 1) return dispatch<__nv_bfloat16>(a, body, s);
  return dispatch<int8_t>(a, body, s);
}

}  // extern "C"
