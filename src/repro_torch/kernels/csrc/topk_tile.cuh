// topk_tile.cuh — the catalog sweep that mips_topk.cu (k ≤ 32) and
// eval_fused.cu (every k) share, on Hopper's tensor cores (sm_90a), with
// the list merges of every top-k kernel in both files.
//
// The sweep scores a block of query rows against a split of the catalog
// and keeps each row's top-k under the key (value descending, id
// ascending):
//   * the scores are 3xTF32 products on the tensor cores (`mma.sync`
//     m16n8k8, the split, fragment layouts and k16 steps of
//     tf32x3_tile.cuh), catalog rows as mma's A (m16) and query rows as
//     B (n8), so a bucket of 8 queries multiplies no zero rows; the
//     queries are split once into B fragments in shared memory, the
//     catalog streams raw through a cp.async double buffer of 64-row
//     tiles and is split as each A fragment is loaded;
//   * target_scores runs the very same `score_step` for one (query,
//     catalog row) pair in the same orientation, split and k order, so a
//     target score computed alone equals the swept column bit for bit;
//   * a threshold the splits share, one int per row whose order is the
//     order of its value. Any k real columns make their k-th a safe bound:
//     a column scoring below it has k columns ahead of it; columns with
//     s ≥ τ are kept, so ties still resolve by id. A pre-pass (the same
//     sweep over a strided sample of the tiles) keeps each lane's best
//     column, and tau_select_kernel takes the k-th of that union as the
//     rows' first τ; every block then raises it with atomicMax to its
//     lists' k-th value (never a pad) and reads it before its filters;
//   * the filter appends to per-row candidate buffers in shared memory;
//     a warp merges a row's buffer into the row's sorted list only when
//     the next tile could overflow it, or at the end of the split, so no
//     barrier per tile waits on merges;
//   * a merge kernel reduces a row's S split lists to its top-k from the
//     entries at or above the final τ.
// A hook sees every tile's scores before the filter: mips_topk passes
// none, eval_fused counts ranks and folds an online LSE there.
//
// The deep variant (FROM_S). The sweep holds its queries' fragments and
// two catalog tiles over the whole depth, which caps d at kMaxD = 256.
// Above it (and for the k > kMaxSweepK lists of mips_topk's chain) the
// caller first computes the score slab S = Y · Qᵀ with deep_tc.cuh —
// on f32 operands a product that walks the depth in chunks of 32 with
// the very score_step arithmetic of this sweep (catalog rows as A, the
// same split and k16 order), on bf16 operands gemm_bf16 (bf16 `wgmma`,
// the depth summed in the tensor cores) — and the sweep reads each tile's
// scores from S instead of computing them: the filter, the shared
// threshold, the merges and the hook are the same code, on the same
// (row, column) values. What bounds that read on an H100 is the slab's
// bytes: 4·c·n_q once at 3.35 TB/s (a 1,024-row eval slab of the
// 256,000-token vocabulary: 1.05 GB, 0.313 ms), 25 GB/s an SM, so by
// Little's law at ≈ 1 µs of latency ≥ 25 KB in flight an SM. A tile of
// the slab (64 catalog rows × the block's QB query columns) therefore
// comes by one TMA box (`cp.async.bulk.tensor.2d` on the slab's tensor
// map, slab_map) into a ring of kSlabStages shared-memory stages, issued
// by one thread kSlabStages − 1 tiles ahead of the fold and completing on
// the stage's mbarrier. A box of 32 columns lands in the TMA's 128-byte
// swizzle (the 16-byte chunk c of row r at c ^ (r & 7)), so a
// half-warp's fragment reads (rows gq, columns 2q, 2q + 1, by LDS.64)
// take two wavefronts where unswizzled 128-byte rows take four; a box of
// 8 columns (QB 8) lands as it is, its 32-byte rows in one. A 1-D bulk
// copy a catalog row (128 bytes) would issue only about every 20 cycles
// on an SM, half the byte rate (the sweep's clock profile, PERF.md); a
// box a tile issues once. The slab's rows are slab_ld(n_q) floats apart,
// a multiple of 4 (a tensor map's rows are 16-byte multiples). A FROM_S
// block holds neither fragments nor tiles, so its own plan (mips_topk.py
// slab_sweep_plan) runs blocks of 4 query tiles, 4 an SM
// (sweep_min_blocks): 16 warps and 64 KB of copies in flight an SM, where
// Cfg<16>'s 8 warps, loading 32 scalars a thread a tile, would have
// nothing in flight while they fold. target_scores
// takes any depth, in the slab's arithmetic (score_step on f32; on bf16
// above kMaxD an `mma.sync` m16n8k16 bf16 chain, which gives gemm_bf16's
// bits: probes/bf16_tc_check.py slab_bits), so the target's score is
// still the swept column bit for bit. The slab costs 2·c·n_q·4 bytes of
// traffic against 2·c·n_q·d FLOP of products: at d 2304 a byte a 576
// FLOP, far above the card's ridge.
//
// bfloat16 operands (T = tf32x3::bf16), resident (d ≤ kMaxD): the catalog
// tiles and the queries are read as stored and widened to f32 as they are
// staged (the tiles through registers: there is no 2-byte cp.async), so
// every score is the f32 sweep's on the widened values bit for bit;
// target_scores reads its two rows the same way, and stays the swept
// column. Deep, the scores are the bf16 product's (other bits than the
// f32 launch on the widened values).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "deep_tc.cuh"
#include "tf32x3_tile.cuh"

namespace topk_tile {

constexpr float kNegInf = -1e30f;
constexpr float kPosInf = __builtin_huge_valf();  // a NaN score's rank
constexpr int kIdPad = 0x7fffffff;
constexpr int kThreads = 256;      // merge and select blocks
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSweepK = 512;  // the sweeps' lists (and today's chain)
constexpr int kMaxK = 1024;      // mips_topk's deep k > 32 chain
constexpr int kMaxD = 256;  // the resident-tile kernels; above: FROM_S
constexpr int kSlotsSmall = 8;  // list entries a lane holds for k ≤ 256
constexpr int kSlotsLarge = kMaxSweepK / 32;  // ... for k ≤ 512
constexpr int kSlotsHuge = kMaxK / 32;  // ... for k ≤ 1024 (deep chain)
constexpr int kMaxSmem = 232448;   // 227 KB opt-in per block on sm_90
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// The merge key: a comes before b iff its value is larger, or equal with
// the lower id. No NaN reaches it: the sweeps' filters enter a NaN score
// as +inf.
__device__ __forceinline__ bool precedes(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The shared threshold τ of a row as an int whose signed order is the
// float order of its value (NaN never enters). Memset to 0x80 bytes it
// reads −3.39e38, below every list value: no threshold yet.
__device__ __forceinline__ int tau_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float tau_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// τ as the other blocks' atomics left it (not a stale cached copy).
__device__ __forceinline__ int load_tau(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// Merges n ≤ 64 candidates (cv, ci) into the sorted list (lv, li) of
// length k, keeping the k first by the key; the merged list is unique
// under it. By merge path: the candidates are first moved into key order
// in their own buffer (each one's rank among them is a count over n);
// then a candidate's new place is its rank among the candidates plus the
// number of list entries that precede it, and a list entry's new place is
// its index plus the number of candidates that precede it — each a binary
// search of the other, sorted side. Pads (NEG_INF, ID_PAD) in the list
// are preceded by every candidate, so they shift right in list order.
// One warp; every lane calls; k ≤ 32·SLOTS.
template <int SLOTS>
__device__ void rank_merge(float* lv, int* li, int k, float* cv, int* ci,
                           int n, int lane) {
  float mv[2];
  int mi[2];
  int mr[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = lane + 32 * u;
    mr[u] = -1;
    if (c < n) {
      const float v = cv[c];
      const int id = ci[c];
      int r = 0;
#pragma unroll 4
      for (int c2 = 0; c2 < n; ++c2) r += precedes(cv[c2], ci[c2], v, id);
      mv[u] = v;
      mi[u] = id;
      mr[u] = r;
    }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (mr[u] >= 0) {
      cv[mr[u]] = mv[u];
      ci[mr[u]] = mi[u];
    }
  }
  __syncwarp();

  float ev[SLOTS + 2];
  int ei[SLOTS + 2];
  int er[SLOTS + 2];
#pragma unroll
  for (int t = 0; t < SLOTS; ++t) {
    const int j = lane + 32 * t;
    er[t] = k;  // k = not kept
    if (j < k) {
      const float v = lv[j];
      const int id = li[j];
      int lo = 0, hi = n;  // candidates preceding (v, id)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (precedes(cv[mid], ci[mid], v, id)) lo = mid + 1;
        else hi = mid;
      }
      ev[t] = v;
      ei[t] = id;
      er[t] = j + lo;
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = lane + 32 * u;
    er[SLOTS + u] = k;
    if (c < n) {
      const float v = cv[c];
      const int id = ci[c];
      int lo = 0, hi = k;  // list entries preceding (v, id)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (precedes(lv[mid], li[mid], v, id)) lo = mid + 1;
        else hi = mid;
      }
      ev[SLOTS + u] = v;
      ei[SLOTS + u] = id;
      er[SLOTS + u] = c + lo;
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < SLOTS + 2; ++t) {
    if (er[t] < k) {
      lv[er[t]] = ev[t];
      li[er[t]] = ei[t];
    }
  }
  __syncwarp();
}

// Streams the `count` pairs (pv[e], pi[e]), 32 per step, through a
// warp-owned list: the pairs that beat the list's k-th entry and score
// at least `floor` are compacted into the warp's 32-slot buffer (bv, bi)
// and rank-merged. The next 32 pairs are read before the current ones
// are merged, to hide their latency. Every lane calls.
template <int SLOTS>
__device__ void stream_merge(float* lv, int* li, int k, float* bv, int* bi,
                             const float* pv, const int* pi, long count,
                             float floor, int lane) {
  float tv = lv[k - 1];
  int ti = li[k - 1];
  float s = lane < count ? pv[lane] : kNegInf;
  int id = lane < count ? pi[lane] : kIdPad;
  for (long base = 0; base < count; base += 32) {
    const long e = base + 32 + lane;
    const float s_next = e < count ? pv[e] : kNegInf;
    const int id_next = e < count ? pi[e] : kIdPad;
    const bool cand = s >= floor && precedes(s, id, tv, ti);
    const unsigned mask = __ballot_sync(kFull, cand);
    if (mask) {
      if (cand) {
        const int pos = __popc(mask & ((1u << lane) - 1u));
        bv[pos] = s;
        bi[pos] = id;
      }
      __syncwarp();
      rank_merge<SLOTS>(lv, li, k, bv, bi, __popc(mask), lane);
      tv = lv[k - 1];
      ti = li[k - 1];
    }
    s = s_next;
    id = id_next;
  }
}

// Shared memory of one merge block: a list and a 32-slot buffer per warp.
__host__ __device__ inline size_t merge_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * kWarps * ((size_t)k + 32);
}

// Merges the n_split sorted lists of row blockIdx.x (every thread
// calls): each of 8 warps merges a contiguous share of the row's
// n_split·k entries, then warp 0 merges the 8 warp lists and writes the
// row's top-k, with ID_PAD wherever the value is NEG_INF (an exhausted
// row's slots). With `tau` (the sweeps' shared thresholds, as keys) an
// entry below its row's final τ is skipped unread by the merges: it has
// k columns ahead of it.
template <int SLOTS>
__device__ __forceinline__ void merge_split_lists(
    const float* __restrict__ part_vals, const int* __restrict__ part_ids,
    float* __restrict__ vals, int* __restrict__ ids, int n_split, int k,
    const int* __restrict__ tau, float4* smem4) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  float* wl_v = reinterpret_cast<float*>(smem4);               // (8, k)
  int* wl_i = reinterpret_cast<int*>(wl_v + kWarps * k);       // (8, k)
  float* buf_v = reinterpret_cast<float*>(wl_i + kWarps * k);  // (8, 32)
  int* buf_i = reinterpret_cast<int*>(buf_v + kWarps * 32);    // (8, 32)
  float* lv = wl_v + warp * k;
  int* li = wl_i + warp * k;
  for (int j = lane; j < k; j += 32) {
    lv[j] = kNegInf;
    li[j] = kIdPad;
  }
  __syncwarp();

  const float floor =
      tau != nullptr ? tau_value(tau[row]) : -__builtin_huge_valf();
  const long n = (long)n_split * k;
  const long lo = n * warp / kWarps;
  const long hi = n * (warp + 1) / kWarps;
  const float* pv = part_vals + (long)row * n + lo;
  const int* pi = part_ids + (long)row * n + lo;
  stream_merge<SLOTS>(lv, li, k, buf_v + warp * 32, buf_i + warp * 32, pv,
                      pi, hi - lo, floor, lane);
  __syncthreads();

  if (warp == 0) {
    stream_merge<SLOTS>(lv, li, k, buf_v, buf_i, wl_v + k, wl_i + k,
                        (long)(kWarps - 1) * k, floor, lane);
    for (int j = lane; j < k; j += 32) {
      vals[(long)row * k + j] = lv[j];
      ids[(long)row * k + j] = lv[j] == kNegInf ? kIdPad : li[j];
    }
  }
}

// The tensor-core sweep's merge of row blockIdx.x's n_split lists (every
// thread calls): all threads first gather the entries at or above the
// row's final τ (`tau`, as keys) — every column of the top k is among
// them, and few others are — into shared memory, then warp 0 rank-merges
// them 64 at a time and writes the row's top-k, ID_PAD wherever the value
// is NEG_INF. A row with more than kMergeCap such entries (ties at τ over
// many splits) takes merge_split_lists. Shared memory:
// sweep_merge_smem_bytes(k).
constexpr int kMergeCap = 1024;

inline size_t sweep_merge_smem_bytes(int k) {
  return merge_smem_bytes(k) + 8 * (size_t)kMergeCap + 16;
}

template <int SLOTS>
__device__ __forceinline__ void merge_row_lists(
    const float* __restrict__ part_vals, const int* __restrict__ part_ids,
    float* __restrict__ vals, int* __restrict__ ids, int n_split, int k,
    const int* __restrict__ tau, float4* smem4) {
  float* sv = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + merge_smem_bytes(k));
  int* si = reinterpret_cast<int*>(sv + kMergeCap);
  int* n_keep = si + kMergeCap;
  const int lane = threadIdx.x & 31;
  const long row = blockIdx.x;
  const float floor = tau_value(tau[row]);
  if (threadIdx.x == 0) *n_keep = 0;
  __syncthreads();
  const long n = (long)n_split * k;
  for (long e = threadIdx.x; e < n; e += kThreads) {
    const float v = part_vals[row * n + e];
    const int id = part_ids[row * n + e];
    if (id != kIdPad && v >= floor) {
      const int at = atomicAdd(n_keep, 1);
      if (at < kMergeCap) {
        sv[at] = v;
        si[at] = id;
      }
    }
  }
  __syncthreads();
  const int m = *n_keep;
  if (m > kMergeCap) {  // block-uniform
    merge_split_lists<SLOTS>(part_vals, part_ids, vals, ids, n_split, k, tau,
                             smem4);
    return;
  }
  if (threadIdx.x >= 32) return;
  float* lv = reinterpret_cast<float*>(smem4);  // warp 0's list
  int* li = reinterpret_cast<int*>(lv + kWarps * k);
  for (int j = lane; j < k; j += 32) {
    lv[j] = kNegInf;
    li[j] = kIdPad;
  }
  __syncwarp();
  for (int off = 0; off < m; off += 64)
    rank_merge<SLOTS>(lv, li, k, sv + off, si + off,
                      m - off < 64 ? m - off : 64, lane);
  for (int j = lane; j < k; j += 32) {
    vals[row * k + j] = lv[j];
    ids[row * k + j] = lv[j] == kNegInf ? kIdPad : li[j];
  }
}

// Opts `kernel` in to the full kMaxSmem of dynamic shared memory, once per
// device; `done` is the caller's per-kernel table. One function for both
// headers: a kernel instantiated on tf32x3::bf16 brings tf32x3's into
// argument-dependent lookup.
using tf32x3::allow_max_smem;
static_assert(kMaxSmem == tf32x3::kMaxSmem &&
                  kMaxDevices == tf32x3::kMaxDevices,
              "one opt-in table shape");

// ---------------------------------------------------------------------------
// The tensor-core sweep
// ---------------------------------------------------------------------------
constexpr int kTile = 64;               // catalog rows a streamed tile
constexpr int kCap = kTile + 32;        // candidate slots a row
constexpr int kMergeAt = kCap - kTile;  // a row past this merges first
constexpr int kMergeEager = 8;  // ... and with it every row past this

// dp: the depth rounded up to whole k16 steps (zeros past d).
__host__ __device__ inline int depth16(int d) { return (d + 15) / 16 * 16; }

// The pitch of a staged catalog row in floats, ≡ 8 mod 32: the 16 lanes
// of a half-warp that read rows gq = 0..3 and depths 2q, 2q + 1 with one
// LDS.64 each hit 16 different pairs of banks.
__host__ __device__ inline int tile_pitch(int d) {
  return (depth16(d) + 31) / 32 * 32 + 8;
}

// FROM_S: the ring's stages (a stage: 64 rows of QB floats as the TMA
// writes its box, 1024-byte aligned for its swizzle), and the slab's row
// pitch for n_q query columns (a multiple of 4: a tensor map's rows are
// 16-byte multiples). The slab's writer (deep_tc::score_slab) and its
// readers take the same slab_ld.
constexpr int kSlabStages = 3;

__host__ __device__ constexpr int slab_ld(int n_q) {
  return (n_q + 3) / 4 * 4;
}

// A 2-D box of the tensor map (inner coordinate x, outer y) into shared
// memory, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(deep_tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(deep_tc::smem_u32(bar))
      : "memory");
}

// The float index of the slab's (row r, column col) in a stage of QB
// columns: 32 columns in the TMA's 128-byte swizzle, 8 as they are.
template <int QB>
__device__ __forceinline__ int stage_at(int r, int col) {
  if constexpr (QB == 32)
    return r * QB + (((col >> 2) ^ (r & 7)) << 2) + (col & 3);
  else
    return r * QB + col;
}

// One block of the sweep: 8·NQT query rows (NQT n8 tiles) against 64-row
// catalog tiles, split over WM × WN warps; each warp computes MT m16
// tiles of catalog rows by NT n8 tiles of queries. MIN_BLOCKS blocks
// share an SM (registers ≤ 65536 / (THREADS·MIN_BLOCKS) a thread).
template <int NQT>
struct Cfg {
  static constexpr int kQB = 8 * NQT;
  static constexpr int kNT = NQT < 4 ? NQT : 4;
  static constexpr int kWN = NQT / kNT;
  static constexpr int kMT = kWN == 4 ? 2 : 1;
  static constexpr int kWM = kTile / (16 * kMT);
  static constexpr int kWarps = kWM * kWN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = NQT == 1 ? 4 : NQT == 4 ? 2 : 1;
  static_assert(kWM * kMT * 16 == kTile && kWN * kNT == NQT, "NQT");
};

// Blocks of the sweep an SM holds (__launch_bounds__' second argument):
// the resident Cfg's, or FROM_S's (4 query tiles at most, no fragments,
// no tiles: 4 blocks of 4 warps, 128 registers a thread).
template <int NQT, bool FROM_S>
constexpr int sweep_min_blocks() {
  static_assert(!FROM_S || NQT <= 4, "FROM_S takes 1 or 4 query tiles");
  return FROM_S ? 4 : Cfg<NQT>::kMinBlocks;
}

// Shared memory of one sweep block: the queries' B fragments (hi, lo),
// two catalog tiles and their valid flags, the merge requests, and per
// row a candidate count, a (value, id) list of k and a buffer of kCap.
// FROM_S holds no fragments and no catalog tiles: in their place the
// ring of kSlabStages slab tiles (64 rows of QB floats), 1 KB to align
// it, and its mbarriers (2 words each); eval_fused's reduction reuses
// the ring.
template <int NQT, bool FROM_S = false>
inline size_t sweep_smem_bytes(int d, int k) {
  constexpr size_t QB = Cfg<NQT>::kQB;
  const size_t dp = depth16(d);
  const size_t stage =
      FROM_S ? (size_t)kSlabStages * kTile * QB + 256 + 2 * kSlabStages
             : 2 * QB * dp + 2 * kTile * (size_t)tile_pitch(d);
  return 4 * (stage + 2 * kTile + 4 + QB + 2 * QB * ((size_t)k + kCap));
}

// One call of the sweep: grid (ceil(n_q / QB), S); block (x, s) takes
// the query rows [QB·x, QB·x + QB) and split s: the tiles
// [⌊s·T / S⌋, ⌊(s + 1)·T / S⌋) of the catalog's T tiles, or, with
// period > 0, the tiles s, s + period, s + 2·period, … (a pre-pass over a
// sample: no lists written, only τ published).
struct Sweep {
  const void* q;                // (n_q, d) query rows, f32 or bf16 (T)
  const void* y;                // (c, d) catalog rows, as q
  const unsigned char* valid;   // (c,) bool mask, or null
  float* part_vals;             // (n_q, S, k) split lists, or null
  int* part_ids;
  int* tau;                     // (n_q,) the shared thresholds, as keys
  int n_q, c, d, k, period;
  int id_offset;                // global id of y's first row
  int c_lo, c_hi;               // global-id window [c_lo, c_hi)
  int vec;                      // 4-value tile copies (d % 4 == 0, aligned)
  int seeded;                   // τ comes from a pre-pass
  const float* s;               // FROM_S: the scores (c, n_q), row-major
  CUtensorMap map;              // FROM_S: s's tensor map (slab_map)
};

// FROM_S: the slab's tensor map for blocks of NQT query tiles: 2-D (the
// n_q columns inner, the c rows outer), rows slab_ld(n_q) floats apart,
// boxes of QB columns × 64 rows, 128-byte swizzle for QB = 32 (none for
// QB = 8), zeros past either edge. False where the driver refuses it.
template <int NQT>
inline bool slab_map(Sweep& a) {
  constexpr int QB = Cfg<NQT>::kQB;
  static_assert(QB == 8 || QB == 32, "FROM_S takes 1 or 4 query tiles");
  const deep_tc::EncodeTiled enc = deep_tc::tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)a.n_q, (cuuint64_t)a.c};
  const cuuint64_t strides[1] = {(cuuint64_t)slab_ld(a.n_q) * 4};
  const cuuint32_t box[2] = {(cuuint32_t)QB, (cuuint32_t)kTile};
  const cuuint32_t el[2] = {1, 1};
  return enc(&a.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(a.s), dims, strides, box, el,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             QB == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Column c0 + tid of a tile of nc columns: 1 if it is in the tile, its
// mask byte (if any) is set and its global id is in the window.
__device__ __forceinline__ int valid_flag(const Sweep& a, long c0, int nc,
                                          int tid) {
  if (tid >= nc) return 0;
  const long gid = (long)a.id_offset + c0 + tid;
  return (a.valid == nullptr || a.valid[c0 + tid] != 0) && gid >= a.c_lo &&
         gid < a.c_hi;
}

// Starts the copy of catalog rows [c0, c0 + nc) into a staged f32 tile
// at pitch p: f32 by cp.async, 16-byte copies when `vec`, else 4-byte
// ones; bf16 through registers (8-byte loads when `vec`, else 2-byte),
// widened as stored — visible, as the copies are, after the barrier that
// follows the ring's wait. Thread tid takes the units tid,
// tid + n_threads, … of the rows in order, its (row, unit) stepped
// without a division a unit. The depth padding [d, dp) is never written.
template <typename T>
__device__ __forceinline__ void copy_tile(float* dst, const T* y, long c0,
                                          int nc, int d, int p, int vec,
                                          int tid, int n_threads) {
  const T* src = y + c0 * d;
  const int w = vec ? 4 : 1;  // values a copy
  const int units = d / w;    // copies a row
  const int dr = n_threads / units;
  const int du = n_threads - dr * units;
  int r = tid / units;
  int u = tid - r * units;
  while (r < nc) {
    if constexpr (sizeof(T) == 2) {
      if (vec)
        *reinterpret_cast<float4*>(dst + r * p + 4 * u) =
            tf32x3::load4(src + (long)r * d + 4 * u);
      else
        dst[r * p + u] = tf32x3::widen(src[(long)r * d + u]);
    } else if (vec) {
      cp_async16(dst + r * p + 4 * u, src + (long)r * d + 4 * u);
    } else {
      cp_async4(dst + r * p + u, src + (long)r * d + u);
    }
    r += dr;
    u += du;
    if (u >= units) {
      u -= units;
      ++r;
    }
  }
}

// One k16 step of a score tile: the three TF32 passes of both k8 steps
// from zero (tf32x3::mma3x2), then acc += them in f32. Every score of the
// sweep and of target_scores is this step applied from acc = 0 over the
// depths in order, with zeros past d.
__device__ __forceinline__ void score_step(float (&acc)[4],
                                           const uint32_t (&ah)[2][4],
                                           const uint32_t (&al)[2][4],
                                           const uint32_t (&bh)[2][2],
                                           const uint32_t (&bl)[2][2]) {
  float t[4];
  tf32x3::mma3x2(t, ah, al, bh, bl);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// The A fragment of one k8 step from the staged rows gq (r0) and gq + 8
// (r8) at depth 8s + 2q: (A[gq][q], A[gq+8][q], A[gq][q+4], A[gq+8][q+4])
// with logical k q at physical depth 2q and q + 4 at 2q + 1 (the
// convention of tf32x3_tile.cuh), split into (hi, lo).
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                       const float* r0, const float* r8) {
  const float2 u = *reinterpret_cast<const float2*>(r0);
  const float2 v = *reinterpret_cast<const float2*>(r8);
  tf32x3::split(u.x, ah[0], al[0]);
  tf32x3::split(v.x, ah[1], al[1]);
  tf32x3::split(u.y, ah[2], al[2]);
  tf32x3::split(v.y, ah[3], al[3]);
}

// The merges of one block: each warp takes rows warp, warp + WARPS, …
// whose buffer holds more than kMergeEager candidates (all: any) — a
// merge is asked for by a row past kMergeAt, and then every row that
// has gathered a few merges too, so that fewer barriers wait on merges. The
// buffer is first compacted to what can still enter — s ≥ the row's τ
// and ahead of its list's k-th entry — then rank-merged 64 at a time;
// a list whose k-th entry is real publishes its value as τ.
template <int SLOTS, int QB, int WARPS>
__device__ void merge_rows(float* lv, int* li, float* cv, int* ci, int* cnt,
                           int k, int* tau, int row0, bool all) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < QB; r += WARPS) {
    const int n = cnt[r];
    if (n == 0 || (!all && n <= kMergeEager)) continue;  // warp-uniform
    float* rv = lv + r * k;
    int* ri = li + r * k;
    float* bv = cv + r * kCap;
    int* bi = ci + r * kCap;
    const float tv = tau_value(load_tau(tau + row0 + r));
    const float kv = rv[k - 1];
    const int ki = ri[k - 1];
    int m = 0;
    for (int base = 0; base < n; base += 32) {
      const int e = base + lane;
      const float v = e < n ? bv[e] : kNegInf;
      const int id = e < n ? bi[e] : kIdPad;
      const bool keep = e < n && v >= tv && precedes(v, id, kv, ki);
      const unsigned mask = __ballot_sync(kFull, keep);
      __syncwarp();  // every lane has read its entry before any is moved
      if (keep) {
        const int pos = m + __popc(mask & ((1u << lane) - 1u));
        bv[pos] = v;
        bi[pos] = id;
      }
      m += __popc(mask);
      __syncwarp();
    }
    for (int off = 0; off < m; off += 64)
      rank_merge<SLOTS>(rv, ri, k, bv + off, bi + off,
                        m - off < 64 ? m - off : 64, lane);
    if (lane == 0) {
      cnt[r] = 0;
      if (ri[k - 1] != kIdPad) atomicMax(tau + row0 + r, tau_key(rv[k - 1]));
    }
    __syncwarp();
  }
}

// The sweep of one block (every thread calls). Stages its QB query rows
// once as split B fragments, streams its tiles by cp.async into a double
// buffer (the next tile's copy overlaps this tile's products), and scores
// each tile with score_step; FROM_S reads each tile's scores from the
// slab's ring instead (a TMA box kSlabStages − 1 tiles ahead, then the
// stage's mbarrier, then one LDS.64 a pair of columns). The warp
// (wm, wn) = (warp % WM, warp / WM) holds, for m16 tile mt, n8 tile nt
// and accumulator e, the score of
// catalog row 16·(wm·MT + mt) + gq + 8·(e >> 1) of the tile against query
// row 8·(wn·NT + nt) + 2q + (e & 1) of the block (lane = 4·gq + q).
// `on_tile(acc, flags, c0)` then sees the tile's scores, its 64 valid
// flags and its first column; the filter appends every valid score ≥ its
// row's threshold — the larger of τ and the list's k-th value — to the
// row's buffer. One barrier a tile (the copies'); a second only after a
// tile whose filter left a buffer past kMergeAt, around its merges.
// Returns the ring of tiles, which the caller may reuse once it returns.
template <int NQT, int SLOTS, bool SAMPLE = false, bool FROM_S = false,
          typename T = float, class OnTile>
__device__ __forceinline__ float* sweep(const Sweep& a, float4* smem4,
                                        OnTile&& on_tile) {
  using C = Cfg<NQT>;
  constexpr int QB = C::kQB, NT = C::kNT, MT = C::kMT, WM = C::kWM;
  constexpr int THREADS = C::kThreads;
  const int d = a.d;
  const int k = a.k;
  const int dp = depth16(d);
  const int p = tile_pitch(d);
  const int k8s = dp / 8;
  uint4* qf = reinterpret_cast<uint4*>(smem4);  // (NQT, dp / 8, 32)
  // 2×(64, p); FROM_S: kSlabStages×(64, QB) from the first 1024-byte
  // boundary, then the stages' mbarriers
  float* ring = FROM_S ? reinterpret_cast<float*>(
                             (reinterpret_cast<uintptr_t>(smem4) + 1023) &
                             ~uintptr_t(1023))
                       : reinterpret_cast<float*>(qf + NQT * k8s * 32);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kSlabStages * kTile * QB);
  int* flags = reinterpret_cast<int*>(
      FROM_S ? reinterpret_cast<float*>(full + kSlabStages)
             : ring + 2 * kTile * p);  // 2 × 64
  int* mreq = flags + 2 * kTile;  // merge requests by tile mod 3
  int* cnt = mreq + 4;                                    // (QB,)
  float* lv = reinterpret_cast<float*>(cnt + QB);         // (QB, k)
  int* li = reinterpret_cast<int*>(lv + QB * k);          // (QB, k)
  float* cv = reinterpret_cast<float*>(li + QB * k);      // (QB, kCap)
  int* ci = reinterpret_cast<int*>(cv + QB * kCap);       // (QB, kCap)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int qd = lane & 3;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int row0 = blockIdx.x * QB;
  const int split = blockIdx.y;

  // The queries as B fragments: entry (j, s, lane) holds query row
  // 8j + gq at depths 8s + 2q, 8s + 2q + 1 as (hi, hi, lo, lo); zeros
  // past d and past n_q. The tiles' depth padding, the lists, the counts.
  for (int e = tid; e < (FROM_S ? 0 : NQT * k8s * 64); e += THREADS) {
    const int u = e & 1;
    const int l = (e >> 1) & 31;
    const int js = e >> 6;
    const int r = row0 + 8 * (js / k8s) + (l >> 2);
    const int kk = 8 * (js % k8s) + 2 * (l & 3) + u;
    const float v = r < a.n_q && kk < d
                        ? tf32x3::widen(static_cast<const T*>(a.q)[(long)r * d + kk])
                        : 0.f;
    uint32_t* f = reinterpret_cast<uint32_t*>(qf + js * 32 + l);
    tf32x3::split(v, f[u], f[2 + u]);
  }
  for (int e = tid; e < (FROM_S ? 0 : 2 * kTile * (dp - d)); e += THREADS) {
    const int r = e / (dp - d);
    ring[r * p + d + (e - r * (dp - d))] = 0.f;
  }
  for (int e = tid; e < QB * k; e += THREADS) {
    lv[e] = kNegInf;
    li[e] = kIdPad;
  }
  for (int e = tid; e < QB; e += THREADS) cnt[e] = 0;
  if (tid < 4) mreq[tid] = 0;
  if (FROM_S && tid == 0) {
    for (int j = 0; j < kSlabStages; ++j) deep_tc::mbar_init(full + j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const long tiles = ((long)a.c + kTile - 1) / kTile;
  long first, step;
  int n_tiles;
  if (a.period == 0) {
    first = split * tiles / gridDim.y;
    step = 1;
    n_tiles = (int)((split + 1) * tiles / gridDim.y - first);
  } else {
    first = split;
    step = a.period;
    n_tiles = split < tiles ? (int)((tiles - 1 - split) / a.period + 1) : 0;
  }
  auto tile_c0 = [first, step](int i) { return (first + i * step) * kTile; };
  // Starts tile i's copy and returns its valid flag for thread tid < 64,
  // which the caller stores once the load has landed.
  auto issue = [&](int i) {
    const long c0 = tile_c0(i);
    const int nc = a.c - c0 < kTile ? (int)(a.c - c0) : kTile;
    if (!FROM_S)
      copy_tile(ring + (i & 1) * kTile * p, static_cast<const T*>(a.y), c0,
                nc, d, p, a.vec, tid, THREADS);
    return tid < kTile ? valid_flag(a, c0, nc, tid) : 0;
  };
  // FROM_S (thread 0): tile j's box of the slab (its 64 rows, the
  // block's QB columns; zeros past c and n_q, which the flags and rows
  // mask) into stage j mod kSlabStages, the stage's mbarrier armed with
  // the box's bytes.
  auto slab_copy = [&](int j) {
    uint64_t* bar = full + j % kSlabStages;
    deep_tc::mbar_arrive_tx(bar, 4 * kTile * QB);
    tma_load_2d(ring + (j % kSlabStages) * kTile * QB, &a.map, row0,
                (int)tile_c0(j), bar);
  };

  if (n_tiles > 0) {
    const int f = issue(0);
    if (tid < kTile) flags[tid] = f;
  }
  if (FROM_S && tid == 0)
    for (int j = 0; j < kSlabStages - 1 && j < n_tiles; ++j) slab_copy(j);
  cp_async_commit();
  float best[NT][2];  // a pre-pass's: the best of the lane's columns
  int tk[NT][2];      // the rows' τ as last read
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      best[nt][u] = -kPosInf;
      tk[nt][u] = (int)0x80808080;
    }
  int f_mine = n_tiles > 0 && tid < kTile ? flags[tid] : 1;  // tile i's
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    // Tile i has landed for every thread (FROM_S: its stage's mbarrier,
    // below); tile i − 1 is no longer read and its candidates are
    // complete. Are all of tile i's columns valid?
    const int all_valid = __syncthreads_and(tid >= kTile || f_mine);
    // The next tile's valid flags are read into a register here and stored
    // after this tile's filter, so their load does not stall the copy.
    const int f_next = i + 1 < n_tiles ? issue(i + 1) : 0;
    cp_async_commit();
    // FROM_S: tile i − 1's stage is free (every thread has read it); the
    // tile kSlabStages − 1 ahead goes there.
    if (FROM_S && tid == 0 && i + kSlabStages - 1 < n_tiles)
      slab_copy(i + kSlabStages - 1);
    // The rows' τ, read now, used after the products: every tile, or,
    // when a pre-pass seeded it, every 8th (the blocks' merges raise it
    // little then).
    if (!SAMPLE && (!a.seeded || (i & 7) == 0)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = row0 + 8 * (wn * NT + nt) + 2 * qd + u;
          tk[nt][u] = r < a.n_q ? load_tau(a.tau + r) : (int)0x80808080;
        }
    }
    if (!SAMPLE && mreq[(i + 2) % 3]) {  // tile i − 1 filled a buffer
      merge_rows<SLOTS, QB, C::kWarps>(lv, li, cv, ci, cnt, k, a.tau, row0,
                                       false);
      __syncthreads();
    }
    if (tid == 0) mreq[(i + 1) % 3] = 0;  // tile i − 2's, read at i − 1

    const float* tb = ring + (i & 1) * kTile * p;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    if constexpr (FROM_S) {
      // The tile's scores from its stage once its box has landed (zeros
      // past the catalog and n_q: the filter and the hook mask those by
      // their flags and rows).
      deep_tc::mbar_wait(full + i % kSlabStages,
                         (uint32_t)((i / kSlabStages) & 1));
      const float* sb = ring + (i % kSlabStages) * kTile * QB;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = *reinterpret_cast<const float2*>(
                sb + stage_at<QB>(16 * (wm * MT + mt) + gq + 8 * h,
                                  8 * (wn * NT + nt) + 2 * qd));
            acc[mt][nt][2 * h] = v.x;
            acc[mt][nt][2 * h + 1] = v.y;
          }
    }
#pragma unroll 2
    for (int s16 = 0; s16 < (FROM_S ? 0 : dp / 16); ++s16) {
      uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* r0 = tb + (16 * (wm * MT + mt) + gq) * p + 16 * s16 +
                            8 * kk + 2 * qd;
          load_a(ah[mt][kk], al[mt][kk], r0, r0 + 8 * p);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint4 f = qf[((wn * NT + nt) * k8s + 2 * s16 + kk) * 32 + lane];
          bh[kk][0] = f.x;
          bh[kk][1] = f.y;
          bl[kk][0] = f.z;
          bl[kk][1] = f.w;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          score_step(acc[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }

    const long c0 = tile_c0(i);
    const int* fl = flags + (i & 1) * kTile;
    on_tile(acc, fl, c0);

    if constexpr (SAMPLE) {  // a pre-pass keeps each lane's best column
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float x = acc[mt][nt][2 * h + u];
              if (fl[16 * (wm * MT + mt) + gq + 8 * h])
                best[nt][u] = fmaxf(best[nt][u], x != x ? kPosInf : x);
            }
    } else {
      // The filter: every valid score at or above its row's threshold — the
      // larger of τ and the list's k-th value — goes to the row's buffer. A
      // thread first marks its scores that are not below it and reserves
      // their slots with one atomicAdd a row, the rows' atomics in flight
      // together. A NaN score (a diverged model) is not below it and enters
      // as +inf: it ranks above every number and NaNs among themselves by
      // id, the order in which the plain version's stable sort (torch.sort)
      // and the reference's lax.top_k rank NaN; its value reads +inf.
      int fv[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          fv[mt][h] = fl[16 * (wm * MT + mt) + gq + 8 * h];
      float thr[NT][2];
      bool any = false;  // one compare a score when none passes, as most
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qr = 8 * (wn * NT + nt) + 2 * qd + u;
          thr[nt][u] = row0 + qr < a.n_q
                           ? fmaxf(tau_value(tk[nt][u]), lv[qr * k + k - 1])
                           : kPosInf;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              any |= !(acc[mt][nt][2 * h + u] < thr[nt][u]);
        }
      unsigned pass = 0;  // bit ((nt·2 + u)·MT + mt)·2 + h
      int at[NT][2] = {};
      if (any) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int qr = 8 * (wn * NT + nt) + 2 * qd + u;
            int n = 0;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const bool in = row0 + qr < a.n_q &&
                                (all_valid || fv[mt][h]) &&
                                !(acc[mt][nt][2 * h + u] < thr[nt][u]);
                pass |= (unsigned)in << (((nt * 2 + u) * MT + mt) * 2 + h);
                n += in;
              }
            at[nt][u] = n ? atomicAdd(&cnt[qr], n) : 0;
          }
      }
      if (pass) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int qr = 8 * (wn * NT + nt) + 2 * qd + u;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int bit = ((nt * 2 + u) * MT + mt) * 2 + h;
                if (!(pass >> bit & 1u)) continue;
                const float x = acc[mt][nt][2 * h + u];
                const int slot = at[nt][u]++;
                cv[qr * kCap + slot] = x != x ? kPosInf : x;
                ci[qr * kCap + slot] =
                    a.id_offset + (int)(c0 + 16 * (wm * MT + mt) + gq + 8 * h);
                if (slot == kMergeAt) mreq[i % 3] = 1;
              }
          }
      }
    }  // SAMPLE
    if (tid < kTile && i + 1 < n_tiles)
      flags[((i + 1) & 1) * kTile + tid] = f_next;
    f_mine = f_next;
  }
  if constexpr (SAMPLE) {
    // The pre-pass's union: per row and block, its 8·WM lanes' bests.
    const int n_split = gridDim.y;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = row0 + 8 * (wn * NT + nt) + 2 * qd + u;
        if (r < a.n_q)
          a.part_vals[((long)r * n_split + split) * (8 * WM) + 8 * wm + gq] =
              best[nt][u];
      }
    return ring;
  }
  __syncthreads();  // the last tile's candidates are complete
  merge_rows<SLOTS, QB, C::kWarps>(lv, li, cv, ci, cnt, k, a.tau, row0, true);
  __syncthreads();

  if (a.part_vals != nullptr) {
    const int n_split = gridDim.y;
    for (int e = tid; e < QB * k; e += THREADS) {
      const int r = e / k;
      const int j = e - r * k;
      if (row0 + r < a.n_q) {
        const long o = ((long)(row0 + r) * n_split + split) * k + j;
        a.part_vals[o] = lv[e];
        a.part_ids[o] = li[e];
      }
    }
  }
  return ring;
}

// Each row's target score: x[r] · y[t_r − id_offset] by score_step with
// the query row as B column gq and the target row as A row gq of an
// m16n8 tile (rows gq + 8 zero) — the sweep's orientation, split and k
// order — so it is bit for bit the score the sweep computes for that
// (query, catalog row) pair; 0 where t_r is outside [id_offset,
// id_offset + c). One warp a run of 8 rows, kTargetWarps warps a block.
// bf16 operands above kMaxD: target_scores_bf16 below, the deep slab's
// arithmetic in the same orientation.
constexpr int kTargetWarps = 4;

// Two bf16 values of row p at depths k, k + 1 packed as mma.sync takes
// them (depth k in the low half), 0 past d; `pair`: p 4-byte aligned and
// d even, one 4-byte load.
__device__ __forceinline__ uint32_t bf16_pair(const tf32x3::bf16* p, int k,
                                              int d, bool pair) {
  if (pair) return k < d ? *reinterpret_cast<const uint32_t*>(p + k) : 0u;
  const uint32_t lo = k < d ? p[k].bits : 0u;
  const uint32_t hi = k + 1 < d ? p[k + 1].bits : 0u;
  return lo | hi << 16;
}

// d += A·B on an m16n8k16 tile of bf16, f32 accumulate (mma.sync).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// target_scores on bf16 operands above kMaxD, in deep_tc.cuh gemm_bf16's
// arithmetic (the score slab's): the target row as A row gq of an
// m16n8k16 bf16 tile (rows gq + 8 zero), the query row as B column gq,
// both read as stored; the accumulator carried from zero through the k16
// steps in ascending depth, over gemm_bf16's 64-deep stages (zeros past
// d). On an H100 that chain gives the bits gemm_bf16 gives the pair
// wherever it sits in its tile (probes/bf16_tc_check.py slab_bits), so
// the target is the slab's column bit for bit. The diagonal (gq, gq) is
// C register c[gq & 1] of lane 4·gq + (gq >> 1).
__device__ __forceinline__ void target_scores_bf16(
    const tf32x3::bf16* x, const tf32x3::bf16* y, const int* targets,
    float* out, int n, int c, int d, int id_offset) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int qd = lane & 3;
  const int r0 = (blockIdx.x * kTargetWarps + (threadIdx.x >> 5)) * 8;
  if (r0 >= n) return;  // warp-uniform
  const int r = r0 + gq;
  const long local = r < n ? (long)targets[r] - id_offset : -1;
  const bool owned = local >= 0 && local < c;
  const tf32x3::bf16* xr = x + (long)(r < n ? r : 0) * d;
  const tf32x3::bf16* yr = y + (owned ? local : 0) * d;
  const bool pair = d % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 4 == 0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int steps = (d + 63) / 64 * 4;  // gemm_bf16's k16 steps
  for (int s16 = 0; s16 < steps; ++s16) {
    const int k = 16 * s16 + 2 * qd;
    const uint32_t a[4] = {owned ? bf16_pair(yr, k, d, pair) : 0u, 0u,
                           owned ? bf16_pair(yr, k + 8, d, pair) : 0u, 0u};
    const uint32_t b[2] = {r < n ? bf16_pair(xr, k, d, pair) : 0u,
                           r < n ? bf16_pair(xr, k + 8, d, pair) : 0u};
    mma_bf16(acc, a, b);
  }
  if (r < n && qd == gq >> 1) out[r] = owned ? acc[gq & 1] : 0.f;
}

template <typename T>
__device__ __forceinline__ void target_scores(const T* x, const T* y,
                                              const int* targets, float* out,
                                              int n, int c, int d,
                                              int id_offset) {
  if constexpr (sizeof(T) == 2) {
    if (d > kMaxD) {  // the deep bf16 slab's arithmetic
      target_scores_bf16(x, y, targets, out, n, c, d, id_offset);
      return;
    }
  }
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int qd = lane & 3;
  const int r0 = (blockIdx.x * kTargetWarps + (threadIdx.x >> 5)) * 8;
  if (r0 >= n) return;  // warp-uniform
  const int r = r0 + gq;
  const long local = r < n ? (long)targets[r] - id_offset : -1;
  const bool owned = local >= 0 && local < c;
  const T* xr = x + (long)(r < n ? r : 0) * d;
  const T* yr = y + (owned ? local : 0) * d;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s16 = 0; s16 < depth16(d) / 16; ++s16) {
    uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kd = 16 * s16 + 8 * kk + 2 * qd + u;
        tf32x3::split(r < n && kd < d ? tf32x3::widen(xr[kd]) : 0.f,
                      bh[kk][u], bl[kk][u]);
        tf32x3::split(owned && kd < d ? tf32x3::widen(yr[kd]) : 0.f,
                      ah[kk][2 * u], al[kk][2 * u]);
        ah[kk][2 * u + 1] = 0u;
        al[kk][2 * u + 1] = 0u;
      }
    score_step(acc, ah, al, bh, bl);
  }
  // (row gq, column gq) of the tile: the C register c0 of lane 4·gq + q
  // for column 2q, c1 for 2q + 1.
  if (r < n && qd == gq >> 1) out[r] = owned ? acc[gq & 1] : 0.f;
}

// ---------------------------------------------------------------------------
// The pre-pass's threshold
// ---------------------------------------------------------------------------
// A pre-pass block: the sweep in SAMPLE mode over the tiles s,
// s + period, … of a strided sample, writing per row the best column of
// each of its 8·WM lanes (a.part_vals: (n_q, S, 8·WM)). Every entry is a
// distinct real column or −inf, so the k-th of a row's union, taken by
// tau_select_kernel, is a safe τ for the sweep: the k-th of ≈ a sample's
// top, where the blocks' own lists start from nothing.
template <int NQT, bool FROM_S, typename T>
__global__ void __launch_bounds__(Cfg<NQT>::kThreads,
                                  sweep_min_blocks<NQT, FROM_S>())
sample_kernel(const __grid_constant__ Sweep a) {
  extern __shared__ float4 smem4[];
  sweep<NQT, 1, true, FROM_S, T>(a, smem4,
                                 [](const auto&, const int*, long) {});
}

// The k-th largest of v[0, n) (k ≤ 32): k times the largest left, one copy
// removed each time (the lowest lane's); −inf when fewer than k values are
// above −inf. With `out`, the k values in order. One warp; every lane
// calls; v is modified.
__device__ inline float warp_kth(float* v, int n, int k, float* out,
                                 int lane) {
  float g = -kPosInf;
  for (int j = 0; j < k; ++j) {
    float lm = -kPosInf;
    int at = -1;
    for (int e = lane; e < n; e += 32) {
      if (v[e] > lm) {
        lm = v[e];
        at = e;
      }
    }
    g = lm;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      g = fmaxf(g, __shfl_xor_sync(kFull, g, off));
    const unsigned m = __ballot_sync(kFull, at >= 0 && lm == g);
    if (m != 0u && lane == __ffs(m) - 1) v[at] = -kPosInf;
    if (out != nullptr && lane == 0) out[j] = g;
    __syncwarp();
  }
  return g;
}

inline size_t tau_select_smem_bytes(int n) {
  return 4 * ((size_t)n + 32 * kWarps);
}

// τ of row blockIdx.x (every thread calls): the k-th largest (k ≤ 32) of
// its n pre-pass entries as a key, or "no threshold" when fewer than k are
// real. Each warp takes the k largest of its share, warp 0 the k-th of
// theirs. Shared memory: tau_select_smem_bytes(n).
__global__ void __launch_bounds__(kThreads)
tau_select_kernel(const float* __restrict__ uv, int n, int k,
                  int* __restrict__ tau) {
  extern __shared__ float4 smem4[];
  float* v = reinterpret_cast<float*>(smem4);
  float* tops = v + n;  // (kWarps, 32)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long row = blockIdx.x;
  for (int e = threadIdx.x; e < n; e += kThreads) v[e] = uv[row * n + e];
  for (int e = threadIdx.x; e < 32 * kWarps; e += kThreads) tops[e] = -kPosInf;
  __syncthreads();
  const int lo = (int)((long)n * warp / kWarps);
  const int hi = (int)((long)n * (warp + 1) / kWarps);
  warp_kth(v + lo, hi - lo, k, tops + 32 * warp, lane);
  __syncthreads();
  if (warp == 0) {
    const float g = warp_kth(tops, 32 * kWarps, k, nullptr, lane);
    if (lane == 0) tau[row] = g > -kPosInf ? tau_key(g) : (int)0x80808080;
  }
}

// τ before a sweep: the pre-pass and its selection when pre_split > 0
// (k ≤ 32; uv: (n_q, pre_split, 8·WM) scratch), else "no threshold" for
// every row. `done` is the caller's opt-in table for the pre-pass kernel:
// a static here would be one object in every library a process loads (a
// template's static local is a unique global symbol), so one library's
// opt-in would stand for the other's kernel.
template <int NQT, bool FROM_S = false, typename T = float>
cudaError_t seed_tau(const Sweep& a, float* uv, int pre_split,
                     int pre_period, bool (&done)[kMaxDevices],
                     cudaStream_t s) {
  using C = Cfg<NQT>;
  if (pre_split == 0)
    return cudaMemsetAsync(a.tau, 0x80, sizeof(int) * (size_t)a.n_q, s);
  const int n_union = pre_split * 8 * C::kWM;
  if (a.k > 32 || uv == nullptr ||
      tau_select_smem_bytes(n_union) > 48 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_max_smem(sample_kernel<NQT, FROM_S, T>, done);
  if (err != cudaSuccess) return err;
  Sweep pre = a;
  pre.part_vals = uv;
  pre.part_ids = nullptr;
  pre.period = pre_period;
  sample_kernel<NQT, FROM_S, T>
      <<<dim3((a.n_q + C::kQB - 1) / C::kQB, pre_split), C::kThreads,
         sweep_smem_bytes<NQT, FROM_S>(a.d, a.k), s>>>(pre);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tau_select_kernel<<<a.n_q, kThreads, tau_select_smem_bytes(n_union), s>>>(
      uv, n_union, a.k, a.tau);
  return cudaGetLastError();
}

// Calls f(NQT, SLOTS) with both as std::integral_constant: the block's
// n8 query tiles (1, 4 or 16; FROM_S 1 or 4) and the list width (a lane
// holds 1 entry for k ≤ 32, 8 for k ≤ 256, 16 above; at most MAX_SLOTS).
template <int MAX_SLOTS, bool FROM_S = false, class F>
cudaError_t dispatch(int query_tiles, int k, F&& f) {
  auto by_nqt = [&](auto slots) -> cudaError_t {
    switch (query_tiles) {
      case 1: return f(std::integral_constant<int, 1>{}, slots);
      case 4: return f(std::integral_constant<int, 4>{}, slots);
      case 16:
        if constexpr (FROM_S) return cudaErrorInvalidValue;
        else return f(std::integral_constant<int, 16>{}, slots);
      default: return cudaErrorInvalidValue;
    }
  };
  if (k <= 32) return by_nqt(std::integral_constant<int, 1>{});
  if constexpr (MAX_SLOTS >= kSlotsSmall) {
    if (k <= 32 * kSlotsSmall)
      return by_nqt(std::integral_constant<int, kSlotsSmall>{});
  }
  if constexpr (MAX_SLOTS >= kSlotsLarge) {
    if (k <= kMaxSweepK)
      return by_nqt(std::integral_constant<int, kSlotsLarge>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace topk_tile
