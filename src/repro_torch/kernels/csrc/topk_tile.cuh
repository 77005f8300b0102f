// topk_tile.cuh — the catalog-sweep tile code that mips_topk.cu and
// eval_fused.cu share (Hopper, sm_90a).
//
// Both kernels stream a split of the catalog through shared memory, score
// it against a block of query rows in f32 register tiles, and keep each
// row's top-k under the key (value descending, id ascending). What they
// share lives here:
//   * the cp.async double-buffered loader of (64, d) catalog tiles;
//   * the RM×4 register-tile score loop: every score is one chain of
//     explicit fmaf over the depths in a fixed order (fma4), and
//     dot_fma runs the very same chain for one (row, column) pair, so a
//     target score computed alone equals, bit for bit, the score the
//     sweep computes for that column;
//   * the threshold filter into a per-row candidate buffer and the
//     merge-path merge of the candidates into the row's sorted list;
//   * the merge of a row's S split lists into its final top-k.
// sweep_split runs one block's share of a partial pass and calls a hook
// on every tile's scores before the filter: mips_topk passes none,
// eval_fused counts ranks and folds an online LSE there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace topk_tile {

constexpr float kNegInf = -1e30f;
constexpr float kPosInf = __builtin_huge_valf();  // a NaN score's rank
constexpr int kIdPad = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileC = 64;         // catalog rows per tile
constexpr int kColsPerThread = 4;  // columns tx + 16*j of the tile
constexpr int kMaxK = 512;
constexpr int kMaxD = 256;
constexpr int kSlotsSmall = 8;  // list entries a lane holds for k ≤ 256
constexpr int kSlotsLarge = kMaxK / 32;  // ... and for k ≤ 512
constexpr int kMaxSmem = 232448;   // 227 KB opt-in per block on sm_90
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// The merge key: a comes before b iff its value is larger, or equal with
// the lower id. No NaN reaches it: the sweep's filter enters a NaN score
// as +inf (see sweep_split).
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

// One step of a score's fold: four depths, four fmaf, in this order.
// Every score is this step applied from 0 over the depths 0 .. 4·d4 − 1,
// with zeros past d.
__device__ __forceinline__ float fma4(float4 a, float4 w, float s) {
  s = fmaf(a.x, w.x, s);
  s = fmaf(a.y, w.y, s);
  s = fmaf(a.z, w.z, s);
  s = fmaf(a.w, w.w, s);
  return s;
}

// a · b over d floats by the sweep's own fold (fma4 over zero-padded
// float4s, in order): bit for bit the score sweep_split computes for the
// same query row and catalog row.
__device__ __forceinline__ float dot_fma(const float* a, const float* b,
                                         int d) {
  float s = 0.f;
  for (int k = 0; k < d; k += 4) {
    float av[4], bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      av[u] = k + u < d ? a[k + u] : 0.f;
      bv[u] = k + u < d ? b[k + u] : 0.f;
    }
    s = fma4(make_float4(av[0], av[1], av[2], av[3]),
             make_float4(bv[0], bv[1], bv[2], bv[3]), s);
  }
  return s;
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
// warp-owned list: the pairs that beat the list's k-th entry are compacted
// into the warp's 32-slot buffer (bv, bi) and rank-merged. The next 32
// pairs are read before the current ones are merged, to hide their
// latency. Every lane calls.
template <int SLOTS>
__device__ void stream_merge(float* lv, int* li, int k, float* bv, int* bi,
                             const float* pv, const int* pi, long count,
                             int lane) {
  float tv = lv[k - 1];
  int ti = li[k - 1];
  float s = lane < count ? pv[lane] : kNegInf;
  int id = lane < count ? pi[lane] : kIdPad;
  for (long base = 0; base < count; base += 32) {
    const long e = base + 32 + lane;
    const float s_next = e < count ? pv[e] : kNegInf;
    const int id_next = e < count ? pi[e] : kIdPad;
    const bool cand = precedes(s, id, tv, ti);
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

// Shared-memory pitch of a staged row, in floats: d rounded up to float4s,
// an odd number of them, so the 8 lanes of a quarter-warp that read 8
// different rows at the same depth with one 16-byte load each hit 8
// different bank groups.
__host__ __device__ inline int row_pitch(int d) {
  const int d4 = (d + 3) / 4;
  return 4 * (d4 | 1);
}

// Shared memory of one partial block of 16·RM query rows: staged queries
// and two catalog tiles, the tiles' valid flags, per-row candidate
// counts, per-row candidate buffers and the per-row (value, id) lists.
template <int RM>
size_t partial_smem_bytes(int d, int k) {
  constexpr int QB = 16 * RM;
  const size_t p = row_pitch(d);
  return sizeof(float) * (QB * p + 2 * kTileC * p) +  // queries, 2 tiles
         sizeof(int) * (2 * kTileC + QB) +             // valid flags, counts
         (sizeof(float) + sizeof(int)) * QB * (kTileC + (size_t)k);
}

// Shared memory of one merge block: a list and a 32-slot buffer per warp.
inline size_t merge_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * kWarps * ((size_t)k + 32);
}

// Starts the cp.async copy of catalog rows [c0, c0 + nc) into a staged
// tile at pitch p: 16-byte copies when `vec` (d % 4 == 0, y aligned),
// else 4-byte ones. The depth padding [d, 4·d4) is never written.
__device__ __forceinline__ void copy_tile_async(float* dst, const float* y,
                                                long c0, int nc, int d,
                                                int d4, int p, int vec,
                                                int tid) {
  const float* src = y + c0 * d;
  if (vec) {
    for (int e = tid; e < nc * d4; e += kThreads) {
      const int r = e / d4;
      const int k4 = e - r * d4;
      cp_async16(dst + r * p + 4 * k4, src + (long)r * d + 4 * k4);
    }
  } else {
    for (int e = tid; e < nc * d; e += kThreads) {
      const int r = e / d;
      cp_async4(dst + r * p + (e - r * d), src + e);
    }
  }
}

// One block's share of a partial pass: the catalog rows of split
// blockIdx.y against the query rows of row block blockIdx.x.
struct Sweep {
  const float* q;               // (n_q, d) query rows
  const float* y;               // (c, d) catalog rows
  const unsigned char* valid;   // (c,) bool mask, or null
  float* part_vals;             // (n_q, S, k) split lists
  int* part_ids;
  int n_q, c, d, k, split_cols;
  int id_offset;                // global id of y's first row
  int c_lo, c_hi;               // global-id window [c_lo, c_hi)
  int vec;                      // 16-byte tile copies (d % 4 == 0, aligned)
};

// Column c0 + tid of a tile of nc columns: 1 if it is in the tile, its
// mask byte (if any) is set and its global id is in the window.
__device__ __forceinline__ int valid_flag(const Sweep& a, long c0, int nc,
                                          int tid) {
  if (tid >= nc) return 0;
  const long gid = (long)a.id_offset + c0 + tid;
  return (a.valid == nullptr || a.valid[c0 + tid] != 0) && gid >= a.c_lo &&
         gid < a.c_hi;
}

// The partial pass of one block (every thread calls). Stages its
// QB = 16·RM query rows once, streams its split in (64, d) tiles with
// cp.async into a double buffer, so the next tile's read overlaps this
// tile's arithmetic, and scores each tile in RM×4 register tiles from
// float4 shared-memory reads (thread (ty, tx) holds rows ty·RM + i and
// columns tx + 16·j). `on_tile(acc, flags, c0)` then sees the tile's
// scores, its 64 valid flags and its first column; its scores that beat
// their row's current k-th entry go to the row's candidate buffer, and
// one warp per row merges them into the row's sorted list. The block
// writes its lists as (n_q, S, k).
template <int RM, int SLOTS, class OnTile>
__device__ __forceinline__ void sweep_split(const Sweep& a, float4* smem4,
                                            OnTile&& on_tile) {
  constexpr int QB = 16 * RM;  // query rows per block
  constexpr int kRowsPerWarp = QB / kWarps;
  const int d = a.d;
  const int k = a.k;
  const int p = row_pitch(d);
  const int p4 = p / 4;
  const int d4 = (d + 3) / 4;
  float* qs = reinterpret_cast<float*>(smem4);            // (QB, p)
  float* ys = qs + QB * p;                                // 2 × (kTileC, p)
  int* vs = reinterpret_cast<int*>(ys + 2 * kTileC * p);  // 2 × (kTileC,)
  int* cnt = vs + 2 * kTileC;                             // (QB,)
  float* cv = reinterpret_cast<float*>(cnt + QB);         // (QB, kTileC)
  int* ci = reinterpret_cast<int*>(cv + QB * kTileC);     // (QB, kTileC)
  float* lv = reinterpret_cast<float*>(ci + QB * kTileC);  // (QB, k)
  int* li = reinterpret_cast<int*>(lv + QB * k);           // (QB, k)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = tid >> 4;  // rows ty*RM .. ty*RM + RM-1 of the block
  const int tx = tid & 15;  // columns tx + 16*j of the tile
  const int row0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const long col_begin = (long)split * a.split_cols;
  const long col_end = col_begin + a.split_cols < (long)a.c
                           ? col_begin + a.split_cols
                           : (long)a.c;
  const int n_tiles =
      col_end > col_begin ? (int)((col_end - col_begin + kTileC - 1) / kTileC)
                          : 0;

  // Queries, zero-padded to 4·d4 (rows past n_q are all zero), the tiles'
  // depth padding (never written by cp.async), the lists and the counts.
  for (int e = tid; e < QB * 4 * d4; e += kThreads) {
    const int r = e / (4 * d4);
    const int kk = e - r * 4 * d4;
    qs[r * p + kk] =
        row0 + r < a.n_q && kk < d ? a.q[(long)(row0 + r) * d + kk] : 0.f;
  }
  const int dpad = 4 * d4 - d;
  for (int e = tid; e < 2 * kTileC * dpad; e += kThreads) {
    const int r = e / dpad;
    ys[r * p + d + (e - r * dpad)] = 0.f;
  }
  for (int e = tid; e < QB * k; e += kThreads) {
    lv[e] = kNegInf;
    li[e] = kIdPad;
  }
  for (int e = tid; e < QB; e += kThreads) cnt[e] = 0;

  // Tile t covers columns [c0, c0 + nc) with c0 = col_begin + 64·t. Its
  // rows arrive by cp.async one tile ahead; its valid flags are computed
  // into a register one tile ahead and stored while the previous tile
  // merges, so neither read stalls the tile before it.
  auto tile_nc = [col_begin, col_end](int t) {
    const long c0 = col_begin + (long)t * kTileC;
    return col_end - c0 < kTileC ? (int)(col_end - c0) : kTileC;
  };
  if (n_tiles > 0) {
    copy_tile_async(ys, a.y, col_begin, tile_nc(0), d, d4, p, a.vec, tid);
    if (tid < kTileC) vs[tid] = valid_flag(a, col_begin, tile_nc(0), tid);
  }
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int b = t & 1;
    int v_next = 0;
    if (t + 1 < n_tiles) {
      const long c1 = col_begin + (long)(t + 1) * kTileC;
      copy_tile_async(ys + (b ^ 1) * kTileC * p, a.y, c1, tile_nc(t + 1), d,
                      d4, p, a.vec, tid);
      if (tid < kTileC) v_next = valid_flag(a, c1, tile_nc(t + 1), tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t and the last merge are visible to all

    float acc[RM][kColsPerThread];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;
    const float4* qa = reinterpret_cast<const float4*>(qs) + ty * RM * p4;
    const float4* yb =
        reinterpret_cast<const float4*>(ys + b * kTileC * p) + tx * p4;
#pragma unroll 2
    for (int k4 = 0; k4 < d4; ++k4) {
      float4 q4[RM];
      float4 w[kColsPerThread];
#pragma unroll
      for (int i = 0; i < RM; ++i) q4[i] = qa[i * p4 + k4];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) w[j] = yb[16 * j * p4 + k4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          acc[i][j] = fma4(q4[i], w[j], acc[i][j]);
    }

    const long c0 = col_begin + (long)t * kTileC;
    const int* flags = vs + b * kTileC;
    on_tile(acc, flags, c0);

    // Keep the scores that beat their row's current k-th entry. A NaN
    // score (a diverged model) enters as +inf: it ranks above every
    // number and NaNs among themselves by id, the order in which the plain
    // version's stable sort (torch.sort) and the reference's lax.top_k
    // rank NaN, so the same ids are selected; its value reads +inf.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      if (row0 + r >= a.n_q) continue;
      const float tv = lv[r * k + k - 1];
      const int ti = li[r * k + k - 1];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int cc = tx + 16 * j;
        const int id = a.id_offset + (int)(c0 + cc);
        const float v = acc[i][j] != acc[i][j] ? kPosInf : acc[i][j];
        if (flags[cc] && precedes(v, id, tv, ti)) {
          const int slot = atomicAdd(&cnt[r], 1);
          cv[r * kTileC + slot] = v;
          ci[r * kTileC + slot] = id;
        }
      }
    }
    __syncthreads();  // candidates complete; tile b is no longer read

    if (t + 1 < n_tiles && tid < kTileC) vs[(b ^ 1) * kTileC + tid] = v_next;
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int n = cnt[r];
      if (n == 0) continue;  // warp-uniform
      rank_merge<SLOTS>(lv + r * k, li + r * k, k, cv + r * kTileC,
                        ci + r * kTileC, n, lane);
      if (lane == 0) cnt[r] = 0;
    }
  }
  __syncthreads();

  const int n_split = gridDim.y;
  for (int e = tid; e < QB * k; e += kThreads) {
    const int r = e / k;
    const int j = e - r * k;
    if (row0 + r < a.n_q) {
      const long o = ((long)(row0 + r) * n_split + split) * k + j;
      a.part_vals[o] = lv[e];
      a.part_ids[o] = li[e];
    }
  }
}

// Merges the n_split sorted lists of row blockIdx.x (every thread
// calls): each of 8 warps merges a contiguous share of the row's
// n_split·k entries, then warp 0 merges the 8 warp lists and writes the
// row's top-k, with ID_PAD wherever the value is NEG_INF (an exhausted
// row's slots).
template <int SLOTS>
__device__ __forceinline__ void merge_split_lists(
    const float* __restrict__ part_vals, const int* __restrict__ part_ids,
    float* __restrict__ vals, int* __restrict__ ids, int n_split, int k,
    float4* smem4) {
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

  const long n = (long)n_split * k;
  const long lo = n * warp / kWarps;
  const long hi = n * (warp + 1) / kWarps;
  const float* pv = part_vals + (long)row * n + lo;
  const int* pi = part_ids + (long)row * n + lo;
  stream_merge<SLOTS>(lv, li, k, buf_v + warp * 32, buf_i + warp * 32, pv,
                      pi, hi - lo, lane);
  __syncthreads();

  if (warp == 0) {
    stream_merge<SLOTS>(lv, li, k, buf_v, buf_i, wl_v + k, wl_i + k,
                        (long)(kWarps - 1) * k, lane);
    for (int j = lane; j < k; j += 32) {
      vals[(long)row * k + j] = lv[j];
      ids[(long)row * k + j] = lv[j] == kNegInf ? kIdPad : li[j];
    }
  }
}

// Opts `kernel` in to the full kMaxSmem of dynamic shared memory, once per
// device (the attribute is per device context); `done` is the caller's
// per-kernel table.
template <class Kernel>
cudaError_t allow_max_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// Calls f(RM, SLOTS) with both as std::integral_constant: the block height
// rows_per_thread ∈ {1, 2, 4} and the list width (8 slots a lane for
// k ≤ 256, 16 above).
template <class F>
cudaError_t dispatch(int rows_per_thread, int k, F&& f) {
  using S8 = std::integral_constant<int, kSlotsSmall>;
  using S16 = std::integral_constant<int, kSlotsLarge>;
  auto by_rm = [&](auto slots) -> cudaError_t {
    switch (rows_per_thread) {
      case 1: return f(std::integral_constant<int, 1>{}, slots);
      case 2: return f(std::integral_constant<int, 2>{}, slots);
      case 4: return f(std::integral_constant<int, 4>{}, slots);
      default: return cudaErrorInvalidValue;
    }
  };
  return k <= 32 * kSlotsSmall ? by_rm(S8{}) : by_rm(S16{});
}

}  // namespace topk_tile
