// mips_topk — per-row top-k of q @ yᵀ, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mips_kernel` of
// src/repro/kernels/mips_topk.py (public `mips_topk`, merge
// `merge_topk_tile` of src/repro/kernels/topk_merge.py). It computes what
// that kernel computes, not its block structure:
//
//   vals, ids = top-k over columns c of (q @ yᵀ)[:, c], for c < C with
//   valid[c] != 0, keyed by (value descending, id ascending), with
//   ids = id_offset + c (int32). Slots left without a real score hold
//   (NEG_INF, ID_PAD). No backward: selection is non-differentiable.
//
// What bounds it on an H100. At the serve shapes (C = 173,520 catalog
// rows, d = 64, k = 10):
//   * bucket 512: 2·512·173,520·64 ≈ 11.4 GFLOP of f32 FMAs — above the
//     card's balance point, so the f32 (non-tensor-core) FMA rate bounds it;
//   * bucket 8: the catalog read, 173,520·64·4 B ≈ 44.4 MB, bounds it —
//     ≈ 178 MFLOP is nothing next to it.
// The scores stay f32 FMAs in a fixed order over d (no TF32, no tensor
// cores): the ids must equal the plain version's, and on integer-valued
// inputs every fold order is exact, so ties resolve bit for bit.
//
// Design. The TPU grid walks the catalog axis sequentially with the merge
// buffer in VMEM; ported as is, bucket 8 would run one block on one of
// 132 SMs. Here the catalog is split instead:
//   1. mips_topk_partial_kernel, grid (ceil(n_q / QB), S): S splits the
//      catalog (the wrapper's plan, measured on the card). Each block
//      stages its QB query rows in shared memory once and streams its
//      split in (64, d) catalog tiles with cp.async into a double buffer,
//      so the next tile's read overlaps this tile's arithmetic (the bytes
//      side: bucket 8). Every thread computes an RM×4 register tile of scores
//      from float4 shared-memory reads — 16·RM FMAs per 4+RM loads (the
//      FLOP side: bucket 512). It then compares its own scores with its
//      rows' current k-th entries; only the few that beat them go to a
//      per-row candidate buffer, and a warp merges those into the row's
//      sorted top-k list by rank (each element's new position is the
//      number of elements that precede it). The block writes its lists
//      as (n_q, S, k) candidates.
//   2. mips_topk_merge_kernel, one block per row: each of 8 warps merges a
//      share of the row's S sorted lists the same way, then warp 0 merges
//      the 8 warp lists and writes ID_PAD wherever the value is NEG_INF
//      (the exhausted-row rule of topk_merge.py).
// Candidate buffers fill in any order, but a rank under a strict total
// order does not depend on it, and there are no global atomics: the result
// is deterministic. k ≤ 512, d ≤ 256.
//
// The per-row lists live in shared memory; each lane of a merging warp
// holds SLOTS of a list's entries in registers while it ranks them: 8 for
// k ≤ 256 (serving's k = 10, SCE training's catalog selection b_y = 256),
// 16 for k ≤ 512 (the position selection, b_x = 320 at the paper's
// shape). The merge is by merge path: it first puts the ≤ 64 candidates
// in key order, then places each element by a binary search of the other
// side, O(log k + log n) per element, where ranking it by a scan of the
// other side costs O(k + n): a 320-entry list once per candidate.
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes in src/repro_torch/kernels/mips_topk.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
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
constexpr unsigned kFull = 0xffffffffu;

// The merge key: a comes before b iff its value is larger, or equal with
// the lower id.
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

template <int RM>
size_t partial_smem_bytes(int d, int k) {
  constexpr int QB = 16 * RM;
  const size_t p = row_pitch(d);
  return sizeof(float) * (QB * p + 2 * kTileC * p) +  // queries, 2 tiles
         sizeof(int) * (2 * kTileC + QB) +             // valid flags, counts
         (sizeof(float) + sizeof(int)) * QB * (kTileC + (size_t)k);
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

// Thread tid's valid flag for column c0 + tid of a tile of nc columns.
__device__ __forceinline__ int valid_flag(const unsigned char* valid, long c0,
                                          int nc, int tid) {
  return tid < nc && (valid == nullptr || valid[c0 + tid] != 0);
}

template <int RM, int SLOTS>
__global__ void __launch_bounds__(kThreads)
mips_topk_partial_kernel(const float* __restrict__ q,
                         const float* __restrict__ y,
                         const unsigned char* __restrict__ valid,
                         float* __restrict__ part_vals,
                         int* __restrict__ part_ids, int n_q, int c, int d,
                         int k, int split_cols, int id_offset, int vec) {
  constexpr int QB = 16 * RM;  // query rows per block
  constexpr int kRowsPerWarp = QB / kWarps;
  extern __shared__ float4 smem4[];
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
  const long col_begin = (long)split * split_cols;
  const long col_end =
      col_begin + split_cols < (long)c ? col_begin + split_cols : (long)c;
  const int n_tiles =
      col_end > col_begin ? (int)((col_end - col_begin + kTileC - 1) / kTileC)
                          : 0;

  // Queries, zero-padded to 4·d4 (rows past n_q are all zero), the tiles'
  // depth padding (never written by cp.async), the lists and the counts.
  for (int e = tid; e < QB * 4 * d4; e += kThreads) {
    const int r = e / (4 * d4);
    const int kk = e - r * 4 * d4;
    qs[r * p + kk] =
        row0 + r < n_q && kk < d ? q[(long)(row0 + r) * d + kk] : 0.f;
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
  // rows arrive by cp.async one tile ahead; its valid flags are read into
  // a register one tile ahead and stored while the previous tile merges,
  // so neither read stalls the tile before it.
  auto tile_nc = [col_begin, col_end](int t) {
    const long c0 = col_begin + (long)t * kTileC;
    return col_end - c0 < kTileC ? (int)(col_end - c0) : kTileC;
  };
  if (n_tiles > 0) {
    copy_tile_async(ys, y, col_begin, tile_nc(0), d, d4, p, vec, tid);
    if (tid < kTileC) vs[tid] = valid_flag(valid, col_begin, tile_nc(0), tid);
  }
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int b = t & 1;
    int v_next = 0;
    if (t + 1 < n_tiles) {
      const long c1 = col_begin + (long)(t + 1) * kTileC;
      copy_tile_async(ys + (b ^ 1) * kTileC * p, y, c1, tile_nc(t + 1), d,
                      d4, p, vec, tid);
      if (tid < kTileC) v_next = valid_flag(valid, c1, tile_nc(t + 1), tid);
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
      float4 a[RM];
      float4 w[kColsPerThread];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qa[i * p4 + k4];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) w[j] = yb[16 * j * p4 + k4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          float s = acc[i][j];
          s = fmaf(a[i].x, w[j].x, s);
          s = fmaf(a[i].y, w[j].y, s);
          s = fmaf(a[i].z, w[j].z, s);
          s = fmaf(a[i].w, w[j].w, s);
          acc[i][j] = s;
        }
    }

    // Keep the scores that beat their row's current k-th entry.
    const long c0 = col_begin + (long)t * kTileC;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      if (row0 + r >= n_q) continue;
      const float tv = lv[r * k + k - 1];
      const int ti = li[r * k + k - 1];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int cc = tx + 16 * j;
        const int id = id_offset + (int)(c0 + cc);
        if (vs[b * kTileC + cc] && precedes(acc[i][j], id, tv, ti)) {
          const int slot = atomicAdd(&cnt[r], 1);
          cv[r * kTileC + slot] = acc[i][j];
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
    if (row0 + r < n_q) {
      const long o = ((long)(row0 + r) * n_split + split) * k + j;
      part_vals[o] = lv[e];
      part_ids[o] = li[e];
    }
  }
}

template <int SLOTS>
__global__ void __launch_bounds__(kThreads)
mips_topk_merge_kernel(const float* __restrict__ part_vals,
                       const int* __restrict__ part_ids,
                       float* __restrict__ vals, int* __restrict__ ids,
                       int n_split, int k) {
  extern __shared__ float4 smem4[];
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

  // Warp w takes a contiguous share of the row's n_split·k candidates.
  const long n = (long)n_split * k;
  const long lo = n * warp / kWarps;
  const long hi = n * (warp + 1) / kWarps;
  const float* pv = part_vals + (long)row * n + lo;
  const int* pi = part_ids + (long)row * n + lo;
  stream_merge<SLOTS>(lv, li, k, buf_v + warp * 32,
                              buf_i + warp * 32, pv, pi, hi - lo, lane);
  __syncthreads();

  if (warp == 0) {
    stream_merge<SLOTS>(lv, li, k, buf_v, buf_i, wl_v + k,
                                wl_i + k, (long)(kWarps - 1) * k, lane);
    for (int j = lane; j < k; j += 32) {
      vals[(long)row * k + j] = lv[j];
      ids[(long)row * k + j] = lv[j] == kNegInf ? kIdPad : li[j];
    }
  }
}

constexpr int kMaxDevices = 64;

// Opts mips_topk_partial_kernel<RM, SLOTS> in to the full
// kMaxSmem of dynamic shared memory, once per device (the attribute is
// per device context).
template <int RM, int SLOTS>
cudaError_t allow_max_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(mips_topk_partial_kernel<RM, SLOTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int RM, int SLOTS>
cudaError_t launch_partial(const float* q, const float* y,
                           const unsigned char* valid, float* part_vals,
                           int* part_ids, int n_q, int c, int d, int k,
                           int n_split, int split_cols, int id_offset,
                           cudaStream_t stream) {
  const size_t smem = partial_smem_bytes<RM>(d, k);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_max_smem<RM, SLOTS>();
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((n_q + 16 * RM - 1) / (16 * RM), n_split);
  mips_topk_partial_kernel<RM, SLOTS>
      <<<grid, kThreads, smem, stream>>>(
      q, y, valid, part_vals, part_ids, n_q, c, d, k, split_cols, id_offset,
      vec);
  return cudaGetLastError();
}

// The partial pass at the block height rows_per_thread, then the merge,
// both at list width SLOTS.
template <int SLOTS>
cudaError_t launch_pair(const float* q, const float* y,
                        const unsigned char* valid, float* part_vals,
                        int* part_ids, float* vals, int* ids, int n_q, int c,
                        int d, int k, int rows_per_thread, int n_split,
                        int split_cols, int id_offset, cudaStream_t s) {
  cudaError_t err;
  switch (rows_per_thread) {
    case 1:
      err = launch_partial<1, SLOTS>(
          q, y, valid, part_vals, part_ids, n_q, c, d, k, n_split,
          split_cols, id_offset, s);
      break;
    case 2:
      err = launch_partial<2, SLOTS>(
          q, y, valid, part_vals, part_ids, n_q, c, d, k, n_split,
          split_cols, id_offset, s);
      break;
    case 4:
      err = launch_partial<4, SLOTS>(
          q, y, valid, part_vals, part_ids, n_q, c, d, k, n_split,
          split_cols, id_offset, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const size_t merge_smem =
      (sizeof(float) + sizeof(int)) * kWarps * ((size_t)k + 32);
  mips_topk_merge_kernel<SLOTS><<<n_q, kThreads, merge_smem, s>>>(
      part_vals, part_ids, vals, ids, n_split, k);
  return cudaGetLastError();
}

}  // namespace

// Launches the partial pass then the merge on `stream`. part_vals /
// part_ids are (n_q, n_split, k) scratch, vals / ids the (n_q, k)
// outputs; valid is a (C,) bool mask (one byte per row) or null.
// Returns the cudaError_t of the launches (0 on success), and
// cudaErrorInvalidValue when a partial block would need more than
// kMaxSmem (the wrapper's plan keeps it under). Nothing is synchronised
// and nothing is allocated.
extern "C" int mips_topk_launch(const float* q, const float* y,
                                const unsigned char* valid, float* part_vals,
                                int* part_ids, float* vals, int* ids, int n_q,
                                int c, int d, int k, int rows_per_thread,
                                int n_split, int split_cols, int id_offset,
                                void* stream) {
  if (n_q <= 0 || c <= 0 || d <= 0 || d > kMaxD || k <= 0 || k > kMaxK ||
      k > c || n_split <= 0 || split_cols <= 0 || split_cols % kTileC != 0 ||
      (long)n_split * split_cols < (long)c)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      k <= 32 * kSlotsSmall
          ? launch_pair<kSlotsSmall>(q, y, valid, part_vals, part_ids, vals,
                                     ids, n_q, c, d, k, rows_per_thread,
                                     n_split, split_cols, id_offset, s)
          : launch_pair<kSlotsLarge>(q, y, valid, part_vals, part_ids, vals,
                                     ids, n_q, c, d, k, rows_per_thread,
                                     n_split, split_cols, id_offset, s);
  return (int)err;
}
