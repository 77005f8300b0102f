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
//   * bucket 512: 2·512·173,520·64 ≈ 11.4 GFLOP; in 3xTF32 three TF32
//     passes at 495 TFLOP/s, 0.069 ms (as f32 FMAs at 67 TFLOP/s 0.170);
//   * bucket 8: the catalog read, 173,520·64·4 B ≈ 44.4 MB at 3.35 TB/s,
//     0.013 ms — ≈ 178 MFLOP is nothing next to it.
// SCE training's selections (320 bucket centres, k = 320 over 25,600
// positions and k = 256 over the catalog) are FMA-bound as well.
//
// Design for k ≤ 32 (serving): the tensor-core sweep of topk_tile.cuh.
//   1. τ, one int per row: sample_kernel over one tile in 8 of the
//      catalog (strided) keeps each lane's best column, tau_select_kernel
//      takes the k-th of that union per row (the plan's pre-pass; on a
//      catalog under 128 tiles, a memset to "no threshold" instead).
//   2. mips_sweep_kernel, grid (ceil(n_q / QB), S): QB = 8, 32 or 128
//      query rows a block (the wrapper's plan), S balanced catalog splits.
//      Scores in 3xTF32 on `mma.sync` (catalog rows as A, queries as B,
//      so bucket 8 multiplies no zero rows); every valid score at or
//      above its row's threshold — τ, or the block's own list's k-th
//      value if higher — goes to a per-row buffer, merged into the row's
//      sorted list by a warp only when the next tile could overflow it or
//      at the end; each merge raises τ to the list's k-th value
//      (atomicMax). A block writes its lists as (n_q, S, k).
//   3. mips_topk_merge_kernel, one block per row: the threads gather the
//      row's list entries at or above its final τ, warp 0 rank-merges
//      them and writes ID_PAD wherever the value is NEG_INF (the
//      exhausted-row rule of topk_merge.py).
// The partial lists depend on when each block reads τ; the result does
// not: a column below τ has k real columns ahead of it, one at τ is kept,
// and the merges rank by the strict key. Integer-valued inputs below
// 2¹¹ are their own TF32 `hi` (lo = 0) and sum exactly, so ties resolve
// bit for bit there.
//
// Design for k > 32 (training). A block of the pair above keeps a QB × k
// list in shared memory, so at k = 320 it holds 16 rows — 5 float4 reads
// per 16 FMAs, bound by shared-memory reads — and each of its S splits
// fills its own k-list from NEG_INF: more than half of a row's valid
// columns go through the merge. Instead, find a safe per-row threshold
// cheaply, collect only what can pass it, and sort that:
//   1. Threshold pass (mips_topk_pass_kernel<false>), 64 rows a block:
//      split s visits catalog tiles s, s + P, s + 2P, … (P = S·R: a 1/R
//      sample of the tiles, strided so that a catalog whose best columns
//      sit in low ids does not put a row's best into one split). Each
//      thread keeps, in a register, the best of the columns it scores
//      for each of its rows: 16 column lanes × S splits entries per row,
//      the union of the bests of disjoint column sets. (Keeping two
//      per thread tightened τ but doubled the union's sort: slower.)
//   2. mips_topk_tau_kernel, one block per row: sorts the union and takes
//      its k-th entry τ. Any k real columns make the k-th of them a safe
//      threshold: at least k columns precede or equal it, so no column
//      after it is in the top k. A union with fewer than k real entries
//      yields a pad, (NEG_INF, ID_PAD): every valid column passes.
//   3. Collect pass (mips_topk_pass_kernel<true>): the same score loop in
//      the same fma4 fold (so a column's score equals its threshold-pass
//      score bit for bit), no lists; every valid column whose key
//      precedes or equals its row's τ is appended to the row's buffer of
//      kcap entries through a global atomicAdd on the row's count.
//   4. mips_topk_select_kernel, one block per row: a bitonic sort of the
//      row's collected entries under the key, the first k written with
//      ID_PAD wherever the value is NEG_INF. The sort makes the result
//      independent of the append order.
//   5. A row that collected more than kcap entries (adversarial input: the
//      whole top of a row in unsampled tiles) is finished exactly by the
//      f32 FMA split sweep below (sweep_split) and its merge at 16 rows a
//      block, launched unconditionally: its blocks and merge rows whose
//      rows all fit return at once, so there is no host synchronisation
//      inside a call.
// No step truncates. Append order varies between runs, a rank under the
// strict total key does not: every output is deterministic. k ≤ 512,
// d ≤ 256. The chain scores in f32 FMAs, fma4 below, in a fixed order
// over d.
//
// Deep variants (mips_topk_deep_launch, mips_topk_select_deep_launch),
// for d > 256 and, in the chain, 512 < k ≤ 1024, where the kernels above
// cannot stage their queries and tiles (d) or their 16-row lists (k):
// deep_tc.cuh's product first writes the score slab S = Y · Qᵀ (c, n_q)
// — f32 operands in 3xTF32 on `wgmma`, walking the depth in chunks of 32;
// bf16 operands on gemm_bf16, bf16 `wgmma` from TMA stages — and the same
// sweep, passes and finishing sweep then read each tile's scores from S
// (FROM_S) in place of their products: the thresholds, filters, sorts
// and merges are unchanged. The wrapper cuts the queries into slabs that
// keep S within a fixed budget. At gemma-2's selection (128 bucket
// centres against a 256,000-row vocabulary, d 2304, k 1024) S is 131 MB,
// 0.08 ms of traffic against 151 GFLOP of products.
//
// bfloat16 operands (the entries' `bf16_in`): in the resident kernels q
// and y are read as stored and widened to f32 as they are staged (the
// sweep's tiles and the queries' split, the chain's tiles and queries).
// A bf16 value is exact in f32 and in TF32 and the product of two is
// exact in f32, so the FMA fold and the 3xTF32 steps give the f32
// launch's outputs on the widened inputs bit for bit. The deep variants
// score on the bf16 product (the depth summed in the tensor cores): other
// bits than the f32 launch, within f32 rounding of f64, repeating bit
// for bit.
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes in src/repro_torch/kernels/mips_topk.py.

#include "deep_tc.cuh"
#include "topk_tile.cuh"

namespace {

using namespace topk_tile;
using tf32x3::bf16;
using tf32x3::by_dtype;

// ---------------------------------------------------------------------------
// k ≤ 32: the tensor-core sweep and its merge
// ---------------------------------------------------------------------------
template <int NQT, int SLOTS, bool FROM_S, typename T>
__global__ void __launch_bounds__(Cfg<NQT>::kThreads,
                                  sweep_min_blocks<NQT, FROM_S>())
mips_sweep_kernel(const __grid_constant__ Sweep a) {
  extern __shared__ float4 smem4[];
  sweep<NQT, SLOTS, false, FROM_S, T>(a, smem4,
                                      [](const auto&, const int*, long) {});
}

template <int SLOTS>
__global__ void __launch_bounds__(kThreads)
mips_topk_merge_kernel(const float* __restrict__ part_vals,
                       const int* __restrict__ part_ids,
                       float* __restrict__ vals, int* __restrict__ ids,
                       int n_split, int k, const int* __restrict__ tau) {
  extern __shared__ float4 smem4[];
  merge_row_lists<SLOTS>(part_vals, part_ids, vals, ids, n_split, k, tau,
                         smem4);
}

// τ seeded (the pre-pass when pre_split > 0), the sweep, the merge.
template <int NQT, int SLOTS, bool FROM_S, typename T>
cudaError_t launch_sweep(const Sweep& a_in, float* uv, float* vals, int* ids,
                         int n_split, int pre_split, int pre_period,
                         cudaStream_t s) {
  using C = Cfg<NQT>;
  static bool done[kMaxDevices] = {}, done_pre[kMaxDevices] = {};
  const size_t smem = sweep_smem_bytes<NQT, FROM_S>(a_in.d, a_in.k);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  Sweep a = a_in;
  if constexpr (FROM_S) {
    if (!slab_map<NQT>(a)) return cudaErrorInvalidValue;
  }
  cudaError_t err =
      allow_max_smem(mips_sweep_kernel<NQT, SLOTS, FROM_S, T>, done);
  if (err != cudaSuccess) return err;
  err = seed_tau<NQT, FROM_S, T>(a, uv, pre_split, pre_period, done_pre, s);
  if (err != cudaSuccess) return err;
  mips_sweep_kernel<NQT, SLOTS, FROM_S, T>
      <<<dim3((a.n_q + C::kQB - 1) / C::kQB, n_split), C::kThreads, smem,
         s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mips_topk_merge_kernel<SLOTS>
      <<<a.n_q, kThreads, sweep_merge_smem_bytes(a.k), s>>>(
          a.part_vals, a.part_ids, vals, ids, n_split, a.k, a.tau);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 FMA tile code of the k > 32 chain: the fold of its passes and
// the split sweep that finishes a row whose collect overflowed.
// ---------------------------------------------------------------------------
constexpr int kTileC = 64;         // catalog rows per tile
constexpr int kColsPerThread = 4;  // columns tx + 16*j of the tile

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

// Shared-memory pitch of a staged row, in floats: d rounded up to float4s,
// an odd number of them, so the 8 lanes of a quarter-warp that read 8
// different rows at the same depth with one 16-byte load each hit 8
// different bank groups.
__host__ __device__ inline int row_pitch(int d) {
  const int d4 = (d + 3) / 4;
  return 4 * (d4 | 1);
}

// Shared memory of one partial block of 16·RM query rows: staged queries
// and two catalog tiles (not FROM_S), the tiles' valid flags, per-row
// candidate counts, per-row candidate buffers and the per-row (value, id)
// lists.
template <int RM>
size_t partial_smem_bytes(int d, int k, bool from_s = false) {
  constexpr int QB = 16 * RM;
  const size_t p = from_s ? 0 : row_pitch(d);
  return sizeof(float) * (QB * p + 2 * kTileC * p) +  // queries, 2 tiles
         sizeof(int) * (2 * kTileC + QB) +             // valid flags, counts
         (sizeof(float) + sizeof(int)) * QB * (kTileC + (size_t)k);
}

// Starts the copy of catalog rows [c0, c0 + nc) into a staged f32 tile at
// pitch p: f32 by cp.async, 16-byte copies when `vec` (d % 4 == 0, y
// aligned), else 4-byte ones; bf16 through registers, widened as stored
// (8-byte loads when `vec`), visible after the same barrier. The depth
// padding [d, 4·d4) is never written.
template <typename T>
__device__ __forceinline__ void copy_tile_async(float* dst, const T* y,
                                                long c0, int nc, int d,
                                                int d4, int p, int vec,
                                                int tid) {
  const T* src = y + c0 * d;
  if (vec) {
    for (int e = tid; e < nc * d4; e += kThreads) {
      const int r = e / d4;
      const int k4 = e - r * d4;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<float4*>(dst + r * p + 4 * k4) =
            tf32x3::load4(src + (long)r * d + 4 * k4);
      else
        cp_async16(dst + r * p + 4 * k4, src + (long)r * d + 4 * k4);
    }
  } else {
    for (int e = tid; e < nc * d; e += kThreads) {
      const int r = e / d;
      if constexpr (sizeof(T) == 2)
        dst[r * p + (e - r * d)] = tf32x3::widen(src[e]);
      else
        cp_async4(dst + r * p + (e - r * d), src + e);
    }
  }
}

// One block's share of a partial pass: the catalog rows of split
// blockIdx.y against the query rows of row block blockIdx.x.
struct FmaSweep {
  const void* q;                // (n_q, d) query rows, f32 or bf16 (T)
  const void* y;                // (c, d) catalog rows, as q
  const unsigned char* valid;   // (c,) bool mask, or null
  float* part_vals;             // (n_q, S, k) split lists
  int* part_ids;
  int n_q, c, d, k, split_cols;
  int id_offset;                // global id of y's first row
  int c_lo, c_hi;               // global-id window [c_lo, c_hi)
  int vec;                      // 16-byte tile copies (d % 4 == 0, aligned)
  const float* s;               // FROM_S: the scores (c, n_q), row-major
};

// Column c0 + tid of a tile of nc columns: 1 if it is in the tile, its
// mask byte (if any) is set and its global id is in the window.
__device__ __forceinline__ int valid_flag(const FmaSweep& a, long c0, int nc,
                                          int tid) {
  if (tid >= nc) return 0;
  const long gid = (long)a.id_offset + c0 + tid;
  return (a.valid == nullptr || a.valid[c0 + tid] != 0) && gid >= a.c_lo &&
         gid < a.c_hi;
}

// FROM_S: the RM × 4 scores of rows r0 .. r0 + RM − 1 and columns
// c0, c0 + 16, … from the slab S (c, n_q), 0 outside it (the callers'
// flags and row checks mask those).
template <int RM>
__device__ __forceinline__ void from_slab(float (&acc)[RM][kColsPerThread],
                                          const float* s, int n_q, int c,
                                          int r0, long c0) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const long col = c0 + 16 * j;
      acc[i][j] = r0 + i < n_q && col < c ? s[col * n_q + r0 + i] : 0.f;
    }
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
template <int RM, int SLOTS, bool FROM_S = false, typename T = float,
          class OnTile>
__device__ __forceinline__ void sweep_split(const FmaSweep& a, float4* smem4,
                                            OnTile&& on_tile) {
  constexpr int QB = 16 * RM;  // query rows per block
  constexpr int kRowsPerWarp = QB / kWarps;
  const int d = a.d;
  const int k = a.k;
  const int p = FROM_S ? 0 : row_pitch(d);
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
  for (int e = tid; e < (FROM_S ? 0 : QB * 4 * d4); e += kThreads) {
    const int r = e / (4 * d4);
    const int kk = e - r * 4 * d4;
    qs[r * p + kk] =
        row0 + r < a.n_q && kk < d
            ? tf32x3::widen(static_cast<const T*>(a.q)[(long)(row0 + r) * d + kk])
            : 0.f;
  }
  const int dpad = 4 * d4 - d;
  for (int e = tid; e < (FROM_S ? 0 : 2 * kTileC * dpad); e += kThreads) {
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
    if (!FROM_S)
      copy_tile_async(ys, static_cast<const T*>(a.y), col_begin, tile_nc(0),
                      d, d4, p, a.vec, tid);
    if (tid < kTileC) vs[tid] = valid_flag(a, col_begin, tile_nc(0), tid);
  }
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int b = t & 1;
    int v_next = 0;
    if (t + 1 < n_tiles) {
      const long c1 = col_begin + (long)(t + 1) * kTileC;
      if (!FROM_S)
        copy_tile_async(ys + (b ^ 1) * kTileC * p, static_cast<const T*>(a.y),
                        c1, tile_nc(t + 1), d, d4, p, a.vec, tid);
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
    const long c0 = col_begin + (long)t * kTileC;
    if constexpr (FROM_S) {
      from_slab<RM>(acc, a.s, a.n_q, a.c, row0 + ty * RM, c0 + tx);
    } else {
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
    }

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

// ---------------------------------------------------------------------------
// k > 32: threshold, collect, select
// ---------------------------------------------------------------------------
constexpr int kPassRM = 4;               // rows per thread of a pass block
constexpr int kPassQB = 16 * kPassRM;    // 64 query rows per pass block
constexpr int kUnionPerSplit = 16;      // union entries per row and split
constexpr int kMaxSort = 8192;           // entries a row sort may hold

// The smallest power of two ≥ n (n ≥ 1).
__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Shared memory of one pass block: staged queries, two catalog tiles (not
// FROM_S) and their valid flags.
inline size_t pass_smem_bytes(int d, bool from_s = false) {
  const size_t p = from_s ? 0 : row_pitch(d);
  return sizeof(float) * (kPassQB + 2 * kTileC) * p +
         sizeof(int) * 2 * kTileC;
}

// One pass over the catalog for 64 query rows (block x) and one split
// (block y), which visits tiles y, y + period, y + 2·period, ….
struct Pass {
  const void* q;                // (n_q, d), f32 or bf16 (T)
  const void* y;                // (c, d), as q
  const unsigned char* valid;   // (c,) or null
  int n_q, c, d, id_offset, period, vec;
  float* uv;                    // threshold pass: (n_q, S, 16) union
  int* ui;
  const float* tau_v;           // collect pass: (n_q,) thresholds
  const int* tau_i;
  int* count;                   // (n_q,) entries collected
  float* bv;                    // (n_q, kcap) collected entries
  int* bi;
  int kcap;
  const float* s;               // FROM_S: the scores (c, n_q), row-major
};

// The threshold pass (COLLECT false) and the collect pass (COLLECT true):
// sweep_split's loader and score loop (the same fma4 fold, the same
// NaN → +inf rule) at 64 rows a block, with register state in place of
// the lists: the threshold pass keeps each thread's best per row, the
// collect pass appends every column that precedes or equals τ.
template <bool COLLECT, bool FROM_S, typename T>
__global__ void __launch_bounds__(kThreads, 2) mips_topk_pass_kernel(Pass a) {
  constexpr int RM = kPassRM;
  constexpr int QB = kPassQB;
  extern __shared__ float4 smem4[];
  const int d = a.d;
  const int p = FROM_S ? 0 : row_pitch(d);
  const int p4 = p / 4;
  const int d4 = (d + 3) / 4;
  float* qs = reinterpret_cast<float*>(smem4);            // (QB, p)
  float* ys = qs + QB * p;                                // 2 × (kTileC, p)
  int* vs = reinterpret_cast<int*>(ys + 2 * kTileC * p);  // 2 × (kTileC,)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*RM .. ty*RM + RM-1 of the block
  const int tx = tid & 15;  // columns tx + 16*j of the tile
  const int row0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int tiles = (a.c + kTileC - 1) / kTileC;
  const int n_tiles =
      split < tiles ? (tiles - 1 - split) / a.period + 1 : 0;

  for (int e = tid; e < (FROM_S ? 0 : QB * 4 * d4); e += kThreads) {
    const int r = e / (4 * d4);
    const int kk = e - r * 4 * d4;
    qs[r * p + kk] =
        row0 + r < a.n_q && kk < d
            ? tf32x3::widen(static_cast<const T*>(a.q)[(long)(row0 + r) * d + kk])
            : 0.f;
  }
  const int dpad = 4 * d4 - d;
  for (int e = tid; e < (FROM_S ? 0 : 2 * kTileC * dpad); e += kThreads) {
    const int r = e / dpad;
    ys[r * p + d + (e - r * dpad)] = 0.f;
  }

  // Threshold pass: this thread's best column, per row. Collect pass:
  // the rows' thresholds.
  float kv[RM];
  int ki[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + ty * RM + i;
    kv[i] = kNegInf;
    ki[i] = kIdPad;
    if (COLLECT && row < a.n_q) {
      kv[i] = a.tau_v[row];
      ki[i] = a.tau_i[row];
    }
  }

  auto tile_c0 = [&](int t) {
    return (long)(split + (long)t * a.period) * kTileC;
  };
  auto tile_nc = [&](long c0) {
    return a.c - c0 < kTileC ? (int)(a.c - c0) : kTileC;
  };
  auto flag = [&](long c0, int nc) {
    return (int)(tid < nc && (a.valid == nullptr || a.valid[c0 + tid] != 0));
  };
  if (n_tiles > 0) {
    const long c0 = tile_c0(0);
    if (!FROM_S)
      copy_tile_async(ys, static_cast<const T*>(a.y), c0, tile_nc(c0), d, d4,
                      p, a.vec, tid);
    if (tid < kTileC) vs[tid] = flag(c0, tile_nc(c0));
  }
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int b = t & 1;
    int v_next = 0;
    if (t + 1 < n_tiles) {
      const long c1 = tile_c0(t + 1);
      if (!FROM_S)
        copy_tile_async(ys + (b ^ 1) * kTileC * p, static_cast<const T*>(a.y),
                        c1, tile_nc(c1), d, d4, p, a.vec, tid);
      if (tid < kTileC) v_next = flag(c1, tile_nc(c1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is visible to all

    float acc[RM][kColsPerThread];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;
    const long c0 = tile_c0(t);
    if constexpr (FROM_S) {
      from_slab<RM>(acc, a.s, a.n_q, a.c, row0 + ty * RM, c0 + tx);
    } else {
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
    }

    int f[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) f[j] = vs[b * kTileC + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = row0 + ty * RM + i;
      if (row >= a.n_q) continue;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        if (!f[j]) continue;
        const int id = a.id_offset + (int)(c0 + tx + 16 * j);
        const float v = acc[i][j] != acc[i][j] ? kPosInf : acc[i][j];
        if (COLLECT) {
          if (!precedes(kv[i], ki[i], v, id)) {  // (v, id) ⪯ τ
            const int slot = atomicAdd(a.count + row, 1);
            if (slot < a.kcap) {
              a.bv[(long)row * a.kcap + slot] = v;
              a.bi[(long)row * a.kcap + slot] = id;
            }
          }
        } else if (precedes(v, id, kv[i], ki[i])) {
          kv[i] = v;
          ki[i] = id;
        }
      }
    }
    __syncthreads();  // tile b and its flags are no longer read
    if (t + 1 < n_tiles && tid < kTileC) vs[(b ^ 1) * kTileC + tid] = v_next;
  }

  if (!COLLECT) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = row0 + ty * RM + i;
      if (row >= a.n_q) continue;
      const long o = ((long)row * gridDim.y + split) * kUnionPerSplit + tx;
      a.uv[o] = kv[i];
      a.ui[o] = ki[i];
    }
  }
}

// A row's sort holds sort_size(n) ≥ n entries: a power of two, at least
// one per thread. Entry e lives at sort_pos(e) = e + e/32 in shared
// memory, so the 32 lanes that read entry lane·E + r at once hit 32
// banks.
__host__ __device__ inline int sort_size(int n) {
  const int p = pow2_at_least(n);
  return p > kThreads ? p : kThreads;
}
__host__ __device__ inline int sort_pos(int e) { return e + (e >> 5); }
__host__ __device__ inline size_t sort_smem_bytes(int n) {
  return (sizeof(float) + sizeof(int)) * (size_t)sort_pos(sort_size(n));
}

// Sorts the N = kThreads·E entries of (sv, si) into key order (value
// descending, id ascending); every thread calls. A bitonic network with
// each thread's E consecutive entries in registers: the strides below E
// run in registers, those below 32·E by warp shuffles, and only the
// strides that cross warps go through shared memory. Equal keys are only
// pads, which may swap freely.
template <int E>
__device__ void block_sort(float* sv, int* si) {
  constexpr int N = kThreads * E;
  const int base = threadIdx.x * E;
  float v[E];
  int id[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    v[r] = sv[sort_pos(base + r)];
    id[r] = si[sort_pos(base + r)];
  }
  for (int size = 2; size <= N; size <<= 1) {
    int stride = size >> 1;
    if (stride >= 32 * E) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        sv[sort_pos(base + r)] = v[r];
        si[sort_pos(base + r)] = id[r];
      }
      __syncthreads();
      for (; stride >= 32 * E; stride >>= 1) {
        for (int e = threadIdx.x; e < N / 2; e += kThreads) {
          const int l = 2 * e - (e & (stride - 1));  // pair (l, l + stride)
          const int lo = sort_pos(l);
          const int hi = sort_pos(l + stride);
          const bool up = (l & size) == 0;
          const float va = sv[lo], vb = sv[hi];
          const int ia = si[lo], ib = si[hi];
          if (precedes(vb, ib, va, ia) == up) {  // up: lo must precede hi
            sv[lo] = vb;
            sv[hi] = va;
            si[lo] = ib;
            si[hi] = ia;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < E; ++r) {
        v[r] = sv[sort_pos(base + r)];
        id[r] = si[sort_pos(base + r)];
      }
    }
    for (; stride >= E; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const float b = __shfl_xor_sync(kFull, v[r], stride / E);
        const int bi = __shfl_xor_sync(kFull, id[r], stride / E);
        const bool up = ((base + r) & size) == 0;
        const bool lo = ((base + r) & stride) == 0;
        // The lower entry of a pair takes the first of the two when up.
        if (precedes(b, bi, v[r], id[r]) == (lo == up)) {
          v[r] = b;
          id[r] = bi;
        }
      }
    }
#pragma unroll
    for (int st = E / 2; st > 0; st >>= 1) {
      if (2 * st > size) continue;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if (r & st) continue;
        const bool up = ((base + r) & size) == 0;
        if (precedes(v[r | st], id[r | st], v[r], id[r]) == up) {
          const float tv = v[r];
          const int ti = id[r];
          v[r] = v[r | st];
          id[r] = id[r | st];
          v[r | st] = tv;
          id[r | st] = ti;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    sv[sort_pos(base + r)] = v[r];
    si[sort_pos(base + r)] = id[r];
  }
  __syncthreads();
}

// Sorts the first n_sort entries (a power of two, kThreads ≤ n_sort ≤
// kThreads·EMAX) with block_sort at E = n_sort / kThreads.
template <int EMAX>
__device__ void sort_entries(float* sv, int* si, int n_sort) {
  if constexpr (EMAX > 1) {
    if (n_sort <= kThreads * (EMAX / 2)) {
      sort_entries<EMAX / 2>(sv, si, n_sort);
      return;
    }
  }
  block_sort<EMAX>(sv, si);
}

// Loads a row's n entries into a sort of sort_size(max(n, k)) ≤
// kThreads·EMAX entries, pads past n, and sorts them (every thread calls;
// the block's dynamic shared memory holds sort_smem_bytes(kThreads·EMAX)).
template <int EMAX>
__device__ void load_and_sort(const float* __restrict__ src_v,
                              const int* __restrict__ src_i, int n, int k,
                              float* sv, int* si) {
  const int n_sort = sort_size(n > k ? n : k);
  for (int e = threadIdx.x; e < n_sort; e += kThreads) {
    sv[sort_pos(e)] = e < n ? src_v[e] : kNegInf;
    si[sort_pos(e)] = e < n ? src_i[e] : kIdPad;
  }
  __syncthreads();
  sort_entries<EMAX>(sv, si, n_sort);
}

// The row kernels (τ, select) are compiled for the widest sort they may
// run (EMAX entries a thread); up to 16 a thread they hold 64 registers,
// so that 4 blocks share an SM and 320 rows run in one wave.
template <int EMAX>
constexpr int row_blocks_per_sm() {
  return EMAX <= 16 ? 4 : 2;
}

// τ of row blockIdx.x: the k-th of its n_union union entries under the
// key (a pad when fewer than k are real); zeroes the row's count.
template <int EMAX>
__global__ void __launch_bounds__(kThreads, row_blocks_per_sm<EMAX>())
mips_topk_tau_kernel(const float* __restrict__ uv, const int* __restrict__ ui,
                     int n_union, int k, float* __restrict__ tau_v,
                     int* __restrict__ tau_i, int* __restrict__ count) {
  extern __shared__ float4 smem4[];
  float* sv = reinterpret_cast<float*>(smem4);
  int* si = reinterpret_cast<int*>(sv + sort_pos(kThreads * EMAX));
  const long row = blockIdx.x;
  load_and_sort<EMAX>(uv + row * n_union, ui + row * n_union, n_union, k, sv,
                      si);
  if (threadIdx.x == 0) {
    tau_v[row] = sv[sort_pos(k - 1)];
    tau_i[row] = si[sort_pos(k - 1)];
    count[row] = 0;
  }
}

// The first k of row blockIdx.x's collected entries in key order, ID_PAD
// where the value is NEG_INF; a row that collected more than kcap is left
// to the split sweep.
template <int EMAX>
__global__ void __launch_bounds__(kThreads, row_blocks_per_sm<EMAX>())
mips_topk_select_kernel(const int* __restrict__ count,
                        const float* __restrict__ bv,
                        const int* __restrict__ bi, int kcap, int k,
                        float* __restrict__ vals, int* __restrict__ ids) {
  extern __shared__ float4 smem4[];
  const long row = blockIdx.x;
  const int n = count[row];
  if (n > kcap) return;
  float* sv = reinterpret_cast<float*>(smem4);
  int* si = reinterpret_cast<int*>(sv + sort_pos(kThreads * EMAX));
  load_and_sort<EMAX>(bv + row * kcap, bi + row * kcap, n, k, sv, si);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const float v = sv[sort_pos(j)];
    vals[row * k + j] = v;
    ids[row * k + j] = v == kNegInf ? kIdPad : si[sort_pos(j)];
  }
}

// Launches a row kernel compiled for sorts of up to sort_size(n) entries:
// f(std::integral_constant<int, EMAX>) with EMAX = sort_size(n) / kThreads.
template <class F>
cudaError_t by_sort_width(int n, F&& f) {
  switch (sort_size(n) / kThreads) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});  // kMaxSort
    default: return cudaErrorInvalidValue;
  }
}

// The split sweep's partial pass for the blocks of 16 rows that hold a
// row whose collect overflowed; the others return at once.
template <int SLOTS, bool FROM_S, typename T>
__global__ void __launch_bounds__(kThreads)
mips_topk_finish_partial_kernel(FmaSweep a, const int* __restrict__ count,
                                int kcap) {
  extern __shared__ float4 smem4[];
  const int row = blockIdx.x * 16 + threadIdx.x;
  if (!__syncthreads_or(threadIdx.x < 16 && row < a.n_q && count[row] > kcap))
    return;
  sweep_split<1, SLOTS, FROM_S, T>(
      a, smem4, [](const float (&)[1][kColsPerThread], const int*, long) {});
}

// The split sweep's merge for the rows whose collect overflowed.
template <int SLOTS>
__global__ void __launch_bounds__(kThreads)
mips_topk_finish_merge_kernel(const float* __restrict__ part_vals,
                              const int* __restrict__ part_ids,
                              const int* __restrict__ count, int kcap,
                              float* __restrict__ vals, int* __restrict__ ids,
                              int n_split, int k) {
  extern __shared__ float4 smem4[];
  if (count[blockIdx.x] <= kcap) return;
  merge_split_lists<SLOTS>(part_vals, part_ids, vals, ids, n_split, k,
                           nullptr, smem4);
}

// Shared memory of the largest launch of select_chain (the wrapper's
// select_smem computes the same).
inline size_t select_smem_bytes(int d, int k, int n_split, int kcap,
                                bool from_s = false) {
  const int n_union = kUnionPerSplit * n_split;
  size_t m = pass_smem_bytes(d, from_s);
  const size_t each[] = {sort_smem_bytes(n_union > k ? n_union : k),
                         sort_smem_bytes(kcap),
                         partial_smem_bytes<1>(d, k, from_s),
                         merge_smem_bytes(k)};
  for (size_t b : each) m = b > m ? b : m;
  return m;
}

struct SelectScratch {
  float* uv;       // (n_q, n_split·kUnionPerSplit) union
  int* ui;
  float* tau_v;    // (n_q,)
  int* tau_i;
  int* count;      // (n_q,)
  float* bv;       // (n_q, kcap) collected
  int* bi;
  float* part_vals;  // (n_q, fin_split, k) the finishing sweep's lists
  int* part_ids;
};

// Launches the chain: threshold, τ, collect, select and the finishing
// sweep, the last at list width SLOTS.
template <int SLOTS, bool FROM_S, typename T>
cudaError_t select_chain(const Pass& base, const SelectScratch& w, int k,
                         int n_split, int period, int collect_split,
                         int fin_split, int fin_split_cols, float* vals,
                         int* ids, cudaStream_t s) {
  static bool done_thr[kMaxDevices] = {}, done_col[kMaxDevices] = {},
              done_fin[kMaxDevices] = {}, done_merge[kMaxDevices] = {};
  const int n_q = base.n_q;
  const int n_union = kUnionPerSplit * n_split;
  const dim3 rows((n_q + kPassQB - 1) / kPassQB);
  const size_t pass_smem = pass_smem_bytes(base.d, FROM_S);
  cudaError_t err;
#define TRY(x)                           \
  if ((err = (x)) != cudaSuccess) return err
  TRY(allow_max_smem(mips_topk_pass_kernel<false, FROM_S, T>, done_thr));
  TRY(allow_max_smem(mips_topk_pass_kernel<true, FROM_S, T>, done_col));
  TRY(allow_max_smem(mips_topk_finish_partial_kernel<SLOTS, FROM_S, T>,
                     done_fin));
  if (merge_smem_bytes(k) > 48 * 1024)  // k > 736: the deep chain's lists
    TRY(allow_max_smem(mips_topk_finish_merge_kernel<SLOTS>, done_merge));

  Pass thr = base;
  thr.period = period;
  thr.uv = w.uv;
  thr.ui = w.ui;
  mips_topk_pass_kernel<false, FROM_S, T>
      <<<dim3(rows.x, n_split), kThreads, pass_smem, s>>>(thr);
  TRY(cudaGetLastError());
  TRY(by_sort_width(n_union > k ? n_union : k, [&](auto emax) {
    constexpr int E = decltype(emax)::value;
    static bool done[kMaxDevices] = {};
    cudaError_t e = allow_max_smem(mips_topk_tau_kernel<E>, done);
    if (e != cudaSuccess) return e;
    mips_topk_tau_kernel<E>
        <<<n_q, kThreads, sort_smem_bytes(kThreads * E), s>>>(
            w.uv, w.ui, n_union, k, w.tau_v, w.tau_i, w.count);
    return cudaGetLastError();
  }));
  Pass col = base;
  col.period = collect_split;
  col.tau_v = w.tau_v;
  col.tau_i = w.tau_i;
  col.count = w.count;
  col.bv = w.bv;
  col.bi = w.bi;
  mips_topk_pass_kernel<true, FROM_S, T>
      <<<dim3(rows.x, collect_split), kThreads, pass_smem, s>>>(col);
  TRY(cudaGetLastError());
  TRY(by_sort_width(base.kcap, [&](auto emax) {
    constexpr int E = decltype(emax)::value;
    static bool done[kMaxDevices] = {};
    cudaError_t e = allow_max_smem(mips_topk_select_kernel<E>, done);
    if (e != cudaSuccess) return e;
    mips_topk_select_kernel<E>
        <<<n_q, kThreads, sort_smem_bytes(kThreads * E), s>>>(
            w.count, w.bv, w.bi, base.kcap, k, vals, ids);
    return cudaGetLastError();
  }));
  const FmaSweep fin{base.q, base.y, base.valid, w.part_vals, w.part_ids,
                  n_q, base.c, base.d, k, fin_split_cols, base.id_offset,
                  base.id_offset, base.id_offset + base.c, base.vec, base.s};
  mips_topk_finish_partial_kernel<SLOTS, FROM_S, T>
      <<<dim3((n_q + 15) / 16, fin_split), kThreads,
         partial_smem_bytes<1>(base.d, k, FROM_S), s>>>(fin, w.count,
                                                        base.kcap);
  TRY(cudaGetLastError());
  mips_topk_finish_merge_kernel<SLOTS>
      <<<n_q, kThreads, merge_smem_bytes(k), s>>>(
          w.part_vals, w.part_ids, w.count, base.kcap, vals, ids, fin_split,
          k);
  return cudaGetLastError();
#undef TRY
}

// deep_tc's score slab, with this library's table of its shared-memory
// opt-in for each element type (gemm's for f32, gemm_bf16's for bf16).
template <typename T>
cudaError_t score_slab(const T* q, const T* y, float* s, int n_q, int c,
                       int d, int ld, cudaStream_t st) {
  static bool done[kMaxDevices] = {};
  return deep_tc::score_slab<T>(q, y, s, n_q, c, d, ld, st, done);
}

// 1 when rows of y (element size `elem`) can be read 4 values at a time.
inline int vec4(const void* y, int d, int elem) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(y) % (4 * elem) == 0;
}

}  // namespace

// Every entry takes q and y in one element type: f32, or bfloat16 when
// `bf16_in` is nonzero (resident: widened to f32 as they are staged; the
// chain's FMA fold and the sweep's 3xTF32 products then run on exact f32
// copies of the values, so the outputs equal the f32 launch on the
// widened inputs bit for bit; deep: the bf16 slab). Scores, values and
// scratch are f32 either way.

// The k ≤ 32 sweep on `stream`: τ seeded — by the pre-pass over tiles s,
// s + pre_period, … of pre_split splits and its selection, or, when
// pre_split is 0, as "no threshold" — the sweep over n_split balanced
// splits of the catalog's tiles at 8·query_tiles query rows a block, and
// the merge. part_vals / part_ids are (n_q, n_split, k), tau (n_q,) int32
// and uv (n_q, pre_split, 8·WM) f32 (WM: 4 for 1 or 4 query tiles, 2 for
// 16) scratch, vals / ids the (n_q, k) outputs; valid is a
// (C,) bool mask (one byte per row) or null. Returns the cudaError_t of
// the launches (0 on success), and cudaErrorInvalidValue for a plan it
// does not take (a block above kMaxSmem included). Nothing is
// synchronised and nothing is allocated.
extern "C" int mips_topk_launch(const void* q, const void* y,
                                const unsigned char* valid, float* part_vals,
                                int* part_ids, int* tau, float* uv,
                                float* vals, int* ids,
                                int n_q, int c, int d, int k, int query_tiles,
                                int n_split, int pre_split, int pre_period,
                                int id_offset, int bf16_in, void* stream) {
  if (n_q <= 0 || c <= 0 || d <= 0 || d > kMaxD || k <= 0 || k > 32 ||
      k > c || n_split <= 0 || n_split > 65535 || pre_split < 0 ||
      pre_split > 65535 || (pre_split > 0 && pre_period < pre_split))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // No window: [id_offset, id_offset + c) holds every row.
  const Sweep a{q, y, valid, part_vals, part_ids, tau, n_q, c, d, k, 0,
                id_offset, id_offset, id_offset + c,
                vec4(y, d, bf16_in ? 2 : 4), pre_split > 0};
  return (int)by_dtype(bf16_in, [&](auto t) {
    using T = decltype(t);
    return dispatch<1>(query_tiles, k, [&](auto nqt, auto slots) {
      return launch_sweep<decltype(nqt)::value, decltype(slots)::value,
                          false, T>(a, uv, vals, ids, n_split, pre_split,
                                    pre_period, s);
    });
  });
}

// The k > 32 chain on `stream`: threshold pass over n_split strided
// splits of period `period` tiles, τ, collect pass over collect_split
// splits into kcap entries a row, select, and the split sweep (fin_split
// splits of fin_split_cols) for rows that overflowed. Scratch (all
// device memory, any contents): uv / ui (n_q, 16·n_split), tau_v / tau_i
// / count (n_q,), bv / bi (n_q, kcap), part_vals / part_ids (n_q,
// fin_split, k). Returns the cudaError_t of the launches,
// cudaErrorInvalidValue for a plan it does not take. Nothing is
// synchronised and nothing is allocated.
extern "C" int mips_topk_select_launch(
    const void* q, const void* y, const unsigned char* valid, float* uv,
    int* ui, float* tau_v, int* tau_i, int* count, float* bv, int* bi,
    float* part_vals, int* part_ids, float* vals, int* ids, int n_q, int c,
    int d, int k, int id_offset, int n_split, int period, int collect_split,
    int kcap, int fin_split, int fin_split_cols, int bf16_in, void* stream) {
  if (n_q <= 0 || c <= 0 || d <= 0 || d > kMaxD || k <= 0 ||
      k > kMaxSweepK || k > c || n_split <= 0 || period < n_split ||
      collect_split <= 0 ||
      kcap < k || kcap > kMaxSort ||
      (long)kUnionPerSplit * n_split > kMaxSort || fin_split <= 0 ||
      fin_split_cols <= 0 || fin_split_cols % kTileC != 0 ||
      (long)fin_split * fin_split_cols < (long)c ||
      select_smem_bytes(d, k, n_split, kcap) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Pass base{};
  base.q = q;
  base.y = y;
  base.valid = valid;
  base.n_q = n_q;
  base.c = c;
  base.d = d;
  base.id_offset = id_offset;
  base.vec = vec4(y, d, bf16_in ? 2 : 4);
  base.kcap = kcap;
  const SelectScratch w{uv, ui, tau_v, tau_i, count, bv, bi, part_vals,
                        part_ids};
  return (int)by_dtype(bf16_in, [&](auto t) {
    using T = decltype(t);
    auto run = [&](auto slots) {
      return select_chain<decltype(slots)::value, false, T>(
          base, w, k, n_split, period, collect_split, fin_split,
          fin_split_cols, vals, ids, s);
    };
    return k <= 32 * kSlotsSmall
               ? run(std::integral_constant<int, kSlotsSmall>{})
               : run(std::integral_constant<int, kSlotsLarge>{});
  });
}

// The deep variants: as mips_topk_launch and mips_topk_select_launch, for
// any d > 0 (and, in the chain, k ≤ kMaxK), with `scores` an f32
// workspace that deep_tc::score_slab fills first — (c, slab_ld(n_q)) for
// the sweep, whose tensor map wants 16-byte rows; (c, n_q) for the chain —
// and the sweeps and passes then read (FROM_S).
extern "C" int mips_topk_deep_launch(const void* q, const void* y,
                                     const unsigned char* valid,
                                     float* scores, float* part_vals,
                                     int* part_ids, int* tau, float* uv,
                                     float* vals, int* ids, int n_q, int c,
                                     int d, int k, int query_tiles,
                                     int n_split, int pre_split,
                                     int pre_period, int id_offset, int bf16_in,
                                     void* stream) {
  if (n_q <= 0 || c <= 0 || d <= 0 || k <= 0 || k > 32 || k > c ||
      scores == nullptr || n_split <= 0 || n_split > 65535 ||
      pre_split < 0 || pre_split > 65535 ||
      (pre_split > 0 && pre_period < pre_split))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = by_dtype(bf16_in, [&](auto t) {
    using T = decltype(t);
    return score_slab(static_cast<const T*>(q), static_cast<const T*>(y),
                      scores, n_q, c, d, slab_ld(n_q), s);
  });
  if (err != cudaSuccess) return (int)err;
  Sweep a{q, y, valid, part_vals, part_ids, tau, n_q, c, d, k, 0,
          id_offset, id_offset, id_offset + c, 0, pre_split > 0};
  a.s = scores;
  return (int)dispatch<1, true>(query_tiles, k, [&](auto nqt, auto slots) {
    return launch_sweep<decltype(nqt)::value, decltype(slots)::value, true,
                        float>(a, uv, vals, ids, n_split, pre_split,
                               pre_period, s);
  });
}

extern "C" int mips_topk_select_deep_launch(
    const void* q, const void* y, const unsigned char* valid,
    float* scores, float* uv, int* ui, float* tau_v, int* tau_i, int* count,
    float* bv, int* bi, float* part_vals, int* part_ids, float* vals,
    int* ids, int n_q, int c, int d, int k, int id_offset, int n_split,
    int period, int collect_split, int kcap, int fin_split,
    int fin_split_cols, int bf16_in, void* stream) {
  if (n_q <= 0 || c <= 0 || d <= 0 || k <= 0 || k > kMaxK || k > c ||
      scores == nullptr || n_split <= 0 || period < n_split ||
      collect_split <= 0 || kcap < k || kcap > kMaxSort ||
      (long)kUnionPerSplit * n_split > kMaxSort || fin_split <= 0 ||
      fin_split_cols <= 0 || fin_split_cols % kTileC != 0 ||
      (long)fin_split * fin_split_cols < (long)c ||
      select_smem_bytes(d, k, n_split, kcap, true) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = by_dtype(bf16_in, [&](auto t) {
    using T = decltype(t);
    return score_slab(static_cast<const T*>(q), static_cast<const T*>(y),
                      scores, n_q, c, d, n_q, s);
  });
  if (err != cudaSuccess) return (int)err;
  Pass base{};
  base.q = q;
  base.y = y;
  base.valid = valid;
  base.n_q = n_q;
  base.c = c;
  base.d = d;
  base.id_offset = id_offset;
  base.kcap = kcap;
  base.s = scores;
  const SelectScratch w{uv, ui, tau_v, tau_i, count, bv, bi, part_vals,
                        part_ids};
  auto run = [&](auto slots) {
    return select_chain<decltype(slots)::value, true, float>(
        base, w, k, n_split, period, collect_split, fin_split,
        fin_split_cols, vals, ids, s);
  };
  return (int)(k <= 32 * kSlotsSmall
                   ? run(std::integral_constant<int, kSlotsSmall>{})
               : k <= kMaxSweepK
                   ? run(std::integral_constant<int, kSlotsLarge>{})
                   : run(std::integral_constant<int, kSlotsHuge>{}));
}
