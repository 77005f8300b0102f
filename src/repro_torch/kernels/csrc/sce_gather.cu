// sce_gather — in-bucket SCE with the candidate rows gathered from the
// catalog inside the kernel, forward and backward, written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels behind `sce_gather_loss` and
// `sce_gather_plse` of src/repro/kernels/sce_prefetch.py: `_gfwd_kernel`
// (forward, with_pos true for the loss, false for the partial LSE),
// `_gbwd_dx_kernel` (dX) and `_gbwd_dy_kernel` (dY), the backward shared
// by both as in the reference (`_plse_vjp_bwd` calls the loss's `_gbwd`).
// With the template flag DIRECT the same kernels replace those behind
// `sce_bucket_loss` and `sce_bucket_plse` of src/repro/kernels/
// sce_bucket.py (`_fwd_kernel`, `_fwd_plse_kernel`, `_bwd_dx_kernel`,
// `_bwd_dy_kernel`): the candidates arrive pre-gathered as y_b (n_b, b_y,
// d), candidate j of bucket n is row n·b_y + j (no idx_y, no clamp), and
// dY writes the bucket's own rows of dy_b instead of adding into catalog
// rows — no atomics, so that dY repeats bit for bit (the entries at the
// end of this file; wrapped by src/repro_torch/kernels/sce_bucket.py).
// For bucket n, row x of x_b (n_b, b_x, d) and candidate j < b_y with
// catalog row r = clamp(idx_y[n, j], 0, C - 1):
//
//   l[x, j]  = cap·tanh(x_b[n, x]·Y[r] / cap)      (no cap: the plain dot)
//   masked   where cand[n, j] == tgt[n, x] or cand[n, j] < 0
//   lse[x]   = log(exp(pos[n, x]) + Σ_j exp(l[x, j]))  over unmasked j
//   loss[x]  = lse[x] − pos[n, x]
//   plse[x]  = m + log(max(s, 1e-30)), the online (m, s) over the masked
//              logits from (NEG_INF, 0), no positive: a masked slot is a
//              NEG_INF logit, so a row with every candidate masked comes
//              out at NEG_INF + log(count) = −1e30 in f32, never −inf
//   gw[x, j] = exp(l[x, j] − lse[x]) · (1 − (l[x, j]/cap)²) · g[n, x]
//              (0 where masked; the cap factor is 1 without a cap; the
//              partial LSE's backward passes plse in place of lse)
//   dX[n, x] = Σ_j gw[x, j] · Y[r_j]
//   dY[r_j] += Σ_x gw[x, j] · x_b[n, x]     (summed over every bucket)
//
// The softcap is applied before the mask, as on the TPU: a masked slot
// stays at NEG_INF, never −cap. The positive logit arrives already capped;
// its gradient d_pos = (exp(pos − lse) − 1)·g is a plain tensor expression
// in the wrapper, as in the reference's `_loss_vjp_bwd`.
//
// One deviation from the plain version, in dX and dY only: their exp
// takes min(l − lse, 44), as linear_ce.cu's backward does. The forward's
// lse comes from f32 FMA logits and the backward recomputes them in
// 3xTF32 (below), so l − lse may exceed 0 by a few units in the last
// place; the min acts only for an lse more than 44 below a logit, where
// the plain version's entry grows on towards inf while the kernels' stays
// at e^44 · g, so that their tensor-core sums stay finite. A masked slot
// is 0 by a select, never by a product: a partial-LSE row with no unmasked
// candidate has plse = −1e30, and its exp would be inf before the min.
//
// What bounds it on an H100. At the paper's training shape (n_b = 320
// buckets, b_x = 320 positions, b_y = 256 candidates, d = 64, C = 173,520)
// the forward is 2·320·320·256·64 ≈ 3.36 GFLOP of f32 FMAs against
// ≈ 47 MB that must move (x_b, the gathered rows, the outputs): 0.050 ms
// at 67 TFLOP/s against 0.014 ms at 3.35 TB/s, so the f32 FMA rate bounds
// it. dX and dY each recompute the logits and run a second product of the
// same size, 6.7 GFLOP: 0.100 ms each as f32 FMAs. Both run their products
// on the tensor cores in 3xTF32 (tf32x3_tile.cuh) instead: three TF32
// passes of 6.7 GFLOP at the dense 495 TFLOP/s are 0.041 ms, against
// 0.006 ms for the 26.2 M exps on the SFUs and 0.022 / 0.027 ms of bytes,
// so the tensor cores bound them. The forward keeps f32 FMAs in a fixed
// order over d (no TF32), so the losses keep f32 precision next to the
// plain version; the backward's 3xTF32 keeps the gradients' f32 tolerance
// (about 2⁻²¹ relative per product, each k16 step summed from zero; see
// linear_ce.cu).
//
// Design of the forward. The TPU grid walks the candidates one row at a
// time on a sequential axis, gathering each row by scalar prefetch into a
// VMEM tile; on Hopper that axis would be one block. Here each block owns
// 64 rows of x_b of one bucket, grid (n_b, ceil(b_x / 64)): it stages
// them in shared memory once, then walks the bucket's candidates 64 at a
// time: it reads the 64 catalog row ids, gathers those rows of Y into
// shared memory (the pointer gather takes the place of scalar prefetch)
// and computes the 64 × 64 logit tile as a 4 × 4 register tile per thread
// from float4 shared-memory reads, the loop structure of csrc/mips_topk.cu
// (the tile code is in csrc/f32_tile.cuh). It folds each tile into a
// per-row online logsumexp held in registers by the 16 threads that share
// a row (half-warp shuffles reduce the tile's max and sum), starting from
// (m, s) = (pos, 1) so the positive is counted once (the partial LSE,
// template flag WITH_POS false, from (NEG_INF, 0) and with no positive to
// read). The partial LSE's rows with no owned candidate are the common
// case in the distributed exact mode — every candidate another shard owns
// arrives as cand = −1 — and cost the same tile walk as any other row.
// b_x = 320 and b_y = 256 need no padding copies: rows past b_x and
// candidates past b_y are staged as zeros and masked in the kernel.
//
// Design of the backward: one kernel, sce_bwd_kernel, on two grids, after
// linear_ce.cu's ce_bwd_kernel. A block of four warps owns 128 rows (32 a
// warp, two m16 tiles) of one bucket — positions of x_b for dX, its
// ceil(b_x / 128) blocks a bucket; candidates for dY, ceil(b_y / 128) —
// and streams the bucket's other side 32 rows a tile. A bucket's blocks
// are neighbours in the grid, so the ragged last block of dX (b_x = 320
// is 2.5 blocks) shares its wave with full ones. Per tile a warp computes
// its 32 × 32 logit tile with 192 `mma` (mma3x2, k16 steps over the
// depth), turns it into gw in the accumulator registers (softcap, mask by
// select, exp2 of one FFMA on the SFU), splits it into hi and lo there
// and multiplies it by the streamed tile into its (32, 64) output
// accumulator with another 192 `mma`: gw's C fragment is the second
// product's A fragment (the k order of tf32x3_tile.cuh), so it never goes
// through shared memory. For d > 64 the grid's second axis takes the
// output 64 depth columns at a time, each block recomputing the logits. A
// warp whose 32 rows all lie past the bucket's end stages and synchronises
// with the others but skips both products. What is new against linear_ce
// is the gather:
//   * the streamed rows arrive by id: a row is d / 4 cp.async 16-byte
//     chunks from Y + clamp(id)·d (4-byte copies when d % 4 ≠ 0 or a row
//     is not 16-byte aligned), into a ring of three raw f32 stages, so
//     that tile i + 2 is in flight while tile i computes — Hopper's tiled
//     TMA cannot gather rows. The ids of tile i + 3 are loaded during tile
//     i's products and stored into a two-slot ring in shared memory after
//     them, so that no copy waits on a dependent load of its id. The
//     streamed tile's per-row inputs (dX: the candidate ids; dY: the
//     positions' lse, g and targets) travel with its rows.
//   * the streamed tile is split in the block: after it lands, one pass of
//     all threads turns its raw rows into (hi, lo) pairs in the swizzled
//     layout of tf32x3_tile.cuh (an LDS.128, four splits and two STS.128
//     per four depths, about 80 instructions a thread a tile at d = 64,
//     against 384 `mma` a warp). The catalog is never split into global
//     planes: that would add 2·C·d·4 B = 88.8 MB to the step's peak.
//   * the owned rows (gathered by id for dY) arrive once per block in one
//     batch of cp.async into the space of the split tile and the ring,
//     and are split from there into the A fragments of their warp.
//   * dY's scatter is an atomic add of four f32 (lanes q and q ^ 1 trade
//     halves so that each holds four columns of one row) per (candidate,
//     four depths) after the walk, skipped for candidates with a negative
//     id (their sum is exactly 0): in the distributed exact mode ≈ 75 % of
//     a 4-way shard's candidates are another shard's and clamp to one row,
//     whose atomics would otherwise serialise (4.7× the dY time on such a
//     shard, PERF.md). Rows within one bucket are distinct (they come from
//     a top-k), but a hot catalog row recurs across buckets, and blocks
//     run in no order. A deterministic scheme would need a per-bucket
//     (n_b, b_y, d) buffer — the tensor the gather kernel exists to avoid
//     — plus a sort by row and a segmented sum. With atomics the order of
//     the additions changes from run to run, so dY is not bitwise
//     repeatable: tests compare it within a tolerance, never bit for bit.
//     The wrapper zeroes dY first, so rows no bucket selected come out
//     exactly 0. DIRECT writes each of the bucket's rows once. dX uses no
//     atomics and repeats bit for bit; DIRECT's dX equals the gathered
//     one's on y_b = y[idx] (the same rows through the same arithmetic).
//   * At d = 64 a block takes 107,904 bytes of shared memory (owned
//     fragments 64 KB, the split tile 16 KB, three raw stages 24 KB), so
//     two blocks, eight warps, share an SM; at 255 registers a thread
//     (ptxas, sm_90a; a few dozen bytes of spills in some instantiations)
//     eight warps are all an SM holds. bwd_plan picks the warps for every
//     d ≤ 256 and is exported as sce_gather_bwd_plan.
//   * On an H100 at the paper's shape dX takes ≈ 0.21 ms and dY ≈ 0.19,
//     half the products' time: the rest is the per-tile barriers, staging
//     and split pass, the per-block prologue and the waves of a short walk
//     (8 and 10 tiles a block), which two warps a scheduler do not hide
//     (probes/sce_gather_times.py; PERF.md).
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes in src/repro_torch/kernels/sce_prefetch.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "f32_tile.cuh"
#include "tf32x3_tile.cuh"

namespace {

using namespace f32_tile;
using namespace tf32x3;

constexpr int kTileX = kTile;  // 64 rows of x_b per forward tile
constexpr int kTileY = kTile;  // 64 candidates per forward tile

// The forward's shared memory: the x_b and candidate tiles, and the
// candidates' row and candidate ids.
size_t fwd_smem(int d) {
  return sizeof(float) * (size_t)(kTileX + kTileY) * row_pitch(d) +
         sizeof(int) * 2 * kTileY;
}

// Loads the row ids and candidate ids of candidates [j0, j0 + ny) of
// bucket n, base = n·b_y + j0: the catalog rows idx_y[base + j] clamped to
// [0, C), or with DIRECT (sce_bucket: y is the pre-gathered y_b viewed as
// (n_b·b_y, d)) the rows base + j themselves. Slots past ny get row 0 and
// id −1.
template <bool DIRECT>
__device__ __forceinline__ void load_candidates(const int* idx_y,
                                                const int* cand, int* rows,
                                                int* cands, long base, int ny,
                                                int c, int tid) {
  if (tid < kTileY) {
    int r = 0;
    int id = -1;
    if (tid < ny) {
      if constexpr (DIRECT) {
        r = (int)(base + tid);
      } else {
        r = idx_y[base + tid];
        r = r < 0 ? 0 : (r >= c ? c - 1 : r);
      }
      id = cand[base + tid];
    }
    rows[tid] = r;
    cands[tid] = id;
  }
}

__device__ __forceinline__ bool masked(int col, int ny, int cand_id,
                                       int tgt) {
  return col >= ny || cand_id < 0 || cand_id == tgt;
}

// ---------------------------------------------------------------------------
// Forward: loss and lse (WITH_POS), or the partial LSE, of 64 rows of one
// bucket. Without the positive, `pos` and `loss` are not read or written.
// ---------------------------------------------------------------------------
template <bool WITH_POS, bool DIRECT>
__global__ void __launch_bounds__(kThreads)
sce_gather_fwd_kernel(const float* __restrict__ x_b,
                      const float* __restrict__ y,
                      const int* __restrict__ idx_y,
                      const int* __restrict__ tgt_b,
                      const int* __restrict__ cand,
                      const float* __restrict__ pos,
                      float* __restrict__ loss, float* __restrict__ lse,
                      int b_x, int b_y, int c, int d, float cap, int vec_x,
                      int vec_y) {
  extern __shared__ float4 smem4[];
  const int p = row_pitch(d);
  const int d4 = (d + 3) / 4;
  float* xs = reinterpret_cast<float*>(smem4);        // (kTileX, p)
  float* ys = xs + kTileX * p;                        // (kTileY, p)
  int* rows = reinterpret_cast<int*>(ys + kTileY * p);  // (kTileY,)
  int* cands = rows + kTileY;                           // (kTileY,)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int n = blockIdx.x;
  const int x0 = blockIdx.y * kTileX;
  const int nx = min(kTileX, b_x - x0);
  const long row0 = (long)n * b_x + x0;

  stage(xs, x_b + row0 * d, nx, kTileX, d, p, vec_x, [](int r) { return r; },
        tid);
  float m[kRM], s[kRM], ps[kRM];
  int tg[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = ty * kRM + i;
    ps[i] = WITH_POS && r < nx ? pos[row0 + r] : 0.f;
    tg[i] = r < nx ? tgt_b[row0 + r] : -2;
    // With the positive folded in (m, s) = (pos, 1); without, (NEG_INF, 0).
    m[i] = WITH_POS ? ps[i] : kNegInf;
    s[i] = WITH_POS ? 1.f : 0.f;
  }

  for (int j0 = 0; j0 < b_y; j0 += kTileY) {
    const int ny = min(kTileY, b_y - j0);
    __syncthreads();  // the previous tile is no longer read
    load_candidates<DIRECT>(idx_y, cand, rows, cands, (long)n * b_y + j0, ny,
                            c, tid);
    __syncthreads();
    stage(ys, y, ny, kTileY, d, p, vec_y, [rows](int r) { return rows[r]; },
          tid);
    __syncthreads();
    float acc[kRM][kCols];
    tile_scores(xs, ys, p, d4, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      float l[kCols];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        l[j] = masked(col, ny, cands[col], tg[i]) ? kNegInf
                                                  : capped(acc[i][j], cap);
        tmax = fmaxf(tmax, l[j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(tmax));
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) se += expf(l[j] - mn);
      s[i] = s[i] * expf(m[i] - mn) + half_warp_sum(se);
      m[i] = mn;
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = ty * kRM + i;
      if (r >= nx) continue;
      if constexpr (WITH_POS) {
        const float l = m[i] + logf(s[i]);
        lse[row0 + r] = l;
        loss[row0 + r] = l - ps[i];
      } else {
        lse[row0 + r] = m[i] + logf(fmaxf(s[i], 1e-30f));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dX and dY on the tensor cores (3xTF32).
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaxExp2 = 44.f * kLog2e;  // exp's argument capped at 44
constexpr int kBwdMaxWarps = 4;
constexpr int kStatRows = 3 * kStreamRows;  // a stage's per-row inputs
constexpr int kStages = 3;  // the raw ring: tile i + 2 lands while i computes

// One backward call. DY: the block owns candidates and streams positions;
// else it owns positions and streams candidates.
struct BwdArgs {
  const float* x_b;   // (n_b, b_x, d)
  const float* y;     // (C, d); DIRECT: y_b as (n_b·b_y, d)
  const int* idx_y;   // (n_b, b_y); null with DIRECT
  const int* tgt;     // (n_b, b_x)
  const int* cand;    // (n_b, b_y)
  const float* lse;   // (n_b, b_x)
  const float* g;     // (n_b, b_x)
  float* out;         // dX (n_b, b_x, d); dY (C, d) or dy_b (n_b·b_y, d)
  int b_x, b_y, c, d, dp;  // dp = d rounded up to 16
  float cap;
  int vec;      // the streamed rows can be copied in 16-byte chunks
  int vec_own;  // the owned rows can be copied in 16-byte chunks
  int vec_out;  // the output rows take 16-byte stores
};

// A candidate id clamped to the catalog's rows [0, C).
__device__ __forceinline__ int clamp_row(int r, int c) {
  return r < 0 ? 0 : (r >= c ? c - 1 : r);
}

// Catalog row of candidate j of bucket n (the flat index n·b_y + j).
template <bool DIRECT>
__device__ __forceinline__ int cand_row(const BwdArgs& a, long nj) {
  return DIRECT ? (int)nj : clamp_row(a.idx_y[nj], a.c);
}

// gw of one logit: 0 where masked (a select), else
// exp2(min(l·log2e − lse·log2e, 44·log2e)) · cap′ · g.
template <bool CAP>
__device__ __forceinline__ float cotangent(float v, float lse2, float g,
                                           bool masked, float cap) {
  const float l = CAP ? capped(v, cap) : v;
  float z = fmaf(l, kLog2e, -lse2);
  z = z > kMaxExp2 ? kMaxExp2 : z;  // a NaN stays NaN
  float p = exp2_approx(z);
  if (CAP) p *= cap_deriv(l, cap);
  return masked ? 0.f : p * g;
}

template <bool DY, bool DIRECT, bool CAP>
__global__ void __launch_bounds__(32 * kBwdMaxWarps, 2)
sce_bwd_kernel(BwdArgs a) {
  constexpr bool GATHER = !DY && !DIRECT;  // streamed rows arrive by id
  extern __shared__ float4 smem4[];
  const int dp = a.dp, cpr = dp / 2, rq = dp / 4;
  const int s8 = dp / 8;  // k8 steps over the depth
  const int warps = blockDim.x >> 5;
  const int bm = kWarpRows * warps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3;
  float4* own = smem4;             // A fragments: (bm / 16, s8, 32, hi|lo)
  float4* tile = own + bm * cpr;   // the split tile: (kStreamRows, cpr)
  float4* raw = tile + kStreamRows * cpr;  // stages × (kStreamRows, rq)
  float* stats = reinterpret_cast<float*>(raw + kStages * kStreamRows *
                                          rq);  // stages × kStatRows
  int* ids = reinterpret_cast<int*>(stats + kStages * kStatRows);  // 2 × 32

  const int n_own = DY ? a.b_y : a.b_x;
  // blockIdx.x = n · row_tiles + row tile: a bucket's blocks are
  // neighbours, so a ragged last row tile (b_x = 320) shares its wave with
  // full ones rather than running with its likes at the end
  const int row_tiles = (n_own + bm - 1) / bm;
  const int n = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x - n * row_tiles) * bm;  // first owned row
  const int oc0 = blockIdx.y * kOutCols;
  const int n_out8 = min(kOutCols, dp - oc0) / 8;
  const int n_str = DY ? a.b_x : a.b_y;
  const int n_tiles = (n_str + kStreamRows - 1) / kStreamRows;
  const long xrow0 = (long)n * a.b_x;  // flat row of position 0
  const long crow0 = (long)n * a.b_y;  // flat index of candidate 0

  // A streamed row's source: a position of x_b (dY), a candidate by its
  // id in the ids ring (dX, gathered) or by its place (dX, DIRECT).
  auto str_row = [&](int t, int r) -> const float* {
    const int row = t * kStreamRows + r;
    if (DY) return a.x_b + (xrow0 + row) * a.d;
    if (DIRECT) return a.y + (crow0 + row) * a.d;
    return a.y + (long)clamp_row(ids[(t & 1) * kStreamRows + r], a.c) * a.d;
  };
  // Tile t's raw rows into ring slot sl (zeros past the bucket and past
  // d), with its per-row inputs: dX the candidate ids, dY the positions'
  // lse, g and targets.
  auto stage = [&](int t, int sl) {
    float* dst = reinterpret_cast<float*>(raw + sl * kStreamRows * rq);
    const int live = min(kStreamRows, n_str - t * kStreamRows);
    if (a.vec) {
      const int r_first = threadIdx.x / rq, c_first = threadIdx.x % rq;
      const int r_step = blockDim.x / rq, c_step = blockDim.x % rq;
      for (int r = r_first, ch = c_first; r < kStreamRows;) {
        const bool ok = r < live && 4 * ch < a.d;
        cp_async16(dst + 4 * (r * rq + ch),
                   ok ? str_row(t, r) + 4 * ch : a.x_b, ok);
        r += r_step;
        ch += c_step;
        if (ch >= rq) {
          ch -= rq;
          ++r;
        }
      }
    } else {
      for (int e = threadIdx.x; e < kStreamRows * dp; e += blockDim.x) {
        const int r = e / dp, k = e - r * dp;
        const bool ok = r < live && k < a.d;
        cp_async4(dst + e, ok ? str_row(t, r) + k : a.x_b, ok);
      }
    }
    float* st = stats + sl * kStatRows;
    for (int e = threadIdx.x; e < (DY ? kStatRows : kStreamRows);
         e += blockDim.x) {
      const int which = e / kStreamRows, r = e - which * kStreamRows;
      const bool ok = r < live;
      const long p = (DY ? xrow0 : crow0) + t * kStreamRows + r;
      const void* src = !DY        ? (const void*)(a.cand + p)
                        : which == 0 ? (const void*)(a.lse + p)
                        : which == 1 ? (const void*)(a.g + p)
                                     : (const void*)(a.tgt + p);
      cp_async4(st + e, ok ? src : (const void*)a.lse, ok);
    }
  };
  // The catalog id of candidate r of tile t (gathered dX), 0 past b_y;
  // clamped where str_row reads it, so that the load of a later tile's
  // ids is not waited for until its store after the products.
  auto tile_id = [&](int t, int r) {
    const int j = t * kStreamRows + r;
    return j < a.b_y ? a.idx_y[crow0 + j] : 0;
  };

  // The thread's owned rows (m16 tile m, half h) and what the cotangent
  // needs of them: dX a position's lse·log2e, g and target; dY a
  // candidate's id (−1 past b_y) and catalog row.
  float ls2[kMT][2], gs[kMT][2];
  int tg[kMT][2], orow[kMT][2];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + warp * kWarpRows + 16 * m + 8 * h + gq;
      const bool live = r < n_own;
      if (DY) {
        tg[m][h] = live ? a.cand[crow0 + r] : -1;
        orow[m][h] = live ? cand_row<DIRECT>(a, crow0 + r) : 0;
        ls2[m][h] = gs[m][h] = 0.f;
      } else {
        tg[m][h] = live ? a.tgt[xrow0 + r] : -1;
        orow[m][h] = live ? (int)(xrow0 + r) : 0;
        ls2[m][h] = live ? a.lse[xrow0 + r] * kLog2e : 0.f;
        gs[m][h] = live ? a.g[xrow0 + r] : 0.f;
      }
    }

  // The owned rows, once: their raw f32 in one batch of cp.async into the
  // split tile and the ring (free until the walk starts; bm rows at a
  // pitch of dp + 4 floats fit there for every dp ≥ 16), then split into
  // the A fragments of their warp. Thread i's row index (the source row,
  // −1 past the bucket) goes through the fragments' space first.
  {
    int* own_row = reinterpret_cast<int*>(own);
    const int r = r0 + threadIdx.x;  // blockDim.x == bm
    own_row[threadIdx.x] =
        r >= n_own ? -1
                   : (DY ? cand_row<DIRECT>(a, crow0 + r) : (int)(xrow0 + r));
    if (GATHER)  // the ids of tiles 0 and 1
      for (int e = threadIdx.x; e < 2 * kStreamRows; e += blockDim.x)
        ids[e] = tile_id(e / kStreamRows, e % kStreamRows);
    __syncthreads();
    const float* src_base = DY ? a.y : a.x_b;
    float* oraw = reinterpret_cast<float*>(tile);
    const int op = dp + 4;  // pitch: the rows of a fragment read spread
    if (a.vec_own) {
      for (int e = threadIdx.x; e < bm * rq; e += blockDim.x) {
        const int rr = e / rq, ch = e - rr * rq;
        const int row = own_row[rr];
        const bool ok = row >= 0 && 4 * ch < a.d;
        cp_async16(oraw + rr * op + 4 * ch,
                   ok ? src_base + (long)row * a.d + 4 * ch : a.x_b, ok);
      }
    } else {
      for (int e = threadIdx.x; e < bm * dp; e += blockDim.x) {
        const int rr = e / dp, k = e - rr * dp;
        const int row = own_row[rr];
        const bool ok = row >= 0 && k < a.d;
        cp_async4(oraw + rr * op + k,
                  ok ? src_base + (long)row * a.d + k : a.x_b, ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // For m16 tile m and k8 step s, lane (gq, q) holds rows gq, gq + 8 at
    // depths 8s + 2q, 8s + 2q + 1, hi beside lo (ce_bwd_kernel's layout).
    for (int u = 0; u < kMT * s8; ++u) {
      const int m = u / s8, s = u - m * s8;
      const float* v0 =
          oraw + (warp * kWarpRows + 16 * m + gq) * op + 8 * s + 2 * q;
      const float2 w0 = *reinterpret_cast<const float2*>(v0);
      const float2 w1 = *reinterpret_cast<const float2*>(v0 + 8 * op);
      uint32_t hi[4], lo[4];
      split(w0.x, hi[0], lo[0]);
      split(w1.x, hi[1], lo[1]);
      split(w0.y, hi[2], lo[2]);
      split(w1.y, hi[3], lo[3]);
      float4* f = own + 2 * (32 * ((warp * kMT + m) * s8 + s) + lane);
      f[0] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                         __uint_as_float(hi[2]), __uint_as_float(hi[3]));
      f[1] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                         __uint_as_float(lo[2]), __uint_as_float(lo[3]));
    }
    __syncthreads();  // the split tile and the ring are free for the walk
  }
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < n_tiles) stage(sl, sl);
    cp_async_commit();
  }
  if (GATHER) {  // tile 2's ids into tile 0's slot
    __syncthreads();
    if (threadIdx.x < kStreamRows) ids[threadIdx.x] = tile_id(2, threadIdx.x);
  }
  const float* afrag =
      reinterpret_cast<const float*>(own) + 8 * (32 * (warp * kMT * s8) + lane);
  const bool warp_live = r0 + warp * kWarpRows < n_own;

  // Per-thread float offsets in the split tile. S's B fragment (row
  // 8n + gq, depths 8s + 2q, + 1): sb[s & 1] + 32·cpr·n + 32·(s >> 1).
  // The product's (rows 8j + 2q + rp, depth oc0 + 8n + gq):
  // pb[rp][n & 1] + 32·cpr·j + 32·(n >> 1). Lo is two chunks after hi.
  int sb_hi[2], sb_lo[2], pb_hi[2][2], pb_lo[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int f = swizzle(gq);
    sb_hi[p] = 4 * (gq * cpr + ((4 * p + (q >> 1)) ^ f)) + 2 * (q & 1);
    sb_lo[p] = 4 * (gq * cpr + ((4 * p + 2 + (q >> 1)) ^ f)) + 2 * (q & 1);
#pragma unroll
    for (int rp = 0; rp < 2; ++rp) {
      const int r = 2 * q + rp, fr = swizzle(r);
      const int base = 4 * r * cpr + 2 * oc0 + (gq & 3);
      pb_hi[rp][p] = base + 4 * ((4 * p + (gq >> 2)) ^ fr);
      pb_lo[rp][p] = base + 4 * ((4 * p + 2 + (gq >> 2)) ^ fr);
    }
  }

  float acc[kMT][8][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n8][i] = 0.f;

  // The split pass's first chunk and steps (four depths of one row a
  // thread a step).
  const int v_first = threadIdx.x / rq, w_first = threadIdx.x % rq;
  const int v_step = blockDim.x / rq, w_step = blockDim.x % rq;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it has landed; the split tile and the slot of
                      // it − 1 are free; the ids of it + stages − 1 are in
    const int ahead = it + kStages - 1;
    if (ahead < n_tiles) stage(ahead, ahead % kStages);
    cp_async_commit();
    // the ids of tile it + stages, stored after the products
    const int next = it + kStages;
    const int next_id =
        GATHER && threadIdx.x < kStreamRows && next < n_tiles
            ? tile_id(next, threadIdx.x)
            : 0;

    // Split tile it: raw rows → (hi, lo) blocks of 8 depths, swizzled.
    const int sl = it % kStages;
    {
      const float4* src = raw + sl * kStreamRows * rq;
      for (int r = v_first, ch = w_first; r < kStreamRows;) {
        const float4 v = src[r * rq + ch];
        uint32_t h[4], l[4];
        split(v.x, h[0], l[0]);
        split(v.y, h[1], l[1]);
        split(v.z, h[2], l[2]);
        split(v.w, h[3], l[3]);
        const int c = 4 * (ch >> 1) + (ch & 1), f = swizzle(r);
        tile[r * cpr + (c ^ f)] =
            make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
        tile[r * cpr + ((c + 2) ^ f)] =
            make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
        r += v_step;
        ch += w_step;
        if (ch >= rq) {
          ch -= rq;
          ++r;
        }
      }
    }
    __syncthreads();  // the split tile is complete

    if (warp_live) {
      const float* t = reinterpret_cast<const float*>(tile);
      const float* st = stats + sl * kStatRows;
      const int col0 = it * kStreamRows;

      // S = own_rows · tᵀ, 32 × 32 a warp, k16 steps over the depth.
      float sc[kMT][4][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[m][n8][i] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < s8 / 2; ++kk) {
        uint32_t ah[kMT][2][4], al[kMT][2][4];  // [m][k8]
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float* f = afrag + 256 * (m * s8 + 2 * kk + k);
            lds128(ah[m][k], f);
            lds128(al[m][k], f + 4);
          }
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float* f = t + 32 * (cpr * n8 + kk);
            lds64(bh[k], f + sb_hi[k]);
            lds64(bl[k], f + sb_lo[k]);
          }
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            float part[4];
            mma3x2(part, ah[m], al[m], bh, bl);
#pragma unroll
            for (int i = 0; i < 4; ++i) sc[m][n8][i] += part[i];
          }
        }
      }

      // gw, in place: 0 on masked slots and past the bucket's end.
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * n8 + 2 * q + j;
          const bool live = col0 + col < n_str;
          const int* sti = reinterpret_cast<const int*>(st);
          float cl2 = 0.f, cg = 0.f;
          int ct;
          if (DY) {
            cl2 = st[col] * kLog2e;
            cg = st[kStreamRows + col];
            ct = sti[2 * kStreamRows + col];
          } else {
            ct = sti[col];
          }
#pragma unroll
          for (int m = 0; m < kMT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float& v = sc[m][n8][2 * h + j];
              // dY: ct is the position's target, tg the candidate's id;
              // dX: ct is the candidate's id, tg the position's target.
              const int cid = DY ? tg[m][h] : ct;
              const bool off = !live || cid < 0 || ct == tg[m][h];
              v = DY ? cotangent<CAP>(v, cl2, cg, off, a.cap)
                     : cotangent<CAP>(v, ls2[m][h], gs[m][h], off, a.cap);
            }
        }

      // acc += gw · t over the tile's 32 rows, k16 steps of the streamed
      // rows; gw's C fragment of n8 tile j is the A fragment of k8 step j.
      // All eight output n8 tiles unless the block's depth chunk is short.
      auto product = [&](auto full) {
        constexpr bool FULL = decltype(full)::value;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t gh[kMT][2][4], gl[kMT][2][4];  // [m][k8]
#pragma unroll
          for (int m = 0; m < kMT; ++m)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int j = 2 * kk + k;
              split(sc[m][j][0], gh[m][k][0], gl[m][k][0]);
              split(sc[m][j][2], gh[m][k][1], gl[m][k][1]);
              split(sc[m][j][1], gh[m][k][2], gl[m][k][2]);
              split(sc[m][j][3], gh[m][k][3], gl[m][k][3]);
            }
          const float* tj[2] = {t + 32 * cpr * (2 * kk),
                                t + 32 * cpr * (2 * kk + 1)};
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8) {
            if (FULL || n8 < n_out8) {
              uint32_t bh[2][2], bl[2][2];
#pragma unroll
              for (int k = 0; k < 2; ++k)
#pragma unroll
                for (int rp = 0; rp < 2; ++rp) {
                  const float* f = tj[k] + 32 * (n8 >> 1);
                  bh[k][rp] = __float_as_uint(f[pb_hi[rp][n8 & 1]]);
                  bl[k][rp] = __float_as_uint(f[pb_lo[rp][n8 & 1]]);
                }
#pragma unroll
              for (int m = 0; m < kMT; ++m) {
                float part[4];
                mma3x2(part, gh[m], gl[m], bh, bl);
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[m][n8][i] += part[i];
              }
            }
          }
        }
      };
      if (n_out8 == 8)
        product(std::true_type{});
      else
        product(std::false_type{});
    }
    if (GATHER && threadIdx.x < kStreamRows && next < n_tiles)
      ids[(next & 1) * kStreamRows + threadIdx.x] = next_id;
  }
  cp_async_wait<0>();

  // dX: the rows, written whole. dY: gathered, an atomic add into each
  // candidate's catalog row, skipped for a negative id (its sum is exactly
  // 0); DIRECT, a plain write of the bucket's own row (an explicit 0 for a
  // negative id), so that it repeats bit for bit. With 16-byte rows the
  // lanes q and q ^ 1 trade halves so that each writes four columns of
  // one row: the even lane row gq, the odd one gq + 8.
  auto put = [&](float* dst, int col, float v, bool zero) {
    if (!DY)
      dst[col] = v;
    else if (DIRECT)
      dst[col] = zero ? 0.f : v;
    else
      atomicAdd(dst + col, v);
  };
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const int rm = r0 + warp * kWarpRows + 16 * m + gq;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      if (n8 >= n_out8) break;
      float* c = acc[m][n8];
      if (a.vec_out) {
        const int h = q & 1;
        const float s0 = __shfl_xor_sync(kFull, h ? c[0] : c[2], 1);
        const float s1 = __shfl_xor_sync(kFull, h ? c[1] : c[3], 1);
        const float4 v = h ? make_float4(s0, s1, c[2], c[3])
                           : make_float4(c[0], c[1], s0, s1);
        const int id = h ? tg[m][1] : tg[m][0];
        const int col = oc0 + 8 * n8 + 4 * (q >> 1);
        if (rm + 8 * h >= n_own || col >= a.d || (DY && !DIRECT && id < 0))
          continue;
        float4* dst = reinterpret_cast<float4*>(
            a.out + (long)(h ? orow[m][1] : orow[m][0]) * a.d + col);
        if (!DY)
          *dst = v;
        else if (DIRECT)
          *dst = id < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : v;
        else
          atomicAdd(dst, v);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const int col = oc0 + 8 * n8 + 2 * q + (i & 1);
          if (rm + 8 * h >= n_own || col >= a.d ||
              (DY && !DIRECT && tg[m][h] < 0))
            continue;
          put(a.out + (long)orow[m][h] * a.d, col, c[i], tg[m][h] < 0);
        }
      }
    }
  }
}

// Opts `kernel` in to the full kMaxSmem of dynamic shared memory, once per
// device (the attribute is per device context); `done` is the caller's
// per-kernel table.
template <typename K>
cudaError_t allow_max_smem(K kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

bool shapes_ok(int n_b, int b_x, int b_y, int c, int d) {
  return n_b > 0 && b_x > 0 && b_y > 0 && c > 0 && d > 0 && d <= kMaxD &&
         (b_x + kTileX - 1) / kTileX <= 65535 &&
         (b_y + kTileY - 1) / kTileY <= 65535;
}

// Launches the forward with the positive or the partial LSE, gathered or
// DIRECT; `pos` and `loss` are null for the partial LSE, `idx_y` for
// DIRECT.
template <bool WITH_POS, bool DIRECT>
int launch_fwd(const float* x_b, const float* y, const int* idx_y,
               const int* tgt_b, const int* cand, const float* pos,
               float* loss, float* lse, int n_b, int b_x, int b_y, int c,
               int d, float cap, void* stream) {
  if (!shapes_ok(n_b, b_x, b_y, c, d)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(d);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  cudaError_t err =
      allow_max_smem(sce_gather_fwd_kernel<WITH_POS, DIRECT>, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_b, (b_x + kTileX - 1) / kTileX);
  sce_gather_fwd_kernel<WITH_POS, DIRECT>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x_b, y, idx_y, tgt_b, cand, pos, loss, lse, b_x, b_y, c, d, cap,
      vec_flag(x_b, d), vec_flag(y, d));
  return (int)cudaGetLastError();
}

// The backward's launch shape at depth d: warps a block (128 owned rows up
// to dp 128, 64 to dp 192, else 32) and shared memory: the owned
// fragments and the split tile (two floats a depth), the three raw
// stages (one), the stages' per-row inputs and the two-slot ids ring. At
// d ≤ 64 two blocks share an SM (2 · (smem + the 1 KB the SM reserves a
// block) ≤ its 228 KB); every d ≤ 256 fits one block. Mirrored by
// kernels/sce_prefetch.py::bwd_plan for the guard's preflight, and
// exported as sce_gather_bwd_plan so that the card checks the two agree.
struct BwdPlan {
  int warps;
  size_t smem;
};

BwdPlan bwd_plan(int d) {
  const int dp = padded_depth(d);
  const int warps = dp <= 128 ? 4 : (dp <= 192 ? 2 : 1);
  return {warps, (size_t)8 * dp * (kWarpRows * warps + kStreamRows) +
                     (size_t)4 * (dp + kStatRows / kStreamRows) *
                         kStreamRows * kStages +
                     (size_t)8 * kStreamRows};
}

// Launches dX (DY false) or dY on the tensor cores.
template <bool DY, bool DIRECT>
int launch_bwd(const float* x_b, const float* y, const int* idx_y,
               const int* tgt_b, const int* cand, const float* lse,
               const float* g, float* out, int n_b, int b_x, int b_y, int c,
               int d, float cap, void* stream) {
  if (!shapes_ok(n_b, b_x, b_y, c, d)) return (int)cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(d);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int bm = kWarpRows * p.warps;
  const long blocks = (long)n_b * (((DY ? b_y : b_x) + bm - 1) / bm);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int dp = padded_depth(d);
  const float* str = DY ? x_b : y;
  BwdArgs a{x_b, y, idx_y, tgt_b, cand, lse, g, out, b_x, b_y, c, d, dp,
            cap, vec_flag(str, d), vec_flag(DY ? y : x_b, d),
            vec_flag(out, d)};
  const dim3 grid((unsigned)blocks, (dp + kOutCols - 1) / kOutCols);
  auto go = [&](auto cp) {
    constexpr bool CP = decltype(cp)::value;
    static bool done[kMaxDevices] = {};
    cudaError_t err = allow_max_smem(sce_bwd_kernel<DY, DIRECT, CP>, done);
    if (err != cudaSuccess) return err;
    sce_bwd_kernel<DY, DIRECT, CP>
        <<<grid, 32 * p.warps, p.smem, static_cast<cudaStream_t>(stream)>>>(
        a);
    return cudaGetLastError();
  };
  return (int)(cap > 0.f ? go(std::true_type{}) : go(std::false_type{}));
}

}  // namespace

// The C interface, bound with ctypes. Shapes: x_b (n_b, b_x, d) f32,
// y (C, d) f32, idx_y and cand (n_b, b_y) i32, tgt_b, pos, lse, g, loss
// (n_b, b_x); all contiguous. `cap` > 0 is the logit softcap, 0 none.
// Each returns the cudaError_t of its launch (0 on success), and
// cudaErrorInvalidValue for shapes it does not take. Nothing is
// synchronised and nothing is allocated: dx (n_b, b_x, d) is written
// whole; dy (C, d) must arrive zeroed and is added into. dX and dY serve
// the partial LSE too, with the plse in place of the lse.
extern "C" int sce_gather_fwd_launch(const float* x_b, const float* y,
                                     const int* idx_y, const int* tgt_b,
                                     const int* cand, const float* pos,
                                     float* loss, float* lse, int n_b,
                                     int b_x, int b_y, int c, int d,
                                     float cap, void* stream) {
  return launch_fwd<true, false>(x_b, y, idx_y, tgt_b, cand, pos, loss, lse,
                                 n_b, b_x, b_y, c, d, cap, stream);
}

extern "C" int sce_gather_plse_fwd_launch(const float* x_b, const float* y,
                                          const int* idx_y,
                                          const int* tgt_b, const int* cand,
                                          float* plse, int n_b, int b_x,
                                          int b_y, int c, int d, float cap,
                                          void* stream) {
  return launch_fwd<false, false>(x_b, y, idx_y, tgt_b, cand, nullptr,
                                  nullptr, plse, n_b, b_x, b_y, c, d, cap,
                                  stream);
}

extern "C" int sce_gather_dx_launch(const float* x_b, const float* y,
                                    const int* idx_y, const int* tgt_b,
                                    const int* cand, const float* lse,
                                    const float* g, float* dx, int n_b,
                                    int b_x, int b_y, int c, int d,
                                    float cap, void* stream) {
  return launch_bwd<false, false>(x_b, y, idx_y, tgt_b, cand, lse, g, dx,
                                  n_b, b_x, b_y, c, d, cap, stream);
}

extern "C" int sce_gather_dy_launch(const float* x_b, const float* y,
                                    const int* idx_y, const int* tgt_b,
                                    const int* cand, const float* lse,
                                    const float* g, float* dy, int n_b,
                                    int b_x, int b_y, int c, int d,
                                    float cap, void* stream) {
  return launch_bwd<true, false>(x_b, y, idx_y, tgt_b, cand, lse, g, dy,
                                 n_b, b_x, b_y, c, d, cap, stream);
}

// The backward's plan at depth d: writes the warps a block, returns the
// dynamic shared memory of a block, or −cudaErrorInvalidValue for a d
// outside (0, 256].
extern "C" int sce_gather_bwd_plan(int d, int* warps) {
  if (d <= 0 || d > kMaxD) return -(int)cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(d);
  *warps = p.warps;
  return (int)p.smem;
}

// sce_bucket: the same kernels with direct addressing, over candidates
// pre-gathered per bucket. y_b (n_b, b_y, d) f32 takes the place of y and
// idx_y: candidate j of bucket n is row n·b_y + j of y_b. Shapes otherwise
// as above. dy_b (n_b, b_y, d) is written whole (no atomics, no zeroing
// needed): a candidate with a negative id gets an exact 0 row. Replaces
// `_fwd_kernel`, `_fwd_plse_kernel`, `_bwd_dx_kernel` and `_bwd_dy_kernel`
// of src/repro/kernels/sce_bucket.py.
namespace {

int direct_rows(int n_b, int b_y) {
  const long rows = (long)n_b * b_y;
  return rows > 0 && rows <= 0x7fffffffL ? (int)rows : 0;
}

}  // namespace

extern "C" int sce_bucket_fwd_launch(const float* x_b, const float* y_b,
                                     const int* tgt_b, const int* cand,
                                     const float* pos, float* loss,
                                     float* lse, int n_b, int b_x, int b_y,
                                     int d, float cap, void* stream) {
  return launch_fwd<true, true>(x_b, y_b, nullptr, tgt_b, cand, pos, loss,
                                lse, n_b, b_x, b_y, direct_rows(n_b, b_y), d,
                                cap, stream);
}

extern "C" int sce_bucket_plse_fwd_launch(const float* x_b, const float* y_b,
                                          const int* tgt_b, const int* cand,
                                          float* plse, int n_b, int b_x,
                                          int b_y, int d, float cap,
                                          void* stream) {
  return launch_fwd<false, true>(x_b, y_b, nullptr, tgt_b, cand, nullptr,
                                 nullptr, plse, n_b, b_x, b_y,
                                 direct_rows(n_b, b_y), d, cap, stream);
}

extern "C" int sce_bucket_dx_launch(const float* x_b, const float* y_b,
                                    const int* tgt_b, const int* cand,
                                    const float* lse, const float* g,
                                    float* dx, int n_b, int b_x, int b_y,
                                    int d, float cap, void* stream) {
  return launch_bwd<false, true>(x_b, y_b, nullptr, tgt_b, cand, lse, g, dx,
                                 n_b, b_x, b_y, direct_rows(n_b, b_y), d,
                                 cap, stream);
}

extern "C" int sce_bucket_dy_launch(const float* x_b, const float* y_b,
                                    const int* tgt_b, const int* cand,
                                    const float* lse, const float* g,
                                    float* dy_b, int n_b, int b_x, int b_y,
                                    int d, float cap, void* stream) {
  return launch_bwd<true, true>(x_b, y_b, nullptr, tgt_b, cand, lse, g,
                                dy_b, n_b, b_x, b_y, direct_rows(n_b, b_y),
                                d, cap, stream);
}
