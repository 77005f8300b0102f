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
// dY's rows are dy_b itself instead of a workspace summed into catalog
// rows (the entries at the end of this file; wrapped by
// src/repro_torch/kernels/sce_bucket.py).
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
// takes min(l − lse, 44), as linear_ce.cu's backward does. The forward
// computes every logit it folds with the arithmetic dX uses (below), so
// with the forward's lse l − lse ≤ 0 up to the rounding of the fold and
// the min never acts; it acts only for an lse supplied from outside that
// lies more than 44 below a logit, where the plain version's entry grows
// on towards inf while the kernels' stays at e^44 · g, so that their
// tensor-core sums stay finite (tests/test_torch_cuda.py holds every SCE
// family to the capped formula there). A masked slot is 0 by a select,
// never by a product: a partial-LSE row with no unmasked candidate has
// plse = −1e30, and its exp would be inf before the min.
//
// What bounds it on an H100. At the paper's training shape (n_b = 320
// buckets, b_x = 320 positions, b_y = 256 candidates, d = 64, C = 173,520)
// the forward's logits are 2·320·320·256·64 ≈ 3.36 GFLOP against ≈ 47 MB
// that must move (x_b, the gathered rows, the outputs; 0.014 ms at
// 3.35 TB/s) and 26.2 M exps (0.006 ms on the SFUs); dX and dY each
// recompute the logits and run a second product of the same size,
// 6.7 GFLOP. All three take their products on the tensor cores in 3xTF32
// (tf32x3_tile.cuh): three TF32 passes at the dense 495 TFLOP/s are
// 0.020 ms for the forward and 0.041 ms for dX or dY (as f32 FMAs at
// 67 TFLOP/s 0.050 and 0.100 ms), so the tensor cores bound them. 3xTF32
// keeps the f32 tolerance (about 2⁻²¹ relative per product, each k16
// step summed from zero; see linear_ce.cu).
//
// The same logits in the forward and dX. The forward takes positions as
// the A operand and candidates as B, with the (hi, lo) split, fragment
// layout, k order and k16 steps of sce_bwd_kernel's dX grid (mma3x2 of
// tf32x3_tile.cuh, each k16 step from zero and added in f32, then the
// softcap), so every logit it folds is the f32 number that dX's
// cotangent reads: the lse and the backward's exp(l − lse) come from one
// rounding: at x_b 3·randn the end-to-end dX is 0.95× the f32 plain
// version's error from f64, where an lse of f32 FMA logits gave 5× (on
// an H100, probes/sce_gather_times.py). dY's grid takes the same
// products with A and B swapped, which adds the two small terms of each
// k8 step in the other order (cand_lo·pos_hi, then cand_hi·pos_lo), so
// its logits are not always the same bits: on an H100, 0.032 % of
// 16.8 M logits at x_b 3·randn differ, by at most 7.6e-6
// (probes/sce_logits_order.py).
//
// Design of the forward: one kernel, sce_fwd_kernel, for the loss and the
// partial LSE (WITH_POS), gathered or DIRECT, with or without the cap.
// The TPU grid walks the candidates one row at a time on a sequential
// axis, gathering each row by scalar prefetch into a VMEM tile. Here a
// block of five warps owns 32 positions a warp of one bucket — half of
// the training shape's 320, grid 2·n_b = 640 blocks — and gathers the
// bucket's candidates once:
//   * the prologue loads the candidates' ids and source rows (cand_row:
//     clamp_row of idx_y, or n·b_y + j with DIRECT), then issues one batch
//     of cp.async (16-byte chunks, or 4-byte ones when d % 4 ≠ 0 or a row
//     is not 16-byte aligned) for the block's 160 positions and up to 256
//     candidate rows, which stay raw and resident, chunk c of row r at
//     chunk c ^ 2(r mod 4) so that a fragment's two depths are one
//     conflict-free LDS.64. One barrier, and the warps sweep every
//     resident candidate with no barrier inside the sweep.
//   * a warp computes a 32 × 64 logit tile at a time (384 `mma` at
//     d = 64), splitting each value into (hi, lo) as it loads a fragment
//     (two cvt.rna and an FADD; 16 positions' values a k16 step for 96
//     `mma`, 4 candidates' values for 12). Holding them split would double
//     the shared memory: with raw rows a block takes 108,544 bytes at
//     d = 64, so two blocks (ten warps) share an SM, and one block's
//     gather runs beside the other's sweep. Splitting nothing (wrong
//     results) left the time as it was; ten warps a bucket in one block of
//     231 KB were 10 % slower (PERF.md).
//   * it folds the tile in the accumulator registers, as linear_ce.cu's
//     forward does: the softcap, the mask by select (cand < 0, cand ==
//     target, past b_y), the tile's max first, then one exp2 of one FFMA
//     per logit. Lane q = 0 of a row starts from the positive, (pos, 1);
//     the others from (NEG_INF, 0). At the end the four lanes of a row
//     merge (m, s) in a fixed tree: no atomics, the forward repeats bit
//     for bit. loss = m + log s − pos; plse = m + log(max(s, 1e-30)), so
//     a row with every candidate masked is −1e30, never −inf.
//   * where b_y·d does not fit (d > 64 at b_y 256, or b_y > 256), the
//     candidates come in resident chunks (fwd_plan: up to ten warps, one
//     block an SM, 64 to 256 candidates a chunk above dp 64), each gathered
//     and synchronised the same way, its copies not overlapped with the
//     previous chunk's sweep. Every d ≤ 256 and any b_x, b_y launch. Rows
//     past b_x are not written.
//   * On an H100 at the training shape (ptxas, sm_90a: 168 registers, the
//     most that ten warps an SM allow, at most 12 bytes of spills; 640
//     blocks, two an SM, 2.42 waves of 264 block slots) the forward takes
//     ≈ 0.125 ms: a clock profile gives a block's warps ≈ 69k cycles, of
//     which the prologue's copies ≈ 13k and their wait ≈ 4k, the products
//     ≈ 44k (≈ 0.3 `mma` a cycle an SM, half of what `mma.sync` gives) and
//     the fold ≈ 8k; the last of three waves holds 112 blocks
//     (probes/sce_gather_times.py; PERF.md).
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
//   * dY writes, for each slot (bucket n, candidate j), the row n·b_y + j
//     of its output: for sce_bucket that is dy_b itself; for the gathered
//     kernels a (n_b·b_y, d) workspace (21 MB at the training shape),
//     which dy_sum_kernel then adds into the catalog's (C, d) per catalog
//     row in ascending (bucket, slot) order — the order of the reference's
//     sequential read-modify-write into its aliased output
//     (src/repro/kernels/sce_prefetch.py:245-250). The wrapper sorts the
//     slots' clamped rows stably (PyTorch glue) and zeroes the (C, d), so
//     rows no bucket selected come out exactly 0; a slot with a negative
//     id writes a 0 row and is keyed past the catalog, so the sum never
//     walks it (on a shard of the exact mode most slots are such). No
//     atomics anywhere: dX and both dYs repeat bit for bit, DIRECT's dX
//     equals the gathered one's on y_b = y[idx] (the same rows through the
//     same arithmetic), and the gathered dY is the in-order sum of
//     DIRECT's rows.
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
// Deep variants (the *_deep_launch entries), for d > 256, where the
// kernels above cannot keep their owned rows' fragments and a streamed
// tile over the whole depth in shared memory. They write the logits once:
//   * the logits L[n] = x_b[n] · Y[idx[n]]ᵀ (n_b, b_x, b_y) f32 into a
//     workspace, by deep_tc.cuh's product (positions as A, candidates
//     gathered by id as B, 3xTF32 k16 steps over depth chunks of 32, the
//     resident kernels' arithmetic; bf16 operands on its bf16 `wgmma`
//     product, gemm_bf16, the cotangent written as bf16 for dX's and
//     dY's products);
//   * the forward: fold_kernel, a warp per (bucket, position) row, folds
//     the row's softcapped, masked logits into the online (m, s) and
//     writes loss and lse (or the plse) as above;
//   * the backward (one entry for dX and dY, *_bwd_deep_launch)
//     recomputes L with the same product (the same bits, so the
//     forward's lse and the backward's exp(l − lse) come from one
//     rounding) and turns it into the cotangent G once (cotangent_kernel:
//     the softcap, the mask, the capped exp, g; f32 in place, or bf16
//     operands' G rounded once into a bf16 buffer of 16-byte rows); then
//     dX = G · Y[idx] and the slot rows Gᵀ · x_b, both read that one G,
//     by the same product, each a d-wide output tiled 128 columns a
//     block, no atomics: dX repeats bit for bit and the gathered dY's
//     workspace goes through dy_sum_kernel as above. A caller that wants
//     one of the two passes null for the other.
// The workspace is the SCE memory model's own n_b·b_x·b_y f32
// (SCEConfig.logit_tensor_elements): 67 MB at gemma-2's shape (n_b 128,
// b_x 128, b_y 1024). The forward writes and reads it once; the backward
// writes L, rewrites it as G and reads G twice, against three products
// of 2·n_b·b_x·b_y·d ≈ 77 GFLOP each at d 2304 — a byte of workspace
// traffic per ≈ 690 FLOP, so the products bound it, as they bound the
// resident kernels.
//
// bfloat16 operands (the entries' bf16_in): x_b and y are read as stored
// — widened to f32 where they land in the resident kernels' staging,
// taken as bf16 by the deep entries' bf16 `wgmma` (gemm_bf16) — and dX
// and dY round the cotangent to bf16 before their products, as the
// reference's gw.astype(tile.dtype). dX and dY's workspace are f32, dX
// rounded to bf16 once by the wrapper; the in-order sum writes a bf16
// catalog's rows as bf16, each f32 sum rounded once (the reference adds
// bf16 partials into dY).
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes in src/repro_torch/kernels/sce_prefetch.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "deep_tc.cuh"
#include "tf32x3_tile.cuh"

namespace {

using namespace tf32x3;

// 1 when rows of `a` (element size `elem`) can be copied four values at a
// time: d % 4 == 0 and 4·elem-byte aligned.
inline int vec_flag(const void* a, int d, int elem = 4) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % (4 * elem) == 0;
}


// A candidate id clamped to the catalog's rows [0, C).
__device__ __forceinline__ int clamp_row(int r, int c) {
  return r < 0 ? 0 : (r >= c ? c - 1 : r);
}

// ---------------------------------------------------------------------------
// Forward on the tensor cores (3xTF32): loss and lse (WITH_POS), or the
// partial LSE, of up to 32 · warps positions of one bucket.
// ---------------------------------------------------------------------------
constexpr int kFwdMaxWarps = 10;  // 320 positions: a bucket at b_x = 320
constexpr int kFwdTile = 64;      // candidates a warp folds at a time ...
constexpr int kFwdNT = kFwdTile / 8;  // ... as n8 tiles
constexpr int kFwdMaxRows = 256;  // resident candidates: a bucket at b_y 256

// One forward call. Without the positive, `pos` and `loss` are null.
struct FwdArgs {
  const void* x_b;    // (n_b, b_x, d), f32 or bf16 (T)
  const void* y;      // (C, d); DIRECT: y_b as (n_b·b_y, d); as x_b
  const int* idx_y;   // (n_b, b_y); null with DIRECT
  const int* tgt;     // (n_b, b_x)
  const int* cand;    // (n_b, b_y)
  const float* pos;   // (n_b, b_x)
  float* loss;        // (n_b, b_x)
  float* lse;         // (n_b, b_x)
  int b_x, b_y, c, d, dp;  // dp = d rounded up to 16
  float cap;
  int rows;   // resident candidates of a chunk, a multiple of kFwdTile
  int pitch;  // floats a resident candidate row: dp rounded up to 32
  int vec;    // the candidate rows can be copied in 16-byte chunks
  int vec_x;  // the position rows can be copied in 16-byte chunks
};

// Floats a resident candidate row takes: whole 128-byte lines, so that
// the swizzle below stays inside the row.
__host__ __device__ inline int fwd_pitch(int dp) {
  return (dp + 31) / 32 * 32;
}

// Where the 16-byte chunk ch (depths 4ch .. 4ch + 3) of resident candidate
// row r lies in the row: ch ^ 2·(r mod 4). A B fragment's two depths
// 8s + 2q, 8s + 2q + 1 are one LDS.64, and the 16 lanes of a half-warp
// (rows gq = 0..3, q = 0..3) then read the four 32-byte quarters of a
// 128-byte line: no bank conflicts.
__device__ __forceinline__ int fwd_chunk(int r, int ch) {
  return ch ^ (2 * (r & 3));
}

template <bool WITH_POS, bool DIRECT, bool CAP, typename T>
__global__ void __launch_bounds__(32 * kFwdMaxWarps, 1)
sce_fwd_kernel(FwdArgs a) {
  const T* const xb = static_cast<const T*>(a.x_b);
  const T* const yy = static_cast<const T*>(a.y);
  extern __shared__ float4 smem4[];
  const int dp = a.dp, s8 = dp / 8;
  const int warps = blockDim.x >> 5;
  const int bm = kWarpRows * warps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3;
  float* xr = reinterpret_cast<float*>(smem4);  // positions: bm × pitch
  float* cr = xr + bm * a.pitch;                 // candidates: rows × pitch
  int* cid = reinterpret_cast<int*>(cr + a.rows * a.pitch);  // rows
  int* crow = cid + a.rows;  // rows: the chunk's source rows

  // blockIdx.x = n · row_tiles + row tile: a bucket's blocks are
  // neighbours in the grid.
  const int row_tiles = (a.b_x + bm - 1) / bm;
  const int n = blockIdx.x / row_tiles;
  const int x0 = (blockIdx.x - n * row_tiles) * bm;  // first owned position
  const long xrow0 = (long)n * a.b_x;  // flat row of position 0
  const long crow0 = (long)n * a.b_y;  // flat index of candidate 0
  const int rq = dp / 4;  // 16-byte chunks of a candidate row

  // Resident rows [r_lo, r_hi) of dst from global memory by cp.async (a
  // bf16 row through registers, widened as stored): src(r) is row r's
  // source, null for a zero row; zeros past d. Thread i copies chunks i,
  // i + blockDim.x, ... in row order (four values a copy with vec, else
  // one), stepping without a division per copy.
  auto copy = [&](float* dst, int r_lo, int r_hi, int vec, auto src) {
    const int per = vec ? rq : dp;
    const int r_step = blockDim.x / per, c_step = blockDim.x % per;
    for (int r = r_lo + threadIdx.x / per, c = threadIdx.x % per;
         r < r_hi;) {
      const T* row = src(r);
      if (vec) {
        const bool ok = row != nullptr && 4 * c < a.d;
        copy4_to_f32(dst + r * a.pitch + 4 * fwd_chunk(r, c),
                     ok ? row + 4 * c : yy, ok, true);
      } else {
        const bool ok = row != nullptr && c < a.d;
        copy1_to_f32(dst + r * a.pitch + 4 * fwd_chunk(r, c >> 2) + (c & 3),
                     ok ? row + c : yy, ok);
      }
      r += r_step;
      c += c_step;
      if (c >= per) {
        c -= per;
        ++r;
      }
    }
  };
  // Candidates [j0, j0 + rows) of the bucket into shared memory: their
  // ids and source rows first (−1 past b_y), then the raw rows, zeros
  // past the bucket's end; with the first chunk, the block's positions
  // (zeros past b_x). One batch of copies; every thread calls, the caller
  // waits and synchronises.
  const int nx = min(bm, a.b_x - x0);
  auto stage = [&](int j0) {
    const int nr = min(a.rows, a.b_y - j0);
    const int nr_pad = (nr + kFwdTile - 1) / kFwdTile * kFwdTile;
    for (int r = threadIdx.x; r < nr_pad; r += blockDim.x) {
      const long j = crow0 + j0 + r;
      const bool ok = r < nr;
      cid[r] = ok ? a.cand[j] : -1;
      crow[r] = !ok ? -1 : (DIRECT ? (int)j : clamp_row(a.idx_y[j], a.c));
    }
    __syncthreads();
    if (j0 == 0)
      copy(xr, 0, bm, a.vec_x, [&](int r) -> const T* {
        return r < nx ? xb + (xrow0 + x0 + r) * a.d : nullptr;
      });
    copy(cr, 0, nr_pad, a.vec, [&](int r) -> const T* {
      return crow[r] < 0 ? nullptr : yy + (long)crow[r] * a.d;
    });
    cp_async_commit();
  };
  stage(0);

  // The warp's A fragments are split from its raw rows at each k16 step:
  // for m16 tile m and k8 step s, lane (gq, q) takes rows gq, gq + 8 at
  // depths 8s + 2q, 8s + 2q + 1 (one LDS.64 each), the values and order
  // of sce_bwd_kernel's dX fragments.
  const float* arow = xr + (warp * kWarpRows + gq) * a.pitch;
  const int sw = 2 * (gq & 3);  // fwd_chunk of every row a lane reads
  const bool warp_live = x0 + warp * kWarpRows < a.b_x;

  // Per owned row of the thread (m16 tile m, half h): the online (m, s)
  // over the thread's columns and the target; lane q = 0 of a row starts
  // from the positive, (pos, 1), the others from (NEG_INF, 0).
  float mx[kMT][2], sx[kMT][2], ps[kMT][2];
  int tg[kMT][2];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = x0 + warp * kWarpRows + 16 * m + 8 * h + gq;
      const bool live = r < a.b_x;
      tg[m][h] = live ? a.tgt[xrow0 + r] : -1;
      ps[m][h] = WITH_POS && live ? a.pos[xrow0 + r] : 0.f;
      mx[m][h] = WITH_POS && q == 0 ? ps[m][h] : kNegInf;
      sx[m][h] = WITH_POS && q == 0 ? 1.f : 0.f;
    }

  for (int j0 = 0; j0 < a.b_y; j0 += a.rows) {
    if (j0 > 0) {
      __syncthreads();  // every warp is done with the previous chunk
      stage(j0);
    }
    cp_async_wait<0>();
    __syncthreads();  // the chunk (and, first, the positions) is in
    if (!warp_live) continue;
    const int tiles = (min(a.rows, a.b_y - j0) + kFwdTile - 1) / kFwdTile;
    for (int t = 0; t < tiles; ++t) {
      // S = own rows · the tile's 64 candidates, k16 steps over the depth,
      // each from zero and added in f32 (sce_bwd_kernel's dX arithmetic).
      float sc[kMT][kFwdNT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int n8 = 0; n8 < kFwdNT; ++n8)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[m][n8][i] = 0.f;
      const float* trow = cr + (kFwdTile * t + gq) * a.pitch;
#pragma unroll 1
      for (int kk = 0; kk < s8 / 2; ++kk) {
        uint32_t ah[kMT][2][4], al[kMT][2][4];  // [m][k8]
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int ch = 4 * kk + 2 * k + (q >> 1);
            const float* f = arow + 16 * m * a.pitch + 4 * (ch ^ sw) +
                             2 * (q & 1);
            const float2 v0 = *reinterpret_cast<const float2*>(f);
            const float2 v1 =
                *reinterpret_cast<const float2*>(f + 8 * a.pitch);
            split(v0.x, ah[m][k][0], al[m][k][0]);
            split(v1.x, ah[m][k][1], al[m][k][1]);
            split(v0.y, ah[m][k][2], al[m][k][2]);
            split(v1.y, ah[m][k][3], al[m][k][3]);
          }
#pragma unroll
        for (int n8 = 0; n8 < kFwdNT; ++n8) {
          // B: candidate row 8·n8 + gq of the tile, depths 8s + 2q and
          // 8s + 2q + 1 of k8 step s = 2kk + k, split here.
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int ch = 4 * kk + 2 * k + (q >> 1);
            const float2 v = *reinterpret_cast<const float2*>(
                trow + 8 * n8 * a.pitch + 4 * (ch ^ sw) + 2 * (q & 1));
            split(v.x, bh[k][0], bl[k][0]);
            split(v.y, bh[k][1], bl[k][1]);
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

      // The online softmax in the C layout: the thread's columns of row
      // (m, h) are 8·n8 + 2q + j, in sc[m][n8][2h + j]. The softcap comes
      // before the mask; a masked slot is NEG_INF by a select, and its
      // exp2 is 0 against any finite max. A row whose columns here are
      // all masked (and had no finite max before) adds nothing.
      int ci[kFwdNT][2];
#pragma unroll
      for (int n8 = 0; n8 < kFwdNT; ++n8) {
        const int2 v = *reinterpret_cast<const int2*>(
            cid + kFwdTile * t + 8 * n8 + 2 * q);
        ci[n8][0] = v.x;
        ci[n8][1] = v.y;
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float tmax = kNegInf;
#pragma unroll
          for (int n8 = 0; n8 < kFwdNT; ++n8)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float& v = sc[m][n8][2 * h + j];
              const int id = ci[n8][j];
              const float l = CAP ? capped(v, a.cap) : v;
              v = id < 0 || id == tg[m][h] ? kNegInf : l;
              tmax = fmaxf(tmax, v);
            }
          const float mn = fmaxf(mx[m][h], tmax);
          if (mn != kNegInf) {
            const float mb = mn * kLog2e;
            float se = 0.f;
#pragma unroll
            for (int n8 = 0; n8 < kFwdNT; ++n8)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                se += exp_from(sc[m][n8][2 * h + j], mb);
            sx[m][h] = sx[m][h] * exp_diff(mx[m][h], mn) + se;
            mx[m][h] = mn;
          }
        }
    }
  }

  // Merge the four lanes of each row in a fixed tree (xor 1, then 2): the
  // result repeats bit for bit. Lane q = 0 writes the row.
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mi = mx[m][h], si = sx[m][h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float mo = __shfl_xor_sync(kFull, mi, o);
        const float so = __shfl_xor_sync(kFull, si, o);
        merge_ms(mi, si, mo, so);
      }
      const int r = x0 + warp * kWarpRows + 16 * m + 8 * h + gq;
      if (q != 0 || r >= a.b_x) continue;
      if constexpr (WITH_POS) {
        const float l = mi + logf(si);
        a.lse[xrow0 + r] = l;
        a.loss[xrow0 + r] = l - ps[m][h];
      } else {
        a.lse[xrow0 + r] = mi + logf(fmaxf(si, 1e-30f));
      }
    }
}

// ---------------------------------------------------------------------------
// dX and dY on the tensor cores (3xTF32).
// ---------------------------------------------------------------------------
constexpr float kMaxExp2 = 44.f * kLog2e;  // exp's argument capped at 44
constexpr int kBwdMaxWarps = 4;
constexpr int kStatRows = 3 * kStreamRows;  // a stage's per-row inputs
constexpr int kStages = 3;  // the raw ring: tile i + 2 lands while i computes

// One backward call. DY: the block owns candidates and streams positions;
// else it owns positions and streams candidates.
struct BwdArgs {
  const void* x_b;    // (n_b, b_x, d), f32 or bf16 (T)
  const void* y;      // (C, d); DIRECT: y_b as (n_b·b_y, d); as x_b
  const int* idx_y;   // (n_b, b_y); null with DIRECT
  const int* tgt;     // (n_b, b_x)
  const int* cand;    // (n_b, b_y)
  const float* lse;   // (n_b, b_x)
  const float* g;     // (n_b, b_x)
  float* out;         // dX (n_b, b_x, d); dY a row per slot (n_b·b_y, d)
  int b_x, b_y, c, d, dp;  // dp = d rounded up to 16
  float cap;
  int vec;      // the streamed rows can be copied in 16-byte chunks
  int vec_own;  // the owned rows can be copied in 16-byte chunks
  int vec_out;  // the output rows take 16-byte stores
};

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

template <bool DY, bool DIRECT, bool CAP, typename T>
__global__ void __launch_bounds__(32 * kBwdMaxWarps, 2)
sce_bwd_kernel(BwdArgs a) {
  constexpr bool GATHER = !DY && !DIRECT;  // streamed rows arrive by id
  // bf16 operands: the cotangent is rounded to bf16 before the second
  // product, as the reference's gw.astype(tile.dtype).
  constexpr bool ROUND_G = sizeof(T) == 2;
  const T* const xb = static_cast<const T*>(a.x_b);
  const T* const yy = static_cast<const T*>(a.y);
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
  auto str_row = [&](int t, int r) -> const T* {
    const int row = t * kStreamRows + r;
    if (DY) return xb + (xrow0 + row) * a.d;
    if (DIRECT) return yy + (crow0 + row) * a.d;
    return yy + (long)clamp_row(ids[(t & 1) * kStreamRows + r], a.c) * a.d;
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
        copy4_to_f32(dst + 4 * (r * rq + ch), ok ? str_row(t, r) + 4 * ch : xb,
                     ok, true);
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
        copy1_to_f32(dst + e, ok ? str_row(t, r) + k : xb, ok);
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
  // candidate's id (−1 past b_y). orow is the row of the output: the
  // position's, or the slot's n·b_y + j.
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
        orow[m][h] = live ? (int)(crow0 + r) : 0;
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
    const T* src_base = DY ? yy : xb;
    float* oraw = reinterpret_cast<float*>(tile);
    const int op = dp + 4;  // pitch: the rows of a fragment read spread
    if (a.vec_own) {
      for (int e = threadIdx.x; e < bm * rq; e += blockDim.x) {
        const int rr = e / rq, ch = e - rr * rq;
        const int row = own_row[rr];
        const bool ok = row >= 0 && 4 * ch < a.d;
        copy4_to_f32(oraw + rr * op + 4 * ch,
                     ok ? src_base + (long)row * a.d + 4 * ch : xb, ok, true);
      }
    } else {
      for (int e = threadIdx.x; e < bm * dp; e += blockDim.x) {
        const int rr = e / dp, k = e - rr * dp;
        const int row = own_row[rr];
        const bool ok = row >= 0 && k < a.d;
        copy1_to_f32(oraw + rr * op + k,
                     ok ? src_base + (long)row * a.d + k : xb, ok);
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
              if (ROUND_G) v = round_bf16(v);
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

  // dX: the rows, written whole. dY: each slot's row n·b_y + j written
  // whole, an explicit 0 for a negative id (DIRECT: dy_b itself; gathered:
  // the workspace that dy_sum_kernel adds into the catalog). No atomics:
  // both repeat bit for bit. With 16-byte rows the lanes q and q ^ 1 trade
  // halves so that each writes four columns of one row: the even lane row
  // gq, the odd one gq + 8.
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
        if (rm + 8 * h >= n_own || col >= a.d) continue;
        float4* dst = reinterpret_cast<float4*>(
            a.out + (long)(h ? orow[m][1] : orow[m][0]) * a.d + col);
        *dst = DY && id < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : v;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const int col = oc0 + 8 * n8 + 2 * q + (i & 1);
          if (rm + 8 * h >= n_own || col >= a.d) continue;
          a.out[(long)orow[m][h] * a.d + col] =
              DY && tg[m][h] < 0 ? 0.f : c[i];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dY of the gathered kernels: the workspace's slot rows summed into the
// catalog in the reference's order.
// ---------------------------------------------------------------------------
constexpr int kSumThreads = 256;
constexpr int kSumGroups = 4;  // 4-depth groups a thread, 32 groups apart

// keys: the n_slots catalog rows of the flat slots n·b_y + j (clamped to
// [0, C)), sorted, a slot that adds nothing (a negative id) keyed C so
// that it sorts last; order: the slot of each, ascending within a key (a
// stable sort). A warp per (sorted slot, segment of 128 four-depth
// groups) — lane l takes groups l, l + 32, l + 64, l + 96 of the
// segment, so each load of the warp is 512 contiguous bytes and four are
// in flight a thread — that starts a run of equal keys below C adds the
// run's workspace rows from 0 in ascending (bucket, slot) order — the
// order of the reference's read-modify-write into the aliased dY — and
// writes the catalog row once (TO bf16: each f32 sum rounded once). Rows
// no bucket selected keep the zeros the wrapper put there. On a shard of
// the distributed exact mode most slots are another shard's: keyed C,
// they cost no walk.
template <typename TO>
__global__ void __launch_bounds__(kSumThreads)
dy_sum_kernel(const float* __restrict__ ws, const int* __restrict__ keys,
              const long long* __restrict__ order, TO* __restrict__ dy,
              int n_slots, int d, int c, int vec) {
  const int dq = (d + 3) / 4;
  const int segs = (dq + 32 * kSumGroups - 1) / (32 * kSumGroups);
  const long w = ((long)blockIdx.x * kSumThreads + threadIdx.x) >> 5;
  if (w >= (long)n_slots * segs) return;  // warp-uniform
  const int p = (int)(w / segs);
  const int g0 = (int)(w - (long)p * segs) * 32 * kSumGroups +
                 (threadIdx.x & 31);
  const int key = keys[p];
  if (key < 0 || key >= c || (p > 0 && keys[p - 1] == key)) return;
  float acc[kSumGroups][4] = {};
  for (int i = p; i < n_slots && keys[i] == key; ++i) {
    const float* src = ws + order[i] * d;
#pragma unroll
    for (int u = 0; u < kSumGroups; ++u) {
      const int k = 4 * (g0 + 32 * u);
      if (k >= d) continue;
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(src + k);
        acc[u][0] += v.x;
        acc[u][1] += v.y;
        acc[u][2] += v.z;
        acc[u][3] += v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < d) acc[u][j] += src[k + j];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kSumGroups; ++u) {
    const int k = 4 * (g0 + 32 * u);
    if (k >= d) continue;
    TO* dst = dy + (long)key * d + k;
    if constexpr (sizeof(TO) == 2) {  // bf16: the f32 sum rounded once
      uint32_t b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = __float_as_uint(round_bf16(acc[u][j])) >> 16;
      if (vec) {
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < d) dst[j].bits = (uint16_t)b[j];
      }
    } else if (vec) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < d) dst[j] = acc[u][j];
    }
  }
}

// Flat rows n_b·b_x and slots n_b·b_y index with int.
bool shapes_ok(int n_b, int b_x, int b_y, int c, int d, bool deep = false) {
  return n_b > 0 && b_x > 0 && b_y > 0 && c > 0 && d > 0 &&
         (deep || d <= kMaxD) && (long)n_b * b_x <= 0x7fffffffL &&
         (long)n_b * b_y <= 0x7fffffffL;
}

// The forward's launch shape at depth d: warps a block (32 positions
// each) and the candidates resident at a time, with its shared memory —
// the positions' and candidates' raw rows (4 bytes a depth at the pitch
// of fwd_pitch) and the candidates' ids and source rows. Up to dp 64 five
// warps and 256 candidates (a whole bucket at b_y 256), 108,544 bytes at
// d = 64, so that two blocks share an SM (each block's gather then runs
// beside the other's sweep; half of a bucket's 320 positions a block).
// Above, one block an SM: the most warps (up to ten) that leave room for
// a 64-candidate chunk. Mirrored by kernels/sce_prefetch.py::fwd_plan for
// the guard's preflight, and exported as sce_gather_fwd_plan.
constexpr int kSmSmem = 233472;  // an SM's shared memory (228 KB), ...
constexpr int kBlockSmem = 1024;  // ... of which each block reserves 1 KB

struct FwdPlan {
  int warps;
  int rows;
  size_t smem;
};

FwdPlan fwd_plan(int d) {
  const int dp = padded_depth(d);
  const size_t row = (size_t)4 * fwd_pitch(dp) + 8;  // a candidate's bytes
  const size_t pos = (size_t)4 * fwd_pitch(dp) * kWarpRows;  // a warp's
  const size_t two = 5 * pos + row * kFwdMaxRows;
  if (2 * (two + kBlockSmem) <= (size_t)kSmSmem) return {5, kFwdMaxRows, two};
  for (int w = kFwdMaxWarps; w > 1; --w) {
    const size_t own = pos * w;
    if (own + row * kFwdTile > (size_t)kMaxSmem) continue;
    int rows = (int)(((size_t)kMaxSmem - own) / row) / kFwdTile * kFwdTile;
    rows = rows < kFwdMaxRows ? rows : kFwdMaxRows;
    return {w, rows, own + row * rows};
  }
  return {1, kFwdTile, pos + row * kFwdTile};
}

// Launches the forward with the positive or the partial LSE, gathered or
// DIRECT; `pos` and `loss` are null for the partial LSE, `idx_y` for
// DIRECT.
template <bool WITH_POS, bool DIRECT>
int launch_fwd(const void* x_b, const void* y, const int* idx_y,
               const int* tgt_b, const int* cand, const float* pos,
               float* loss, float* lse, int n_b, int b_x, int b_y, int c,
               int d, float cap, int bf16_in, void* stream) {
  if (!shapes_ok(n_b, b_x, b_y, c, d)) return (int)cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(d);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int bm = kWarpRows * p.warps;
  const long blocks = (long)n_b * ((b_x + bm - 1) / bm);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int dp = padded_depth(d);
  const int elem = bf16_in ? 2 : 4;
  FwdArgs a{x_b, y, idx_y, tgt_b, cand, pos, loss, lse, b_x, b_y, c, d, dp,
            cap, p.rows, fwd_pitch(dp), vec_flag(y, d, elem),
            vec_flag(x_b, d, elem)};
  auto go = [&](auto cp, auto t) {
    constexpr bool CP = decltype(cp)::value;
    using T = decltype(t);
    static bool done[kMaxDevices] = {};
    cudaError_t err =
        allow_max_smem(sce_fwd_kernel<WITH_POS, DIRECT, CP, T>, done);
    if (err != cudaSuccess) return err;
    sce_fwd_kernel<WITH_POS, DIRECT, CP, T>
        <<<(unsigned)blocks, 32 * p.warps, p.smem,
           static_cast<cudaStream_t>(stream)>>>(a);
    return cudaGetLastError();
  };
  return (int)by_dtype(bf16_in, [&](auto t) {
    return cap > 0.f ? go(std::true_type{}, t) : go(std::false_type{}, t);
  });
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
int launch_bwd(const void* x_b, const void* y, const int* idx_y,
               const int* tgt_b, const int* cand, const float* lse,
               const float* g, float* out, int n_b, int b_x, int b_y, int c,
               int d, float cap, int bf16_in, void* stream) {
  if (!shapes_ok(n_b, b_x, b_y, c, d)) return (int)cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(d);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int bm = kWarpRows * p.warps;
  const long blocks = (long)n_b * (((DY ? b_y : b_x) + bm - 1) / bm);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int dp = padded_depth(d);
  const void* str = DY ? x_b : y;
  const int elem = bf16_in ? 2 : 4;
  BwdArgs a{x_b, y, idx_y, tgt_b, cand, lse, g, out, b_x, b_y, c, d, dp,
            cap, vec_flag(str, d, elem), vec_flag(DY ? y : x_b, d, elem),
            vec_flag(out, d)};
  const dim3 grid((unsigned)blocks, (dp + kOutCols - 1) / kOutCols);
  auto go = [&](auto cp, auto t) {
    constexpr bool CP = decltype(cp)::value;
    using T = decltype(t);
    static bool done[kMaxDevices] = {};
    cudaError_t err =
        allow_max_smem(sce_bwd_kernel<DY, DIRECT, CP, T>, done);
    if (err != cudaSuccess) return err;
    sce_bwd_kernel<DY, DIRECT, CP, T>
        <<<grid, 32 * p.warps, p.smem, static_cast<cudaStream_t>(stream)>>>(
        a);
    return cudaGetLastError();
  };
  return (int)by_dtype(bf16_in, [&](auto t) {
    return cap > 0.f ? go(std::true_type{}, t) : go(std::false_type{}, t);
  });
}

// ---------------------------------------------------------------------------
// Deep variants: the logits written once into a workspace.
// ---------------------------------------------------------------------------
constexpr int kFoldWarps = 8;

// deep_tc's product, with this library's table of its shared-memory
// opt-in for each instantiation.
template <bool A_KM, bool B_KN, bool GATHER, typename TA, typename TB>
cudaError_t tc_gemm(const deep_tc::Gemm& g, long batch, cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  return deep_tc::gemm<A_KM, B_KN, GATHER, false, TA, TB>(g, batch, s,
                                                           done);
}

// deep_tc's bf16 product (gemm_bf16: bf16 × bf16 at the bf16 rate), with
// its own opt-in table.
template <bool A_KM, bool B_KN, bool GATHER>
cudaError_t bf16_gemm(const deep_tc::Gemm& g, long batch, cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  return deep_tc::gemm_bf16<A_KM, B_KN, GATHER, false>(g, batch, s, done);
}

// The bf16 cotangent's row pitch: b_y rounded up to 8 values, so that its
// rows start 16-byte aligned and the products take G by TMA.
__host__ __device__ inline int g_pitch(int b_y) {
  return (b_y + 7) / 8 * 8;
}

// The logits L (n_b, b_x, b_y) of every bucket into ws: candidates
// gathered by clamped id (or row n·b_y + j with DIRECT); x_b and y of
// element type T.
template <bool DIRECT, typename T>
cudaError_t deep_logits(const void* x_b, const void* y, const int* idx_y,
                        float* ws, int n_b, int b_x, int b_y, int c, int d,
                        cudaStream_t s) {
  deep_tc::Gemm g{};
  g.a = x_b;
  g.a_batch = (long)b_x * d;
  g.lda = d;
  g.b = y;
  g.ldb = d;
  if (DIRECT) {
    g.b_batch = (long)b_y * d;
  } else {
    g.b_idx = idx_y;
    g.idx_batch = b_y;
    g.b_rows = c;
  }
  g.out = ws;
  g.out_batch = (long)b_x * b_y;
  g.ldo = b_y;
  g.m = b_x;
  g.n = b_y;
  g.k = d;
  if constexpr (sizeof(T) == 2)
    return bf16_gemm<false, false, !DIRECT>(g, n_b, s);
  else
    return tc_gemm<false, false, !DIRECT, T, T>(g, n_b, s);
}

// The forward's fold of row blockIdx.x · kFoldWarps + warp: the online
// (m, s) of its unmasked, softcapped logits (lanes stride the row, then a
// fixed shuffle tree); with the positive, (pos, 1) merged last, loss =
// lse − pos; without, plse = m + log(max(s, 1e-30)).
template <bool WITH_POS, bool CAP>
__global__ void __launch_bounds__(32 * kFoldWarps)
fold_kernel(const float* __restrict__ ws, const int* __restrict__ tgt,
            const int* __restrict__ cand, const float* __restrict__ pos,
            float* __restrict__ loss, float* __restrict__ lse, long rows,
            int b_x, int b_y, float cap) {
  const long row = (long)blockIdx.x * kFoldWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int t = tgt[row];
  const float* l = ws + row * b_y;
  const int* cd = cand + (row / b_x) * b_y;
  float m = kNegInf, s = 0.f;
  for (int j = lane; j < b_y; j += 32) {
    const int id = cd[j];
    if (id < 0 || id == t) continue;
    const float v = CAP ? capped(l[j], cap) : l[j];
    if (v > m) {
      s = s * exp_diff(m, v) + 1.f;
      m = v;
    } else {
      s += exp_diff(v, m);
    }
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(kFull, m, o);
    const float so = __shfl_xor_sync(kFull, s, o);
    merge_ms(m, s, mo, so);
  }
  if (lane != 0) return;
  if constexpr (WITH_POS) {
    const float p = pos[row];
    merge_ms(m, s, p, 1.f);
    const float l2 = m + logf(s);
    lse[row] = l2;
    loss[row] = l2 - p;
  } else {
    lse[row] = m + logf(fmaxf(s, 1e-30f));
  }
}

// ws (n_b, b_x, b_y) logits → the cotangent gw (cotangent<CAP>: 0 where
// masked, else exp(min(l − lse, 44))·cap′·g): f32 in place, or (BF) for
// bf16 operands rounded to bf16 once, as the reference's
// gw.astype(tile.dtype), into gb (n_b·b_x rows at pitch g_pitch(b_y)) —
// the logits stay in ws.
// A block per (bucket, position) row at a time, its threads along the
// row.
template <bool CAP, bool BF>
__global__ void __launch_bounds__(256)
cotangent_kernel(float* __restrict__ ws, bf16* __restrict__ gb,
                 const int* __restrict__ tgt, const int* __restrict__ cand,
                 const float* __restrict__ lse, const float* __restrict__ g,
                 long rows, int b_x, int b_y, float cap) {
  const int ldg = g_pitch(b_y);
  for (long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int t = tgt[row];
    const float l2 = lse[row] * kLog2e, gr = g[row];
    const int* const cd = cand + (row / b_x) * b_y;
    float* const w = ws + row * b_y;
    for (int j = threadIdx.x; j < b_y; j += blockDim.x) {
      const int id = cd[j];
      const float v = cotangent<CAP>(w[j], l2, gr, id < 0 || id == t, cap);
      if (BF)
        gb[row * ldg + j].bits =
            (uint16_t)(__float_as_uint(round_bf16(v)) >> 16);
      else
        w[j] = v;
    }
  }
}

template <bool WITH_POS, bool DIRECT>
int launch_fwd_deep(const void* x_b, const void* y, const int* idx_y,
                    const int* tgt_b, const int* cand, const float* pos,
                    float* loss, float* lse, float* ws, int n_b, int b_x,
                    int b_y, int c, int d, float cap, int bf16_in,
                    void* stream) {
  if (!shapes_ok(n_b, b_x, b_y, c, d, true) || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = by_dtype(bf16_in, [&](auto t) {
    return deep_logits<DIRECT, decltype(t)>(x_b, y, idx_y, ws, n_b, b_x, b_y,
                                            c, d, s);
  });
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)n_b * b_x;
  const unsigned blocks = (unsigned)((rows + kFoldWarps - 1) / kFoldWarps);
  if (cap > 0.f)
    fold_kernel<WITH_POS, true><<<blocks, 32 * kFoldWarps, 0, s>>>(
        ws, tgt_b, cand, pos, loss, lse, rows, b_x, b_y, cap);
  else
    fold_kernel<WITH_POS, false><<<blocks, 32 * kFoldWarps, 0, s>>>(
        ws, tgt_b, cand, pos, loss, lse, rows, b_x, b_y, cap);
  return (int)cudaGetLastError();
}

// dX into dx and dY's slot rows into dy (either may be null, not both)
// from one cotangent: the logits recomputed into ws and turned into the
// cotangent once (f32 in ws; bf16 operands: bf16 into gws), then each
// product reads it.
template <bool DIRECT, typename T>
int launch_bwd_deep(const void* x_b, const void* y, const int* idx_y,
                    const int* tgt_b, const int* cand, const float* lse,
                    const float* g, float* dx, float* dy, float* ws,
                    void* gws, int n_b, int b_x, int b_y, int c, int d,
                    float cap, void* stream) {
  constexpr bool BF = sizeof(T) == 2;
  if (!shapes_ok(n_b, b_x, b_y, c, d, true) || ws == nullptr ||
      (BF && gws == nullptr) || (dx == nullptr && dy == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* const gb = static_cast<bf16*>(gws);
  cudaError_t err =
      deep_logits<DIRECT, T>(x_b, y, idx_y, ws, n_b, b_x, b_y, c, d, s);
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)n_b * b_x;
  const unsigned blocks = (unsigned)(rows < (1L << 20) ? rows : 1L << 20);
  if (cap > 0.f)
    cotangent_kernel<true, BF><<<blocks, 256, 0, s>>>(
        ws, gb, tgt_b, cand, lse, g, rows, b_x, b_y, cap);
  else
    cotangent_kernel<false, BF><<<blocks, 256, 0, s>>>(
        ws, gb, tgt_b, cand, lse, g, rows, b_x, b_y, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ldg = BF ? g_pitch(b_y) : b_y;
  deep_tc::Gemm p{};
  p.a = BF ? static_cast<const void*>(gb) : ws;
  p.a_batch = (long)b_x * ldg;
  p.lda = ldg;
  p.ldb = d;
  p.ldo = d;
  p.n = d;
  if (dx != nullptr) {  // dX[n, x] = Σ_j G[x][j]·Y[idx[n, j]]
    deep_tc::Gemm q = p;
    q.out = dx;
    q.b = y;
    if (DIRECT) {
      q.b_batch = (long)b_y * d;
    } else {
      q.b_idx = idx_y;
      q.idx_batch = b_y;
      q.b_rows = c;
    }
    q.out_batch = (long)b_x * d;
    q.m = b_x;
    q.k = b_y;
    if constexpr (BF)
      err = bf16_gemm<false, true, !DIRECT>(q, n_b, s);
    else
      err = tc_gemm<false, true, !DIRECT, float, T>(q, n_b, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (dy != nullptr) {  // slot rows n·b_y + j: Σ_x G[x][j]·x_b[n, x]
    p.out = dy;
    p.b = x_b;
    p.b_batch = (long)b_x * d;
    p.out_batch = (long)b_y * d;
    p.m_zero = cand;  // a negative id's row is an exact 0
    p.mz_batch = b_y;
    p.m = b_y;
    p.k = b_x;
    if constexpr (BF)
      err = bf16_gemm<true, true, false>(p, n_b, s);
    else
      err = tc_gemm<true, true, false, float, T>(p, n_b, s);
  }
  return (int)err;
}

}  // namespace

// The deep entries: as their resident namesakes below, for any d > 0, with
// `ws` an (n_b, b_x, b_y) f32 workspace for the logits.
extern "C" int sce_gather_fwd_deep_launch(
    const void* x_b, const void* y, const int* idx_y, const int* tgt_b,
    const int* cand, const float* pos, float* loss, float* lse, float* ws,
    int n_b, int b_x, int b_y, int c, int d, float cap, int bf16_in, void* stream) {
  return launch_fwd_deep<true, false>(x_b, y, idx_y, tgt_b, cand, pos, loss,
                                      lse, ws, n_b, b_x, b_y, c, d, cap,
                                      bf16_in, stream);
}

extern "C" int sce_gather_plse_fwd_deep_launch(
    const void* x_b, const void* y, const int* idx_y, const int* tgt_b,
    const int* cand, float* plse, float* ws, int n_b, int b_x, int b_y,
    int c, int d, float cap, int bf16_in, void* stream) {
  return launch_fwd_deep<false, false>(x_b, y, idx_y, tgt_b, cand, nullptr,
                                       nullptr, plse, ws, n_b, b_x, b_y, c,
                                       d, cap, bf16_in, stream);
}

// dX into dx and dY's slot rows into dy (n_b·b_y, d), either null when
// not wanted: the logits written into ws and their cotangent once — in
// ws, or with bf16_in into gws, (n_b·b_x, ⌈b_y / 8⌉·8) bf16 (null for
// f32 operands).
extern "C" int sce_gather_bwd_deep_launch(
    const void* x_b, const void* y, const int* idx_y, const int* tgt_b,
    const int* cand, const float* lse, const float* g, float* dx, float* dy,
    float* ws, void* gws, int n_b, int b_x, int b_y, int c, int d,
    float cap, int bf16_in, void* stream) {
  return (int)by_dtype(bf16_in, [&](auto t) {
    return launch_bwd_deep<false, decltype(t)>(x_b, y, idx_y, tgt_b, cand,
                                               lse, g, dx, dy, ws, gws, n_b,
                                               b_x, b_y, c, d, cap, stream);
  });
}

// The C interface, bound with ctypes. Shapes: x_b (n_b, b_x, d) and
// y (C, d) f32, or both bfloat16 when `bf16_in` is nonzero (dX and dY then
// take the cotangent rounded to bf16; every output is f32), idx_y and
// cand (n_b, b_y) i32, tgt_b, pos, lse, g, loss (n_b, b_x) f32; all
// contiguous. `cap` > 0 is the logit softcap, 0 none.
// Each returns the cudaError_t of its launch (0 on success), and
// cudaErrorInvalidValue for shapes it does not take. Nothing is
// synchronised and nothing is allocated: dx (n_b, b_x, d) is written
// whole; sce_gather_dy_launch writes its `dy` as a workspace of one row
// per slot, (n_b·b_y, d) (0 for a negative id), which
// sce_gather_dy_sum_launch then adds into the catalog's (C, d). dX and dY
// serve the partial LSE too, with the plse in place of the lse.
extern "C" int sce_gather_fwd_launch(const void* x_b, const void* y,
                                     const int* idx_y, const int* tgt_b,
                                     const int* cand, const float* pos,
                                     float* loss, float* lse, int n_b,
                                     int b_x, int b_y, int c, int d,
                                     float cap, int bf16_in, void* stream) {
  return launch_fwd<true, false>(x_b, y, idx_y, tgt_b, cand, pos, loss, lse,
                                 n_b, b_x, b_y, c, d, cap, bf16_in, stream);
}

extern "C" int sce_gather_plse_fwd_launch(const void* x_b, const void* y,
                                          const int* idx_y,
                                          const int* tgt_b, const int* cand,
                                          float* plse, int n_b, int b_x,
                                          int b_y, int c, int d, float cap, int bf16_in,
                                          void* stream) {
  return launch_fwd<false, false>(x_b, y, idx_y, tgt_b, cand, nullptr,
                                  nullptr, plse, n_b, b_x, b_y, c, d, cap,
                                  bf16_in, stream);
}

extern "C" int sce_gather_dx_launch(const void* x_b, const void* y,
                                    const int* idx_y, const int* tgt_b,
                                    const int* cand, const float* lse,
                                    const float* g, float* dx, int n_b,
                                    int b_x, int b_y, int c, int d,
                                    float cap, int bf16_in, void* stream) {
  return launch_bwd<false, false>(x_b, y, idx_y, tgt_b, cand, lse, g, dx,
                                  n_b, b_x, b_y, c, d, cap, bf16_in, stream);
}

extern "C" int sce_gather_dy_launch(const void* x_b, const void* y,
                                    const int* idx_y, const int* tgt_b,
                                    const int* cand, const float* lse,
                                    const float* g, float* dy, int n_b,
                                    int b_x, int b_y, int c, int d,
                                    float cap, int bf16_in, void* stream) {
  return launch_bwd<true, false>(x_b, y, idx_y, tgt_b, cand, lse, g, dy,
                                 n_b, b_x, b_y, c, d, cap, bf16_in, stream);
}

// The forward's plan at depth d: writes the warps a block and the
// candidates resident at a time, returns the dynamic shared memory of a
// block, or −cudaErrorInvalidValue for a d outside (0, 256].
extern "C" int sce_gather_fwd_plan(int d, int* warps, int* rows) {
  if (d <= 0 || d > kMaxD) return -(int)cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(d);
  *warps = p.warps;
  *rows = p.rows;
  return (int)p.smem;
}

// The gathered dY's second step: dy (C, d), zeroed, receives the sum of
// the workspace ws (n_slots, d) — the slots' rows that sce_gather_dy_launch
// wrote — per catalog row, in ascending slot order. keys (n_slots,) i32
// are the slots' clamped catalog rows, C for a slot that adds nothing,
// sorted; order (n_slots,) i64 the slot of each from a stable sort. dy
// is f32, or bf16 with bf16_out (each row's f32 sum rounded once).
extern "C" int sce_gather_dy_sum_launch(const float* ws, const int* keys,
                                        const long long* order, void* dy,
                                        int n_slots, int d, int c,
                                        int bf16_out, void* stream) {
  if (n_slots <= 0 || d <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const int segs = ((d + 3) / 4 + 32 * kSumGroups - 1) / (32 * kSumGroups);
  const long threads = (long)n_slots * segs * 32;
  const long blocks = (threads + kSumThreads - 1) / kSumThreads;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dy) % (bf16_out ? 8 : 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_out)
    dy_sum_kernel<<<(unsigned)blocks, kSumThreads, 0, s>>>(
        ws, keys, order, static_cast<bf16*>(dy), n_slots, d, c, vec);
  else
    dy_sum_kernel<<<(unsigned)blocks, kSumThreads, 0, s>>>(
        ws, keys, order, static_cast<float*>(dy), n_slots, d, c, vec);
  return (int)cudaGetLastError();
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
// pre-gathered per bucket. y_b (n_b, b_y, d), in x_b's element type, takes the place of y and
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

extern "C" int sce_bucket_fwd_launch(const void* x_b, const void* y_b,
                                     const int* tgt_b, const int* cand,
                                     const float* pos, float* loss,
                                     float* lse, int n_b, int b_x, int b_y,
                                     int d, float cap, int bf16_in, void* stream) {
  return launch_fwd<true, true>(x_b, y_b, nullptr, tgt_b, cand, pos, loss,
                                lse, n_b, b_x, b_y, direct_rows(n_b, b_y), d,
                                cap, bf16_in, stream);
}

extern "C" int sce_bucket_plse_fwd_launch(const void* x_b, const void* y_b,
                                          const int* tgt_b, const int* cand,
                                          float* plse, int n_b, int b_x,
                                          int b_y, int d, float cap, int bf16_in,
                                          void* stream) {
  return launch_fwd<false, true>(x_b, y_b, nullptr, tgt_b, cand, nullptr,
                                 nullptr, plse, n_b, b_x, b_y,
                                 direct_rows(n_b, b_y), d, cap, bf16_in, stream);
}

extern "C" int sce_bucket_dx_launch(const void* x_b, const void* y_b,
                                    const int* tgt_b, const int* cand,
                                    const float* lse, const float* g,
                                    float* dx, int n_b, int b_x, int b_y,
                                    int d, float cap, int bf16_in, void* stream) {
  return launch_bwd<false, true>(x_b, y_b, nullptr, tgt_b, cand, lse, g, dx,
                                 n_b, b_x, b_y, direct_rows(n_b, b_y), d,
                                 cap, bf16_in, stream);
}

extern "C" int sce_bucket_dy_launch(const void* x_b, const void* y_b,
                                    const int* tgt_b, const int* cand,
                                    const float* lse, const float* g,
                                    float* dy_b, int n_b, int b_x, int b_y,
                                    int d, float cap, int bf16_in, void* stream) {
  return launch_bwd<true, true>(x_b, y_b, nullptr, tgt_b, cand, lse, g,
                                dy_b, n_b, b_x, b_y, direct_rows(n_b, b_y),
                                d, cap, bf16_in, stream);
}

extern "C" int sce_bucket_fwd_deep_launch(
    const void* x_b, const void* y_b, const int* tgt_b, const int* cand,
    const float* pos, float* loss, float* lse, float* ws, int n_b, int b_x,
    int b_y, int d, float cap, int bf16_in, void* stream) {
  return launch_fwd_deep<true, true>(x_b, y_b, nullptr, tgt_b, cand, pos,
                                     loss, lse, ws, n_b, b_x, b_y,
                                     direct_rows(n_b, b_y), d, cap, bf16_in, stream);
}

extern "C" int sce_bucket_plse_fwd_deep_launch(
    const void* x_b, const void* y_b, const int* tgt_b, const int* cand,
    float* plse, float* ws, int n_b, int b_x, int b_y, int d, float cap, int bf16_in,
    void* stream) {
  return launch_fwd_deep<false, true>(x_b, y_b, nullptr, tgt_b, cand,
                                      nullptr, nullptr, plse, ws, n_b, b_x,
                                      b_y, direct_rows(n_b, b_y), d, cap,
                                      bf16_in, stream);
}

extern "C" int sce_bucket_bwd_deep_launch(
    const void* x_b, const void* y_b, const int* tgt_b, const int* cand,
    const float* lse, const float* g, float* dx, float* dy_b, float* ws,
    void* gws, int n_b, int b_x, int b_y, int d, float cap, int bf16_in,
    void* stream) {
  return (int)by_dtype(bf16_in, [&](auto t) {
    return launch_bwd_deep<true, decltype(t)>(
        x_b, y_b, nullptr, tgt_b, cand, lse, g, dx, dy_b, ws, gws, n_b, b_x,
        b_y, direct_rows(n_b, b_y), d, cap, stream);
  });
}
