// linear_ce — full-catalog cross-entropy streamed over the catalog, forward
// and backward, written by hand for Hopper (sm_90a). The (N, C) logits
// never exist in device memory.
//
// Replaces two Pallas TPU kernel families that compute the same tiles:
//   * `linear_ce_loss` of src/repro/kernels/linear_sce.py: `_fwd_kernel`
//     (the (m, s, pos) sweep, the positive plucked with col == target,
//     the softcap in the tile), `_bwd_dx_kernel` and `_bwd_dw_kernel`;
//   * `fused_lse` of src/repro/kernels/fused_ce.py: `_lse_kernel`,
//     `_bwd_dx_kernel` and `_bwd_dy_kernel` (no positive, no cap; the
//     wrapper gathers the positive outside).
// With no cap, the linear forward is the LSE sweep plus the pluck, and its
// backward cotangent is fused_ce's minus the one-hot, so three kernels,
// templated on PLUCK (in-sweep positive and one-hot) and CAP, serve both.
// For row r of x (N, d), catalog row j of w (C, d), cap > 0 or none:
//
//   l[r, j]  = cap·tanh(x[r]·w[j] / cap)          (no cap: the plain dot)
//   lse[r]   = log Σ_j exp(l[r, j])
//   loss[r]  = lse[r] − l[r, tgt[r]]               (PLUCK; 0 if tgt ∉ [0, C))
//   gw[r, j] = (exp(l[r, j] − lse[r]) − [j == tgt[r]]) · (1 − (l/cap)²) · g[r]
//   dX[r]    = Σ_j gw[r, j] · w[j]
//   dW[j]    = Σ_r gw[r, j] · x[r]
//
// One deviation from the plain version (kernels/ref.py), in dX and dW
// only: their exp takes min(l − lse, 44). With the lse of the same
// logits, l − lse ≤ 0 and the min never acts. Given an lse more than 44
// below a logit, the plain version's entry grows on towards inf, while
// the kernels' stays at e^44 · g, so that their tensor-core sums stay
// finite (tests/test_torch_cuda.py holds this regime against the capped
// formula).
//
// The softcap applies before the mask of the ragged last tile, as on the
// TPU (linear_sce.py:84-87): a padded column stays at NEG_INF, never −cap.
//
// What bounds it on an H100. At the paper's training shape (N = 25,600
// positions, C = 173,520 catalog rows, d = 64) the forward computes
// 2·N·C·d = 5.69e11 FLOPs of logits and N·C = 4.44e9 exps against 51 MB
// that must move (0.015 ms at 3.35 TB/s); dX and dW each recompute the
// logits and take a product of the same size, 1.14e12 FLOPs. As f32 FMAs
// at 67 TFLOP/s that is 8.49 ms for the forward and 16.97 ms for dX or
// dW. All three run their products on the tensor cores in 3xTF32
// (tf32x3_tile.cuh) instead: three TF32 passes at the dense 495 TFLOP/s
// are 3.45 ms for the forward and 6.9 ms for dX or dW, against about 1 ms
// of exps on the SFUs (16 a clock per SM, 132 SMs, 1.98 GHz). So the
// tensor cores bound them; `mma.sync` (not `wgmma`) reaches about 310
// TFLOP/s of TF32 with eight warps an SM on an H100 SXM
// (probes/tf32_mma_rate.py), 5.5 and 11 ms here. Shared memory comes
// next: a warp-tile of 384 `mma`, forward or backward, reads 48 KB of
// fragments, about two thirds of what the SM's 128 bytes a clock give at
// that rate. The rest — the cotangent's exps, the splits of G, the FADDs
// of the k16 steps — is about 1,700 instructions a backward warp-tile
// beside its 384 `mma`; the forward's online softmax is four a logit
// (max, FFMA, exp2, add) over a thread's 64 logits a tile. On an H100 at
// the paper's shape the forward takes 10.8 ms, 158 TFLOP/s of TF32;
// probes/linear_ce_fwd_parts.py times it with the softmax replaced by a
// plain sum and without staging any later tile.
//
// Why 3xTF32 keeps the f32 tolerance. A product a·b becomes
// a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with each half rounded to nearest:
// about 2⁻²¹ relative error per product against f32's 2⁻²⁴, and no sum
// runs long inside the tensor cores (each k16 step starts from zero and
// is added in f32; see tf32x3_tile.cuh). A logit of |l| ≈ 100 then moves
// by a few units in f32's last place, less than cuBLAS's f32 product of
// the plain version does, well inside the lse's 1e-5·max|lse| and the
// gradients' 1e-5·max|grad| + 2e-4·|grad|. The forward's lse and the
// backward's recomputed logits come from the same arithmetic. Inputs are
// split once per step by split_kernel into (hi, lo) planes,
// (N + C)·dp·8 bytes (102 MB at the paper's shape), which the forward,
// dX and dW share: the autograd forward splits and keeps the planes for
// the backward (kernels/linear_sce.py). A step splits once instead of
// twice, and holding the planes from the loss's forward to its backward
// raised the full-CE steps' peak memory by at most 43 MiB over splitting
// again in the backward, less than one split's 97 MiB of planes (H100,
// the paper's shape; probes/linear_ce_times.py peak).
//
// Design. The TPU grid carries (m, s, pos) along a sequential catalog axis;
// on Hopper a block owns a tile and loops itself. Every kernel below stages
// its owned rows once into shared memory as ready A fragments and streams
// the other matrix's planes through a ring of cp.async stages, so tile
// i + 2 loads while tile i computes, each fragment load landing in the
// registers the `mma` reads (the layouts of tf32x3_tile.cuh; a (hi, lo)
// pair per depth would need four register moves per `mma`).
//   * forward: a block of up to eight warps owns 32 positions a warp (256
//     at d ≤ 64) and streams its split of the catalog 64 rows a tile (32
//     above dp 64, where a 64-row stage would crowd out the warps). Per
//     tile a warp computes its 32 × 64 logit tile with 384 `mma` (k16 steps
//     over the depth) and folds it, in the accumulator registers, into an
//     online (m, s) per thread and row: the softcap before the ragged-tile
//     mask (as on the TPU), the tile's max first, then one exp per logit;
//     the target's logit is plucked from the same register that enters the
//     sum, so loss = lse − pos comes from one rounding. At the end the four
//     lanes of a row merge their (m, s, pos) in a fixed tree. fwd_plan
//     picks the warps and ring stages that fit a block's shared memory.
//   * dX and dW are one kernel, ce_bwd_kernel, on two grids. A block of
//     four warps owns 128 rows (32 a warp, two m16 tiles) of one matrix —
//     positions of x for dX, catalog rows of w for dW (the transposed grid,
//     as on the TPU) — and streams the other matrix's planes 32 rows a tile
//     through three stages (two for dW at d ≤ 64, where its tiles also
//     carry lse, g and the targets of their 32 positions and three would
//     not let two blocks share an SM). Per tile a warp computes its
//     32 × 32 logit tile S with 192 `mma`, turns it into the cotangent in
//     the accumulator registers (the softcap before the ragged-tile mask;
//     rows with g = 0 give exactly 0), splits it into hi and lo there, and
//     multiplies it by the streamed tile into its (32, 64) output
//     accumulator with another 192 `mma` — G never goes through shared
//     memory. For d > 64 the grid's third axis takes the output 64 depth
//     columns at a time, each block recomputing S.
//   * 100 forward blocks (one an SM) and 200 dX blocks (two an SM) at
//     N = 25,600 fill the 132 SMs in under a wave, so both cut the catalog
//     into S contiguous splits (grid (N / rows, S)), S the least number
//     whose blocks fill their last wave to 90 % (the occupancy calculator
//     gives the blocks per SM). Each split writes its partial per row —
//     the forward its (m, s, pos), dX its rows — and a second kernel
//     merges them per row in split order. No atomics: every result repeats
//     bit for bit. dW writes each row once; a target shared by many
//     positions is summed inside the block's loop.
//   * At d = 64 (ptxas, sm_90a): the forward 209–231 registers a thread
//     and no spills, its eight warps sharing 229,376 bytes of shared
//     memory (256 positions' planes and three 64-row stages): one block,
//     eight warps, per SM. dX and dW 253–255 registers and no spills,
//     114,688 bytes for dX and 99,072 for dW: two blocks, eight warps,
//     per SM.
//
// Deep variants (the *_deep_launch entries), for d > 256, where no tile
// above holds its owned planes and a streamed tile over the whole depth
// in 227 KB. They read x and w as they are (no planes: at gemma-2's tied
// 256,000 × 2304 table those would cost 4.7 GB) and walk the catalog in
// chunks of `chunk` rows that a slab budget fixes (kernels/linear_sce.py
// deep_chunk), as the deep eval_fused walks its score slabs:
//   * forward: per chunk, the (N, chunk) logits slab by deep_tc.cuh's
//     3xTF32 product (positions as A, catalog rows as B; bf16 operands
//     on its bf16 `wgmma` product, gemm_bf16), then
//     deep_fold_kernel, a warp per row: the softcap, the online (m, s)
//     merged after the chunks before it, the target's logit plucked from
//     the same slab value in its chunk; deep_finish_kernel writes lse and
//     loss. The chunks go in ascending order, so the result repeats bit
//     for bit.
//   * backward (one entry for dX and dW/dY): per chunk the logits again
//     (the same product, so the same bits as the forward's), turned in
//     place into the cotangent (p − onehot)·cap′·g once, then
//     dX += G · w_chunk (the first chunk writes; the product's
//     accumulate epilogue, in chunk order, no atomics) and
//     dW_chunk = Gᵀ · x (every row written once), both reading that G.
// At N 4,096, C 256,000, d 2304 the forward's product is 4.8 TFLOP (29 ms
// at three TF32 passes at 495 TFLOP/s), each backward product as much;
// the slab's traffic (written and folded; written, rewritten, read
// twice) is a byte per ≈ 575 FLOP forward and ≈ 860 backward, so the
// products bound them.
//
// bfloat16 operands (the entries' bf16_in): split_kernel widens bf16 rows
// into planes whose lo is 0, so the forward, dX and dW (ONE) take one
// TF32 pass a product — the lo passes would add exact zeros — and dX and
// dW round the cotangent to bf16 before its product, as the reference's
// gw.astype(w.dtype); the deep entries read bf16 x and w as stored into
// deep_tc.cuh's bf16 `wgmma` (gemm_bf16) and write the chunk's cotangent
// rounded once as bf16 (rows of 16 bytes beside the f32 logits slab),
// which dX's and dW's products read at the bf16 rate. Every output is
// f32; the wrapper rounds dX and dW once.
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes in src/repro_torch/kernels/linear_sce.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "deep_tc.cuh"
#include "tf32x3_tile.cuh"

namespace {

using namespace tf32x3;

constexpr int kMaxSplits = 64;
constexpr int kMergeThreads = 256;

template <bool CAP>
__device__ __forceinline__ float logit(float v, float cap) {
  return CAP ? capped(v, cap) : v;
}

// The backward tile's entry: (p − onehot) · cap′ · g, 0 on padded columns.
// With the lse of the logits, l − lse ≤ 0; an lse far below them would
// overflow exp, and capping its argument at kMaxExp keeps such a
// cotangent (and its tensor-core products and sums) finite — the
// deviation from the plain version named at the top.
constexpr float kMaxExp = 44.f;  // e^44 < 2^64
template <bool PLUCK, bool CAP>
__device__ __forceinline__ float cotangent(float l, float lse, float g,
                                           bool live, bool hit, float cap) {
  float z = l - lse;
  z = z > kMaxExp ? kMaxExp : z;  // a NaN stays NaN
  float p = expf(z);
  if (PLUCK) p -= hit ? 1.f : 0.f;
  if (CAP) p *= cap_deriv(l, cap);
  return live ? p * g : 0.f;
}

// ---------------------------------------------------------------------------
// Forward: per row and split, the partial (m, s, pos) over the split.
// ---------------------------------------------------------------------------
constexpr int kFwdMaxWarps = 8;

// The forward's helpers. ce_bwd_kernel does the same staging and logit
// tile inline, with hi and lo of an A fragment side by side and its depth
// loop unrolled by 2: sharing these helpers left its registers and spills
// as they were but made it up to 9 % slower on an H100.

// The streamed tile's rows go to ring slot `t` in the planes' layout under
// the swizzle of tf32x3_tile.cuh: thread i copies chunks i, i + threads,
// ... in row order; rows past `rows_total` are zeros.
__device__ __forceinline__ void stage_rows(float4* t, const float4* src,
                                           long base, int rows,
                                           long rows_total, int cpr) {
  const int r_first = threadIdx.x / cpr, c_first = threadIdx.x % cpr;
  const int r_step = blockDim.x / cpr, c_step = blockDim.x % cpr;
  for (int r = r_first, ch = c_first; r < rows;) {
    const bool ok = base + r < rows_total;
    cp_async16(t + r * cpr + (ch ^ swizzle(r)),
               src + (ok ? (base + r) * cpr + ch : 0), ok);
    r += r_step;
    ch += c_step;
    if (ch >= cpr) {
      ch -= cpr;
      ++r;
    }
  }
}

// The block's owned rows r0 .. r0 + bm − 1 of `src` (rows past `n_rows`
// zero) as A fragments, once: for m16 tile mt and k8 step s, lane (gq, q)
// holds rows gq, gq + 8 at depths 8s + 2q, 8s + 2q + 1 — a float4 of hi,
// and 32 float4s (one a lane) later one of lo, so that a warp's LDS.128
// of either has no bank conflicts (9 % faster at the paper's shape than
// hi and lo side by side). Returns the warp's first fragment for its lane.
__device__ __forceinline__ const float* stage_fragments(float4* own,
                                                        const float4* src4,
                                                        long r0, int bm,
                                                        long n_rows,
                                                        int cpr) {
  const int s8 = cpr / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const float2* src = reinterpret_cast<const float2*>(src4);
  for (int u = warp; u < (bm / 16) * s8; u += warps) {
    const int mt = u / s8, s = u - mt * s8;
    const long r = r0 + 16 * mt + gq;
    const int hi = 2 * (4 * s + (q >> 1)) + (q & 1);  // float2 in row
    float2 h0{0.f, 0.f}, h1{0.f, 0.f}, l0{0.f, 0.f}, l1{0.f, 0.f};
    if (r < n_rows) {
      h0 = src[r * 2 * cpr + hi];
      l0 = src[r * 2 * cpr + hi + 4];
    }
    if (r + 8 < n_rows) {
      h1 = src[(r + 8) * 2 * cpr + hi];
      l1 = src[(r + 8) * 2 * cpr + hi + 4];
    }
    own[64 * u + lane] = make_float4(h0.x, h1.x, h0.y, h1.y);
    own[64 * u + 32 + lane] = make_float4(l0.x, l1.x, l0.y, l1.y);
  }
  return reinterpret_cast<const float*>(own) + 256 * (warp * kMT * s8) +
         4 * lane;
}

// Per-thread float offsets of the logit tile's B fragment in a streamed
// tile (row 8n + gq, depths 8s + 2q, + 1, at 32·cpr·n + 32·(s >> 1) +
// sb[s & 1]); lo is two chunks after hi.
__device__ __forceinline__ void logit_offsets(int cpr, int (&sb_hi)[2],
                                              int (&sb_lo)[2]) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int f = swizzle(gq);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    sb_hi[p] = 4 * (gq * cpr + ((4 * p + (q >> 1)) ^ f)) + 2 * (q & 1);
    sb_lo[p] = 4 * (gq * cpr + ((4 * p + 2 + (q >> 1)) ^ f)) + 2 * (q & 1);
  }
}

// sc[m][n] = the warp's owned rows · the streamed tile's rows 8n .. 8n + 7,
// 32 × 8·NT, in k16 steps over the depth, each from zero and added in f32
// (ONE: planes of bf16 values, lo 0, one pass). The depth loop is not
// unrolled: unrolled by 2, the 32 × 64 tile took 255 registers and
// spilled.
template <int NT, bool ONE>
__device__ __forceinline__ void logit_tile(const float* afrag,
                                           const float* t, int cpr,
                                           const int (&sb_hi)[2],
                                           const int (&sb_lo)[2],
                                           float (&sc)[kMT][NT][4]) {
  const int s8 = cpr / 4;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[m][n][i] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < s8 / 2; ++kk) {
    uint32_t ah[kMT][2][4], al[kMT][2][4];  // [m][k8]
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float* f = afrag + 256 * (m * s8 + 2 * kk + k);
        lds128(ah[m][k], f);
        if (!ONE) lds128(al[m][k], f + 128);
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float* f = t + 32 * (cpr * n + kk);
        lds64(bh[k], f + sb_hi[k]);
        if (!ONE) lds64(bl[k], f + sb_lo[k]);
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        float part[4];
        mma_k16<ONE>(part, ah[m], al[m], bh, bl);
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[m][n][i] += part[i];
      }
    }
  }
}

// The forward's inputs: the planes of x (owned) and w (streamed). `tgt` is
// null without PLUCK.
struct FwdProblem {
  const float4* xp;  // (n, dp) planes
  const float4* wp;  // (c, dp) planes
  const int* tgt;    // (n,)
  int n, c, cpr;     // cpr = dp / 2 chunks a row
  float cap;
  int tiles_per_split;  // streamed tiles of one split
  int stages;           // cp.async ring depth: 2 or 3
};

// NT n8 tiles a streamed tile: 8·NT catalog rows. ONE: the planes hold
// bf16 values (lo 0), one TF32 pass a product.
template <bool PLUCK, bool CAP, int NT, bool ONE>
__global__ void __launch_bounds__(32 * kFwdMaxWarps, 1)
ce_fwd_kernel(FwdProblem a, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  constexpr int kRows = 8 * NT;
  const int cpr = a.cpr;
  const int bm = kWarpRows * (blockDim.x >> 5);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3;
  float4* own = smem4;            // A fragments: (bm / 16, s8, 32, hi|lo)
  float4* ring = own + bm * cpr;  // stages × (kRows, cpr), swizzled

  const int r0 = blockIdx.x * bm;
  const int n_tiles = (a.c + kRows - 1) / kRows;
  const int t_lo = blockIdx.y * a.tiles_per_split;
  const int t_hi = min(n_tiles, t_lo + a.tiles_per_split);
  auto stage = [&](int tile, int sl) {
    stage_rows(ring + sl * kRows * cpr, a.wp, (long)tile * kRows, kRows,
               a.c, cpr);
  };
  for (int sl = 0; sl < a.stages - 1; ++sl) {
    if (t_lo + sl < t_hi) stage(t_lo + sl, sl);
    cp_async_commit();
  }
  const float* afrag = stage_fragments(own, a.xp, r0, bm, a.n, cpr);
  int sb_hi[2], sb_lo[2];
  logit_offsets(cpr, sb_hi, sb_lo);

  // Per owned row of the thread (m16 tile m, half h): the online (m, s)
  // over the thread's columns, the plucked positive and the target.
  float mx[kMT][2], sx[kMT][2], ps[kMT][2];
  int tg[kMT][2];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + warp * kWarpRows + 16 * m + 8 * h + gq;
      mx[m][h] = kNegInf;
      sx[m][h] = 0.f;
      ps[m][h] = 0.f;
      tg[m][h] = PLUCK && r < a.n ? a.tgt[r] : -1;
    }

  for (int it = 0; t_lo + it < t_hi; ++it) {
    if (a.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // tile it has landed; the slot of it − 1 is free

    const float* t = reinterpret_cast<const float*>(
        ring + (it % a.stages) * kRows * cpr);
    const int col0 = (t_lo + it) * kRows;
    float sc[kMT][NT][4];
    logit_tile<NT, ONE>(afrag, t, cpr, sb_hi, sb_lo, sc);
    // The next stage's copies go out after the products (on an H100 at the
    // paper's shape 2 % faster than before them).
    const int ahead = it + a.stages - 1;
    if (t_lo + ahead < t_hi) stage(t_lo + ahead, ahead % a.stages);
    cp_async_commit();

    // The online softmax in the C layout: the thread's columns of row
    // (m, h) are 8n + 2q + j, in sc[m][n][2h + j]. A full tile needs no
    // mask; the catalog's last tile masks the columns past it, whose exps
    // it leaves out (all of a thread's columns may be masked there, and
    // then its max is kNegInf).
    const int valid = a.c - col0;  // columns of the tile inside the catalog
    auto softmax = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float tmax = kNegInf;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float& v = sc[m][n][2 * h + j];
              v = logit<CAP>(v, a.cap);
              if (!FULL && 8 * n + 2 * q + j >= valid) v = kNegInf;
              tmax = fmaxf(tmax, v);
            }
          const float mn = fmaxf(mx[m][h], tmax);
          const float mb = mn * kLog2e;
          float se = 0.f;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (FULL || 8 * n + 2 * q + j < valid)
                se += exp_from(sc[m][n][2 * h + j], mb);
          sx[m][h] = sx[m][h] * exp_diff(mx[m][h], mn) + se;
          mx[m][h] = mn;
        }
    };
    if (valid >= kRows)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});

    // The target's logit, from the register that entered the sum: a row's
    // target lies in this tile in about one tile of C / 64, so one branch
    // after the softmax keeps the sum's code free of it.
    if (PLUCK) {
      int rel[kMT][2];  // the target's column in the tile, else −1
      bool hit = false;
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = tg[m][h] - col0;
          rel[m][h] = r >= 0 && r < kRows && r < valid ? r : -1;
          hit |= rel[m][h] >= 0 && ((r >> 1) & 3) == q;
        }
      if (hit) {
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                if (8 * n + 2 * q + j == rel[m][h])
                  ps[m][h] += sc[m][n][2 * h + j];
      }
    }
  }
  cp_async_wait<0>();

  // Merge the four lanes of each row in a fixed tree (xor 1, then 2); lane
  // q = 0 writes the row's partial.
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mi = mx[m][h], si = sx[m][h], pi = ps[m][h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float mo = __shfl_xor_sync(kFull, mi, o);
        const float so = __shfl_xor_sync(kFull, si, o);
        merge_ms(mi, si, mo, so);
        if (PLUCK) pi += __shfl_xor_sync(kFull, pi, o);
      }
      const int r = r0 + warp * kWarpRows + 16 * m + 8 * h + gq;
      if (q == 0 && r < a.n) {
        float* out = part + ((long)blockIdx.y * a.n + r) * 3;
        out[0] = mi;
        out[1] = si;
        out[2] = pi;
      }
    }
}

// One thread per row: the splits' (m, s, pos) in split order → lse, loss.
template <bool PLUCK>
__global__ void __launch_bounds__(kMergeThreads)
ce_fwd_merge_kernel(const float* __restrict__ part, float* __restrict__ loss,
                    float* __restrict__ lse, int n, int splits) {
  const int r = blockIdx.x * kMergeThreads + threadIdx.x;
  if (r >= n) return;
  float m = kNegInf, s = 0.f, pos = 0.f;
  for (int k = 0; k < splits; ++k) {
    const float* q = part + ((long)k * n + r) * 3;
    merge_ms(m, s, q[0], q[1]);
    pos += q[2];
  }
  const float l = m + logf(s);
  lse[r] = l;
  if (PLUCK) loss[r] = l - pos;
}

// ---------------------------------------------------------------------------
// The (hi, lo) planes of x and w, which the forward, dX and dW share; then
// dX and dW on the tensor cores.
// ---------------------------------------------------------------------------
constexpr int kSplitThreads = 256;

// xp and wp: the rows of x (n, d) and w (c, d) as blocks of 8 depths,
// (hi[8], lo[8]), zeros past d (tf32x3_tile.cuh). One thread a group of
// four depths: one 16-byte chunk of hi and one of lo. bf16 rows (T) are
// widened as read: each value is its own hi and its lo plane is 0, so the
// kernels that read the planes compute on the bf16 values exactly.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const T* __restrict__ x, const T* __restrict__ w,
             float4* __restrict__ xp, float4* __restrict__ wp, int n, int c,
             int d, int cpr) {
  const int quads = cpr / 2;  // groups of four depths a row
  long e = (long)blockIdx.x * kSplitThreads + threadIdx.x;
  const T* src = x;
  float4* dst = xp;
  if (e >= (long)n * quads) {
    e -= (long)n * quads;
    src = w;
    dst = wp;
    if (e >= (long)c * quads) return;
  }
  const long r = e / quads;
  const int k = 4 * (int)(e - r * quads);  // first depth of the group
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split(k + i < d ? widen(src[r * d + k + i]) : 0.f, h[i], l[i]);
  // block k / 8: chunks (hi 0..3, hi 4..7, lo 0..3, lo 4..7)
  float4* out = dst + r * cpr + (k / 8) * 4 + (k % 8) / 4;
  out[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                       __uint_as_float(h[2]), __uint_as_float(h[3]));
  out[2] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                       __uint_as_float(l[2]), __uint_as_float(l[3]));
}

constexpr int kBwdMaxWarps = 4;

// One backward call. The block owns rows of `own` and streams `str`:
// dX owns positions (x) and streams the catalog (w); dW the reverse.
struct BwdProblem {
  const float4* own;  // (n_own, dp) planes
  const float4* str;  // (n_str, dp) planes
  const int* tgt;     // (n,) or null without PLUCK
  const float* lse;   // (n,)
  const float* g;     // (n,)
  int n, c, d, cpr;   // cpr = dp / 2 chunks a row
  int n_own, n_str;
  float cap;
  int tiles_per_split;  // streamed tiles of one split (all of them for dW)
  int stages;           // cp.async ring depth: 2 or 3
};

// Rows of the owned block: kWarpRows a warp.
// dX: out (splits, n, d), this split's partial; dW: out (c, d).
// ONE: the planes hold bf16 values (lo 0); the cotangent is rounded to
// bf16 before its product (the reference's gw.astype(w.dtype)), and each
// product takes one TF32 pass.
template <bool DW, bool PLUCK, bool CAP, bool ONE>
__global__ void __launch_bounds__(32 * kBwdMaxWarps, 2)
ce_bwd_kernel(BwdProblem a, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int cpr = a.cpr;
  const int s8 = cpr / 4;  // k8 steps over the depth
  const int warps = blockDim.x >> 5;
  const int bm = kWarpRows * warps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3;
  float4* own = smem4;            // A fragments: (bm / 16, s8, 32, hi|lo)
  float4* ring = own + bm * cpr;  // stages × (kStreamRows, cpr), swizzled
  float* stats = reinterpret_cast<float*>(ring + a.stages * kStreamRows *
                                          cpr);  // DW: stages × 3 × 32

  const int r0 = blockIdx.x * bm;
  const int n_tiles = (a.n_str + kStreamRows - 1) / kStreamRows;
  const int t_lo = blockIdx.y * a.tiles_per_split;
  const int t_hi = min(n_tiles, t_lo + a.tiles_per_split);
  const int oc0 = blockIdx.z * kOutCols;
  const int n_out8 = min(kOutCols, 2 * cpr - oc0) / 8;

  // The streamed tiles: thread i copies chunks i, i + blockDim.x, ... in
  // row order; rows past the matrix are zeros.
  const int r_first = threadIdx.x / cpr, c_first = threadIdx.x % cpr;
  const int r_step = blockDim.x / cpr, c_step = blockDim.x % cpr;
  auto stage = [&](int tile, int sl) {
    float4* t = ring + sl * kStreamRows * cpr;
    const long base = (long)tile * kStreamRows;
    for (int r = r_first, ch = c_first; r < kStreamRows;) {
      const bool ok = base + r < a.n_str;
      cp_async16(t + r * cpr + (ch ^ swizzle(r)),
                 a.str + (ok ? (base + r) * cpr + ch : 0), ok);
      r += r_step;
      ch += c_step;
      if (ch >= cpr) {
        ch -= cpr;
        ++r;
      }
    }
    if (DW) {  // the tile's positions' lse, g and targets
      float* st = stats + sl * 3 * kStreamRows;
      for (int e = threadIdx.x; e < 3 * kStreamRows; e += blockDim.x) {
        const int which = e / kStreamRows;
        const long p = base + (e - which * kStreamRows);
        const bool ok = p < a.n && (which < 2 || PLUCK);
        const void* src = which == 0   ? (const void*)(a.lse + p)
                          : which == 1 ? (const void*)(a.g + p)
                                       : (const void*)(a.tgt + p);
        cp_async4(st + e, ok ? src : (const void*)a.lse, ok);
      }
    }
  };
  for (int sl = 0; sl < a.stages - 1; ++sl) {
    if (t_lo + sl < t_hi) stage(t_lo + sl, sl);
    cp_async_commit();
  }

  // The owned rows as A fragments, once: for m16 tile mt and k8 step s,
  // lane (gq, q) holds rows gq, gq + 8 at depths 8s + 2q, 8s + 2q + 1.
  {
    const float2* src = reinterpret_cast<const float2*>(a.own);
    for (int u = warp; u < (bm / 16) * s8; u += warps) {
      const int mt = u / s8, s = u - mt * s8;
      const long r = r0 + 16 * mt + gq;
      const int hi = 2 * (4 * s + (q >> 1)) + (q & 1);  // float2 in row
      float2 h0{0.f, 0.f}, h1{0.f, 0.f}, l0{0.f, 0.f}, l1{0.f, 0.f};
      if (r < a.n_own) {
        h0 = src[r * 2 * cpr + hi];
        l0 = src[r * 2 * cpr + hi + 4];
      }
      if (r + 8 < a.n_own) {
        h1 = src[(r + 8) * 2 * cpr + hi];
        l1 = src[(r + 8) * 2 * cpr + hi + 4];
      }
      own[2 * (32 * u + lane)] = make_float4(h0.x, h1.x, h0.y, h1.y);
      own[2 * (32 * u + lane) + 1] = make_float4(l0.x, l1.x, l0.y, l1.y);
    }
  }
  const float* afrag =
      reinterpret_cast<const float*>(own) + 8 * (32 * (warp * kMT * s8) + lane);

  // Per-thread float offsets in a streamed tile. S's B fragment (row
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

  // Per owned row of the thread (m16 tile m, half h): dX's lse, g and
  // target; dW's catalog row.
  float ls[kMT][2], gs[kMT][2];
  int tg[kMT][2];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + warp * kWarpRows + 16 * m + 8 * h + gq;
      const bool live = !DW && r < a.n;
      ls[m][h] = live ? a.lse[r] : 0.f;
      gs[m][h] = live ? a.g[r] : 0.f;
      tg[m][h] = DW ? r : (PLUCK && live ? a.tgt[r] : -1);
    }

  float acc[kMT][8][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  for (int it = 0; t_lo + it < t_hi; ++it) {
    if (a.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // tile it has landed; the slot of it − 1 is free
    const int ahead = it + a.stages - 1;
    if (t_lo + ahead < t_hi) stage(t_lo + ahead, ahead % a.stages);
    cp_async_commit();

    const int sl = it % a.stages;
    const float* t = reinterpret_cast<const float*>(ring + sl * kStreamRows *
                                                    cpr);
    const int col0 = (t_lo + it) * kStreamRows;

    // S = own_rows · tᵀ, 32 × 32 a warp, k16 steps over the depth.
    float sc[kMT][4][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[m][n][i] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < s8 / 2; ++kk) {
      uint32_t ah[kMT][2][4], al[kMT][2][4];  // [m][k8]
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float* f = afrag + 256 * (m * s8 + 2 * kk + k);
          lds128(ah[m][k], f);
          if (!ONE) lds128(al[m][k], f + 4);
        }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float* f = t + 32 * (cpr * n + kk);
          lds64(bh[k], f + sb_hi[k]);
          if (!ONE) lds64(bl[k], f + sb_lo[k]);
        }
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          float part[4];
          mma_k16<ONE>(part, ah[m], al[m], bh, bl);
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[m][n][i] += part[i];
        }
      }
    }

    // The cotangent, in place: (p − onehot)·cap′·g, 0 on padded columns.
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * q + j;
        const int p = col0 + col;
        float cl = 0.f, cg = 0.f;
        int ct = -1;
        if (DW) {
          const float* st = stats + sl * 3 * kStreamRows;
          cl = st[col];
          cg = st[kStreamRows + col];
          ct = PLUCK ? reinterpret_cast<const int*>(st)[2 * kStreamRows + col]
                     : -1;
        }
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& v = sc[m][n][2 * h + j];
            const float l = logit<CAP>(v, a.cap);
            v = DW ? cotangent<PLUCK, CAP>(l, cl, cg, p < a.n,
                                           tg[m][h] == ct, a.cap)
                   : cotangent<PLUCK, CAP>(l, ls[m][h], gs[m][h], p < a.c,
                                           p == tg[m][h], a.cap);
            if (ONE) v = round_bf16(v);
          }
      }

    // acc += G · t over the tile's 32 rows, k16 steps of the streamed rows;
    // G's C fragment of n8 tile j is the A fragment of k8 step j. All eight
    // output n8 tiles unless the block's depth chunk is short (d % 64).
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
        const float* tj[2] = {t + 32 * cpr * (2 * kk), t + 32 * cpr * (2 * kk + 1)};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (FULL || n < n_out8) {
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int k = 0; k < 2; ++k)
#pragma unroll
              for (int rp = 0; rp < 2; ++rp) {
                const float* f = tj[k] + 32 * (n >> 1);
                bh[k][rp] = __float_as_uint(f[pb_hi[rp][n & 1]]);
                bl[k][rp] = ONE ? 0u : __float_as_uint(f[pb_lo[rp][n & 1]]);
              }
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
              float part[4];
              mma_k16<ONE>(part, gh[m], gl[m], bh, bl);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[m][n][i] += part[i];
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
  cp_async_wait<0>();

  float* dst = DW ? out : out + (long)blockIdx.y * a.n * a.d;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n >= n_out8) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long r = r0 + warp * kWarpRows + 16 * m + 8 * (i >> 1) + gq;
        const int col = oc0 + 8 * n + 2 * q + (i & 1);
        if (r < a.n_own && col < a.d) dst[r * a.d + col] = acc[m][n][i];
      }
    }
}

// dX = Σ over the splits of their partial dX, in split order.
__global__ void __launch_bounds__(kMergeThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  long nd, int splits) {
  const long e = (long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= nd) return;
  float acc = 0.f;
  for (int k = 0; k < splits; ++k) acc += part[(long)k * nd + e];
  out[e] = acc;
}

// ---------------------------------------------------------------------------
// Host side: dispatch, shared memory, the split plan.
// ---------------------------------------------------------------------------
using True = std::true_type;
using False = std::false_type;

// Calls f(PLUCK, CAP) with both as std::integral_constant<bool>.
template <class F>
cudaError_t with_flags(bool pluck, bool cap, F&& f) {
  if (pluck) return cap ? f(True{}, True{}) : f(True{}, False{});
  return cap ? f(False{}, True{}) : f(False{}, False{});
}


// The least S ≤ min(kMaxSplits, catalog tiles) whose row_tiles·S blocks
// fill their last wave to 90 %, else the S that fills it best.
template <class K>
cudaError_t plan_splits(K kernel, int threads, size_t smem, int row_tiles,
                        int c_tiles, int* splits) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const long slots = (long)n_sm * (per_sm > 0 ? per_sm : 1);
  const int most = c_tiles < kMaxSplits ? c_tiles : kMaxSplits;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= most; ++s) {
    const long blocks = (long)row_tiles * s;
    const long waves = (blocks + slots - 1) / slots;
    const double fill = (double)blocks / (double)(waves * slots);
    if (fill >= 0.9) {
      best = s;
      break;
    }
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
  }
  *splits = best;
  return cudaSuccess;
}

// The resident kernels take d ≤ kMaxD; the deep entries (deep) any d.
bool shapes_ok(int n, int c, int d, bool deep = false) {
  return n > 0 && c > 0 && d > 0 && (deep || d <= kMaxD) && c <= (1 << 30);
}

// Splits of `tiles` tiles into `splits` contiguous ranges.
int tiles_per_split(int tiles, int splits) {
  return (tiles + splits - 1) / splits;
}

// The forward's launch shape at depth d: streamed rows a tile (64 up to
// dp 64, else 32), warps a block and ring stages — the most warps (at most
// eight, 32 owned positions each) whose owned planes fit one block's
// shared memory beside a ring of three stages, or of two where that fits
// more — and the shared memory. Mirrored by
// kernels/linear_sce.py::fwd_plan for the guard's preflight, and exported
// as linear_ce_fwd_plan so that the card checks the two agree.
struct FwdPlan {
  int rows, warps, stages;
  size_t smem;
};

FwdPlan fwd_plan(int d) {
  const int dp = padded_depth(d);
  FwdPlan p{dp <= 64 ? 64 : 32, 0, 3, 0};
  const size_t own = (size_t)8 * dp * kWarpRows;  // bytes a warp
  const size_t stage = (size_t)8 * dp * p.rows;
  for (int stages = 3; stages >= 2; --stages) {
    const size_t ring = stages * stage;
    const size_t fit = ring < (size_t)kMaxSmem ? (kMaxSmem - ring) / own : 0;
    const int warps = fit < (size_t)kFwdMaxWarps ? (int)fit : kFwdMaxWarps;
    if (warps > p.warps) {
      p.warps = warps;
      p.stages = stages;
    }
  }
  p.smem = own * p.warps + stage * p.stages;
  return p;
}

// Calls f with the forward's n8 tiles a streamed tile at depth d as a
// std::integral_constant<int>.
template <class F>
cudaError_t with_rows(int d, F&& f) {
  if (fwd_plan(d).rows == 64) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, 4>{});
}

template <bool PLUCK, bool CAP, int NT, bool ONE = false>
cudaError_t fwd_kernel_ready() {
  static bool done[kMaxDevices] = {};
  return allow_max_smem(ce_fwd_kernel<PLUCK, CAP, NT, ONE>, done);
}

// The backward's launch shape at depth d: warps a block (128 owned rows
// while the owned planes and a ring fit, fewer for d > 128), ring stages
// and shared memory. Three stages where two blocks still share an SM
// (2 · (smem + the 1 KB the SM reserves a block) ≤ its 228 KB), else two
// where that lets them, else the most that fit one block. Mirrored by
// kernels/linear_sce.py::bwd_plan for the guard's preflight, and exported
// as linear_ce_bwd_plan so that the card checks the two agree.
struct BwdPlan {
  int warps, stages;
  size_t smem;
};

constexpr size_t kPairSmem = 233472 / 2 - 1024;

BwdPlan bwd_plan(int d, bool dw) {
  const int dp = padded_depth(d);
  BwdPlan p{dp <= 128 ? 4 : (dp <= 192 ? 2 : 1), 3, 0};
  auto bytes = [&](int stages) {
    return (size_t)16 * (dp / 2) * (kWarpRows * p.warps +
                                    stages * kStreamRows) +
           (dw ? (size_t)12 * stages * kStreamRows : 0);
  };
  if (bytes(3) > kPairSmem && (bytes(2) <= kPairSmem ||
                               bytes(3) > (size_t)kMaxSmem))
    p.stages = 2;
  p.smem = bytes(p.stages);
  return p;
}

template <bool DW, bool PLUCK, bool CAP, bool ONE = false>
cudaError_t bwd_kernel_ready() {
  static bool done[kMaxDevices] = {};
  return allow_max_smem(ce_bwd_kernel<DW, PLUCK, CAP, ONE>, done);
}

// The backward's problem on the planes; tiles_per_split is set by the
// caller.
BwdProblem bwd_problem(bool dw, const float* xp, const float* wp,
                       const int* tgt, const float* lse, const float* g,
                       int n, int c, int d, float cap, int stages) {
  const float4* x4 = reinterpret_cast<const float4*>(xp);
  const float4* w4 = reinterpret_cast<const float4*>(wp);
  BwdProblem a{dw ? w4 : x4, dw ? x4 : w4, tgt, lse, g, n, c, d,
               padded_depth(d) / 2, dw ? c : n, dw ? n : c, cap, 0, stages};
  return a;
}

int out_chunks(int d) { return (padded_depth(d) + kOutCols - 1) / kOutCols; }

int s_tiles(int rows) { return (rows + kStreamRows - 1) / kStreamRows; }

// ---------------------------------------------------------------------------
// Deep variants (d > kMaxD): the catalog in chunks of `chunk` rows, each
// chunk's logits written once into an (n, chunk) slab by deep_tc.cuh's
// product, then folded (forward) or turned into the cotangent in place
// and multiplied back (backward), chunk after chunk in stream order.
// ---------------------------------------------------------------------------
constexpr int kFoldWarps = 8;

// deep_tc's product, with this library's table of its shared-memory
// opt-in for each instantiation.
template <bool A_KM, bool B_KN, bool ACC, bool GATHER = false,
          typename TA = float, typename TB = TA>
cudaError_t tc_gemm(const deep_tc::Gemm& g, cudaStream_t s, long batch = 1) {
  static bool done[kMaxDevices] = {};
  return deep_tc::gemm<A_KM, B_KN, GATHER, ACC, TA, TB>(g, batch, s, done);
}

// deep_tc's bf16 product (gemm_bf16: bf16 × bf16 at the bf16 rate), with
// its own opt-in table.
template <bool A_KM, bool B_KN, bool ACC, bool GATHER = false>
cudaError_t bf16_gemm(const deep_tc::Gemm& g, cudaStream_t s,
                      long batch = 1) {
  static bool done[kMaxDevices] = {};
  return deep_tc::gemm_bf16<A_KM, B_KN, GATHER, ACC>(g, batch, s, done);
}

// The bf16 cotangent slab's row pitch: the chunk rounded up to 8 values,
// so that its rows start 16-byte aligned and the products take G by TMA.
__host__ __device__ inline int g_pitch(int chunk) {
  return (chunk + 7) / 8 * 8;
}


// Calls f(std::integral_constant<bool, v>).
template <class F>
cudaError_t with_bool(bool v, F&& f) {
  return v ? f(True{}) : f(False{});
}

// slab[r][j] = x[r] · w[c0 + j] for j < cc, at pitch ld; x, w of type T
// (bf16: gemm_bf16).
template <typename T>
cudaError_t chunk_logits(const void* x, const void* w, float* slab, int ld,
                         int n, int c0, int cc, int d, cudaStream_t s) {
  deep_tc::Gemm g{};
  g.a = x;
  g.lda = d;
  g.b = static_cast<const T*>(w) + (long)c0 * d;
  g.ldb = d;
  g.out = slab;
  g.ldo = ld;
  g.m = n;
  g.n = cc;
  g.k = d;
  if constexpr (sizeof(T) == 2)
    return bf16_gemm<false, false, false>(g, s);
  else
    return tc_gemm<false, false, false, false, T>(g, s);
}

// One chunk of the forward, a warp per row: the online (m, s) of the
// row's capped logits (lanes stride the chunk, then a fixed shuffle
// tree), merged after the (m, s) of the chunks before it in state
// (n, 3) = (m, s, pos); the target's capped logit plucked when it lies
// in this chunk (a target outside [0, C) keeps pos 0).
template <bool PLUCK, bool CAP>
__global__ void __launch_bounds__(32 * kFoldWarps)
deep_fold_kernel(const float* __restrict__ slab, int ld,
                 const int* __restrict__ tgt, float* __restrict__ state,
                 int n, int c0, int cc, int first, float cap) {
  const int row = blockIdx.x * kFoldWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const float* l = slab + (long)row * ld;
  float m = kNegInf, s = 0.f;
  for (int j = lane; j < cc; j += 32) {
    const float v = logit<CAP>(l[j], cap);
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
  float* st = state + 3L * row;
  float pos = 0.f;
  if (!first) {
    float mp = st[0], sp = st[1];
    merge_ms(mp, sp, m, s);
    m = mp;
    s = sp;
    pos = st[2];
  }
  if (PLUCK) {
    const int t = tgt[row];
    if (t >= c0 && t - c0 < cc) pos = logit<CAP>(l[t - c0], cap);
  }
  st[0] = m;
  st[1] = s;
  st[2] = pos;
}

// lse = m + log(s) of each row's state; with PLUCK loss = lse − pos.
template <bool PLUCK>
__global__ void __launch_bounds__(kMergeThreads)
deep_finish_kernel(const float* __restrict__ state, float* __restrict__ loss,
                   float* __restrict__ lse, int n) {
  const int r = blockIdx.x * kMergeThreads + threadIdx.x;
  if (r >= n) return;
  const float l2 = state[3L * r] + logf(state[3L * r + 1]);
  lse[r] = l2;
  if (PLUCK) loss[r] = l2 - state[3L * r + 2];
}

// The chunk's logits in the slab → the cotangent (p − onehot)·cap′·g,
// the resident backward's entry (cotangent above): f32 in place, or (BF)
// for bf16 operands rounded to bf16 once, as the reference's
// gw.astype(w.dtype), into gb (n rows at pitch g_pitch(ld)).
// A block per row at a time, its threads along the chunk.
template <bool PLUCK, bool CAP, bool BF>
__global__ void __launch_bounds__(256)
deep_cotangent_kernel(float* __restrict__ slab, bf16* __restrict__ gb,
                      int ld, const int* __restrict__ tgt,
                      const float* __restrict__ lse,
                      const float* __restrict__ g, int n, int c0, int cc,
                      float cap) {
  const int ldg = g_pitch(ld);
  for (long row = blockIdx.x; row < n; row += gridDim.x) {
    const float ls = lse[row], gr = g[row];
    const int t = PLUCK ? tgt[row] - c0 : -1;
    float* const p = slab + row * ld;
    for (int j = threadIdx.x; j < cc; j += blockDim.x) {
      const float l = logit<CAP>(p[j], cap);
      const float v =
          cotangent<PLUCK, CAP>(l, ls, gr, true, PLUCK && t == j, cap);
      if (BF)
        gb[row * ldg + j].bits =
            (uint16_t)(__float_as_uint(round_bf16(v)) >> 16);
      else
        p[j] = v;
    }
  }
}

}  // namespace

// The C interface, bound with ctypes. Shapes: x (n, d) f32, w (c, d) f32,
// tgt (n,) i32 (null unless pluck), lse, g, loss (n,) f32; xp
// (n, dp / 8, 2, 8) and wp (c, dp / 8, 2, 8) f32, the (hi, lo) planes of
// x and w (dp = d rounded up to 16), 16-byte aligned; all contiguous,
// d ≤ 256 (above, the deep entries at the end). `cap` > 0 is the logit
// softcap, 0 none.
// Each launcher returns the cudaError_t of its launches (0 on success),
// and cudaErrorInvalidValue for shapes it does not take. Nothing is
// synchronised and nothing is allocated.

// The number of catalog splits S the forward (kind 0) or dX (kind 1) runs
// at for these shapes and flags on the current device (≥ 1), or −err. The
// caller allocates the split scratch: (S, n, 3) floats for the forward,
// (S, n, d) for dX when S > 1.
extern "C" int linear_ce_splits(int kind, int n, int c, int d, int pluck,
                                float cap) {
  if (!shapes_ok(n, c, d) || kind < 0 || kind > 1)
    return -(int)cudaErrorInvalidValue;
  int splits = 1;
  cudaError_t err = with_flags(pluck != 0, cap > 0.f, [&](auto pl, auto cp) {
    constexpr bool PL = decltype(pl)::value;
    constexpr bool CP = decltype(cp)::value;
    if (kind == 0) {
      const FwdPlan p = fwd_plan(d);
      const int bm = kWarpRows * p.warps;
      return with_rows(d, [&](auto nt) {
        constexpr int NT = decltype(nt)::value;
        cudaError_t e = fwd_kernel_ready<PL, CP, NT>();
        if (e != cudaSuccess) return e;
        return plan_splits(ce_fwd_kernel<PL, CP, NT, false>, 32 * p.warps,
                           p.smem,
                           (n + bm - 1) / bm, (c + p.rows - 1) / p.rows,
                           &splits);
      });
    }
    cudaError_t e = bwd_kernel_ready<false, PL, CP>();
    if (e != cudaSuccess) return e;
    const BwdPlan p = bwd_plan(d, false);
    const int bm = kWarpRows * p.warps;
    return plan_splits(ce_bwd_kernel<false, PL, CP, false>, 32 * p.warps,
                       p.smem,
                       (n + bm - 1) / bm * out_chunks(d), s_tiles(c),
                       &splits);
  });
  return err == cudaSuccess ? splits : -(int)err;
}

// The forward's launch plan at depth d: its dynamic shared memory in
// bytes, with the warps a block and the ring's stages written to *warps
// and *stages; −cudaErrorInvalidValue for d outside (0, kMaxD]. Touches
// no device.
extern "C" int linear_ce_fwd_plan(int d, int* warps, int* stages) {
  if (!shapes_ok(1, 1, d) || warps == nullptr || stages == nullptr)
    return -(int)cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(d);
  *warps = p.warps;
  *stages = p.stages;
  return (int)p.smem;
}

// The backward's launch plan at depth d for dX (dw 0) or dW (dw 1): its
// dynamic shared memory in bytes, with the warps a block and the ring's
// stages written to *warps and *stages; −cudaErrorInvalidValue for d
// outside (0, kMaxD]. Touches no device.
extern "C" int linear_ce_bwd_plan(int d, int dw, int* warps, int* stages) {
  if (!shapes_ok(1, 1, d) || warps == nullptr || stages == nullptr)
    return -(int)cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(d, dw != 0);
  *warps = p.warps;
  *stages = p.stages;
  return (int)p.smem;
}

// Forward: lse (n,), and with pluck loss (n,) = lse − the target's logit,
// from the planes xp and wp. part: (splits, n, 3) f32 scratch. bf16_in:
// the planes were split from bfloat16 operands (lo 0): one TF32 pass.
extern "C" int linear_ce_fwd_launch(const float* xp, const float* wp,
                                    const int* tgt, float* part, float* loss,
                                    float* lse, int n, int c, int d,
                                    int splits, int pluck, float cap,
                                    int bf16_in, void* stream) {
  if (!shapes_ok(n, c, d) || splits < 1 || splits > kMaxSplits ||
      (pluck && (tgt == nullptr || loss == nullptr)))
    return (int)cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(d);
  if (p.warps < 1 || p.smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FwdProblem a{reinterpret_cast<const float4*>(xp),
               reinterpret_cast<const float4*>(wp), tgt, n, c,
               padded_depth(d) / 2, cap,
               tiles_per_split((c + p.rows - 1) / p.rows, splits), p.stages};
  return (int)with_flags(pluck != 0, cap > 0.f, [&](auto pl, auto cp) {
    constexpr bool PL = decltype(pl)::value;
    constexpr bool CP = decltype(cp)::value;
    const int bm = kWarpRows * p.warps;
    cudaError_t err = with_rows(d, [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      return with_bool(bf16_in != 0, [&](auto one) {
        constexpr bool ONE = decltype(one)::value;
        cudaError_t e = fwd_kernel_ready<PL, CP, NT, ONE>();
        if (e != cudaSuccess) return e;
        const dim3 grid((n + bm - 1) / bm, splits);
        ce_fwd_kernel<PL, CP, NT, ONE>
            <<<grid, 32 * p.warps, p.smem, st>>>(a, part);
        return cudaGetLastError();
      });
    });
    if (err != cudaSuccess) return err;
    ce_fwd_merge_kernel<PL>
        <<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, st>>>(
            part, loss, lse, n, splits);
    return cudaGetLastError();
  });
}

// The (hi, lo) planes of x and w, one launch for both; x and w f32, or
// both bfloat16 when bf16_in is nonzero (then every lo is 0).
extern "C" int linear_ce_split_launch(const void* x, const void* w,
                                      float* xp, float* wp, int n, int c,
                                      int d, int bf16_in, void* stream) {
  if (!shapes_ok(n, c, d)) return (int)cudaErrorInvalidValue;
  const int cpr = padded_depth(d) / 2;
  const long quads = ((long)n + c) * (cpr / 2);
  return (int)by_dtype(bf16_in, [&](auto t) {
    using T = decltype(t);
    split_kernel<T>
        <<<(unsigned)((quads + kSplitThreads - 1) / kSplitThreads),
           kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const T*>(w),
            reinterpret_cast<float4*>(xp), reinterpret_cast<float4*>(wp), n,
            c, d, cpr);
    return cudaGetLastError();
  });
}

// dX (n, d) for the upstream cotangent g (n,) of the loss (pluck) or of
// the lse. part: (splits, n, d) f32 scratch, unused (may be null) when
// splits == 1. bf16_in: the planes hold bfloat16 operands, and the
// cotangent is rounded to bf16 before its product (the reference's
// gw.astype(w.dtype)); dx is f32 either way.
extern "C" int linear_ce_dx_launch(const float* xp, const float* wp,
                                   const int* tgt, const float* lse,
                                   const float* g, float* part, float* dx,
                                   int n, int c, int d, int splits, int pluck,
                                   float cap, int bf16_in, void* stream) {
  if (!shapes_ok(n, c, d) || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && part == nullptr) || (pluck && tgt == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(d, false);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdProblem a = bwd_problem(false, xp, wp, tgt, lse, g, n, c, d, cap,
                             p.stages);
  a.tiles_per_split = tiles_per_split(s_tiles(c), splits);
  return (int)with_flags(pluck != 0, cap > 0.f, [&](auto pl, auto cp) {
    constexpr bool PL = decltype(pl)::value;
    constexpr bool CP = decltype(cp)::value;
    const int bm = kWarpRows * p.warps;
    const dim3 grid((n + bm - 1) / bm, splits, out_chunks(d));
    cudaError_t err = with_bool(bf16_in != 0, [&](auto one) {
      constexpr bool ONE = decltype(one)::value;
      cudaError_t e = bwd_kernel_ready<false, PL, CP, ONE>();
      if (e != cudaSuccess) return e;
      ce_bwd_kernel<false, PL, CP, ONE><<<grid, 32 * p.warps, p.smem, st>>>(
          a, splits > 1 ? part : dx);
      return cudaGetLastError();
    });
    if (err != cudaSuccess || splits == 1) return err;
    const long nd = (long)n * d;
    sum_splits_kernel<<<(unsigned)((nd + kMergeThreads - 1) / kMergeThreads),
                        kMergeThreads, 0, st>>>(part, dx, nd, splits);
    return cudaGetLastError();
  });
}

// dW (c, d) for the upstream cotangent g (n,), every row written once;
// bf16_in as linear_ce_dx_launch's.
extern "C" int linear_ce_dw_launch(const float* xp, const float* wp,
                                   const int* tgt, const float* lse,
                                   const float* g, float* dw, int n, int c,
                                   int d, int pluck, float cap, int bf16_in,
                                   void* stream) {
  if (!shapes_ok(n, c, d) || (pluck && tgt == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(d, true);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdProblem a = bwd_problem(true, xp, wp, tgt, lse, g, n, c, d, cap,
                             p.stages);
  a.tiles_per_split = s_tiles(n);
  return (int)with_flags(pluck != 0, cap > 0.f, [&](auto pl, auto cp) {
    constexpr bool PL = decltype(pl)::value;
    constexpr bool CP = decltype(cp)::value;
    const int bm = kWarpRows * p.warps;
    const dim3 grid((c + bm - 1) / bm, 1, out_chunks(d));
    return with_bool(bf16_in != 0, [&](auto one) {
      constexpr bool ONE = decltype(one)::value;
      cudaError_t err = bwd_kernel_ready<true, PL, CP, ONE>();
      if (err != cudaSuccess) return err;
      ce_bwd_kernel<true, PL, CP, ONE><<<grid, 32 * p.warps, p.smem, st>>>(
          a, dw);
      return cudaGetLastError();
    });
  });
}

// The deep entries, for any d > 0 (the resident ones above take
// d ≤ 256): x (n, d), w (c, d) f32, or both bfloat16 with bf16_in, read as
// they are (no planes); slab an (n, chunk) f32 workspace, chunk a
// multiple of 4 (the wrapper takes 128 · ⌊budget / 128⌋ catalog rows).

// Forward: lse (n,), and with pluck loss (n,); state (n, 3) f32 scratch.
extern "C" int linear_ce_fwd_deep_launch(const void* x, const void* w,
                                         const int* tgt, float* slab,
                                         float* state, float* loss,
                                         float* lse, int n, int c, int d,
                                         int chunk, int pluck, float cap,
                                         int bf16_in, void* stream) {
  if (!shapes_ok(n, c, d, true) || chunk < 1 || chunk % 4 != 0 ||
      (pluck && (tgt == nullptr || loss == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_flags(pluck != 0, cap > 0.f, [&](auto pl, auto cp) {
    constexpr bool PL = decltype(pl)::value;
    constexpr bool CP = decltype(cp)::value;
    for (long c0 = 0; c0 < c; c0 += chunk) {
      const int cc = (int)(c - c0 < chunk ? c - c0 : chunk);
      cudaError_t err =
          bf16_in ? chunk_logits<bf16>(x, w, slab, chunk, n, (int)c0, cc, d, st)
                  : chunk_logits<float>(x, w, slab, chunk, n, (int)c0, cc, d,
                                        st);
      if (err != cudaSuccess) return err;
      deep_fold_kernel<PL, CP>
          <<<(n + kFoldWarps - 1) / kFoldWarps, 32 * kFoldWarps, 0, st>>>(
              slab, chunk, tgt, state, n, (int)c0, cc, c0 == 0, cap);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    deep_finish_kernel<PL>
        <<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, st>>>(
            state, loss, lse, n);
    return cudaGetLastError();
  });
}

// dX (n, d) and dW (c, d) — either may be null, not both — for the
// upstream cotangent g (n,), each chunk's cotangent written once and read
// by both products: dX += G · w_chunk over the chunks in order (the first
// writes), dW's chunk rows = Gᵀ · x, each written once; both f32. With
// bf16_in the cotangent is rounded to bf16 into gslab, (n, ⌈chunk / 8⌉·8)
// bf16 (null for f32 operands), and both products run on gemm_bf16.
extern "C" int linear_ce_bwd_deep_launch(const void* x, const void* w,
                                         const int* tgt, const float* lse,
                                         const float* g, float* dx, float* dw,
                                         float* slab, void* gslab, int n,
                                         int c, int d, int chunk, int pluck,
                                         float cap, int bf16_in,
                                         void* stream) {
  if (!shapes_ok(n, c, d, true) || chunk < 1 || chunk % 4 != 0 ||
      (pluck && tgt == nullptr) || (dx == nullptr && dw == nullptr) ||
      (bf16_in && gslab == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* const gb = static_cast<bf16*>(gslab);
  return (int)by_dtype(bf16_in, [&](auto t) {
  using T = decltype(t);
  constexpr bool BF = sizeof(T) == 2;
  return with_flags(pluck != 0, cap > 0.f, [&](auto pl, auto cp) {
    constexpr bool PL = decltype(pl)::value;
    constexpr bool CP = decltype(cp)::value;
    for (long c0 = 0; c0 < c; c0 += chunk) {
      const int cc = (int)(c - c0 < chunk ? c - c0 : chunk);
      cudaError_t err =
          chunk_logits<T>(x, w, slab, chunk, n, (int)c0, cc, d, st);
      if (err != cudaSuccess) return err;
      deep_cotangent_kernel<PL, CP, BF>
          <<<(unsigned)(n < (1 << 20) ? n : 1 << 20), 256, 0, st>>>(
              slab, gb, chunk, tgt, lse, g, n, (int)c0, cc, cap);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      deep_tc::Gemm p{};
      p.a = BF ? static_cast<const void*>(gb) : slab;
      p.lda = BF ? g_pitch(chunk) : chunk;
      p.ldo = d;
      p.n = d;
      p.ldb = d;
      if (dx != nullptr) {  // dX[r] += Σ_j G[r][j]·w[c0 + j]
        deep_tc::Gemm q = p;
        q.b = static_cast<const T*>(w) + c0 * d;
        q.out = dx;
        q.m = n;
        q.k = cc;
        if constexpr (BF)
          err = c0 == 0 ? bf16_gemm<false, true, false>(q, st)
                        : bf16_gemm<false, true, true>(q, st);
        else
          err = c0 == 0 ? tc_gemm<false, true, false, false, float, T>(q, st)
                        : tc_gemm<false, true, true, false, float, T>(q, st);
        if (err != cudaSuccess) return err;
      }
      if (dw != nullptr) {  // dW[c0 + j] = Σ_r G[r][j]·x[r]
        p.b = x;
        p.out = dw + c0 * d;
        p.m = cc;
        p.k = n;
        if constexpr (BF)
          err = bf16_gemm<true, true, false>(p, st);
        else
          err = tc_gemm<true, true, false, false, float, T>(p, st);
        if (err != cudaSuccess) return err;
      }
    }
    return cudaSuccess;
  });
  });
}

// deep_tc.cuh's products on their own, in every operand option (the
// entry of tests and probes; the deep variants above call them inline):
// `batch` products C[t] = A[t] · B[t]ᵀ of deep_tc::Gemm's shapes, out = C
// or, with acc, out += C. f32 operands: the 3xTF32 product. With bf16_in
// both operands are bfloat16: gemm_bf16.
extern "C" int deep_tc_launch(const void* a, const void* b,
                              const int* idx, const int* m_zero, float* out,
                              int m, int n, int k, int lda, int ldb, int ldo,
                              long a_batch, long b_batch, long idx_batch,
                              long out_batch, long mz_batch, int b_rows,
                              int batch, int a_km, int b_kn, int gather,
                              int acc, int bf16_in, void* stream) {
  if (gather && (idx == nullptr || b_rows < 1))
    return (int)cudaErrorInvalidValue;
  deep_tc::Gemm g{a,   a_batch,   lda, b,      b_batch,  ldb,
                  idx, idx_batch, b_rows, out, out_batch, ldo,
                  m_zero, mz_batch, m, n, k, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_in)
    return (int)with_bool(a_km != 0, [&](auto akm) {
      return with_bool(b_kn != 0, [&](auto bkn) {
        return with_bool(gather != 0, [&](auto gat) {
          return with_bool(acc != 0, [&](auto ac) {
            return bf16_gemm<decltype(akm)::value, decltype(bkn)::value,
                             decltype(ac)::value, decltype(gat)::value>(
                g, st, batch);
          });
        });
      });
    });
  return (int)with_bool(a_km != 0, [&](auto akm) {
    return with_bool(b_kn != 0, [&](auto bkn) {
      return with_bool(gather != 0, [&](auto gat) {
        return with_bool(acc != 0, [&](auto ac) {
          return tc_gemm<decltype(akm)::value, decltype(bkn)::value,
                         decltype(ac)::value, decltype(gat)::value>(g, st,
                                                                   batch);
        });
      });
    });
  });
}
