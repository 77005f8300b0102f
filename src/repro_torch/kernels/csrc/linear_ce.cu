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
// The softcap applies before the mask of the ragged last tile, as on the
// TPU (linear_sce.py:84-87): a padded column stays at NEG_INF, never −cap.
//
// What bounds it on an H100. At the paper's training shape (N = 25,600
// positions, C = 173,520 catalog rows, d = 64) the forward is
// 2·N·C·d = 5.69e11 f32 FLOPs against 51 MB that must move: 8.49 ms at
// 67 TFLOP/s against 0.015 ms at 3.35 TB/s. dX and dW each recompute the
// logits and take a product of the same size, 1.14e12 FLOPs, 16.97 ms. So
// the f32 FMA rate bounds all three. The products stay f32 FMAs in a fixed
// order over d (f32_tile.cuh; no TF32, no tensor cores), so the losses and
// gradients keep f32 precision next to the plain version.
//
// Design. The TPU grid carries (m, s, pos) along a sequential catalog axis;
// on Hopper a block owns a tile and loops itself.
//   * forward and dX: a block owns 64 positions, stages their rows of x in
//     shared memory once and streams its share of the catalog through
//     shared memory 64 rows at a time, computing each 64 × 64 logit tile
//     as a 4 × 4 register tile per thread. The forward keeps per thread and
//     row an online (m, s) over the thread's columns (and the plucked
//     positive), merged over the row's 16 threads by half-warp shuffles in
//     a fixed tree at the end. dX turns each tile into gw, stores gwᵀ in
//     shared memory and accumulates gw · w_tile into a (64, d) register
//     accumulator.
//   * 400 position tiles at N = 25,600 fill the 132 SMs in about 1.5
//     waves, so the catalog is cut into S contiguous splits (grid
//     (N / 64, S)), S the least number whose blocks fill their last wave to
//     90 % (the occupancy calculator gives the blocks per SM). Each split
//     writes its partial (m, s, pos) per row, or its partial dX, and a
//     second kernel merges them per row in split order. No atomics: every
//     result repeats bit for bit.
//   * dW (dY for fused_ce): the transposed grid, as on the TPU. A block
//     owns 64 catalog rows, stages them once, streams all N positions 64 at
//     a time (recomputing the capped tile from the saved lse) and writes
//     each output row once: deterministic. The one-hot term hits a target's
//     column once per position, so a target shared by many positions is
//     summed over them inside the block's loop. At C = 173,520 that is
//     2,712 blocks, enough waves that no split is needed.
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes in src/repro_torch/kernels/linear_sce.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "f32_tile.cuh"

namespace {

using namespace f32_tile;

constexpr int kMaxSplits = 64;
constexpr int kMergeThreads = 256;

// One call's inputs. `tgt` is null without PLUCK; `lse` and `g` are null
// in the forward.
struct Problem {
  const float* x;    // (n, d)
  const float* w;    // (c, d)
  const int* tgt;    // (n,)
  const float* lse;  // (n,)
  const float* g;    // (n,)
  int n, c, d;
  float cap;
  int vec_x, vec_w;
  int tiles_per_split;  // catalog tiles of one split (forward, dX)
};

size_t smem_bytes(int d, bool with_gw) {
  return sizeof(float) * ((size_t)2 * kTile * row_pitch(d) +
                          (with_gw ? (size_t)kTile * kGwPitch : 0));
}

template <bool CAP>
__device__ __forceinline__ float logit(float v, float cap) {
  return CAP ? capped(v, cap) : v;
}

// The backward tile's entry: (p − onehot) · cap′ · g, 0 on padded columns.
template <bool PLUCK, bool CAP>
__device__ __forceinline__ float cotangent(float l, float lse, float g,
                                           bool live, bool hit, float cap) {
  if (!live) return 0.f;
  float p = expf(l - lse);
  if (PLUCK && hit) p -= 1.f;
  if (CAP) p *= cap_deriv(l, cap);
  return p * g;
}

// ---------------------------------------------------------------------------
// Forward: per row and split, the partial (m, s, pos) over the split.
// ---------------------------------------------------------------------------
template <bool PLUCK, bool CAP>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(Problem a, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int p = row_pitch(a.d);
  const int d4 = (a.d + 3) / 4;
  float* xs = reinterpret_cast<float*>(smem4);  // (kTile, p)
  float* ws = xs + kTile * p;                   // (kTile, p)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int r0 = blockIdx.x * kTile;
  const int nr = min(kTile, a.n - r0);
  const long c_lo = (long)blockIdx.y * a.tiles_per_split * kTile;
  const long c_hi = min((long)a.c, c_lo + (long)a.tiles_per_split * kTile);

  stage(xs, a.x + (long)r0 * a.d, nr, kTile, a.d, p, a.vec_x,
        [](int r) { return r; }, tid);
  float m[kRM], s[kRM], ps[kRM];
  int tg[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = ty * kRM + i;
    m[i] = kNegInf;
    s[i] = 0.f;
    ps[i] = 0.f;
    tg[i] = PLUCK && r < nr ? a.tgt[r0 + r] : -1;
  }

  for (long c0 = c_lo; c0 < c_hi; c0 += kTile) {
    const int nc = (int)min((long)kTile, c_hi - c0);
    __syncthreads();  // the previous tile is no longer read
    stage(ws, a.w + c0 * a.d, nc, kTile, a.d, p, a.vec_w,
          [](int r) { return r; }, tid);
    __syncthreads();
    float acc[kRM][kCols];
    tile_scores(xs, ws, p, d4, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      float l[kCols];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        const float v = logit<CAP>(acc[i][j], a.cap);
        if (PLUCK && col < nc && c0 + col == tg[i]) ps[i] += v;
        l[j] = col < nc ? v : kNegInf;
        tmax = fmaxf(tmax, l[j]);
      }
      const float mn = fmaxf(m[i], tmax);
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        se += tx + 16 * j < nc ? expf(l[j] - mn) : 0.f;
      s[i] = s[i] * expf(m[i] - mn) + se;
      m[i] = mn;
    }
  }

  // Merge the 16 threads of each row, a fixed tree over the half-warp.
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    float mi = m[i], si = s[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(kFull, mi, o);
      const float so = __shfl_xor_sync(kFull, si, o);
      const float mn = fmaxf(mi, mo);
      si = si * expf(mi - mn) + so * expf(mo - mn);
      mi = mn;
    }
    const float pi = PLUCK ? half_warp_sum(ps[i]) : 0.f;
    const int r = ty * kRM + i;
    if (tx == 0 && r < nr) {
      float* q = part + ((long)blockIdx.y * a.n + r0 + r) * 3;
      q[0] = mi;
      q[1] = si;
      q[2] = pi;
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
    const float mn = fmaxf(m, q[0]);
    s = s * expf(m - mn) + q[1] * expf(q[0] - mn);
    m = mn;
    pos += q[2];
  }
  const float l = m + logf(s);
  lse[r] = l;
  if (PLUCK) loss[r] = l - pos;
}

// ---------------------------------------------------------------------------
// dX: 64 positions against one split of the catalog.
// ---------------------------------------------------------------------------
template <int NC, bool PLUCK, bool CAP>
__global__ void __launch_bounds__(kThreads)
ce_dx_kernel(Problem a, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int p = row_pitch(a.d);
  const int d4 = (a.d + 3) / 4;
  float* xs = reinterpret_cast<float*>(smem4);  // (kTile, p)
  float* ws = xs + kTile * p;                   // (kTile, p)
  float* gwt = ws + kTile * p;                  // (kTile, kGwPitch): gwᵀ

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int r0 = blockIdx.x * kTile;
  const int nr = min(kTile, a.n - r0);
  const long c_lo = (long)blockIdx.y * a.tiles_per_split * kTile;
  const long c_hi = min((long)a.c, c_lo + (long)a.tiles_per_split * kTile);

  stage(xs, a.x + (long)r0 * a.d, nr, kTile, a.d, p, a.vec_x,
        [](int r) { return r; }, tid);
  float ls[kRM], gs[kRM];
  int tg[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = ty * kRM + i;
    ls[i] = r < nr ? a.lse[r0 + r] : 0.f;
    gs[i] = r < nr ? a.g[r0 + r] : 0.f;
    tg[i] = PLUCK && r < nr ? a.tgt[r0 + r] : -1;
  }
  float acc_dx[kRM][NC][4];
  zero<NC>(acc_dx);

  for (long c0 = c_lo; c0 < c_hi; c0 += kTile) {
    const int nc = (int)min((long)kTile, c_hi - c0);
    __syncthreads();  // the previous tile and gwᵀ are no longer read
    stage(ws, a.w + c0 * a.d, nc, kTile, a.d, p, a.vec_w,
          [](int r) { return r; }, tid);
    __syncthreads();
    float acc[kRM][kCols];
    tile_scores(xs, ws, p, d4, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        gwt[col * kGwPitch + ty * kRM + i] = cotangent<PLUCK, CAP>(
            logit<CAP>(acc[i][j], a.cap), ls[i], gs[i], col < nc,
            c0 + col == tg[i], a.cap);
      }
    __syncthreads();
    accumulate<NC>(gwt, ws, nc, p, d4, ty, tx, acc_dx);
  }

  float* dst = out + (long)blockIdx.y * a.n * a.d;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = ty * kRM + i;
    if (r >= nr) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = kChunk * cc + 4 * tx + q;
        if (col < a.d) dst[(long)(r0 + r) * a.d + col] = acc_dx[i][cc][q];
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
// dW: 64 catalog rows against all N positions (the transposed grid).
// ---------------------------------------------------------------------------
template <int NC, bool PLUCK, bool CAP>
__global__ void __launch_bounds__(kThreads)
ce_dw_kernel(Problem a, float* __restrict__ dw) {
  extern __shared__ float4 smem4[];
  const int p = row_pitch(a.d);
  const int d4 = (a.d + 3) / 4;
  float* xs = reinterpret_cast<float*>(smem4);  // (kTile, p)
  float* ws = xs + kTile * p;                   // (kTile, p)
  float* gw = ws + kTile * p;                   // (kTile, kGwPitch)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const long c0 = (long)blockIdx.x * kTile;
  const int nc = (int)min((long)kTile, a.c - c0);

  stage(ws, a.w + c0 * a.d, nc, kTile, a.d, p, a.vec_w,
        [](int r) { return r; }, tid);
  float acc_dw[kRM][NC][4];
  zero<NC>(acc_dw);

  for (int r0 = 0; r0 < a.n; r0 += kTile) {
    const int nr = min(kTile, a.n - r0);
    __syncthreads();  // the previous rows and gw are no longer read
    stage(xs, a.x + (long)r0 * a.d, nr, kTile, a.d, p, a.vec_x,
          [](int r) { return r; }, tid);
    __syncthreads();
    float acc[kRM][kCols];
    tile_scores(xs, ws, p, d4, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = ty * kRM + i;
      const bool live = r < nr;
      const float ls = live ? a.lse[r0 + r] : 0.f;
      const float g = live ? a.g[r0 + r] : 0.f;
      const int tg = PLUCK && live ? a.tgt[r0 + r] : -1;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        gw[r * kGwPitch + col] = cotangent<PLUCK, CAP>(
            logit<CAP>(acc[i][j], a.cap), ls, g, live && col < nc,
            c0 + col == tg, a.cap);
      }
    }
    __syncthreads();
    accumulate<NC>(gw, xs, nr, p, d4, ty, tx, acc_dw);
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int j = ty * kRM + i;
    if (j >= nc) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = kChunk * cc + 4 * tx + q;
        if (col < a.d) dw[(c0 + j) * a.d + col] = acc_dw[i][cc][q];
      }
  }
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

// Calls f(NC) with NC = ceil(d / 64) ∈ {1, .., 4} as an integral_constant.
template <class F>
cudaError_t with_chunks(int d, F&& f) {
  switch ((d + kChunk - 1) / kChunk) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

// Opts `kernel` in to kMaxSmem of dynamic shared memory, once per device;
// `done` is the caller's per-kernel table.
template <class K>
cudaError_t allow_max_smem(K kernel, bool (&done)[kMaxDevices]) {
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

// The least S ≤ min(kMaxSplits, catalog tiles) whose row_tiles·S blocks
// fill their last wave to 90 %, else the S that fills it best.
template <class K>
cudaError_t plan_splits(K kernel, size_t smem, int row_tiles, int c_tiles,
                        int* splits) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
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

bool shapes_ok(int n, int c, int d) {
  return n > 0 && c > 0 && d > 0 && d <= kMaxD && c <= (1 << 30);
}

Problem problem(const float* x, const float* w, const int* tgt,
                const float* lse, const float* g, int n, int c, int d,
                float cap) {
  Problem a{x, w, tgt, lse, g, n, c, d, cap, vec_flag(x, d), vec_flag(w, d),
            0};
  return a;
}

int c_tiles(int c) { return (c + kTile - 1) / kTile; }

// Splits of `c_tiles` catalog tiles into `splits` contiguous ranges.
int tiles_per_split(int c, int splits) {
  return (c_tiles(c) + splits - 1) / splits;
}

template <bool PLUCK, bool CAP>
cudaError_t fwd_kernel_ready() {
  static bool done[kMaxDevices] = {};
  return allow_max_smem(ce_fwd_kernel<PLUCK, CAP>, done);
}

template <int NC, bool PLUCK, bool CAP>
cudaError_t dx_kernel_ready() {
  static bool done[kMaxDevices] = {};
  return allow_max_smem(ce_dx_kernel<NC, PLUCK, CAP>, done);
}

template <int NC, bool PLUCK, bool CAP>
cudaError_t dw_kernel_ready() {
  static bool done[kMaxDevices] = {};
  return allow_max_smem(ce_dw_kernel<NC, PLUCK, CAP>, done);
}

}  // namespace

// The C interface, bound with ctypes. Shapes: x (n, d) f32, w (c, d) f32,
// tgt (n,) i32 (null unless pluck), lse, g, loss (n,) f32; all contiguous,
// d ≤ 256. `cap` > 0 is the logit softcap, 0 none. Each launcher returns
// the cudaError_t of its launches (0 on success), and cudaErrorInvalidValue
// for shapes it does not take. Nothing is synchronised and nothing is
// allocated.

// The number of catalog splits S the forward (kind 0) or dX (kind 1) runs
// at for these shapes and flags on the current device (≥ 1), or −err. The
// caller allocates the split scratch: (S, n, 3) floats for the forward,
// (S, n, d) for dX when S > 1.
extern "C" int linear_ce_splits(int kind, int n, int c, int d, int pluck,
                                float cap) {
  if (!shapes_ok(n, c, d) || kind < 0 || kind > 1)
    return -(int)cudaErrorInvalidValue;
  int splits = 1;
  const int row_tiles = (n + kTile - 1) / kTile;
  cudaError_t err = with_flags(pluck != 0, cap > 0.f, [&](auto pl, auto cp) {
    constexpr bool PL = decltype(pl)::value;
    constexpr bool CP = decltype(cp)::value;
    if (kind == 0) {
      cudaError_t e = fwd_kernel_ready<PL, CP>();
      if (e != cudaSuccess) return e;
      return plan_splits(ce_fwd_kernel<PL, CP>, smem_bytes(d, false),
                         row_tiles, c_tiles(c), &splits);
    }
    return with_chunks(d, [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      cudaError_t e = dx_kernel_ready<NC, PL, CP>();
      if (e != cudaSuccess) return e;
      return plan_splits(ce_dx_kernel<NC, PL, CP>, smem_bytes(d, true),
                         row_tiles, c_tiles(c), &splits);
    });
  });
  return err == cudaSuccess ? splits : -(int)err;
}

// Forward: lse (n,), and with pluck loss (n,) = lse − the target's logit.
// part: (splits, n, 3) f32 scratch.
extern "C" int linear_ce_fwd_launch(const float* x, const float* w,
                                    const int* tgt, float* part, float* loss,
                                    float* lse, int n, int c, int d,
                                    int splits, int pluck, float cap,
                                    void* stream) {
  if (!shapes_ok(n, c, d) || splits < 1 || splits > kMaxSplits ||
      (pluck && (tgt == nullptr || loss == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, false);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Problem a = problem(x, w, tgt, nullptr, nullptr, n, c, d, cap);
  a.tiles_per_split = tiles_per_split(c, splits);
  return (int)with_flags(pluck != 0, cap > 0.f, [&](auto pl, auto cp) {
    constexpr bool PL = decltype(pl)::value;
    constexpr bool CP = decltype(cp)::value;
    cudaError_t err = fwd_kernel_ready<PL, CP>();
    if (err != cudaSuccess) return err;
    const dim3 grid((n + kTile - 1) / kTile, splits);
    ce_fwd_kernel<PL, CP><<<grid, kThreads, smem, st>>>(a, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ce_fwd_merge_kernel<PL>
        <<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, st>>>(
            part, loss, lse, n, splits);
    return cudaGetLastError();
  });
}

// dX (n, d) for the upstream cotangent g (n,) of the loss (pluck) or of
// the lse. part: (splits, n, d) f32 scratch, unused (may be null) when
// splits == 1.
extern "C" int linear_ce_dx_launch(const float* x, const float* w,
                                   const int* tgt, const float* lse,
                                   const float* g, float* part, float* dx,
                                   int n, int c, int d, int splits, int pluck,
                                   float cap, void* stream) {
  if (!shapes_ok(n, c, d) || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && part == nullptr) || (pluck && tgt == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, true);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Problem a = problem(x, w, tgt, lse, g, n, c, d, cap);
  a.tiles_per_split = tiles_per_split(c, splits);
  return (int)with_flags(pluck != 0, cap > 0.f, [&](auto pl, auto cp) {
    constexpr bool PL = decltype(pl)::value;
    constexpr bool CP = decltype(cp)::value;
    return with_chunks(d, [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      cudaError_t err = dx_kernel_ready<NC, PL, CP>();
      if (err != cudaSuccess) return err;
      const dim3 grid((n + kTile - 1) / kTile, splits);
      ce_dx_kernel<NC, PL, CP>
          <<<grid, kThreads, smem, st>>>(a, splits > 1 ? part : dx);
      err = cudaGetLastError();
      if (err != cudaSuccess || splits == 1) return err;
      const long nd = (long)n * d;
      sum_splits_kernel<<<(unsigned)((nd + kMergeThreads - 1) /
                                     kMergeThreads),
                          kMergeThreads, 0, st>>>(part, dx, nd, splits);
      return cudaGetLastError();
    });
  });
}

// dW (c, d) for the upstream cotangent g (n,), every row written once.
extern "C" int linear_ce_dw_launch(const float* x, const float* w,
                                   const int* tgt, const float* lse,
                                   const float* g, float* dw, int n, int c,
                                   int d, int pluck, float cap,
                                   void* stream) {
  if (!shapes_ok(n, c, d) || (pluck && tgt == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, true);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Problem a = problem(x, w, tgt, lse, g, n, c, d, cap);
  return (int)with_flags(pluck != 0, cap > 0.f, [&](auto pl, auto cp) {
    constexpr bool PL = decltype(pl)::value;
    constexpr bool CP = decltype(cp)::value;
    return with_chunks(d, [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      cudaError_t err = dw_kernel_ready<NC, PL, CP>();
      if (err != cudaSuccess) return err;
      ce_dw_kernel<NC, PL, CP>
          <<<c_tiles(c), kThreads, smem, st>>>(a, dw);
      return cudaGetLastError();
    });
  });
}
