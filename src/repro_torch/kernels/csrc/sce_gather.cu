// sce_gather — in-bucket SCE with the candidate rows gathered from the
// catalog inside the kernel, forward and backward, written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels behind `sce_gather_loss` and
// `sce_gather_plse` of src/repro/kernels/sce_prefetch.py: `_gfwd_kernel`
// (forward, with_pos true for the loss, false for the partial LSE),
// `_gbwd_dx_kernel` (dX) and `_gbwd_dy_kernel` (dY), the backward shared
// by both as in the reference (`_plse_vjp_bwd` calls the loss's `_gbwd`).
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
// What bounds it on an H100. At the paper's training shape (n_b = 320
// buckets, b_x = 320 positions, b_y = 256 candidates, d = 64, C = 173,520)
// the forward is 2·320·320·256·64 ≈ 3.36 GFLOP of f32 FMAs against
// ≈ 47 MB that must move (x_b, the gathered rows, the outputs): 0.050 ms
// at 67 TFLOP/s against 0.014 ms at 3.35 TB/s, so the f32 FMA rate bounds
// it. dX and dY each recompute the logits and run a second product of the
// same size, 6.7 GFLOP: 0.100 ms each. The logits stay f32 FMAs in a
// fixed order over d (no TF32, no tensor cores), so the port's losses and
// gradients keep f32 precision next to the plain version.
//
// Design. The TPU grid walks the candidates one row at a time on a
// sequential axis, gathering each row by scalar prefetch into a VMEM tile;
// on Hopper that axis would be one block. Here each block owns a 64 × 64
// tile pair and loops itself:
//   * forward and dX: grid (n_b, ceil(b_x / 64)). A block stages its 64
//     rows of x_b in shared memory once, then walks the bucket's
//     candidates 64 at a time: it reads the 64 catalog row ids, gathers
//     those rows of Y into shared memory (the pointer gather takes the
//     place of scalar prefetch) and computes the 64 × 64 logit tile as a
//     4 × 4 register tile per thread from float4 shared-memory reads, the
//     loop structure of csrc/mips_topk.cu (the tile code is in
//     csrc/f32_tile.cuh, shared with csrc/linear_ce.cu). The forward folds
//     each tile into a per-row online logsumexp held in registers by the
//     16 threads that share a row (half-warp shuffles reduce the tile's
//     max and sum),
//     starting from (m, s) = (pos, 1) so the positive is counted once
//     (the partial LSE, template flag WITH_POS false, from (NEG_INF, 0)
//     and with no positive to read). The partial LSE's rows with no owned
//     candidate are the common case in the distributed exact mode — every
//     candidate another shard owns arrives as cand = −1 — and cost the
//     same tile walk as any other row. dX
//     recomputes the tile, turns it into gw, stores gwᵀ in shared memory
//     and accumulates gw · Y_tile into registers.
//   * dY: grid (n_b, ceil(b_y / 64)), the transposed walk. A block gathers
//     its 64 candidate rows once and loops over all b_x rows of the bucket
//     64 at a time, recomputing the logits and accumulating gwᵀ · x_b into
//     registers; it then adds its 64 × d result into dY[r_j].
//   * b_x = 320 and b_y = 256 need no padding copies: rows past b_x and
//     candidates past b_y are staged as zeros and masked in the kernel.
//   * dY's scatter is an f32 atomicAdd, skipped for candidates with a
//     negative id (their sum is exactly 0): in the distributed exact mode
//     ≈ 75 % of a 4-way shard's candidates are another shard's and clamp
//     to one row, whose atomics would otherwise serialise (4.7× the dY
//     time on such a shard, PERF.md). Rows within one bucket are distinct
//     (they come from a top-k), but a hot catalog row recurs across
//     buckets, and blocks run in no order. A deterministic scheme would
//     need a per-bucket (n_b, b_y, d) buffer — the tensor the gather kernel
//     exists to avoid — plus a sort by row and a segmented sum. With
//     atomics the order of the additions changes from run to run, so dY is
//     not bitwise repeatable: tests compare it within a tolerance, never
//     bit for bit. The wrapper zeroes dY first, so rows no bucket selected
//     come out exactly 0.
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes in src/repro_torch/kernels/sce_prefetch.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_tile.cuh"

namespace {

using namespace f32_tile;

constexpr int kTileX = kTile;  // 64 rows of x_b per tile
constexpr int kTileY = kTile;  // 64 candidates per tile

size_t smem_bytes(int d, bool with_gw) {
  return sizeof(float) * ((size_t)(kTileX + kTileY) * row_pitch(d) +
                          (with_gw ? (size_t)kTileX * kGwPitch : 0)) +
         sizeof(int) * 2 * kTileY;
}

// Loads the catalog row ids (clamped to [0, C)) and candidate ids of
// candidates [j0, j0 + ny) of bucket n; slots past ny get row 0 and id −1.
__device__ __forceinline__ void load_candidates(const int* idx_y,
                                                const int* cand, int* rows,
                                                int* cands, long base, int ny,
                                                int c, int tid) {
  if (tid < kTileY) {
    int r = 0;
    int id = -1;
    if (tid < ny) {
      r = idx_y[base + tid];
      r = r < 0 ? 0 : (r >= c ? c - 1 : r);
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
template <bool WITH_POS>
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
    load_candidates(idx_y, cand, rows, cands, (long)n * b_y + j0, ny, c,
                    tid);
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
// dX: 64 rows of one bucket, the same walk as the forward.
// ---------------------------------------------------------------------------
template <int NC>
__global__ void __launch_bounds__(kThreads)
sce_gather_dx_kernel(const float* __restrict__ x_b,
                     const float* __restrict__ y,
                     const int* __restrict__ idx_y,
                     const int* __restrict__ tgt_b,
                     const int* __restrict__ cand,
                     const float* __restrict__ lse_in,
                     const float* __restrict__ g_in, float* __restrict__ dx,
                     int b_x, int b_y, int c, int d, float cap, int vec_x,
                     int vec_y) {
  extern __shared__ float4 smem4[];
  const int p = row_pitch(d);
  const int d4 = (d + 3) / 4;
  float* xs = reinterpret_cast<float*>(smem4);  // (kTileX, p)
  float* ys = xs + kTileX * p;                  // (kTileY, p)
  float* gwt = ys + kTileY * p;                 // (kTileY, kGwPitch): gwᵀ
  int* rows = reinterpret_cast<int*>(gwt + kTileY * kGwPitch);
  int* cands = rows + kTileY;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int n = blockIdx.x;
  const int x0 = blockIdx.y * kTileX;
  const int nx = min(kTileX, b_x - x0);
  const long row0 = (long)n * b_x + x0;

  stage(xs, x_b + row0 * d, nx, kTileX, d, p, vec_x, [](int r) { return r; },
        tid);
  float ls[kRM], gs[kRM];
  int tg[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = ty * kRM + i;
    ls[i] = r < nx ? lse_in[row0 + r] : 0.f;
    gs[i] = r < nx ? g_in[row0 + r] : 0.f;
    tg[i] = r < nx ? tgt_b[row0 + r] : -2;
  }
  float acc_dx[kRM][NC][4];
  zero<NC>(acc_dx);

  for (int j0 = 0; j0 < b_y; j0 += kTileY) {
    const int ny = min(kTileY, b_y - j0);
    __syncthreads();  // the previous tile and gwᵀ are no longer read
    load_candidates(idx_y, cand, rows, cands, (long)n * b_y + j0, ny, c,
                    tid);
    __syncthreads();
    stage(ys, y, ny, kTileY, d, p, vec_y, [rows](int r) { return rows[r]; },
          tid);
    __syncthreads();
    float acc[kRM][kCols];
    tile_scores(xs, ys, p, d4, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        const float l = capped(acc[i][j], cap);
        const float pr =
            masked(col, ny, cands[col], tg[i]) ? 0.f : expf(l - ls[i]);
        gwt[col * kGwPitch + ty * kRM + i] = pr * cap_deriv(l, cap) * gs[i];
      }
    __syncthreads();
    accumulate<NC>(gwt, ys, ny, p, d4, ty, tx, acc_dx);
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = ty * kRM + i;
    if (r >= nx) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = kChunk * cc + 4 * tx + q;
        if (col < d) dx[(row0 + r) * d + col] = acc_dx[i][cc][q];
      }
  }
}

// ---------------------------------------------------------------------------
// dY: 64 candidates of one bucket, the transposed walk over its b_x rows,
// then an atomic add into their catalog rows.
// ---------------------------------------------------------------------------
template <int NC>
__global__ void __launch_bounds__(kThreads)
sce_gather_dy_kernel(const float* __restrict__ x_b,
                     const float* __restrict__ y,
                     const int* __restrict__ idx_y,
                     const int* __restrict__ tgt_b,
                     const int* __restrict__ cand,
                     const float* __restrict__ lse_in,
                     const float* __restrict__ g_in, float* __restrict__ dy,
                     int b_x, int b_y, int c, int d, float cap, int vec_x,
                     int vec_y) {
  extern __shared__ float4 smem4[];
  const int p = row_pitch(d);
  const int d4 = (d + 3) / 4;
  float* xs = reinterpret_cast<float*>(smem4);  // (kTileX, p)
  float* ys = xs + kTileX * p;                  // (kTileY, p)
  float* gw = ys + kTileY * p;                  // (kTileX, kGwPitch)
  int* rows = reinterpret_cast<int*>(gw + kTileX * kGwPitch);
  int* cands = rows + kTileY;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int n = blockIdx.x;
  const int j0 = blockIdx.y * kTileY;
  const int ny = min(kTileY, b_y - j0);

  load_candidates(idx_y, cand, rows, cands, (long)n * b_y + j0, ny, c, tid);
  __syncthreads();
  stage(ys, y, ny, kTileY, d, p, vec_y, [rows](int r) { return rows[r]; },
        tid);
  float acc_dy[kRM][NC][4];
  zero<NC>(acc_dy);

  for (int x0 = 0; x0 < b_x; x0 += kTileX) {
    const int nx = min(kTileX, b_x - x0);
    const long row0 = (long)n * b_x + x0;
    __syncthreads();  // the previous rows and gw are no longer read
    stage(xs, x_b + row0 * d, nx, kTileX, d, p, vec_x,
          [](int r) { return r; }, tid);
    __syncthreads();
    float acc[kRM][kCols];
    tile_scores(xs, ys, p, d4, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = ty * kRM + i;
      const bool live = r < nx;
      const float ls = live ? lse_in[row0 + r] : 0.f;
      const float g = live ? g_in[row0 + r] : 0.f;
      const int tg = live ? tgt_b[row0 + r] : -2;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        const float l = capped(acc[i][j], cap);
        const float pr =
            !live || masked(col, ny, cands[col], tg) ? 0.f : expf(l - ls);
        gw[r * kGwPitch + col] = pr * cap_deriv(l, cap) * g;
      }
    }
    __syncthreads();
    accumulate<NC>(gw, xs, nx, p, d4, ty, tx, acc_dy);
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int j = ty * kRM + i;
    // A candidate with a negative id is masked on every row: its sum is
    // exactly 0 and its clamped row is not written.
    if (j >= ny || cands[j] < 0) continue;
    float* out = dy + (long)rows[j] * d;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = kChunk * cc + 4 * tx + q;
        if (col < d) atomicAdd(out + col, acc_dy[i][cc][q]);
      }
  }
}

// Opts `kernel` in to the full kMaxSmem of dynamic shared memory, once per
// device (the attribute is per device context). `slot` names the kernel.
template <typename K>
cudaError_t allow_max_smem(K kernel, int slot) {
  static bool done[10][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[slot][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[slot][dev] = true;
  return err;
}

bool shapes_ok(int n_b, int b_x, int b_y, int c, int d) {
  return n_b > 0 && b_x > 0 && b_y > 0 && c > 0 && d > 0 && d <= kMaxD &&
         (b_x + kTileX - 1) / kTileX <= 65535 &&
         (b_y + kTileY - 1) / kTileY <= 65535;
}

// Launches the forward with the positive (slot 0) or the partial LSE
// (slot 9); `pos` and `loss` are null for the latter.
template <bool WITH_POS>
int launch_fwd(const float* x_b, const float* y, const int* idx_y,
               const int* tgt_b, const int* cand, const float* pos,
               float* loss, float* lse, int n_b, int b_x, int b_y, int c,
               int d, float cap, void* stream) {
  if (!shapes_ok(n_b, b_x, b_y, c, d)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, false);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      allow_max_smem(sce_gather_fwd_kernel<WITH_POS>, WITH_POS ? 0 : 9);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_b, (b_x + kTileX - 1) / kTileX);
  sce_gather_fwd_kernel<WITH_POS><<<grid, kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      x_b, y, idx_y, tgt_b, cand, pos, loss, lse, b_x, b_y, c, d, cap,
      vec_flag(x_b, d), vec_flag(y, d));
  return (int)cudaGetLastError();
}

// Launches the dX (kind 0) or dY (kind 1) kernel at NC = ceil(d / 64).
template <int NC>
cudaError_t launch_bwd(int kind, const float* x_b, const float* y,
                       const int* idx_y, const int* tgt_b, const int* cand,
                       const float* lse, const float* g, float* out, int n_b,
                       int b_x, int b_y, int c, int d, float cap,
                       cudaStream_t s) {
  const size_t smem = smem_bytes(d, true);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const int vx = vec_flag(x_b, d);
  const int vy = vec_flag(y, d);
  cudaError_t err;
  if (kind == 0) {
    err = allow_max_smem(sce_gather_dx_kernel<NC>, NC);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_b, (b_x + kTileX - 1) / kTileX);
    sce_gather_dx_kernel<NC><<<grid, kThreads, smem, s>>>(
        x_b, y, idx_y, tgt_b, cand, lse, g, out, b_x, b_y, c, d, cap, vx, vy);
  } else {
    err = allow_max_smem(sce_gather_dy_kernel<NC>, 4 + NC);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_b, (b_y + kTileY - 1) / kTileY);
    sce_gather_dy_kernel<NC><<<grid, kThreads, smem, s>>>(
        x_b, y, idx_y, tgt_b, cand, lse, g, out, b_x, b_y, c, d, cap, vx, vy);
  }
  return cudaGetLastError();
}

int launch_bwd_any(int kind, const float* x_b, const float* y,
                   const int* idx_y, const int* tgt_b, const int* cand,
                   const float* lse, const float* g, float* out, int n_b,
                   int b_x, int b_y, int c, int d, float cap, void* stream) {
  if (!shapes_ok(n_b, b_x, b_y, c, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + kChunk - 1) / kChunk) {
    case 1:
      return (int)launch_bwd<1>(kind, x_b, y, idx_y, tgt_b, cand, lse, g, out,
                                n_b, b_x, b_y, c, d, cap, s);
    case 2:
      return (int)launch_bwd<2>(kind, x_b, y, idx_y, tgt_b, cand, lse, g, out,
                                n_b, b_x, b_y, c, d, cap, s);
    case 3:
      return (int)launch_bwd<3>(kind, x_b, y, idx_y, tgt_b, cand, lse, g, out,
                                n_b, b_x, b_y, c, d, cap, s);
    case 4:
      return (int)launch_bwd<4>(kind, x_b, y, idx_y, tgt_b, cand, lse, g, out,
                                n_b, b_x, b_y, c, d, cap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  return launch_fwd<true>(x_b, y, idx_y, tgt_b, cand, pos, loss, lse, n_b,
                          b_x, b_y, c, d, cap, stream);
}

extern "C" int sce_gather_plse_fwd_launch(const float* x_b, const float* y,
                                          const int* idx_y,
                                          const int* tgt_b, const int* cand,
                                          float* plse, int n_b, int b_x,
                                          int b_y, int c, int d, float cap,
                                          void* stream) {
  return launch_fwd<false>(x_b, y, idx_y, tgt_b, cand, nullptr, nullptr,
                           plse, n_b, b_x, b_y, c, d, cap, stream);
}

extern "C" int sce_gather_dx_launch(const float* x_b, const float* y,
                                    const int* idx_y, const int* tgt_b,
                                    const int* cand, const float* lse,
                                    const float* g, float* dx, int n_b,
                                    int b_x, int b_y, int c, int d,
                                    float cap, void* stream) {
  return launch_bwd_any(0, x_b, y, idx_y, tgt_b, cand, lse, g, dx, n_b, b_x,
                        b_y, c, d, cap, stream);
}

extern "C" int sce_gather_dy_launch(const float* x_b, const float* y,
                                    const int* idx_y, const int* tgt_b,
                                    const int* cand, const float* lse,
                                    const float* g, float* dy, int n_b,
                                    int b_x, int b_y, int c, int d,
                                    float cap, void* stream) {
  return launch_bwd_any(1, x_b, y, idx_y, tgt_b, cand, lse, g, dy, n_b, b_x,
                        b_y, c, d, cap, stream);
}
