// eval_fused — the leave-one-out evaluation sweep, written by hand for
// Hopper (sm_90a), and eval_tgt_gather, the target score it compares
// against.
//
// Replaces the Pallas TPU kernels `_fused_kernel` (public `eval_fused`)
// and `_tgt_gather_kernel` (public `eval_tgt_gather`) of
// src/repro/kernels/eval_fused.py. It computes what they compute, not
// their block structure. For rows r with target id t_r and threshold
// tgt_r, over the columns c < C of y whose global id g = id_offset + c
// lies in [c_lo, c_hi) (the valid columns), with s = (x @ yᵀ)[r, c]:
//
//   vals, ids  top-k of s over the valid columns, keyed by (value
//              descending, id ascending); (NEG_INF, ID_PAD) where fewer
//              than k columns are valid;
//   gt         #{valid c : s > tgt_r and g ≠ t_r};
//   eq         #{valid c : s == tgt_r or g == t_r} — the target's own
//              column never counts into gt and always into eq;
//   m, s       (with_lse) the online logsumexp of softcap(s) over the
//              valid columns, lse = m + log s, from (NEG_INF, 0);
//   tgt        eval_tgt_gather: x[r] · y[t_r − id_offset], 0 where t_r is
//              outside [id_offset, id_offset + C).
//
// The threshold must be the very value the sweep computes for the target
// column, or eq misses it and every rank is off. The TPU kernel gets it
// from a gather product of the sweep's own tile shape (a same-shape gemm
// reduces in the same order). Here both kernels run one fold, fma4 of
// topk_tile.cuh from 0 over the depths in order: the sweep in its
// register tiles, eval_tgt_gather in dot_fma. So tgt is bit for bit the
// swept score of the target column, and eq ≥ 1 on every row whose target
// is valid.
//
// What bounds it on an H100. At B = 128 evaluated users, C = 173,520
// catalog rows, d = 64: 2·128·173,520·64 ≈ 2.84 GFLOP of f32 FMAs, at
// 67 TFLOP/s 0.042 ms; the catalog read, 44.4 MB at 3.35 TB/s, is
// 0.013 ms. So the FMA rate bounds it, and at B = 256 more so (0.085 ms).
// The scores stay f32 FMAs in a fixed order over d (no TF32, no tensor
// cores): ids, counts and the threshold must equal the plain version's,
// exactly on integer-valued inputs, where every fold order is exact.
// eval_tgt_gather reads B·(2d + 1) floats: a few KB, launch-bound.
//
// Design. The TPU kernel carries its merge buffer, its counts and (m, s)
// in VMEM along a sequential catalog axis; ported so, B = 128 would run
// one block on one of 132 SMs. It is built as mips_topk is instead:
//   1. eval_fused_partial_kernel, grid (ceil(B / QB), S): the sweep of
//      topk_tile.cuh over S catalog splits. On every tile's scores each
//      thread adds, for its RM rows and 4 columns, the gt/eq comparisons
//      to per-row register counts and (with_lse) folds softcap(s) of the
//      valid columns into a per-row (m, s) pair; the scores then feed the
//      threshold filter and the list merge as in mips_topk. After the
//      split the 16 threads of a row combine their counts and pairs with
//      half-warp shuffles in a fixed tree, and the block writes its
//      (B, S, k) lists, (B, S) counts and (B, S) pairs.
//   2. eval_fused_merge_kernel, one block per row: the merge of the S
//      lists of mips_topk, ID_PAD where the value is NEG_INF; one thread
//      sums the counts and folds the pairs in split order.
// No atomics touch global memory: the result is deterministic. k ≤ 512,
// d ≤ 256; k may exceed the valid columns.
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes in src/repro_torch/kernels/eval_fused.py.

#include <math.h>

#include "topk_tile.cuh"

namespace {

using namespace topk_tile;

constexpr int kGatherThreads = 128;

__global__ void __launch_bounds__(kGatherThreads)
eval_tgt_gather_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const int* __restrict__ targets,
                       float* __restrict__ out, int n, int c, int d,
                       int id_offset) {
  const int r = blockIdx.x * kGatherThreads + threadIdx.x;
  if (r >= n) return;
  const long local = (long)targets[r] - id_offset;
  out[r] = local >= 0 && local < c
               ? dot_fma(x + (long)r * d, y + local * d, d)
               : 0.f;
}

// (m, s) of two disjoint column sets → (m, s) of their union.
__device__ __forceinline__ void lse_combine(float& m, float& s, float m2,
                                            float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <int RM, int SLOTS, bool LSE>
__global__ void __launch_bounds__(kThreads)
eval_fused_partial_kernel(Sweep a, const float* __restrict__ tgt,
                          const int* __restrict__ targets,
                          int* __restrict__ part_cnt,
                          float* __restrict__ part_ms, float cap) {
  extern __shared__ float4 smem4[];
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int row0 = blockIdx.x * 16 * RM + ty * RM;
  float t_r[RM];
  int id_r[RM];
  int gt[RM], eq[RM];
  float m[RM], s[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const bool in = row0 + i < a.n_q;
    t_r[i] = in ? tgt[row0 + i] : 0.f;
    id_r[i] = in ? targets[row0 + i] : -1;
    gt[i] = 0;
    eq[i] = 0;
    m[i] = kNegInf;
    s[i] = 0.f;
  }

  sweep_split<RM, SLOTS>(a, smem4, [&](const float (&acc)[RM][kColsPerThread],
                                       const int* flags, long c0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float lv[kColsPerThread];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int cc = tx + 16 * j;
        const bool ok = flags[cc] != 0;
        const bool self = a.id_offset + (int)(c0 + cc) == id_r[i];
        const float sv = ok ? acc[i][j] : kNegInf;
        gt[i] += sv > t_r[i] && !self;
        eq[i] += sv == t_r[i] || (self && ok);
        if (LSE) {
          const float v = cap > 0.f ? cap * tanhf(acc[i][j] / cap) : acc[i][j];
          lv[j] = ok ? v : kNegInf;
          tile_max = fmaxf(tile_max, lv[j]);
        }
      }
      if (LSE) {
        const float mn = fmaxf(m[i], tile_max);
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          if (flags[tx + 16 * j]) add += expf(lv[j] - mn);
        s[i] = s[i] * expf(m[i] - mn) + add;
        m[i] = mn;
      }
    }
  });

  // The 16 threads of a row group are the lanes of one half-warp.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      gt[i] += __shfl_xor_sync(kFull, gt[i], off);
      eq[i] += __shfl_xor_sync(kFull, eq[i], off);
      if (LSE) {
        const float m2 = __shfl_xor_sync(kFull, m[i], off);
        const float s2 = __shfl_xor_sync(kFull, s[i], off);
        lse_combine(m[i], s[i], m2, s2);
      }
    }
  }
  if (tx == 0) {
    const int n_split = gridDim.y;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (row0 + i >= a.n_q) continue;
      const long o = (long)(row0 + i) * n_split + blockIdx.y;
      part_cnt[2 * o] = gt[i];
      part_cnt[2 * o + 1] = eq[i];
      if (LSE) {
        part_ms[2 * o] = m[i];
        part_ms[2 * o + 1] = s[i];
      }
    }
  }
}

template <int SLOTS, bool LSE>
__global__ void __launch_bounds__(kThreads)
eval_fused_merge_kernel(const float* __restrict__ part_vals,
                        const int* __restrict__ part_ids,
                        const int* __restrict__ part_cnt,
                        const float* __restrict__ part_ms,
                        float* __restrict__ vals, int* __restrict__ ids,
                        int* __restrict__ gt, int* __restrict__ eq,
                        float* __restrict__ m_out, float* __restrict__ s_out,
                        int n_split, int k) {
  extern __shared__ float4 smem4[];
  const int row = blockIdx.x;
  // The last thread folds the counts and pairs while warp 0 ends the
  // list merge.
  merge_split_lists<SLOTS>(part_vals, part_ids, vals, ids, n_split, k, smem4);
  if (threadIdx.x == kThreads - 1) {
    int g = 0, e = 0;
    float m = kNegInf, s = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const long o = (long)row * n_split + sp;
      g += part_cnt[2 * o];
      e += part_cnt[2 * o + 1];
      if (LSE) lse_combine(m, s, part_ms[2 * o], part_ms[2 * o + 1]);
    }
    gt[row] = g;
    eq[row] = e;
    if (LSE) {
      m_out[row] = m;
      s_out[row] = s;
    }
  }
}

struct EvalOut {
  const float* tgt;
  const int* targets;
  int* part_cnt;
  float* part_ms;
  float* vals;
  int* ids;
  int* gt;
  int* eq;
  float* m;
  float* s;
  float cap;
};

template <int RM, int SLOTS, bool LSE>
cudaError_t launch_pair(const Sweep& a, const EvalOut& o, int n_split,
                        cudaStream_t st) {
  static bool done[kMaxDevices] = {};
  const size_t smem = partial_smem_bytes<RM>(a.d, a.k);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err =
      allow_max_smem(eval_fused_partial_kernel<RM, SLOTS, LSE>, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + 16 * RM - 1) / (16 * RM), n_split);
  eval_fused_partial_kernel<RM, SLOTS, LSE><<<grid, kThreads, smem, st>>>(
      a, o.tgt, o.targets, o.part_cnt, o.part_ms, o.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  eval_fused_merge_kernel<SLOTS, LSE>
      <<<a.n_q, kThreads, merge_smem_bytes(a.k), st>>>(
          a.part_vals, a.part_ids, o.part_cnt, o.part_ms, o.vals, o.ids,
          o.gt, o.eq, o.m, o.s, n_split, a.k);
  return cudaGetLastError();
}

}  // namespace

// Launches eval_tgt_gather on `stream`: out (n,) f32 from x (n, d), y
// (c, d) and targets (n,) int32. Returns the cudaError_t of the launch
// (0 on success). Nothing is synchronised and nothing is allocated.
extern "C" int eval_tgt_gather_launch(const float* x, const float* y,
                                      const int* targets, float* out, int n,
                                      int c, int d, int id_offset,
                                      void* stream) {
  if (n <= 0 || c <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  eval_tgt_gather_kernel<<<(n + kGatherThreads - 1) / kGatherThreads,
                           kGatherThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, y, targets, out, n, c, d, id_offset);
  return (int)cudaGetLastError();
}

// Launches the partial pass then the merge of eval_fused on `stream`.
// tgt (n,) f32 thresholds and targets (n,) int32 global ids are inputs;
// part_vals / part_ids (n, n_split, k), part_cnt (n, n_split, 2) int32
// and part_ms (n, n_split, 2) f32 are scratch; vals / ids (n, k), gt / eq
// (n,) int32 and, when with_lse, m / s (n,) f32 the outputs (m, s and
// part_ms may be null without it). cap ≤ 0 means no softcap. Returns the
// cudaError_t of the launches (0 on success), and cudaErrorInvalidValue
// when a partial block would need more than kMaxSmem. Nothing is
// synchronised and nothing is allocated.
extern "C" int eval_fused_launch(
    const float* x, const float* y, const float* tgt, const int* targets,
    float* part_vals, int* part_ids, int* part_cnt, float* part_ms,
    float* vals, int* ids, int* gt, int* eq, float* m, float* s, int n,
    int c, int d, int k, int rows_per_thread, int n_split, int split_cols,
    int id_offset, int c_lo, int c_hi, float cap, int with_lse,
    void* stream) {
  if (n <= 0 || c <= 0 || d <= 0 || d > kMaxD || k <= 0 || k > kMaxK ||
      n_split <= 0 || split_cols <= 0 || split_cols % kTileC != 0 ||
      (long)n_split * split_cols < (long)c ||
      (with_lse && (m == nullptr || s == nullptr || part_ms == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Sweep a{x, y, nullptr, part_vals, part_ids, n, c, d, k, split_cols,
                id_offset, c_lo, c_hi,
                d % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0};
  const EvalOut o{tgt, targets, part_cnt, part_ms, vals, ids, gt, eq, m, s,
                  cap};
  return (int)dispatch(rows_per_thread, k, [&](auto rm, auto slots) {
    constexpr int RM = decltype(rm)::value;
    constexpr int SLOTS = decltype(slots)::value;
    return with_lse ? launch_pair<RM, SLOTS, true>(a, o, n_split, st)
                    : launch_pair<RM, SLOTS, false>(a, o, n_split, st);
  });
}
