// eval_fused — the leave-one-out evaluation sweep, written by hand for
// Hopper (sm_90a), and eval_tgt_gather, the target score it compares
// against.
//
// Replaces the Pallas TPU kernels `_fused_kernel` (public `eval_fused`)
// and `_tgt_gather_kernel` (public `eval_tgt_gather`) of
// src/repro/kernels/eval_fused.py, and — as eval_topk_launch and
// eval_tgt_scores_launch at the end of this file — `_eval_kernel` and
// `_tgt_kernel` of src/repro/kernels/eval_topk.py. It computes what they
// compute, not their block structure. For rows r with target id t_r and
// threshold tgt_r, over the columns c < C of y whose global id
// g = id_offset + c lies in [c_lo, c_hi) (the valid columns), with
// s = (x @ yᵀ)[r, c]:
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
// reduces in the same order). Here every score, swept or gathered, is
// topk_tile.cuh's score_step — 3xTF32 `mma.sync` with the catalog row as
// A and the query row as B, the same split and k order, k16 steps from
// zero added in f32 — the sweep in its tiles, eval_tgt_gather in
// target_scores (the deep bf16 slab and its target: gemm_bf16's
// arithmetic, below). So tgt is bit for bit the swept score of the target
// column, and eq ≥ 1 on every row whose target is valid.
//
// What bounds it on an H100. At B = 256 evaluated users, C = 173,520
// catalog rows, d = 64: 2·256·173,520·64 ≈ 5.7 GFLOP; in 3xTF32 three
// TF32 passes at 495 TFLOP/s take 0.035 ms (as f32 FMAs 0.085 ms), the
// LSE's exps 0.011 ms at the SFUs' rate and the catalog read, 44.4 MB at
// 3.35 TB/s, 0.013 ms: the tensor cores bound it (B = 128: 0.017 ms).
// Integer-valued inputs below 2¹¹ are their own TF32 `hi` (lo = 0), so
// ids, counts and the threshold equal the plain version's exactly there.
// eval_tgt_gather reads B·(2d + 1) floats: a few KB, launch-bound.
//
// Design. The TPU kernel carries its merge buffer, its counts and (m, s)
// in VMEM along a sequential catalog axis; ported so, B = 128 would run
// one block on one of 132 SMs. It runs mips_topk's k ≤ 32 sweep instead,
// at every k:
//   1. τ seeded as for mips_topk (the pre-pass for k ≤ 32 on a catalog of
//      128 tiles or more, else "no threshold"); eval_sweep_kernel, grid
//      (ceil(B / QB), S): the tensor-core sweep of topk_tile.cuh over S
//      catalog splits with the shared threshold. On every tile's scores each thread adds, for
//      its queries and catalog rows, the gt/eq comparisons to per-query
//      register counts and (with_lse) folds softcap(s) of the valid
//      columns into a per-query (m, s) pair, before the filter. After the
//      split the 8 lanes of a query combine their counts and pairs with
//      shuffles in a fixed tree, the warps of the block in warp order, and
//      the block writes its (B, S, k) lists, (B, S) counts and pairs.
//   2. eval_fused_merge_kernel, one block per row: the merge of the S
//      lists of mips_topk (from the entries at or above the final τ),
//      ID_PAD where the value is NEG_INF; one thread sums the counts and
//      folds the pairs in split order.
// The lists depend on when each block reads τ, the result does not; the
// counts and pairs are folded in a fixed order: every output is
// deterministic. k ≤ 512, d ≤ 256; k may exceed the valid columns.
//
// Deep variants (eval_fused_deep_launch, eval_topk_deep_launch) for
// d > 256: deep_tc.cuh's product first writes the score slab S = Y · Xᵀ
// (c, n), catalog rows as A and queries as B — f32 operands with
// score_step's arithmetic over depth chunks of 32 (`wgmma`), bf16
// operands on gemm_bf16 (bf16 `wgmma`, the depth summed in the tensor
// cores) — and the same sweep reads its tiles' scores from S
// (topk_tile.cuh's FROM_S: a ring of slab tiles fed by TMA boxes, at
// its own plan of 4-warp blocks): the counts, the lists and the merge are
// this file's code; the LSE folds there in base-2 units on the SFU
// (logit2 below), where the resident sweep's accurate tanhf and expf
// set the deep sweep's pace. eval_tgt_gather takes any depth, and a slab
// score equals its target score bit for bit: f32, the same mma3x2 k16
// steps from zero, added in ascending depth order, in the same
// orientation; bf16, an `mma.sync` m16n8k16 chain carried from zero in
// ascending depth, which gives gemm_bf16's bits wherever the pair sits in
// its tile (probes/bf16_tc_check.py slab_bits) — so eq still counts the
// target's own column. The slab is never cut in depth (a target is one
// product). The wrapper cuts the rows into slabs that keep S within a
// fixed budget.
//
// bfloat16 operands (the entries' bf16_in): resident (d ≤ 256), x and y
// are widened to f32 as they are staged (topk_tile.cuh), so every output
// equals the f32 launch's on the widened inputs bit for bit; deep, the
// scores come from the bf16 product (other bits than the f32 launch,
// within f32 rounding of f64, repeating bit for bit), and the target
// score stays the swept column either way.
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes in src/repro_torch/kernels/eval_fused.py.

#include <math.h>

#include "deep_tc.cuh"
#include "topk_tile.cuh"

namespace {

using namespace topk_tile;
using tf32x3::bf16;
using tf32x3::by_dtype;

template <typename T>
__global__ void __launch_bounds__(32 * kTargetWarps)
eval_tgt_gather_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const int* __restrict__ targets,
                       float* __restrict__ out, int n, int c, int d,
                       int id_offset) {
  target_scores(x, y, targets, out, n, c, d, id_offset);
}

cudaError_t launch_target_scores(const void* x, const void* y,
                                 const int* targets, float* out, int n, int c,
                                 int d, int id_offset, int bf16_in,
                                 cudaStream_t s) {
  if (n <= 0 || c <= 0 || d <= 0) return cudaErrorInvalidValue;
  const int rows = 8 * kTargetWarps;
  return by_dtype(bf16_in, [&](auto t) {
    using T = decltype(t);
    eval_tgt_gather_kernel<T>
        <<<(n + rows - 1) / rows, 32 * kTargetWarps, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(y), targets, out,
            n, c, d, id_offset);
    return cudaGetLastError();
  });
}

// deep_tc's score slab, with this library's table of its shared-memory
// opt-in for each element type (gemm's for f32, gemm_bf16's for bf16).
template <typename T>
cudaError_t score_slab(const void* q, const void* y, float* s, int n_q, int c,
                       int d, int ld, cudaStream_t st) {
  static bool done[kMaxDevices] = {};
  return deep_tc::score_slab<T>(static_cast<const T*>(q),
                                static_cast<const T*>(y), s, n_q, c, d, ld,
                                st, done);
}

// The deep sweep's LSE logit (FROM_S): softcap(x)·log2(e), folded in
// base-2 units on the SFU — cap·tanh(x / cap) as cap·(1 − 2 / (1 +
// e^{2x/cap})) by ex2.approx and rcp.approx (kt = 2·log2(e) / cap,
// kv = cap·log2(e)), within ≈ 3e-7·cap; x·log2(e) without a cap. The
// resident sweep's accurate tanhf, its true division and expf took 72 %
// of the deep sweep's fold and set its pace (PERF.md, the sweep's clock
// profile); a slab read at its byte rate leaves ≈ 40 instructions an
// element to the fold.
__device__ __forceinline__ float rcp_approx(float a) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ float logit2(float x, float cap, float kt,
                                        float kv) {
  if (cap <= 0.f) return x * tf32x3::kLog2e;
  return fmaf(-2.f * kv, rcp_approx(1.f + tf32x3::exp2_approx(x * kt)), kv);
}

// (m, s) of two disjoint column sets → (m, s) of their union.
__device__ __forceinline__ void lse_combine(float& m, float& s, float m2,
                                            float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// SELF: eval_fused's self-column rule (the target's own column never in
// gt, always in eq). Without it (eval_topk) the counts go by score alone
// and `targets` is not read. FROM_S folds the LSE in base-2 units
// (logit2, exp2 on the SFU) and returns m in natural units after the
// sweep; the resident sweep keeps tanhf and expf.
template <int NQT, int SLOTS, bool LSE, bool SELF, bool FROM_S, typename T>
__global__ void __launch_bounds__(Cfg<NQT>::kThreads,
                                  sweep_min_blocks<NQT, FROM_S>())
eval_sweep_kernel(const __grid_constant__ Sweep a,
                  const float* __restrict__ tgt,
                  const int* __restrict__ targets, int* __restrict__ part_cnt,
                  float* __restrict__ part_ms, float cap) {
  using C = Cfg<NQT>;
  constexpr int QB = C::kQB, NT = C::kNT, MT = C::kMT, WM = C::kWM;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int qd = lane & 3;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int row0 = blockIdx.x * QB;
  // Query 8·(wn·NT + nt) + 2q + u of the block, for this thread.
  auto query = [&](int nt, int u) { return 8 * (wn * NT + nt) + 2 * qd + u; };
  float t_r[NT][2];
  int id_r[NT][2];
  int gt[NT][2], eq[NT][2];
  float m[NT][2], s[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = row0 + query(nt, u);
      const bool in = r < a.n_q;
      t_r[nt][u] = in ? tgt[r] : 0.f;
      id_r[nt][u] = SELF && in ? targets[r] : -1;
      gt[nt][u] = 0;
      eq[nt][u] = 0;
      m[nt][u] = kNegInf;
      s[nt][u] = 0.f;
    }
  const float kt = cap > 0.f ? 2.f * tf32x3::kLog2e / cap : 0.f;
  const float kv = cap > 0.f ? cap * tf32x3::kLog2e : 0.f;
  // e^a: expf resident, 2^a (base-2 units) on the slab
  auto exp_ = [](float a) {
    if constexpr (FROM_S) return tf32x3::exp2_approx(a);
    else return expf(a);
  };

  float* red = sweep<NQT, SLOTS, false, FROM_S, T>(
      a, smem4,
      [&](const float (&acc)[MT][NT][4], const int* flags, long c0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float lv[MT][2];
            float tile_max = kNegInf;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int cc = 16 * (wm * MT + mt) + gq + 8 * h;
                const float x = acc[mt][nt][2 * h + u];
                const bool ok = flags[cc] != 0;
                const bool self =
                    SELF && a.id_offset + (int)(c0 + cc) == id_r[nt][u];
                const float sv = ok ? x : kNegInf;
                gt[nt][u] += sv > t_r[nt][u] && !self;
                eq[nt][u] += sv == t_r[nt][u] || (self && ok);
                if (LSE) {
                  const float v =
                      FROM_S ? logit2(x, cap, kt, kv)
                             : cap > 0.f ? cap * tanhf(x / cap) : x;
                  lv[mt][h] = ok ? v : kNegInf;
                  tile_max = fmaxf(tile_max, lv[mt][h]);
                }
              }
            if (LSE) {
              const float mn = fmaxf(m[nt][u], tile_max);
              float add = 0.f;
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  if (flags[16 * (wm * MT + mt) + gq + 8 * h])
                    add += exp_(lv[mt][h] - mn);
              s[nt][u] = s[nt][u] * exp_(m[nt][u] - mn) + add;
              m[nt][u] = mn;
            }
          }
      });
  if constexpr (FROM_S && LSE) {  // m back to natural units
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (m[nt][u] != kNegInf) m[nt][u] *= 0.6931471805599453f;
  }

  // The 8 lanes of a query (gq = 0..7) in a fixed shuffle tree, then the
  // WM warps of its column in warp order through the free tile ring.
  int* r_gt = reinterpret_cast<int*>(red);  // (WM, QB) each
  int* r_eq = r_gt + WM * QB;
  float* r_m = reinterpret_cast<float*>(r_eq + WM * QB);
  float* r_s = r_m + WM * QB;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        gt[nt][u] += __shfl_xor_sync(kFull, gt[nt][u], off);
        eq[nt][u] += __shfl_xor_sync(kFull, eq[nt][u], off);
        if (LSE) {
          const float m2 = __shfl_xor_sync(kFull, m[nt][u], off);
          const float s2 = __shfl_xor_sync(kFull, s[nt][u], off);
          lse_combine(m[nt][u], s[nt][u], m2, s2);
        }
      }
      if (gq == 0) {
        const int o = wm * QB + query(nt, u);
        r_gt[o] = gt[nt][u];
        r_eq[o] = eq[nt][u];
        r_m[o] = m[nt][u];
        r_s[o] = s[nt][u];
      }
    }
  __syncthreads();
  const int n_split = gridDim.y;
  for (int r = threadIdx.x; r < QB; r += C::kThreads) {
    if (row0 + r >= a.n_q) continue;
    int g = 0, e = 0;
    float mm = kNegInf, ss = 0.f;
    for (int w = 0; w < WM; ++w) {
      g += r_gt[w * QB + r];
      e += r_eq[w * QB + r];
      if (LSE) lse_combine(mm, ss, r_m[w * QB + r], r_s[w * QB + r]);
    }
    const long o = (long)(row0 + r) * n_split + blockIdx.y;
    part_cnt[2 * o] = g;
    part_cnt[2 * o + 1] = e;
    if (LSE) {
      part_ms[2 * o] = mm;
      part_ms[2 * o + 1] = ss;
    }
  }
}

template <int SLOTS, bool LSE>
__global__ void __launch_bounds__(kThreads)
eval_fused_merge_kernel(const float* __restrict__ part_vals,
                        const int* __restrict__ part_ids,
                        const int* __restrict__ part_cnt,
                        const float* __restrict__ part_ms,
                        const int* __restrict__ tau,
                        float* __restrict__ vals, int* __restrict__ ids,
                        int* __restrict__ gt, int* __restrict__ eq,
                        float* __restrict__ m_out, float* __restrict__ s_out,
                        int n_split, int k) {
  extern __shared__ float4 smem4[];
  const int row = blockIdx.x;
  // The last thread folds the counts and pairs while warp 0 ends the
  // list merge.
  merge_row_lists<SLOTS>(part_vals, part_ids, vals, ids, n_split, k, tau,
                         smem4);
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

struct Seed {
  float* uv;  // the pre-pass's union, or null
  int pre_split, pre_period;
};

template <int NQT, int SLOTS, bool LSE, bool SELF, bool FROM_S, typename T>
cudaError_t launch_sweep(const Sweep& a_in, const EvalOut& o, int n_split,
                         const Seed& pre, cudaStream_t st) {
  using C = Cfg<NQT>;
  static bool done[kMaxDevices] = {}, done_pre[kMaxDevices] = {};
  const size_t smem = sweep_smem_bytes<NQT, FROM_S>(a_in.d, a_in.k);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  Sweep a = a_in;
  if constexpr (FROM_S) {
    if (!slab_map<NQT>(a)) return cudaErrorInvalidValue;
  }
  cudaError_t err =
      allow_max_smem(eval_sweep_kernel<NQT, SLOTS, LSE, SELF, FROM_S, T>, done);
  if (err != cudaSuccess) return err;
  err = seed_tau<NQT, FROM_S, T>(a, pre.uv, pre.pre_split, pre.pre_period,
                              done_pre, st);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + C::kQB - 1) / C::kQB, n_split);
  eval_sweep_kernel<NQT, SLOTS, LSE, SELF, FROM_S, T>
      <<<grid, C::kThreads, smem, st>>>(a, o.tgt, o.targets, o.part_cnt,
                                        o.part_ms, o.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  eval_fused_merge_kernel<SLOTS, LSE>
      <<<a.n_q, kThreads, sweep_merge_smem_bytes(a.k), st>>>(
          a.part_vals, a.part_ids, o.part_cnt, o.part_ms, a.tau, o.vals,
          o.ids, o.gt, o.eq, o.m, o.s, n_split, a.k);
  return cudaGetLastError();
}

bool bad_plan(int n, int c, int d, int k, int n_split, int pre_split,
              int pre_period, bool deep = false) {
  return n <= 0 || c <= 0 || d <= 0 || (!deep && d > kMaxD) || k <= 0 ||
         k > kMaxSweepK ||
         n_split <= 0 || n_split > 65535 || pre_split < 0 ||
         pre_split > 65535 || (pre_split > 0 && pre_period < pre_split);
}

// eval_fused (SELF) or eval_topk, resident (FROM_S false) or on the score
// slab `scores` that this first fills (FROM_S).
template <bool SELF, bool FROM_S>
int launch_eval(const void* x, const void* y, float* scores,
                const EvalOut& o, float* part_vals, int* part_ids, int* tau,
                float* uv, int n, int c, int d, int k, int query_tiles,
                int n_split, int pre_split, int pre_period, int id_offset,
                int c_lo, int c_hi, bool with_lse, int bf16_in,
                cudaStream_t st) {
  if (bad_plan(n, c, d, k, n_split, pre_split, pre_period, FROM_S) ||
      (FROM_S && scores == nullptr) ||
      (with_lse && (o.m == nullptr || o.s == nullptr ||
                    o.part_ms == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int elem = bf16_in ? 2 : 4;
  Sweep a{x, y, nullptr, part_vals, part_ids, tau, n, c, d, k, 0,
          id_offset, c_lo, c_hi,
          d % 4 == 0 && reinterpret_cast<uintptr_t>(y) % (4 * elem) == 0,
          pre_split > 0};
  if (FROM_S) {  // at the sweep's row pitch, slab_ld(n)
    const int ld = slab_ld(n);
    cudaError_t err =
        bf16_in ? score_slab<bf16>(x, y, scores, n, c, d, ld, st)
                : score_slab<float>(x, y, scores, n, c, d, ld, st);
    if (err != cudaSuccess) return (int)err;
    a.s = scores;
    a.vec = 0;
  }
  auto go = [&](auto t) {
    using T = decltype(t);
    return dispatch<kSlotsLarge, FROM_S>(query_tiles, k, [&](auto nqt,
                                                            auto slots) {
      constexpr int NQT = decltype(nqt)::value;
      constexpr int SLOTS = decltype(slots)::value;
      const Seed pre{uv, pre_split, pre_period};
      if constexpr (SELF) {  // the LSE is eval_fused's only
        if (with_lse)
          return launch_sweep<NQT, SLOTS, true, true, FROM_S, T>(
              a, o, n_split, pre, st);
      }
      return launch_sweep<NQT, SLOTS, false, SELF, FROM_S, T>(a, o, n_split,
                                                              pre, st);
    });
  };
  // The slab's sweep reads no operand: one (f32) instantiation.
  if constexpr (FROM_S) return (int)go(float{});
  else return (int)by_dtype(bf16_in, go);
}

}  // namespace

// Launches eval_tgt_gather on `stream`: out (n,) f32 from x (n, d), y
// (c, d) and targets (n,) int32. Returns the cudaError_t of the launch
// (0 on success). Nothing is synchronised and nothing is allocated.
extern "C" int eval_tgt_gather_launch(const void* x, const void* y,
                                      const int* targets, float* out, int n,
                                      int c, int d, int id_offset,
                                      int bf16_in, void* stream) {
  return (int)launch_target_scores(x, y, targets, out, n, c, d, id_offset,
                                   bf16_in,
                                   static_cast<cudaStream_t>(stream));
}

// Launches τ's seeding, the sweep and the merge of eval_fused on `stream`.
// tgt (n,) f32 thresholds and targets (n,) int32 global ids are inputs;
// part_vals / part_ids (n, n_split, k), part_cnt (n, n_split, 2) int32,
// part_ms (n, n_split, 2) f32, tau (n,) int32 and uv (n, pre_split, 8·WM)
// f32 (the pre-pass's union, as mips_topk_launch's) are scratch; vals / ids
// (n, k), gt / eq (n,) int32 and, when with_lse, m / s (n,) f32 the
// outputs (m, s and part_ms may be null without it). 8·query_tiles query
// rows a block; cap ≤ 0 means no softcap. Returns the cudaError_t of the
// launches (0 on success), and cudaErrorInvalidValue for a plan it does
// not take (a block above kMaxSmem included). The catalog's tiles go to
// n_split balanced splits; τ is seeded as in mips_topk_launch (a pre-pass
// only for k ≤ 32). Nothing is synchronised and nothing is allocated.
extern "C" int eval_fused_launch(
    const void* x, const void* y, const float* tgt, const int* targets,
    float* part_vals, int* part_ids, int* part_cnt, float* part_ms, int* tau,
    float* uv, float* vals, int* ids, int* gt, int* eq, float* m, float* s,
    int n, int c, int d, int k, int query_tiles, int n_split, int pre_split,
    int pre_period, int id_offset, int c_lo, int c_hi, float cap,
    int with_lse, int bf16_in, void* stream) {
  const EvalOut o{tgt, targets, part_cnt, part_ms, vals, ids, gt, eq, m, s,
                  cap};
  return launch_eval<true, false>(
      x, y, nullptr, o, part_vals, part_ids, tau, uv, n, c, d, k,
      query_tiles, n_split, pre_split, pre_period, id_offset, c_lo, c_hi,
      with_lse != 0, bf16_in, static_cast<cudaStream_t>(stream));
}

// The deep variants' score slab alone: scores (c, n) f32 = y · xᵀ, as
// eval_fused_deep_launch and eval_topk_deep_launch write it before their
// sweep (the same call), for the tests and probes that hold a target
// score against its slab column. Returns the cudaError_t (0 on success).
extern "C" int eval_score_slab_launch(const void* x, const void* y,
                                      float* scores, int n, int c, int d,
                                      int bf16_in, void* stream) {
  if (n <= 0 || c <= 0 || d <= 0 || scores == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16_in ? score_slab<bf16>(x, y, scores, n, c, d, n, st)
                       : score_slab<float>(x, y, scores, n, c, d, n, st));
}

// eval_fused_launch for any d > 0, on the (c, slab_ld(n)) f32 workspace
// `scores` (topk_tile.cuh: the slab's tensor map wants 16-byte rows).
extern "C" int eval_fused_deep_launch(
    const void* x, const void* y, const float* tgt, const int* targets,
    float* part_vals, int* part_ids, int* part_cnt, float* part_ms, int* tau,
    float* uv, float* vals, int* ids, int* gt, int* eq, float* m, float* s,
    float* scores, int n, int c, int d, int k, int query_tiles, int n_split,
    int pre_split, int pre_period, int id_offset, int c_lo, int c_hi,
    float cap, int with_lse, int bf16_in, void* stream) {
  const EvalOut o{tgt, targets, part_cnt, part_ms, vals, ids, gt, eq, m, s,
                  cap};
  return launch_eval<true, true>(
      x, y, scores, o, part_vals, part_ids, tau, uv, n, c, d, k,
      query_tiles, n_split, pre_split, pre_period, id_offset, c_lo, c_hi,
      with_lse != 0, bf16_in, static_cast<cudaStream_t>(stream));
}

// eval_topk and eval_tgt_scores: the deprecated two-pass entries of
// src/repro/kernels/eval_topk.py (`_eval_kernel`, `_tgt_kernel`), kept as
// the oracle of eval_fused. eval_topk is the sweep above without the
// self-column rule and without the LSE: gt and eq count by score alone
// against the caller's tgt. Arguments as eval_fused_launch's, minus the
// targets, the LSE pair, part_ms and the cap. eval_tgt_scores is the
// target score eval_topk compares against: x[r] · y[t_r − id_offset] by
// the sweep's own score_step (target_scores), so it is bit for bit the
// swept column; 0 where t_r is outside [id_offset, id_offset + C). The
// TPU kernel gets those bits from a second full sweep; here one
// arithmetic gives them from a gather of B rows. Each returns the
// cudaError_t of its launches (0 on success).
extern "C" int eval_topk_launch(
    const void* x, const void* y, const float* tgt, float* part_vals,
    int* part_ids, int* part_cnt, int* tau, float* uv, float* vals, int* ids,
    int* gt, int* eq, int n, int c, int d, int k, int query_tiles,
    int n_split, int pre_split, int pre_period, int id_offset, int c_lo,
    int c_hi, int bf16_in, void* stream) {
  const EvalOut o{tgt, nullptr, part_cnt, nullptr, vals, ids, gt, eq,
                  nullptr, nullptr, 0.f};
  return launch_eval<false, false>(
      x, y, nullptr, o, part_vals, part_ids, tau, uv, n, c, d, k,
      query_tiles, n_split, pre_split, pre_period, id_offset, c_lo, c_hi,
      false, bf16_in, static_cast<cudaStream_t>(stream));
}

// eval_topk_launch for any d > 0, on the (c, slab_ld(n)) f32 workspace
// `scores`.
extern "C" int eval_topk_deep_launch(
    const void* x, const void* y, const float* tgt, float* part_vals,
    int* part_ids, int* part_cnt, int* tau, float* uv, float* vals, int* ids,
    int* gt, int* eq, float* scores, int n, int c, int d, int k,
    int query_tiles, int n_split, int pre_split, int pre_period,
    int id_offset, int c_lo, int c_hi, int bf16_in, void* stream) {
  const EvalOut o{tgt, nullptr, part_cnt, nullptr, vals, ids, gt, eq,
                  nullptr, nullptr, 0.f};
  return launch_eval<false, true>(
      x, y, scores, o, part_vals, part_ids, tau, uv, n, c, d, k,
      query_tiles, n_split, pre_split, pre_period, id_offset, c_lo, c_hi,
      false, bf16_in, static_cast<cudaStream_t>(stream));
}

extern "C" int eval_tgt_scores_launch(const void* x, const void* y,
                                      const int* targets, float* out, int n,
                                      int c, int d, int id_offset,
                                      int bf16_in, void* stream) {
  return (int)launch_target_scores(x, y, targets, out, n, c, d, id_offset,
                                   bf16_in,
                                   static_cast<cudaStream_t>(stream));
}
