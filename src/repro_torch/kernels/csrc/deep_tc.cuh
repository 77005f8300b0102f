// deep_tc — the depth-chunked product of every deep variant (d > 256),
// designed for Hopper's tensor cores. A batched C[b] = A[b] · B[b]ᵀ for
// any depth K: in 3xTF32 on f32 operands (gemm), and on bfloat16
// operands at the bf16 rate (gemm_bf16, below: the deep SCE, the full CE
// and the score slab).
//
// Which TPU kernels it serves: at d > 256 it takes every product of
//   * sce_gather.cu's deep entries — the in-bucket logits, dX = G · Y[idx]
//     and dY's slot rows Gᵀ · x_b — behind `sce_gather_loss` /
//     `sce_gather_plse` (src/repro/kernels/sce_prefetch.py: `_gfwd_kernel`,
//     `_gbwd_dx_kernel`, `_gbwd_dy_kernel`) and `sce_bucket_loss` /
//     `sce_bucket_plse` (src/repro/kernels/sce_bucket.py);
//   * linear_ce.cu's deep entries — a catalog chunk's logits slab,
//     dX += G · W_chunk and dW_chunk = Gᵀ · X — behind `linear_ce_loss`
//     (src/repro/kernels/linear_sce.py `_fwd`, `_bwd`) and `fused_lse` /
//     `fused_ce_loss` (src/repro/kernels/fused_ce.py);
//   * the score slabs S = Y · Qᵀ of mips_topk.cu's and eval_fused.cu's
//     deep entries (score_slab below: catalog rows as A, queries as B, the
//     orientation of topk_tile.cuh's score_step and target_scores), behind
//     `mips_topk`
//     (src/repro/kernels/mips_topk.py `_mips_kernel`), `eval_fused` and
//     `eval_topk` (src/repro/kernels/eval_fused.py, eval_topk.py).
//
// The f32 arithmetic is topk_tile.cuh's score_step and tf32x3_tile.cuh's:
// every value split into TF32 (hi, lo) (tf32x3::split), each k16 step's
// three passes (lo·hi, hi·lo of both k8 steps, then hi·hi) summed from
// zero on the tensor cores and added to the f32 accumulator in ascending
// depth, k16 steps past K skipped, values out of range 0. On an H100
// `wgmma` gives the bits of `mma.sync` m16n8k8 for the same passes
// (SHA-256 of every deep output at gemma-2's shapes,
// probes/deep_tc_turns.py digests; PERF.md), so an f32 slab score equals
// target_scores' for the same pair bit for bit, and SCE's forward, dX and
// dY read logits of one arithmetic. On bf16 operands the slab runs
// gemm_bf16, and target_scores runs that product's arithmetic (an
// `mma.sync` m16n8k16 bf16 chain), so the tie holds there too.
// gemm runs on f32 operands only (its element-typed staging helpers are
// instantiated on float; bf16 operands take gemm_bf16).
//
// Options (template flags): A_KM — A stored (K, M), M contiguous;
// B_KN — B stored (K, N); GATHER — B's rows (n, or k with B_KN) taken
// from b at clamp(idx[r], 0, b_rows − 1); ACC — out += C instead of
// out = C (linear_ce's dX across catalog chunks, one launch a chunk in
// stream order: a fixed order, no atomics). m_zero: a row m whose
// m_zero[b·mz_batch + m] < 0 is a zero row of C.
// Shapes: A(m, k) is a[b·a_batch + m·lda + k], or with A_KM
// a[b·a_batch + k·lda + m]; B(n, k) is row(n)[k], or with B_KN row(k)[n],
// where row(r) = b + b·b_batch + r·ldb, or with GATHER
// b + clamp(idx[b·idx_batch + r], 0, b_rows − 1)·ldb. Out of range values
// read 0. out[b·out_batch + m·ldo + n] (f32) for m < M, n < N.
//
// What bounds it on an H100: three TF32 passes at the dense 495 TFLOP/s
// (6·M·N·K FLOP of TF32 per product); the
// bytes (each operand once, the output once) are a small share at the
// deep shapes (d 2304).
//
// Design, against the register-staged mma.sync product it replaced (its
// clock profile: scalar loads' issue 50–63 % of the cycles, the fragment
// splits and `mma` 27–41 %; PERF.md):
//   * loads: 16-byte cp.async per row chunk (4-byte where a leading
//     dimension or base is not 16-byte aligned; a bf16 operand then copies
//     through registers), for dense and gathered operands alike, into a
//     ring of kStages raw stages, two 32-deep chunks ahead of the
//     products; a gathered row's id is read once a block (K-major) or an
//     iteration before its copies (B_KN). (The TMA cannot gather, and
//     every value passes through a thread for its split anyway: one code
//     path.)
//   * the split: each landed chunk is split once, by the whole block, into
//     (hi, lo) planes laid out as wgmma's K-major core matrices (8 rows ×
//     16 bytes; M- or N-major operands, A_KM and B_KN, transposed on the
//     way), so the tensor cores read ready TF32 words from shared memory
//     and no warp splits or loads a fragment.
//   * tiles and the instruction: 128 × 128 outputs a block, two
//     warpgroups of 64 rows, each k8 step three `wgmma` m64n128k8 (tf32,
//     both operands K-major from shared memory, no swizzle),
//     asynchronous: the block splits chunk t + 1 and issues chunk t + 3's
//     copies while the tensor cores take chunk t, then adds each k16
//     step's product to its accumulator. One barrier per 32-deep chunk
//     (two plane buffers, three raw stages).
// A plane: per operand and per (hi, lo), depth group c (4 depths) of row
// r at core(c, r) — row groups of 8 side by side (128 bytes apart), depth
// groups 2 KB apart; the raw K-major chunk's XOR keeps the split's reads
// and the copies' writes free of bank conflicts.
// Shared memory: kStages · 2 · 16 KB raw + 2 · 64 KB planes = 224 KB,
// one block (two warpgroups) an
// SM; three 64-float accumulators a thread (the running sum and both k16
// steps' products).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3_tile.cuh"

namespace deep_tc {

constexpr int kBM = 128;   // output rows (M) a block: two warpgroups of 64
constexpr int kBN = 128;   // output columns (N) a block
constexpr int kBK = 32;    // depth (K) a chunk: two k16 steps
constexpr int kThreads = 256;
constexpr int kStages = 3;  // raw ring
constexpr int kRaw = kBM * kBK;  // floats of one operand's raw chunk
constexpr int kPlane = kBM * kBK;  // floats of one operand's hi (or lo)
constexpr int kPlanes = 2 * kPlane;  // an operand's chunk: hi, then lo
constexpr size_t kSmem =
    sizeof(float) * ((size_t)kStages * 2 * kRaw + 2 * 2 * kPlanes);

struct Gemm {
  const void* a;     // f32 or bf16, as the launch's TA
  long a_batch;
  int lda;
  const void* b;     // f32 or bf16, as the launch's TB
  long b_batch;
  int ldb;
  const int* b_idx;  // GATHER: the source row of each B row
  long idx_batch;
  int b_rows;        // GATHER: rows of b (ids are clamped to them)
  float* out;
  long out_batch;
  int ldo;
  const int* m_zero;  // or null
  long mz_batch;
  int m, n, k;
  int vec_a, vec_b;  // set by gemm(): 16-byte copies allowed
  int vec_o;         // set by gemm(): 8-byte output pairs allowed
  // set by gemm_bf16(): operands that come by TMA, and the tile walk
  int tma_a, tma_b;
  int n_fast;        // consecutive tiles share an A tile (else a B tile)
  long tiles;        // output tiles over the batch
};

using tf32x3::bf16;

// How an operand of element type T is copied: V values a 16-byte copy;
// K-major, CPR copies a 32-deep row and KROWS rows a pass of the block's
// threads; M- or N-major, CPD copies a 128-wide depth row and DROWS depth
// rows a pass; IT passes either way (4 for f32, 2 for bf16).
template <typename T>
struct Stage {
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int CPR = kBK / V;
  static constexpr int KROWS = kThreads / CPR;
  static constexpr int CPD = kBM / V;
  static constexpr int DROWS = kThreads / CPD;
  static constexpr int IT = kBM / KROWS;
  static_assert(IT == kBK / DROWS, "passes");
};

// The 16-byte chunk of a K-major raw row r where its chunk kc lies: f32
// rows are 8 chunks (kc ^ r mod 8), bf16 rows 4 (kc ^ ⌊r / 2⌋ mod 4).
template <typename T>
__device__ __forceinline__ int raw_chunk(int kc, int r) {
  return sizeof(T) == 4 ? kc ^ (r & 7) : kc ^ ((r >> 1) & 3);
}

// V consecutive values global → shared, `n` of them valid (zeros after):
// one 16-byte cp.async (src-size n values); with !vec four 4-byte copies
// (f32) or V loads through registers (bf16: no 2-byte cp.async).
template <typename T>
__device__ __forceinline__ void copy_vec(T* dst, const T* src, int n,
                                         bool vec, const T* safe) {
  constexpr int V = Stage<T>::V;
  n = n < 0 ? 0 : (n > V ? V : n);
  if (vec) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(n > 0 ? src : safe), "r"((int)sizeof(T) * n)
                 : "memory");
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      tf32x3::cp_async4(dst + j, j < n ? src + j : safe, j < n);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j].bits = j < n ? src[j].bits : 0;
  }
}

// The float offset of depths 4c .. 4c + 3 of row r in a plane: wgmma's
// K-major core matrices (8 rows × 16 bytes, 128 bytes each), the 16 of a
// depth group c side by side (rows 8g .. 8g + 7 at 128·g bytes), the
// eight depth groups 2 KB apart.
__device__ __forceinline__ int core(int c, int r) {
  return (c * (kBM / 8) + (r >> 3)) * 32 + (r & 7) * 4;
}

// Unit i (0..3) of this thread's share of one operand's split: row
// tid & 127, depths 4c .. 4c + 3 with c = (tid >> 7) + 2i, from the landed
// raw chunk into the (hi, lo) planes. K-major raw (KM false): [128
// rows][32], 16-byte chunk kc of row r at raw_chunk(kc, r); M- or N-major
// (KM true): [32][128].
template <bool KM, typename T>
__device__ __forceinline__ void split_unit(const T* raw, float* pl, int i) {
  const int r = threadIdx.x & (kBM - 1), c = (threadIdx.x >> 7) + 2 * i;
  float4 v;
  if (!KM) {
    constexpr int G = Stage<T>::V / 4;  // depth groups a 16-byte chunk
    v = tf32x3::load4(raw + r * kBK + Stage<T>::V * raw_chunk<T>(c / G, r) +
                      4 * (c % G));
  } else {
    const T* col = raw + 4 * c * kBM + r;
    v = make_float4(tf32x3::widen(col[0]), tf32x3::widen(col[kBM]),
                    tf32x3::widen(col[2 * kBM]), tf32x3::widen(col[3 * kBM]));
  }
  const int off = core(c, r);
  uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
  tf32x3::split(v.x, h0, l0);
  tf32x3::split(v.y, h1, l1);
  tf32x3::split(v.z, h2, l2);
  tf32x3::split(v.w, h3, l3);
  *reinterpret_cast<uint4*>(pl + off) = make_uint4(h0, h1, h2, h3);
  *reinterpret_cast<uint4*>(pl + kPlane + off) = make_uint4(l0, l1, l2, l3);
}

// A wgmma matrix descriptor of K-major core matrices without swizzle at
// p: the leading byte offset (the next 4 depths) 2 KB, the stride byte
// offset (the next 8 rows) 128 bytes.
__device__ __forceinline__ uint64_t desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(2048 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d (+)= A·Bᵀ on a 64 × 128 × 8 tile: A the warpgroup's 64 rows, B the
// block's 128, TF32 from shared memory; d = A·Bᵀ when scale_d is 0.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders the compiler's accesses to d after the wait (and before issue).
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    asm volatile("" : "+f"(d[i])::"memory");
  }
}

template <bool A_KM, bool B_KN, bool GATHER, bool ACC, typename TA,
          typename TB>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(Gemm g) {
  using SA = Stage<TA>;
  using SB = Stage<TB>;
  extern __shared__ __align__(128) float smem[];
  float* const raw = smem;                           // [stage][A, B][kRaw]
  float* const planes = smem + kStages * 2 * kRaw;  // [buf][A, B][kPlanes]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int wg = warp >> 2;  // this warpgroup's 64 rows: 64·wg ..
  const long m0 = (long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long bt = blockIdx.z;
  const TA* const A = static_cast<const TA*>(g.a) + bt * g.a_batch;
  const TB* const B = static_cast<const TB*>(g.b) + (GATHER ? 0 : bt * g.b_batch);
  const TA* const a_safe = static_cast<const TA*>(g.a);
  const TB* const b_safe = static_cast<const TB*>(g.b);
  const int* const idx = GATHER ? g.b_idx + bt * g.idx_batch : nullptr;
  const bool vec_a = g.vec_a, vec_b = g.vec_b;

  // K-major operands: this thread copies 16-byte chunk tid % CPR of rows
  // tid / CPR + KROWS·i, whose sources are fixed for the block.
  const TA* a_row[SA::IT];
  const TB* b_row[SB::IT];
#pragma unroll
  for (int i = 0; i < SA::IT; ++i) {
    const int r = tid / SA::CPR + SA::KROWS * i;
    a_row[i] = nullptr;
    if (!A_KM && m0 + r < g.m) a_row[i] = A + (m0 + r) * g.lda;
  }
#pragma unroll
  for (int i = 0; i < SB::IT; ++i) {
    const int r = tid / SB::CPR + SB::KROWS * i;
    b_row[i] = nullptr;
    if (!B_KN && n0 + r < g.n) {
      long src = n0 + r;
      if (GATHER) {
        const int id = idx[n0 + r];
        src = id < 0 ? 0 : (id >= g.b_rows ? g.b_rows - 1 : id);
      }
      b_row[i] = B + src * g.ldb;
    }
  }
  // B_KN: the source rows of chunk t's depth rows tid / CPD + DROWS·i,
  // read an iteration before their copies are issued (the ids unclamped,
  // so that nothing waits for the loads until the copies need them).
  auto rows_of = [&](int t, int (&src)[SB::IT]) {
#pragma unroll
    for (int i = 0; i < SB::IT; ++i) {
      const int k = t * kBK + tid / SB::CPD + SB::DROWS * i;
      src[i] = GATHER && k < g.k ? idx[k] : k;
    }
  };
  // The copies of chunk t into raw stage st.
  auto load = [&](int t, int st, const int (&b_src)[SB::IT]) {
    TA* ra = reinterpret_cast<TA*>(raw + st * 2 * kRaw);
    TB* rb = reinterpret_cast<TB*>(raw + st * 2 * kRaw + kRaw);
    const int k0 = t * kBK;
#pragma unroll
    for (int i = 0; i < SA::IT; ++i) {
      if (!A_KM) {
        const int r = tid / SA::CPR + SA::KROWS * i, kc = tid % SA::CPR;
        copy_vec(ra + r * kBK + SA::V * raw_chunk<TA>(kc, r),
                 a_row[i] ? a_row[i] + k0 + SA::V * kc : a_safe,
                 a_row[i] ? g.k - k0 - SA::V * kc : 0, vec_a, a_safe);
      } else {
        const int kr = tid / SA::CPD + SA::DROWS * i;
        const int c = SA::V * (tid % SA::CPD);
        const int k = k0 + kr;
        const long m = m0 + c;
        copy_vec(ra + kr * kBM + c, k < g.k ? A + (long)k * g.lda + m : a_safe,
                 k < g.k ? (int)(g.m - m < SA::V ? g.m - m : SA::V) : 0,
                 vec_a, a_safe);
      }
    }
#pragma unroll
    for (int i = 0; i < SB::IT; ++i) {
      if (!B_KN) {
        const int r = tid / SB::CPR + SB::KROWS * i, kc = tid % SB::CPR;
        copy_vec(rb + r * kBK + SB::V * raw_chunk<TB>(kc, r),
                 b_row[i] ? b_row[i] + k0 + SB::V * kc : b_safe,
                 b_row[i] ? g.k - k0 - SB::V * kc : 0, vec_b, b_safe);
      } else {
        const int kr = tid / SB::CPD + SB::DROWS * i;
        const int c = SB::V * (tid % SB::CPD);
        const bool ok = k0 + kr < g.k;
        const int id = b_src[i];
        const long src =
            GATHER ? (id < 0 ? 0 : (id >= g.b_rows ? g.b_rows - 1 : id)) : id;
        copy_vec(rb + kr * kBN + c, ok ? B + src * g.ldb + n0 + c : b_safe,
                 ok ? g.n - n0 - c : 0, vec_b, b_safe);
      }
    }
  };
  // Half h (units 2h, 2h + 1) of the split of the landed chunk in raw
  // stage st into plane buffer pb.
  auto split = [&](int st, int pb, int h) {
    const TA* ra = reinterpret_cast<const TA*>(raw + st * 2 * kRaw);
    const TB* rb = reinterpret_cast<const TB*>(raw + st * 2 * kRaw + kRaw);
    float* pn = planes + pb * 2 * kPlanes;
#pragma unroll
    for (int i = 2 * h; i < 2 * h + 2; ++i) {
      split_unit<A_KM>(ra, pn, i);
      split_unit<B_KN>(rb, pn + kPlanes, i);
    }
  };
  // The split's writes made visible to the tensor cores' reads (the
  // async proxy), before the barrier that hands the planes over.
  auto publish = [] {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float acc[64], p0[64], p1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const int k16 = (g.k + 15) / 16;  // k16 steps over the depth
  const int chunks = (g.k + kBK - 1) / kBK;

  int b_src[SB::IT] = {};
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < chunks) {
      if (B_KN) rows_of(t, b_src);
      load(t, t, b_src);
    }
    tf32x3::cp_async_commit();
  }
  if (B_KN) rows_of(kStages, b_src);
  tf32x3::cp_async_wait<kStages - 1>();
  __syncthreads();
  split(0, 0, 0);
  split(0, 0, 1);
  publish();

  // Iteration t: each k16 step of chunk t goes to the tensor cores
  // (asynchronous) and half of chunk t + 1 is split while it runs, then
  // chunk t + 3's copies are issued, then each step's product (from zero,
  // mma3x2's pass order) is added to the f32 accumulator in depth order.
  for (int t = 0; t < chunks; ++t) {
    tf32x3::cp_async_wait<kStages - 2>();  // chunk t + 1 has landed
    __syncthreads();
    const float* pa = planes + (t & 1) * 2 * kPlanes;
    const float* pb = pa + kPlanes;
    const bool second = 2 * t + 1 < k16;  // the chunk's second k16 step
    const bool more = t + 1 < chunks;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float (&p)[64] = s == 0 ? p0 : p1;
      // k8 step kk of step s: depth groups 4s + 2kk, 4s + 2kk + 1
      const uint64_t a_hi[2] = {desc(pa + core(4 * s, 64 * wg)),
                                desc(pa + core(4 * s + 2, 64 * wg))};
      const uint64_t b_hi[2] = {desc(pb + core(4 * s, 0)),
                                desc(pb + core(4 * s + 2, 0))};
      const uint64_t lo = (uint64_t)(kPlane * 4) >> 4;  // hi → lo
      if (s == 0 || second) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          wgmma(p, a_hi[kk] + lo, b_hi[kk], kk);  // lo·hi, from zero first
          wgmma(p, a_hi[kk], b_hi[kk] + lo, 1);   // hi·lo
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) wgmma(p, a_hi[kk], b_hi[kk], 1);
        wgmma_commit();
      }
      // half of chunk t + 1's split while the tensor cores take step s
      if (more) split((t + 1) % kStages, (t + 1) & 1, s);
    }
    if (more) publish();
    int next_src[SB::IT] = {};
    if (t + kStages < chunks) {
      if (B_KN) rows_of(t + kStages + 1, next_src);
      load(t + kStages, t % kStages, b_src);
    }
    tf32x3::cp_async_commit();
#pragma unroll
    for (int i = 0; i < SB::IT; ++i) b_src[i] = next_src[i];
    // Both steps' products read only after the whole group has landed:
    // an accumulator read while another wgmma is in flight serializes
    // every wgmma of the kernel (ptxas C7514).
    wgmma_wait<0>();
    fence_regs(p0);
    fence_regs(p1);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += p0[i];
    if (second) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += p1[i];
    }
  }

  // acc[4j + 2h + u]: row 16·(warp & 3) + gq + 8h of the warpgroup's 64,
  // column 8j + 2q + u (wgmma's accumulator layout).
  float* out = g.out + bt * g.out_batch;
  const bool vec_o = g.vec_o;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long m = m0 + 64 * wg + 16 * (warp & 3) + gq + 8 * h;
    if (m >= g.m) continue;
    const bool zero =
        g.m_zero != nullptr && g.m_zero[bt * g.mz_batch + m] < 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n >= g.n) continue;
      float* o = out + m * g.ldo + n;
      float v0 = zero ? 0.f : acc[4 * j + 2 * h];
      float v1 = zero ? 0.f : acc[4 * j + 2 * h + 1];
      if (vec_o && n + 1 < g.n) {
        if (ACC) {
          const float2 w = *reinterpret_cast<const float2*>(o);
          v0 = w.x + v0;
          v1 = w.y + v1;
        }
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = ACC ? o[0] + v0 : v0;
        if (n + 1 < g.n) o[1] = ACC ? o[1] + v1 : v1;
      }
    }
  }
}

// 1 when an operand of element size `elem` at a has rows (and batches)
// that start 16-byte aligned at leading dimension ld.
inline int vec_ok(const void* a, long batch, int ld, int elem) {
  const int v = 16 / elem;
  return ld % v == 0 && batch % v == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

// Launches `batch` products on stream s; `done` is the caller's per-device
// table of the kernel's shared-memory opt-in (kept in the caller's .cu:
// see tf32x3::allow_max_smem). cudaErrorInvalidValue for an empty shape
// or a grid the card does not take.
template <bool A_KM, bool B_KN, bool GATHER, bool ACC, typename TA = float,
          typename TB = TA>
cudaError_t gemm(Gemm g, long batch, cudaStream_t s,
                 bool (&done)[tf32x3::kMaxDevices]) {
  if (g.m <= 0 || g.n <= 0 || g.k <= 0 || batch <= 0 || batch > 65535)
    return cudaErrorInvalidValue;
  const long gx = (g.m + kBM - 1) / kBM, gy = (g.n + kBN - 1) / kBN;
  if (gx > 0x7fffffffL || gy > 65535) return cudaErrorInvalidValue;
  g.vec_a = vec_ok(g.a, g.a_batch, g.lda, sizeof(TA));
  g.vec_b = vec_ok(g.b, GATHER ? 0 : g.b_batch, g.ldb, sizeof(TB));
  g.vec_o = g.ldo % 2 == 0 && g.out_batch % 2 == 0 &&
            reinterpret_cast<uintptr_t>(g.out) % 8 == 0;
  auto kernel = gemm_kernel<A_KM, B_KN, GATHER, ACC, TA, TB>;
  cudaError_t err = tf32x3::allow_max_smem(kernel, done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)gx, (unsigned)gy, (unsigned)batch), kThreads, kSmem,
            s>>>(g);
  return cudaGetLastError();
}

template <bool A_KM, bool B_KN, bool GATHER, bool ACC>
cudaError_t gemm_bf16(Gemm g, long batch, cudaStream_t s,
                      bool (&done)[tf32x3::kMaxDevices]);

// The score slab S (c, n_q), row-major at a pitch of ld ≥ n_q floats:
// S[r·ld + j] = y[r] · q[j], catalog rows as A and queries as B —
// topk_tile.cuh's score_step orientation, so that a slab score equals
// target_scores' for the pair bit for bit. The
// deep mips_topk and eval_fused sweeps then read S. f32: gemm's 3xTF32;
// bf16: gemm_bf16, one product over the whole depth per score, so a
// query's scores do not depend on the other queries of its slab.
template <typename T>
cudaError_t score_slab(const T* q, const T* y, float* s, int n_q, int c,
                       int d, int ld, cudaStream_t st,
                       bool (&done)[tf32x3::kMaxDevices]) {
  Gemm g{};
  g.a = y;
  g.lda = d;
  g.b = q;
  g.ldb = d;
  g.out = s;
  g.ldo = ld;
  g.m = c;
  g.n = n_q;
  g.k = d;
  if constexpr (sizeof(T) == 2)
    return gemm_bf16<false, false, false, false>(g, 1, st, done);
  else
    return gemm<false, false, false, false, T, T>(g, 1, st, done);
}

// ---------------------------------------------------------------------------
// gemm_bf16: the same product (the Gemm struct, A_KM, B_KN, GATHER, ACC,
// m_zero, the f32 output and its epilogue) for bf16 × bf16 operands at the
// tensor cores' bf16 rate: `wgmma` m64n128k16 .f32.bf16.bf16 reads both
// operands as stored, from shared memory in its 128-byte-swizzled layout,
// and accumulates over the whole depth in the tensor cores (f32). Used by
// the deep SCE (sce_gather.cu: the logits, dX = G · Y[idx], Gᵀ · x_b),
// the deep full CE (linear_ce.cu: the chunk's logits, dX += G · W_chunk,
// dW_chunk = Gᵀ · X), G their bf16 cotangent, and the score slab of the
// deep mips_topk and eval sweeps (score_slab above), on bf16 operands.
// An output's bits do not depend on where it sits in its tile, and a
// per-pair `mma.sync` m16n8k16 bf16 chain from zero in ascending k16
// steps gives them (probes/bf16_tc_check.py slab_bits): topk_tile.cuh's
// target_scores runs that chain, so a target score stays the slab's.
//
// What bounds it on an H100: 2·M·N·K FLOP at the dense bf16 989 TFLOP/s;
// the bytes (each operand once at 2 B a value, the f32 output once) where
// the depth is short (Gᵀ · x_b: K = b_x = 128).
//
// Design (Hopper's usual shape, cuda_guide.md "Warp Specialization"):
//   * a persistent grid, one block an SM, walking 128 × 128 output tiles
//     (n fastest where A is the larger operand, so a tile of A is read
//     once while B's rows stay in L2; else m fastest). The tile, from
//     the clock profile by phase (probes/deep_tc_turns.py profile bf16):
//     the gathered products wait on their copies and dY's slot rows
//     (K = b_x = 128) on their f32 stores, which a wider tile moves
//     neither of; the SCE slabs are 1,024–18,432 tiles, so 128 × 128
//     leaves no SM idle;
//   * one producer warpgroup keeps a ring of kBStages stages of 64 depths
//     (16 KB an operand) in flight, across tile boundaries: dense operands
//     whose rows start 16-byte aligned come by TMA (one thread, a 3-D
//     tensor map with the batch, zeros past the edges, completion on the
//     stage's mbarrier); gathered rows (the TMA does not gather) by
//     16-byte cp.async of its 128 threads into the same swizzled layout,
//     the ids loaded apart from the copies (N-major: a stage ahead),
//     tracked by the same mbarrier (cp.async.mbarrier.arrive.noinc); rows
//     not 16-byte aligned through registers (2-byte loads, 16-byte shared
//     stores) — one kernel, three ways in. (A 1-row TMA box per gathered
//     row, which the address-keyed swizzle allows, was tried: 3.3–3.8×
//     slower on the SCE logits and dX, 128 boxes of 128 bytes a stage;
//     PERF.md.)
//   * two consumer warpgroups of 64 output rows each issue four
//     m64n128k16 `wgmma` a stage, keep one stage's group in flight and
//     free the stage before (the empty mbarrier), and read the
//     accumulators only after the tile's last group has landed (a read
//     while a wgmma is in flight serializes them all: ptxas C7514).
// Layouts (the TMA's SWIZZLE_128B, 1024-byte aligned stages): K-major
// (A, or B without B_KN) 128 rows × 128 bytes, the 16-byte chunk c of row
// r at c ^ (r mod 8); M- or N-major (A_KM, B_KN) two halves of 64 columns,
// each 64 depth rows × 128 bytes swizzled alike — wgmma's transpose bits
// take them as they are. Shared memory kBStages · 32 KB + barriers.

constexpr int kBBK = 64;            // depth a stage: 128 bytes of bf16
constexpr int kBStages = 6;
constexpr int kBTile = kBM * kBBK * 2;  // bytes of one operand's stage
constexpr int kBConsumers = 256;    // two warpgroups of 64 output rows
constexpr int kBThreads = kBConsumers + 128;  // + the producer warpgroup
constexpr size_t kBSmem = (size_t)kBStages * 2 * kBTile + 1024 + 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}
// An arrival once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// A 3-D box of the tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// A wgmma descriptor of a 128-byte-swizzled operand at p: lbo the stride
// between 64-column halves (M- or N-major; K-major: unused, 16), sbo
// 1024 bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d += A·Bᵀ on a 64 × 128 × 16 tile of bf16 from shared memory; TA / TB 1
// for an M- / N-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, 1, 1, 1, %66, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

// The units of a producer thread pt (1,024 16-byte units of 8 values a
// stage, 8 a thread): K-major, row (pt >> 3) + 16·i, 16-byte chunk
// pt & 7; M- or N-major, depth row (pt >> 4) + 8·i, 8-column group
// pt & 15 of 128 columns.
template <bool MN>
__device__ __forceinline__ int unit_row(int pt, int i) {
  return MN ? (pt >> 4) + 8 * i : (pt >> 3) + 16 * i;
}

// A gathered operand's source ids of this thread's units: rows base + r
// of the tile (K-major: fixed for the tile; MN-major: the stage's depth
// rows), 0 past lim. Loaded apart from the copies, so that the eight
// loads are in flight together (and, MN-major, a stage ahead).
template <bool MN>
__device__ __forceinline__ void load_ids(int (&ids)[8], const int* idx,
                                         int lim, int base, int pt) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = base + unit_row<MN>(pt, i);
    ids[i] = r < lim ? idx[r] : 0;
  }
}

// One operand's stage written by the producer warpgroup's 128 threads
// (thread pt) as the TMA would write it, for rows the TMA cannot take:
// gathered rows by 16-byte cp.async (vec: rows 16-byte aligned), rows
// not 16-byte aligned by 2-byte loads through registers and 16-byte
// shared stores. K-major (!MN): rows r0 .. r0 + 127 of extent `extent`
// (gathered: row r is src row clamp(ids)), depths k0 .. k0 + 63 of
// `depth`. MN-major: depth rows k0 .. k0 + 63 (gathered: src rows
// clamp(ids)), columns r0 .. r0 + 127 of `extent`. Values past either
// edge are 0.
template <bool MN, bool GATHER>
__device__ __forceinline__ void copy_stage(unsigned char* tile,
                                           const bf16* src, long ld,
                                           int extent, int depth, int r0,
                                           int k0, const int (&ids)[8],
                                           int rows, bool vec, int pt) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = unit_row<MN>(pt, i);
    long row;
    int col, n;
    uint32_t off;
    if (!MN) {
      const int c = pt & 7;
      row = r0 + r;
      col = k0 + 8 * c;
      n = row < extent ? depth - col : 0;
      off = r * 128 + ((c ^ (r & 7)) << 4);
    } else {
      const int c = pt & 15;
      row = k0 + r;
      col = r0 + 8 * c;
      n = row < depth ? extent - col : 0;
      off = (c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    }
    n = n < 0 ? 0 : (n > 8 ? 8 : n);
    if (GATHER) row = ids[i] < 0 ? 0 : (ids[i] >= rows ? rows - 1 : ids[i]);
    const bf16* p = n > 0 ? src + row * ld + col : src;
    if (vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(tile + off)),
                   "l"(p), "r"(2 * n)
                   : "memory");
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < n) w[j >> 1] |= (uint32_t)p[j].bits << (16 * (j & 1));
      *reinterpret_cast<uint4*>(tile + off) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <bool A_KM, bool B_KN, bool GATHER, bool ACC>
__global__ void __launch_bounds__(kBThreads, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, Gemm g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(smem + (size_t)kBStages * 2 * kBTile);
  uint64_t* const empty = full + kBStages;
  const int tid = threadIdx.x;
  const bool copies = !g.tma_a || !g.tma_b;
  if (tid == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(full + s, 1 + (copies ? 128 : 0));
      mbar_init(empty + s, kBConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int gm = (g.m + kBM - 1) / kBM, gn = (g.n + kBN - 1) / kBN;
  const int chunks = (g.k + kBBK - 1) / kBBK;
  // output tile → (m0, n0, batch)
  auto tile_of = [&](long t, long& m0, int& n0, long& bt) {
    bt = t / ((long)gm * gn);
    const long r = t - bt * gm * gn;
    const long mt = g.n_fast ? r / gn : r % gm;
    const long nt = g.n_fast ? r % gn : r / gm;
    m0 = mt * kBM;
    n0 = (int)nt * kBN;
  };

  if (tid >= kBConsumers) {  // the producer warpgroup
    const int pt = tid - kBConsumers;
    const bool sync_copy = (!g.tma_a && !g.vec_a) || (!g.tma_b && !g.vec_b);
    const int tx = (g.tma_a ? kBTile : 0) + (g.tma_b ? kBTile : 0);
    long it = 0;
    for (long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      long m0, bt;
      int n0;
      tile_of(t, m0, n0, bt);
      const bf16* const A = static_cast<const bf16*>(g.a) + bt * g.a_batch;
      const bf16* const B =
          static_cast<const bf16*>(g.b) + (GATHER ? 0 : bt * g.b_batch);
      const int* const idx = GATHER ? g.b_idx + bt * g.idx_batch : nullptr;
      // gathered ids: K-major once a tile; N-major a stage ahead
      int ids[8] = {}, next[8] = {};
      if (GATHER)
        load_ids<B_KN>(B_KN ? next : ids, idx, B_KN ? g.k : g.n,
                       B_KN ? 0 : n0, pt);
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = (int)(it % kBStages);
        mbar_wait(empty + s, (uint32_t)((it / kBStages) & 1) ^ 1u);
        unsigned char* const ta = smem + (size_t)s * 2 * kBTile;
        unsigned char* const tb = ta + kBTile;
        const int k0 = c * kBBK;
        if (pt == 0) {
          mbar_arrive_tx(full + s, tx);
          if (g.tma_a) {
            if (!A_KM) {
              tma_load(ta, &map_a, k0, (int)m0, (int)bt, full + s);
            } else {
              tma_load(ta, &map_a, (int)m0, k0, (int)bt, full + s);
              tma_load(ta + kBTile / 2, &map_a, (int)m0 + 64, k0, (int)bt,
                       full + s);
            }
          }
          if (g.tma_b) {
            if (!B_KN) {
              tma_load(tb, &map_b, k0, n0, (int)bt, full + s);
            } else {
              tma_load(tb, &map_b, n0, k0, (int)bt, full + s);
              tma_load(tb + kBTile / 2, &map_b, n0 + 64, k0, (int)bt,
                       full + s);
            }
          }
        }
        if (!g.tma_a)
          copy_stage<A_KM, false>(ta, A, g.lda, g.m, g.k, (int)m0, k0, ids,
                                  0, false, pt);
        if (GATHER && B_KN) {
#pragma unroll
          for (int i = 0; i < 8; ++i) ids[i] = next[i];
          if (c + 1 < chunks) load_ids<true>(next, idx, g.k, k0 + kBBK, pt);
        }
        if (!g.tma_b)
          copy_stage<B_KN, GATHER>(tb, B, g.ldb, g.n, g.k, n0, k0, ids,
                                   g.b_rows, g.vec_b, pt);
        if (sync_copy) {  // registers' stores (and any cp.async)
          asm volatile("cp.async.wait_all;\n" ::: "memory");
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full + s);
        } else if (copies) {
          mbar_arrive_cp_async(full + s);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // the consumer warpgroups: rows 64·wg .. 64·wg + 63 of each tile
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int wg = warp >> 2;
  const uint32_t lbo_a = A_KM ? 8192 : 16, lbo_b = B_KN ? 8192 : 16;
  long it = 0;
  for (long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    long m0, bt;
    int n0;
    tile_of(t, m0, n0, bt);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = (int)(it % kBStages);
      mbar_wait(full + s, (uint32_t)((it / kBStages) & 1));
      if (copies) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const unsigned char* const ta = smem + (size_t)s * 2 * kBTile;
      const unsigned char* const tb = ta + kBTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBBK / 16; ++kk) {
        const uint64_t da = sw128_desc(
            ta + wg * (kBTile / 2) + kk * (A_KM ? 2048 : 32), lbo_a);
        const uint64_t db = sw128_desc(tb + kk * (B_KN ? 2048 : 32), lbo_b);
        wgmma_bf16<A_KM ? 1 : 0, B_KN ? 1 : 0>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before has been read: free it
      if (prev >= 0) mbar_arrive(empty + prev);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + prev);

    // acc[4j + 2h + u]: row 16·(warp & 3) + gq + 8h of the warpgroup's 64,
    // column 8j + 2q + u (wgmma's accumulator layout).
    float* out = g.out + bt * g.out_batch;
    if (g.vec_o == 2) {
      // 16-byte stores: lanes q and q ^ 1 swap a pair, so that an even q
      // holds 4 columns of row h = 0 and an odd q 4 columns of row h = 1
      const int hh = q & 1;
      const long m = m0 + 64 * wg + 16 * (warp & 3) + gq + 8 * hh;
      const bool live = m < g.m;
      const bool zero = live && g.m_zero != nullptr &&
                        g.m_zero[bt * g.mz_batch + m] < 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float r0 = __shfl_xor_sync(
            0xffffffffu, hh ? acc[4 * j] : acc[4 * j + 2], 1);
        const float r1 = __shfl_xor_sync(
            0xffffffffu, hh ? acc[4 * j + 1] : acc[4 * j + 3], 1);
        float4 v = hh ? make_float4(r0, r1, acc[4 * j + 2], acc[4 * j + 3])
                      : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1);
        const int n = n0 + 8 * j + 2 * (q & 2);
        if (!live || n >= g.n) continue;
        if (zero) v = make_float4(0.f, 0.f, 0.f, 0.f);
        float* o = out + m * g.ldo + n;
        if (n + 3 < g.n) {
          if (ACC) {
            const float4 w = *reinterpret_cast<const float4*>(o);
            v = make_float4(w.x + v.x, w.y + v.y, w.z + v.z, w.w + v.w);
          }
          *reinterpret_cast<float4*>(o) = v;
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (n + u < g.n) o[u] = ACC ? o[u] + e[u] : e[u];
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long m = m0 + 64 * wg + 16 * (warp & 3) + gq + 8 * h;
        if (m >= g.m) continue;
        const bool zero =
            g.m_zero != nullptr && g.m_zero[bt * g.mz_batch + m] < 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + 8 * j + 2 * q;
          if (n >= g.n) continue;
          float* o = out + m * g.ldo + n;
          float v0 = zero ? 0.f : acc[4 * j + 2 * h];
          float v1 = zero ? 0.f : acc[4 * j + 2 * h + 1];
          if (g.vec_o && n + 1 < g.n) {
            if (ACC) {
              const float2 w = *reinterpret_cast<const float2*>(o);
              v0 = w.x + v0;
              v1 = w.y + v1;
            }
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = ACC ? o[0] + v0 : v0;
            if (n + 1 < g.n) o[1] = ACC ? o[1] + v1 : v1;
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, fetched once through the runtime's entry-point
// lookup (no link against libcuda); null where libcuda lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 operand's tensor map: `batch` matrices `outer` rows of `inner`
// values, rows ld values apart, matrices `batch_ld` apart; boxes of 64
// values × box_rows rows, 128-byte swizzle, zeros out of range.
inline bool bf16_map(CUtensorMap* map, const void* base, long inner,
                     long outer, long batch, long ld, long batch_ld,
                     int box_rows) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  if (batch <= 1) batch_ld = ld * outer;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)(batch < 1 ? 1 : batch)};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2,
                                 (cuuint64_t)batch_ld * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t el[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, el,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The card's SM count (the persistent grid), per device.
inline int sm_count() {
  static int n[tf32x3::kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < tf32x3::kMaxDevices && n[dev] > 0) return n[dev];
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < tf32x3::kMaxDevices) n[dev] = v;
  return v;
}

// Launches `batch` bf16 products on stream s (shapes and options as
// gemm()); `done` the caller's shared-memory opt-in table.
// cudaErrorInvalidValue for an empty shape, and where
// cuTensorMapEncodeTiled refuses a tensor map.
template <bool A_KM, bool B_KN, bool GATHER, bool ACC>
cudaError_t gemm_bf16(Gemm g, long batch, cudaStream_t s,
                      bool (&done)[tf32x3::kMaxDevices]) {
  if (g.m <= 0 || g.n <= 0 || g.k <= 0 || batch <= 0 ||
      batch > 0x7fffffffL)
    return cudaErrorInvalidValue;
  const long gm = (g.m + kBM - 1) / kBM, gn = (g.n + kBN - 1) / kBN;
  g.tiles = gm * gn * batch;
  g.n_fast = g.m > g.n;
  g.vec_a = vec_ok(g.a, g.a_batch, g.lda, 2);
  g.vec_b = vec_ok(g.b, GATHER ? 0 : g.b_batch, g.ldb, 2);
  // the output's widest stores: 16 bytes (2), 8 (1) or 4 (0)
  g.vec_o = vec_ok(g.out, g.out_batch, g.ldo, 4)
                ? 2
                : g.ldo % 2 == 0 && g.out_batch % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(g.out) % 8 == 0;
  CUtensorMap ma{}, mb{};
  g.tma_a = g.vec_a;
  g.tma_b = g.vec_b && !GATHER;
  if (g.tma_a && !(A_KM ? bf16_map(&ma, g.a, g.m, g.k, batch, g.lda,
                                   g.a_batch, 64)
                        : bf16_map(&ma, g.a, g.k, g.m, batch, g.lda,
                                   g.a_batch, kBM)))
    return cudaErrorInvalidValue;
  if (g.tma_b && !(B_KN ? bf16_map(&mb, g.b, g.n, g.k, batch, g.ldb,
                                   g.b_batch, 64)
                        : bf16_map(&mb, g.b, g.k, g.n, batch, g.ldb,
                                   g.b_batch, kBN)))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  auto kernel = gemm_bf16_kernel<A_KM, B_KN, GATHER, ACC>;
  cudaError_t err = tf32x3::allow_max_smem(kernel, done);
  if (err != cudaSuccess) return err;
  const long grid = g.tiles < sms ? g.tiles : sms;
  kernel<<<(unsigned)grid, kBThreads, kBSmem, s>>>(ma, mb, g);
  return cudaGetLastError();
}

}  // namespace deep_tc
