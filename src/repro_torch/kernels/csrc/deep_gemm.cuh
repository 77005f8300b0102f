// deep_gemm — the products of the deep variants, for a depth above the
// 256 that the resident-tile kernels of topk_tile.cuh, mips_topk.cu and
// sce_gather.cu hold whole in shared memory (kMaxD). A batched
// C[b] = A[b] · B[b]ᵀ in 3xTF32 on the tensor cores, with the depth (K)
// walked in chunks of 32 through a double buffer, so any K runs in the
// same 40 KB of shared memory.
//
// Who calls it, and with what:
//   * mips_topk.cu and eval_fused.cu: the score slab S = Y · Qᵀ, catalog
//     rows as A and queries as B — the orientation, (hi, lo) split and k
//     order of topk_tile.cuh's score_step — so a score here equals
//     target_scores' for the same pair bit for bit (each k16 step from
//     zero, added to the accumulator in ascending depth order); the
//     sweeps and the k > 32 chain then read S in place of their products;
//   * sce_gather.cu: the in-bucket logits x_b[n] · Y[idx[n]]ᵀ (positions
//     as A, candidates as B, gathered by id), dX = G · Y[idx] and
//     dY = Gᵀ · x_b on the cotangent G the logits turn into.
//
// The arithmetic is tf32x3_tile.cuh's: every value is split into
// (hi, lo) as it is read from shared memory; a k16 step is mma3x2 from
// zero, then acc += it in f32. The fragment layout is topk_tile.cuh's
// sweep: A fragment (rows gq, gq + 8; logical k q at physical depth 2q,
// q + 4 at 2q + 1) as one LDS.64 per row, B likewise from a row of B.
//
// Shapes: A(m, k) is a[b·a_batch + m·lda + k], or with A_KM
// a[b·a_batch + k·lda + m]; B(n, k) is row(n)[k], or with B_KN row(k)[n],
// where row(r) = b + b·b_batch + r·ldb, or with GATHER
// b + clamp(idx[b·idx_batch + r], 0, b_rows − 1)·ldb. Out of range
// values read 0. out[b·out_batch + m·ldo + n] for m < M, n < N; with
// m_zero, a row m whose m_zero[b·mz_batch + m] < 0 is written 0 (dY's
// slots with a negative id).
//
// Block: 128 threads, a 64 × 64 output tile, 2 × 2 warps of 32 × 32
// (two m16 by four n8 tiles each, 48 `mma` a k16 step); the next depth
// chunk is loaded into registers before the current one's products and
// stored into the other buffer after them: one barrier a chunk. What
// bounds it on an H100: three TF32 passes at 495 TFLOP/s; a simple tile
// (mma.sync, register-staged loads, no TMA) runs well below that. It is
// the depth-chunked product the deep variants needed first; `wgmma` with
// TMA-fed tiles is the way to its bound.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3_tile.cuh"

namespace deep_gemm {

constexpr int kBM = 64;   // output rows (M) a block
constexpr int kBN = 64;   // output columns (N) a block
constexpr int kBK = 32;   // depth (K) a chunk: two k16 steps
constexpr int kPitch = kBK + 8;  // ≡ 8 mod 32: conflict-free LDS.64 reads
constexpr int kThreads = 128;
constexpr int kLoads = kBM * kBK / kThreads;  // values a thread stages

struct Gemm {
  const float* a;
  long a_batch;
  int lda;
  const float* b;
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
};

template <bool A_KM, bool B_KN, bool GATHER>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Gemm g) {
  __shared__ __align__(16) float as[2][kBM * kPitch];
  __shared__ __align__(16) float bs[2][kBN * kPitch];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const long m0 = (long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long bt = blockIdx.z;
  const float* A = g.a + bt * g.a_batch;
  const float* B = g.b + (GATHER ? 0 : bt * g.b_batch);
  const int* idx = GATHER ? g.b_idx + bt * g.idx_batch : nullptr;

  // Value i of this thread in a 64 × 32 chunk: (row r, depth c). The
  // layout contiguous in memory runs along the threads.
  auto at = [&](bool rows_contig, int i, int& r, int& c) {
    const int e = tid + kThreads * i;
    if (rows_contig) {
      r = e & (kBM - 1);
      c = e / kBM;
    } else {
      r = e / kBK;
      c = e & (kBK - 1);
    }
  };
  auto load_a = [&](int k0, int i) -> float {
    int r, c;
    at(A_KM, i, r, c);
    const long m = m0 + r;
    const int k = k0 + c;
    if (m >= g.m || k >= g.k) return 0.f;
    return A_KM ? A[(long)k * g.lda + m] : A[m * g.lda + k];
  };
  auto load_b = [&](int k0, int i) -> float {
    int r, c;
    at(B_KN, i, r, c);
    const int n = n0 + r;
    const int k = k0 + c;
    if (n >= g.n || k >= g.k) return 0.f;
    const int row = B_KN ? k : n;
    long src = row;
    if (GATHER) {
      const int id = idx[row];
      src = id < 0 ? 0 : (id >= g.b_rows ? g.b_rows - 1 : id);
    }
    return B[src * g.ldb + (B_KN ? n : k)];
  };
  float ra[kLoads], rb[kLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      ra[i] = load_a(k0, i);
      rb[i] = load_b(k0, i);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      int r, c;
      at(A_KM, i, r, c);
      as[buf][r * kPitch + c] = ra[i];
      at(B_KN, i, r, c);
      bs[buf][r * kPitch + c] = rb[i];
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int k16 = (g.k + 15) / 16;  // k16 steps over the depth, zeros past K
  const int chunks = (g.k + kBK - 1) / kBK;
  fetch(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < chunks; ++t) {
    const int buf = t & 1;
    if (t + 1 < chunks) fetch((t + 1) * kBK);
    const int steps = min(2, k16 - 2 * t);
    for (int s = 0; s < steps; ++s) {
      uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* r0 = as[buf] + (32 * wm + 16 * mt + gq) * kPitch +
                            16 * s + 8 * kk + 2 * q;
          const float2 u = *reinterpret_cast<const float2*>(r0);
          const float2 v = *reinterpret_cast<const float2*>(r0 + 8 * kPitch);
          tf32x3::split(u.x, ah[mt][kk][0], al[mt][kk][0]);
          tf32x3::split(v.x, ah[mt][kk][1], al[mt][kk][1]);
          tf32x3::split(u.y, ah[mt][kk][2], al[mt][kk][2]);
          tf32x3::split(v.y, ah[mt][kk][3], al[mt][kk][3]);
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float2 w = *reinterpret_cast<const float2*>(
              bs[buf] + (32 * wn + 8 * nt + gq) * kPitch + 16 * s + 8 * kk +
              2 * q);
          tf32x3::split(w.x, bh[kk][0], bl[kk][0]);
          tf32x3::split(w.y, bh[kk][1], bl[kk][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float part[4];
          tf32x3::mma3x2(part, ah[mt], al[mt], bh, bl);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
        }
      }
    }
    if (t + 1 < chunks) store(buf ^ 1);
    __syncthreads();
  }

  float* out = g.out + bt * g.out_batch;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = m0 + 32 * wm + 16 * mt + gq + 8 * h;
      if (m >= g.m) continue;
      const bool zero =
          g.m_zero != nullptr && g.m_zero[bt * g.mz_batch + m] < 0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int n = n0 + 32 * wn + 8 * nt + 2 * q + u;
          if (n < g.n) out[m * g.ldo + n] = zero ? 0.f : acc[mt][nt][2 * h + u];
        }
    }
}

// Launches `batch` products on stream s. cudaErrorInvalidValue for an
// empty shape or a grid the card does not take.
template <bool A_KM, bool B_KN, bool GATHER>
cudaError_t gemm(const Gemm& g, long batch, cudaStream_t s) {
  if (g.m <= 0 || g.n <= 0 || g.k <= 0 || batch <= 0 || batch > 65535)
    return cudaErrorInvalidValue;
  const long gx = (g.m + kBM - 1) / kBM, gy = (g.n + kBN - 1) / kBN;
  if (gx > 0x7fffffffL || gy > 65535) return cudaErrorInvalidValue;
  gemm_kernel<A_KM, B_KN, GATHER>
      <<<dim3((unsigned)gx, (unsigned)gy, (unsigned)batch), kThreads, 0, s>>>(
          g);
  return cudaGetLastError();
}

// The score slab S (c, n_q), row-major: S[r][j] = y[r] · q[j], catalog
// rows as A and queries as B (the sweeps' orientation).
inline cudaError_t score_slab(const float* q, const float* y, float* s,
                              int n_q, int c, int d, cudaStream_t st) {
  Gemm g{};
  g.a = y;
  g.lda = d;
  g.b = q;
  g.ldb = d;
  g.out = s;
  g.ldo = n_q;
  g.m = c;
  g.n = n_q;
  g.k = d;
  return gemm<false, false, false>(g, 1, st);
}

}  // namespace deep_gemm
