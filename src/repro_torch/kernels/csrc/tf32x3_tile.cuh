// tf32x3_tile — f32-accurate products on Hopper's tensor cores ("3xTF32"),
// for kernels that compute a logit tile S = A·Bᵀ, fold it into an online
// logsumexp or multiply its cotangent G back into a (rows, d) gradient.
// linear_ce.cu's and sce_gather.cu's kernels use it, with the softcap,
// the online-logsumexp helpers and the constants both files share.
//
// The arithmetic. An f32 value a is split into a_hi = tf32(a) and
// a_lo = tf32(a − a_hi), each rounded to nearest with ties away from zero
// (cvt.rna.tf32.f32: 10 explicit mantissa bits). a − a_hi is exact in
// f32, so a_hi + a_lo carries 22 bits of a's 24. A product is
//   a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
// (the small terms first), each an m16n8k8 tf32 `mma.sync` with f32
// accumulation; the dropped a_lo·b_lo and the two splits' rounding leave
// about 2⁻²¹ relative per product, against 2⁻²⁴ for an f32 FMA.
// The tensor cores add inside an `mma` without round-to-nearest (the
// addends are aligned to the largest and cut), so no sum runs long inside
// them: each k16 step (two k8 steps, six `mma`) starts from zero and is
// added to an f32 register accumulator with an ordinary FADD. The cut
// then costs a few units in the last place of a 16-term partial, not of
// the whole sum, and a sum over a catalog of 10⁵ columns rounds like an
// f32 FMA loop. kernels/ref.py::tf32_round is the plain version of the
// rounding.
//
// The layouts. A matrix of rows × d is split once, by split_kernel in
// linear_ce.cu, into rows × dp / 8 blocks of (hi[8], lo[8]), dp = d
// rounded up to 16 with zeros past d: a row is dp / 2 chunks of 16 bytes
// (hi of depths 8b .. 8b + 3, hi of 8b + 4 .. 8b + 7, then the two lo
// chunks), whole 128-byte lines. A streamed tile keeps that layout in
// shared memory, chunk c of row r at chunk c ^ f(r) of its line,
// f(r) = 2·((r₁ << 1) | (r₀ ^ r₂)) on the bits of r, which makes both of
// its fragment reads below free of bank conflicts. A block's owned rows
// are staged once into the A fragments themselves: per m16 tile, k8 step
// and lane, a float4 of hi and one of lo, read with one LDS.128 each
// (lanes 32 bytes apart: two-way bank conflicts, which a lane-contiguous
// order removes but at 255 registers made the plucked dX kernel spill).
//
// The fragments (m16n8k8, lane = 4·gq + q): A holds (row gq, k q),
// (gq + 8, q), (gq, q + 4), (gq + 8, q + 4); B (k q, n gq), (q + 4, gq);
// C (gq, 2q), (gq, 2q + 1), (gq + 8, 2q), (gq + 8, 2q + 1). The k order
// inside a k8 step is free as long as A and B agree, and every product
// here uses logical k q ↔ physical 2q and q + 4 ↔ 2q + 1:
//   * logit tile, k = depth: a thread's B values at depths 8s + 2q and
//     8s + 2q + 1 of one streamed row are adjacent, one LDS.64 for hi and
//     one for lo, straight into the fragment registers;
//   * second product, k = the streamed tile's rows: the cotangent G is in
//     the C layout, whose columns 2q, 2q + 1 are exactly logical k q and
//     q + 4, so G's accumulator registers are the A fragment
//     (c0, c2, c1, c3) without a shuffle, and B is four LDS.32 from
//     streamed rows 2q and 2q + 1 at depth gq (hi and lo).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int kWarpRows = 32;    // owned rows per warp ...
constexpr int kMT = kWarpRows / 16;  // ... as m16 tiles
constexpr int kStreamRows = 32;  // rows of a streamed tile: four n8 tiles
constexpr int kOutCols = 64;     // output depth columns per block: 8 n8
constexpr int kDepthAlign = 16;  // dp: whole 128-byte lines of pairs

// Shared by linear_ce.cu and sce_gather.cu.
constexpr float kNegInf = -1e30f;  // a masked logit: finite, never -inf
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in per block on sm_90
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int padded_depth(int d) {
  return (d + kDepthAlign - 1) / kDepthAlign * kDepthAlign;
}

// ---------------------------------------------------------------------------
// PTX: the rounding, the product, exp2, asynchronous copies.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// d += a·b on one m16n8k8 tile, tf32 operands, f32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^a on the SFU (ex2.approx.ftz: about 2 ulp, subnormal results flushed
// to 0) — one MUFU.EX2, where exp2f adds a subnormal fix-up around it.
__device__ __forceinline__ float exp2_approx(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(a));
  return r;
}

// 16 bytes global → shared, zeros when !valid (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global → shared, zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four f32 values global → shared (copy4_to_f32 below, bf16 beside).
__device__ __forceinline__ void copy4_to_f32(float* dst, const float* src,
                                             bool valid, bool vec) {
  if (vec) {
    cp_async16(dst, src, valid);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) cp_async4(dst + j, src + j, valid);
  }
}
__device__ __forceinline__ void copy1_to_f32(float* dst, const float* src,
                                             bool valid) {
  cp_async4(dst, src, valid);
}

// ---------------------------------------------------------------------------
// Shared-memory tiles of (hi, lo) pairs and their fragments.
// ---------------------------------------------------------------------------

// The swizzle of a streamed row: f(r) ∈ {0, 2, 4, 6}, a bijection on the
// rows {0..3}, {4..7}, {0, 2, 4, 6} and {1, 3, 5, 7} of each 8 rows.
__device__ __forceinline__ int swizzle(int r) {
  return 2 * ((((r >> 1) & 1) << 1) | ((r ^ (r >> 2)) & 1));
}

// Three-pass product of one k16 step on an m16n8 tile, from zero: the
// small terms of both k8 steps first, then the large ones.
__device__ __forceinline__ void mma3x2(float (&t)[4],
                                       const uint32_t (&ah)[2][4],
                                       const uint32_t (&al)[2][4],
                                       const uint32_t (&bh)[2][2],
                                       const uint32_t (&bl)[2][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    mma(t, al[k], bh[k]);
    mma(t, ah[k], bl[k]);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) mma(t, ah[k], bh[k]);
}

// One k16 step from zero: mma3x2, or with ONE — operands whose lo parts
// are 0, as bf16 values' are — its two hi·hi passes alone: the same sum
// with the zero passes dropped (lo fragments left unread).
template <bool ONE>
__device__ __forceinline__ void mma_k16(float (&t)[4],
                                        const uint32_t (&ah)[2][4],
                                        const uint32_t (&al)[2][4],
                                        const uint32_t (&bh)[2][2],
                                        const uint32_t (&bl)[2][2]) {
  if constexpr (ONE) {
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) mma(t, ah[k], bh[k]);
  } else {
    mma3x2(t, ah, al, bh, bl);
  }
}

// Loads 4 or 2 tf32 registers from shared memory in one instruction.
__device__ __forceinline__ void lds128(uint32_t (&r)[4], const float* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

__device__ __forceinline__ void lds64(uint32_t (&r)[2], const float* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  r[0] = v.x;
  r[1] = v.y;
}

// ---------------------------------------------------------------------------
// The softcap and the online logsumexp of both files' folds.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float capped(float v, float cap) {
  return cap > 0.f ? cap * tanhf(v / cap) : v;
}

// d capped / d logit as a function of the capped value: 1 − (capped/cap)².
__device__ __forceinline__ float cap_deriv(float c, float cap) {
  if (cap <= 0.f) return 1.f;
  const float t = c / cap;
  return 1.f - t * t;
}

// exp(v − mx) as one FFMA and the SFU's exp2, given mb = mx·log2(e) of a
// finite logit mx ≥ v; 0 for v = kNegInf. Not for mx = kNegInf: the FFMA
// then leaves the rounding error of a product near 1e30, which exp2 takes
// to inf.
__device__ __forceinline__ float exp_from(float v, float mb) {
  return exp2_approx(fmaf(v, kLog2e, -mb));
}

// exp(v − mx) for mx ≥ v, kNegInf included: exactly 1 when v == mx.
__device__ __forceinline__ float exp_diff(float v, float mx) {
  return exp2_approx((v - mx) * kLog2e);
}

// (m, s) ← the online merge of (m, s) and (mo, so).
__device__ __forceinline__ void merge_ms(float& m, float& s, float mo,
                                         float so) {
  const float mn = fmaxf(m, mo);
  s = s * exp_diff(m, mn) + so * exp_diff(mo, mn);
  m = mn;
}

// ---------------------------------------------------------------------------
// bfloat16 operands: stored as they are, widened to f32 where read.
// ---------------------------------------------------------------------------
// A bfloat16 value as stored: the high 16 bits of an f32.
struct bf16 {
  uint16_t bits;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) {
  return __uint_as_float((uint32_t)v.bits << 16);
}
// The two bf16 values packed in a 32-bit word, low half first.
__device__ __forceinline__ float widen_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float widen_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// Four values of type T at p (16-byte aligned for f32, 8-byte for bf16)
// as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(widen_lo(w.x), widen_hi(w.x), widen_lo(w.y),
                     widen_hi(w.y));
}

// f(T{}) for the operands' element type: bf16 when `bf16_in` (the C
// entries' flag), else f32 — the one place a launch picks its
// instantiation.
template <class F>
auto by_dtype(int bf16_in, F&& f) {
  return bf16_in ? f(bf16{}) : f(float{});
}

// v rounded to the nearest bfloat16 (ties to even; a NaN stays a NaN), as
// an f32: the reference's `astype(bfloat16)` of the cotangent before its
// second product (src/repro/kernels/sce_prefetch.py `gw.astype(
// tile.dtype)`), the rounding torch's bfloat16 cast makes.
__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __uint_as_float(u | 0x400000u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// Four values global → shared as f32: f32 by a 16-byte cp.async (`vec`:
// 16-byte aligned) or four 4-byte ones; bf16 through registers, one 8-byte
// load (`vec`: 8-byte aligned) or four 2-byte ones, widened as they are
// stored. Zeros where !valid (nothing is read then). A synchronous store
// is visible at the same barrier that follows the ring's cp.async wait.
// (The f32 versions are with the PTX above.)
__device__ __forceinline__ void copy4_to_f32(float* dst, const bf16* src,
                                             bool valid, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    if (vec) {
      v = load4(src);
    } else {
      v = make_float4(widen(src[0]), widen(src[1]), widen(src[2]),
                      widen(src[3]));
    }
  }
  *reinterpret_cast<float4*>(dst) = v;
}
// One value global → shared as f32.
__device__ __forceinline__ void copy1_to_f32(float* dst, const bf16* src,
                                             bool valid) {
  *dst = valid ? widen(*src) : 0.f;
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

}  // namespace tf32x3
