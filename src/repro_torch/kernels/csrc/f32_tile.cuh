// f32_tile — the 64 × 64 f32 FMA tile code of sce_gather.cu's forward:
// staging rows into shared memory, the register-tiled logit tile, the
// softcap and its derivative (which the 3xTF32 backward shares) and
// half-warp reductions.
//
// A block is 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty·4 .. ty·4 + 3 of a 64-row tile and columns tx + 16·j (j < 4) of a
// 64-column tile, so the 16 threads of a half-warp share their rows. Every
// product is f32 FMAs in a fixed order over the depth (no TF32, no tensor
// cores), so results keep f32 precision and repeat bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32_tile {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kRM = 4;             // rows of the tile per thread
constexpr int kCols = 4;           // columns tx + 16*j of the tile
constexpr int kTile = 16 * kRM;    // 64 rows (and 64 columns) per tile
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;     // 227 KB opt-in per block on sm_90
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

static_assert(16 * kCols == kTile, "the logit tile is square");

// Shared-memory pitch of a staged row, in floats: d rounded up to float4s,
// an odd number of them, so the 8 lanes of a quarter-warp that read 8
// different rows at the same depth hit 8 different bank groups.
__host__ __device__ inline int row_pitch(int d) {
  const int d4 = (d + 3) / 4;
  return 4 * (d4 | 1);
}

__device__ __forceinline__ float capped(float v, float cap) {
  return cap > 0.f ? cap * tanhf(v / cap) : v;
}

// d capped / d logit as a function of the capped value: 1 − (capped/cap)².
__device__ __forceinline__ float cap_deriv(float c, float cap) {
  if (cap <= 0.f) return 1.f;
  const float t = c / cap;
  return 1.f - t * t;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Stages `rows` rows into dst at pitch p: row r < n is read from
// src + row_of(r)·d, rows [n, rows) and the depth padding [d, 4·d4) are
// zero. float4 copies when `vec` (d % 4 == 0, src 16-byte aligned), else
// 4-byte ones. Every thread calls.
template <typename RowOf>
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int rows, int d, int p, int vec,
                                      RowOf row_of, int tid) {
  const int d4 = (d + 3) / 4;
  if (vec) {
    for (int e = tid; e < rows * d4; e += kThreads) {
      const int r = e / d4;
      const int k4 = e - r * d4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n)
        v = *reinterpret_cast<const float4*>(src + (long)row_of(r) * d +
                                             4 * k4);
      *reinterpret_cast<float4*>(dst + r * p + 4 * k4) = v;
    }
  } else {
    const int w = 4 * d4;
    for (int e = tid; e < rows * w; e += kThreads) {
      const int r = e / w;
      const int kk = e - r * w;
      dst[r * p + kk] =
          r < n && kk < d ? src[(long)row_of(r) * d + kk] : 0.f;
    }
  }
}

// acc[i][j] = Σ_k as[ty·kRM + i][k] · bs[tx + 16·j][k] over the staged
// depth (its padding is zero): f32 FMAs in a fixed order over d.
__device__ __forceinline__ void tile_scores(const float* as, const float* bs,
                                            int p, int d4, int ty, int tx,
                                            float acc[kRM][kCols]) {
  const int p4 = p / 4;
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  const float4* a4 = reinterpret_cast<const float4*>(as) + ty * kRM * p4;
  const float4* b4 = reinterpret_cast<const float4*>(bs) + tx * p4;
#pragma unroll 2
  for (int k4 = 0; k4 < d4; ++k4) {
    float4 a[kRM];
    float4 b[kCols];
#pragma unroll
    for (int i = 0; i < kRM; ++i) a[i] = a4[i * p4 + k4];
#pragma unroll
    for (int j = 0; j < kCols; ++j) b[j] = b4[16 * j * p4 + k4];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// 1 when rows of `a` can be read as float4s: d % 4 == 0 and 16-byte aligned.
inline int vec_flag(const float* a, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

}  // namespace f32_tile
