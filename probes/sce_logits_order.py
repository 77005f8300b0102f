#!/usr/bin/env python3
"""Do the SCE forward's and dY's logits agree bit for bit? Needs an NVIDIA
GPU and ``nvcc``.

    python3 probes/sce_logits_order.py

``csrc/sce_gather.cu``'s forward and dX take a logit x·y with the
positions as ``mma``'s A operand and the candidates as B; dY takes it with
the two swapped, so the two small terms of each k8 step are added in the
other order (x_lo·y_hi then x_hi·y_lo, against y_lo·x_hi then y_hi·x_lo).
This builds a small kernel on ``csrc/tf32x3_tile.cuh`` (the same split
and ``mma3x2``, k16 steps from zero, added in f32) into
``build/probes/``, computes 4,096 × 4,096 logits both ways from x_b at
3·randn and candidates at randn (d = 64, the trainer's logit scale) and
prints one JSON line: the share of logits whose bits differ, the largest
difference in units in the last place of the logit (``max_ulps``, over
all logits, and ``max_ulps_abs_ge_1`` over those of magnitude 1 or more),
and the largest absolute one — with ``nvidia-smi``'s card name and power
limit.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "probes"
N, D = 4096, 64

SOURCE = r"""
#include "tf32x3_tile.cuh"
using namespace tf32x3;

// rows r0 .. r0 + 15 of a (·, dp) matrix as the A fragments of k8 steps
// 2kk, 2kk + 1; rows c0 .. c0 + 7 as the B fragments (sce_gather.cu's
// depth order: logical k q is depth 2q, q + 4 is 2q + 1).
__device__ void frag_a(const float* m, int r0, int dp, int kk,
                       uint32_t (&h)[2][4], uint32_t (&l)[2][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  for (int k = 0; k < 2; ++k) {
    const int dep = 16 * kk + 8 * k + 2 * q;
    const float v[4] = {m[(r0 + gq) * dp + dep], m[(r0 + gq + 8) * dp + dep],
                        m[(r0 + gq) * dp + dep + 1],
                        m[(r0 + gq + 8) * dp + dep + 1]};
    for (int i = 0; i < 4; ++i) split(v[i], h[k][i], l[k][i]);
  }
}

__device__ void frag_b(const float* m, int c0, int dp, int kk,
                       uint32_t (&h)[2][2], uint32_t (&l)[2][2]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  for (int k = 0; k < 2; ++k) {
    const int dep = 16 * kk + 8 * k + 2 * q;
    split(m[(c0 + gq) * dp + dep], h[k][0], l[k][0]);
    split(m[(c0 + gq) * dp + dep + 1], h[k][1], l[k][1]);
  }
}

// One warp per 16 x rows × 16 y rows: lx[i][j] with x as A (the forward
// and dX), ly[i][j] with y as A (dY).
extern "C" __global__ void logits_kernel(const float* x, const float* y,
                                         float* lx, float* ly, int n,
                                         int dp) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  const int tiles = n / 16;
  if (warp >= tiles * tiles) return;
  const int p0 = 16 * (warp / tiles), c0 = 16 * (warp % tiles);
  for (int way = 0; way < 2; ++way) {
    const float* a = way ? y : x;
    const float* b = way ? x : y;
    const int a0 = way ? c0 : p0, b0 = way ? p0 : c0;
    for (int nt = 0; nt < 2; ++nt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < dp / 16; ++kk) {
        uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
        frag_a(a, a0, dp, kk, ah, al);
        frag_b(b, b0 + 8 * nt, dp, kk, bh, bl);
        float part[4];
        mma3x2(part, ah, al, bh, bl);
        for (int i = 0; i < 4; ++i) acc[i] += part[i];
      }
      for (int i = 0; i < 4; ++i) {
        const int ar = a0 + gq + 8 * (i >> 1);      // A's row
        const int bc = b0 + 8 * nt + 2 * q + (i & 1);  // B's row
        if (way == 0)
          lx[(long)ar * n + bc] = acc[i];
        else
          ly[(long)bc * n + ar] = acc[i];
      }
    }
  }
}

extern "C" int run(const float* x, const float* y, float* lx, float* ly,
                   int n, int dp) {
  const int warps = (n / 16) * (n / 16);
  logits_kernel<<<(warps + 7) / 8, 256>>>(x, y, lx, ly, n, dp);
  return (int)cudaDeviceSynchronize();
}
"""


def main():
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "sce_logits_order.cu"
    src.write_text(SOURCE)
    lib_path = OUT / "sce_logits_order.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes = [p] * 4 + [i] * 2
    lib.run.restype = i
    g = torch.Generator(device="cuda").manual_seed(0)
    x = 3.0 * torch.randn(N, D, generator=g, device="cuda")
    y = torch.randn(N, D, generator=g, device="cuda")
    lx = torch.empty(N, N, device="cuda")
    ly = torch.empty(N, N, device="cuda")
    err = lib.run(x.data_ptr(), y.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                  N, D)
    if err != 0:
        sys.exit(f"cudaError {err}")
    diff = lx != ly
    mag = lx.abs()
    ulps = (lx - ly).abs() / (torch.nextafter(mag, torch.full_like(mag, 1e38))
                              - mag)
    print(chip_smoke.smi())
    print(json.dumps({
        "logits": N * N, "d": D,
        "share_differing": diff.double().mean().item(),
        "max_ulps": ulps.max().item(),
        "max_ulps_abs_ge_1": ulps[mag >= 1].max().item(),
        "max_abs_diff": (lx - ly).abs().max().item(),
        "max_abs_logit": lx.abs().max().item()}))


if __name__ == "__main__":
    main()
