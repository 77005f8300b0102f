#!/usr/bin/env python3
"""The rate and latency of ``mma.sync.m16n8k8`` TF32 on the card, the
instruction that ``csrc/linear_ce.cu``'s backward kernels run on. Needs an
NVIDIA GPU and ``nvcc``.

    python3 probes/tf32_mma_rate.py

builds a small kernel into ``build/probes/`` and prints one JSON line:

- ``throughput_tflops``: 2·16·8·8 FLOPs per ``mma``, every warp issuing
  eight independent accumulator chains, for 2, 4, 8 and 16 warps per SM
  (132 blocks of 64 to 512 threads) — the most that ``mma.sync`` gives at
  each occupancy, against the 495 TFLOP/s of dense TF32 that ``wgmma``
  reaches;
- ``chain_cycles``: SM clock cycles per ``mma`` of one dependent chain in
  a single warp (``clock64``), the latency a chain of dependent ``mma``
  pays.

With ``nvidia-smi``'s card name and power limit.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "probes"

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Eight independent chains a warp, `iters` mma each.
__global__ void rate_kernel(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f800000u + threadIdx.x * 3 + i;
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c) mma(acc[c], a, b);
  float s = 0.f;
  for (int c = 0; c < 8; ++c)
    for (int i = 0; i < 4; ++i) s += acc[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One warp, one dependent chain: cycles per mma.
__global__ void chain_kernel(float* out, long long* cycles, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f800000u + i;
  float acc[4] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) mma(acc, a, b);
  const long long t1 = clock64();
  out[threadIdx.x] = acc[0] + acc[1] + acc[2] + acc[3];
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

extern "C" int rate(float* out, int blocks, int threads, int iters,
                    void* stream) {
  rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int chain(float* out, long long* cycles, int iters,
                     void* stream) {
  chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(out, cycles, iters);
  return (int)cudaGetLastError();
}
"""


def main():
    sys.path.insert(0, str(REPO / "src"))
    import torch

    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "tf32_mma_rate.cu"
    lib_path = OUT / "tf32_mma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rate.argtypes = [p, i, i, i, p]
    lib.chain.argtypes = [p, p, i, p]
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(n_sm * 512, device=dev)
    iters = 4096
    rates = {}
    for warps in (2, 4, 8, 16):
        threads = 32 * warps
        assert lib.rate(out.data_ptr(), n_sm, threads, 16, stream) == 0
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        assert lib.rate(out.data_ptr(), n_sm, threads, iters, stream) == 0
        b.record()
        b.synchronize()
        flops = 2 * 16 * 8 * 8 * 8 * iters * warps * n_sm
        rates[warps] = flops / (a.elapsed_time(b) * 1e-3) / 1e12
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    assert lib.chain(out.data_ptr(), cycles.data_ptr(), iters, stream) == 0
    torch.cuda.synchronize()
    print(json.dumps({
        "card": card,
        "throughput_tflops": {f"{w}_warps_per_sm": r
                              for w, r in rates.items()},
        "chain_cycles": cycles.item() / iters}))


if __name__ == "__main__":
    main()
