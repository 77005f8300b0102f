#!/usr/bin/env python3
"""The bf16 product of ``csrc/deep_tc.cuh`` (``gemm_bf16``: ``wgmma``
m64n128k16 .f32.bf16.bf16) on the card: every operand option against
f64, its time beside PyTorch's bf16 product, and the bits that tie a
target score to the score slab. Needs an NVIDIA GPU.

    python3 probes/bf16_tc_check.py [options] [times] [slab_bits]

builds the ``linear_ce`` library of this tree (its ``deep_tc_launch``
entry, wrapped by ``linear_sce.deep_tc_product``) and prints one JSON line
per mode:

* ``options``: every operand option (A M-major, B N-major, B gathered by
  clamped id, the accumulate epilogue, zeroed rows) at ragged shapes and
  at row pitches that are and are not 16-byte aligned (the TMA, the
  gathered cp.async and the register-staged copies), each against the
  f64 plain version (``ref.deep_tc_ref``) within ``1e-5·max|C| +
  2e-4·|C|`` and repeating bit for bit.
* ``times``: device ms (CUDA events, mean of 5 after one warm call) of
  the product at the deep backward's shapes — the full CE's chunk logits
  (4,096 × 65,536 × 2304), dX's G · W (4,096 × 2304 × 65,536, W
  N-major), dW's Gᵀ · X (65,536 × 2304 × 4,096, both M/N-major); SCE's
  logits (128 buckets of 128 × 1024 × 2304, the candidates gathered),
  dX (128 × 2304 × 1024, gathered N-major), dY's slot rows (1024 × 2304
  × 128) — beside ``torch.matmul`` / ``bmm`` on the same bf16 tensors
  (f32 out) and the bound at the dense bf16 989 TFLOP/s.

* ``slab_bits``: the two questions that tie a target score to the
  bf16 score slab ``S = Y · Qᵀ`` (catalog rows as A, queries as B), on
  128 random bf16 catalog rows and 128 queries at gemma-2's d 2304 (TMA
  stages) and at d 300 (register-staged rows):
  (a) does an output of ``gemm_bf16`` keep its bits wherever its (row,
  column) sits in the 128 × 128 tile? A holds the catalog rows rolled by
  each of 128 shifts, B the queries rolled by each of 128 shifts, one
  16,384 × 16,384 product; each pair's output at every one of the 128 ×
  128 (row position, column position) is held against its output at
  (i, j) of the unrolled tile, bit for bit;
  (b) does a per-pair chain of ``mma.sync.m16n8k16.row.col.f32.bf16.bf16
  .f32`` (the catalog row as A row gq, the query as B column gq, the
  accumulator carried through ascending k16 steps from zero, zeros past
  d; a small kernel built into ``build/probes/``) give the slab's bits?
  Each answer as the count of equal outputs out of all, with the
  largest difference relative to the slab's scale.

Every line carries ``nvidia-smi``'s card name and power limit.
"""
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def _bf(t):
    import torch
    return t.to(torch.bfloat16)


def options():
    import itertools

    import torch

    from repro_torch.kernels import linear_sce, ref

    results, ok = [], True
    shapes = [(2, 130, 70, 300), (2, 33, 260, 2304), (2, 5, 7, 37),
              (1, 200, 136, 64), (3, 129, 140, 41), (1, 257, 131, 520)]
    for (t, m, n, k), (a_km, b_kn, gather, acc) in itertools.product(
            shapes, itertools.product((False, True), repeat=4)):
        g = torch.Generator(device="cuda").manual_seed(m + n + k)
        a = _bf(torch.randn((t, k, m) if a_km else (t, m, k), generator=g,
                            device="cuda"))
        idx = None
        if gather:
            rows = 50
            b = _bf(torch.randn((rows, n) if b_kn else (rows, k),
                                generator=g, device="cuda"))
            idx = torch.randint(-2, rows + 2, (t, k if b_kn else n),
                                generator=g, device="cuda",
                                dtype=torch.int32)
        else:
            b = _bf(torch.randn((t, k, n) if b_kn else (t, n, k),
                                generator=g, device="cuda"))
        m_zero = (torch.randint(-1, 3, (t, m), generator=g, device="cuda",
                                dtype=torch.int32) if a_km else None)
        out0 = (torch.randn(t, m, n, generator=g, device="cuda")
                if acc else None)
        kw = dict(a_km=a_km, b_kn=b_kn, idx=idx, m_zero=m_zero)
        try:
            got = linear_sce.deep_tc_product(
                a, b, out=None if out0 is None else out0.clone(), **kw)
            again = linear_sce.deep_tc_product(
                a, b, out=None if out0 is None else out0.clone(), **kw)
            torch.cuda.synchronize()
        except RuntimeError as e:
            results.append({"case": [t, m, n, k, a_km, b_kn, gather, acc],
                            "error": str(e)[:200]})
            ok = False
            continue
        want = ref.deep_tc_ref(a.double(), b.double(),
                               out=None if out0 is None else out0.double(),
                               **kw)
        err = (got.double() - want).abs()
        tol = 1e-5 * want.abs().max().item() + 2e-4 * want.abs()
        good = bool((err <= tol).all()) and torch.equal(got, again)
        ok &= good
        if not good:
            results.append({"case": [t, m, n, k, a_km, b_kn, gather, acc],
                            "max_err": err.max().item(),
                            "scale": want.abs().max().item(),
                            "repeat": torch.equal(got, again)})
    return {"all_ok": ok, "failures": results[:12],
            "n_failures": len(results)}


def _time(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def times():
    import torch

    from repro_torch.kernels import linear_sce

    g = torch.Generator(device="cuda").manual_seed(3)
    n, cc, d, c = 4096, 65536, 2304, 256000
    x = _bf(torch.randn(n, d, generator=g, device="cuda"))
    w = _bf(torch.randn(cc, d, generator=g, device="cuda") * 0.02)
    gs = _bf(torch.randn(n, cc, generator=g, device="cuda") * 1e-3)
    out = {}
    f = 2 * n * cc * d

    def row(name, kern, lib, flops):
        out[name] = {"ms": _time(kern), "library_ms": _time(lib),
                     "bound_ms": flops / 989e12 * 1e3}

    row("ce_logits", lambda: linear_sce.deep_tc_product(x[None], w[None]),
        lambda: torch.matmul(x, w.T).float(), f)
    row("ce_dx", lambda: linear_sce.deep_tc_product(gs[None], w[None],
                                                    b_kn=True),
        lambda: torch.matmul(gs, w).float(), f)
    row("ce_dw", lambda: linear_sce.deep_tc_product(gs[None], x[None],
                                                    a_km=True, b_kn=True),
        lambda: torch.matmul(gs.T, x).float(), f)
    del gs
    n_b, b_x, b_y = 128, 128, 1024
    y = _bf(torch.randn(c, d, generator=g, device="cuda") * 0.02)
    x_b = _bf(torch.randn(n_b, b_x, d, generator=g, device="cuda"))
    idx = torch.randint(0, c, (n_b, b_y), generator=g, device="cuda",
                        dtype=torch.int32)
    gb = _bf(torch.randn(n_b, b_x, b_y, generator=g, device="cuda") * 1e-3)
    y_b = y[idx.long()]
    f = 2 * n_b * b_x * b_y * d
    row("sce_logits", lambda: linear_sce.deep_tc_product(x_b, y, idx=idx),
        lambda: torch.bmm(x_b, y_b.transpose(1, 2)).float(), f)
    row("sce_dx", lambda: linear_sce.deep_tc_product(gb, y, idx=idx,
                                                     b_kn=True),
        lambda: torch.bmm(gb, y[idx.long()]).float(), f)
    row("sce_dy_slots", lambda: linear_sce.deep_tc_product(
        gb, x_b, a_km=True, b_kn=True),
        lambda: torch.bmm(gb.transpose(1, 2), x_b).float(), f)
    return out


CHAIN_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// One bf16 value of row p at depth k, 0 past d.
__device__ __forceinline__ uint32_t at(const uint16_t* p, int k, int d) {
  return k < d ? (uint32_t)p[k] : 0u;
}

// out[e] = y[ri[e]] · q[ci[e]] by mma.sync m16n8k16 bf16, one warp a run
// of 8 pairs: pair gq's catalog row as A row gq (rows gq + 8 zero), its
// query as B column gq; the accumulator carried from zero through the
// k16 steps in ascending depth; the diagonal (gq, gq) kept.
__global__ void chain_kernel(const uint16_t* y, const uint16_t* q,
                             const int* ri, const int* ci, float* out,
                             int n, int d) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, qd = lane & 3;
  const int e0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 8;
  if (e0 >= n) return;
  const int e = e0 + gq;
  const bool in = e < n;
  const uint16_t* yr = y + (long)(in ? ri[e] : 0) * d;
  const uint16_t* qr = q + (long)(in ? ci[e] : 0) * d;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < d; k0 += 16) {
    const int k = k0 + 2 * qd;
    const uint32_t a0 = in ? at(yr, k, d) | at(yr, k + 1, d) << 16 : 0u;
    const uint32_t a2 = in ? at(yr, k + 8, d) | at(yr, k + 9, d) << 16 : 0u;
    const uint32_t b0 = in ? at(qr, k, d) | at(qr, k + 1, d) << 16 : 0u;
    const uint32_t b1 = in ? at(qr, k + 8, d) | at(qr, k + 9, d) << 16 : 0u;
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
  }
  if (in && qd == gq >> 1) out[e] = c[gq & 1];
}

extern "C" int chain(const void* y, const void* q, const int* ri,
                     const int* ci, float* out, int n, int d, void* s) {
  const int warps = 4;
  chain_kernel<<<(n + 8 * warps - 1) / (8 * warps), 32 * warps, 0,
                 (cudaStream_t)s>>>((const uint16_t*)y, (const uint16_t*)q,
                                    ri, ci, out, n, d);
  return (int)cudaGetLastError();
}
"""


def _chain_lib():
    from repro_torch.kernels import _build

    out = Path(__file__).resolve().parents[1] / "build" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "bf16_mma_chain.cu", out / "bf16_mma_chain.so"
    src.write_text(CHAIN_SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chain.argtypes = [p, p, p, p, p, i, i, p]
    return lib


def slab_bits():
    import torch

    from repro_torch.kernels import linear_sce

    lib = _chain_lib()
    out = {}
    t = 128
    ar = torch.arange(t, device="cuda")
    for d in (2304, 300):
        g = torch.Generator(device="cuda").manual_seed(d)
        y = _bf(torch.randn(t, d, generator=g, device="cuda") * 0.02)
        q = _bf(torch.randn(t, d, generator=g, device="cuda"))
        # A's block p holds catalog row i at row position (i + p) mod 128
        roll = (ar[None, :] - ar[:, None]) % t  # [p, pos] → row
        a = y[roll.reshape(-1)].contiguous()
        b = q[roll.reshape(-1)].contiguous()
        s = linear_sce.deep_tc_product(a[None], b[None])[0]
        s4 = s.view(t, t, t, t)  # [p, row pos, r, column pos]
        del s
        pos = (ar[None, :] + ar[:, None]) % t  # [p, i] → row position
        v = s4[ar[:, None, None, None], pos[:, :, None, None],
               ar[None, None, :, None], pos[None, None, :, :]]
        del s4
        base = v[0, :, 0, :].contiguous()  # pair (i, j) at (i, j)
        same = (v.view(torch.int32)
                == base.view(torch.int32)[None, :, None, :])
        n_pos = same.numel()
        eq_pos = int(same.sum().item())
        del same
        spread = (v - base[None, :, None, :]).abs().max().item()
        del v
        ri = ar.repeat_interleave(t).to(torch.int32)
        ci = ar.repeat(t).to(torch.int32)
        chain = torch.empty(t * t, device="cuda")
        err = lib.chain(y.data_ptr(), q.data_ptr(), ri.data_ptr(),
                        ci.data_ptr(), chain.data_ptr(), t * t, d,
                        torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"chain kernel: cudaError {err}")
        chain = chain.view(t, t)
        scale = base.abs().max().item()
        out[f"d{d}"] = {
            "a_position_equal": eq_pos, "a_positions": n_pos,
            "a_max_rel_diff": spread / scale,
            "b_chain_equal": int((chain.view(torch.int32)
                                  == base.view(torch.int32)).sum().item()),
            "b_pairs": t * t,
            "b_max_rel_diff": (chain - base).abs().max().item() / scale}
    return out


def main():
    modes = sys.argv[1:] or ["options", "times", "slab_bits"]
    card = _smi()
    for mode in modes:
        res = {"options": options, "times": times,
               "slab_bits": slab_bits}[mode]()
        print(json.dumps({"mode": mode, "card": card, **res}), flush=True)


if __name__ == "__main__":
    main()
