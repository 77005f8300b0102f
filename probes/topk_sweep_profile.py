#!/usr/bin/env python3
"""A clock profile of the catalog sweep of ``mips_topk`` (k ≤ 32) and
``eval_fused`` in any tree: the f32 FMA ``sweep_split`` of
``csrc/topk_tile.cuh`` before the tensor-core sweep, or that sweep
(``sweep``), whichever the tree's header holds. Needs an NVIDIA GPU and
``nvcc``.

    python3 probes/topk_sweep_profile.py TREE

copies ``TREE``'s kernel sources into ``build/probes/topk_profile/``,
inserts ``clock64()`` marks at the ends of the sweep's phases, builds
``mips_topk.cu`` and ``eval_fused.cu`` from the copy, hands the
instrumented libraries to ``TREE``'s wrappers and prints, for serving's
n_q 8 / 32 / 512 (C = 173,520, d = 64, k = 10) and ``eval_fused`` at
B = 256, one JSON line: the mean SM cycles a warp of the sweep kernel
spends in each phase, the plan, and each kernel's device time per call
from ``torch.profiler`` (the sweep and the merge kernel apart). The
f32 FMA sweep's phases: the prologue (staging the queries, zeroing the
lists), the next tile's copy issue, the wait for its copy, the barrier
before the products, the products, the hook (eval's counts and LSE),
the filter, the barrier after it, the merges, the epilogue (the lists'
write). The tensor-core sweep's: the prologue, the wait for the tile's
copy, the barrier after it, the next tile's copy issue and the τ loads,
the merges a filled buffer asks for (with their barrier), the products,
the hook, the filter, the final merges (with their barriers), the
epilogue; and per call the merge requests, the rows merged, their
buffered candidates and those kept after the compaction against τ.

The marks cost a few cycles each; the phase shares, not the total, are
the reading. With ``nvidia-smi``'s card name and power limit.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "probes" / "topk_profile"
PHASES = ("prologue", "issue", "wait", "barrier_1", "products", "hook",
          "filter", "barrier_2", "merges", "epilogue")
TC_PHASES = ("prologue", "wait", "barrier", "issue_and_tau", "merges",
             "products", "hook", "filter", "final_merges", "epilogue")
TC_COUNTS = ("merge_requests", "rows_merged", "buffered", "kept")

PROF = r"""
__device__ unsigned long long g_prof[16];
extern "C" int topk_prof_read(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  if (e == cudaSuccess && reset) {
    unsigned long long z[16] = {};
    e = cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)e;
}
#define PROF_MARK(i)                          \
  {                                           \
    asm volatile("" ::: "memory");            \
    const long long _n = clock64();           \
    _ph[i] += _n - _t;                        \
    _t = _n;                                  \
  }
"""

# (anchor, text inserted before it, text inserted after it)
EDITS = (
    ("namespace topk_tile {\n", "", PROF),
    ("OnTile&& on_tile) {\n", "",
     "  long long _t = clock64();\n  long long _ph[10] = {};\n"),
    ("  // Tile t covers columns [c0, c0 + nc)", "  PROF_MARK(0);\n", ""),
    ("    __syncthreads();  // tile t and the last merge are visible to all\n",
     "", "    PROF_MARK(3);\n"),
    ("    const long c0 = col_begin + (long)t * kTileC;\n"
     "    const int* flags = vs + b * kTileC;\n", "    PROF_MARK(4);\n", ""),
    ("    on_tile(acc, flags, c0);\n", "", "    PROF_MARK(5);\n"),
    ("    __syncthreads();  // candidates complete; tile b is no longer read\n",
     "    PROF_MARK(6);\n", "    PROF_MARK(7);\n"),
)


def instrument(src: str) -> str:
    for anchor, before, after in EDITS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, before + anchor + after)
    # the copy issue and its wait, both branches
    src = src.replace(
        "      cp_async_commit();\n      cp_async_wait<1>();\n",
        "      cp_async_commit();\n      PROF_MARK(1);\n"
        "      cp_async_wait<1>();\n      PROF_MARK(2);\n")
    old = "    } else {\n      cp_async_wait<0>();\n    }\n    __syncthreads();  // tile t"
    assert src.count(old) == 1
    src = src.replace(old, "    } else {\n      PROF_MARK(1);\n"
                      "      cp_async_wait<0>();\n      PROF_MARK(2);\n"
                      "    }\n    __syncthreads();  // tile t")
    old = "    }\n  }\n  __syncthreads();\n\n  const int n_split = gridDim.y;"
    src = src.replace(old, "    }\n    PROF_MARK(8);\n  }\n  __syncthreads();"
                      "\n\n  const int n_split = gridDim.y;")
    end = ("      a.part_ids[o] = li[e];\n    }\n  }\n")
    assert src.count(end) == 1
    src = src.replace(end, end + (
        "  PROF_MARK(9);\n"
        "  if ((threadIdx.x & 31) == 0) {\n"
        "    for (int i = 0; i < 10; ++i)\n"
        "      atomicAdd(&g_prof[i], (unsigned long long)_ph[i]);\n"
        "    atomicAdd(&g_prof[15], 1ull);\n  }\n"))
    return src


TC_EDITS = (
    ("namespace topk_tile {\n", "", PROF),
    ("  constexpr int THREADS = C::kThreads;\n", "",
     "  long long _t = clock64();\n  long long _ph[10] = {};\n"),
    ("  if (n_tiles > 0) {\n    const int f = issue(0);", "  PROF_MARK(0);\n",
     ""),
    ("    cp_async_wait<0>();\n    // Tile i has landed", "",
     ""),
    ("    if (!SAMPLE && mreq[(i + 2) % 3]) {  // tile i − 1 filled a buffer\n",
     "    PROF_MARK(3);\n",
     "      if (threadIdx.x == 0) atomicAdd(&g_prof[10], 1ull);\n"),
    ("    if (tid == 0) mreq[(i + 1) % 3] = 0;", "    PROF_MARK(4);\n", ""),
    ("    const long c0 = tile_c0(i);\n    const int* fl =",
     "    PROF_MARK(5);\n", ""),
    ("    on_tile(acc, fl, c0);\n", "", "    PROF_MARK(6);\n"),
    ("    }  // SAMPLE\n", "", "    PROF_MARK(7);\n"),
    ("  merge_rows<SLOTS, QB, C::kWarps>(lv, li, cv, ci, cnt, k, a.tau, row0, "
     "true);\n  __syncthreads();\n", "", "  PROF_MARK(8);\n"),
    ("  return ring;\n}", "  PROF_MARK(9);\n"
     "  if ((threadIdx.x & 31) == 0) {\n"
     "    for (int i = 0; i < 10; ++i)\n"
     "      atomicAdd(&g_prof[i], (unsigned long long)_ph[i]);\n"
     "    atomicAdd(&g_prof[15], 1ull);\n  }\n", ""),
    ("    if (lane == 0) {\n      cnt[r] = 0;\n", "",
     "      atomicAdd(&g_prof[11], 1ull);\n"
     "      atomicAdd(&g_prof[12], (unsigned long long)n);\n"
     "      atomicAdd(&g_prof[13], (unsigned long long)m);\n"),
)


def instrument_tc(src: str) -> str:
    for anchor, before, after in TC_EDITS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, before + anchor + after)
    old = "    cp_async_wait<0>();\n    // Tile i has landed"
    src = src.replace(old, "    cp_async_wait<0>();\n    PROF_MARK(1);\n"
                      "    // Tile i has landed")
    old = ("    const int all_valid = __syncthreads_and(tid >= kTile || "
           "f_mine);\n")
    assert src.count(old) == 1
    return src.replace(old, old + "    PROF_MARK(2);\n")


def main(tree):
    tree = Path(tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import eval_fused as ef
    from repro_torch.kernels import mips_topk as mk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    csrc = OUT / "csrc"
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(tree / "src" / "repro_torch" / "kernels" / "csrc", csrc)
    hdr = csrc / "topk_tile.cuh"
    tc = "score_step" in hdr.read_text()
    hdr.write_text((instrument_tc if tc else instrument)(hdr.read_text()))
    procs = {}
    for name in ("mips_topk", "eval_fused"):
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            sys.exit(f"nvcc {name} failed:\n{out}")
    libs = {}
    for name in procs:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.topk_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _build._loaded[name] = libs[name] = lib

    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn(173_520, 64, generator=g, device=dev) * 0.02
    ar = torch.arange(173_520, device=dev)
    window = (ar >= 1) & (ar < 173_511)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    x = torch.randn(256, 64, generator=g, device=dev)
    t = torch.randint(1, 173_511, (256,), generator=g, device=dev,
                      dtype=torch.int32)
    ts = ef.eval_tgt_gather(x, y, t)
    cases = {}
    for n_q in (8, 32, 512):
        q = torch.randn(n_q, 64, generator=g, device=dev)
        cases[f"mips_{n_q}"] = ("mips_topk", n_q, lambda q=q: mk.mips_topk(
            q, y, 10, valid=window))
    cases["eval_fused_256"] = ("eval_fused", 256, lambda: ef.eval_fused(
        x, y, t, 10, tgt_scores=ts, c_lo=1, c_hi=173_511))
    result = {"card": card}
    buf = (ctypes.c_ulonglong * 16)()
    for name, (lib, n_q, fn) in cases.items():
        fn()
        torch.cuda.synchronize()
        libs[lib].topk_prof_read(buf, 1)
        reps = 10
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        assert libs[lib].topk_prof_read(buf, 1) == 0
        warps = buf[15]
        kernels = {ev.key[:60]: ev.device_time_total / reps / 1e3
                   for ev in prof.key_averages()
                   if any(w in ev.key for w in ("partial", "sweep", "merge",
                                                "sample", "tau_select"))}
        plan = getattr(mk, "sweep_plan", mk.plan)
        result[name] = {
            "plan": str(plan(n_q, 173_520, 64, 10, n_sm)),
            "warps": warps // reps,
            "cycles_per_warp": {p: buf[i] / warps for i, p in
                                enumerate(TC_PHASES if tc else PHASES)},
            "kernel_ms": kernels,
        }
        if tc:
            result[name]["per_call"] = {c: buf[10 + i] / reps
                                        for i, c in enumerate(TC_COUNTS)}
    print(json.dumps(result))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
