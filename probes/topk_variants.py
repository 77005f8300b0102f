#!/usr/bin/env python3
"""Variants of the tensor-core catalog sweep (``csrc/topk_tile.cuh``)
timed in one process on one card. Needs an NVIDIA GPU and ``nvcc``.

    python3 probes/topk_variants.py NAME [NAME ...]

For each named variant it copies this tree's ``src/`` to
``build/probes/variants/NAME/``, applies the variant's text edits to the
copy's ``topk_tile.cuh`` (``base`` applies none), builds ``mips_topk.cu``
and ``eval_fused.cu`` there, checks the variant's serving answers
against ``base``'s bit for bit — or, for a variant that changes the
arithmetic, against the plain version within ``1e-5·max|score|`` — and
then times, in two interleaved rounds of 50 calls each after a 1 GiB L2
flush, ``mips_topk`` at n_q 8 / 32 / 512 (C = 173,520, d = 64, k = 10,
window [1, 173,511)) and ``eval_fused`` at B = 256 (with its
``eval_tgt_gather``). Prints one JSON line with the card, each variant's
times and its edits' descriptions. Plan variants run ``base``'s build
with another plan: ``splitsX`` (X a number) scales the plan's split
count by X; ``nopre`` seeds the shared threshold with no pre-pass (τ by
``atomicMax`` alone); ``preR`` (R a number) samples one tile in R in the
pre-pass.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "probes" / "variants"

# name → (description, [(old, new), ...], same arithmetic as base)
VARIANTS = {
    "base": ("the tree as it is", [], True),
    "chains2": (
        "score_step's small and large terms in two accumulators, added",
        [("""  float t[4];
  tf32x3::mma3x2(t, ah, al, bh, bl);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];""",
          """  float t[4] = {0.f, 0.f, 0.f, 0.f}, w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    tf32x3::mma(t, al[k], bh[k]);
    tf32x3::mma(w, ah[k], bh[k]);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) tf32x3::mma(t, ah[k], bl[k]);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i] + w[i];""")], False),
    "tauevery": (
        "the rows' τ read every tile when a pre-pass seeded it too",
        [("    if (!SAMPLE && (!a.seeded || (i & 7) == 0)) {",
          "    if (!SAMPLE) {")], True),
    "mergeat32": (
        "a merge phase merges only the rows past kMergeAt",
        [("    if (n == 0 || (!all && n <= kMergeEager)) continue;",
          "    if (n == 0 || (!all && n <= kMergeAt)) continue;")], True),
}


def build(name, edits):
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "src", root / "src")
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    hdr = csrc / "topk_tile.cuh"
    text = hdr.read_text()
    for old, new in edits:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    hdr.write_text(text)
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build

    procs = {n: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(root / f"{n}.so"),
         str(csrc / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for n in ("mips_topk", "eval_fused")}
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            sys.exit(f"nvcc {name}/{n} failed:\n{out}")
    return {n: root / f"{n}.so" for n in procs}


def main(names):
    sys.path.insert(0, str(REPO / "src"))
    import dataclasses

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import eval_fused as ef
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels.ref import mips_topk_ref

    sys.path.insert(0, str(REPO / "probes"))
    from mips_topk_times import time_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    libs, built = {}, {}
    def source(name):  # the build a name runs
        return name if name in VARIANTS else "base"

    for name in names:
        base = source(name)
        if base not in built:
            built[base] = build(base, VARIANTS[base][1])
        libs[name] = built[base]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn(173_520, 64, generator=g, device=dev) * 0.02
    ar = torch.arange(173_520, device=dev)
    window = (ar >= 1) & (ar < 173_511)
    qs = {n: torch.randn(n, 64, generator=g, device=dev) for n in (8, 32, 512)}
    x = torch.randn(256, 64, generator=g, device=dev)
    t = torch.randint(1, 173_511, (256,), generator=g, device=dev,
                      dtype=torch.int32)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    own_plan = mk.sweep_plan

    def use(name):
        mk._lib.cache_clear()
        ef._lib.cache_clear()
        for n, path in libs[name].items():
            _build._loaded[n] = ctypes.CDLL(str(path))
        def plan(*a):
            p = own_plan(*a)
            if name in VARIANTS:
                return p
            if name.startswith("splits"):
                return dataclasses.replace(
                    p, n_split=max(1, round(p.n_split * float(name[6:]))))
            if name == "nopre":
                return dataclasses.replace(p, pre_split=0, pre_period=0)
            if name.startswith("pre") and p.pre_split:
                return dataclasses.replace(
                    p, pre_period=p.pre_split * int(name[3:]))
            return p

        mk.sweep_plan = plan

    def cases():
        out = {n: (lambda q=q: mk.mips_topk(q, y, 10, valid=window))
               for n, q in qs.items()}
        out["eval_fused_b256"] = lambda: ef.eval_fused(
            x, y, t, 10, tgt_scores=ef.eval_tgt_gather(x, y, t), c_lo=1,
            c_hi=173_511)
        return out

    want = {}
    try:
        for name in names:
            use(name)
            got = {n: [a.clone() for a in fn() if a is not None]
                   for n, fn in cases().items()}
            exact = VARIANTS[source(name)][2]
            if not want:
                want = got
            for n, outs in got.items():
                if exact:
                    assert all(torch.equal(a, b) for a, b in
                               zip(outs, want[n])), (name, n)
                elif isinstance(n, int):
                    ref = mips_topk_ref(qs[n], y, 10, valid=window)
                    tol = 1e-5 * (qs[n] @ y.T).abs().max().item()
                    assert (outs[0] - ref[0]).abs().max().item() <= tol
        times = {name: {} for name in names}
        for _ in range(2):
            for name in names:
                use(name)
                for n, fn in cases().items():
                    times[name].setdefault(str(n), []).append(
                        time_ms(fn, 50, flush))
    finally:
        mk.sweep_plan = own_plan
    print(json.dumps({"card": card, "times": times,
                      "variants": {n: VARIANTS[source(n)][0] if n in VARIANTS
                                   else f"base, plan {n}" for n in names}}))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
