#!/usr/bin/env python3
"""What the full-CE forward kernel's time is made of, on the card (CUDA
events, each call after a 1 GiB L2 flush). Needs an NVIDIA GPU.

    python3 probes/linear_ce_fwd_parts.py

times ``linear_ce_fwd`` and ``fused_lse_fwd`` at the trainer's shape (x
25,600 × 64, w 173,520 × 64, on one split's planes) as built from
``csrc/linear_ce.cu`` and from copies of it with one part changed, each
copy built into ``build/fwd_parts/<name>/`` and timed in a process of its
own, in turns (as built first and last):

- ``products_only``: the online softmax replaced by a plain sum of the
  logits, so what is left is the logit tiles' ``mma`` and their staging;
- ``no_later_stage``: tiles after the prologue's are never staged (the
  kernel computes on what the ring holds: wrong values, the products and
  the softmax at full cost, no copies in the loop);
- ``interleaved_a``: the A fragments' hi and lo side by side (lanes 32
  bytes apart, as ``ce_bwd_kernel`` keeps them) in place of
  lane-contiguous.

Prints one ``name {...}`` line a turn with the card's name and power
limit, and first, for the forward kernel as built, one ``ptxas`` line an
instantiation (PLUCK, CAP and the n8 tiles a streamed tile NT: registers
and spill bytes from the build's ``-Xptxas -v`` report) and one ``sass``
line (its HMMA, MUFU.EX2 and local-memory instructions in
``cuobjdump -sass``). The copies' values are not checked: this measures,
the CUDA tests check.
"""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = Path("src/repro_torch/kernels/csrc/linear_ce.cu")
N, C, D = 25_600, 173_520, 64
REPS = 5

SOFTMAX = """    if (valid >= kRows)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});"""
STAGE = """    if (t_lo + ahead < t_hi) stage(t_lo + ahead, ahead % a.stages);
    cp_async_commit();

    // The online softmax"""
VARIANTS = {
    "as_built": [],
    "products_only": [(SOFTMAX, """    for (int m = 0; m < kMT; ++m)
      for (int h = 0; h < 2; ++h)
        for (int n = 0; n < NT; ++n)
          for (int j = 0; j < 2; ++j) sx[m][h] += sc[m][n][2 * h + j];""")],
    "no_later_stage": [(STAGE, STAGE.split("\n", 1)[1])],
    "interleaved_a": [
        ("own[64 * u + lane] =", "own[64 * u + 2 * lane] ="),
        ("own[64 * u + 32 + lane] =", "own[64 * u + 2 * lane + 1] ="),
        ("256 * (warp * kMT * s8) +\n         4 * lane;",
         "256 * (warp * kMT * s8) +\n         8 * lane;"),
        ("lds128(al[m][k], f + 128);", "lds128(al[m][k], f + 4);"),
    ],
}
TURNS = ["as_built", "products_only", "no_later_stage", "interleaved_a",
         "as_built"]
SASS_COUNTS = {"HMMA": r"HMMA", "MUFU.EX2": r"MUFU\.EX2",
               "LDL/STL": r"\b(?:LDL|STL)\b"}


def make_tree(name):
    """A copy of the port's sources with ``name``'s edits, built into its
    own ``build/`` (the build directory follows the package)."""
    tree = ROOT / "build" / "fwd_parts" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src", tree / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tree)
    text = (tree / SRC).read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            sys.exit(f"{name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    (tree / SRC).write_text(text)
    return tree


def kernel_report(tree):
    """The forward kernel's instantiations as ``tree`` builds them:
    ptxas's registers and spills, and instruction counts of its SASS."""
    sys.path.insert(0, str(Path(tree) / "src"))
    from repro_torch.kernels import _build

    lib = _build.build_all()["linear_ce"]

    def args(mangled):
        m = re.search(r"ce_fwd_kernelILb(\d)ELb(\d)ELi(\d+)E", mangled)
        return m and f"PLUCK={m[1]} CAP={m[2]} NT={m[3]}"

    for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads.*?Used (\d+) registers",
            _build.build_log("linear_ce"), re.S):
        if args(m[1]):
            print("ptxas", args(m[1]), f"registers={m[4]} spill_stores={m[2]} "
                  f"spill_loads={m[3]}", flush=True)
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = args(part.split(None, 1)[0])
        if name:
            print("sass", name, " ".join(
                f"{k}={len(re.findall(v, part))}"
                for k, v in SASS_COUNTS.items()), flush=True)


def time_tree(tree, name):
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from repro_torch import resolve_device
    from repro_torch.kernels import _build, fused_ce, linear_sce

    dev = resolve_device("cuda")
    _build.build_all()
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(N, D, generator=g, device=dev)
    w = torch.randn(C, D, generator=g, device=dev) * 0.125
    t = torch.randint(0, C, (N,), generator=g, device=dev, dtype=torch.int32)
    planes = linear_sce.linear_ce_split(x, w)
    ms = {
        "linear_ce_fwd": chip_smoke.time_ms(
            lambda: linear_sce.linear_ce_fwd(x, w, t, planes=planes), REPS,
            flush),
        "fused_lse_fwd": chip_smoke.time_ms(
            lambda: fused_ce.fused_lse_fwd(x, w, planes=planes), REPS, flush),
    }
    print(name, json.dumps({"card": chip_smoke.smi(), "ms": ms}), flush=True)


def main():
    if sys.argv[1:2] == ["time"]:
        time_tree(sys.argv[2], sys.argv[3])
        return
    if sys.argv[1:2] == ["report"]:
        kernel_report(sys.argv[2])
        return
    trees = {name: make_tree(name) for name in VARIANTS}
    for what, name in [("report", "as_built")] + [("time", n) for n in TURNS]:
        proc = subprocess.run([sys.executable, __file__, what,
                               str(trees[name]), name])
        if proc.returncode:
            sys.exit(f"{what} {name}: exit {proc.returncode}")


if __name__ == "__main__":
    main()
