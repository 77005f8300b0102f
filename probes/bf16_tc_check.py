#!/usr/bin/env python3
"""The bf16 product of ``csrc/deep_tc.cuh`` (``gemm_bf16``: ``wgmma``
m64n128k16 .f32.bf16.bf16) on the card: its bits against the one-TF32
pass, every operand option against f64, and its time beside PyTorch's
bf16 product. Needs an NVIDIA GPU.

    python3 probes/bf16_tc_check.py [bits] [options] [times]

builds the ``linear_ce`` library of this tree (its ``deep_tc_launch``
entry, wrapped by ``linear_sce.deep_tc_product``) and prints one JSON line
per mode:

* ``bits``: does one k16 ``wgmma`` on bf16 give the bits of the score
  slab's route (``one_pass``: two TF32 k8 ``wgmma`` summed from zero,
  then added to the f32 accumulator)? 256 × 256 products at K 16 (one
  step each) and K 2304 (the depth summed in the tensor cores against 144
  f32 adds), inputs ``randn`` rounded to bf16: the share of equal
  outputs and the largest difference relative to the output's scale.
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

Every line carries ``nvidia-smi``'s card name and power limit.
"""
import json
import os
import subprocess
import sys

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


def bits():
    import torch

    from repro_torch.kernels import linear_sce

    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for k in (16, 2304):
        a = _bf(torch.randn(1, 256, k, generator=g, device="cuda"))
        b = _bf(torch.randn(1, 256, k, generator=g, device="cuda"))
        native = linear_sce.deep_tc_product(a, b)
        one = linear_sce.deep_tc_product(a, b, one_pass=True)
        diff = (native - one).abs()
        out[f"k{k}"] = {
            "equal_share": (native == one).double().mean().item(),
            "max_rel_diff": (diff.max() / one.abs().max()).item()}
    return out


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


def main():
    modes = sys.argv[1:] or ["bits", "options", "times"]
    card = _smi()
    for mode in modes:
        res = {"bits": bits, "options": options, "times": times}[mode]()
        print(json.dumps({"mode": mode, "card": card, **res}), flush=True)


if __name__ == "__main__":
    main()
