#!/usr/bin/env python3
"""Device times of the full-CE backward kernels on the card (CUDA events,
each call after a 1 GiB L2 flush). Needs an NVIDIA GPU.

    python3 probes/linear_ce_times.py train TREE LABEL

imports ``repro_torch`` (and ``chip_smoke.py``) from ``TREE`` — a checkout
of any commit, for example the parent unpacked with ``git archive`` —
builds its kernels and prints ``LABEL {...}`` with, at the trainer's
shape (x 25,600 × 64 at unit scale, w 173,520 × 64 at 0.125, no cap):

- ``ms``: the mean of 5 calls of each backward kernel — ``linear_ce_dx``
  and ``linear_ce_dw`` (the target plucked) and ``fused_lse_dx`` /
  ``fused_lse_dy``; in a tree whose backward splits its inputs into TF32
  planes (``linear_ce_split``), the kernels take the planes, the split is
  timed alone, and ``backward`` is split + dX + dW as autograd runs them
  (in the parent, dX + dW);
- ``max_abs_err``: each kernel's largest difference from its plain f32
  version (``linear_ce_dx_ref`` / ``linear_ce_dw_ref``) and the
  tolerance ``1e-5·max|want|`` beside it;
- ``steps``: ``chip_smoke.loss_run`` — the trainer's ``ce_fused_linear``
  and ``ce_fused`` steps (phase 14), 20 each: median step (host clock)
  and the mean phase breakdown from the steps' own CUDA events, and the
  peak device memory.

Every line carries ``nvidia-smi``'s card name and power limit. Run two
trees in turns (parent, change, change, parent) in one call to compare
them.
"""
import json
import sys

N, C, D = 25_600, 173_520, 64
REPS = 5
STEPS = 20


def train(tree, label):
    sys.path.insert(0, tree + "/src")
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from repro_torch import resolve_device
    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.kernels import _build, fused_ce, linear_sce, ref

    card = chip_smoke.smi()
    dev = resolve_device("cuda")
    _build.build_all()
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(N, D, generator=g, device=dev)
    w = torch.randn(C, D, generator=g, device=dev) * 0.125
    t = torch.randint(0, C, (N,), generator=g, device=dev, dtype=torch.int32)
    gr = torch.rand(N, generator=g, device=dev) + 0.5
    lse = ref.fused_lse_ref(x, w)
    split = getattr(linear_sce, "linear_ce_split", None)
    kw = {}
    calls = {}
    if split is not None:
        planes = split(x, w)
        kw = {"planes": planes}
        calls["split"] = lambda: split(x, w)
    calls.update({
        "linear_ce_dx": lambda: linear_sce.linear_ce_dx(x, w, t, lse, gr,
                                                        **kw),
        "linear_ce_dw": lambda: linear_sce.linear_ce_dw(x, w, t, lse, gr,
                                                        **kw),
        "fused_lse_dx": lambda: fused_ce.fused_lse_dx(x, w, lse, gr, **kw),
        "fused_lse_dy": lambda: fused_ce.fused_lse_dy(x, w, lse, gr, **kw),
    })

    def backward():
        pl = split(x, w) if split is not None else None
        more = {} if pl is None else {"planes": pl}
        linear_sce.linear_ce_dx(x, w, t, lse, gr, **more)
        linear_sce.linear_ce_dw(x, w, t, lse, gr, **more)

    calls["backward"] = backward
    out = {"card": card, "ms": {}, "max_abs_err": {}, "steps": {}}
    with torch.no_grad():
        for name, fn in calls.items():
            out["ms"][name] = chip_smoke.time_ms(fn, REPS, flush)
        plain = {
            "linear_ce_dx": (calls["linear_ce_dx"],
                             lambda: ref.linear_ce_dx_ref(x, w, t, lse, gr)),
            "linear_ce_dw": (calls["linear_ce_dw"],
                             lambda: ref.linear_ce_dw_ref(x, w, t, lse, gr)),
            "fused_lse_dx": (calls["fused_lse_dx"],
                             lambda: ref.linear_ce_dx_ref(x, w, None, lse,
                                                          gr)),
            "fused_lse_dy": (calls["fused_lse_dy"],
                             lambda: ref.linear_ce_dw_ref(x, w, None, lse,
                                                          gr)),
        }
        for name, (kern, want_fn) in plain.items():
            got, want = kern(), want_fn()
            out["max_abs_err"][name] = {
                "err": (got - want).abs().max().item(),
                "tol": 1e-5 * want.abs().max().item()}
            del got, want
    del flush
    torch.cuda.empty_cache()
    print(label, card, json.dumps({"ms": out["ms"],
                                   "max_abs_err": out["max_abs_err"]}),
          flush=True)

    cfg = make_config()
    batch = N // cfg.max_len
    for name in ("ce_fused_linear", "ce_fused"):
        r = chip_smoke.loss_run(dev, cfg, name, STEPS, batch)
        out["steps"][name] = {
            "median_step_ms": r["median_step_ms"],
            "breakdown": r["breakdown"],
            "peak_mib": r["peak_bytes"] / 2**20,
            "peak_above_live_mib": (r["peak_bytes"]
                                    - r["live_bytes_before"]) / 2**20,
            "loss_first_last": [r["losses"][0], r["losses"][-1]]}
        print(label, card, name, json.dumps(out["steps"][name]), flush=True)
    print(label, json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1:2] == ["train"] and len(sys.argv) == 4:
        train(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)
