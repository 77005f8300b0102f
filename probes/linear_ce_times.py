#!/usr/bin/env python3
"""Device times of the full-CE kernels on the card (CUDA events, each call
after a 1 GiB L2 flush). Needs an NVIDIA GPU.

    python3 probes/linear_ce_times.py train TREE LABEL

imports ``repro_torch`` (and ``chip_smoke.py``) from ``TREE`` — a checkout
of any commit, for example the parent unpacked with ``git archive`` —
builds its kernels and prints ``LABEL {...}`` with, at the trainer's
shape (x 25,600 × 64 at unit scale, w 173,520 × 64 at 0.125, no cap):

- ``ms``: the mean of 5 calls of each kernel — the forward
  ``linear_ce_fwd`` / ``fused_lse_fwd`` and the backward ``linear_ce_dx``
  and ``linear_ce_dw`` (the target plucked) and ``fused_lse_dx`` /
  ``fused_lse_dy``; in a tree that splits its inputs into TF32 planes
  (``linear_ce_split``), the kernels that take the planes get them, the
  split is timed alone, and ``backward`` is split + dX + dW (in a tree
  without the split, dX + dW); ``loss_kernels`` is every kernel of one
  ``ce_fused_linear`` step's loss in the order a step runs them (a tree
  whose forward takes the planes splits first);
- ``max_abs_err``: each kernel's largest difference from its plain f32
  version (``linear_ce_loss_ref`` and ``fused_lse_ref`` — the lse of
  ``linear_ce_fwd`` too — ``linear_ce_dx_ref``, ``linear_ce_dw_ref``)
  and the tolerance ``1e-5·max|want|`` beside it;
- ``steps``: ``chip_smoke.loss_run`` — the trainer's ``ce_fused_linear``
  and ``ce_fused`` steps (phase 14), 20 each: median step (host clock),
  the mean phase breakdown from the steps' own CUDA events (the loss
  forward among them), the peak device memory and the first and last
  losses.

Every line carries ``nvidia-smi``'s card name and power limit. Run two
trees in turns (parent, change, change, parent) in one call to compare
them.

    python3 probes/linear_ce_times.py peak TREE LABEL

runs the same two trainers (``chip_smoke.loss_run``, 20 steps each) in a
tree whose autograd forward keeps the planes for the backward, as built
(``hold``) and with the autograd Functions patched to drop them after the
forward and split again in the backward (``resplit``), in turns hold,
resplit, resplit, hold; one ``LABEL way loss {...}`` line a run with the
median step, the loss forward and backward phases and the peak device
memory.
"""
import inspect
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
    # a forward that takes the planes gets them
    fkw = (kw if "planes" in inspect.signature(
        linear_sce.linear_ce_fwd).parameters else {})
    calls.update({
        "linear_ce_fwd": lambda: linear_sce.linear_ce_fwd(x, w, t, **fkw),
        "fused_lse_fwd": lambda: fused_ce.fused_lse_fwd(x, w, **fkw),
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

    def loss_kernels():
        pl = split(x, w) if fkw else None
        more = {"planes": pl} if fkw else {}
        _, lse_ = linear_sce.linear_ce_fwd(x, w, t, **more)
        if not fkw and split is not None:
            pl = split(x, w)
            more = {"planes": pl}
        linear_sce.linear_ce_dx(x, w, t, lse_, gr, **more)
        linear_sce.linear_ce_dw(x, w, t, lse_, gr, **more)

    calls["backward"] = backward
    calls["loss_kernels"] = loss_kernels
    out = {"card": card, "ms": {}, "max_abs_err": {}, "steps": {}}
    with torch.no_grad():
        for name, fn in calls.items():
            out["ms"][name] = chip_smoke.time_ms(fn, REPS, flush)
        plain = {
            "linear_ce_fwd": (lambda: calls["linear_ce_fwd"]()[0],
                              lambda: ref.linear_ce_loss_ref(x, w, t)),
            "linear_ce_fwd_lse": (lambda: calls["linear_ce_fwd"]()[1],
                                  lambda: lse),
            "fused_lse_fwd": (calls["fused_lse_fwd"], lambda: lse),
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


def resplit(linear_sce, fused_ce):
    """Patches ``LinearCELoss`` and ``FusedLSE`` to keep no planes from
    the forward: the backward splits ``x`` and ``w`` again. Returns a
    function that undoes it."""
    saved = [(f, f.forward, f.backward)
             for f in (linear_sce.LinearCELoss, fused_ce.FusedLSE)]

    def lin_forward(ctx, x, w, targets, cap):
        loss, lse = linear_sce.linear_ce_fwd(x, w, targets, logit_softcap=cap)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.logit_softcap = cap
        return loss

    def lin_backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        planes = linear_sce.linear_ce_split(x, w)
        kw = dict(logit_softcap=ctx.logit_softcap, planes=planes)
        g = g.contiguous()
        return (linear_sce.linear_ce_dx(x, w, targets, lse, g, **kw),
                linear_sce.linear_ce_dw(x, w, targets, lse, g, **kw),
                None, None)

    def fused_forward(ctx, x, y):
        lse = fused_ce.fused_lse_fwd(x, y)
        ctx.save_for_backward(x, y, lse)
        return lse

    def fused_backward(ctx, g):
        x, y, lse = ctx.saved_tensors
        planes = linear_sce.linear_ce_split(x, y)
        g = g.contiguous()
        return (fused_ce.fused_lse_dx(x, y, lse, g, planes=planes),
                fused_ce.fused_lse_dy(x, y, lse, g, planes=planes))

    linear_sce.LinearCELoss.forward = staticmethod(lin_forward)
    linear_sce.LinearCELoss.backward = staticmethod(lin_backward)
    fused_ce.FusedLSE.forward = staticmethod(fused_forward)
    fused_ce.FusedLSE.backward = staticmethod(fused_backward)

    def undo():
        for f, fwd, bwd in saved:
            f.forward, f.backward = staticmethod(fwd), staticmethod(bwd)
    return undo


def peak(tree, label):
    sys.path.insert(0, tree + "/src")
    sys.path.insert(0, tree)
    import chip_smoke
    from repro_torch import resolve_device
    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.kernels import _build, fused_ce, linear_sce

    card = chip_smoke.smi()
    dev = resolve_device("cuda")
    _build.build_all()
    cfg = make_config()
    batch = N // cfg.max_len
    for way in ("hold", "resplit", "resplit", "hold"):
        undo = resplit(linear_sce, fused_ce) if way == "resplit" else None
        for name in ("ce_fused_linear", "ce_fused"):
            before = linear_sce.linear_ce_split.launches
            r = chip_smoke.loss_run(dev, cfg, name, STEPS, batch)
            bd = r["breakdown"]
            print(label, card, way, name, json.dumps({
                "median_step_ms": r["median_step_ms"],
                "loss_forward_ms": bd["loss_forward_ms"],
                "backward_ms": bd["backward_ms"],
                "peak_mib": r["peak_bytes"] / 2**20,
                "peak_above_live_mib": (r["peak_bytes"]
                                        - r["live_bytes_before"]) / 2**20,
                "splits_a_step": (linear_sce.linear_ce_split.launches
                                  - before) / STEPS}), flush=True)
        if undo is not None:
            undo()


if __name__ == "__main__":
    if sys.argv[1:2] == ["train"] and len(sys.argv) == 4:
        train(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["peak"] and len(sys.argv) == 4:
        peak(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)
