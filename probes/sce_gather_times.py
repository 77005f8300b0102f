#!/usr/bin/env python3
"""Device times of the in-bucket SCE kernels on the card (CUDA events,
each call after a 1 GiB L2 flush). Needs an NVIDIA GPU.

    python3 probes/sce_gather_times.py TREE LABEL

imports ``repro_torch`` (and ``chip_smoke.py``) from ``TREE`` — a checkout
of any commit, for example the parent unpacked with ``git archive`` —
builds its kernels and prints ``LABEL {...}`` with, at the paper's
training shape (n_b = b_x = 320, b_y = 256, d = 64, C = 173,520; x_b at
unit scale, the catalog at 0.125, no cap; distinct candidates per bucket,
slot 0 colliding with the target of position 0, the last slot invalid):

- ``ms``: the mean of 20 calls of each of the ten kernels —
  ``sce_gather_fwd`` / ``_dx`` / ``_dy`` (the loss), ``sce_gather_plse_fwd``
  / ``_dx`` / ``_dy`` (the partial LSE, every candidate owned, as on the
  trainer's (1, 1) mesh) and ``sce_bucket_fwd`` / ``_dx`` / ``_dy`` /
  ``_plse_fwd`` on the pre-gathered ``y_b = y[idx]``; dX and dY take the
  lse (plse) of their tree's forward kernel. ``sce_gather_dy`` is the
  whole wrapper; in a tree whose gathered dY writes a workspace and sums
  it in slot order (``sce_prefetch.sce_gather_dy_sum``), also its parts:
  ``sce_gather_dy_kernel`` (the rows into the workspace),
  ``sce_gather_dy_sort`` (the slots' keys and their stable sort,
  PyTorch),
  ``sce_gather_dy_zero`` (zeroing the (C, d) gradient) and
  ``sce_gather_dy_sum`` (the in-order sum);
- ``max_abs_err``: each kernel's largest difference from autograd through
  its plain f32 version (``ref.sce_gather_loss_ref``,
  ``sce_gather_plse_ref``, ``sce_bucket_loss_ref``; the forwards' loss or
  plse), the tolerance ``1e-5·max|want|`` beside it and ``share``, the
  largest ``|got − want| / (1e-5·max|want| + rtol·|want|)`` with the
  tests' rtol (0 for a forward, 2e-4 for a gradient): at most 1 passes;
- ``e2e_dx_err``: at the trainer's logit scale (x_b 3·randn, 16 buckets
  of the training shape over 20,000 catalog rows), the largest
  difference of dX through ``ops.sce_gather_loss`` from autograd through
  the plain version in f64, beside the f32 plain version's;
- ``steps``: ``chip_smoke.train_phase`` — the trainer at full width in
  ``gspmd`` (``sce_gather``) and ``exact`` (``sce_gather_plse``), 30 steps
  each: median step (host clock), the mean phase breakdown from the
  steps' own CUDA events (the backward among them), the peak device
  memory above what was live before the run, and the first and last
  losses.

Every line carries ``nvidia-smi``'s card name and power limit. Run two
trees in turns (parent, change, change, parent) in one call to compare
them.
"""
import json
import sys

N_B, B_X, B_Y, C, D = 320, 320, 256, 173_520, 64
REPS = 20


def share(got, want, rtol):
    """The largest share of the tolerance a difference uses."""
    tol = 1e-5 * want.abs().max() + rtol * want.abs()
    return ((got - want).abs() / tol).max().item()


def times(tree, label):
    sys.path.insert(0, tree + "/src")
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from repro_torch import resolve_device
    from repro_torch.kernels import _build, guard, ref, sce_bucket
    from repro_torch.kernels import sce_prefetch

    card = chip_smoke.smi()
    dev = resolve_device("cuda")
    _build.build_all()
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    x_b = torch.randn(N_B, B_X, D, generator=g, device=dev)
    y = torch.randn(C, D, generator=g, device=dev) * 0.125
    idx = torch.stack([torch.randperm(C, generator=g, device=dev)[:B_Y]
                       for _ in range(N_B)]).to(torch.int32)
    tgt = torch.randint(0, C, (N_B, B_X), generator=g, device=dev,
                        dtype=torch.int32)
    cand = idx.clone()
    cand[:, 0] = tgt[:, 0]
    cand[:, -1] = -1
    pos = torch.einsum("nxd,nxd->nx", x_b, y[tgt.long()]).contiguous()
    up = torch.rand(N_B, B_X, generator=g, device=dev)
    y_b = y[idx.long()].contiguous()
    gather = (x_b, y, idx, tgt, cand)
    plse_in = (x_b, y, idx, tgt, idx)
    bucket = (x_b, y_b, tgt, cand)
    _, lse = sce_prefetch.sce_gather_fwd(*gather, pos)
    plse = sce_prefetch.sce_gather_plse_fwd(*plse_in)
    _, blse = sce_bucket.sce_bucket_fwd(*bucket, pos)
    calls = {
        "sce_gather_fwd": lambda: sce_prefetch.sce_gather_fwd(*gather, pos),
        "sce_gather_dx": lambda: sce_prefetch.sce_gather_dx(*gather, lse, up),
        "sce_gather_dy": lambda: sce_prefetch.sce_gather_dy(*gather, lse, up),
        "sce_gather_plse_fwd": lambda: sce_prefetch.sce_gather_plse_fwd(
            *plse_in),
        "sce_gather_plse_dx": lambda: sce_prefetch.sce_gather_plse_dx(
            *plse_in, plse, up),
        "sce_gather_plse_dy": lambda: sce_prefetch.sce_gather_plse_dy(
            *plse_in, plse, up),
        "sce_bucket_fwd": lambda: sce_bucket.sce_bucket_fwd(*bucket, pos),
        "sce_bucket_dx": lambda: sce_bucket.sce_bucket_dx(*bucket, blse, up),
        "sce_bucket_dy": lambda: sce_bucket.sce_bucket_dy(*bucket, blse, up),
        "sce_bucket_plse_fwd": lambda: sce_bucket.sce_bucket_plse_fwd(
            *bucket),
    }
    if hasattr(sce_prefetch, "sce_gather_dy_sum"):
        ws = torch.empty(N_B * B_Y, D, device=dev)
        dyz = torch.zeros_like(y)
        keys, order = sce_prefetch.dy_sum_keys(idx, cand, C)
        calls.update({
            "sce_gather_dy_kernel": lambda: sce_prefetch._launch(
                "sce_gather_dy_launch", (*gather, lse, up, ws, 0.0),
                (N_B, B_X, B_Y, C, D), dev),
            "sce_gather_dy_sort": lambda: sce_prefetch.dy_sum_keys(idx, cand,
                                                                   C),
            "sce_gather_dy_zero": dyz.zero_,
            "sce_gather_dy_sum": lambda: sce_prefetch.sce_gather_dy_sum(
                ws, keys, order, dyz),
        })
    out = {"card": card, "ms": {}, "max_abs_err": {}, "steps": {}}
    with torch.no_grad():
        for name, fn in calls.items():
            out["ms"][name] = chip_smoke.time_ms(fn, REPS, flush)
    del flush
    torch.cuda.empty_cache()

    # each family's plain version, its output and its two gradients
    plain = (("sce_gather", ref.sce_gather_loss_ref, gather, (pos,)),
             ("sce_gather_plse", ref.sce_gather_plse_ref, plse_in, ()),
             ("sce_bucket", ref.sce_bucket_loss_ref, bucket, (pos,)))
    for fam, fn, args, rest in plain:
        leaves = [t.clone().requires_grad_(True) for t in args[:2]]
        want = fn(*leaves, *args[2:], *rest)
        grads = torch.autograd.grad((want * up).sum(), leaves)
        fwd = calls[f"{fam}_fwd"]()
        got = {"fwd": fwd if fam == "sce_gather_plse" else fwd[0],
               "dx": calls[f"{fam}_dx"](), "dy": calls[f"{fam}_dy"]()}
        for what, w, rtol in (("fwd", want.detach(), 0.0),
                              ("dx", grads[0], 2e-4), ("dy", grads[1], 2e-4)):
            a = got[what]
            out["max_abs_err"][f"{fam}_{what}"] = {
                "err": (a - w).abs().max().item(),
                "tol": 1e-5 * w.abs().max().item(),
                "share": share(a, w, rtol)}
        del leaves, want, grads, got
    torch.cuda.empty_cache()
    print(label, card, json.dumps({"ms": out["ms"],
                                   "max_abs_err": out["max_abs_err"]}),
          flush=True)

    # End to end at the trainer's logit scale (x_b 3·randn, 16 buckets of
    # the training shape over 20,000 rows): dX of the loss through ops
    # against autograd through the plain version in f64, beside the f32
    # plain version's error on the same inputs.
    from repro_torch.kernels import ops
    ge = torch.Generator(device=dev).manual_seed(41)
    n_e, c_e = 16, 20_000
    xe = 3.0 * torch.randn(n_e, B_X, D, generator=ge, device=dev)
    ye = torch.randn(c_e, D, generator=ge, device=dev)
    ie = torch.stack([torch.randperm(c_e, generator=ge, device=dev)[:B_Y]
                      for _ in range(n_e)]).to(torch.int32)
    te = torch.randint(0, c_e, (n_e, B_X), generator=ge, device=dev,
                       dtype=torch.int32)
    ce = ie.clone()
    ce[:, 0] = te[:, 0]
    ce[:, -1] = -1
    pe = (xe * ye[te.long()]).sum(-1)
    ue = torch.rand(n_e, B_X, generator=ge, device=dev)

    def dx_of(fn, dtype):
        xl = xe.to(dtype).requires_grad_(True)
        out_ = fn(xl, ye.to(dtype), ie, te, ce, pe.to(dtype))
        return torch.autograd.grad((out_ * ue.to(dtype)).sum(), xl)[0]

    exact = dx_of(ref.sce_gather_loss_ref, torch.float64)
    out["e2e_dx_err"] = {
        what: (dx_of(fn, torch.float32).double() - exact).abs().max().item()
        for what, fn in (("kernel", ops.sce_gather_loss),
                         ("f32_plain", ref.sce_gather_loss_ref))}
    del xe, ye, exact
    torch.cuda.empty_cache()
    print(label, card, json.dumps({"e2e_dx_err": out["e2e_dx_err"]}),
          flush=True)

    guard.run_conformance(device=dev)  # as chip_smoke's phase 3, first
    for mode in ("gspmd", "exact"):
        r = chip_smoke.train_phase(dev, mode)
        bd = r["breakdown"]
        mem = r["memory"]
        out["steps"][mode] = {
            "median_step_ms": r["median_step_ms"],
            "backward_ms": bd["backward_ms"],
            "breakdown": bd,
            "peak_mib": mem["peak_bytes"] / 2**20,
            "peak_above_live_mib": (mem["peak_bytes"]
                                    - mem["live_bytes_before"]) / 2**20,
            "loss_first_last": [r["losses"][0], r["losses"][-1]]}
        print(label, card, mode, json.dumps(out["steps"][mode]), flush=True)
    print(label, json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) == 3:
        times(sys.argv[1], sys.argv[2])
    else:
        sys.exit(__doc__)
