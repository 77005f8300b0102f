#!/usr/bin/env python3
"""SHA-256 digests of the resident kernels' outputs (d ≤ 256, k ≤ 512)
in any tree, so two trees' outputs compare bit for bit. Needs an NVIDIA
GPU.

    python3 probes/shallow_digests.py TREE LABEL

imports ``repro_torch`` from ``TREE/src`` (a checkout of any commit, for
example the parent unpacked with ``git archive`` into ``.benchrun/``),
builds its kernels and prints ``LABEL {"name": sha256, ...}`` for, on
inputs drawn from fixed seeds on the card:

* ``mips_topk`` at serving's shapes (n_q 8 / 32 / 512, C = 173,520,
  d = 64, k = 10, window [1, 173,511)), SCE training's two selections
  (320 centres against 25,600 positions at k = 320 with ≈ 25 % masked,
  and against the catalog at k = 256) and k = 512 at d = 256;
* ``eval_fused`` (k 10, the LSE with cap 30) with ``eval_tgt_gather`` at
  B = 256, and the two-pass ``eval_topk`` / ``eval_tgt_scores``;
* ``sce_gather`` forward, dX and dY, ``sce_gather_plse`` forward, dX and
  dY and ``sce_bucket`` forward, dX and dY at the training shape
  (n_b = b_x = 320, b_y = 256, d = 64), cap 30;
* ``linear_ce`` forward, dX and dW at N 4,096, C 173,520, d 64;
* ``bf16``: in a tree that takes bfloat16 operands, the same resident
  calls (serving's ``mips_topk`` at n_q 512, ``eval_fused``, the three
  SCE families' forward, dX and dY, ``linear_ce``'s forward, dX and dW)
  on those inputs rounded to bf16 — dY's in-order sum into the bf16
  table included ("refused" where the tree takes f32 only).

Run the parent and the change in one call and compare the lines.
"""
import hashlib
import json
import sys


def _digest(*tensors):
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:  # its bits (numpy has no bf16)
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(tree, label):
    sys.path.insert(0, tree + "/src")
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import _build, eval_fused, eval_topk
    from repro_torch.kernels import linear_sce, sce_bucket, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk

    dev = resolve_device("cuda")
    _build.build_all()
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    c, d = 173_520, 64
    y = torch.randn(c, d, generator=g, device=dev) * 0.125
    window = torch.arange(c, device=dev)
    window = (window >= 1) & (window < 173_511)
    for n_q in (8, 32, 512):
        q = torch.randn(n_q, d, generator=g, device=dev)
        out[f"mips_topk_serve_{n_q}"] = _digest(*mips_topk(q, y, 10,
                                                          valid=window))
    b = torch.randn(320, d, generator=g, device=dev)
    x = torch.randn(25_600, d, generator=g, device=dev)
    valid = torch.rand(25_600, generator=g, device=dev) > 0.25
    out["mips_topk_positions_k320"] = _digest(*mips_topk(b, x, 320,
                                                         valid=valid))
    out["mips_topk_catalog_k256"] = _digest(*mips_topk(b, y, 256))
    q256 = torch.randn(40, 256, generator=g, device=dev)
    y256 = torch.randn(3_000, 256, generator=g, device=dev)
    out["mips_topk_k512_d256"] = _digest(*mips_topk(q256, y256, 512))

    xe = torch.randn(256, d, generator=g, device=dev)
    te = torch.randint(1, 173_511, (256,), generator=g, device=dev,
                       dtype=torch.int32)
    ev = eval_fused.eval_fused(xe, y, te, 10, c_lo=1, c_hi=173_511,
                               logit_softcap=30.0, with_lse=True)
    out["eval_fused"] = _digest(*ev)
    tgt = eval_topk.eval_tgt_scores(xe, y, te)
    out["eval_two_pass"] = _digest(
        tgt, *eval_topk.eval_topk(xe, y, tgt, 10, c_lo=1, c_hi=173_511))

    n_b, b_x, b_y = 320, 320, 256
    x_b = torch.randn(n_b, b_x, d, generator=g, device=dev)
    idx = torch.stack([torch.randperm(c, generator=g, device=dev)[:b_y]
                       for _ in range(n_b)]).to(torch.int32)
    tgt_b = torch.randint(0, c, (n_b, b_x), generator=g, device=dev,
                          dtype=torch.int32)
    cand = idx.clone()
    cand[:, 0] = tgt_b[:, 0]
    cand[:, -1] = -1
    pos = 30.0 * torch.tanh(torch.randn(n_b, b_x, generator=g, device=dev))
    gg = torch.rand(n_b, b_x, generator=g, device=dev)
    kw = dict(logit_softcap=30.0)
    loss, lse = sce_prefetch.sce_gather_fwd(x_b, y, idx, tgt_b, cand, pos,
                                            **kw)
    args = (x_b, y, idx, tgt_b, cand, lse, gg)
    out["sce_gather"] = _digest(loss, lse,
                                sce_prefetch.sce_gather_dx(*args, **kw),
                                sce_prefetch.sce_gather_dy(*args, **kw))
    plse = sce_prefetch.sce_gather_plse_fwd(x_b, y, idx, tgt_b, cand, **kw)
    args = (x_b, y, idx, tgt_b, cand, plse, gg)
    out["sce_gather_plse"] = _digest(
        plse, sce_prefetch.sce_gather_plse_dx(*args, **kw),
        sce_prefetch.sce_gather_plse_dy(*args, **kw))
    y_b = y[idx.long()]
    bl, blse = sce_bucket.sce_bucket_fwd(x_b, y_b, tgt_b, cand, pos, **kw)
    bargs = (x_b, y_b, tgt_b, cand, blse, gg)
    out["sce_bucket"] = _digest(bl, blse,
                                sce_bucket.sce_bucket_dx(*bargs, **kw),
                                sce_bucket.sce_bucket_dy(*bargs, **kw))

    xl = torch.randn(4_096, d, generator=g, device=dev)
    tl = torch.randint(0, c, (4_096,), generator=g, device=dev,
                       dtype=torch.int32)
    lleaves = [t.clone().requires_grad_(True) for t in (xl, y)]
    ll = linear_sce.linear_ce_loss(lleaves[0], lleaves[1], tl,
                                   logit_softcap=30.0)
    out["linear_ce"] = _digest(ll, *torch.autograd.grad(
        (ll * gg.reshape(-1)[:4_096]).sum(), lleaves))
    torch.cuda.synchronize()
    bf = torch.bfloat16
    try:
        mips_topk(q.to(bf), y.to(bf), 10, valid=window)
    except TypeError:
        out["bf16"] = "refused"
    else:
        yb, xb, pb = y.to(bf), x_b.to(bf), pos.to(bf)
        o = {"mips_topk_serve_512": _digest(*mips_topk(
            q.to(bf), yb, 10, valid=window))}
        o["eval_fused"] = _digest(*eval_fused.eval_fused(
            xe.to(bf), yb, te, 10, c_lo=1, c_hi=173_511, logit_softcap=30.0,
            with_lse=True))
        loss, lse = sce_prefetch.sce_gather_fwd(xb, yb, idx, tgt_b, cand,
                                                pb, **kw)
        args = (xb, yb, idx, tgt_b, cand, lse, gg)
        o["sce_gather"] = _digest(loss, lse,
                                  sce_prefetch.sce_gather_dx(*args, **kw),
                                  sce_prefetch.sce_gather_dy(*args, **kw))
        plse = sce_prefetch.sce_gather_plse_fwd(xb, yb, idx, tgt_b, cand,
                                                **kw)
        args = (xb, yb, idx, tgt_b, cand, plse, gg)
        o["sce_gather_plse"] = _digest(
            plse, sce_prefetch.sce_gather_plse_dx(*args, **kw),
            sce_prefetch.sce_gather_plse_dy(*args, **kw))
        y_bb = yb[idx.long()]
        bl, blse = sce_bucket.sce_bucket_fwd(xb, y_bb, tgt_b, cand, pb, **kw)
        bargs = (xb, y_bb, tgt_b, cand, blse, gg)
        o["sce_bucket"] = _digest(bl, blse,
                                  sce_bucket.sce_bucket_dx(*bargs, **kw),
                                  sce_bucket.sce_bucket_dy(*bargs, **kw))
        lleaves = [t.to(bf).requires_grad_(True) for t in (xl, y)]
        ll = linear_sce.linear_ce_loss(lleaves[0], lleaves[1], tl,
                                       logit_softcap=30.0)
        o["linear_ce"] = _digest(ll, *torch.autograd.grad(
            (ll.float() * gg.reshape(-1)[:4_096]).sum(), lleaves))
        out["bf16"] = o
    torch.cuda.synchronize()
    print(label, json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
