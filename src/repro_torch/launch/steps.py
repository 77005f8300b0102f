"""Step factories (port of the single-device serving step of
``repro/launch/steps.py``)."""
from __future__ import annotations

import torch

from repro_torch.eval.streaming import streaming_topk
from repro_torch.models import sasrec as sasrec_lib


def make_seqrec_mips_serve_step(cfg, *, top_k: int = 10):
    """MIPS-backed retrieval serving (the ``launch/serve.py`` step):
    encode the request batch, take each history's last hidden state, and
    stream the catalog through ``kernels.ops.mips_topk`` (via
    ``eval.streaming.streaming_topk``) — no ``(B, C)`` score matrix.

    Only global ids in ``[1, n_items)`` serve: the padding row 0 and the
    phantom rows of the shard-even catalog slice are masked. Ties go to
    the lower id. ``serve_step(params, tokens)`` → ``(vals (B, top_k)
    f32, ids (B, top_k) int32)`` on the tokens' device. Single device
    only: the mesh path is not ported.
    """

    @torch.inference_mode()
    def serve_step(params, tokens):
        hidden = sasrec_lib.forward(params, cfg, tokens)
        x_last = hidden[:, -1].contiguous()  # (B, d)
        y = sasrec_lib.loss_catalog(params, cfg)  # shard-even slice
        return streaming_topk(x_last, y, top_k, c_lo=1, c_hi=cfg.n_items)

    return serve_step
