#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``. Phases:

1. Device: needs ``torch.cuda.is_available()`` (else exits 2, printing no
   result); prints ``nvidia-smi``'s name and power limit.
2. Build: compiles every kernel of ``src/repro_torch/kernels/csrc/``
   (one ``nvcc`` per source, in parallel) into ``build/torch_kernels/``
   and prints the build seconds and the compiler's resource report.
3. The kernel guard: ``run_conformance(refresh=True)`` on the card, the
   12 canaries of the 7 kernel groups (each kernel against its plain
   version, the two bitwise checks kernel against kernel), with the
   verdict table and its wall time. Any failure fails the run. The
   canaries are the one path that runs the ``sce_bucket`` and two-pass
   eval kernels (PERF.md rows 6, 7, 10, 11): their launches are counted
   from 0 around this phase. The verdicts stay memoized, so the later
   phases' dispatches consult them without running canaries.
4. Serve kernel against its plain version on the card: ``mips_topk`` at
   the serve shapes (n_q ∈ {8, 32, 512}, C = 173,520, d = 64, k = 10,
   window [1, 173,511)) and adversarial cases (integer ties, C tail,
   k > C, a starved ``valid``, an ``id_offset``, k = 256, d % 4 != 0, a
   catalog off a 16-byte boundary). Values agree within
   ``1e-5·max|score|`` (f32 fold order differs between the kernel and
   cuBLAS); ids agree exactly wherever neighbouring scores are further
   apart than that, and bit for bit on integer-valued inputs, where every
   fold order is exact. Times the kernel, the plain version and
   ``torch.matmul`` + ``torch.topk`` with a cold L2 cache.
5. The server at full width: ``RetrievalServer("sasrec-sce",
   cfg=make_config(), buckets=(8, 32, 512), top_k=10, device="cuda")``
   serves waves of async requests and one bulk ``score()`` of 512
   histories; the ids are held against a dense on-card oracle, the
   kernel's launch count must have moved, and ``cache_misses`` must be 0.
6. Train kernels against their plain versions on the card: ``mips_topk``
   at SCE training's two selections (320 bucket centres against 25,600
   positions at k = 320 under a mask with ≈ 25 % masked, and against the
   173,520 catalog rows at k = 256), a starved mask and k = 512, and the
   ``k > 32`` chain's adversarial inputs at those shapes (integer valued,
   bit for bit): every row's best columns in one residue of the
   threshold pass's tiles, all-equal scores, and a collect buffer of k
   entries that sends every row to the split sweep — each with its
   per-row collect counts. Times the chain's steps (threshold, τ,
   collect, select, the finishing sweep) at both selections, each
   kernel's device time from ``torch.profiler`` with a cold L2. The
   three ``sce_gather`` kernels (forward, dX, dY) at the training shape
   (n_b = b_x = 320, b_y = 256, d = 64) on a real selection, with every
   bucket on the same candidates, with collisions and ``cand < 0``, and
   ragged (b_x = 23, b_y = 50, d = 33, softcap 30). Losses within
   ``1e-5·max|loss|``, gradients within ``rtol 2e-4``,
   ``atol 1e-5·max|grad|`` of autograd through the plain version, rows of
   dY no bucket selected exactly 0. Times each kernel, its plain version
   and one PyTorch call with a cold L2 cache: for the forward the whole
   function (the gather ``y[idx]``, ``baddbmm`` with the mask as its
   additive input, the positive, ``logsumexp``), for dX and dY
   ``torch.bmm`` on pre-gathered candidates (one product alone), and dX
   and dY composed in PyTorch on pre-gathered candidates (the logits
   ``bmm``, ``exp(l − lse)·g`` on the unmasked ones, the second ``bmm``;
   dY then ``index_add_`` into ``(C, d)``). dY's time is its kernel
   alone, into the ``(n_b·b_y, d)`` workspace, against the same rows in
   plain PyTorch; the wrapper (the kernel, the sort, the zeroing and the
   sum), which the composed dY matches, is timed apart and is not in the
   kernels line. All three take their logits
   in 3xTF32 on the tensor cores and are bound as ``linear_ce``'s kernels
   (phase 13): three TF32 passes, an exp per unmasked pair at the SFUs'
   rate, and the bytes, with the f32 FMA bound beside it. The wrapper's
   copies of the forward's and dX / dY's launch plans must equal the
   library's at every d ≤ 256. The gathered dY (each slot's row into a
   workspace, then ``sce_gather_dy_sum`` adds them per catalog row in
   slot order) must repeat bit for bit, on the trainer's selection and on
   candidates every bucket shares; its sum kernel is held to
   ``index_add_`` on the same workspace and timed beside an in-place
   ``index_add_`` (and the stable sort, PyTorch glue, timed apart).
   The three ``sce_gather_plse`` launches (the partial LSE of distributed
   SCE: forward, dX, dY) the same way, on the same selection as the
   trainer's (1, 1) mesh sees it (every candidate owned), on shard 0 of a
   4-way catalog split of it (43,380 rows, ≈ 75 % of ``cand = −1``), with
   buckets that own no candidate and collisions, with softcap 30, and
   ragged; rows with no unmasked candidate must be exactly −1e30 with
   exactly 0 in dX. Timed on the (1, 1) and the shard inputs against the
   plain version and ``torch.baddbmm`` (the mask as its additive input) +
   ``torch.logsumexp`` on pre-gathered rows.
7. The trainer at full width, ``sce_mode="gspmd"`` (``core/sce.py``):
   ``train("sasrec-sce", cfg=make_config(), batch=128, steps=30, seed=0,
   sce_mode="gspmd", eval_every=10, eval_users=128, device="cuda")``.
   Every loss finite, no step skipped, the mean loss of the last 5 steps
   below that of the first 5, ``mips_topk`` launched exactly 2 (once at
   k = 320, once at k = 256) and each ``sce_gather`` kernel exactly once
   per step, ``sce_gather_plse`` never; three ``[eval]`` lines, each eval
   kernel launched once per evaluation. Prints the median step (its
   evaluations excluded: the trainer takes a step's time before its
   evaluation), the step's breakdown from CUDA events that the trainer's
   own steps record through its ``mark`` hook, and the run's peak device
   memory. The same run once more: prints whether the two end on the
   same losses (measured, not required).
8. The same with the trainer's default ``sce_mode="exact"``: distributed
   SCE (``core/distributed_sce.py``) on the (1, 1) host mesh, each
   ``sce_gather_plse`` launch once per step and ``sce_gather`` never;
   the same checks and prints. It runs with ``guard_policy="strict"``
   after the ``mips_topk``, ``sce_gather`` and ``eval_fused`` verdicts
   are dropped: their canaries run at the first dispatch inside the
   trainer and must pass (their launches are taken out of the counts);
   every step's sentinels are zero, the loss cap is ``inf`` for 8 steps
   and finite from the 9th.
9. The same trainer with the guard ``off`` (no verdicts, no sentinels):
   the guard's cost per step, in the same call.
10. One full-width batch through the three SCE modes on one injected Ω:
   ``exact`` and ``union`` (on one card both select what ``gspmd``
   selects) against ``gspmd``, the loss within ``1e-5·|loss|``, the
   gradients of x and y within ``1e-5·max|g|`` plus ``2e-4·|g|``.
11. Eval kernels against their plain versions on the card: ``eval_fused``
   at B = 128 and 256 against the whole catalog (C = 173,520, k = 10,
   window [1, 173,511)), with the LSE on (cap none and 30), on
   integer-valued inputs, a ragged C with an ``id_offset``, and k above
   the valid columns; ``eval_tgt_gather`` with each. Integer inputs:
   ids, vals, ``gt``, ``eq`` and ``tgt`` equal bit for bit. Floats: vals
   within ``1e-5·max|score|``, ids equal where consecutive scores are
   more than ``1e-4·max|score|`` apart, ranks inside the band of a dense
   f64 oracle (other scores within ``1e-5·max|score|`` of the target
   may fall on either side), ``tgt`` within ``1e-5·max|score|``. The LSE
   ``m + log s`` within 1e-5 relative. Every input: a target in the
   kernel's top-k carries exactly ``tgt``, and ``eq ≥ 1`` on every row
   whose target is valid. Times each kernel, its plain version and one
   PyTorch computation of the same function with a cold L2 cache.
12. The evaluation at full width: ``evaluate_streaming`` over 8 held-out
   batches of 256 users (``eval_batch`` of ``Cursor(0, step)``, steps
   0–7) on random weights from seed 0, folded into one
   ``MetricAccumulator``; then the dense on-card oracle
   (``core/metrics.py``). Streamed and dense ranks inside the f64 band,
   HR/NDCG/COV@{1,5,10} side by side (HR and NDCG may differ by the
   share of rows whose rank the band leaves open), the eval kernels'
   launch counts, and the streaming evaluation's peak device memory
   against the dense ``B·C·4 B``.
13. Full-CE kernels against their plain versions on the card: the six
   launches of ``csrc/linear_ce.cu`` — ``linear_ce_fwd`` / ``_dx`` /
   ``_dw`` (the positive plucked in the sweep, softcap in the tile) and
   ``fused_lse_fwd`` / ``_dx`` / ``_dy`` (no pluck, no cap) — at the
   trainer's shape (x 25,600 × 64, w 173,520 × 64, whose last tile is
   ragged), with cap 30 past its knee, half the targets on one row and
   every third cotangent 0, and on integer-valued inputs (d = 33; d = 200
   with cap 30 and repeated targets). Values within ``1e-5·max|want|``,
   gradients within ``1e-5·max|grad|`` plus ``2e-4·|grad|`` of the plain
   versions (``linear_ce_loss_ref``, ``fused_lse_ref``,
   ``linear_ce_dx_ref``, ``linear_ce_dw_ref``), dX exactly 0 on rows with
   a zero cotangent. All six kernels (3xTF32 on the tensor cores) take
   the planes of ``linear_ce_split``, which must equal the plain split
   (``ref.tf32x3_planes_ref``) bit for bit on every input. Times each
   kernel, the split, their plain versions and one PyTorch call
   (``logsumexp(x @ wᵀ)``, ``softmax(x @ wᵀ) @ w``,
   ``softmax(x @ wᵀ)ᵀ @ x``, all f32; none for the split) with a cold L2
   cache. A kernel's bound is the largest of three TF32 passes at 495
   TFLOP/s, the N·C exps at the SFUs' rate (16 a clock per SM at
   ``nvidia-smi``'s top SM clock) and the bytes, its basis named and the
   f32 FMA bound printed beside it. The wrapper's copies of the forward's
   and the backward's launch plans (the guard's ``smem_budget``) must
   equal the library's at every d ≤ 256.
14. The trainer with the competitor losses at full width:
   ``make_seqrec_train_step`` with ``train_loss`` set by
   ``dataclasses.replace`` — ``ce_fused_linear`` and ``ce_fused`` for 20
   steps each (every loss finite, no step skipped, the mean of the last 5
   losses below the first 5's, each of the family's three kernels and the
   split launched once per step), then every other registry name at its
   ``make_loss`` defaults for 3 steps (``ce`` holds the dense
   ``(N, C)`` logits and runs at batch 64: at 128 they and their
   gradients do not fit an H100 80GB). Prints one table of each loss's
   median step and peak device memory beside SCE's from phases 7–8 and
   ``loss_peak_elements``.
15. The guard's kernels against their plain versions on the card:
   ``sce_bucket`` forward, dX, dY and the partial LSE at n_b 320, b_x
   320, b_y 256, d 64 with ``y_b`` gathered from the catalog (a collision
   and a padding slot per bucket), without and with cap 30 — losses and
   gradients within ``1e-5·max|want|`` plus ``2e-4·|want|``, masked dY
   rows exactly 0, two dY launches equal bit for bit; ``eval_tgt_scores``
   then ``eval_topk`` at B 256 and 128 against the whole catalog (k 10,
   window [1, 173,511)) and on shard 1 of 4 with its ``id_offset`` —
   values within ``1e-5·max|score|``, isolated ids equal, ``gt``/``eq``
   inside a dense f64 band, ``eq ≥ 1`` on every valid target (the
   threshold is bit for bit the swept column). Times each kernel, its
   plain version and one PyTorch call with a cold L2 (``sce_bucket``'s dX
   and dY bound in 3xTF32 as in phase 6).
16. Drills: the trainer at full width with ``chaos_nan_at=5`` must raise
   ``RuntimeError`` at step 7 after three ``[guard]`` strike lines naming
   ``sce_bucket_nonfinite``; the same with checkpoints (``gspmd``,
   ``ckpt_every=4``, ``max_strikes=3``, 12 steps) must strike at steps
   5 and 6 and at step 7 roll back to the verified step 3, with one
   rollback, 16 steps run, a finite final loss and no NaN in any saved
   checkpoint; a monkeypatched broken ``mips_topk`` must make its CUDA
   dispatch raise ``KernelConformanceError`` under ``warn`` and keep a
   fresh server not ready (then the real kernel is restored and its
   verdict passes again).
17. Checkpoints at full width (``ckpt_phase``; ``sce_mode="gspmd"``,
   batch 128, seed 0, a temporary directory). The main path, its counts
   from 0: a straight run of 12 steps with ``ckpt_every=4`` and
   ``keep_n=0`` (saves at steps 3, 7, 11; ``mips_topk`` at k 320 and
   256, the three ``sce_gather`` launches and the dY sum once a step,
   ``sce_gather_plse`` never), then ``RetrievalServer("sasrec-sce",
   cfg=make_config(), ckpt_dir=…, buckets=(8, 32))`` answering 40
   histories (``mips_topk`` at k 10). ``restored_step`` must be 11 and
   the answers equal bit for bit those of a server given the same
   restored params through ``params=``, and differ from a random
   server's. Drills, each held to the straight run's losses bit for bit:
   6 steps and a relaunch to 12 in the same directory (``resumed from
   step 3``, steps 4–11); ``step_11/leaves.npz`` truncated and a byte of
   ``step_7/manifest.json`` flipped, then a relaunch (two ``falling
   back`` warnings, resumed from step 3); a ``mark`` hook sending SIGTERM
   at step 5's ``"start"`` (step 5 completes, ``preempted`` with
   ``preempt_step`` 5 after a final blocking save) and its relaunch
   (resumed from step 5). The same resume with ``sce_mode="exact"``
   under ``strict`` is printed (equal bit for bit, or the largest gap),
   not required. Prints, each beside the card's name and power limit, the
   checkpoint's bytes on disk, a non-blocking save's host snapshot (what
   the caller waits for) and its writer thread's seconds, a restore's
   seconds onto the card (three each), and the straight run's median step
   with and without ``ckpt_dir`` (the trainer's ``step_s``, and the loop
   iteration from one step's start to the next, saves included); the run
   without ``ckpt_dir`` must end on the same losses. A third run of 60
   steps at the CLI's ``ckpt_every=20`` (its first 12 losses the
   straight run's) prints its loop iterations (median, mean, the two
   saving ones) and the median step 1–4 and 15–19 steps after a save.
18. The LM path at full width (``lm_phase``): gemma-2-2b as published —
   bfloat16 with remat, 26 layers, d 2304, vocabulary 256,000 — random
   weights from a seed. First its kernels at its shapes in f32 against
   their plain versions: ``mips_topk`` (the deep chain) for 128 bucket
   centres against 4,096 positions at k 128 and against the 256,000
   vocabulary rows at k 1024 (gap-aware); the three ``sce_gather_plse``
   and the three ``sce_gather_loss`` launches at (n_b 128, b_x 128,
   b_y 1024, d 2304, cap 30) on that selection (phase 6's tolerances),
   and the deep backward as autograd runs it (one launch: the cotangent
   written once, dX and dY's slot rows from it), bit for bit dX and dY
   alone;
   ``eval_fused`` / ``eval_tgt_gather`` at 8,192 × 256,000, k 1, the LSE
   with cap 30 (integers bit for bit; floats within ``1e-5`` of scale,
   the LSE within 1e-5 relative); one microbatch's SCE loss and its dX
   and dY through ``sce_loss_sharded`` (exact, the (1, 1) mesh) on the
   kernel path against the plain path (integer-valued x, y / 256 and a
   sparse Ω, so both select the same candidates); each timed with a cold
   L2 beside its plain version, a PyTorch computation of its function
   and its 3xTF32 bound. Then the same kernels on bf16 operands
   (``lm_bf16_kernel_phase``): both selections, the three
   ``sce_gather_plse`` launches and the deep backward, the in-order dY
   sum into the bf16 table, ``eval_fused`` / ``eval_tgt_gather`` and the
   deep ``linear_ce`` (and ``fused_lse``, timed only) forward and
   backward; all of them on the bf16 ``wgmma`` product (``gemm_bf16``),
   repeating bit for bit;
   the selections' and eval's values and LSE pair within ``1e-5·max|·| +
   2e-4·|·|`` of the f64 plain version, ids equal wherever the gap is
   above that, the eval's ``gt`` within the columns that close to the
   target and ``eq`` ≥ 1; each target score the eval slab's own column
   bit for bit (so ``eq`` counts it); the SCE and ``linear_ce`` forwards within
   ``1e-5`` and backwards within ``3e-2`` of their scale of the plain
   versions (the cotangent rounded to bf16 on both sides), the bf16 dY
   sum the f32 sum rounded once bit for bit; each timed beside its plain
   version, a PyTorch call in bf16 and its bound at bf16's rates (3.35
   TB/s at 2 B a value, 989 TFLOP/s). Then the main
   path in bf16, its counts from 0:
   ``train("gemma2-2b", cfg=…, batch=2, seq_len=4096, steps=4,
   sce_mode="exact")`` under ``warn`` — train_4k's 2 microbatches of one
   sequence, ``mips_topk`` at k 128 and 1024 and the three
   ``sce_gather_plse`` launches and the dY sum once a microbatch, the
   token-rank evaluation of 2 held-out sequences after step 4 (one
   ``eval_fused`` and one ``eval_tgt_gather``); finite losses, the last
   below the first; AdamW moments and the microbatch accumulator f32.
   Prints the median step, its phases (``mark``), SCE's share, the peak
   memory; then 2 steps of the full-CE baseline (``ce_fused_linear``);
   on fresh weights the evaluation's rows/s and phases, and a 512-token
   prefill and 8 decode steps whose last logits must equal a forward over
   the 520 tokens within ``3e-2`` of their scale (bf16; ``1e-3`` in
   f32). Last, the f32 step still driven at reduced depth (2 layers of
   26, the published widths): 2 SCE steps and 2 full-CE steps.
19. BERT4Rec at full width (``b4r_phase``): ``configs/bert4rec.py`` as
   published — 1,000,000 items (1,000,016 rows with [MASK] and the
   padding), d 64, L 200, 2 blocks, 2 heads, f32 — random weights from a
   seed. First its kernels at its shapes against their plain versions
   (phases 4, 6 and 11's tolerances), each timed with a cold L2 beside its
   plain version, a PyTorch call and its bound: ``mips_topk`` at a
   microbatch's two SCE selections (320 bucket centres against 25,600
   positions at k 320 under a ≈ 15 % cloze mask, against the 10⁶ catalog
   at k 512), at serving's bucket 512 (k 10), serve_p99 (512 × 10⁶,
   k 100) and retrieval_cand (1 × 10⁶ gathered candidates, k 100); the
   three ``sce_gather_plse`` launches and the dY sum at n_b 320, b_x 320,
   b_y 512 on that selection; ``eval_fused`` / ``eval_tgt_gather`` at
   B 256 against the catalog (k 10). Then the main path, each run's
   counts from 0: ``train("bert4rec", cfg=…, batch=1024, steps=4,
   sce_mode="exact")`` (train_batch's 65,536 sequences cut to 1,024, in
   its 8 microbatches of 128, each with its cloze mask; ``mips_topk`` at
   k 320 and 512, the three ``sce_gather_plse`` launches and the dY sum
   once a microbatch; finite losses; median step, phases by ``mark``,
   peak memory); phase 12's evaluation with BERT4Rec's cloze score
   function (8 × 256 users, ranks inside the f64 band of a dense on-card
   oracle that masks the held-out item); phase 5's server as
   ``RetrievalServer("bert4rec")`` at buckets 8 / 32 / 512, k 10; then
   ``make_seqrec_serve_step`` at serve_p99 (512 histories, k 100, only
   phantom rows masked) and ``make_seqrec_retrieval_step`` at
   retrieval_cand (1 × 10⁶ candidates, k 100), each against a dense
   on-card oracle with the tie rule and timed by the host clock.
20. granite-moe-3b-a800m at full width (``granite_phase``):
   ``configs/granite_moe.py`` as published — 32 layers, d 1536, 24 query
   heads (padded to 32) over 8 KV heads of 64, 40 experts (padded to 48)
   top-8 of d_ff 512 at capacity factor 1.25, vocabulary 49,155 (49,168
   table rows: a ragged last tile), no final softcap, bfloat16 with remat
   — random weights from a seed. First phase 18's bf16 kernel checks at
   its shapes (``lm_bf16_kernel_phase``: SCE's parameters at 4,096
   positions, n_b 128, b_x 128, b_y 512, no cap; ``mips_topk`` at k 128
   and 512, ``sce_gather_plse`` and its deep backward, the dY sum into
   the bf16 (49,168, 1536) table, ``eval_fused`` / ``eval_tgt_gather`` at
   8,192 × 49,168, the deep ``linear_ce``); then one MoE block at its
   widths (4,096 tokens): forward and backward repeat bit for bit (the
   combine is a gather summed in a fixed order, no atomics), timed.
   Then the main path, each run's counts from 0: ``train(
   "granite-moe-3b-a800m", cfg=…, batch=8, seq_len=4096, steps=4,
   sce_mode="exact")`` — train_4k's 256 sequences cut to 8, in its 8
   microbatches of one sequence; finite, falling losses; the median step,
   its phases, the peak memory and the mark that reached it, the MoE
   assignments dropped per step; then 2 steps of ``ce_fused_linear``;
   on fresh weights the token rank's rows/s, the parameters as stored,
   and prefill 512 + 8 decode steps against a forward over 520 tokens,
   each path's drops and the (layer, token) pairs routed unlike the
   forward counted (a decode step drops none), then the same at a
   capacity factor at which nothing drops (printed), then with every
   token routed to all 40 experts (no choice to flip, nothing dropped)
   in bf16 (printed) and held on the same weights in f32: the last
   logits within ``1e-3`` of the scale.
21. Distribution on one card, a world of one (``dist_phase``). (a) The
   sharded entry points on a ``(1, 1)`` mesh against ``mesh=None``, equal
   (metrics exactly, tensors bit for bit) and timed by the host clock
   beside them, their kernels' launches counted from 0:
   ``evaluate_streaming`` for SASRec-SCE (C 173,511) and BERT4Rec (10⁶
   items) at 256 users, ``evaluate_streaming_lm`` at gemma-2-2b's
   published widths in bf16 (vocabulary 256,000, d 2304, softcap 30;
   depth cut to 2 of 26 layers, random weights) over 1,024 rows, BERT4Rec's
   three serve steps (serve_p99's 512 histories, retrieval_cand's 1 ×
   10⁶ candidates) and ``RetrievalServer(mesh=)`` at SASRec's buckets.
   (b) Each model shard's local stage of a 4-way split of the same
   catalogs in turn (C/4 rows at ``id_offset = j·C/4``): the shards'
   ``eval_tgt_gather`` summed (the psum: the owner's score and exact
   zeros), each shard's ``eval_fused`` against it, merged by the
   collectives' own ``merge_gathered_topk`` / ``merge_gathered_lse`` and
   the summed counts — ids, values, ``gt``, ``eq`` and the target score
   equal to the unsharded ``eval_fused`` bit for bit, the LSE within
   ``1e-5`` relative; the serve steps' ``mips_topk`` stage likewise, bit
   for bit; shard 0's kernels held against their plain versions on the
   same inputs (at ``eval_case``'s and ``run_case``'s tolerances) and
   timed at the shard's shape. (c)
   ``train("sasrec-sce", grad_compression="int8", n_hosts=4)`` at full
   width for 4 steps (its host batches bit for bit the 1-host batches;
   its losses beside the uncompressed run's), and a compressed run
   checkpointed at step 1 and resumed to 4 that repeats the
   uninterrupted one bit for bit, its last checkpoint (the
   error-feedback residual included) too.
22. The CTR models and SchNet at their published widths
   (``recsys_gnn_phase``); neither family runs a kernel of the port (the
   reference computes them without Pallas), so every launch counter of
   ``repro_torch.kernels`` must stay where it was around the phase.
   dcn-v2, dlrm-rm2 and xdeepfm at ``make_config()``: ``train(name,
   cfg=…, batch=65536, steps=4)`` (train_batch as published, guarded
   AdamW, the clickstream drawn on the host before each step's ``start``
   mark): finite losses, the median step from ``start`` to
   ``optimizer`` and its phases from CUDA events, the peak memory; then,
   on random weights and random rows, the serve step at serve_p99 (512
   rows) and serve_bulk (262,144 rows) by the host clock, the first 512
   probabilities within ``2e-5`` of an f64 forward of the same rows, and
   the retrieval step at retrieval_cand (one user, 10⁶ candidates in
   chunks of 4,096, top 100) by the host clock, its values within
   ``1e-4·max|s|`` of the top 100 of every candidate's f64 score and its
   positions equal wherever an f64 score stands further than that from
   its neighbours. SchNet at ``make_config(shape)`` on molecule (128
   molecules of 30 nodes and 64 bonds), full_graph_sm (2,708 nodes and
   10,556 directed edges padded to multiples of 512) and minibatch_lg
   (1,024 seeds, fanouts 15 and 10, sampled from a Reddit-sized graph of
   232,965 nodes and 229 M directed edges built on the host, its build
   time printed): the first step's loss within ``1e-5`` relative and
   gradients within ``1e-4·max|g|`` of the same step on f64 copies, then
   4 AdamW steps through ``make_gnn_train_step`` — median step, phases,
   peak memory. ogb_products is not run (its ``(E, 300)`` RBF features
   alone are 138 GiB).
23. Prints the kernels' JSON line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``. ``mips_topk`` has
   three entries: all its main-path launches timed at serving's largest
   bucket, and its training selections (k = 320 over the positions,
   k = 256 over the catalog), each with both trainers' and the
   checkpoint path's launches at that k. The ``sce_gather`` and dY-sum
   entries add the checkpoint path's launches too. ``eval_fused`` and ``eval_tgt_gather`` have two each: the
   evaluation phase's B = 256 and the trainers' B = 128. The three
   ``sce_gather_plse`` launches carry phase 8's launches and phase 6's
   times on the (1, 1) input. ``sce_gather_dy_sum`` carries both
   trainers' launches and phase 6's time. The six full-CE kernels and the
   split carry
   phase 14's launches and phase 13's times at the trainer's shape. The four
   ``sce_bucket`` launches and ``eval_topk`` / ``eval_tgt_scores`` carry
   phase 3's launches (the canaries') and phase 15's times (the eval ones
   at B = 256). The LM path's entries (``*_lm``) carry phase 18's f32
   runs' launches (reduced depth) and its f32 times at gemma-2's shapes
   (``mips_topk`` one per selection); the ``*_lm_bf16`` entries the
   published bf16 runs' launches and the bf16 times. The ``*_b4r``
   entries carry phase 19's runs' launches (``mips_topk`` one per shape:
   the two selections with the trainer's launches at that k, the server's
   and each serve step's) and its times at BERT4Rec's shapes. The
   ``*_granite`` entries carry phase 20's runs' launches and its times
   at granite's shapes. The ``*_shard4*`` entries carry phase 21's
   times of shard 0 of 4, that shard's kernel against its plain version
   (``max_abs_err``), the 4-way merge against the unsharded kernel
   (``merge_max_abs_err``: 0, bit for bit) and the launches of its
   sharded entry points (the evaluation of their model, the server, the
   top-100 serve step).
   Every entry must have launched at least once on its main path.

Any failed check raises, so the script exits non-zero and prints no
result. ``--json PATH`` also writes every case, time and count to PATH.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_PHASES = 23

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12  # f32 outside the tensor cores
PEAK_TF32_FLOP_S = 495e12  # dense TF32 on the tensor cores
PEAK_BF16_FLOP_S = 989e12  # dense bf16 on the tensor cores
SFU_PER_SM_CLOCK = 16  # exp2 / tanh results an SM's SFUs give a clock

C_SERVE = 173_520  # sasrec-sce's shard-even catalog slice
N_ITEMS = 173_511
D = 64
K = 10
BUCKETS = (8, 32, 512)
NEG_INF = -1e30
ID_PAD = 2**31 - 1
EVAL_B = (128, 256)  # users per evaluation: the trainer's, the eval phase's
KS = (1, 5, 10)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel against its plain version
# ---------------------------------------------------------------------------
def dense_topk(scores, k):
    """Top-``k`` of a dense masked score matrix with the merge's tie rule
    (value desc, id asc) — a stable descending sort over id order."""
    import torch

    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    order = order[:, :k]
    return torch.gather(scores, 1, order), order.to(torch.int32)


def compare(got, want, want_next, tol, *, exact: bool):
    """Hold a kernel result against the plain one. ``want_next`` is the
    plain (k+1)-th value per row (or None when k = C). Returns the max
    |value| difference; raises on disagreement."""
    import torch

    gv, gi = got
    wv, wi = want
    check(gv.shape == wv.shape and gi.shape == wi.shape,
          f"shape {tuple(gv.shape)} vs {tuple(wv.shape)}")
    check(gi.dtype == torch.int32, f"ids dtype {gi.dtype}")
    err = (gv - wv).abs().max().item() if gv.numel() else 0.0
    if exact:
        check(torch.equal(gv, wv), f"values differ bitwise (max {err})")
        check(torch.equal(gi, wi), "ids differ on exact inputs")
        return err
    check(err <= tol, f"values differ by {err} > {tol}")
    # Ids must match where position j's score is isolated: further than
    # tol from its neighbours (the (k+1)-th included).
    nxt = wv[:, 1:]
    if want_next is not None:
        nxt = torch.cat([nxt, want_next[:, None]], dim=1)
    else:
        nxt = torch.cat([nxt, torch.full_like(wv[:, :1], NEG_INF)], dim=1)
    prv = torch.cat([torch.full_like(wv[:, :1], float("inf")), wv[:, :-1]],
                    dim=1)
    isolated = ((prv - wv) > tol) & ((wv - nxt) > tol)
    bad = isolated & (gi != wi)
    check(not bad.any().item(),
          f"{int(bad.sum())} isolated ids differ from the plain version")
    return err


def run_case(name, q, y, k, *, valid=None, id_offset=0, exact=False,
             kcap=None):
    """Kernel vs plain version on one input; returns a result dict. Above
    k = 32 it also reports the chain's per-row collect counts (rows above
    ``kcap`` were finished by the split sweep); ``kcap`` replaces the
    plan's."""
    import torch

    from repro_torch.kernels.mips_topk import SMALL_K, mips_topk
    from repro_torch.kernels.ref import mips_topk_ref

    got = mips_topk(q, y, k, valid=valid, id_offset=id_offset, kcap=kcap)
    torch.cuda.synchronize()
    collect = None
    if min(k, y.shape[0]) > SMALL_K:
        counts = mips_topk.last_counts.float()
        collect = {"mean": counts.mean().item(),
                   "max": int(counts.max().item()),
                   "overflow_rows": int((counts > (
                       kcap or _kcap(q, y, k))).sum().item())}
    c = y.shape[0]
    kk = min(k, c)
    want = mips_topk_ref(q, y, kk, valid=valid, id_offset=id_offset)
    want_next = None
    if kk < c:
        nv, _ = mips_topk_ref(q, y, kk + 1, valid=valid, id_offset=id_offset)
        want_next = nv[:, kk]
    scale = (q @ y.T).abs().max().item()
    tol = 1e-5 * scale
    err = compare(got, want, want_next, tol, exact=exact)
    n_pad = int((got[1] == ID_PAD).sum())
    more = "" if collect is None else (
        f" collected mean {collect['mean']:.1f} max {collect['max']}, "
        f"{collect['overflow_rows']} rows finished by the split sweep")
    print(f"  case {name}: n_q={q.shape[0]} C={c} d={q.shape[1]} k={kk} "
          f"id_offset={id_offset} max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'bitwise' if exact else 'gap-aware'} ID_PAD={n_pad}{more} ok")
    return {"name": name, "n_q": q.shape[0], "C": c, "d": q.shape[1],
            "k": kk, "max_abs_err": err, "tol": tol, "exact": exact,
            "id_pad_slots": n_pad, "collect": collect}


def _kcap(q, y, k):
    """The plan's collect buffer per row of a k > 32 call."""
    import torch

    from repro_torch.kernels.mips_topk import select_plan

    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    return select_plan(q.shape[0], y.shape[0], q.shape[1],
                       min(k, y.shape[0]), n_sm).kcap


def time_ms(fn, reps, flush):
    """Mean device time of ``fn`` over ``reps`` runs, each after an L2
    flush (the serve step's catalog read comes from device memory). The
    flush (zeroing 1 GiB, about 0.3 ms of device time) is queued first,
    so ``fn``'s launches are queued while it runs and the events time the
    device work, not the host's enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def roofline_ms(nbytes, flops):
    """The larger of the byte time and the f32 FLOP time at the card's
    peaks, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tf32x3_bound(nbytes, flops, exps):
    """The least time of a kernel that runs its ``flops`` in 3xTF32 on the
    tensor cores: the largest of three TF32 passes at the dense TF32 rate,
    its ``exps`` at the SFUs' rate (16 a clock per SM at the card's top SM
    clock) and its bytes. Returns ``(ms, "bytes" | "operations", basis,
    f32_ms)``, the same FLOPs' f32 FMA bound (:func:`roofline_ms`) last."""
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cands = {"3xTF32 tensor cores": 3 * flops / PEAK_TF32_FLOP_S * 1e3,
             "SFU exps": exps / (SFU_PER_SM_CLOCK * n_sm * sm_clock_hz())
             * 1e3,
             "bytes": nbytes / PEAK_BYTES_S * 1e3}
    basis = max(cands, key=cands.get)
    return (cands[basis], "bytes" if basis == "bytes" else "operations",
            basis, roofline_ms(nbytes, flops)[0])


def bf16_bound(nbytes, flops, exps):
    """The least time of a kernel on bf16 operands: the largest of its
    FLOPs at the card's dense bf16 rate (the least any bf16 product
    takes), its ``exps`` at the SFUs' rate and its bytes (operands at 2 B
    a value). Returns ``(ms, "bytes" | "operations", basis)``."""
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cands = {"bf16 tensor cores": flops / PEAK_BF16_FLOP_S * 1e3,
             "SFU exps": exps / (SFU_PER_SM_CLOCK * n_sm * sm_clock_hz())
             * 1e3,
             "bytes": nbytes / PEAK_BYTES_S * 1e3}
    basis = max(cands, key=cands.get)
    return (cands[basis], "bytes" if basis == "bytes" else "operations",
            basis)


def bf16_bound_keys(bound):
    """A timing's bound keys from :func:`bf16_bound`."""
    return {"bound_ms": bound[0], "bound_by": bound[1],
            "bound_basis": bound[2]}


def f32_bound(nbytes, flops):
    """:func:`roofline_ms` in :func:`tf32x3_bound`'s form, for a kernel of
    f32 FMAs."""
    ms, by = roofline_ms(nbytes, flops)
    return ms, by, "bytes" if by == "bytes" else "f32 FMAs", ms


def bound_keys(bound):
    """A timing's bound keys from a :func:`roofline_ms` pair or a
    :func:`tf32x3_bound` / :func:`f32_bound` quadruple (with its basis and
    the f32 FMA bound)."""
    keys = {"bound_ms": bound[0], "bound_by": bound[1]}
    if len(bound) == 4:
        keys.update(bound_basis=bound[2], bound_f32_ms=bound[3])
    return keys


def bound_text(t):
    """A timing's bound as printed: ms, what bounds it and, for a 3xTF32
    kernel, its f32 FMA bound."""
    if t.get("bound_basis") in (None, "bytes", "f32 FMAs"):
        return f"{t['bound_ms']:.4f} ms ({t['bound_by']})"
    if "bound_f32_ms" not in t:  # bf16: the tensor cores or the SFUs
        return f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bound_basis']})"
    return (f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bound_basis']}; "
            f"as f32 FMAs {t['bound_f32_ms']:.4f} ms)")


def unmasked_pairs(tgt, cand):
    """The (position, candidate) pairs of the buckets that are not masked
    (a candidate with a negative id or equal to the position's target):
    the exps the backward's data needs."""
    return int(((cand[:, None, :] >= 0)
                & (cand[:, None, :] != tgt[:, :, None])).sum())


def bound_ms(n_q, c, d, k, *, valid=True):
    """Least time for the work: inputs read once (q, y, the bool valid
    mask when there is one), outputs written once, 2·n_q·C·d FLOPs — in
    3xTF32 on the tensor cores for k ≤ 32 (the tensor-core sweep), as f32
    FMAs above (the k > 32 chain)."""
    nbytes = 4 * (n_q * d + c * d) + (c if valid else 0) + 8 * n_q * k
    if k <= 32:
        return tf32x3_bound(nbytes, 2 * n_q * c * d, 0)[:2]
    return roofline_ms(nbytes, 2 * n_q * c * d)


def kernel_phase(dev):
    import torch

    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.kernels.ref import mips_topk_ref

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device=dev).to(torch.float32)

    ar = torch.arange(C_SERVE, device=dev)
    window = (ar >= 1) & (ar < N_ITEMS)
    y = randn(C_SERVE, D, scale=0.02)  # embed_init scale
    cases = []
    serve = {}
    for n_q in BUCKETS:
        q = randn(n_q, D)
        r = run_case(f"serve_b{n_q}", q, y, K, valid=window)
        cases.append(r)
        serve[n_q] = (q, r)

    # Adversarial cases (mirroring the reference's conformance canaries).
    qi, yi = randint(-2, 3, 32, D), randint(-2, 3, C_SERVE, D)
    cases.append(run_case("int_ties_serve", qi, yi, K, valid=window,
                          exact=True))
    cases.append(run_case("int_ties_k256", randint(-2, 3, 40, 128),
                          randint(-2, 3, 20_000, 128), 256, exact=True))
    cases.append(run_case("c_tail", randn(8, D), randn(1_037, D), K))
    cases.append(run_case("k_gt_c", randint(-3, 4, 5, D),
                          randint(-3, 4, 7, D), K, exact=True))
    starved = torch.zeros(500, dtype=torch.bool, device=dev)
    starved[torch.tensor([3, 77, 78, 200, 301, 499], device=dev)] = True
    cases.append(run_case("starved_valid", randint(-3, 4, 9, D),
                          randint(-3, 4, 500, D), K, valid=starved,
                          exact=True))
    cases.append(run_case(
        "id_offset", randn(16, D), randn(3_000, D), K,
        valid=torch.rand(3_000, generator=g, device=dev) > 0.3,
        id_offset=1_000,
    ))
    cases.append(run_case("k256_d256", randn(40, 256), randn(30_000, 256),
                          256))
    # d % 4 != 0, and a catalog 4 bytes off a 16-byte boundary: the
    # 4-byte tile loader (and, for odd d, the zeroed depth padding).
    cases.append(run_case("odd_d33_ties", randint(-2, 3, 37, 33),
                          randint(-2, 3, 1_100, 33), K,
                          valid=torch.arange(1_100, device=dev) >= 1,
                          id_offset=7, exact=True))
    cases.append(run_case("odd_d63", randn(12, 63), randn(2_000, 63), 20,
                          id_offset=3))
    y_off = randint(-2, 3, 700 * D + 1)[1:].view(700, D)
    check(y_off.data_ptr() % 16 != 0, "misaligned catalog is aligned")
    cases.append(run_case("misaligned_y", randint(-2, 3, 9, D), y_off, K,
                          exact=True))

    # Times at the serve shapes, cold L2 (the H100's is 50 MB).
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    timings = {}
    for n_q in BUCKETS:
        q, r = serve[n_q]

        def kernel():
            return mips_topk(q, y, K, valid=window)

        def plain():
            return mips_topk_ref(q, y, K, valid=window)

        def library():
            s = torch.where(window[None, :], torch.matmul(q, y.T), NEG_INF)
            return torch.topk(s, K)

        b, by = bound_ms(n_q, C_SERVE, D, K)
        timings[n_q] = {
            "ms": time_ms(kernel, 50, flush),
            "plain_ms": time_ms(plain, 3, flush),
            "library_ms": time_ms(library, 50, flush),
            "bound_ms": b, "bound_by": by,
            "max_abs_err": r["max_abs_err"],
        }
        t = timings[n_q]
        print(f"  time n_q={n_q}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({by})")
    return cases, timings


# ---------------------------------------------------------------------------
# The server at full width
# ---------------------------------------------------------------------------
def step_breakdown(server, hist, reps=20):
    """Where one serve step's time goes, per bucket: CUDA events between
    the step's phases (tokens to the card, the encoder's forward, the
    mips_topk selection, results to the host) and the host clock around
    the whole step. The device timeline between two events includes any
    wait for the host to enqueue the next launch."""
    import torch

    from repro_torch.eval.streaming import streaming_topk
    from repro_torch.models import sasrec

    cfg, params, dev = server.cfg, server.params, server.device
    model = encoder(cfg)
    y = sasrec.loss_catalog(params, cfg)
    out = {}
    for bucket in server.router.buckets:
        tokens = hist[:bucket]
        sums = [0.0] * 4
        wall = 0.0
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                ev[0].record()
                tok = torch.from_numpy(tokens).to(dev)
                ev[1].record()
                x = model.forward(params, cfg, tok)[:, -1].contiguous()
                ev[2].record()
                vals, ids = streaming_topk(x, y, server.top_k, c_lo=1,
                                           c_hi=cfg.n_items)
                ev[3].record()
                vals.cpu(), ids.cpu()
                ev[4].record()
            ev[4].synchronize()
            if rep:  # the first run is a warm-up
                wall += (time.perf_counter() - t0) * 1e3
                for i in range(4):
                    sums[i] += ev[i].elapsed_time(ev[i + 1])
        out[bucket] = dict(zip(
            ("h2d_ms", "forward_ms", "select_ms", "d2h_ms"),
            (s / reps for s in sums),
        ))
        out[bucket]["step_wall_ms"] = wall / reps
        b = out[bucket]
        print(f"  step b{bucket}: wall {b['step_wall_ms']:.3f} ms = "
              f"h2d {b['h2d_ms']:.3f} + forward {b['forward_ms']:.3f} + "
              f"mips_topk {b['select_ms']:.3f} + d2h {b['d2h_ms']:.3f} ms "
              f"(device events, mean of {reps})")
    return out


def encoder(cfg):
    """The model module whose ``forward`` encodes ``cfg``'s histories:
    BERT4Rec's for a bidirectional config, SASRec's otherwise."""
    from repro_torch.models import bert4rec, sasrec

    return sasrec if cfg.causal else bert4rec


def server_phase(dev, arch="sasrec-sce"):
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.serve import RetrievalServer
    from repro_torch.models import sasrec

    cfg = get_arch(arch).make_config()
    check(arch != "sasrec-sce" or (cfg.catalog_loss_size == C_SERVE
                                   and cfg.n_items == N_ITEMS),
          "sasrec-sce catalog changed")
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=512,
    ))
    hist = data.next_batch(Cursor(seed=1))[0]["tokens"]

    mips_topk.launches = 0  # the main path starts here
    t0 = time.monotonic()
    server = RetrievalServer(
        arch, cfg=cfg, buckets=BUCKETS, top_k=K, queue_size=1024,
        seed=0, device=dev,
    )
    setup_s = time.monotonic() - t0
    warm_launches = mips_topk.launches
    try:
        waves = (5, 19, 45)  # not bucket multiples
        reqs, ofs = [], 0
        t0 = time.monotonic()
        for n in waves:
            wave = [server.submit(h) for h in hist[ofs:ofs + n]]
            for r in wave:
                r.result(timeout=300.0)
            reqs += wave
            ofs += n
        async_s = time.monotonic() - t0
        t0 = time.monotonic()
        bulk_vals, bulk_ids = server.score(hist)
        bulk_s = time.monotonic() - t0
        health = server.health()
    finally:
        server.close()
    launches = mips_topk.launches  # the main path ends here
    breakdown = step_breakdown(server, hist)
    check(launches > warm_launches,
          f"serving launched mips_topk {launches - warm_launches} times")
    check(health["cache_misses"] == 0, f"cache_misses {health['cache_misses']}")
    gate = [v for v in health["conformance"] if v["kernel"] == "mips_topk"]
    check(health["ready"] and health["readiness_error"] is None
          and gate and gate[0]["passed"],
          f"the server did not become ready through its gate: {health}")
    check(health["compile_count"] == len(BUCKETS), "bucket warm-up count")
    results = [r.result() for r in reqs]
    check(all(not r.degraded and r.k == K for r in results),
          "an async request came back degraded")

    # Dense on-card oracle, same params and tie rule.
    with torch.inference_mode():
        tok = torch.from_numpy(hist).to(dev)
        hidden = encoder(cfg).forward(server.params, cfg, tok)[:, -1]
        y = sasrec.loss_catalog(server.params, cfg)
        raw = hidden @ y.T
        gid = torch.arange(y.shape[0], device=dev)
        ok = (gid >= 1) & (gid < cfg.n_items)
        scale = raw[:, ok].abs().max().item()
        want_v, want_i = dense_topk(torch.where(ok[None, :], raw, NEG_INF),
                                    K + 1)
    # The oracle runs the forward at batch 512; async requests ran in other
    # bucket shapes, where cuBLAS may fold in another order: 1e-4·max|s|.
    tol = 1e-4 * scale
    async_v = torch.from_numpy(np.stack([r.vals for r in results])).to(dev)
    async_i = torch.from_numpy(np.stack([r.ids for r in results])).to(dev)
    n_async = len(results)
    errs = []
    for name, (gv, gi), rows in (
        ("async", (async_v, async_i), slice(0, n_async)),
        ("bulk", (torch.from_numpy(bulk_vals).to(dev),
                  torch.from_numpy(bulk_ids).to(dev)), slice(0, 512)),
    ):
        wv, wi = want_v[rows, :K], want_i[rows, :K]
        errs.append(compare((gv, gi), (wv, wi), want_v[rows, K], tol,
                            exact=False))
        check(bool(((gi >= 1) & (gi < cfg.n_items)).all()),
              f"{name}: an id outside [1, n_items) was served")
    lats = sorted(r.latency_ms for r in reqs)
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    out = {
        "arch": arch,
        "config": {"n_items": cfg.n_items, "max_len": cfg.max_len,
                   "d_model": cfg.d_model, "n_layers": cfg.n_layers,
                   "n_heads": cfg.n_heads,
                   "catalog_rows": cfg.catalog_loss_size},
        "setup_s": setup_s, "warm_launches": warm_launches,
        "launches": launches, "serve_launches": launches - warm_launches,
        "async_requests": n_async, "waves": list(waves),
        "async_s": async_s, "async_req_s": n_async / async_s,
        "p50_ms": p50, "p99_ms": p99, "bulk_histories": 512,
        "bulk_s": bulk_s, "bulk_req_s": 512 / bulk_s,
        "oracle_tol": tol, "oracle_max_abs_err": max(errs),
        "cache_misses": health["cache_misses"], "step_breakdown": breakdown,
        "ready": health["ready"], "guard_policy": health["guard_policy"],
        "conformance": health["conformance"],
    }
    print(f"  server ({arch}): set-up {setup_s:.2f} s ({warm_launches} "
          f"warm-up "
          f"launches); {n_async} async requests in waves {waves}: "
          f"{out['async_req_s']:.1f} req/s, p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms (n={n_async}, p99 = max); bulk 512 in "
          f"{bulk_s * 1e3:.3f} ms ({out['bulk_req_s']:.1f} req/s); "
          f"mips_topk launches {launches}; cache_misses 0; oracle max err "
          f"{max(errs):.3e} (tol {tol:.3e}); ready through its gate "
          f"(guard {health['guard_policy']}, {len(health['conformance'])} "
          f"verdicts in health())")
    return out


# ---------------------------------------------------------------------------
# Train kernels against their plain versions
# ---------------------------------------------------------------------------
N_POS = 128 * 200  # train_paper: batch 128 × L 200 positions
N_B, B_X, B_Y = 320, 320, 256  # SCEConfig.from_alpha_beta(25,600, 173,511)


def gather_case(name, x_b, y, idx, tgt, cand, pos, cap=None):
    """The three sce_gather kernels against autograd through the plain
    version on one input, for a random upstream cotangent. Returns the
    case's max errors; raises on disagreement."""
    import torch

    from repro_torch.kernels import ops, ref

    g = torch.rand(pos.shape, device=pos.device,
                   generator=torch.Generator(device=pos.device).manual_seed(5))
    got_l = [t.clone().requires_grad_(True) for t in (x_b, y, pos)]
    loss = ops.sce_gather_loss(got_l[0], got_l[1], idx, tgt, cand, got_l[2],
                               logit_softcap=cap)
    got = [loss.detach()] + list(torch.autograd.grad((loss * g).sum(), got_l))
    want_l = [t.clone().requires_grad_(True) for t in (x_b, y, pos)]
    wloss = ref.sce_gather_loss_ref(want_l[0], want_l[1], idx, tgt, cand,
                                    want_l[2], cap)
    want = [wloss.detach()] + list(torch.autograd.grad((wloss * g).sum(),
                                                       want_l))
    torch.cuda.synchronize()
    errs = {}
    for what, a, b, rtol in zip(("loss", "dx", "dy", "dpos"), got, want,
                                (0.0, 2e-4, 2e-4, 2e-4)):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{name}: {what} shape or finiteness")
        err = (a - b).abs()
        tol = 1e-5 * b.abs().max().item()
        check(bool((err <= tol + rtol * b.abs()).all()),
              f"{name}: {what} differs by {err.max().item():.3e} "
              f"(tol {tol:.3e} + {rtol}·|want|)")
        errs[what] = err.max().item()
    touched = torch.zeros(y.shape[0], dtype=torch.bool, device=y.device)
    touched[idx.long().reshape(-1)] = True
    check(bool((got[2][~touched] == 0).all()),
          f"{name}: a dY row no bucket selected is not exactly 0")
    n_b, b_x, d = x_b.shape
    print(f"  case {name}: n_b={n_b} b_x={b_x} b_y={idx.shape[1]} d={d} "
          f"C={y.shape[0]} cap={cap} max err loss {errs['loss']:.3e} dX "
          f"{errs['dx']:.3e} dY {errs['dy']:.3e} d_pos {errs['dpos']:.3e}; "
          f"{int((~touched).sum())} untouched dY rows exactly 0 ok")
    return {"name": name, "n_b": n_b, "b_x": b_x, "b_y": idx.shape[1],
            "d": d, "C": y.shape[0], "cap": cap, "max_abs_err": errs}


def gather_bounds(x_b, y, idx, tgt, cand):
    """Least times of the three kernels on these inputs, as
    ``(ms, by, basis, f32_ms)``: each reads x_b, the distinct catalog rows
    it gathers, the ids and its per-row inputs once and writes its outputs
    once; the forward does 2·n_b·b_x·b_y·d FLOPs, dX and dY twice that
    (the logits again, then a product of the same size), all in 3xTF32 on
    the tensor cores, with an exp per unmasked pair
    (:func:`tf32x3_bound`; the f32 FMA bound beside it). dY is its kernel
    alone, which writes the ``(n_b·b_y, d)`` workspace (the sum into the
    catalog is :func:`dy_sum_bound`)."""
    import torch

    n_b, b_x, d = x_b.shape
    b_y = idx.shape[1]
    rows = int(torch.unique(idx).numel())
    common = 4 * (n_b * b_x * d + rows * d + 2 * n_b * b_y)
    flops = 2 * n_b * b_x * b_y * d
    exps = unmasked_pairs(tgt, cand)
    return {
        "sce_gather_fwd": tf32x3_bound(common + 4 * 4 * n_b * b_x, flops,
                                       exps),
        "sce_gather_dx": tf32x3_bound(
            common + 4 * 3 * n_b * b_x + 4 * n_b * b_x * d, 2 * flops, exps),
        "sce_gather_dy": tf32x3_bound(
            common + 4 * 3 * n_b * b_x + 4 * n_b * b_y * d, 2 * flops,
            exps),
    }


def whole_forward(x_b, y_b, bias, pos):
    """One PyTorch computation of the forward's whole function on the
    candidate rows ``y_b``: the logits with the mask as ``baddbmm``'s
    additive input, the positive beside them, ``logsumexp`` → ``(loss,
    lse)``: the library yardstick of rows 4 and 6."""
    import torch

    lse = torch.logsumexp(torch.cat(
        [pos[..., None], torch.baddbmm(bias, x_b, y_b.transpose(1, 2))],
        -1), -1)
    return lse - pos, lse


def dy_sum_bound(idx, cand, d):
    """Least time of the gathered dY's in-order sum: it reads every
    slot's sorted key (i32) and, for the slots with a non-negative id,
    the slot (i64) and its workspace row once, and writes each selected
    catalog row once."""
    import torch

    n_slots = idx.numel()
    kept = int((cand >= 0).sum())
    rows = int(torch.unique(idx[cand >= 0]).numel())
    return roofline_ms(4 * n_slots + 8 * kept + 4 * kept * d + 4 * rows * d,
                       0)


SHARDS = 4  # the exact-mode shard of phase 6: shard 0 of a 4-way catalog


def plse_case(name, x_b, y, idx, tgt, cand, cap=None):
    """The three ``sce_gather_plse`` launches (forward, dX, dY) against
    autograd through the plain version on one input, for a random
    upstream cotangent. Rows whose candidates are all masked must come out
    at exactly ``NEG_INF`` (finite) with exactly 0 in dX. Returns the
    case's max errors; raises on disagreement."""
    import torch

    from repro_torch.kernels import ops, ref

    g = torch.rand(x_b.shape[:2], device=x_b.device,
                   generator=torch.Generator(device=x_b.device).manual_seed(6))
    got_l = [t.clone().requires_grad_(True) for t in (x_b, y)]
    plse = ops.sce_gather_plse(got_l[0], got_l[1], idx, tgt, cand,
                               logit_softcap=cap)
    got = [plse.detach()] + list(torch.autograd.grad((plse * g).sum(), got_l))
    want_l = [t.clone().requires_grad_(True) for t in (x_b, y)]
    wplse = ref.sce_gather_plse_ref(want_l[0], want_l[1], idx, tgt, cand, cap)
    want = [wplse.detach()] + list(torch.autograd.grad((wplse * g).sum(),
                                                       want_l))
    torch.cuda.synchronize()
    dead = ((cand[:, None, :] < 0)
            | (cand[:, None, :] == tgt[:, :, None])).all(dim=-1)
    check(bool(torch.isfinite(got[0]).all()), f"{name}: a plse is not finite")
    check(bool((got[0][dead] == NEG_INF).all()
               and (want[0][dead] == NEG_INF).all()),
          f"{name}: a row with no unmasked candidate is not NEG_INF")
    check(bool((got[1][dead] == 0).all()),
          f"{name}: dX of a row with no unmasked candidate is not 0")
    errs = {}
    for what, a, b, rtol, keep in (("plse", got[0], want[0], 0.0, ~dead),
                                   ("dx", got[1], want[1], 2e-4, None),
                                   ("dy", got[2], want[2], 2e-4, None)):
        if keep is not None:
            a, b = a[keep], b[keep]
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{name}: {what} shape or finiteness")
        err = (a - b).abs()
        tol = 1e-5 * b.abs().max().item()
        check(bool((err <= tol + rtol * b.abs()).all()),
              f"{name}: {what} differs by {err.max().item():.3e} "
              f"(tol {tol:.3e} + {rtol}·|want|)")
        errs[what] = err.max().item()
    touched = torch.zeros(y.shape[0], dtype=torch.bool, device=y.device)
    touched[idx.long()[cand >= 0]] = True
    check(bool((got[2][~touched] == 0).all()),
          f"{name}: a dY row no unmasked candidate gathers is not exactly 0")
    n_b, b_x, d = x_b.shape
    masked = float((cand < 0).float().mean())
    print(f"  case {name}: n_b={n_b} b_x={b_x} b_y={idx.shape[1]} d={d} "
          f"C={y.shape[0]} cap={cap} cand<0 {masked:.1%}, {int(dead.sum())} "
          f"rows with no unmasked candidate (NEG_INF, dX 0); max err plse "
          f"{errs['plse']:.3e} dX {errs['dx']:.3e} dY {errs['dy']:.3e} ok")
    return {"name": name, "n_b": n_b, "b_x": b_x, "b_y": idx.shape[1],
            "d": d, "C": y.shape[0], "cap": cap, "cand_masked": masked,
            "dead_rows": int(dead.sum()), "max_abs_err": errs}


def plse_bounds(x_b, y, idx, tgt, cand):
    """Least times of the three partial-LSE launches on these inputs, as
    :func:`gather_bounds`: each reads x_b, the distinct catalog rows its
    unmasked candidates gather, the ids and its per-row inputs once and
    writes its outputs once; the forward does 2·d FLOPs per unmasked
    (row, candidate) pair, dX and dY twice that, all in 3xTF32 with an exp
    per pair; dY writes its workspace, as in :func:`gather_bounds`."""
    import torch

    n_b, b_x, d = x_b.shape
    b_y = idx.shape[1]
    pairs = unmasked_pairs(tgt, cand)
    rows = int(torch.unique(idx[cand >= 0]).numel())
    common = 4 * (n_b * b_x * d + rows * d + 2 * n_b * b_y + n_b * b_x)
    flops = 2 * pairs * d
    return {
        "sce_gather_plse_fwd": tf32x3_bound(common + 4 * n_b * b_x, flops,
                                            pairs),
        "sce_gather_plse_dx": tf32x3_bound(
            common + 4 * 2 * n_b * b_x + 4 * n_b * b_x * d, 2 * flops,
            pairs),
        "sce_gather_plse_dy": tf32x3_bound(
            common + 4 * 2 * n_b * b_x + 4 * n_b * b_y * d, 2 * flops,
            pairs),
    }


# The k > 32 chain's kernels, by a part of their names, and its steps.
CHAIN_STEPS = (("pass_kernel<false>", "threshold"), ("tau_kernel", "tau"),
               ("pass_kernel<true>", "collect"), ("select_kernel", "select"),
               ("finish_", "finish"))


def chain_steps(fn, flush, reps=10):
    """Each step's device time per call of ``fn`` (a k > 32 ``mips_topk``),
    from ``torch.profiler`` over ``reps`` calls, each after the L2 flush;
    None for a step the profiler saw no device time of."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    steps = dict.fromkeys((s for _, s in CHAIN_STEPS), 0.0)
    for ev in prof.key_averages():
        for part, step in CHAIN_STEPS:
            if "mips_topk" in ev.key and part in ev.key:
                steps[step] += ev.device_time_total / reps / 1e3
    return {s: t or None for s, t in steps.items()}


def train_kernel_phase(dev):
    import torch

    from repro_torch.core import sce
    from repro_torch.kernels import ref, sce_prefetch
    from repro_torch.kernels.mips_topk import TILE_C, mips_topk, select_plan
    from repro_torch.kernels.ref import mips_topk_ref

    g = torch.Generator(device=dev).manual_seed(1)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device=dev).to(torch.float32)

    # The selections of one training step at the paper's shape.
    x = randn(N_POS, D)  # hidden states
    y = randn(C_SERVE, D, scale=0.125)  # catalog rows
    valid = torch.rand(N_POS, generator=g, device=dev) > 0.25
    targets = torch.randint(1, N_ITEMS, (N_POS,), generator=g, device=dev,
                            dtype=torch.int32)
    cfg = sce.SCEConfig.from_alpha_beta(N_POS, N_ITEMS, use_kernel=True)
    check((cfg.n_buckets, cfg.bucket_size_x, cfg.bucket_size_y)
          == (N_B, B_X, B_Y), "the paper's SCE shape changed")
    b = sce.make_bucket_centers(x, N_B, use_mix=True, valid_mask=valid,
                                generator=g)
    cases = [
        run_case("train_positions_k320", b, x, B_X, valid=valid),
        run_case("train_catalog_k256", b, y, B_Y),
    ]
    starved = torch.zeros(N_POS, dtype=torch.bool, device=dev)
    starved[torch.randperm(N_POS, generator=g, device=dev)[:B_X // 3]] = True
    cases.append(run_case("starved_k320", randint(-2, 3, 40, D),
                          randint(-2, 3, N_POS, D), B_X, valid=starved,
                          exact=True))
    cases.append(run_case("k512_ties", randint(-2, 3, 64, D),
                          randint(-2, 3, 20_000, D), 512, exact=True))
    # The chain's adversarial inputs at the training shapes, integer
    # valued (exact): every row's best columns in one residue of the
    # threshold pass's tiles — over the positions one split holds them
    # all, over the catalog they lie in tiles its 1/R sample skips —;
    # all-equal scores; and a collect buffer of k entries, which sends
    # every row of the catalog selection to the split sweep.
    sp_pos = select_plan(N_B, N_POS, D, B_X, n_sm)
    sp_cat = select_plan(N_B, C_SERVE, D, B_Y, n_sm)

    def clustered(c, period, residue):
        hot = (torch.arange(c, device=dev) // TILE_C) % period == residue
        cat = randint(-2, 3, c, D)
        cat[hot] = randint(3, 6, int(hot.sum()), D)
        return randint(1, 3, N_B, D), cat

    cases.append(run_case("clustered_positions_k320",
                          *clustered(N_POS, sp_pos.period, 1), B_X,
                          valid=valid, exact=True))
    cases.append(run_case("clustered_catalog_k256",
                          *clustered(C_SERVE, sp_cat.period,
                                     sp_cat.n_split + 1), B_Y, exact=True))
    cases.append(run_case("all_equal_positions_k320",
                          torch.ones(N_B, D, device=dev),
                          torch.ones(N_POS, D, device=dev), B_X,
                          valid=valid, exact=True))
    cases.append(run_case("overflow_catalog_k256", randint(-2, 3, N_B, D),
                          randint(-2, 3, C_SERVE, D), B_Y, exact=True,
                          kcap=B_Y))
    check(cases[-1]["collect"]["overflow_rows"] == N_B,
          "the k-entry buffer left rows to the select")

    # The in-bucket loss on that real selection.
    idx_x, idx_y = sce.select_buckets(b, x, y, cfg, valid_mask=valid)
    ix = idx_x.long()
    x_b = x[ix].contiguous()
    tgt_b = targets[ix].to(torch.int32)
    pos = torch.einsum("nxd,nxd->nx", x_b, y[tgt_b.long()]).contiguous()
    gcases = [gather_case("train_shape", x_b, y, idx_y, tgt_b, idx_y, pos)]
    same = idx_y[:1].expand(N_B, -1).contiguous()
    gcases.append(gather_case("same_candidates", x_b, y, same, tgt_b, same,
                              pos))
    rows = torch.stack([torch.randperm(5_000, generator=g, device=dev)[:128]
                        for _ in range(64)]).to(torch.int32)
    tg = torch.randint(0, 5_000, (64, 100), generator=g, device=dev,
                       dtype=torch.int32)
    cand = rows.clone()
    cand[:, 0] = tg[:, 0]
    cand[:, -1] = -1
    gcases.append(gather_case("collisions_cand_neg", randn(64, 100, D),
                              randn(5_000, D), rows, tg, cand,
                              randn(64, 100)))
    rows = torch.stack([torch.randperm(300, generator=g, device=dev)[:50]
                        for _ in range(7)]).to(torch.int32)
    gcases.append(gather_case(
        "ragged_d33_cap30", randn(7, 23, 33, scale=8.0), randn(300, 33),
        rows, torch.randint(0, 300, (7, 23), generator=g, device=dev,
                            dtype=torch.int32), rows,
        30.0 * torch.tanh(randn(7, 23)), cap=30.0))

    # The partial LSE of the distributed exact mode: on one card (the
    # (1, 1) mesh the trainer runs) every candidate of the global top-256
    # is owned; on shard 0 of a 4-way catalog those another shard owns
    # arrive as cand = −1 (≈ 75 %), the rows clamped into the slice.
    pcases = [plse_case("plse_train_shape", x_b, y, idx_y, tgt_b, idx_y)]
    c_l = C_SERVE // SHARDS
    own = idx_y < c_l
    idx_l = idx_y.clamp(max=c_l - 1)
    cand_l = torch.where(own, idx_y, -1)
    y_l = y[:c_l]
    pcases.append(plse_case(f"plse_shard0_of_{SHARDS}", x_b, y_l, idx_l,
                            tgt_b, cand_l))
    cand_nc = cand_l.clone()
    cand_nc[:16] = -1  # buckets that own no candidate at all
    tgt_nc = tgt_b.clone()
    first = cand_l.gather(1, own.to(torch.int32).argmax(1, keepdim=True))
    tgt_nc[16:48, :B_X // 2] = first[16:48]  # collide with an owned one
    pcases.append(plse_case("plse_no_owned_collisions", x_b, y_l, idx_l,
                            tgt_nc, cand_nc))
    pcases.append(plse_case("plse_shard_cap30", x_b * 8.0, y_l, idx_l,
                            tgt_b, cand_l, cap=30.0))
    rows = torch.stack([torch.randperm(300, generator=g, device=dev)[:50]
                        for _ in range(7)]).to(torch.int32)
    cand_r = torch.where(torch.rand(7, 50, generator=g, device=dev) < 0.5,
                         rows, -1)
    cand_r[0] = -1
    pcases.append(plse_case(
        "plse_ragged_d33_cap30", randn(7, 23, 33, scale=8.0), randn(300, 33),
        rows, torch.randint(0, 300, (7, 23), generator=g, device=dev,
                            dtype=torch.int32), cand_r, cap=30.0))

    # The guard's preflight trusts the wrapper's copies of the forward's
    # and dX / dY's launch plans (sce_prefetch.planned_smem): hold them
    # equal to the library's.
    for d in range(1, sce_prefetch.MAX_D + 1):
        for what, mine, lib in (
                ("forward", sce_prefetch.fwd_plan(d),
                 sce_prefetch.library_fwd_plan(d)),
                ("backward", sce_prefetch.bwd_plan(d),
                 sce_prefetch.library_bwd_plan(d))):
            check(mine == lib, f"sce_gather {what} plan at d={d}: wrapper "
                  f"{mine}, library {lib}")
    print("  sce_gather forward and backward plans: the wrapper's copies "
          "equal the library's at every d <= 256")

    # The gathered dY repeats bit for bit (a workspace row per slot, summed
    # in slot order: no atomics), on the trainer's selection and on
    # candidates that every bucket shares; its sum kernel against the
    # plain index_add_ on the same workspace.
    g_rep = torch.rand(pos.shape, generator=g, device=dev)
    for what, ids in (("same_candidates", same), ("train_shape", idx_y)):
        _, lse_r = sce_prefetch.sce_gather_fwd(x_b, y, ids, tgt_b, ids, pos)
        d1, d2 = (sce_prefetch.sce_gather_dy(x_b, y, ids, tgt_b, ids, lse_r,
                                             g_rep) for _ in range(2))
        check(torch.equal(d1, d2), f"{what}: two gathered dY calls differ")
        print(f"  gathered dY ({what}): two calls equal bit for bit ok")
    ws = torch.empty(N_B * B_Y, D, device=dev)  # the train shape's rows
    sce_prefetch._launch("sce_gather_dy_launch",
                         (x_b, y, idx_y, tgt_b, idx_y, lse_r, g_rep, ws, 0.0),
                         (N_B, B_X, B_Y, C_SERVE, D), dev)
    keys, order = sce_prefetch.dy_sum_keys(idx_y, idx_y, C_SERVE)
    dyz = torch.zeros_like(y)
    got = sce_prefetch.sce_gather_dy_sum(ws, keys, order, dyz)
    want = sce_prefetch.dy_sum_plain(ws, idx_y, idx_y, C_SERVE)
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-5 * want.abs().max().item()
    check(bool((err <= tol + 2e-4 * want.abs()).all()),
          f"sce_gather_dy_sum differs by {err.max().item():.3e}")
    sum_err = err.max().item()
    print(f"  case dy_sum_train_shape: {N_B * B_Y} slots into "
          f"{int(torch.unique(idx_y).numel())} catalog rows, max err "
          f"{sum_err:.3e} against index_add_ ok")

    # Times at the training shape, cold L2.
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    timings = {}
    for name, q, cat, k, vm in (("positions_k320", b, x, B_X, valid),
                                ("catalog_k256", b, y, B_Y, None)):
        def kernel():
            return mips_topk(q, cat, k, valid=vm)

        def plain():
            return mips_topk_ref(q, cat, k, valid=vm)

        def library():
            s_ = torch.matmul(q, cat.T)
            if vm is not None:
                s_ = torch.where(vm[None, :], s_, NEG_INF)
            return torch.topk(s_, k)

        bd, by = bound_ms(q.shape[0], cat.shape[0], D, k,
                          valid=vm is not None)
        timings[name] = {"ms": time_ms(kernel, 20, flush),
                         "plain_ms": time_ms(plain, 2, flush),
                         "library_ms": time_ms(library, 20, flush),
                         "bound_ms": bd, "bound_by": by}
        timings[name]["steps_ms"] = chain_steps(kernel, flush)
        print(f"  steps {name}: " + ", ".join(
            f"{s} {'not measured' if t is None else f'{t:.4f}'}"
            for s, t in timings[name]["steps_ms"].items()) + " ms")

    g_up = torch.rand(pos.shape, generator=g, device=dev)
    _, lse = sce_prefetch.sce_gather_fwd(x_b, y, idx_y, tgt_b, idx_y, pos)
    y_b = y[idx_y.long()]
    probs = torch.rand(N_B, B_X, B_Y, generator=g, device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y)]
    out = (ref.sce_gather_loss_ref(leaves[0], leaves[1], idx_y, tgt_b, idx_y,
                                   pos) * g_up).sum()
    args = (x_b, y, idx_y, tgt_b, idx_y)
    bias_main = torch.where((idx_y[:, None, :] < 0)
                            | (idx_y[:, None, :] == tgt_b[:, :, None]),
                            NEG_INF, 0.0)
    # A dY entry times its kernel alone, into the (n_b·b_y, d) workspace;
    # the wrapper (the kernel, the keys and sort, the zeroing and the sum)
    # is timed apart as wrapper_ms, and the sum has its own entry.
    ws_t = torch.empty(N_B * B_Y, D, device=dev)

    def dy_kernel(cat, ids, cand, lse_):
        sce_prefetch._launch(
            "sce_gather_dy_launch",
            (x_b, cat, ids, tgt_b, cand, lse_, g_up, ws_t, 0.0),
            (N_B, B_X, B_Y, cat.shape[0], D), dev)
        return ws_t

    def dy_rows_plain(cat, ids, cand, lse_):
        """The dY kernel's function in plain PyTorch: each slot's row,
        0 where masked."""
        cat_b = cat[ids.long().clamp(0, cat.shape[0] - 1)]
        hide = (cand[:, None, :] < 0) | (cand[:, None, :] == tgt_b[:, :, None])
        p = torch.where(hide, 0.0, torch.exp(
            torch.bmm(x_b, cat_b.transpose(1, 2)) - lse_[..., None])
            * g_up[..., None])
        return torch.bmm(p.transpose(1, 2), x_b).reshape(-1, D)

    runs = {
        "sce_gather_fwd": (  # library: the gather, then the whole function
            lambda: sce_prefetch.sce_gather_fwd(*args, pos),
            lambda: ref.sce_gather_loss_ref(*args, pos),
            lambda: whole_forward(x_b, y[idx_y.long()], bias_main, pos)),
        "sce_gather_dx": (
            lambda: sce_prefetch.sce_gather_dx(*args, lse, g_up),
            lambda: torch.autograd.grad(out, leaves[0], retain_graph=True),
            lambda: torch.bmm(probs, y_b)),
        "sce_gather_dy": (
            lambda: dy_kernel(y, idx_y, idx_y, lse),
            lambda: dy_rows_plain(y, idx_y, idx_y, lse),
            lambda: torch.bmm(probs.transpose(1, 2), x_b)),
    }
    wrappers = {"sce_gather_dy":
                lambda: sce_prefetch.sce_gather_dy(*args, lse, g_up)}
    bounds = gather_bounds(x_b, y, idx_y, tgt_b, idx_y)
    # The gathered dY's sum on the train shape's workspace; library: one
    # in-place index_add_ into a (C, d) buffer (its values do not matter
    # to the time; the kernel's caller zeroes dy apart, as here).
    lib_c = torch.zeros_like(y)
    sum_rows = idx_y.reshape(-1).long()
    runs["sce_gather_dy_sum"] = (
        lambda: sce_prefetch.sce_gather_dy_sum(ws, keys, order, dyz),
        lambda: sce_prefetch.dy_sum_plain(ws, idx_y, idx_y, C_SERVE),
        lambda: lib_c.index_add_(0, sum_rows, ws))
    bounds["sce_gather_dy_sum"] = dy_sum_bound(idx_y, idx_y, D)
    # The partial LSE on the main path's input (one card: every candidate
    # owned) and on the shard of 4. Library: bmm + logsumexp on the
    # pre-gathered rows, the mask folded in as baddbmm's additive input.
    for sfx, (cat, ids, cand) in (("", (y, idx_y, idx_y)),
                                  ("_shard4", (y_l, idx_l, cand_l))):
        pargs = (x_b, cat, ids, tgt_b, cand)
        plse = sce_prefetch.sce_gather_plse_fwd(*pargs)
        pleaves = [t.clone().requires_grad_(True) for t in (x_b, cat)]
        pout = (ref.sce_gather_plse_ref(pleaves[0], pleaves[1], *pargs[2:])
                * g_up).sum()
        cat_b = cat[ids.long()]
        bias = torch.where((cand[:, None, :] < 0)
                           | (cand[:, None, :] == tgt_b[:, :, None]),
                           NEG_INF, 0.0)
        pb = plse_bounds(*pargs)
        runs.update({
            f"sce_gather_plse_fwd{sfx}": (
                lambda a=pargs: sce_prefetch.sce_gather_plse_fwd(*a),
                lambda a=pargs: ref.sce_gather_plse_ref(*a),
                lambda yb=cat_b, bi=bias: torch.logsumexp(
                    torch.baddbmm(bi, x_b, yb.transpose(1, 2)), dim=-1)),
            f"sce_gather_plse_dx{sfx}": (
                lambda a=pargs, p=plse: sce_prefetch.sce_gather_plse_dx(
                    *a, p, g_up),
                lambda o=pout, lv=pleaves: torch.autograd.grad(
                    o, lv[0], retain_graph=True),
                lambda yb=cat_b: torch.bmm(probs, yb)),
            f"sce_gather_plse_dy{sfx}": (
                lambda a=pargs, p=plse: dy_kernel(a[1], a[2], a[4], p),
                lambda a=pargs, p=plse: dy_rows_plain(a[1], a[2], a[4], p),
                lambda: torch.bmm(probs.transpose(1, 2), x_b)),
        })
        wrappers[f"sce_gather_plse_dy{sfx}"] = (
            lambda a=pargs, p=plse: sce_prefetch.sce_gather_plse_dy(
                *a, p, g_up))
        bounds.update({k + sfx: v for k, v in pb.items()})
    # The composed PyTorch computation of dX and dY on the pre-gathered
    # candidates (the library call above is its second product alone):
    # the logits bmm, exp(l − lse)·g on the unmasked candidates, the
    # second bmm, and for dY index_add_ of the gathered rows into (C, d)
    # (the whole dY: compare it with wrapper_ms).
    masked = (idx_y[:, None, :] < 0) | (idx_y[:, None, :] == tgt_b[:, :, None])

    def composed(lse_, dy):
        p = torch.where(masked, 0.0, torch.exp(
            torch.bmm(x_b, y_b.transpose(1, 2)) - lse_[..., None])
            * g_up[..., None])
        if not dy:
            return torch.bmm(p, y_b)
        out = torch.zeros_like(y)
        return out.index_add_(0, idx_y.reshape(-1).long(), torch.bmm(
            p.transpose(1, 2), x_b).reshape(-1, D))

    plse_main = sce_prefetch.sce_gather_plse_fwd(x_b, y, idx_y, tgt_b, idx_y)
    composed_runs = {
        "sce_gather_dx": lambda: composed(lse, False),
        "sce_gather_dy": lambda: composed(lse, True),
        "sce_gather_plse_dx": lambda: composed(plse_main, False),
        "sce_gather_plse_dy": lambda: composed(plse_main, True),
    }
    with torch.no_grad():
        for name, (kern, plain, lib) in runs.items():
            timings[name] = {"ms": time_ms(kern, 20, flush),
                             "plain_ms": time_ms(plain, 5, flush),
                             "library_ms": time_ms(lib, 20, flush),
                             **bound_keys(bounds[name])}
            if name in composed_runs:
                timings[name]["composed_ms"] = time_ms(composed_runs[name],
                                                       20, flush)
            if name in wrappers:
                timings[name]["wrapper_ms"] = time_ms(wrappers[name], 20,
                                                      flush)
    timings["sce_gather_dy_sum"]["max_abs_err"] = sum_err
    sort_ms = time_ms(lambda: sce_prefetch.dy_sum_keys(idx_y, idx_y, C_SERVE),
                      20, flush)
    timings["sce_gather_dy_sum"]["sort_ms"] = sort_ms
    print(f"  time of the gathered dY's keys and stable sort (PyTorch glue, "
          f"{N_B * B_Y} slots): {sort_ms:.4f} ms")
    for name, t in timings.items():
        more = (f", composed {t['composed_ms']:.4f} ms" if "composed_ms" in t
                else "")
        if "wrapper_ms" in t:
            more += (f"; the wrapper (the kernel, keys and sort, zeroing, "
                     f"sum) {t['wrapper_ms']:.4f} ms")
        print(f"  time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms"
              f"{more}, bound {bound_text(t)}")
    return cases, gcases, pcases, timings


# ---------------------------------------------------------------------------
# The trainer at full width
# ---------------------------------------------------------------------------
TRAIN_STEPS = 30
EVAL_EVERY = 10


PHASES = ("h2d", "forward", "select", "loss_forward", "backward",
          "optimizer")
EVAL_PHASES = ("h2d", "forward", "sweep", "fold")


class StepMarks:
    """The ``mark`` hook of ``launch/train.py::train`` (``phases``
    ``PHASES``) and of ``eval/harness.py::evaluate_streaming``
    (``EVAL_PHASES``): a CUDA event where each phase of each step ends
    (``"start"`` opens a step), read after the run. The device timeline
    between two events includes any wait for the host to enqueue the
    next launch."""

    def __init__(self, phases=PHASES):
        self.phases = phases
        self.steps = []

    def __call__(self, name):
        import torch

        if name == "start":
            self.steps.append([])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1].append((name, ev))

    def breakdown(self, skip=1):
        """Mean ms of each phase over the steps after the first ``skip``."""
        sums = dict.fromkeys(self.phases, 0.0)
        for marks in self.steps[skip:]:
            names = [n for n, _ in marks]
            check(names == ["start", *self.phases], f"phase marks {names}")
            for (_, a), (name, b) in zip(marks, marks[1:]):
                sums[name] += a.elapsed_time(b)
        n = len(self.steps) - skip
        return {f"{k}_ms": v / n for k, v in sums.items()}


GATHER = ("sce_gather_fwd", "sce_gather_dx", "sce_gather_dy")
PLSE = ("sce_gather_plse_fwd", "sce_gather_plse_dx", "sce_gather_plse_dy")


def train_phase(dev, sce_mode, guard_policy=None, fresh=()):
    """The trainer at full width in ``sce_mode``: ``"gspmd"`` runs
    ``core/sce.py``'s loss through the three ``sce_gather`` launches,
    ``"exact"`` (the trainer's default) ``core/distributed_sce.py`` on the
    (1, 1) mesh through the three ``sce_gather_plse`` launches; each
    family is launched once a step and the other never.

    ``guard_policy`` is the kernel guard's policy for the run (``None``:
    the default, ``warn``). The verdicts of the groups in ``fresh`` are
    dropped first, so their canaries run at the first dispatch inside the
    run and must pass; their own launches (each verdict's count) are
    taken out before the main path's counts are checked. Under a policy
    other than ``off`` every step's sentinels must be zero; the loss cap
    is ``inf`` for the first 8 steps and finite from the 9th on."""
    import statistics

    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.core import sce
    from repro_torch.kernels import eval_fused, guard, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.train import train

    cfg = make_config()
    counters = (mips_topk, *(getattr(sce_prefetch, n) for n in GATHER + PLSE),
                sce_prefetch.sce_gather_dy_sum, eval_fused.eval_fused,
                eval_fused.eval_tgt_gather)
    marks = StepMarks()
    gc.collect()  # what earlier phases left in reference cycles
    torch.cuda.synchronize()
    live_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for group in fresh:
        guard.clear_verdicts(group)
    for fn in counters:  # the main path starts here
        fn.launches = 0
    mips_topk.launches_by_k.clear()
    t0 = time.monotonic()
    out = train("sasrec-sce", cfg=cfg, batch=N_POS // cfg.max_len,
                steps=TRAIN_STEPS, seed=0, sce_mode=sce_mode, log_every=10,
                eval_every=EVAL_EVERY, eval_users=EVAL_B[0], device=dev,
                guard_policy=guard_policy, mark=marks)
    wall_s = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in counters}  # ... ends here
    by_k = dict(mips_topk.launches_by_k)
    peak = torch.cuda.max_memory_allocated(dev)
    policy = guard.policy()
    guard.set_policy(None)
    run_verdicts = {v["kernel"]: v for v in guard.verdict_table()
                    if v["kernel"] in fresh}
    check(set(run_verdicts) == set(fresh),
          f"verdicts run in the trainer: {sorted(run_verdicts)}, not "
          f"{sorted(fresh)}")
    canary = {}
    for v in run_verdicts.values():
        check(v["passed"], f"{v['kernel']} failed its canaries in the "
              f"trainer: {v['failures']}")
        for name, n in v["launches"].items():
            canary[name] = canary.get(name, 0) + n
    launches = {k: n - canary.get(k, 0) for k, n in launches.items()}
    check(sum(n for k, n in by_k.items() if k not in (B_X, B_Y))
          == canary.get("mips_topk", 0), f"mips_topk by k {by_k}")
    by_k = {k: n for k, n in by_k.items() if k in (B_X, B_Y)}
    sentinels = out["sentinels"]
    if policy == "off":
        check(all(s_ == {} for s_ in sentinels), "sentinels under off")
    else:
        check(all(s_ == {"sce_bucket_nonfinite": 0} for s_ in sentinels),
              f"a sentinel tripped: {sentinels}")
    caps = out["loss_caps"]
    check(all(c == math.inf for c in caps[:8])
          and all(math.isfinite(c) for c in caps[8:]),
          f"loss caps {caps}")
    losses = out["losses"]
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} steps ran")
    check(all(math.isfinite(v) for v in losses), "a training loss is not "
          "finite")
    check(out["skipped_steps"] == 0, f"{out['skipped_steps']} steps skipped")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"mean loss of the last 5 steps {last:.5f} is not "
          f"below the first 5's {first:.5f}")
    check(launches["mips_topk"] == 2 * TRAIN_STEPS
          and by_k == {B_X: TRAIN_STEPS, B_Y: TRAIN_STEPS},
          f"mips_topk launched {launches['mips_topk']} times ({by_k} by k) "
          f"in {TRAIN_STEPS} steps")
    on = (PLSE if sce_mode == "exact" else GATHER) + ("sce_gather_dy_sum",)
    for name in GATHER + PLSE + ("sce_gather_dy_sum",):
        want = TRAIN_STEPS if name in on else 0
        check(launches[name] == want,
              f"{sce_mode}: {name} launched {launches[name]} times in "
              f"{TRAIN_STEPS} steps, not {want}")
    n_evals = TRAIN_STEPS // EVAL_EVERY
    for name in ("eval_fused", "eval_tgt_gather"):
        check(launches[name] == n_evals,
              f"{name} launched {launches[name]} times in {n_evals} "
              f"evaluations")
    check(set(out.get("eval", {})) == {f"{m}@{k}" for m in ("hr", "ndcg",
                                                           "cov")
                                       for k in KS}, "no eval metrics")
    median_ms = statistics.median(out["step_s"][1:]) * 1e3
    eval_s = wall_s - sum(out["step_s"])
    print(f"  trainer (sce_mode={sce_mode}): {TRAIN_STEPS} steps of batch "
          f"{N_POS // cfg.max_len} "
          f"× L {cfg.max_len}, C {cfg.catalog_loss_size}, in {wall_s:.2f} s; "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f} (mean of first 5 "
          f"{first:.4f}, last 5 {last:.4f}); median step {median_ms:.3f} ms "
          f"(host clock, steps 2–{TRAIN_STEPS}, evaluations excluded); "
          f"{n_evals} evaluations of {EVAL_B[0]} users and set-up "
          f"{eval_s:.2f} s (wall − Σ steps); launches {launches}, "
          f"mips_topk by k {by_k}; guard {policy}: verdicts run in the "
          f"trainer {sorted(run_verdicts)} (their canary launches {canary} "
          f"not counted above), "
          f"{'no sentinels' if policy == 'off' else 'sentinels zero'} every "
          f"step, loss cap inf for steps 1–8 and finite from step 9 "
          f"({caps[8]:.4g})")
    bd = marks.breakdown()
    print("  step breakdown: " + " + ".join(
        f"{p} {bd[p + '_ms']:.3f}" for p in PHASES)
        + f" = {sum(bd.values()):.3f} ms (device events of the trainer's "
        f"own steps, mean of steps 2–{TRAIN_STEPS})")
    sce_cfg = sce.SCEConfig.from_alpha_beta(N_POS, cfg.n_items)
    mem = {
        "peak_bytes": peak, "live_bytes_before": live_bytes,
        "sce_fused_peak_bytes": 4 * sce.sce_peak_elements(
            sce_cfg, N_POS, cfg.catalog_loss_size, cfg.d_model,
            fused=True)["total"],
        "sce_plain_peak_bytes": 4 * sce.sce_peak_elements(
            sce_cfg, N_POS, cfg.catalog_loss_size, cfg.d_model)["total"],
        "full_ce_logit_bytes": sce.full_ce_memory_bytes(
            N_POS, cfg.catalog_loss_size),
    }
    print(f"  peak device memory of the run: {peak / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated; params, AdamW state and "
          f"activations included; {live_bytes / 2**20:.1f} MiB were live "
          f"before it); SCE loss side, fused model "
          f"{mem['sce_fused_peak_bytes'] / 2**20:.2f} MiB, plain path "
          f"{mem['sce_plain_peak_bytes'] / 2**20:.1f} MiB; full CE logits "
          f"N·C·4 B = {mem['full_ce_logit_bytes'] / 1e9:.2f} GB")
    return {"sce_mode": sce_mode, "losses": losses, "step_s": out["step_s"],
            "wall_s": wall_s, "median_step_ms": median_ms,
            "launches": launches, "guard_policy": policy,
            "verdicts_in_run": sorted(run_verdicts),
            "canary_launches": canary, "loss_caps": caps,
            "eval": out["eval"], "eval_and_setup_s": eval_s,
            "mips_topk_launches_by_k": by_k, "breakdown": bd, "memory": mem}


def mode_agreement_phase(dev):
    """One full-width batch through the three SCE modes on one injected
    Ω: ``gspmd`` (``sce_loss``), and ``exact`` and ``union``
    (``sce_loss_sharded`` on the (1, 1) mesh, where both select what
    ``gspmd`` selects). Losses within ``1e-5·|loss|``, the gradients of x
    and y within ``1e-5·max|g|`` plus ``2e-4·|g|`` of ``gspmd``'s."""
    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.core.distributed_sce import sce_loss_sharded
    from repro_torch.core.sce import sce_loss
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_sce_config
    from repro_torch.launch.train import to_device
    from repro_torch.models import sasrec

    cfg = make_config()
    batch = N_POS // cfg.max_len
    params = sasrec.init_params(cfg, seed=0, device=dev)
    host, _ = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len,
        batch_size=batch)).next_batch(Cursor(seed=0))
    b = to_device(host, dev)
    with torch.no_grad():
        x = sasrec.forward(params, cfg, b["tokens"]).reshape(N_POS, -1)
        y = sasrec.loss_catalog(params, cfg).clone()
    t, valid = b["targets"].reshape(-1), b["valid"].reshape(-1)
    sce_cfg = build_sce_config(N_POS, cfg.n_items,
                               bucket_size_y=B_Y)
    omega = torch.randn((sce_cfg.n_buckets, N_POS), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    mesh = make_host_mesh(max_data=batch)
    check(mesh.shape == {"data": 1, "model": 1}, f"mesh {mesh.shape}")
    res = {}
    for mode in ("gspmd", "exact", "union"):
        xl, yl = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        if mode == "gspmd":
            loss = sce_loss(xl, yl, t, cfg=sce_cfg, valid_mask=valid,
                            omega=omega)
        else:
            loss = sce_loss_sharded(xl, yl, t, cfg=sce_cfg, mesh=mesh,
                                    valid_mask=valid, mode=mode, omega=omega)
        res[mode] = (loss.item(), *torch.autograd.grad(loss, (xl, yl)))
    torch.cuda.synchronize()
    want = res["gspmd"]
    errs = {}
    for mode in ("exact", "union"):
        got = res[mode]
        lerr = abs(got[0] - want[0])
        check(math.isfinite(got[0]) and lerr <= 1e-5 * abs(want[0]),
              f"{mode}: loss {got[0]} vs gspmd {want[0]}")
        errs[mode] = {"loss": lerr}
        for what, a, w in (("dx", got[1], want[1]), ("dy", got[2], want[2])):
            err = (a - w).abs()
            tol = 1e-5 * w.abs().max().item()
            check(bool(torch.isfinite(a).all()
                       and (err <= tol + 2e-4 * w.abs()).all()),
                  f"{mode}: {what} differs from gspmd by "
                  f"{err.max().item():.3e} (tol {tol:.3e} + 2e-4·|g|)")
            errs[mode][what] = err.max().item()
        print(f"  {mode} vs gspmd: loss {got[0]:.6f} vs {want[0]:.6f} "
              f"(|Δ| {lerr:.3e}), max |Δ| dX {errs[mode]['dx']:.3e}, dY "
              f"{errs[mode]['dy']:.3e} ok")
    return {"losses": {m: r[0] for m, r in res.items()}, "max_abs_err": errs}


# ---------------------------------------------------------------------------
# Eval kernels against their plain versions
# ---------------------------------------------------------------------------
def rank_band(x, y, t, ok, gid, tol):
    """Per row, the least and the most 0-based rank of the target that a
    dense f64 oracle allows when valid scores within ``tol`` of it may
    fall on either side (the target's own column left out); also the
    dense f64 scores, masked to NEG_INF off the valid columns."""
    import torch

    s64 = x.double() @ y.double().T
    c = y.shape[0]
    local = t.long() - int(gid[0])
    owned = (local >= 0) & (local < c)
    t64 = torch.where(owned, s64.gather(1, local.clamp(0, c - 1)[:, None])[:, 0],
                      0.0)
    other = ok[None, :] & (gid[None, :] != t[:, None])
    lo = ((s64 > t64[:, None] + tol) & other).sum(1)
    hi = ((s64 >= t64[:, None] - tol) & other).sum(1)
    return lo, hi, torch.where(ok[None, :], s64, NEG_INF)


def isolated_ids_agree(s64, ids, want_ids, k, gap):
    """Whether the ids agree wherever the dense f64 scores ``s64`` put
    the slot's value more than ``gap`` from both of its neighbours."""
    import torch

    top = torch.topk(s64, min(k + 1, s64.shape[1]), dim=1).values
    if top.shape[1] == k:
        top = torch.cat([top, torch.full_like(top[:, :1], NEG_INF)], 1)
    prv = torch.cat([torch.full_like(top[:, :1], float("inf")),
                     top[:, :k - 1]], 1)
    isolated = ((prv - top[:, :k]) > gap) & ((top[:, :k] - top[:, 1:]) > gap)
    return bool((ids == want_ids)[isolated].all())


def eval_case(name, x, y, t, k, *, c_lo, c_hi, id_offset=0, cap=None,
              with_lse=False, exact=False):
    """``eval_fused`` (and the ``eval_tgt_gather`` it calls) against the
    plain version on one input; returns the case's errors, raises on
    disagreement."""
    import torch

    from repro_torch.kernels import ops, ref

    kw = dict(c_lo=c_lo, c_hi=c_hi, id_offset=id_offset, logit_softcap=cap,
              with_lse=with_lse)
    vals, ids, gt, eq, tgt, m, s = ops.eval_fused(x, y, t, k, **kw)
    torch.cuda.synchronize()
    want = ref.eval_fused_ref(x, y, t, k, **kw)
    dev = x.device
    gid = id_offset + torch.arange(y.shape[0], device=dev)
    ok = (gid >= c_lo) & (gid < c_hi)
    scale = (x.double() @ y.double().T)[:, ok].abs().max().item()
    tol = 1e-5 * scale
    lo, hi, s64 = rank_band(x, y, t, ok, gid, tol)
    rank = gt + (eq - 1).clamp_min(0)
    check(bool(((rank >= lo) & (rank <= hi)).all()),
          f"{name}: a rank outside the f64 band")
    err = (vals - want[0]).abs().max().item()
    tgt_err = (tgt - want[4]).abs().max().item()
    if exact:
        for what, a, b in zip(("vals", "ids", "gt", "eq", "tgt"),
                              (vals, ids, gt, eq, tgt), want[:5]):
            check(torch.equal(a, b), f"{name}: {what} differ on exact inputs")
    else:
        check(err <= tol, f"{name}: values differ by {err} > {tol}")
        check(tgt_err <= tol, f"{name}: tgt differs by {tgt_err} > {tol}")
        check(isolated_ids_agree(s64, ids, want[1], k, 1e-4 * scale),
              f"{name}: isolated ids differ from the plain version")
    lse_err = 0.0
    if with_lse:
        lse, want_lse = m + torch.log(s), want[5] + torch.log(want[6])
        lse_err = ((lse - want_lse).abs()
                   / want_lse.abs().clamp_min(1e-6)).max().item()
        check(lse_err <= 1e-5, f"{name}: lse relative error {lse_err}")
    hit = ids == t[:, None]
    check(torch.equal(vals[hit], tgt[:, None].expand(-1, k)[hit]),
          f"{name}: a target in the top-k does not carry tgt bit for bit")
    lo_id, hi_id = max(c_lo, id_offset), min(c_hi, id_offset + y.shape[0])
    valid_t = (t >= lo_id) & (t < hi_id)
    check(bool((eq[valid_t] >= 1).all()), f"{name}: eq < 1 on a valid target")
    print(f"  case {name}: B={x.shape[0]} C={y.shape[0]} d={x.shape[1]} k={k} "
          f"window [{c_lo}, {c_hi}) id_offset={id_offset} lse={with_lse} "
          f"cap={cap} max_abs_err vals {err:.3e} tgt {tgt_err:.3e} lse rel "
          f"{lse_err:.3e} (tol {tol:.3e}) {'bitwise' if exact else 'banded'}"
          f"; {int(hit.any(1).sum())} targets in the top-k carry tgt "
          f"exactly; ranks in the f64 band ok")
    return {"name": name, "B": x.shape[0], "C": y.shape[0], "d": x.shape[1],
            "k": k, "with_lse": with_lse, "cap": cap, "exact": exact,
            "max_abs_err": err, "tgt_err": tgt_err, "lse_rel_err": lse_err,
            "tol": tol, "targets_in_topk": int(hit.any(1).sum())}


def eval_bounds(b, c, d, k, n_rows):
    """Least times on these inputs, both in 3xTF32 on the tensor cores (no
    LSE: no exps). eval_fused reads x, the catalog, the targets and
    thresholds once, writes (B, k) values and ids and the two counts, and
    does 2·B·C·d FLOPs; eval_tgt_gather reads x, the ``n_rows`` distinct
    target rows and the targets, writes (B,) scores, and does 2·B·d."""
    fused = tf32x3_bound(4 * (b * d + c * d + 2 * b) + 8 * b * k + 8 * b,
                         2 * b * c * d, 0)
    gather = tf32x3_bound(4 * (b * d + n_rows * d + b) + 4 * b, 2 * b * d, 0)
    return fused, gather


def eval_kernel_phase(dev):
    import torch

    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device=dev).to(torch.float32)

    def targets(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    # Full width: states like the final LayerNorm's, the catalog at its
    # init scale; 8 rows get their target planted at the top of the row.
    y = randn(C_SERVE, D, scale=0.02)
    cases, inputs = [], {}
    for b in EVAL_B:
        x = randn(b, D)
        t = targets(b, 1, N_ITEMS)
        y[t[:8].long()] = 0.05 * x[:8]
        inputs[b] = (x, t)
    window = dict(c_lo=1, c_hi=N_ITEMS)
    for b in EVAL_B:
        x, t = inputs[b]
        cases.append(eval_case(f"eval_b{b}", x, y, t, K, **window))
    x, t = inputs[EVAL_B[0]]
    cases.append(eval_case("eval_b128_lse", x, y, t, K, with_lse=True,
                           **window))
    cases.append(eval_case("eval_b128_lse_cap30", x, y, t, K, with_lse=True,
                           cap=30.0, **window))
    yi = randint(-2, 3, C_SERVE, D)
    xi = randint(-2, 3, EVAL_B[0], D)
    cases.append(eval_case("int_ties_b128_lse", xi, yi,
                           targets(EVAL_B[0], 1, N_ITEMS), K, with_lse=True,
                           exact=True, **window))
    cases.append(eval_case("int_ragged_offset_d33", randint(-2, 3, 40, 33),
                           randint(-2, 3, 1_037, 33),
                           targets(40, 1_003, 1_900), 17, c_lo=1_003,
                           c_hi=1_900, id_offset=1_000, cap=30.0,
                           with_lse=True, exact=True))
    cases.append(eval_case("int_k_gt_valid", randint(-2, 3, 9, D),
                           randint(-2, 3, 500, D), targets(9, 3, 9), 12,
                           c_lo=3, c_hi=9, with_lse=True, exact=True))
    xo = randn(24, D)
    to = targets(24, 5_000, 8_000)
    cases.append(eval_case("float_offset", xo, randn(3_000, D), to, K,
                           c_lo=5_001, c_hi=7_990, id_offset=5_000))

    # Times at the evaluation's shapes, cold L2.
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    window_mask = (torch.arange(C_SERVE, device=dev) >= 1) & \
        (torch.arange(C_SERVE, device=dev) < N_ITEMS)
    timings = {}
    for b in EVAL_B:
        x, t = inputs[b]
        tgt = ek.eval_tgt_gather(x, y, t)

        def fused():
            return ek.eval_fused(x, y, t, K, tgt_scores=tgt, **window)

        def fused_plain():
            return ref.eval_fused_ref(x, y, t, K, tgt_scores=tgt, **window)

        def fused_library():
            s_ = torch.where(window_mask[None, :], torch.matmul(x, y.T),
                             NEG_INF)
            return (torch.topk(s_, K), (s_ > tgt[:, None]).sum(1),
                    (s_ == tgt[:, None]).sum(1))

        def gather():
            return ek.eval_tgt_gather(x, y, t)

        def gather_plain():
            return ref.eval_tgt_gather_ref(x, y, t)

        def gather_library():
            return (x * y[t.long()]).sum(-1)

        bf, bg = eval_bounds(b, C_SERVE, D, K,
                             int(torch.unique(t).numel()))
        timings[b] = {
            "eval_fused": {"ms": time_ms(fused, 50, flush),
                           "plain_ms": time_ms(fused_plain, 3, flush),
                           "library_ms": time_ms(fused_library, 50, flush),
                           "bound_ms": bf[0], "bound_by": bf[1]},
            "eval_tgt_gather": {"ms": time_ms(gather, 50, flush),
                                "plain_ms": time_ms(gather_plain, 20, flush),
                                "library_ms": time_ms(gather_library, 50,
                                                      flush),
                                "bound_ms": bg[0], "bound_by": bg[1]},
        }
        for name, tt in timings[b].items():
            print(f"  time {name} B={b}: kernel {tt['ms']:.4f} ms, plain "
                  f"{tt['plain_ms']:.3f} ms, library {tt['library_ms']:.4f} "
                  f"ms, bound {tt['bound_ms']:.4f} ms ({tt['bound_by']})")
    return cases, timings


# ---------------------------------------------------------------------------
# The evaluation at full width
# ---------------------------------------------------------------------------
N_EVAL_BATCHES = 8


def dense_cloze_scores(params, cfg, batch):
    """BERT4Rec's dense leave-one-out oracle (``core/metrics.py``'s
    ``dense_scores`` is SASRec's): keep the sequences with at least 2
    real items, put [MASK] on the held-out last item, and score the whole
    catalog ``Y (n_items, d)`` at that position; the padding id 0 scores
    ``-inf``. → ``(scores (B', n_items), host targets)``."""
    import numpy as np
    import torch

    from repro_torch.models import bert4rec

    tokens = np.asarray(batch["tokens"])
    tokens = tokens[(tokens != 0).sum(axis=1) >= 2]
    targets = tokens[:, -1].copy()
    masked = tokens.copy()
    masked[:, -1] = bert4rec.mask_token_id(cfg)
    dev = params["item_emb"].device
    with torch.no_grad():
        hidden = bert4rec.forward(params, cfg,
                                  torch.from_numpy(masked).to(dev))
        scores = hidden[:, -1] @ bert4rec.item_embeddings(params, cfg).T
    scores[:, 0] = -torch.inf
    return scores, targets


def eval_phase(dev, arch="sasrec-sce"):
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import metrics
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.eval import (
        MetricAccumulator,
        default_score_fn,
        evaluate_streaming,
        ranks_from_counts,
        streaming_eval_scores,
    )
    from repro_torch.eval.harness import _keep_and_targets
    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels.mips_topk import sweep_plan

    cfg = get_arch(arch).make_config()
    b = EVAL_B[1]
    params = encoder(cfg).init_params(cfg, seed=0, device=dev)
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=b,
    ))
    batches = [data.eval_batch(Cursor(seed=0, step=i))[0]
               for i in range(N_EVAL_BATCHES)]
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counters = (ek.eval_fused, ek.eval_tgt_gather)
    for fn in counters:  # the main path starts here
        fn.launches = 0
    acc = MetricAccumulator(KS, cfg.n_items)
    marks = StepMarks(EVAL_PHASES)
    batch_ms = []
    t0 = time.monotonic()
    for batch in batches:
        t1 = time.perf_counter()
        evaluate_streaming(params, cfg, batch, ks=KS, accumulator=acc,
                           mark=marks)
        batch_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in counters}  # ... ends here
    peak = torch.cuda.max_memory_allocated(dev)
    streamed = acc.result()
    for name, n in launches.items():
        check(n == N_EVAL_BATCHES, f"{name} launched {n} times in "
              f"{N_EVAL_BATCHES} evaluations")

    # The dense on-card oracle, and both sets of ranks against the band.
    dense_acc = MetricAccumulator(KS, cfg.n_items)
    score_fn = default_score_fn(cfg)
    dense_scores = (metrics.dense_scores if cfg.causal
                    else dense_cloze_scores)
    n_amb = n_users = n_same = 0
    tols = []
    for batch in batches:
        scores, tg = dense_scores(params, cfg, batch)
        dense_rank = metrics.rank_of_target(scores, tg)
        top = torch.sort(scores, dim=1, descending=True,
                         stable=True).indices[:, :max(KS)]
        dense_acc.update(dense_rank, top)
        tokens, targets = _keep_and_targets(batch["tokens"])
        t = torch.from_numpy(targets.astype(np.int32)).to(dev)
        with torch.no_grad():
            x, catalog = score_fn(params, torch.from_numpy(tokens).to(dev))
            _, _, gt, eq, _, _, _ = streaming_eval_scores(
                x, catalog, t, max(KS), c_lo=1, c_hi=cfg.n_items)
        gid = torch.arange(catalog.shape[0], device=dev)
        ok = (gid >= 1) & (gid < cfg.n_items)
        tol = 1e-5 * (x.double() @ catalog.double().T)[:, ok].abs().max()
        lo, hi, _ = rank_band(x, catalog, t, ok, gid, tol.item())
        streamed_rank = torch.from_numpy(ranks_from_counts(gt, eq)).to(dev)
        for what, r in (("streamed", streamed_rank), ("dense", dense_rank)):
            check(bool(((r >= lo) & (r <= hi)).all()),
                  f"{what} rank outside the f64 band")
        n_same += int((streamed_rank == dense_rank).sum())
        n_amb += int((lo != hi).sum())
        n_users += len(targets)
        tols.append(tol.item())
    dense = dense_acc.result()
    breakdown = marks.breakdown()
    print(f"  one evaluation of {b} users: {statistics.median(batch_ms[1:]):.3f}"
          f" ms median host clock (batches 2–{N_EVAL_BATCHES}; first "
          f"{batch_ms[0]:.3f}) = " + " + ".join(
              f"{p} {breakdown[p + '_ms']:.3f}" for p in EVAL_PHASES)
          + f" = {sum(breakdown.values()):.3f} ms (device events of "
          f"evaluate_streaming's own phases, mean of batches "
          f"2–{N_EVAL_BATCHES})")
    for k in KS:
        for m in ("hr", "ndcg"):
            diff = abs(streamed[f"{m}@{k}"] - dense[f"{m}@{k}"])
            check(diff <= n_amb / n_users + 1e-12,
                  f"{m}@{k} streamed {streamed[f'{m}@{k}']} vs dense "
                  f"{dense[f'{m}@{k}']} with {n_amb} ambiguous ranks")
    dense_bytes = 4 * b * cfg.n_items
    pl = sweep_plan(b, cfg.catalog_loss_size, cfg.d_model, max(KS),
                    torch.cuda.get_device_properties(dev)
                    .multi_processor_count)
    scratch_bytes = b * pl.n_split * (8 * max(KS) + 8) + 4 * b
    print(f"  evaluation ({arch}): {N_EVAL_BATCHES} batches of {b} users × L "
          f"{cfg.max_len}, C {cfg.catalog_loss_size}, in {wall_s:.3f} s "
          f"({n_users} users, {n_users / wall_s:.0f} users/s, host clock); "
          f"launches {launches}; {n_amb} ranks the f64 band leaves open "
          f"(tol ≤ {max(tols):.3e}); {n_same} of {n_users} streamed ranks "
          f"equal the dense oracle's")
    print("  metric    streamed    dense")
    for key in streamed:
        print(f"  {key:8s} {streamed[key]:.6f}  {dense[key]:.6f}")
    print(f"  peak device memory of the streaming evaluation: "
          f"{(peak - live) / 2**20:.1f} MiB above the {live / 2**20:.1f} MiB "
          f"live before it (torch.cuda.max_memory_allocated; the "
          f"forward's activations included); eval_fused's split scratch "
          f"B·S·(8k + 8) + 4·B B = {scratch_bytes / 2**20:.2f} MiB (S = "
          f"{pl.n_split}); dense scores B·C·4 B = {dense_bytes / 2**20:.1f} "
          f"MiB per batch")
    return {"arch": arch, "batches": N_EVAL_BATCHES, "batch": b,
            "users": n_users,
            "wall_s": wall_s, "launches": launches, "streamed": streamed,
            "dense": dense, "ambiguous_ranks": n_amb,
            "ranks_equal_to_dense": n_same, "scratch_bytes": scratch_bytes,
            "peak_bytes_above_live": peak - live, "live_bytes": live,
            "dense_score_bytes": dense_bytes, "batch_ms": batch_ms,
            "breakdown": breakdown}


# ---------------------------------------------------------------------------
# Full-CE kernels against their plain versions
# ---------------------------------------------------------------------------
CE_KERNELS = (  # (wrapper, family, output, the TPU kernel it replaces)
    ("linear_ce_fwd", "linear", "fwd", "src/repro/kernels/linear_sce.py:60"),
    ("linear_ce_dx", "linear", "dx", "src/repro/kernels/linear_sce.py:121"),
    ("linear_ce_dw", "linear", "dw", "src/repro/kernels/linear_sce.py:154"),
    ("fused_lse_fwd", "fused", "fwd", "src/repro/kernels/fused_ce.py:34"),
    ("fused_lse_dx", "fused", "dx", "src/repro/kernels/fused_ce.py:69"),
    ("fused_lse_dy", "fused", "dw", "src/repro/kernels/fused_ce.py:102"),
)


def ce_calls(x, w, t, g, lse, cap, planes):
    """Per kernel of ``CE_KERNELS``: ``(kernel call, plain call)`` on these
    inputs; the backward kernels and their plain versions take the same
    ``lse``, the kernels the split ``planes`` of ``x`` and ``w`` (as the
    autograd forward hands them over). ``linear_ce_fwd`` returns
    ``(loss, lse)``, its plain version the loss."""
    from repro_torch.kernels import fused_ce, linear_sce, ref

    kw = dict(logit_softcap=cap)
    bwd = (x, w, t, lse, g)
    return {
        "linear_ce_fwd": (lambda: linear_sce.linear_ce_fwd(x, w, t, **kw,
                                                           planes=planes),
                          lambda: ref.linear_ce_loss_ref(x, w, t, **kw)),
        "linear_ce_dx": (lambda: linear_sce.linear_ce_dx(*bwd, **kw,
                                                         planes=planes),
                         lambda: ref.linear_ce_dx_ref(*bwd, **kw)),
        "linear_ce_dw": (lambda: linear_sce.linear_ce_dw(*bwd, **kw,
                                                         planes=planes),
                         lambda: ref.linear_ce_dw_ref(*bwd, **kw)),
        "fused_lse_fwd": (lambda: fused_ce.fused_lse_fwd(x, w,
                                                         planes=planes),
                          lambda: ref.fused_lse_ref(x, w)),
        "fused_lse_dx": (lambda: fused_ce.fused_lse_dx(x, w, lse, g,
                                                       planes=planes),
                         lambda: ref.linear_ce_dx_ref(x, w, None, lse, g)),
        "fused_lse_dy": (lambda: fused_ce.fused_lse_dy(x, w, lse, g,
                                                       planes=planes),
                         lambda: ref.linear_ce_dw_ref(x, w, None, lse, g)),
    }


def split_calls(x, w):
    """``linear_ce_split`` and its plain version on ``x`` and ``w``."""
    from repro_torch.kernels import linear_sce, ref

    return (lambda: linear_sce.linear_ce_split(x, w),
            lambda: (ref.tf32x3_planes_ref(x), ref.tf32x3_planes_ref(w)))


def ce_case(name, x, w, t, g, *, cap=None):
    """The six full-CE kernels against their plain versions on one input
    (the fused family without the cap, which it does not take), on the
    split kernel's planes, which must equal the plain split bit for bit.
    Values within ``1e-5·max|want|``, gradients within ``1e-5·max|grad|``
    plus ``2e-4·|grad|`` (f32 exp sums fold in another order; the products
    in 3xTF32); rows with a zero cotangent get dX exactly 0. Returns the
    max errors."""
    import torch

    from repro_torch.kernels import ref

    errs = {}
    split, split_plain = split_calls(x, w)
    planes = split()
    for got, want in zip(planes, split_plain()):
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"{name}: linear_ce_split's planes differ from the plain "
              f"version's bits")
    errs["linear_ce_split"] = 0.0
    for family, c_ in (("linear", cap), ("fused", None)):
        lse = ref.fused_lse_ref(x, w, logit_softcap=c_)
        calls = ce_calls(x, w, t, g, lse, c_, planes)
        for kname, fam, what, _ in CE_KERNELS:
            if fam != family:
                continue
            kern, plain = calls[kname]
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if kname == "linear_ce_fwd":
                got_lse, got = got[1], got[0]
                err = (got_lse - lse).abs().max().item()
                check(err <= 1e-5 * lse.abs().max().item(),
                      f"{name}: {kname} lse differs by {err:.3e}")
            rtol = 0.0 if what == "fwd" else 2e-4
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"{name}: {kname} shape or finiteness")
            err = (got - want).abs()
            tol = 1e-5 * want.abs().max().item()
            check(bool((err <= tol + rtol * want.abs()).all()),
                  f"{name}: {kname} differs by {err.max().item():.3e} (tol "
                  f"{tol:.3e} + {rtol}·|want|)")
            if what == "dx":
                check(bool((got[g == 0] == 0).all()),
                      f"{name}: {kname} row with a zero cotangent is not 0")
            errs[kname] = err.max().item()
    n, d = x.shape
    print(f"  case {name}: N={n} C={w.shape[0]} d={d} cap={cap} "
          f"{int((g == 0).sum())} zero-cotangent rows, "
          f"{n - int(torch.unique(t).numel())} repeated targets; max err "
          + " ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " ok")
    return {"name": name, "N": n, "C": w.shape[0], "d": d, "cap": cap,
            "max_abs_err": errs}


def sm_clock_hz():
    """The card's top SM clock (``nvidia-smi clocks.max.sm``)."""
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def ce_bounds(n, c, d):
    """Least times of the full-CE kernels at (N, C, d): each reads x and w
    once (the linear family also the targets), the backward kernels the
    lse and g; each writes its outputs once (loss and lse; lse; dX; dW).
    The forward does 2·N·C·d FLOPs of logits; dX and dW/dY recompute them
    and take a product of the same size, 4·N·C·d FLOPs. All run in 3xTF32
    on the tensor cores: a bound is the largest of three TF32 passes at
    the dense TF32 rate, the N·C exps (no cap) at the SFU rate of the
    card's SMs at its top clock, and the bytes; the f32 FMA bound of the
    same FLOPs stands beside it (``f32_ms``). The split kernel reads x and
    w and writes their planes (two floats per depth, d rounded up to 16):
    bytes. Returns name → ``(ms, "bytes" | "operations", basis,
    f32_ms)``."""
    common = 4 * (n * d + c * d)
    flops = 2 * n * c * d
    out = {}
    for kname, family, what, _ in CE_KERNELS:
        tgt = 4 * n if family == "linear" else 0
        if what == "fwd":
            work = flops
            nbytes = common + tgt + (8 if family == "linear" else 4) * n
        else:
            work = 2 * flops
            written = 4 * (n if what == "dx" else c) * d
            nbytes = common + tgt + 8 * n + written
        out[kname] = tf32x3_bound(nbytes, work, n * c)
    dp = -(-d // 16) * 16
    ms = (common + 8 * (n + c) * dp) / PEAK_BYTES_S * 1e3
    out["linear_ce_split"] = (ms, "bytes", "bytes", ms)
    return out


def ce_kernel_phase(dev):
    import torch

    from repro_torch.kernels import linear_sce, ref

    # The guard's preflight plans the kernels' shared memory with
    # linear_sce.fwd_plan and bwd_plan, copies of the library's plans:
    # hold them equal.
    for d in range(1, linear_sce.MAX_D + 1):
        mine, lib = linear_sce.fwd_plan(d), linear_sce.library_fwd_plan(d)
        check(mine == lib, f"linear_ce forward plan at d={d}: wrapper "
              f"{mine}, library {lib}")
        for dw in (False, True):
            mine = linear_sce.bwd_plan(d, dw)
            lib = linear_sce.library_bwd_plan(d, dw)
            check(mine == lib, f"linear_ce backward plan at d={d} dw={dw}: "
                  f"wrapper {mine}, library {lib}")
    print("  linear_ce forward and backward plans: the wrapper's copies "
          "equal the library's at every d <= 256")

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=dev).to(torch.float32)

    def targets(n, c):
        return torch.randint(0, c, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def cotangent(n):
        return torch.rand(n, generator=gen, device=dev) + 0.5

    # The trainer's shape: hidden states at unit scale, the catalog at a
    # scale that puts the logits near unit variance.
    x = randn(N_POS, D)
    w = randn(C_SERVE, D, scale=0.125)
    t = targets(N_POS, N_ITEMS)
    g = cotangent(N_POS)
    cases = [ce_case("train_shape", x, w, t, g)]
    # cap 30 past its knee, half the targets on the last (ragged: C % 64
    # = 16) catalog row, every third cotangent 0
    t2 = t.clone()
    t2[: N_POS // 2] = C_SERVE - 1
    g2 = g.clone()
    g2[::3] = 0.0
    cases.append(ce_case("train_shape_cap30_dup_zero", 8.0 * x, w, t2, g2,
                         cap=30.0))
    cases.append(ce_case("int_ragged_d33", randint(-2, 3, 1_000, 33),
                         randint(-2, 3, 5_003, 33), targets(1_000, 5_003),
                         cotangent(1_000)))
    ti = targets(300, 3_001)
    ti[:100] = 7
    cases.append(ce_case("int_cap30_d200_dup", randint(-2, 3, 300, 200),
                         randint(-2, 3, 3_001, 200), ti, cotangent(300),
                         cap=30.0))

    # Times at the trainer's shape, cold L2; the library calls hold the
    # (N, C) f32 logits (17.8 GB) and their softmax. The kernels take the
    # planes of one split, timed on its own.
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    lse = ref.fused_lse_ref(x, w)
    split, split_plain = split_calls(x, w)
    calls = ce_calls(x, w, t, g, lse, None, split())
    calls["linear_ce_split"] = (split, split_plain)
    library = {
        "fwd": lambda: torch.logsumexp(x @ w.T, -1),
        "dx": lambda: torch.softmax(x @ w.T, -1) @ w,
        "dw": lambda: torch.softmax(x @ w.T, -1).T @ x,
    }
    bounds = ce_bounds(N_POS, C_SERVE, D)
    timings = {}
    with torch.no_grad():
        for kname, what in [(k, w_) for k, _, w_, _ in CE_KERNELS] + [
                ("linear_ce_split", None)]:
            kern, plain = calls[kname]
            ms, by, basis, f32_ms = bounds[kname]
            timings[kname] = {
                "ms": time_ms(kern, 5, flush),
                "plain_ms": time_ms(plain, 2, flush),
                "library_ms": (None if what is None
                               else time_ms(library[what], 3, flush)),
                "bound_ms": ms, "bound_by": by, "bound_basis": basis,
                "bound_f32_ms": f32_ms,
            }
            tt = timings[kname]
            lib_ms = ("none" if tt["library_ms"] is None
                      else f"{tt['library_ms']:.4f} ms")
            f32 = "" if what is None else f"; as f32 FMAs {f32_ms:.4f} ms"
            print(f"  time {kname}: kernel {tt['ms']:.4f} ms, plain "
                  f"{tt['plain_ms']:.3f} ms, library {lib_ms}, bound "
                  f"{tt['bound_ms']:.4f} ms ({tt['bound_by']}: {basis}"
                  f"{f32})")
    del flush
    torch.cuda.empty_cache()
    return cases, timings


# ---------------------------------------------------------------------------
# The trainer with the competitor losses at full width
# ---------------------------------------------------------------------------
KERNEL_LOSS_STEPS = 20
OTHER_LOSS_STEPS = 3
LOSS_PHASES = ("h2d", "forward", "loss_forward", "backward", "optimizer")
OTHER_LOSSES = ("ce", "ce_chunked", "bce", "bce_plus", "gbce", "ce_minus",
                "ce_inbatch", "ce_pop", "rece")
# The dense `ce` step holds the (N, C) f32 logits, their softmax gradient
# and the gather's scatter: at batch 128 (17.8 GB of logits) it does not
# fit on an H100 80GB (one more 16.55 GiB allocation with 66.8 GiB held),
# so it runs at batch 64.
DENSE_CE_BATCH = 64


def loss_run(dev, cfg, name, steps, batch):
    """``steps`` steps of ``make_seqrec_train_step`` with ``train_loss``
    set to ``name`` (``dataclasses.replace`` of the arch, as a user would),
    from random weights (seed 0) on ``Cursor(seed=0)``'s batches, with the
    loss at its ``make_loss`` defaults as ``_vocab_loss`` calls it."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.launch.steps import make_seqrec_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.models import sasrec

    arch = dataclasses.replace(get_arch("sasrec-sce"), train_loss=name)
    step_fn, (opt_init, _), _ = make_seqrec_train_step(
        arch, cfg, ShapeSpec("train_paper", "train", {"batch": batch}))
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=batch))
    params = sasrec.init_params(cfg, seed=0, device=dev)
    opt_state = opt_init(params)
    gen = torch.Generator(device=dev).manual_seed(0)
    cursor = Cursor(seed=0)
    marks = StepMarks(LOSS_PHASES)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s, skipped = [], [], 0
    for _ in range(steps):
        t0 = time.perf_counter()
        host, cursor = data.next_batch(cursor)
        marks("start")
        dev_batch = to_device(host, dev)
        marks("h2d")
        params, opt_state, m = step_fn(params, opt_state, dev_batch,
                                       generator=gen, mark=marks)
        losses.append(float(m["loss"]))
        skipped += bool(m["skipped"])
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    del params, opt_state
    torch.cuda.empty_cache()
    check(all(math.isfinite(v) for v in losses), f"{name}: a loss is not "
          f"finite")
    check(skipped == 0, f"{name}: {skipped} steps skipped")
    return {"loss": name, "batch": batch, "steps": steps, "losses": losses,
            "step_s": step_s,
            "median_step_ms": statistics.median(step_s[1:]) * 1e3,
            "peak_bytes": peak, "live_bytes_before": live,
            "breakdown": marks.breakdown()}


def loss_phase(dev, trainers):
    import statistics

    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.core import sce
    from repro_torch.core.losses import loss_peak_elements
    from repro_torch.kernels import fused_ce, linear_sce

    cfg = make_config()
    batch = N_POS // cfg.max_len
    counters = {k: getattr(linear_sce if k.startswith("linear") else fused_ce,
                           k) for k, *_ in CE_KERNELS}
    counters["linear_ce_split"] = linear_sce.linear_ce_split
    for fn in counters.values():  # the main path starts here
        fn.launches = 0
    runs, seen = [], dict.fromkeys(counters, 0)
    for name in ("ce_fused_linear", "ce_fused"):
        r = loss_run(dev, cfg, name, KERNEL_LOSS_STEPS, batch)
        first = statistics.mean(r["losses"][:5])
        last = statistics.mean(r["losses"][-5:])
        check(last < first, f"{name}: mean loss of the last 5 steps "
              f"{last:.5f} is not below the first 5's {first:.5f}")
        moved = {k: fn.launches - seen[k] for k, fn in counters.items()}
        family = "linear" if name == "ce_fused_linear" else "fused"
        for kname, fam, *_ in CE_KERNELS + (("linear_ce_split", family),):
            want = KERNEL_LOSS_STEPS if fam == family else 0
            check(moved[kname] == want, f"{name}: {kname} launched "
                  f"{moved[kname]} times in {KERNEL_LOSS_STEPS} steps")
        seen = {k: fn.launches for k, fn in counters.items()}
        bd = r["breakdown"]
        print(f"  {name}: {KERNEL_LOSS_STEPS} steps of batch {batch}, loss "
              f"{r['losses'][0]:.4f} → {r['losses'][-1]:.4f} (mean of first "
              f"5 {first:.4f}, last 5 {last:.4f}); step breakdown "
              + " + ".join(f"{p} {bd[p + '_ms']:.3f}" for p in LOSS_PHASES)
              + f" = {sum(bd.values()):.3f} ms (device events, mean of "
              f"steps 2–{KERNEL_LOSS_STEPS}); launches {moved}")
        runs.append(r)
    for name in OTHER_LOSSES:
        runs.append(loss_run(dev, cfg, name, OTHER_LOSS_STEPS,
                             DENSE_CE_BATCH if name == "ce" else batch))
    launches = {k: fn.launches for k, fn in counters.items()}  # ... ends here
    check(launches == seen, f"a competitor loss launched a CE kernel: "
          f"{launches} after {seen}")

    n, c, d = N_POS, cfg.catalog_loss_size, cfg.d_model
    sce_cfg = sce.SCEConfig.from_alpha_beta(n, cfg.n_items, use_kernel=True)
    print(f"  loss             batch steps  median step ms  peak MiB "
          f"(above live)  loss_peak_elements MiB (×4 B)")
    rows = [{"loss": f"sce {t['sce_mode']} (ph. {ph})", "batch": batch,
             "steps": TRAIN_STEPS,
             "median_step_ms": t["median_step_ms"],
             "peak_bytes": t["memory"]["peak_bytes"],
             "live_bytes_before": t["memory"]["live_bytes_before"],
             "model_elements": loss_peak_elements("sce", n, c, d,
                                                  cfg=sce_cfg)}
            for t, ph in zip(trainers, (7, 8))]
    for r in runs:
        rows.append(dict(r, model_elements=loss_peak_elements(
            r["loss"], r["batch"] * cfg.max_len, c, d)))
    for r in rows:
        print(f"  {r['loss']:16s} {r['batch']:5d} {r['steps']:5d} "
              f"{r['median_step_ms']:14.3f}  {r['peak_bytes'] / 2**20:9.1f} "
              f"({(r['peak_bytes'] - r['live_bytes_before']) / 2**20:9.1f})"
              f"  {4 * r['model_elements'] / 2**20:12.1f}")
    print(f"  (median step: host clock, steps after the first; peak: "
          f"torch.cuda.max_memory_allocated over the run, params, AdamW "
          f"state and activations included; SCE's from phases 7–8, their "
          f"evaluations included; ce at batch {DENSE_CE_BATCH}: at 128 its "
          f"(N, C) logits and their gradients do not fit the card)")
    return {"runs": runs, "table": rows, "launches": launches}


# ---------------------------------------------------------------------------
# The kernel guard: conformance on the card
# ---------------------------------------------------------------------------
def conformance_phase(dev):
    """``run_conformance(refresh=True)`` on the card: the 12 canaries of
    the 7 kernel groups, each kernel against its plain version. The
    canaries are the one path that runs rows 6, 7, 10 and 11 (the two
    SCE-bucket and two two-pass eval kernels); their launches are read
    from counts set to 0 just before. The verdicts stay memoized, so the
    later phases' dispatches consult them without running canaries."""
    import torch

    from repro_torch.kernels import guard
    from repro_torch.kernels.guard.conformance import (
        launch_counts,
        reset_launch_counts,
    )

    guard.set_policy(None)
    reset_launch_counts()  # the main path starts here
    t0 = time.monotonic()
    verdicts = guard.run_conformance(device=dev, refresh=True)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = launch_counts()  # ... and ends here
    n_pass = 0
    for name, v in sorted(verdicts.items()):
        print(f"  verdict {name}: {'PASS' if v.passed else 'FAIL'} "
              f"{v.n_pass}/{v.n_pass + v.n_fail} on {v.device}; launches "
              f"{dict(v.launches)}")
        check(v.passed, f"conformance of {name} failed on the card: "
              f"{'; '.join(v.failures)}")
        n_pass += v.n_pass
    check(n_pass == 12 and len(verdicts) == 7,
          f"{n_pass} canaries over {len(verdicts)} groups, not 12 over 7")
    for name in GUARD_KERNELS:
        check(launches[name] > 0, f"{name} not launched by the canaries")
    print(f"  conformance: 12 canaries over 7 groups passed in "
          f"{wall_s:.3f} s (wall, first launches of every kernel included)")
    return {"wall_s": wall_s, "verdicts": guard.verdict_table(),
            "launches": {k: v for k, v in launches.items() if v}}


# The kernels only the guard's canaries run (PERF.md rows 6, 7, 10, 11):
# name → (source, the TPU kernel it replaces).
GUARD_KERNELS = {
    "sce_bucket_fwd": ("sce_gather.cu", "sce_bucket.py:40"),
    "sce_bucket_dx": ("sce_gather.cu", "sce_bucket.py:160"),
    "sce_bucket_dy": ("sce_gather.cu", "sce_bucket.py:209"),
    "sce_bucket_plse_fwd": ("sce_gather.cu", "sce_bucket.py:108"),
    "eval_topk": ("eval_fused.cu", "eval_topk.py:57"),
    "eval_tgt_scores": ("eval_fused.cu", "eval_topk.py:121"),
}


def bucket_case(name, x_b, y_b, tgt, cand, pos, cap=None):
    """The sce_bucket kernels (forward, dX, dY, and the partial LSE with
    the same dX and dY launches) against autograd through the plain
    versions on one input; dY must repeat bit for bit. Returns the case's
    max errors; raises on disagreement."""
    import torch

    from repro_torch.kernels import ref, sce_bucket

    g = torch.rand(pos.shape, device=pos.device,
                   generator=torch.Generator(device=pos.device).manual_seed(7))
    errs = {}

    def hold(what, a, b, rtol):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{name}: {what} shape or finiteness")
        err = (a - b).abs()
        tol = 1e-5 * b.abs().max().item()
        check(bool((err <= tol + rtol * b.abs()).all()),
              f"{name}: {what} differs by {err.max().item():.3e} "
              f"(tol {tol:.3e} + {rtol}·|want|)")
        errs[what] = err.max().item()

    got_l = [t.clone().requires_grad_(True) for t in (x_b, y_b, pos)]
    loss = sce_bucket.sce_bucket_loss(got_l[0], got_l[1], tgt, cand,
                                      got_l[2], logit_softcap=cap)
    got = [loss.detach()] + list(torch.autograd.grad((loss * g).sum(), got_l))
    want_l = [t.clone().requires_grad_(True) for t in (x_b, y_b, pos)]
    wloss = ref.sce_bucket_loss_ref(want_l[0], want_l[1], tgt, cand,
                                    want_l[2], cap)
    want = [wloss.detach()] + list(torch.autograd.grad((wloss * g).sum(),
                                                       want_l))
    torch.cuda.synchronize()
    for what, a, b, rtol in zip(("loss", "dx", "dy", "dpos"), got, want,
                                (0.0, 2e-4, 2e-4, 2e-4)):
        hold(what, a, b, rtol)
    check(bool((got[2][cand < 0] == 0).all()),
          f"{name}: a masked candidate's dY row is not exactly 0")
    _, lse = sce_bucket.sce_bucket_fwd(x_b, y_b, tgt, cand, pos,
                                       logit_softcap=cap)
    d1 = sce_bucket.sce_bucket_dy(x_b, y_b, tgt, cand, lse, g,
                                  logit_softcap=cap)
    d2 = sce_bucket.sce_bucket_dy(x_b, y_b, tgt, cand, lse, g,
                                  logit_softcap=cap)
    check(torch.equal(d1, d2), f"{name}: two dY launches differ")
    got_l = [t.clone().requires_grad_(True) for t in (x_b, y_b)]
    plse = sce_bucket.sce_bucket_plse(got_l[0], got_l[1], tgt, cand,
                                      logit_softcap=cap)
    got = [plse.detach()] + list(torch.autograd.grad((plse * g).sum(), got_l))
    want_l = [t.clone().requires_grad_(True) for t in (x_b, y_b)]
    wplse = ref.sce_bucket_plse_ref(want_l[0], want_l[1], tgt, cand, cap)
    want = [wplse.detach()] + list(torch.autograd.grad((wplse * g).sum(),
                                                       want_l))
    torch.cuda.synchronize()
    for what, a, b, rtol in zip(("plse", "plse_dx", "plse_dy"), got, want,
                                (0.0, 2e-4, 2e-4)):
        hold(what, a, b, rtol)
    n_b, b_x, d = x_b.shape
    print(f"  case {name}: n_b={n_b} b_x={b_x} b_y={y_b.shape[1]} d={d} "
          f"cap={cap} max err " + " ".join(f"{k} {v:.3e}"
                                          for k, v in errs.items())
          + "; dY bit-equal across two launches ok")
    return {"name": name, "n_b": n_b, "b_x": b_x, "b_y": y_b.shape[1],
            "d": d, "cap": cap, "max_abs_err": errs,
            "dy_bitwise_repeat": True}


def bucket_bounds(x_b, y_b, tgt, cand):
    """Least times on these inputs, as :func:`gather_bounds`: each launch
    reads x_b, the pre-gathered y_b, the ids and its per-row inputs once
    and writes its outputs once; the forward does 2·n_b·b_x·b_y·d FLOPs,
    dX and dY twice that, all in 3xTF32 with an exp per unmasked pair."""
    n_b, b_x, d = x_b.shape
    b_y = y_b.shape[1]
    common = 4 * (n_b * b_x * d + n_b * b_y * d + n_b * b_y + n_b * b_x)
    flops = 2 * n_b * b_x * b_y * d
    exps = unmasked_pairs(tgt, cand)
    return {
        "sce_bucket_fwd": tf32x3_bound(common + 4 * 3 * n_b * b_x, flops,
                                       exps),
        "sce_bucket_plse_fwd": tf32x3_bound(common + 4 * n_b * b_x, flops,
                                            exps),
        "sce_bucket_dx": tf32x3_bound(
            common + 4 * 2 * n_b * b_x + 4 * n_b * b_x * d, 2 * flops, exps),
        "sce_bucket_dy": tf32x3_bound(
            common + 4 * 2 * n_b * b_x + 4 * n_b * b_y * d, 2 * flops, exps),
    }


def topk_case(name, x, y, t, k, *, c_lo, c_hi, id_offset=0):
    """``eval_tgt_scores`` then ``eval_topk`` against the plain versions
    on one input; the threshold must be bit for bit the swept column
    (``eq >= 1`` on every valid target). Raises on disagreement."""
    import torch

    from repro_torch.kernels import eval_topk as tk
    from repro_torch.kernels import ref

    ts = tk.eval_tgt_scores(x, y, t, id_offset=id_offset)
    vals, ids, gt, eq = tk.eval_topk(x, y, ts, k, c_lo=c_lo, c_hi=c_hi,
                                     id_offset=id_offset)
    torch.cuda.synchronize()
    ts_want = ref.eval_tgt_scores_ref(x, y, t, id_offset=id_offset)
    want = ref.eval_topk_ref(x, y, ts_want, k, c_lo=c_lo, c_hi=c_hi,
                             id_offset=id_offset)
    gid = id_offset + torch.arange(y.shape[0], device=x.device)
    ok = (gid >= c_lo) & (gid < c_hi)
    s64 = x.double() @ y.double().T
    scale = s64[:, ok].abs().max().item()
    tol = 1e-5 * scale
    ts_err = (ts - ts_want).abs().max().item()
    err = (vals - want[0]).abs().max().item()
    check(ts_err <= tol, f"{name}: tgt_scores differ by {ts_err} > {tol}")
    check(err <= tol, f"{name}: values differ by {err} > {tol}")
    t64 = ts.double()[:, None]
    lo = ((s64 > t64 + tol) & ok[None, :]).sum(1)
    hi = ((s64 >= t64 - tol) & ok[None, :]).sum(1)
    check(bool(((gt >= lo) & (gt + eq <= hi)).all()),
          f"{name}: gt/eq outside the f64 band")
    check(isolated_ids_agree(torch.where(ok[None, :], s64, NEG_INF), ids,
                             want[1], k, 1e-4 * scale),
          f"{name}: isolated ids differ from the plain version")
    valid_t = (t >= max(c_lo, id_offset)) & (t < min(c_hi, id_offset
                                                     + y.shape[0]))
    check(bool((eq[valid_t] >= 1).all()),
          f"{name}: eval_tgt_scores is not bitwise eval_topk's column")
    hit = ids == t[:, None]
    check(torch.equal(vals[hit], ts[:, None].expand(-1, k)[hit]),
          f"{name}: a target in the top-k does not carry its score exactly")
    print(f"  case {name}: B={x.shape[0]} C={y.shape[0]} k={k} window "
          f"[{c_lo}, {c_hi}) id_offset={id_offset} max_abs_err vals "
          f"{err:.3e} tgt_scores {ts_err:.3e} (tol {tol:.3e}); eq >= 1 on "
          f"{int(valid_t.sum())} valid targets (bitwise column) ok")
    return {"name": name, "B": x.shape[0], "C": y.shape[0], "k": k,
            "max_abs_err": err, "tgt_err": ts_err, "tol": tol,
            "bitwise_column_rows": int(valid_t.sum())}


def guard_kernel_phase(dev):
    """Rows 6, 7, 10 and 11 against their plain versions at the
    full-width shapes, then their times with a cold L2."""
    import torch

    from repro_torch.kernels import eval_topk as tk
    from repro_torch.kernels import ref, sce_bucket

    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    # The training shape with y_b gathered from the catalog: each bucket
    # 256 distinct catalog rows, a collision in slot 0 and a padding slot.
    x = randn(N_POS, D)
    y = randn(C_SERVE, D, scale=0.125)
    targets = torch.randint(1, N_ITEMS, (N_POS,), generator=g, device=dev,
                            dtype=torch.int32)
    idx_x = torch.stack([torch.randperm(N_POS, generator=g,
                                        device=dev)[:B_X]
                         for _ in range(N_B)])
    idx_y = torch.stack([torch.randperm(C_SERVE, generator=g,
                                        device=dev)[:B_Y]
                         for _ in range(N_B)]).to(torch.int32)
    x_b = x[idx_x].contiguous()
    tgt_b = targets[idx_x].contiguous()
    y_b = y[idx_y.long()].contiguous()
    cand = idx_y.clone()
    cand[:, 0] = tgt_b[:, 0]
    cand[:, -1] = -1
    pos = torch.einsum("nxd,nxd->nx", x_b, y[tgt_b.long()]).contiguous()
    bcases = [bucket_case("bucket_train_shape", x_b, y_b, tgt_b, cand, pos)]
    pos30 = (30.0 * torch.tanh(pos * 8.0 / 30.0)).contiguous()
    bcases.append(bucket_case("bucket_train_shape_cap30", x_b * 8.0, y_b,
                              tgt_b, cand, pos30, cap=30.0))

    # The two-pass evaluation at the evaluation's shapes.
    ye = randn(C_SERVE, D, scale=0.02)
    window = dict(c_lo=1, c_hi=N_ITEMS)
    inputs = {}
    for b in EVAL_B:
        xe = randn(b, D)
        te = torch.randint(1, N_ITEMS, (b,), generator=g, device=dev,
                           dtype=torch.int32)
        ye[te[:8].long()] = 0.05 * xe[:8]
        inputs[b] = (xe, te)
    tcases = [topk_case(f"two_pass_b{b}", inputs[b][0], ye, inputs[b][1], K,
                        **window) for b in EVAL_B]
    c_l = C_SERVE // SHARDS
    xo, to = randn(64, D), torch.randint(c_l - 500, 2 * c_l + 500, (64,),
                                         generator=g, device=dev,
                                         dtype=torch.int32)
    tcases.append(topk_case("two_pass_shard1_offset", xo, ye[c_l:2 * c_l],
                            to, K, c_lo=c_l, c_hi=2 * c_l, id_offset=c_l))

    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    g_up = torch.rand(pos.shape, generator=g, device=dev)
    _, lse = sce_bucket.sce_bucket_fwd(x_b, y_b, tgt_b, cand, pos)
    probs = torch.rand(N_B, B_X, B_Y, generator=g, device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y_b)]
    out = (ref.sce_bucket_loss_ref(leaves[0], leaves[1], tgt_b, cand, pos)
           * g_up).sum()
    pleaves = [t.clone().requires_grad_(True) for t in (x_b, y_b)]
    args = (x_b, y_b, tgt_b, cand)
    bias = torch.where((cand[:, None, :] < 0)
                       | (cand[:, None, :] == tgt_b[:, :, None]),
                       NEG_INF, 0.0)
    runs = {
        "sce_bucket_fwd": (
            lambda: sce_bucket.sce_bucket_fwd(*args, pos),
            lambda: ref.sce_bucket_loss_ref(*args, pos),
            lambda: whole_forward(x_b, y_b, bias, pos)),
        "sce_bucket_dx": (
            lambda: sce_bucket.sce_bucket_dx(*args, lse, g_up),
            lambda: torch.autograd.grad(out, leaves[0], retain_graph=True),
            lambda: torch.bmm(probs, y_b)),
        "sce_bucket_dy": (
            lambda: sce_bucket.sce_bucket_dy(*args, lse, g_up),
            lambda: torch.autograd.grad(out, leaves[1], retain_graph=True),
            lambda: torch.bmm(probs.transpose(1, 2), x_b)),
        "sce_bucket_plse_fwd": (
            lambda: sce_bucket.sce_bucket_plse_fwd(*args),
            lambda: ref.sce_bucket_plse_ref(pleaves[0], pleaves[1], tgt_b,
                                            cand),
            lambda: torch.logsumexp(torch.baddbmm(
                bias, x_b, y_b.transpose(1, 2)), dim=-1)),
    }
    bounds = bucket_bounds(x_b, y_b, tgt_b, cand)
    window_mask = (torch.arange(C_SERVE, device=dev) >= 1) & \
        (torch.arange(C_SERVE, device=dev) < N_ITEMS)
    for b in EVAL_B:
        xe, te = inputs[b]
        ts = tk.eval_tgt_scores(xe, ye, te)
        sfx = "" if b == EVAL_B[1] else f"_b{b}"

        def library(xe=xe, ts=ts):
            s_ = torch.where(window_mask[None, :], torch.matmul(xe, ye.T),
                             NEG_INF)
            return (torch.topk(s_, K), (s_ > ts[:, None]).sum(1),
                    (s_ == ts[:, None]).sum(1))

        runs[f"eval_topk{sfx}"] = (
            lambda xe=xe, ts=ts: tk.eval_topk(xe, ye, ts, K, **window),
            lambda xe=xe, ts=ts: ref.eval_topk_ref(xe, ye, ts, K, **window),
            library)
        runs[f"eval_tgt_scores{sfx}"] = (
            lambda xe=xe, te=te: tk.eval_tgt_scores(xe, ye, te),
            lambda xe=xe, te=te: ref.eval_tgt_scores_ref(xe, ye, te),
            lambda xe=xe, te=te: (xe * ye[te.long()]).sum(-1))
        fused, gather = eval_bounds(b, C_SERVE, D, K,
                                    int(torch.unique(te).numel()))
        bounds[f"eval_topk{sfx}"] = fused
        bounds[f"eval_tgt_scores{sfx}"] = gather
    timings = {}
    with torch.no_grad():
        for name, (kern, plain, lib) in runs.items():
            heavy = name.startswith("eval_topk")
            timings[name] = {"ms": time_ms(kern, 20, flush),
                             "plain_ms": time_ms(plain, 2 if heavy else 5,
                                                 flush),
                             "library_ms": time_ms(lib, 20, flush),
                             **bound_keys(bounds[name])}
    for name, t in timings.items():
        print(f"  time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {bound_text(t)}")
    return bcases, tcases, timings


# ---------------------------------------------------------------------------
# Drills: the divergence guard and a broken kernel
# ---------------------------------------------------------------------------
CHAOS_AT = 5
# The checkpointed runs of phases 16–17: 12 steps, saves at steps 3, 7, 11.
CKPT_STEPS = 12
CKPT_EVERY = 4


def rollback_drill(dev, cfg):
    """The divergence drill with checkpoints: NaN params at step 5,
    strikes at steps 5 and 6, and at step 7 the rollback to the verified
    step 3 (saves every 4 steps), then steps 4–11 again on the reseeded
    stream: one rollback, a finite final loss, no NaN in any checkpoint."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import guard
    from repro_torch.launch.train import train
    from repro_torch.optim.optimizers import tree_leaves

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(buf):
            out = train("sasrec-sce", cfg=cfg, batch=N_POS // cfg.max_len,
                        steps=CKPT_STEPS, seed=0, log_every=0, device=dev,
                        sce_mode="gspmd", ckpt_dir=tmp,
                        ckpt_every=CKPT_EVERY, keep_n=0, max_strikes=3,
                        chaos_nan_at=CHAOS_AT, guard_policy="strict")
        guard.set_policy(None)
        mgr = CheckpointManager(tmp)
        saved = mgr.all_steps()
        finite = all(bool(np.isfinite(a).all()) for s_ in saved
                     for a in tree_leaves(mgr.restore_params(s_)))
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  | {line}")
    strikes = [ln for ln in lines if ln.startswith("[guard] step")]
    check(len(strikes) == 3 and all(
        ln.startswith(f"[guard] step {CHAOS_AT + i}: loss nan")
        and f"(strike {i + 1}/3)" in ln and "sce_bucket_nonfinite" in ln
        for i, ln in enumerate(strikes)), f"strike lines {strikes}")
    back = f"[guard] rolled back to verified step {CKPT_EVERY - 1} "
    check(sum(ln.startswith(back) for ln in lines) == 1,
          "no rollback line to the verified step")
    check(out["rollbacks"] == 1 and out["skipped_steps"] == 3,
          f"rollbacks {out['rollbacks']}, skipped {out['skipped_steps']}")
    check(out["steps"] == (CHAOS_AT + 3) + (CKPT_STEPS - CKPT_EVERY),
          f"{out['steps']} steps run")
    check(math.isfinite(out["final_loss"]), "the final loss is not finite")
    check(finite and saved == [3, 7, 11], f"checkpoints {saved} (finite: "
          f"{finite})")
    print(f"  rollback drill: strikes at steps {CHAOS_AT}–{CHAOS_AT + 1}, "
          f"rollback at step {CHAOS_AT + 2} to the verified step "
          f"{CKPT_EVERY - 1}, {out['steps']} steps run, rollbacks "
          f"{out['rollbacks']}, final loss {out['final_loss']:.4f}, "
          f"checkpoints {saved} all finite ok")
    return {"rollbacks": out["rollbacks"], "steps": out["steps"],
            "skipped_steps": out["skipped_steps"],
            "final_loss": out["final_loss"], "strike_lines": strikes,
            "checkpoints": saved}


def drill_phase(dev):
    """The divergence drill at full width (NaN params at step 5: strikes
    at steps 5 and 6, the RuntimeError at step 7, each strike line naming
    the sentinel), the same with checkpoints (``rollback_drill``: the
    rollback to step 3) and the broken-kernel drill (a ``mips_topk`` that
    raises: under ``warn`` its CUDA dispatch raises
    ``KernelConformanceError``, and a fresh server stays not ready)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.kernels import guard, ops
    from repro_torch.kernels import mips_topk as mips_mod
    from repro_torch.launch.serve import RetrievalServer, ServerNotReadyError
    from repro_torch.launch.train import train

    cfg = make_config()
    buf = io.StringIO()
    raised = None
    with contextlib.redirect_stdout(buf):
        try:
            train("sasrec-sce", cfg=cfg, batch=N_POS // cfg.max_len,
                  steps=CHAOS_AT + 6, seed=0, log_every=0, device=dev,
                  chaos_nan_at=CHAOS_AT, guard_policy="strict")
        except RuntimeError as e:  # the drill's expected outcome
            raised = e
    guard.set_policy(None)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  | {line}")
    check(raised is not None, "the divergence drill did not raise")
    check(f"at step {CHAOS_AT + 2} and no --ckpt-dir" in str(raised),
          f"the divergence drill raised {raised!r}")
    strikes = [ln for ln in lines if ln.startswith("[guard] step")]
    check(len(strikes) == 3 and all(
        ln.startswith(f"[guard] step {CHAOS_AT + i}: loss nan")
        and f"(strike {i + 1}/3)" in ln and "sce_bucket_nonfinite" in ln
        for i, ln in enumerate(strikes)), f"strike lines {strikes}")
    print(f"  divergence drill: RuntimeError({raised}) after 3 strike lines "
          f"naming sce_bucket_nonfinite ok")
    rollback = rollback_drill(dev, cfg)

    def broken(*a, **k):
        raise RuntimeError("injected miscompile")

    real = mips_mod.mips_topk
    mips_mod.mips_topk = broken
    guard.clear_verdicts("mips_topk")
    guard.set_policy("warn")
    try:
        q = torch.randn(8, D, device=dev)
        err = None
        try:
            ops.mips_topk(q, torch.randn(1_000, D, device=dev), K)
        except guard.KernelConformanceError as e:  # the drill's outcome
            err = e
        check(err is not None and err.kernel == "mips_topk",
              "a broken mips_topk did not raise under warn")
        server = RetrievalServer("sasrec-sce", buckets=(8,), top_k=K,
                                 device=dev)
        try:
            not_ready = None
            try:
                server.submit(np.ones(server.cfg.max_len, np.int32))
            except ServerNotReadyError as e:  # the drill's outcome
                not_ready = e
            check(not server.ready and not_ready is not None
                  and "mips_topk" in (server.readiness_error or ""),
                  "a server on a broken mips_topk became ready")
            health = server.health()
        finally:
            server.close()
    finally:
        mips_mod.mips_topk = real
        guard.clear_verdicts("mips_topk")
        guard.set_policy(None)
    check(guard.verdict_for("mips_topk", device=dev).passed,
          "mips_topk fails its canaries after the drill")
    print(f"  broken-kernel drill: KernelConformanceError under warn "
          f"({str(err)[:80]}...); fresh server not ready "
          f"(ready={health['ready']}, readiness_error set) ok")
    return {"divergence_error": str(raised), "strike_lines": strikes,
            "rollback": rollback, "broken_kernel_error": str(err),
            "server_ready": health["ready"],
            "readiness_error": health["readiness_error"]}


# ---------------------------------------------------------------------------
# Checkpoints at full width
# ---------------------------------------------------------------------------
PREEMPT_AT = 5
SERVE_HISTORIES = 40
CKPT_BUCKETS = (8, 32)
# The CLI's save interval, over three saves (steps 19, 39, 59).
SPARSE_EVERY = 20
SPARSE_STEPS = 60


class StartClock:
    """A ``mark`` hook that takes the host clock at each step's
    ``"start"``: the gaps are whole loop iterations, a save's host
    snapshot and any wait for the previous writer included (the trainer's
    own ``step_s`` ends before its save)."""

    def __init__(self):
        self.t = []

    def __call__(self, name):
        if name == "start":
            self.t.append(time.perf_counter())

    def gaps_ms(self):
        return [(b - a) * 1e3 for a, b in zip(self.t, self.t[1:])]


def ckpt_phase(dev):
    """The trainer that checkpoints, and the server on its checkpoint, at
    full width (``sce_mode="gspmd"``, batch 128, seed 0, saves every 4
    steps into a temporary directory).

    The main path, counted from 0: a straight run of 12 steps (saves at
    steps 3, 7, 11), then ``RetrievalServer(ckpt_dir=)`` on it answering
    40 histories. Then the drills, each held to the straight run's losses
    bit for bit: 6 steps and a relaunch to 12 (resumed from step 3);
    ``step_11/leaves.npz`` truncated and a byte of ``step_7``'s manifest
    flipped, and a relaunch (two ``falling back`` warnings, resumed from
    step 3); SIGTERM at step 5's ``"start"`` mark (step 5 completes, a
    final blocking save, ``preempt_step`` 5) and a relaunch (resumed from
    step 5). The server's answers equal a ``params=`` server's on the same
    restored params bit for bit and differ from a random server's. The
    same resume once in ``sce_mode="exact"`` under ``strict``, printed,
    not required. Prints the checkpoint's bytes, a non-blocking save's
    host snapshot and writer seconds, a restore's seconds, and the median
    step with and without ``ckpt_dir``, and a run of 60 steps at the
    CLI's ``ckpt_every=20`` (its loop iterations, the saving ones, and
    the steps its writer overlaps against those it does not), each beside
    the card."""
    import contextlib
    import io
    import os
    import signal
    import statistics
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.kernels import guard, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.serve import RetrievalServer
    from repro_torch.launch.train import train
    from repro_torch.optim.optimizers import tree_leaves

    cfg = make_config()
    card = smi()
    kw = dict(cfg=cfg, batch=N_POS // cfg.max_len, seed=0, log_every=0,
              device=dev, ckpt_every=CKPT_EVERY, keep_n=0)

    def run(steps, ckpt_dir, sce_mode="gspmd", **extra):
        """``train`` with its output captured and echoed → (result,
        stdout, stderr)."""
        out_buf, err_buf = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out_buf), \
                contextlib.redirect_stderr(err_buf):
            out = train("sasrec-sce", steps=steps, ckpt_dir=ckpt_dir,
                        sce_mode=sce_mode, **{**kw, **extra})
        for line in (out_buf.getvalue() + err_buf.getvalue()).splitlines():
            print(f"  | {line}")
        return out, out_buf.getvalue(), err_buf.getvalue()

    hist = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len,
        batch_size=SERVE_HISTORIES)).next_batch(Cursor(seed=1))[0]["tokens"]
    counters = (mips_topk, *(getattr(sce_prefetch, n) for n in GATHER + PLSE),
                sce_prefetch.sce_gather_dy_sum)
    serve_kw = dict(cfg=cfg, buckets=CKPT_BUCKETS, top_k=K, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        straight_dir = os.path.join(tmp, "straight")
        clock = StartClock()
        for fn in counters:  # the main path starts here
            fn.launches = 0
        mips_topk.launches_by_k.clear()
        straight, _, _ = run(CKPT_STEPS, straight_dir, mark=clock)
        server = RetrievalServer("sasrec-sce", ckpt_dir=straight_dir,
                                 **serve_kw)
        try:
            vals, ids = server.score(hist)
        finally:
            server.close()
        launches = {fn.__name__: fn.launches for fn in counters}
        by_k = dict(mips_topk.launches_by_k)  # ... ends here
        losses = straight["losses"]
        check(len(losses) == CKPT_STEPS and straight["skipped_steps"] == 0
              and all(math.isfinite(v) for v in losses),
              f"the straight run: {straight['steps']} steps, "
              f"{straight['skipped_steps']} skipped")
        check(CheckpointManager(straight_dir).all_steps() == [3, 7, 11],
              "the straight run's checkpoints")
        check(by_k.get(B_X) == CKPT_STEPS and by_k.get(B_Y) == CKPT_STEPS
              and by_k.get(K, 0) >= 1 and sum(by_k.values())
              == launches["mips_topk"], f"mips_topk launches by k {by_k}")
        for name in GATHER + PLSE + ("sce_gather_dy_sum",):
            want = 0 if name in PLSE else CKPT_STEPS
            check(launches[name] == want, f"{name} launched "
                  f"{launches[name]} times on the checkpoint path, not "
                  f"{want}")

        # The server on the checkpoint against one on the same params.
        check(server.restored_step == CKPT_STEPS - 1,
              f"the server restored step {server.restored_step}")
        step, params = CheckpointManager(
            straight_dir).restore_params_latest(device=dev)
        same = RetrievalServer("sasrec-sce", params=params, **serve_kw)
        rand = RetrievalServer("sasrec-sce", seed=0, **serve_kw)
        try:
            same_vals, same_ids = same.score(hist)
            rand_ids = rand.score(hist)[1]
        finally:
            same.close()
            rand.close()
        check(step == CKPT_STEPS - 1 and np.array_equal(vals, same_vals)
              and np.array_equal(ids, same_ids),
              "the checkpoint server's answers differ from the params= "
              "server's")
        check(not np.array_equal(ids, rand_ids),
              "the checkpoint server answers as a random one")
        check(bool(((ids >= 1) & (ids < cfg.n_items)).all()),
              "an id outside [1, n_items) was served")
        print(f"  server on the checkpoint: restored_step "
              f"{server.restored_step}; {SERVE_HISTORIES} histories' top-"
              f"{K} equal to the params= server's bit for bit, not the "
              f"random server's ok; main path launches {launches}, "
              f"mips_topk by k {by_k}")

        # Resume: 6 steps, then a relaunch to 12 in the same directory.
        resume_dir = os.path.join(tmp, "resume")
        first, _, _ = run(6, resume_dir)
        resumed, text, _ = run(CKPT_STEPS, resume_dir)
        check(first["losses"] == losses[:6],
              "6 steps from scratch left the straight curve")
        check(f"[restore] resumed from step {CKPT_EVERY - 1}" in text,
              "the relaunch did not resume from step 3")
        check(resumed["losses"] == losses[CKPT_EVERY:],
              f"the resumed losses {resumed['losses']} are not the "
              f"straight run's {losses[CKPT_EVERY:]} bit for bit")
        print(f"  resume: 6 steps, relaunch to {CKPT_STEPS} resumed from "
              f"step {CKPT_EVERY - 1}; losses of steps {CKPT_EVERY}–"
              f"{CKPT_STEPS - 1} equal the straight run's bit for bit ok")

        # Corruption: the two newest checkpoints, two ways.
        p = os.path.join(resume_dir, "step_11", "leaves.npz")
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)
        p = os.path.join(resume_dir, "step_7", "manifest.json")
        with open(p, "rb") as f:
            raw = bytearray(f.read())
        raw[len(raw) // 2] ^= 0xFF
        with open(p, "wb") as f:
            f.write(bytes(raw))
        again, text, err = run(CKPT_STEPS, resume_dir)
        check(err.count("falling back") == 2,
              f"{err.count('falling back')} fall-back warnings, not 2")
        check(f"[restore] resumed from step {CKPT_EVERY - 1}" in text,
              "the relaunch past two corrupt steps did not resume from 3")
        check(again["losses"] == losses[CKPT_EVERY:],
              "the relaunch past the corrupt steps left the straight curve")
        print("  corruption: step_11's payload truncated, step_7's "
              "manifest flipped; two fall-back warnings, resumed from step "
              "3, losses equal the straight run's bit for bit ok")

        # Preemption: SIGTERM while step 5 is in flight.
        pre_dir = os.path.join(tmp, "preempt")
        starts = []

        def sigterm_at(name):
            if name == "start":
                starts.append(name)
                if len(starts) == PREEMPT_AT + 1:
                    os.kill(os.getpid(), signal.SIGTERM)

        before = signal.getsignal(signal.SIGTERM)
        pre, text, _ = run(CKPT_STEPS, pre_dir, mark=sigterm_at)
        check(signal.getsignal(signal.SIGTERM) == before,
              "the SIGTERM handler was not restored")
        check(pre.get("preempted") and pre["preempt_step"] == PREEMPT_AT
              and pre["steps"] == PREEMPT_AT + 1,
              f"preempted {pre.get('preempted')} at step "
              f"{pre.get('preempt_step')} after {pre['steps']} steps")
        check(CheckpointManager(pre_dir).all_steps() == [3, PREEMPT_AT],
              "the drain's blocking save is missing")
        check(pre["losses"] == losses[:PREEMPT_AT + 1],
              "the preempted run left the straight curve")
        relaunch, text, _ = run(CKPT_STEPS, pre_dir)
        check(f"[restore] resumed from step {PREEMPT_AT}" in text,
              "the relaunch after SIGTERM did not resume from step 5")
        check(relaunch["losses"] == losses[PREEMPT_AT + 1:],
              "the relaunch after SIGTERM left the straight curve")
        print(f"  preemption: SIGTERM at step {PREEMPT_AT}'s start, step "
              f"{PREEMPT_AT} completed, the drain saved step {PREEMPT_AT}; "
              f"the relaunch resumed from it and ends on the straight "
              f"curve bit for bit ok")

        # The same resume in sce_mode="exact" under strict: printed.
        ex_dir, ex_dir2 = (os.path.join(tmp, n) for n in ("ex1", "ex2"))
        try:
            ex, _, _ = run(CKPT_STEPS, ex_dir, "exact",
                           guard_policy="strict")
            run(6, ex_dir2, "exact", guard_policy="strict")
            ex_res, _, _ = run(CKPT_STEPS, ex_dir2, "exact",
                               guard_policy="strict")
        finally:
            guard.set_policy(None)
        ex_want = ex["losses"][CKPT_EVERY:]
        exact_equal = ex_res["losses"] == ex_want
        exact_gap = max(abs(a - b) for a, b in zip(ex_res["losses"],
                                                   ex_want))
        print(f"  exact under strict: the resumed losses equal the straight "
              f"run's bit for bit: {exact_equal} (largest gap "
              f"{exact_gap!r}) — measured, not required")

        # The numbers: bytes, snapshot, writer, restore, steps.
        step_dir = os.path.join(straight_dir, "step_11")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        n_params = sum(p_.numel() for p_ in tree_leaves(params))
        mgr = CheckpointManager(straight_dir)
        restore_s, snapshot_s, write_s = [], [], []
        timing = CheckpointManager(os.path.join(tmp, "timing"), keep_n=1)
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree = mgr.restore(CKPT_STEPS - 1, device=dev)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t0)
            timing.save(i, tree, blocking=False)
            snapshot_s.append(timing.last_snapshot_s)
            timing.wait()
            write_s.append(timing.last_write_s)
            del tree
        check(mgr.unverified_loads == 0 and timing.unverified_loads == 0,
              "an unverified load")
        plain_clock = StartClock()
        plain, _, _ = run(CKPT_STEPS, None, mark=plain_clock)
        check(plain["losses"] == losses, "the run without ckpt_dir left the "
              "straight curve")
        # The CLI's save interval: does each write end before the next
        # save, and which steps does the writer slow?
        sparse_clock = StartClock()
        sparse, _, _ = run(SPARSE_STEPS, os.path.join(tmp, "sparse"),
                           mark=sparse_clock, ckpt_every=SPARSE_EVERY)
        check(sparse["steps"] == SPARSE_STEPS
              and sparse["skipped_steps"] == 0
              and sparse["losses"][:CKPT_STEPS] == losses
              and all(math.isfinite(v) for v in sparse["losses"]),
              f"the run saving every {SPARSE_EVERY} steps left the straight "
              f"curve or skipped steps")

    def med(xs):
        return statistics.median(xs)

    steps_ms = {
        "with_ckpt_step_ms": med(straight["step_s"][1:]) * 1e3,
        "without_ckpt_step_ms": med(plain["step_s"][1:]) * 1e3,
        "with_ckpt_iteration_ms": med(clock.gaps_ms()[1:]),
        "without_ckpt_iteration_ms": med(plain_clock.gaps_ms()[1:]),
        "with_ckpt_iteration_mean_ms": statistics.mean(clock.gaps_ms()[1:]),
        "without_ckpt_iteration_mean_ms": statistics.mean(
            plain_clock.gaps_ms()[1:]),
        "with_ckpt_save_iterations_ms": [clock.gaps_ms()[s_] for s_ in
                                         (CKPT_EVERY - 1,
                                          2 * CKPT_EVERY - 1)],
    }
    # Saves at SPARSE_EVERY - 1, 2 · SPARSE_EVERY - 1, ...; a gap i is step
    # i's iteration, its save included. The steps 1–4 after a save overlap
    # its writer (≈ 0.3 s); the steps 15–19 after it come once it is done.
    saves = range(SPARSE_EVERY - 1, SPARSE_STEPS - 1, SPARSE_EVERY)
    gaps = sparse_clock.gaps_ms()
    sparse_s = sparse["step_s"]
    sparse_ms = {
        "every": SPARSE_EVERY, "steps": SPARSE_STEPS,
        "iteration_ms": med(gaps[1:]),
        "iteration_mean_ms": statistics.mean(gaps[1:]),
        "save_iterations_ms": [gaps[s_] for s_ in saves],
        "steps_1_4_after_save_ms": med(
            [sparse_s[s_ + j] for s_ in saves for j in range(1, 5)]) * 1e3,
        "steps_15_19_after_save_ms": med(
            [sparse_s[s_ + j] for s_ in saves for j in range(15, 20)]) * 1e3,
    }
    print(f"  checkpoint at full width: {nbytes} bytes on disk "
          f"({nbytes / 1e6:.1f} MB; {n_params} f32 parameters with AdamW's "
          f"m and v) [{card}]")
    print(f"  non-blocking save: host snapshot (blocking) "
          f"{[round(x * 1e3, 3) for x in snapshot_s]} ms, writer thread "
          f"{[round(x, 4) for x in write_s]} s; restore onto the card "
          f"(verify, decode, copy) {[round(x, 4) for x in restore_s]} s "
          f"[{card}]")
    print(f"  straight run of {CKPT_STEPS} steps: median step (the trainer's "
          f"step_s, steps 2–{CKPT_STEPS}) {steps_ms['with_ckpt_step_ms']:.3f} "
          f"ms with ckpt_dir, {steps_ms['without_ckpt_step_ms']:.3f} ms "
          f"without; median loop iteration (start to start, saves "
          f"included) {steps_ms['with_ckpt_iteration_ms']:.3f} / "
          f"{steps_ms['without_ckpt_iteration_ms']:.3f} ms, mean "
          f"{steps_ms['with_ckpt_iteration_mean_ms']:.3f} / "
          f"{steps_ms['without_ckpt_iteration_mean_ms']:.3f} ms; the "
          f"iterations that saved (steps 3, 7) "
          f"{[round(x, 3) for x in steps_ms['with_ckpt_save_iterations_ms']]}"
          f" ms [{card}]")
    print(f"  {SPARSE_STEPS} steps saving every {SPARSE_EVERY}: loop "
          f"iteration median {sparse_ms['iteration_ms']:.3f} ms, mean "
          f"{sparse_ms['iteration_mean_ms']:.3f} ms; the iterations that "
          f"saved (steps {', '.join(str(s_) for s_ in saves)}) "
          f"{[round(x, 3) for x in sparse_ms['save_iterations_ms']]} ms; "
          f"median step 1–4 steps after a save (its writer running) "
          f"{sparse_ms['steps_1_4_after_save_ms']:.3f} ms, 15–19 after "
          f"{sparse_ms['steps_15_19_after_save_ms']:.3f} ms [{card}]")
    return {"card": card, "launches": launches, "mips_topk_by_k": by_k,
            "losses": losses, "restored_step": CKPT_STEPS - 1,
            "exact_resume_equal": exact_equal, "exact_resume_gap": exact_gap,
            "bytes": nbytes, "n_params": n_params,
            "snapshot_s": snapshot_s, "write_s": write_s,
            "restore_s": restore_s, **steps_ms, "sparse_saves": sparse_ms}


# ---------------------------------------------------------------------------
# The LM path at full width: gemma-2-2b
# ---------------------------------------------------------------------------
LM_SEQ = 4096  # train_4k's sequence length
LM_STEPS = 4
LM_EVAL_SEQS = 2  # held-out sequences: 8,192 token-rank rows
LM_PROMPT = 512
LM_DECODE = 8
LM_CAP = 30.0  # gemma-2's final softcap
LM_CE_STEPS = 2  # the full-CE baseline's steps
LM_F32_STEPS = 2  # the f32 step at reduced depth


def lm_config():
    """gemma-2-2b as published: bfloat16, remat on, 26 layers, d 2304, 8
    heads over 4 KV heads of 256, vocabulary 256,000."""
    from repro_torch.configs.gemma2_2b import make_config

    return make_config()


LM_F32_LAYERS = 2


def lm_config_f32():
    """The published widths in float32 with depth cut to
    ``LM_F32_LAYERS`` (reduced): the f32 LM step still driven beside the
    bf16 main path."""
    import dataclasses

    from repro_torch.configs.gemma2_2b import make_config

    return dataclasses.replace(make_config(), dtype="float32",
                               n_layers=LM_F32_LAYERS)


def lm_sce_config(cfg):
    from repro_torch.launch.steps import build_sce_config

    return build_sce_config(LM_SEQ, cfg.vocab, bucket_size_y=1024,
                            logit_softcap=LM_CAP)


def lm_eval_check(name, x, y, t, *, exact):
    """``eval_fused`` (k 1, the LSE, cap 30, window [1, V)) and the
    ``eval_tgt_gather`` it calls against the plain version: on integers
    every output bit for bit; on floats values and the threshold within
    ``1e-5`` of their scale, the LSE within 1e-5 relative; on both a
    target in the top-1 carries the threshold bit for bit and ``eq ≥ 1``
    on every valid target."""
    import torch

    from repro_torch.kernels import ops, ref

    vocab = y.shape[0]
    kw = dict(c_lo=1, c_hi=vocab, logit_softcap=LM_CAP, with_lse=True)
    got = ops.eval_fused(x, y, t, 1, **kw)
    torch.cuda.synchronize()
    want = ref.eval_fused_ref(x, y, t, 1, **kw)
    vals, ids, gt, eq, tgt, m, s = got
    scale = want[0].abs().max().item()
    err = (vals - want[0]).abs().max().item()
    tgt_err = (tgt - want[4]).abs().max().item()
    if exact:
        for what, a, b in zip(("vals", "ids", "gt", "eq", "tgt"), got[:5],
                              want[:5]):
            check(torch.equal(a, b), f"{name}: {what} differ on integers")
    else:
        check(err <= 1e-5 * scale and tgt_err <= 1e-5 * scale,
              f"{name}: vals / tgt differ by {err:.3e} / {tgt_err:.3e}")
    lse, want_lse = m + torch.log(s), want[5] + torch.log(want[6])
    lse_err = ((lse - want_lse).abs()
               / want_lse.abs().clamp_min(1e-6)).max().item()
    check(lse_err <= 1e-5, f"{name}: lse relative error {lse_err}")
    hit = ids == t[:, None]
    check(torch.equal(vals[hit], tgt[:, None][hit]),
          f"{name}: a target in the top-1 does not carry tgt bit for bit")
    check(bool((eq >= 1).all()), f"{name}: eq < 1 on a valid target")
    rank_agree = float(((gt + (eq - 1).clamp_min(0))
                        == (want[2] + (want[3] - 1).clamp_min(0)))
                       .float().mean())
    print(f"  case {name}: B={x.shape[0]} V={vocab} d={x.shape[1]} k=1 "
          f"lse cap {LM_CAP} max_abs_err vals {err:.3e} tgt {tgt_err:.3e} "
          f"lse rel {lse_err:.3e} {'bitwise' if exact else 'scaled'}; "
          f"ranks equal to the plain version's on {rank_agree:.2%} of rows; "
          f"{int(hit.any(1).sum())} targets at the top carry tgt exactly ok")
    return {"name": name, "B": x.shape[0], "C": vocab, "d": x.shape[1],
            "exact": exact, "max_abs_err": err, "tgt_err": tgt_err,
            "lse_rel_err": lse_err, "rank_agreement": rank_agree}


SWEEP_KERNELS = ("sample_kernel", "tau_select_kernel", "eval_sweep_kernel",
                 "eval_fused_merge_kernel")  # the deep sweep's launches


def slab_sweep_times(name, xs, y, t, tgt, c_hi, flush, reps=5):
    """The deep eval sweep of one score slab alone: ``xs`` one slab's rows
    (1,024 at the token rank) against the vocabulary ``y``. The device
    time of its kernels (:data:`SWEEP_KERNELS`: the pre-pass and its τ,
    the sweep, the merge; not the product that writes the slab) in one
    ``eval_fused`` call (k 1, the LSE, cap 30, window [1, c_hi)) and one
    ``eval_topk`` call, from ``torch.profiler`` over ``reps`` calls, each
    after the L2 flush ("not measured" where it saw none); beside the
    slab's bytes at the card's rate and PyTorch on the kernels' own slab
    (``eval_fused.score_slab``): ``max(0)``, the counts against the
    target scores and, with the LSE, the capped ``logsumexp``."""
    import torch

    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels import eval_topk as tk

    calls = {
        "lse": lambda: ek.eval_fused(xs, y, t, 1, tgt_scores=tgt, c_lo=1,
                                     c_hi=c_hi, logit_softcap=LM_CAP,
                                     with_lse=True),
        "no_lse": lambda: tk.eval_topk(xs, y, tgt, 1, c_lo=1, c_hi=c_hi)}
    s = ek.score_slab(xs, y)[1:c_hi]

    def lib(lse):
        out = s.max(0), (s > tgt).sum(0), (s == tgt).sum(0)
        if lse:
            out += (torch.logsumexp(LM_CAP * torch.tanh(s / LM_CAP), 0),)
        return out

    out = {"rows": xs.shape[0], "C": y.shape[0],
           "bound_ms": 4 * xs.shape[0] * y.shape[0] / PEAK_BYTES_S * 1e3,
           "bound_by": "bytes"}
    for kind, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        ms = sum(ev.device_time_total for ev in prof.key_averages()
                 if any(k in ev.key for k in SWEEP_KERNELS)) / reps / 1e3
        out[kind] = {"ms": ms or None,
                     "library_ms": time_ms(lambda: lib(kind == "lse"), 3,
                                           flush)}
    del s
    f = (lambda v: "not measured" if v is None else f"{v:.4f} ms")
    print(f"  time {name}: the deep sweep of one slab ({out['rows']} x "
          f"{out['C']}) alone, with the LSE {f(out['lse']['ms'])} "
          f"(PyTorch on the slab {out['lse']['library_ms']:.4f} ms), "
          f"without {f(out['no_lse']['ms'])} (PyTorch "
          f"{out['no_lse']['library_ms']:.4f} ms); bound "
          f"{out['bound_ms']:.4f} ms (bytes)")
    return out


def lm_kernel_phase(dev, cfg):
    """The kernels of the LM path at its shapes against their plain
    versions, then timed with a cold L2: ``mips_topk`` (the deep chain:
    128 centres against 4,096 positions at k 128 and against the 256,000
    vocabulary rows at k 1024), the three ``sce_gather_plse`` launches and
    the three ``sce_gather_loss`` ones at (n_b 128, b_x 128, b_y 1024,
    d 2304, cap 30) on that selection, ``eval_fused`` / ``eval_tgt_gather``
    at 8,192 × 256,000 at k 1 with the LSE, and one microbatch's SCE loss
    and gradients through ``sce_loss_sharded`` (exact, the (1, 1) mesh) on
    the kernel path against the plain path; and the deep sweep of one eval
    slab alone (:func:`slab_sweep_times`)."""
    import dataclasses

    import torch

    from repro_torch.core.distributed_sce import sce_loss_sharded
    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels import ref, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.mesh import make_host_mesh

    g = torch.Generator(device=dev).manual_seed(11)
    vocab, d = cfg.vocab_padded, cfg.d_model
    sce_cfg = lm_sce_config(cfg)
    n_b, b_x, b_y = (sce_cfg.n_buckets, sce_cfg.bucket_size_x,
                     sce_cfg.bucket_size_y)
    check((n_b, b_x, b_y) == (128, 128, 1024),
          f"SCE shape {(n_b, b_x, b_y)}, not (128, 128, 1024)")
    y = torch.randn(vocab, d, generator=g, device=dev) * 0.02
    x = torch.randn(LM_SEQ, d, generator=g, device=dev)
    q = torch.randn(n_b, d, generator=g, device=dev)
    cases = [run_case("lm_positions_k128", q, x, b_x),
             run_case("lm_vocab_k1024", q, y, b_y)]
    _, ix = mips_topk(q, x, b_x)
    _, iy = mips_topk(q, y, b_y)
    targets = torch.randint(1, cfg.vocab, (LM_SEQ,), generator=g, device=dev,
                            dtype=torch.int32)
    x_b = x[ix.long()]
    tgt_b = targets[ix.long()]
    pos = LM_CAP * torch.tanh((x_b * y[tgt_b.long()]).sum(-1) / LM_CAP)
    gcase = gather_case("lm_gather", x_b, y, iy, tgt_b, iy, pos, cap=LM_CAP)
    pcase = plse_case("lm_plse", x_b, y, iy, tgt_b, iy, cap=LM_CAP)

    # one microbatch's SCE on the kernel path against the plain path;
    # integer-valued x, y / 256 and a sparse ±1 Ω make every selection
    # score exact on both paths, so both select the same candidates
    xi = torch.randint(-2, 3, (LM_SEQ, d), generator=g, device=dev).float()
    yi = torch.randint(-2, 3, (vocab, d), generator=g, device=dev).float()
    yi = yi / 256
    omega = torch.zeros(n_b, LM_SEQ, device=dev)
    cols = torch.randint(0, LM_SEQ, (n_b, 4), generator=g, device=dev)
    signs = torch.randint(0, 2, (n_b, 4), generator=g, device=dev) * 2 - 1
    omega.scatter_(1, cols, signs.float())
    mesh = make_host_mesh(max_data=1)
    res = {}
    for path, use_kernel in (("kernel", True), ("plain", False)):
        xl, yl = xi.clone().requires_grad_(True), yi.clone().requires_grad_(True)
        loss = sce_loss_sharded(
            xl, yl, targets, cfg=dataclasses.replace(sce_cfg,
                                                     use_kernel=use_kernel),
            mesh=mesh, valid_mask=torch.ones(LM_SEQ, dtype=torch.bool,
                                             device=dev),
            mode="exact", omega=omega)
        res[path] = (loss.item(), *torch.autograd.grad(loss, (xl, yl)))
    torch.cuda.synchronize()
    got, want = res["kernel"], res["plain"]
    lerr = abs(got[0] - want[0])
    check(math.isfinite(got[0]) and lerr <= 1e-5 * abs(want[0]),
          f"lm microbatch SCE: loss {got[0]} vs plain {want[0]}")
    sce_err = {"loss": lerr}
    for what, a, w in (("dx", got[1], want[1]), ("dy", got[2], want[2])):
        err = (a - w).abs()
        tol = 1e-5 * w.abs().max().item()
        check(bool(torch.isfinite(a).all()
                   and (err <= tol + 2e-4 * w.abs()).all()),
              f"lm microbatch SCE: {what} differs by {err.max().item():.3e}")
        sce_err[what] = err.max().item()
    print(f"  lm microbatch SCE (exact, (1, 1) mesh, {LM_SEQ} positions, "
          f"cap {LM_CAP}): kernel path loss {got[0]:.6f} vs plain "
          f"{want[0]:.6f} (|Δ| {lerr:.3e}), max |Δ| dX {sce_err['dx']:.3e}, "
          f"dY {sce_err['dy']:.3e} ok")
    del xi, yi, res, got, want

    # token rank: 8,192 rows against the vocabulary, k 1, LSE, cap 30
    n_e = LM_EVAL_SEQS * LM_SEQ
    te = torch.randint(1, cfg.vocab, (n_e,), generator=g, device=dev,
                       dtype=torch.int32)
    xe_i = torch.randint(-2, 3, (n_e, d), generator=g, device=dev).float()
    ye_i = torch.randint(-2, 3, (vocab, d), generator=g, device=dev).float()
    ecases = [lm_eval_check("lm_token_rank_integers", xe_i, ye_i, te,
                            exact=True)]
    del xe_i, ye_i
    xe = torch.randn(n_e, d, generator=g, device=dev)
    ecases.append(lm_eval_check("lm_token_rank", xe, y, te, exact=False))

    # times, cold L2
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    timings = {}
    for name, cat, k in (("mips_topk_lm_positions_k128", x, b_x),
                         ("mips_topk_lm_vocab_k1024", y, b_y)):
        c = cat.shape[0]
        timings[name] = {
            "ms": time_ms(lambda: mips_topk(q, cat, k), 5, flush),
            "plain_ms": time_ms(lambda: ref.mips_topk_ref(q, cat, k), 2,
                                flush),
            "library_ms": time_ms(lambda: torch.topk(q @ cat.T, k), 5, flush),
            **bound_keys(tf32x3_bound(4 * (n_b * d + c * d) + 8 * n_b * k,
                                      2 * n_b * c * d, 0))}
    g_up = torch.rand(n_b, b_x, generator=g, device=dev)
    args = (x_b, y, iy, tgt_b, iy)
    plse = sce_prefetch.sce_gather_plse_fwd(*args, logit_softcap=LM_CAP)
    _, lse = sce_prefetch.sce_gather_fwd(*args, pos, logit_softcap=LM_CAP)
    y_b = y[iy.long()]
    hide = (iy[:, None, :] < 0) | (iy[:, None, :] == tgt_b[:, :, None])

    def capped_logits():
        l_ = torch.bmm(x_b, y_b.transpose(1, 2))
        return LM_CAP * torch.tanh(l_ / LM_CAP)

    def lib_fwd(with_pos):
        l_ = torch.where(hide, NEG_INF, capped_logits())
        if with_pos:
            l_ = torch.cat([pos[..., None], l_], -1)
        return torch.logsumexp(l_, -1)

    def lib_cot(lse_):
        c_ = capped_logits()
        return torch.where(hide, 0.0, torch.exp(c_ - lse_[..., None])
                           * (1 - (c_ / LM_CAP) ** 2) * g_up[..., None])

    def lib_bwd(lse_, dy):
        p = lib_cot(lse_)
        if not dy:
            return torch.bmm(p, y_b)
        return torch.bmm(p.transpose(1, 2), x_b)

    def lib_pair(lse_):
        p = lib_cot(lse_)
        return torch.bmm(p, y_b), torch.bmm(p.transpose(1, 2), x_b)

    def plain_grad(fn):
        """``i`` → the gradient of leaf i (x_b 0, y 1); None → both."""
        leaves = [t.clone().requires_grad_(True) for t in (x_b, y)]
        out = (fn(*leaves) * g_up).sum()
        return lambda i: torch.autograd.grad(
            out, leaves if i is None else leaves[i], retain_graph=True)

    p_plse = plain_grad(lambda a, b: ref.sce_gather_plse_ref(
        a, b, iy, tgt_b, iy, LM_CAP))
    p_loss = plain_grad(lambda a, b: ref.sce_gather_loss_ref(
        a, b, iy, tgt_b, iy, pos, LM_CAP))
    kw = dict(logit_softcap=LM_CAP)
    runs = {
        "sce_gather_plse_fwd_lm": (
            lambda: sce_prefetch.sce_gather_plse_fwd(*args, **kw),
            lambda: ref.sce_gather_plse_ref(*args, LM_CAP),
            lambda: lib_fwd(False)),
        "sce_gather_plse_dx_lm": (
            lambda: sce_prefetch.sce_gather_plse_dx(*args, plse, g_up, **kw),
            lambda: p_plse(0), lambda: lib_bwd(plse, False)),
        "sce_gather_plse_dy_lm": (
            lambda: sce_prefetch.sce_gather_plse_dy(*args, plse, g_up, **kw),
            lambda: p_plse(1), lambda: lib_bwd(plse, True)),
        # the backward as autograd runs it: one deep launch, the cotangent
        # written once, dX and dY's slot rows from it, then the dY sum
        "sce_gather_plse_bwd_lm": (
            lambda: sce_prefetch._grads(
                sce_prefetch.sce_gather_plse_dx,
                sce_prefetch.sce_gather_plse_dy, args + (plse, g_up), LM_CAP,
                True, True),
            lambda: p_plse(None), lambda: lib_pair(plse)),
        "sce_gather_fwd_lm": (
            lambda: sce_prefetch.sce_gather_fwd(*args, pos, **kw),
            lambda: ref.sce_gather_loss_ref(*args, pos, LM_CAP),
            lambda: lib_fwd(True)),
        "sce_gather_dx_lm": (
            lambda: sce_prefetch.sce_gather_dx(*args, lse, g_up, **kw),
            lambda: p_loss(0), lambda: lib_bwd(lse, False)),
        "sce_gather_dy_lm": (
            lambda: sce_prefetch.sce_gather_dy(*args, lse, g_up, **kw),
            lambda: p_loss(1), lambda: lib_bwd(lse, True)),
    }
    bounds = {k + "_lm": v for k, v in {
        **plse_bounds(*args), **gather_bounds(*args)}.items()}
    # the pair reads the plse's inputs once and writes dX and the whole
    # (C, d) dY; three products (the logits, dX, dY) of 2·d FLOPs a pair
    pairs = unmasked_pairs(tgt_b, iy)
    rows = int(torch.unique(iy[iy >= 0]).numel())
    bounds["sce_gather_plse_bwd_lm"] = tf32x3_bound(
        4 * (n_b * b_x * d + rows * d + 2 * n_b * b_y + 3 * n_b * b_x
             + n_b * b_x * d + vocab * d), 3 * 2 * pairs * d, pairs)
    pair = sce_prefetch._grads(
        sce_prefetch.sce_gather_plse_dx, sce_prefetch.sce_gather_plse_dy,
        args + (plse, g_up), LM_CAP, True, True)
    alone = (sce_prefetch.sce_gather_plse_dx(*args, plse, g_up, **kw),
             sce_prefetch.sce_gather_plse_dy(*args, plse, g_up, **kw))
    check(all(torch.equal(a, b) for a, b in zip(pair, alone)),
          "lm: the one-cotangent backward differs from dX and dY alone")
    print("  lm deep backward: dX and dY from one cotangent equal dX and "
          "dY alone bit for bit ok")
    del pair, alone
    # dY's entries time the whole wrapper here (the deep kernel writes its
    # slot rows, then the in-order sum into (C, d)); the sum's own entry:
    ws = torch.randn(n_b * b_y, d, generator=g, device=dev)
    keys, order = sce_prefetch.dy_sum_keys(iy, iy, vocab)
    dyz = torch.zeros_like(y)
    lib_c = torch.zeros_like(y)
    runs["sce_gather_dy_sum_lm"] = (
        lambda: sce_prefetch.sce_gather_dy_sum(ws, keys, order, dyz),
        lambda: sce_prefetch.dy_sum_plain(ws, iy, iy, vocab),
        lambda: lib_c.index_add_(0, iy.reshape(-1).long(), ws))
    bounds["sce_gather_dy_sum_lm"] = dy_sum_bound(iy, iy, d)
    with torch.no_grad():
        for name, (kern, plain, lib) in runs.items():
            timings[name] = {"ms": time_ms(kern, 5, flush),
                             "plain_ms": time_ms(plain, 2, flush),
                             "library_ms": time_ms(lib, 5, flush),
                             **bound_keys(bounds[name])}
    del p_plse, p_loss
    tgt_e = ek.eval_tgt_gather(xe, y, te)
    window = torch.arange(vocab, device=dev)
    window = (window >= 1) & (window < cfg.vocab)

    def eval_library():
        s_ = torch.where(window[None, :], xe @ y.T, NEG_INF)
        return (torch.topk(s_, 1), (s_ > tgt_e[:, None]).sum(1),
                (s_ == tgt_e[:, None]).sum(1),
                torch.logsumexp(LM_CAP * torch.tanh(s_ / LM_CAP), -1))

    ekw = dict(c_lo=1, c_hi=cfg.vocab, logit_softcap=LM_CAP, with_lse=True)
    timings["eval_fused_lm"] = {
        "ms": time_ms(lambda: ek.eval_fused(xe, y, te, 1, tgt_scores=tgt_e,
                                            **ekw), 3, flush),
        "plain_ms": time_ms(lambda: ref.eval_fused_ref(
            xe, y, te, 1, tgt_scores=tgt_e, **ekw), 1, flush),
        "library_ms": time_ms(eval_library, 2, flush),
        **bound_keys(tf32x3_bound(4 * (n_e * d + vocab * d + 2 * n_e)
                                  + 8 * n_e + 16 * n_e,
                                  2 * n_e * vocab * d, n_e * vocab))}
    n_rows = int(torch.unique(te).numel())
    timings["eval_tgt_gather_lm"] = {
        "ms": time_ms(lambda: ek.eval_tgt_gather(xe, y, te), 20, flush),
        "plain_ms": time_ms(lambda: ref.eval_tgt_gather_ref(xe, y, te), 3,
                            flush),
        "library_ms": time_ms(lambda: (xe * y[te.long()]).sum(-1), 20,
                              flush),
        **bound_keys(tf32x3_bound(4 * (n_e * d + n_rows * d + n_e) + 4 * n_e,
                                  2 * n_e * d, 0))}
    sweep_slab = slab_sweep_times("eval_sweep_slab_lm", xe[:1024], y,
                                  te[:1024], tgt_e[:1024], cfg.vocab, flush)
    ce_timings, ce_errs = lm_full_ce_kernels(dev, x, y, targets, g, flush)
    timings.update(ce_timings)
    for name, t in timings.items():
        print(f"  time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {bound_text(t)}")
    errs = {
        **ce_errs,
        "mips_topk_lm_positions_k128": cases[0]["max_abs_err"],
        "mips_topk_lm_vocab_k1024": cases[1]["max_abs_err"],
        "sce_gather_plse_fwd_lm": pcase["max_abs_err"]["plse"],
        "sce_gather_plse_dx_lm": pcase["max_abs_err"]["dx"],
        "sce_gather_plse_dy_lm": pcase["max_abs_err"]["dy"],
        # bit for bit the two alone (checked above), so their errors
        "sce_gather_plse_bwd_lm": max(pcase["max_abs_err"]["dx"],
                                      pcase["max_abs_err"]["dy"]),
        "sce_gather_fwd_lm": gcase["max_abs_err"]["loss"],
        "sce_gather_dx_lm": gcase["max_abs_err"]["dx"],
        "sce_gather_dy_lm": gcase["max_abs_err"]["dy"],
        "eval_fused_lm": max(c["max_abs_err"] for c in ecases),
        "eval_tgt_gather_lm": max(c["tgt_err"] for c in ecases),
    }
    # the sum kernel on its own input against index_add_
    got = sce_prefetch.sce_gather_dy_sum(ws, keys, order, torch.zeros_like(y))
    want = sce_prefetch.dy_sum_plain(ws, iy, iy, vocab)
    errs["sce_gather_dy_sum_lm"] = (got - want).abs().max().item()
    check(errs["sce_gather_dy_sum_lm"]
          <= 1e-5 * want.abs().max().item() + 1e-6,
          "lm dy_sum differs from index_add_")
    for name in timings:
        timings[name]["max_abs_err"] = errs[name]
    return {"cases": cases, "gather_case": gcase, "plse_case": pcase,
            "eval_cases": ecases, "microbatch_sce_err": sce_err,
            "timings": timings, "sweep_slab": sweep_slab}


def lm_bf16_kernel_phase(dev, cfg, *, sce_cfg=None, cap=LM_CAP,
                         tag="lm_bf16", extras=True):
    """The LM path's kernels on bf16 operands at gemma-2's shapes (the
    published type, which the main path runs; another LM's with its
    ``cfg``, ``sce_cfg`` and final softcap ``cap``, its entries named
    ``*_{tag}``, and without ``extras``: ``fused_lse``'s deep entries and
    the one-slab sweep, which no LM path runs): ``mips_topk`` at both
    selections, the three ``sce_gather_plse`` launches and the deep
    backward as autograd runs it (n_b 128, b_x 128, b_y 1024, d 2304,
    cap 30), the in-order dY sum into the bf16 table, ``eval_fused`` /
    ``eval_tgt_gather`` at 8,192 × 256,000 (k 1, the LSE), and the deep
    ``linear_ce`` forward and one-launch backward at N 4,096 (cap 30, the
    target plucked). Every one takes its products on the bf16 ``wgmma``
    (``deep_tc.cuh`` ``gemm_bf16``: the depth summed in the tensor cores,
    other bits than the f32 kernels' 3xTF32 steps) and repeats bit for
    bit. The selections' and eval's values and LSE pair
    lie within ``1e-5·max|·| + 2e-4·|·|`` of the f64 plain version on the
    same values, ids equal wherever the gap is above that; the eval's
    ``gt`` lies between the f64 count of columns above the target by more
    than that tolerance and the count of those above it less the
    tolerance, and ``eq`` ≥ 1 on every row; each target score equals the
    eval slab's own column (``eval_fused.score_slab``) bit for bit, so
    ``eq`` counts the target's column; the bf16 dY sum
    equals the f32 sum rounded once bit for bit. Each also against its
    plain version on the bf16 inputs:
    values within ``1e-5`` of their scale (selections, the lse) or the
    bf16 tolerance ``3e-2`` of their scale (bf16 outputs: losses,
    gradients, whose cotangent is rounded to bf16 on both sides). Then
    each timed with a cold L2 beside its plain version, a PyTorch call of
    the same function in bf16 and its bound at bf16's rates
    (:func:`bf16_bound`); and the deep sweep of one eval slab alone
    (:func:`slab_sweep_times`)."""
    import torch

    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels import linear_sce, ref, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(12)
    vocab, d = cfg.vocab_padded, cfg.d_model
    sce_cfg = sce_cfg or lm_sce_config(cfg)
    n_b, b_x, b_y = (sce_cfg.n_buckets, sce_cfg.bucket_size_x,
                     sce_cfg.bucket_size_y)
    y = (torch.randn(vocab, d, generator=g, device=dev) * 0.02).to(bf)
    x = torch.randn(LM_SEQ, d, generator=g, device=dev).to(bf)
    q = torch.randn(n_b, d, generator=g, device=dev).to(bf)
    targets = torch.randint(1, cfg.vocab, (LM_SEQ,), generator=g,
                            device=dev, dtype=torch.int32)
    errs, runs, bounds = {}, {}, {}

    def capped(s_):
        return s_ if cap is None else cap * torch.tanh(s_ / cap)

    def same(what, got, want, of="the f32 kernel on the widened inputs"):
        check(len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want)),
            f"lm bf16 {what}: differs from {of}")

    def within(what, got, want, tol):
        err = (got.double() - want.double()).abs().max().item()
        scale = want.double().abs().max().item()
        check(bool(torch.isfinite(got).all()) and err <= tol * scale,
              f"lm bf16 {what}: |Δ| {err:.3e} above {tol}·{scale:.3e}")
        return err

    def near_f64(what, got, want, scale):
        """Within 1e-5·scale + 2e-4·|want| of the f64 ``want``."""
        tol = 1e-5 * scale + 2e-4 * want.abs()
        bad = int(((got.double() - want).abs() > tol).sum())
        check(bool(torch.isfinite(got).all()) and bad == 0,
              f"lm bf16 {what}: {bad} values outside 1e-5·max + 2e-4·|·| "
              f"of f64")
        return tol

    def top_f64(what, got, s64, k):
        """A selection against the f64 top-k of s64 (columns out of the
        window at -inf): values within the tolerance of the finite
        scores' largest magnitude, then ids wherever the gap to both
        neighbours is above it, on at least one entry. Returns that
        scale."""
        v, order = torch.topk(s64, min(k + 1, s64.shape[1]), dim=1)
        wv, wi = v[:, :k], order[:, :k].to(torch.int32)
        scale = s64.nan_to_num(neginf=0.0).abs().max().item()
        check(math.isfinite(scale) and scale > 0,
              f"lm bf16 {what}: no finite score to scale the tolerance")
        tol = near_f64(what, got[0], wv, scale)
        inf = torch.full_like(wv[:, :1], float("inf"))
        nxt = torch.cat([wv[:, 1:], v[:, k:k + 1] if v.shape[1] > k
                         else -inf], 1)
        iso = ((torch.cat([inf, wv[:, :-1]], 1) - wv) > tol) & (
            (wv - nxt) > tol)
        check(bool(iso.any()) and bool(torch.equal(got[1][iso], wi[iso])),
              f"lm bf16 {what}: ids differ from f64 where the gap is "
              f"above the tolerance, or no gap is")
        return scale

    # the selections
    sel = {}
    for name, cat, k in ((f"mips_topk_positions_k{b_x}_{tag}", x, b_x),
                         (f"mips_topk_vocab_k{b_y}_{tag}", y, b_y)):
        got = mips_topk(q, cat, k)
        same(name, got, mips_topk(q, cat, k), "a second launch")
        top_f64(name, got, q.double() @ cat.double().T, k)
        want = ref.mips_topk_ref(q, cat, k)
        errs[name] = within(name, got[0], want[0], 1e-5)
        sel[k] = got[1]
        c = cat.shape[0]
        runs[name] = (lambda cat=cat, k=k: mips_topk(q, cat, k),
                      lambda cat=cat, k=k: ref.mips_topk_ref(q, cat, k),
                      lambda cat=cat, k=k: torch.topk(q @ cat.T, k))
        bounds[name] = bf16_bound(2 * (n_b * d + c * d) + 8 * n_b * k,
                                  2 * n_b * c * d, 0)
    ix, iy = sel[b_x], sel[b_y]
    x_b = x[ix.long()].contiguous()
    tgt_b = targets[ix.long()]
    args = (x_b, y, iy, tgt_b, iy)
    plse = sce_prefetch.sce_gather_plse_fwd(*args, logit_softcap=cap)
    same("sce_gather_plse_fwd", (plse,), (sce_prefetch.sce_gather_plse_fwd(
        *args, logit_softcap=cap),), "a second launch")
    errs[f"sce_gather_plse_fwd_{tag}"] = within(
        "plse", plse, ref.sce_gather_plse_ref(*args, cap), 1e-5)
    g_up = torch.rand(n_b, b_x, generator=g, device=dev)

    def plain_grads(i):
        with torch.enable_grad():  # also inside the timing's no_grad
            leaves = [t.clone().requires_grad_(True) for t in (x_b, y)]
            out = ref.sce_gather_plse_ref(leaves[0], leaves[1], iy, tgt_b,
                                          iy, cap)
            return torch.autograd.grad((out * g_up).sum(),
                                       leaves if i is None else leaves[i])

    pair = sce_prefetch._grads(
        sce_prefetch.sce_gather_plse_dx, sce_prefetch.sce_gather_plse_dy,
        args + (plse, g_up), cap, True, True)
    want = plain_grads(None)
    check(pair[0].dtype == pair[1].dtype == bf,
          "lm bf16: the SCE gradients are not bf16")
    errs[f"sce_gather_plse_dx_{tag}"] = within("dX", pair[0], want[0], 3e-2)
    errs[f"sce_gather_plse_dy_{tag}"] = within("dY", pair[1], want[1], 3e-2)
    errs[f"sce_gather_plse_bwd_{tag}"] = max(
        errs[f"sce_gather_plse_dx_{tag}"], errs[f"sce_gather_plse_dy_{tag}"])
    again = sce_prefetch._grads(
        sce_prefetch.sce_gather_plse_dx, sce_prefetch.sce_gather_plse_dy,
        args + (plse, g_up), cap, True, True)
    same("the deep SCE backward, twice", pair, again)
    del pair, want, again
    y_b = y[iy.long()]
    hide = (iy[:, None, :] < 0) | (iy[:, None, :] == tgt_b[:, :, None])

    def lib_logits():
        return capped(torch.bmm(x_b, y_b.transpose(1, 2)))

    def lib_cot():
        c_ = lib_logits()
        return torch.where(hide, 0.0, torch.exp(c_ - plse[..., None])
                           * (1.0 if cap is None else 1 - (c_ / cap) ** 2)
                           * g_up[..., None]).to(bf)

    kw = dict(logit_softcap=cap)
    runs[f"sce_gather_plse_fwd_{tag}"] = (
        lambda: sce_prefetch.sce_gather_plse_fwd(*args, **kw),
        lambda: ref.sce_gather_plse_ref(*args, cap),
        lambda: torch.logsumexp(torch.where(hide, NEG_INF, lib_logits()),
                                -1))
    runs[f"sce_gather_plse_dx_{tag}"] = (
        lambda: sce_prefetch.sce_gather_plse_dx(*args, plse, g_up, **kw),
        lambda: plain_grads(0), lambda: torch.bmm(lib_cot(), y_b))
    runs[f"sce_gather_plse_dy_{tag}"] = (
        lambda: sce_prefetch.sce_gather_plse_dy(*args, plse, g_up, **kw),
        lambda: plain_grads(1),
        lambda: torch.bmm(lib_cot().transpose(1, 2), x_b))
    runs[f"sce_gather_plse_bwd_{tag}"] = (
        lambda: sce_prefetch._grads(
            sce_prefetch.sce_gather_plse_dx, sce_prefetch.sce_gather_plse_dy,
            args + (plse, g_up), cap, True, True),
        lambda: plain_grads(None),
        lambda: (lambda p: (torch.bmm(p, y_b),
                            torch.bmm(p.transpose(1, 2), x_b)))(lib_cot()))
    # the in-order dY sum into the bf16 table: each row's f32 sum rounded
    # once, equal to the f32 table's rounded to bf16
    ws = torch.randn(n_b * b_y, d, generator=g, device=dev)
    keys, order = sce_prefetch.dy_sum_keys(iy, iy, vocab)
    dyz = torch.zeros_like(y)
    got = sce_prefetch.sce_gather_dy_sum(ws, keys, order, dyz)
    same("sce_gather_dy_sum", (got,), (sce_prefetch.sce_gather_dy_sum(
        ws, keys, order, torch.zeros(vocab, d, device=dev)).to(bf),),
        "the f32 sum rounded once")
    errs[f"sce_gather_dy_sum_{tag}"] = within(
        "dY sum", got, sce_prefetch.dy_sum_plain(ws, iy, iy, vocab, bf), 3e-2)
    del got
    lib_c = torch.zeros(vocab, d, device=dev)
    runs[f"sce_gather_dy_sum_{tag}"] = (
        lambda: sce_prefetch.sce_gather_dy_sum(ws, keys, order, dyz),
        lambda: sce_prefetch.dy_sum_plain(ws, iy, iy, vocab, bf),
        lambda: lib_c.index_add_(0, iy.reshape(-1).long(), ws).to(bf))
    kept = int((iy >= 0).sum())
    u_rows = int(torch.unique(iy[iy >= 0]).numel())
    bounds[f"sce_gather_dy_sum_{tag}"] = bf16_bound(
        4 * iy.numel() + 8 * kept + 4 * kept * d + 2 * u_rows * d, 0, 0)
    pairs = unmasked_pairs(tgt_b, iy)
    rows = int(torch.unique(iy[iy >= 0]).numel())
    common = 2 * (n_b * b_x * d + rows * d) + 4 * (2 * n_b * b_y + n_b * b_x)
    bounds[f"sce_gather_plse_fwd_{tag}"] = bf16_bound(
        common + 4 * n_b * b_x, 2 * pairs * d, pairs)
    bounds[f"sce_gather_plse_dx_{tag}"] = bf16_bound(
        common + 8 * n_b * b_x + 2 * n_b * b_x * d, 4 * pairs * d, pairs)
    bounds[f"sce_gather_plse_dy_{tag}"] = bf16_bound(
        common + 8 * n_b * b_x + 2 * vocab * d, 4 * pairs * d, pairs)
    bounds[f"sce_gather_plse_bwd_{tag}"] = bf16_bound(
        common + 8 * n_b * b_x + 2 * n_b * b_x * d + 2 * vocab * d,
        6 * pairs * d, pairs)

    # token rank: 8,192 rows against the vocabulary, k 1, LSE, cap 30
    n_e = LM_EVAL_SEQS * LM_SEQ
    te = torch.randint(1, cfg.vocab, (n_e,), generator=g, device=dev,
                       dtype=torch.int32)
    xe = torch.randn(n_e, d, generator=g, device=dev).to(bf)
    ekw = dict(c_lo=1, c_hi=cfg.vocab, logit_softcap=cap, with_lse=True)
    got = ek.eval_fused(xe, y, te, 1, **ekw)
    same("eval_fused", got, ek.eval_fused(xe, y, te, 1, **ekw),
         "a second launch")
    tgt_e = ek.eval_tgt_gather(xe, y, te)
    same("eval_tgt_gather", (tgt_e,), (got[4],))
    same("eval_tgt_gather", (tgt_e,), (ek.eval_tgt_gather(xe, y, te),),
         "a second launch")
    # against f64 and the slab, one eval slab (1,024 rows) at a time
    y64 = y.double()
    ids_v = torch.arange(vocab, device=dev)
    ok_v = (ids_v >= 1) & (ids_v < cfg.vocab)
    for r in range(0, n_e, 1024):
        rr = slice(r, r + 1024)
        slab = ek.score_slab(xe[rr], y)  # (vocab, 1,024): the launch's own
        col = slab[te[rr].long(), torch.arange(slab.shape[1], device=dev)]
        check(torch.equal(tgt_e[rr].view(torch.int32), col.view(torch.int32)),
              "lm bf16: a target score is not its slab column bit for bit")
        del slab, col
        s64 = xe[rr].double() @ y64.T
        sv = torch.where(ok_v[None, :], s64, -math.inf)
        scale = top_f64("eval_fused", (got[0][rr], got[1][rr]), sv, 1)
        # gt within the columns that lie within the tolerance of the
        # target; eq counts at least the target's own column
        tgt64 = (xe[rr].double() * y64[te[rr].long()]).sum(1)
        tol_t = near_f64("eval tgt", got[4][rr], tgt64, scale)
        self_ = ids_v[None, :] == te[rr].long()[:, None]
        gt64 = ((sv > tgt64[:, None]) & ~self_).sum(1)
        near = ((sv - tgt64[:, None]).abs() <= tol_t[:, None]).sum(1)
        check(bool(((got[2][rr].long() - gt64).abs() <= near).all()),
              "lm bf16 eval gt: differs from the f64 count by more than the "
              "columns within the tolerance of the target")
        check(bool((got[3][rr] >= 1).all()),
              "lm bf16 eval eq: a row counts no column equal to its target")
        del self_, gt64, near
        lv = torch.where(ok_v[None, :], capped(s64), -math.inf)
        m64 = lv.amax(1)
        near_f64("eval m", got[5][rr], m64, m64.abs().max().item())
        s_64 = torch.exp(lv - m64[:, None]).sum(1)
        near_f64("eval s", got[6][rr], s_64, s_64.abs().max().item())
        del s64, sv, lv
    del y64
    want = ref.eval_fused_ref(xe, y, te, 1, **ekw)
    errs[f"eval_fused_{tag}"] = within("eval vals", got[0], want[0], 1e-5)
    errs[f"eval_tgt_gather_{tag}"] = within("eval tgt", got[4], want[4],
                                             1e-5)
    del got, want
    window = torch.arange(vocab, device=dev)
    window = (window >= 1) & (window < cfg.vocab)

    def eval_library():
        s_ = torch.where(window[None, :], (xe @ y.T).float(), NEG_INF)
        return (torch.topk(s_, 1), (s_ > tgt_e[:, None]).sum(1),
                (s_ == tgt_e[:, None]).sum(1),
                torch.logsumexp(capped(s_), -1))

    runs[f"eval_fused_{tag}"] = (
        lambda: ek.eval_fused(xe, y, te, 1, tgt_scores=tgt_e, **ekw),
        lambda: ref.eval_fused_ref(xe, y, te, 1, tgt_scores=tgt_e, **ekw),
        eval_library)
    bounds[f"eval_fused_{tag}"] = bf16_bound(
        2 * (n_e * d + vocab * d) + 4 * 2 * n_e + 8 * n_e + 16 * n_e,
        2 * n_e * vocab * d, n_e * vocab)
    n_rows = int(torch.unique(te).numel())
    runs[f"eval_tgt_gather_{tag}"] = (
        lambda: ek.eval_tgt_gather(xe, y, te),
        lambda: ref.eval_tgt_gather_ref(xe, y, te),
        lambda: (xe * y[te.long()]).float().sum(-1))
    bounds[f"eval_tgt_gather_{tag}"] = bf16_bound(
        2 * (n_e * d + n_rows * d) + 4 * n_e + 4 * n_e, 2 * n_e * d, 0)

    # the full-CE baseline's deep linear_ce: one microbatch
    gr = torch.rand(LM_SEQ, generator=g, device=dev) + 0.5
    loss, lse = linear_sce._fwd(x, y, targets, cap)
    same("linear_ce forward", (loss, lse), linear_sce._fwd(
        x, y, targets, cap), "a second launch")
    errs[f"linear_ce_fwd_{tag}"] = within(
        "linear_ce lse", lse, ref.fused_lse_ref(x, y, logit_softcap=cap),
        1e-5)
    pair = linear_sce._bwd_deep(x, y, targets, lse, gr, cap, True, True)
    check(pair[0].dtype == pair[1].dtype == bf,
          "lm bf16: the full-CE gradients are not bf16")
    same("linear_ce backward", pair, linear_sce._bwd_deep(
        x, y, targets, lse, gr, cap, True, True), "a second launch")
    cargs = (x, y, targets, lse, gr)
    errs[f"linear_ce_bwd_{tag}"] = max(
        within("linear_ce dX", pair[0], ref.linear_ce_dx_ref(
            *cargs, logit_softcap=cap), 3e-2),
        within("linear_ce dW", pair[1], ref.linear_ce_dw_ref(
            *cargs, logit_softcap=cap), 3e-2))
    del pair
    ce = full_ce_runs("linear_ce", x, y, targets, cap, lse, gr,
                      (lse - loss).detach())
    runs[f"linear_ce_fwd_{tag}"] = ce["linear_ce_fwd_lm"]
    runs[f"linear_ce_bwd_{tag}"] = ce["linear_ce_bwd_lm"]
    if extras:
        # fused_lse's deep entries (no pluck, no cap; no LM path runs
        # them: their times go to --json only)
        f_lse = linear_sce._fwd(x, y, None, None)[1]
        errs[f"fused_lse_fwd_{tag}"] = within(
            "fused_lse", f_lse, ref.fused_lse_ref(x, y), 1e-5)
        pair = linear_sce._bwd_deep(x, y, None, f_lse, gr, None, True, True)
        errs[f"fused_lse_bwd_{tag}"] = max(
            within("fused_lse dX", pair[0], ref.linear_ce_dx_ref(
                x, y, None, f_lse, gr), 3e-2),
            within("fused_lse dY", pair[1], ref.linear_ce_dw_ref(
                x, y, None, f_lse, gr), 3e-2))
        del pair
        fe = full_ce_runs("fused_lse", x, y, None, None, f_lse, gr, None)
        runs[f"fused_lse_fwd_{tag}"] = fe["fused_lse_fwd_lm"]
        runs[f"fused_lse_bwd_{tag}"] = fe["fused_lse_bwd_lm"]
    n = LM_SEQ
    io = 2 * (n * d + vocab * d)
    for fam in ("linear_ce", "fused_lse"):
        bounds[f"{fam}_fwd_{tag}"] = bf16_bound(
            io + 4 * 4 * n, 2 * n * vocab * d, n * vocab)
        bounds[f"{fam}_bwd_{tag}"] = bf16_bound(
            2 * io + 4 * 4 * n, 3 * 2 * n * vocab * d, n * vocab)

    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    sweep_slab = (slab_sweep_times(f"eval_sweep_slab_{tag}", xe[:1024], y,
                                   te[:1024], tgt_e[:1024], cfg.vocab,
                                   flush) if extras else None)
    timings = {}
    with torch.no_grad():
        for name, (kern, plain, lib) in runs.items():
            reps = 2 if "_ce_" in name or "fused" in name else 5
            timings[name] = {"ms": time_ms(kern, reps, flush),
                             "plain_ms": time_ms(plain, 1, flush),
                             "library_ms": time_ms(lib, 2, flush),
                             **bf16_bound_keys(bounds[name]),
                             "max_abs_err": errs[name]}
    for name, t in timings.items():
        print(f"  time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library (bf16) "
              f"{t['library_ms']:.4f} ms, bound {bound_text(t)}; max |Δ| "
              f"from the plain version {t['max_abs_err']:.3e}")
    print(f"  {tag}: every kernel on the bf16 wgmma product repeats bit for "
          "bit; the selections and eval within 1e-5·max + 2e-4·|·| of f64 "
          "(ids where the gap is above it; gt within the columns that close "
          "to the target, eq >= 1), every target score its slab column bit "
          "for bit; SCE and linear_ce forwards within 1e-5 and "
          "backwards within 3e-2 of their scale of the plain versions; the "
          "bf16 dY sum is the f32 sum rounded once ok")
    return {"timings": timings, "sweep_slab": sweep_slab}


def full_ce_runs(fam, x, y, tt, cap, lse, gr, pos):
    """name → (kernel, plain, library) callables of one full-CE family's
    forward and one-launch backward at these inputs (``tt`` None: the
    fused family)."""
    import torch

    from repro_torch.kernels import linear_sce, ref

    n = x.shape[0]
    args = (x, y, tt, lse, gr)

    def lib_logits():
        l_ = x @ y.T
        return l_ if cap is None else cap * torch.tanh(l_ / cap)

    def lib_fwd():
        lse_ = torch.logsumexp(lib_logits(), -1)
        return lse_ if tt is None else lse_ - pos

    def lib_bwd():
        c_ = lib_logits()
        p = torch.exp(c_ - lse[:, None])
        if tt is not None:
            p[torch.arange(n, device=x.device), tt.long()] -= 1.0
        if cap is not None:
            p = p * (1 - (c_ / cap) ** 2)
        p = (p * gr[:, None]).to(x.dtype)  # bf16 operands: G rounded
        return p @ y, p.T @ x

    if tt is None:
        from repro_torch.kernels import fused_ce

        kern_fwd = lambda: fused_ce.fused_lse_fwd(x, y)  # noqa: E731
        plain_fwd = lambda: ref.fused_lse_ref(x, y)  # noqa: E731
    else:
        kern_fwd = lambda: linear_sce.linear_ce_fwd(  # noqa: E731
            x, y, tt, logit_softcap=cap)
        plain_fwd = lambda: ref.linear_ce_loss_ref(  # noqa: E731
            x, y, tt, logit_softcap=cap)
    return {
        f"{fam}_fwd_lm": (kern_fwd, plain_fwd, lib_fwd),
        f"{fam}_bwd_lm": (
            lambda: linear_sce._bwd_deep(x, y, tt, lse, gr, cap, True, True),
            lambda: (ref.linear_ce_dx_ref(*args, logit_softcap=cap),
                     ref.linear_ce_dw_ref(*args, logit_softcap=cap)),
            lib_bwd),
    }


def lm_full_ce_kernels(dev, x, y, t, g, flush):
    """The full-CE baseline's kernels at one LM microbatch's shape (4,096
    positions, the 256,000-row padded vocabulary, d 2304: the deep
    variant, the catalog in slabs): ``linear_ce_loss``'s forward (cap 30,
    the target plucked) and its one-launch backward (dX and dW from each
    chunk's cotangent, as autograd runs it), and ``fused_lse``'s (no cap,
    no pluck), against their plain versions (f32; logits ≈ 1 here) —
    values within ``1e-5·max|want|``, gradients within ``1e-5·max|grad| +
    2e-4·|grad|``, the one launch equal to dX and dW alone bit for bit —
    then timed with a cold L2 beside the plain versions and one PyTorch
    composition (``matmul`` + ``logsumexp``; the composed backward)."""
    import torch

    from repro_torch.kernels import linear_sce, ref

    n, d = x.shape
    c = y.shape[0]
    gr = torch.rand(n, generator=g, device=dev) + 0.5

    def close(what, got, want, rtol):
        err = (got - want).abs()
        tol = 1e-5 * want.abs().max().item()
        check(bool(torch.isfinite(got).all()
                   and (err <= tol + rtol * want.abs()).all()),
              f"lm {what} differs from its plain version by "
              f"{err.max().item():.3e}")
        return err.max().item()

    errs, runs = {}, {}
    pos = None
    for fam, tt, cap in (("linear_ce", t, LM_CAP), ("fused_lse", None,
                                                    None)):
        loss, lse = linear_sce._fwd(x, y, tt, cap)
        want_lse = ref.fused_lse_ref(x, y, logit_softcap=cap)
        err = close(f"{fam} lse", lse, want_lse, 0.0)
        if tt is not None:
            want = ref.linear_ce_loss_ref(x, y, tt, logit_softcap=cap)
            err = max(err, close(f"{fam} loss", loss, want, 0.0))
            pos = (lse - loss).detach()
        pair = linear_sce._bwd_deep(x, y, tt, lse, gr, cap, True, True)
        alone = (linear_sce._dx(x, y, tt, lse, gr, cap),
                 linear_sce._dw(x, y, tt, lse, gr, cap))
        check(all(torch.equal(a, b) for a, b in zip(pair, alone)),
              f"lm {fam}: the one-launch backward differs from dX and dW "
              f"alone")
        args = (x, y, tt, lse, gr)
        gerr = max(close(f"{fam} dX", pair[0], ref.linear_ce_dx_ref(
                       *args, logit_softcap=cap), 2e-4),
                   close(f"{fam} dW", pair[1], ref.linear_ce_dw_ref(
                       *args, logit_softcap=cap), 2e-4))
        del pair, alone
        errs[f"{fam}_fwd_lm"], errs[f"{fam}_bwd_lm"] = err, gerr
        print(f"  lm {fam} (deep, N {n}, C {c}, d {d}, cap {cap}, slabs of "
              f"{linear_sce.deep_chunk(n, c)} rows): max |Δ| forward "
              f"{err:.3e}, dX / dW {gerr:.3e}; the one-launch backward "
              f"equals dX and dW alone bit for bit ok")

        runs.update(full_ce_runs(fam, x, y, tt, cap, lse, gr, pos))
    io = 4 * (n * d + c * d)
    bounds = {"fwd": tf32x3_bound(io + 4 * 4 * n, 2 * n * c * d, n * c),
              "bwd": tf32x3_bound(2 * io + 4 * 4 * n, 3 * 2 * n * c * d,
                                  n * c)}
    timings = {}
    with torch.no_grad():
        for name, (kern, plain, lib) in runs.items():
            timings[name] = {"ms": time_ms(kern, 3, flush),
                             "plain_ms": time_ms(plain, 1, flush),
                             "library_ms": time_ms(lib, 2, flush),
                             **bound_keys(bounds[name[-6:-3]])}
    return timings, errs


def lm_micro(arch):
    """train_4k's microbatches of an LM arch: one sequence each, so also
    the sequences a step here (gemma-2: 2, granite: 8)."""
    from repro_torch.configs import get_arch

    return get_arch(arch).microbatches["train_4k"]


def lm_phases(n_micro, sce=True):
    """The ``mark`` phases of an LM step of ``n_micro`` microbatches."""
    per = ("forward", "select", "loss_forward", "backward") if sce else (
        "forward", "loss_forward", "backward")
    return ("h2d",) + per * n_micro + ("optimizer",)


class MemMarks(StepMarks):
    """:class:`StepMarks` that also reads, at each mark, the bytes the
    caching allocator holds for tensors and their peak since the reset
    (host-side counters: no sync)."""

    def __init__(self, phases):
        super().__init__(phases)
        self.mem = []

    def __call__(self, name):
        import torch

        super().__call__(name)
        if name == "start":
            self.mem.append([])
        self.mem[-1].append((name, torch.cuda.memory_allocated(),
                             torch.cuda.max_memory_allocated()))

    def peak_phase(self):
        """(step, index of the phase, its name, the peak) of the mark
        where the run's peak was first seen, and each step's allocated
        bytes at its start."""
        peak = max(m[2] for step in self.mem for m in step)
        for i, step in enumerate(self.mem):
            for j, (name, _, top) in enumerate(step):
                if top == peak:
                    return {"step": i, "mark": j, "phase": name,
                            "peak": peak,
                            "start_bytes": [st[0][1] for st in self.mem]}
        return None


def lm_full_ce_phase(dev, cfg, sce, arch="gemma2-2b"):
    """An LM's full-CE baseline, the paper's comparison at LM scale:
    ``train(arch, …, steps=2, train_loss="ce_fused_linear")`` from the
    SCE run's seed (the same initial parameters and batches), the final
    softcap (gemma-2's 30; granite has none) inside the deep
    ``linear_ce`` (no SCE selection, no evaluation): its launch counts
    from 0 around the run, finite and falling loss, its median step,
    phases and peak memory printed beside SCE's (``sce``:
    :func:`lm_train_phase`'s result)."""
    import statistics

    import torch

    from repro_torch.kernels import guard, linear_sce
    from repro_torch.launch.train import train

    n_micro = lm_micro(arch)
    phases = lm_phases(n_micro, sce=False)
    counters = (linear_sce.linear_ce_fwd, linear_sce.linear_ce_dx,
                linear_sce.linear_ce_dw, linear_sce.linear_ce_split)
    marks = MemMarks(phases)
    guard.run_conformance(device=dev)  # the canaries' launches come first
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters:  # the full-CE LM path starts here
        fn.launches = 0
    t0 = time.monotonic()
    out = train(arch, cfg=cfg, batch=n_micro, seq_len=LM_SEQ,
                steps=LM_CE_STEPS, seed=0, log_every=1, device=dev,
                guard_policy="warn", mark=marks,
                train_loss="ce_fused_linear")
    wall_s = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in counters}  # ... ends here
    peak = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    n_mb = LM_CE_STEPS * n_micro
    check(len(losses) == LM_CE_STEPS
          and all(math.isfinite(v) for v in losses),
          f"full-CE LM losses {losses}")
    check(losses[-1] < losses[0], f"full-CE LM loss {losses[-1]} is not "
          f"below the first step's {losses[0]}")
    check(out["skipped_steps"] == 0, f"{out['skipped_steps']} steps skipped")
    for name in ("linear_ce_fwd", "linear_ce_dx", "linear_ce_dw"):
        check(launches[name] == n_mb,
              f"{name} launched {launches[name]} times, not {n_mb}")
    check(launches["linear_ce_split"] == 0,
          "the deep full CE split its inputs into planes")
    median_ms = statistics.median(out["step_s"][1:]) * 1e3
    bd = marks.breakdown()
    sce_bd = sce["breakdown"]
    print(f"  {arch} {cfg.dtype} ({lm_depth(cfg, arch)}), "
          f"train_loss=ce_fused_linear: {LM_CE_STEPS} "
          f"steps of {n_micro} × {LM_SEQ} tokens in {wall_s:.2f} s; loss "
          f"{' → '.join(f'{v:.4f}' for v in losses)}; median step "
          f"{median_ms:.1f} ms against SCE's {sce['median_step_ms']:.1f} ms "
          f"(host clock, steps 2–); launches {launches}")
    print("  full-CE step breakdown: " + " + ".join(
        f"{p} {bd[p + '_ms']:.1f}" for p in dict.fromkeys(phases))
        + f" = {sum(bd.values()):.1f} ms; SCE's: " + " + ".join(
            f"{p} {sce_bd[p + '_ms']:.1f}"
            for p in dict.fromkeys(lm_phases(n_micro)))
        + f" = {sum(sce_bd.values()):.1f} ms (device events, all "
          f"{n_micro} microbatches, steps 2–)")
    print(f"  peak device memory: full CE {peak / 2**30:.2f} GiB against "
          f"SCE's {sce['peak_bytes'] / 2**30:.2f} GiB (max_memory_allocated;"
          f" {live / 2**30:.2f} GiB live before)")
    return {"losses": losses, "step_s": out["step_s"], "wall_s": wall_s,
            "median_step_ms": median_ms, "breakdown": bd,
            "launches": launches, "peak_bytes": peak,
            "live_bytes_before": live, "peak_phase": marks.peak_phase()}


def lm_depth(cfg, arch="gemma2-2b"):
    """The layers, and ``reduced`` where depth was cut."""
    from repro_torch.configs import get_arch

    full = get_arch(arch).make_config().n_layers
    return (f"{cfg.n_layers} layers" if cfg.n_layers == full else
            f"{cfg.n_layers} layers, reduced from {full}")


def lm_train_phase(dev, cfg, steps=LM_STEPS, arch="gemma2-2b"):
    """``train(arch, cfg=…, batch=n, seq_len=4096, steps=4,
    sce_mode="exact")`` at full width under the guard's ``warn``: train_4k's
    n microbatches of one sequence (4,096 positions; gemma-2: 2, granite:
    8) a step, SCE at the arch's parameters (gemma-2: n_b 128, b_x 128,
    b_y 1024, cap 30; granite: b_y 512, no cap) through the deep
    ``mips_topk`` chain and ``sce_gather_plse``, the arch's optimizer's
    guarded update written in place, and after the last step the
    token-rank evaluation of 2 held-out sequences (8,192 rows:
    ``eval_fused`` at k 1 with the LSE). The launch counts from 0 around
    the run, its median step and phases (``mark``), the peak memory and
    the mark where it was reached; for an MoE model the assignments its
    forwards dropped, per step (``models/moe.py::count_drops``)."""
    import contextlib
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import eval_fused, guard, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.steps import build_sce_config
    from repro_torch.launch.train import train
    from repro_torch.models import moe

    n_micro = lm_micro(arch)
    phases = lm_phases(n_micro)
    sce_cfg = build_sce_config(
        LM_SEQ, cfg.vocab, bucket_size_y=get_arch(arch).sce_bucket_size_y,
        logit_softcap=cfg.final_softcap)
    counters = (mips_topk, *(getattr(sce_prefetch, n) for n in GATHER + PLSE),
                sce_prefetch.sce_gather_dy_sum, eval_fused.eval_fused,
                eval_fused.eval_tgt_gather)
    marks = MemMarks(phases)
    guard.run_conformance(device=dev)  # the canaries' launches come first
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counting = (moe.count_drops() if cfg.moe is not None
                else contextlib.nullcontext([]))
    for fn in counters:  # the LM main path starts here
        fn.launches = 0
    mips_topk.launches_by_k.clear()
    t0 = time.monotonic()
    with counting as drops:
        out = train(arch, cfg=cfg, batch=n_micro, seq_len=LM_SEQ,
                    steps=steps, seed=0, sce_mode="exact", log_every=1,
                    eval_every=steps, eval_users=LM_EVAL_SEQS, device=dev,
                    guard_policy="warn", mark=marks)
    wall_s = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in counters}  # ... ends here
    by_k = dict(mips_topk.launches_by_k)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    n_mb = steps * n_micro
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"LM losses {losses}")
    check(losses[-1] < losses[0], f"LM loss {losses[-1]} is not below the "
          f"first step's {losses[0]}")
    check(out["skipped_steps"] == 0, f"{out['skipped_steps']} steps skipped")
    b_x, b_y = sce_cfg.bucket_size_x, sce_cfg.bucket_size_y
    check(by_k == {b_x: n_mb, b_y: n_mb},
          f"mips_topk by k {by_k}, not {b_x} and {b_y} {n_mb} times each")
    for name in PLSE + ("sce_gather_dy_sum",):
        check(launches[name] == n_mb,
              f"{name} launched {launches[name]} times, not {n_mb}")
    for name in GATHER:
        check(launches[name] == 0, f"{name} launched on the exact path")
    for name in ("eval_fused", "eval_tgt_gather"):
        check(launches[name] == 1, f"{name} launched {launches[name]} times "
              f"in one evaluation")
    ev = out["eval"]
    check(ev["n_tokens"] == LM_EVAL_SEQS * (LM_SEQ - 1)
          and math.isfinite(ev["loss"]), f"token-rank eval {ev}")
    dropped = None
    if cfg.moe is not None:
        # the steps' forwards: n_micro × n_layers routings a step, then
        # the evaluation's
        per_step = n_micro * cfg.n_layers
        check(len(drops) >= steps * per_step, f"{len(drops)} MoE routings "
              f"counted, fewer than the steps' {steps * per_step}")
        dropped = [int(sum(int(n) for n, _ in
                           drops[i * per_step:(i + 1) * per_step]))
                   for i in range(steps)]
        assigned = sum(a for _, a in drops[:per_step])
        check(all(0 <= v <= assigned for v in dropped),
              f"MoE drops {dropped} of {assigned}")
    median_ms = statistics.median(out["step_s"][1:]) * 1e3
    bd = marks.breakdown()
    print(f"  {arch} {cfg.dtype} ({lm_depth(cfg, arch)}; "
          f"{cfg.param_count():,} parameters; SCE n_b {sce_cfg.n_buckets}, "
          f"b_x {b_x}, b_y {b_y}, cap {sce_cfg.logit_softcap}): "
          f"{steps} steps of {n_micro} × {LM_SEQ} tokens in "
          f"{n_micro} microbatches in {wall_s:.2f} s (evaluation and set-up "
          f"included); loss {' → '.join(f'{v:.4f}' for v in losses)}; "
          f"median step {median_ms:.1f} ms (host clock, steps 2–{steps}); "
          f"launches {launches}, mips_topk by k {by_k}; [eval] {ev}")
    if dropped is not None:
        print(f"  MoE assignments dropped per step (capacity "
              f"{cfg.moe.capacity(LM_SEQ)} a sequence, "
              f"{cfg.moe.n_experts} experts, top-{cfg.moe.top_k}): "
              f"{dropped} of {assigned} ({dropped[-1] / assigned:.3%} in "
              f"the last)")
    total = sum(bd.values())
    sce_ms = sum(bd[p + "_ms"] for p in ("select", "loss_forward"))
    print("  step breakdown: " + " + ".join(
        f"{p} {bd[p + '_ms']:.1f}" for p in dict.fromkeys(phases))
        + f" = {total:.1f} ms (device events, all {n_micro} microbatches,"
        f" mean of steps 2–{steps}); SCE's selection and loss forward "
        f"{sce_ms:.1f} ms = {sce_ms / total:.1%} of it (its backward "
        f"kernels run inside the backward phase)")
    pk = marks.peak_phase()
    print(f"  peak device memory of the run: {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated; {live / 2**30:.2f} GiB live before), "
          f"first reached by mark {pk['mark']} ({pk['phase']}) of step "
          f"{pk['step'] + 1}; allocated at each step's start "
          + ", ".join(f"{v / 2**30:.2f}" for v in pk["start_bytes"])
          + " GiB")
    return {"losses": losses, "step_s": out["step_s"], "wall_s": wall_s,
            "median_step_ms": median_ms, "breakdown": bd,
            "launches": launches, "mips_topk_launches_by_k": by_k,
            "eval": ev, "peak_bytes": peak, "live_bytes_before": live,
            "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "peak_phase": pk, "moe_dropped": dropped,
            "sce": (sce_cfg.n_buckets, b_x, b_y)}


def lm_serve_phase(dev, cfg, arch="gemma2-2b"):
    """On random weights (seed 1): the token-rank evaluation of 2
    held-out sequences timed by its phases (rows/s), then a 512-token
    prompt prefilled and 8 tokens decoded, the last decode's logits held
    to a forward over all 520 tokens (teacher forcing: the decoded tokens
    are the sequence's own). An MoE model routes the prefill, each
    one-token decode step and the forward each by its own capacity, and
    a token's top-k can differ between the paths where two router
    probabilities lie within rounding: either changes the token's FFN,
    and the change cascades. So the drops of each path and the (layer,
    token) pairs routed unlike the forward are counted and printed beside
    the difference, then the same at a capacity factor at which nothing
    can drop (``n_experts / top_k``); the comparison is held on the same
    weights with every token routed to every expert (top-k =
    ``n_experts``, capacity L: no choice to flip, nothing dropped; the
    sort, ranks, dispatch and combine still run): printed in bf16 (the
    layers' bf16 rounding in two orders), held on the weights widened to
    f32 (exact) within ``1e-3`` of the scale."""
    import dataclasses

    import torch

    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.eval import evaluate_streaming_lm
    from repro_torch.launch.steps import (make_lm_decode_step,
                                          make_lm_prefill_step)
    from repro_torch.models import moe, transformer

    from repro_torch.optim.optimizers import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    params = transformer.init_params(cfg, seed=1, device=dev)
    leaves = tree_leaves(params)
    n_values = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"  parameters as stored (padded: heads, experts, vocabulary): "
          f"{n_values:,} values, {n_bytes:,} B; {cfg.param_count():,} "
          f"counted as the reference counts them")
    del leaves
    held, _ = SequenceDataset(SeqDataConfig(
        n_items=cfg.vocab, seq_len=LM_SEQ, batch_size=LM_EVAL_SEQS,
        min_len_frac=1.0)).heldout_batch(Cursor(seed=0))
    evaluate_streaming_lm(params, cfg, held)  # warm
    marks = StepMarks(EVAL_PHASES)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ev = evaluate_streaming_lm(params, cfg, held, mark=marks)
    torch.cuda.synchronize()
    eval_s = time.monotonic() - t0
    rows = LM_EVAL_SEQS * LM_SEQ
    bd = marks.breakdown(skip=0)
    print(f"  token-rank evaluation: {rows} rows ({int(ev['n_tokens'])} "
          f"valid) against {cfg.vocab_padded} vocabulary rows in "
          f"{eval_s * 1e3:.1f} ms = {rows / eval_s:,.0f} rows/s; phases "
          + ", ".join(f"{p} {bd[p + '_ms']:.1f}" for p in EVAL_PHASES)
          + f" ms; {ev}")
    tok = torch.from_numpy(held["tokens"][:1, :LM_PROMPT + LM_DECODE]).to(dev)
    routed = []  # an MoE model's expert ids, one (1, S) tensor a routing
    dispatch = moe.dispatch

    def spy(probs, cfg_, capacity):
        r = dispatch(probs, cfg_, capacity)
        routed.append(r.expert)
        return r

    def decode_run(cfg_, params_):
        """Prefill, decode, then the forward → (last logits, the
        forward's, prefill ms, decode ms, drops of prefill / decode /
        forward, the (layer, position) pairs whose top-k experts differ
        between the prefill or decode path and the forward)."""
        prefill = make_lm_prefill_step(cfg_, cache_len=LM_PROMPT + LM_DECODE)
        decode = make_lm_decode_step(cfg_)
        drops = {}
        routed.clear()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with moe.count_drops() as d_:
            logits, cache = prefill(params_, tok[:, :LM_PROMPT])
        torch.cuda.synchronize()
        prefill_ms = (time.monotonic() - t0) * 1e3
        drops["prefill"] = d_
        step_ms = []
        with moe.count_drops() as d_:
            for j in range(LM_DECODE):
                t0 = time.monotonic()
                logits, cache = decode(params_, cache, tok[
                    :, LM_PROMPT + j:LM_PROMPT + j + 1], LM_PROMPT + j)
                torch.cuda.synchronize()
                step_ms.append((time.monotonic() - t0) * 1e3)
        drops["decode"] = d_
        with torch.no_grad(), moe.count_drops() as d_:
            hidden, _ = transformer.forward(params_, cfg_, tok)
            want = transformer.logits_from_hidden(params_, cfg_,
                                                  hidden[:, -1:])
        drops["forward"] = d_
        counts = {k: int(sum(int(n) for n, _ in v)) for k, v in drops.items()}
        flips = None
        if cfg_.moe is not None:
            n_l, k = cfg_.n_layers, cfg_.moe.top_k
            ids = [e.reshape(-1, k).sort(-1).values for e in routed]
            pre, dec, fwd = (ids[:n_l], ids[n_l:n_l * (1 + LM_DECODE)],
                             ids[n_l * (1 + LM_DECODE):])
            check(len(fwd) == n_l, f"{len(routed)} MoE routings recorded")
            flips = sum(int((pre[i] != fwd[i][:LM_PROMPT]).any(-1).sum())
                        for i in range(n_l))
            flips += sum(int((dec[j * n_l + i][0] != fwd[i][LM_PROMPT + j])
                             .any()) for j in range(LM_DECODE)
                         for i in range(n_l))
        return logits, want, prefill_ms, step_ms, counts, flips

    def held_to(logits, want):
        err = (logits - want).abs().max().item()
        scale = want[..., :cfg.vocab].abs().max().item()
        check(bool(torch.isfinite(logits[..., :cfg.vocab]).all())
              and logits.shape == (1, 1, cfg.vocab_padded),
              f"decode logits {tuple(logits.shape)}")
        return err, scale, bool(logits.argmax(-1).eq(want.argmax(-1)).all())

    # f32: 1e-3 of the scale; bf16 (8 bits of mantissa, the KV cache and
    # the attention in another order): the reference's bf16 tolerance
    tol = 1e-3 if cfg.dtype == "float32" else 3e-2
    moe.dispatch = spy
    try:
        logits, want, prefill_ms, step_ms, counts, flips = decode_run(
            cfg, params)
        err, scale, top_equal = held_to(logits, want)
        out = {"eval": ev, "eval_s": eval_s,
               "eval_rows_per_s": rows / eval_s, "eval_breakdown": bd,
               "prefill_ms": prefill_ms, "decode_ms": step_ms,
               "decode_max_abs_err": err, "decode_scale": scale,
               "decode_argmax_equal": top_equal, "param_values": n_values,
               "param_bytes": n_bytes}
        n_pairs = cfg.n_layers * (LM_PROMPT + LM_DECODE)
        print(f"  prefill {LM_PROMPT} tokens {prefill_ms:.1f} ms, "
              f"{LM_DECODE} decode steps "
              f"{', '.join(f'{t:.1f}' for t in step_ms)} ms (host clock); "
              f"the last decode's logits against a forward over "
              f"{LM_PROMPT + LM_DECODE} tokens: max |Δ| {err:.3e} (scale "
              f"{scale:.3f}, tolerance {tol} of it, {cfg.dtype}), the same "
              f"argmax: {top_equal}"
              + ("" if cfg.moe is None else
                 f"; MoE assignments dropped: prefill {counts['prefill']}, "
                 f"decode {counts['decode']}, forward {counts['forward']}; "
                 f"(layer, token) pairs routed to other experts than the "
                 f"forward's: {flips} of {n_pairs}"))
        if cfg.moe is None:
            check(err <= tol * scale, f"the last decode's logits differ "
                  f"from the forward's by {err:.3e} (scale {scale:.3e}, "
                  f"tolerance {tol})")
            print("  decode against the forward ok")
            return out
        # An MoE model: a routing unlike the forward's (a drop, or a top-k
        # that rounding reorders where two router probabilities nearly
        # tie) changes that token's FFN, and such a change cascades into
        # later layers and tokens. So: the same at a capacity factor that
        # drops nothing (printed: what the near-ties alone do), then where
        # the routing has no choice to make — every token to every expert
        # (top-k = n_experts, capacity = L: nothing drops) — in bf16
        # (printed: 32 layers of bf16 rounding in two orders) and held on
        # the same weights widened to f32 (exact) within 1e-3.
        check(counts["decode"] == 0, f"a one-token decode step dropped "
              f"{counts['decode']} assignments")
        m = cfg.moe
        roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
        logits, want, _, _, counts_r, flips_r = decode_run(roomy, params)
        err_r, scale_r, top_r = held_to(logits, want)
        check(sum(counts_r.values()) == 0, f"capacity factor "
              f"{roomy.moe.capacity_factor} dropped {counts_r}")
        every = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, top_k=m.n_experts, capacity_factor=1.0))
        logits, want, _, _, counts_e, flips_e = decode_run(every, params)
        err_e, scale_e, top_e = held_to(logits, want)
        check(sum(counts_e.values()) == 0 and flips_e == 0,
              f"top-{m.n_experts}: drops {counts_e}, {flips_e} routings "
              f"unlike the forward's")
        del logits, want
        p32 = tree_map(lambda t: t.float(), params)
        logits, want, _, _, counts_f, flips_f = decode_run(
            dataclasses.replace(every, dtype="float32"), p32)
        err_f, scale_f, top_f = held_to(logits, want)
        del p32, logits, want
        tol32 = 1e-3
        check(sum(counts_f.values()) == 0 and flips_f == 0,
              f"top-{m.n_experts} in f32: drops {counts_f}, {flips_f} "
              f"routings unlike the forward's")
        check(err_f <= tol32 * scale_f, f"the last decode's logits differ "
              f"from the forward's by {err_f:.3e} in f32 with every token "
              f"routed to every expert (scale {scale_f:.3e}, tolerance "
              f"{tol32})")
        print(f"  at capacity factor {roomy.moe.capacity_factor} (nothing "
              f"dropped): max |Δ| {err_r:.3e} (scale {scale_r:.3f}), the "
              f"same argmax {top_r}, {flips_r} of {n_pairs} pairs routed "
              f"unlike the forward; every token to all {m.n_experts} experts"
              f" (no choice, nothing dropped): bf16 max |Δ| {err_e:.3e} "
              f"(scale {scale_e:.3f}), the same argmax {top_e}; on the same "
              f"weights in f32 max |Δ| {err_f:.3e} (scale {scale_f:.3f}, "
              f"tolerance {tol32} of it), the same argmax {top_f} ok")
        out.update(moe_dropped=counts, moe_flips=flips,
                   no_drops={"max_abs_err": err_r, "scale": scale_r,
                             "argmax_equal": top_r, "flips": flips_r},
                   every_expert_bf16={"max_abs_err": err_e,
                                      "scale": scale_e,
                                      "argmax_equal": top_e},
                   every_expert_f32={"max_abs_err": err_f,
                                     "scale": scale_f,
                                     "argmax_equal": top_f})
        return out
    finally:
        moe.dispatch = dispatch


def lm_phase(dev):
    """Phase 18: the kernels at gemma-2's shapes in f32 and in bf16, the
    main path as published (bf16: SCE training, the full-CE baseline,
    token rank, prefill and decode), then the same SCE and full-CE steps
    in f32 at reduced depth."""
    import torch

    cfg, cfg32 = lm_config(), lm_config_f32()
    kern = lm_kernel_phase(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    kern_bf16 = lm_bf16_kernel_phase(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    trained = lm_train_phase(dev, cfg)
    full_ce = lm_full_ce_phase(dev, cfg, trained)
    served = lm_serve_phase(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    trained32 = lm_train_phase(dev, cfg32, steps=LM_F32_STEPS)
    full_ce32 = lm_full_ce_phase(dev, cfg32, trained32)
    print(f"  card: {smi()}")
    return {"kernels": kern, "kernels_bf16": kern_bf16, "train": trained,
            "full_ce": full_ce, "serve": served, "train_f32": trained32,
            "full_ce_f32": full_ce32}


# ---------------------------------------------------------------------------
# BERT4Rec at full width
# ---------------------------------------------------------------------------
B4R_BATCH = 1024  # train_batch's 65,536 sequences cut to one card
B4R_MICRO = 8  # train_batch's microbatches: 128 sequences each
B4R_STEPS = 4
B4R_POS = B4R_BATCH // B4R_MICRO * 200  # 25,600 positions a microbatch
B4R_N_B, B4R_B_X, B4R_B_Y = 320, 320, 512  # build_sce_config(25,600, 10⁶)
B4R_TOP_K = 100  # serve_p99's and retrieval_cand's top-k (the steps' own)
B4R_SERVE = 512  # serve_p99's histories
B4R_PHASES = (("h2d",) + ("forward", "select", "loss_forward", "backward")
              * B4R_MICRO + ("optimizer",))
# The kernels line's BERT4Rec entries: (name, the TPU kernel it replaces,
# the timing of the kernel phase it carries).
B4R_MIPS = ("positions_k320", "catalog_k512", "serve_b512_k10",
            "serve_p99_k100", "retrieval_k100")


def b4r_config():
    """bert4rec as published (``configs/bert4rec.py``): 10⁶ items, d 64,
    L 200, 2 blocks, 2 heads, f32."""
    from repro_torch.configs.bert4rec import make_config

    cfg = make_config()
    check((cfg.n_items, cfg.catalog_loss_size, cfg.n_rows, cfg.d_model,
           cfg.max_len, cfg.n_layers, cfg.n_heads, cfg.causal)
          == (1_000_000, 1_000_000, 1_000_016, D, 200, 2, 2, False),
          f"bert4rec's published config changed: {cfg}")
    return cfg


def b4r_kernel_phase(dev, cfg):
    """BERT4Rec's kernels alone at its shapes against their plain
    versions, each timed with a cold L2 beside its plain version, a
    PyTorch call of its function and its bound: ``mips_topk`` at the two
    SCE selections of a microbatch (320 bucket centres against 25,600
    positions at k 320 under a cloze mask of ≈ 15 % valid, and against
    the 10⁶ catalog rows at k 512), at serving's bucket 512 (k 10, window
    [1, 10⁶)), at serve_p99 (512 × 10⁶, k 100, window [0, 10⁶)) and at
    retrieval_cand (1 × 10⁶ gathered candidates, k 100); the three
    ``sce_gather_plse`` launches and the dY sum at n_b 320, b_x 320,
    b_y 512, d 64 on that selection; ``eval_fused`` / ``eval_tgt_gather``
    at B 256 against the catalog (k 10). Phase 6's and 11's tolerances."""
    import torch

    from repro_torch.core import sce
    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels import ref, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.kernels.ref import mips_topk_ref

    g = torch.Generator(device=dev).manual_seed(9)
    c = cfg.catalog_loss_size

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = randn(B4R_POS, D)  # one microbatch's hidden states
    y = randn(c, D, scale=0.02)  # the catalog at its init scale
    valid = torch.rand(B4R_POS, generator=g, device=dev) < 0.15  # cloze
    targets = torch.randint(1, cfg.n_items, (B4R_POS,), generator=g,
                            device=dev, dtype=torch.int32)
    scfg = sce.SCEConfig.from_alpha_beta(B4R_POS, cfg.n_items,
                                         bucket_size_y=B4R_B_Y,
                                         use_kernel=True)
    check((scfg.n_buckets, scfg.bucket_size_x, scfg.bucket_size_y)
          == (B4R_N_B, B4R_B_X, B4R_B_Y), f"BERT4Rec's SCE shape {scfg}")
    b = sce.make_bucket_centers(x, B4R_N_B, use_mix=True, valid_mask=valid,
                                generator=g)
    gid = torch.arange(c, device=dev)
    serve_q = randn(B4R_SERVE, D)
    cand = torch.randperm(c, generator=g, device=dev)
    mips_inputs = {  # name: (q, catalog, k, valid)
        "positions_k320": (b, x, B4R_B_X, valid),
        "catalog_k512": (b, y, B4R_B_Y, None),
        "serve_b512_k10": (serve_q, y, K, (gid >= 1) & (gid < cfg.n_items)),
        "serve_p99_k100": (serve_q, y, B4R_TOP_K, gid < cfg.n_items),
        "retrieval_k100": (serve_q[:1], y[cand], B4R_TOP_K, None),
    }
    cases = [run_case(f"b4r_{name}", q, cat, k, valid=vm)
             for name, (q, cat, k, vm) in mips_inputs.items()]
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    timings = {}
    for (name, (q, cat, k, vm)), case in zip(mips_inputs.items(), cases):
        def library(q=q, cat=cat, k=k, vm=vm):
            s_ = torch.matmul(q, cat.T)
            if vm is not None:
                s_ = torch.where(vm[None, :], s_, NEG_INF)
            return torch.topk(s_, k)

        bd, by = bound_ms(q.shape[0], cat.shape[0], D, k,
                          valid=vm is not None)
        timings[f"mips_topk_{name}"] = {
            "ms": time_ms(lambda: mips_topk(q, cat, k, valid=vm), 20, flush),
            "plain_ms": time_ms(lambda: mips_topk_ref(q, cat, k, valid=vm),
                                1, flush),
            "library_ms": time_ms(library, 20, flush),
            "bound_ms": bd, "bound_by": by,
            "max_abs_err": case["max_abs_err"]}

    # The partial LSE of the exact mode on the (1, 1) mesh (every
    # candidate owned) on that selection, and the gathered dY's sum.
    idx_x, idx_y = sce.select_buckets(b, x, y, scfg, valid_mask=valid)
    x_b = x[idx_x.long()].contiguous()
    tgt_b = targets[idx_x.long()]
    pcase = plse_case("b4r_plse", x_b, y, idx_y, tgt_b, idx_y)
    pargs = (x_b, y, idx_y, tgt_b, idx_y)
    g_up = torch.rand(x_b.shape[:2], generator=g, device=dev)
    plse = sce_prefetch.sce_gather_plse_fwd(*pargs)
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y)]
    out = (ref.sce_gather_plse_ref(leaves[0], leaves[1], *pargs[2:])
           * g_up).sum()
    y_b = y[idx_y.long()]
    hide = (idx_y[:, None, :] < 0) | (idx_y[:, None, :] == tgt_b[:, :, None])
    bias = torch.where(hide, NEG_INF, 0.0)
    probs = torch.rand(B4R_N_B, B4R_B_X, B4R_B_Y, generator=g, device=dev)
    ws = torch.empty(B4R_N_B * B4R_B_Y, D, device=dev)

    def dy_kernel():  # the dY kernel alone, into the workspace
        sce_prefetch._launch(
            "sce_gather_dy_launch",
            (x_b, y, idx_y, tgt_b, idx_y, plse, g_up, ws, 0.0),
            (B4R_N_B, B4R_B_X, B4R_B_Y, c, D), dev)
        return ws

    def dy_plain():
        p = torch.where(hide, 0.0, torch.exp(torch.bmm(
            x_b, y_b.transpose(1, 2)) - plse[..., None]) * g_up[..., None])
        return torch.bmm(p.transpose(1, 2), x_b).reshape(-1, D)

    dy_kernel()
    keys, order = sce_prefetch.dy_sum_keys(idx_y, idx_y, c)
    dyz = torch.zeros_like(y)
    got = sce_prefetch.sce_gather_dy_sum(ws, keys, order, dyz)
    want = sce_prefetch.dy_sum_plain(ws, idx_y, idx_y, c)
    torch.cuda.synchronize()
    err = (got - want).abs()
    check(bool((err <= 1e-5 * want.abs().max() + 2e-4 * want.abs()).all()),
          f"b4r sce_gather_dy_sum differs by {err.max().item():.3e}")
    sum_err = err.max().item()
    lib_c = torch.zeros_like(y)
    runs = {
        "sce_gather_plse_fwd": (
            lambda: sce_prefetch.sce_gather_plse_fwd(*pargs),
            lambda: ref.sce_gather_plse_ref(*pargs),
            lambda: torch.logsumexp(torch.baddbmm(
                bias, x_b, y_b.transpose(1, 2)), dim=-1)),
        "sce_gather_plse_dx": (
            lambda: sce_prefetch.sce_gather_plse_dx(*pargs, plse, g_up),
            lambda: torch.autograd.grad(out, leaves[0], retain_graph=True),
            lambda: torch.bmm(probs, y_b)),
        "sce_gather_plse_dy": (dy_kernel, dy_plain,
                               lambda: torch.bmm(probs.transpose(1, 2),
                                                 x_b)),
        "sce_gather_dy_sum": (
            lambda: sce_prefetch.sce_gather_dy_sum(ws, keys, order, dyz),
            lambda: sce_prefetch.dy_sum_plain(ws, idx_y, idx_y, c),
            lambda: lib_c.index_add_(0, idx_y.reshape(-1).long(), ws)),
    }
    bounds = plse_bounds(*pargs)
    bounds["sce_gather_dy_sum"] = dy_sum_bound(idx_y, idx_y, D)
    errs = {"sce_gather_plse_fwd": pcase["max_abs_err"]["plse"],
            "sce_gather_plse_dx": pcase["max_abs_err"]["dx"],
            "sce_gather_plse_dy": pcase["max_abs_err"]["dy"],
            "sce_gather_dy_sum": sum_err}
    with torch.no_grad():
        for name, (kern, plain, lib) in runs.items():
            timings[name] = {"ms": time_ms(kern, 20, flush),
                             "plain_ms": time_ms(plain, 3, flush),
                             "library_ms": time_ms(lib, 20, flush),
                             "max_abs_err": errs[name],
                             **bound_keys(bounds[name])}

    # The evaluation's sweep: 256 users against the catalog, 8 targets
    # planted at the top of their rows.
    xe = randn(EVAL_B[1], D)
    te = torch.randint(1, cfg.n_items, (EVAL_B[1],), generator=g,
                       device=dev, dtype=torch.int32)
    ye = y.clone()
    ye[te[:8].long()] = 0.05 * xe[:8]
    window = dict(c_lo=1, c_hi=cfg.n_items)
    ecase = eval_case("b4r_eval_b256", xe, ye, te, K, **window)
    tgt = ek.eval_tgt_gather(xe, ye, te)
    wmask = (gid >= 1) & (gid < cfg.n_items)

    def fused_library():
        s_ = torch.where(wmask[None, :], torch.matmul(xe, ye.T), NEG_INF)
        return (torch.topk(s_, K), (s_ > tgt[:, None]).sum(1),
                (s_ == tgt[:, None]).sum(1))

    bf, bg = eval_bounds(EVAL_B[1], c, D, K, int(torch.unique(te).numel()))
    for name, kern, plain, lib, bound, err in (
            ("eval_fused",
             lambda: ek.eval_fused(xe, ye, te, K, tgt_scores=tgt, **window),
             lambda: ref.eval_fused_ref(xe, ye, te, K, tgt_scores=tgt,
                                        **window),
             fused_library, bf, ecase["max_abs_err"]),
            ("eval_tgt_gather", lambda: ek.eval_tgt_gather(xe, ye, te),
             lambda: ref.eval_tgt_gather_ref(xe, ye, te),
             lambda: (xe * ye[te.long()]).sum(-1), bg, ecase["tgt_err"])):
        timings[name] = {"ms": time_ms(kern, 20, flush),
                         "plain_ms": time_ms(plain, 2, flush),
                         "library_ms": time_ms(lib, 20, flush),
                         "bound_ms": bound[0], "bound_by": bound[1],
                         "max_abs_err": err}
    for name, t in timings.items():
        print(f"  time {name} (BERT4Rec): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {bound_text(t)}")
    return {"cases": cases, "plse_case": pcase, "eval_case": ecase,
            "dy_sum_max_abs_err": sum_err, "timings": timings}


def b4r_train_phase(dev, cfg):
    """``train("bert4rec", cfg=…, batch=1024, steps=4, sce_mode="exact")``
    at full width under the guard's ``warn``: train_batch's 8
    microbatches of 128 sequences, each with its cloze mask, SCE (n_b
    320, b_x 320, b_y 512) through ``mips_topk`` at k 320 and 512 and
    ``sce_gather_plse`` with the dY sum, once a microbatch; guarded AdamW.
    The launch counts from 0 around the run, its median step and phases
    (``mark``), and the peak memory."""
    import statistics

    import torch

    from repro_torch.kernels import eval_fused, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.train import train

    counters = (mips_topk, *(getattr(sce_prefetch, n) for n in GATHER + PLSE),
                sce_prefetch.sce_gather_dy_sum, eval_fused.eval_fused,
                eval_fused.eval_tgt_gather)
    marks = StepMarks(B4R_PHASES)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters:  # the BERT4Rec main path starts here
        fn.launches = 0
    mips_topk.launches_by_k.clear()
    t0 = time.monotonic()
    out = train("bert4rec", cfg=cfg, batch=B4R_BATCH, steps=B4R_STEPS,
                seed=0, sce_mode="exact", log_every=1, device=dev,
                guard_policy="warn", mark=marks)
    wall_s = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in counters}  # ... ends here
    by_k = dict(mips_topk.launches_by_k)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    n_mb = B4R_STEPS * B4R_MICRO
    check(len(losses) == B4R_STEPS and all(math.isfinite(v) for v in losses),
          f"BERT4Rec losses {losses}")
    check(out["skipped_steps"] == 0, f"{out['skipped_steps']} steps skipped")
    check(by_k == {B4R_B_X: n_mb, B4R_B_Y: n_mb},
          f"mips_topk by k {by_k}, not {B4R_B_X} and {B4R_B_Y} {n_mb} "
          f"times each")
    for name in PLSE + ("sce_gather_dy_sum",):
        check(launches[name] == n_mb,
              f"{name} launched {launches[name]} times, not {n_mb}")
    for name in GATHER + ("eval_fused", "eval_tgt_gather"):
        check(launches[name] == 0, f"{name} launched in the BERT4Rec steps")
    median_ms = statistics.median(out["step_s"][1:]) * 1e3
    bd = marks.breakdown()
    print(f"  bert4rec ({cfg.n_items:,} items, d {cfg.d_model}, L "
          f"{cfg.max_len}, {cfg.n_layers} blocks, {cfg.n_heads} heads, "
          f"{cfg.dtype}): {B4R_STEPS} steps of {B4R_BATCH} sequences in "
          f"{B4R_MICRO} microbatches in {wall_s:.2f} s (set-up included); "
          f"loss {' → '.join(f'{v:.4f}' for v in losses)}; median step "
          f"{median_ms:.1f} ms (host clock, steps 2–{B4R_STEPS}); launches "
          f"{launches}, mips_topk by k {by_k}")
    total = sum(bd.values())
    print("  step breakdown: " + " + ".join(
        f"{p} {bd[p + '_ms']:.2f}" for p in dict.fromkeys(B4R_PHASES))
        + f" = {total:.2f} ms (device events, all {B4R_MICRO} microbatches,"
        f" mean of steps 2–{B4R_STEPS})")
    print(f"  peak device memory of the run: {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated; {live / 2**30:.2f} GiB live before)")
    return {"losses": losses, "step_s": out["step_s"], "wall_s": wall_s,
            "median_step_ms": median_ms, "breakdown": bd,
            "launches": launches, "mips_topk_launches_by_k": by_k,
            "peak_bytes": peak, "live_bytes_before": live}


def b4r_serve_steps_phase(dev, cfg):
    """``make_seqrec_serve_step`` at serve_p99 (512 histories, k 100, only
    the phantom rows masked) and ``make_seqrec_retrieval_step`` at
    retrieval_cand (1 history against the 10⁶ catalog ids in a random
    order, k 100: positions back) on random weights, each held against
    a dense on-card oracle with the tie rule (values within
    ``1e-4·max|score|``, ids where the gap is above it) and timed by the
    host clock; ``mips_topk``'s launches counted from 0 around each."""
    import torch

    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.steps import (make_seqrec_retrieval_step,
                                          make_seqrec_serve_step)
    from repro_torch.models import bert4rec

    gc.collect()
    torch.cuda.empty_cache()
    params = bert4rec.init_params(cfg, seed=0, device=dev)
    hist = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=B4R_SERVE,
    )).next_batch(Cursor(seed=1))[0]["tokens"]
    tok = torch.from_numpy(hist).to(dev)
    cand = torch.randperm(cfg.catalog_loss_size,
                          generator=torch.Generator().manual_seed(2)).to(
        device=dev, dtype=torch.int32)
    y = bert4rec.item_embeddings(params, cfg)  # = the loss catalog here
    out = {}
    for name, step, args in (
            ("serve_p99", make_seqrec_serve_step(cfg), (tok,)),
            ("retrieval_cand", make_seqrec_retrieval_step(cfg),
             (tok[:1], cand))):
        mips_topk.launches = 0  # this step's path starts here
        vals, ids = step(params, *args)
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            step(params, *args)[1].cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = mips_topk.launches  # ... ends here
        check(launches == 6, f"{name}: mips_topk launched {launches} times "
              f"in 6 calls")
        with torch.inference_mode():
            x = bert4rec.forward(params, cfg, args[0])[:, -1]
            rows = y if name == "serve_p99" else y[cand.long()]
            raw = x @ rows.T
            want_v, want_i = dense_topk(raw, B4R_TOP_K + 1)
        scale = raw.abs().max().item()
        tol = 1e-4 * scale
        err = compare((vals, ids), (want_v[:, :B4R_TOP_K],
                                    want_i[:, :B4R_TOP_K]),
                      want_v[:, B4R_TOP_K], tol, exact=False)
        check(bool(((ids >= 0) & (ids < rows.shape[0])).all()),
              f"{name}: an id outside [0, {rows.shape[0]})")
        ms.sort()
        out[name] = {"n_q": int(args[0].shape[0]), "k": B4R_TOP_K,
                     "candidates": rows.shape[0], "launches": launches,
                     "oracle_max_abs_err": err, "oracle_tol": tol,
                     "ms": ms, "median_ms": ms[len(ms) // 2]}
        print(f"  {name}: {args[0].shape[0]} × {rows.shape[0]:,}, k "
              f"{B4R_TOP_K}: median {out[name]['median_ms']:.3f} ms a call "
              f"(host clock to the ids on the host, of 5: "
              f"{', '.join(f'{t:.3f}' for t in ms)}); oracle max err "
              f"{err:.3e} (tol {tol:.3e}), ids equal where isolated; "
              f"mips_topk launches {launches}")
    return out


def b4r_phase(dev):
    """Phase 19: BERT4Rec as published (10⁶ items): its kernels at its
    shapes, then the main path — SCE training, the cloze evaluation,
    ``RetrievalServer("bert4rec")`` and the serve and retrieval steps."""
    import torch

    cfg = b4r_config()
    kern = b4r_kernel_phase(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    trained = b4r_train_phase(dev, cfg)
    evaluation = eval_phase(dev, "bert4rec")
    server = server_phase(dev, "bert4rec")
    steps_ = b4r_serve_steps_phase(dev, cfg)
    print(f"  card: {smi()}")
    return {"kernels": kern, "train": trained, "eval": evaluation,
            "server": server, "serve_steps": steps_}


# ---------------------------------------------------------------------------
# granite-moe-3b-a800m at full width
# ---------------------------------------------------------------------------
GRANITE = "granite-moe-3b-a800m"
# The kernels line's granite entries: (name, source, the TPU kernel it
# replaces); their launches come from phase 20's runs.
GRANITE_KERNELS = (
    ("mips_topk_positions_k128_granite", "mips_topk.cu", "mips_topk.py:52"),
    ("mips_topk_vocab_k512_granite", "mips_topk.cu", "mips_topk.py:52"),
    ("sce_gather_plse_fwd_granite", "sce_gather.cu", "sce_prefetch.py:497"),
    ("sce_gather_plse_dx_granite", "sce_gather.cu", "sce_prefetch.py:497"),
    ("sce_gather_plse_dy_granite", "sce_gather.cu", "sce_prefetch.py:497"),
    ("sce_gather_plse_bwd_granite", "sce_gather.cu", "sce_prefetch.py:497"),
    ("sce_gather_dy_sum_granite", "sce_gather.cu", "sce_prefetch.py:250"),
    ("eval_fused_granite", "eval_fused.cu", "eval_fused.py:104"),
    ("eval_tgt_gather_granite", "eval_fused.cu", "eval_fused.py:82"),
    ("linear_ce_fwd_granite", "linear_ce.cu", "linear_sce.py:60"),
    ("linear_ce_bwd_granite", "linear_ce.cu", "linear_sce.py:121"),
)


def granite_config():
    """granite-moe-3b-a800m as published (``configs/granite_moe.py``)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(GRANITE).make_config()
    m = cfg.moe
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_heads_padded,
           cfg.n_kv_heads, cfg.head_dim, m.n_experts, m.n_experts_padded,
           m.top_k, m.d_ff, m.capacity_factor, cfg.vocab, cfg.vocab_padded,
           cfg.dtype, cfg.final_softcap, cfg.remat, cfg.tie_embeddings)
          == (32, 1536, 24, 32, 8, 64, 40, 48, 8, 512, 1.25, 49_155,
              49_168, "bfloat16", None, True, True),
          f"granite's published config changed: {cfg}")
    return cfg


def granite_block_phase(dev, cfg, reps=5):
    """One MoE block of granite at its widths (layer 0 of seed 3's
    weights, 4,096 tokens of N(0, 1) in bf16): ``apply_moe``'s output,
    aux and the gradients of ``sum(y · w) + aux`` with respect to the
    input and every weight repeat bit for bit over two runs, the drops
    counted; then forward and forward + backward timed (CUDA events, mean
    of ``reps``)."""
    import torch

    from repro_torch.models import moe

    g = torch.Generator(device=dev).manual_seed(3)
    params = moe.init_moe(g, cfg.d_model, cfg.moe, dtype=cfg.torch_dtype,
                          device=dev)
    x = torch.randn(1, LM_SEQ, cfg.d_model, generator=g,
                    device=dev).to(cfg.torch_dtype)
    w = torch.randn(x.shape, generator=g, device=dev).to(cfg.torch_dtype)
    names = sorted(params)

    def run():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        xx = x.detach().requires_grad_(True)
        y, aux = moe.apply_moe(leaves, xx, cfg.moe)
        grads = torch.autograd.grad((y.float() * w.float()).sum() + aux,
                                    [xx] + [leaves[k] for k in names])
        return (y.detach(), aux.detach()) + tuple(grads)

    with moe.count_drops() as drops:
        first = run()
    again = run()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "granite's MoE block does not repeat bit for bit")
    check(all(bool(torch.isfinite(t).all()) for t in first),
          "granite's MoE block gave a non-finite value")
    dropped, assigned = int(drops[0][0]), drops[0][1]
    del first, again

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        a_ = torch.cuda.Event(enable_timing=True)
        b_ = torch.cuda.Event(enable_timing=True)
        a_.record()
        for _ in range(reps):
            fn()
        b_.record()
        torch.cuda.synchronize()
        return a_.elapsed_time(b_) / reps

    with torch.no_grad():
        fwd_ms = timed(lambda: moe.apply_moe(params, x, cfg.moe))
    both_ms = timed(run)
    print(f"  MoE block (d {cfg.d_model}, {cfg.moe.n_experts} experts "
          f"padded to {cfg.moe.n_experts_padded}, top-{cfg.moe.top_k}, "
          f"capacity {cfg.moe.capacity(LM_SEQ)}, {LM_SEQ} tokens, "
          f"{cfg.dtype}): output, aux and every gradient repeat bit for "
          f"bit ok; {dropped} of {assigned} assignments dropped; forward "
          f"{fwd_ms:.3f} ms, forward + backward {both_ms:.3f} ms (CUDA "
          f"events, mean of {reps})")
    return {"dropped": dropped, "assigned": assigned, "fwd_ms": fwd_ms,
            "fwd_bwd_ms": both_ms}


def granite_phase(dev):
    """Phase 20: granite-moe-3b-a800m as published: its kernels at its
    shapes on bf16, one MoE block, then the main path — SCE training, the
    full-CE baseline, token rank, prefill and decode."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_sce_config

    cfg = granite_config()
    sce_cfg = build_sce_config(
        LM_SEQ, cfg.vocab, bucket_size_y=get_arch(GRANITE).sce_bucket_size_y,
        logit_softcap=cfg.final_softcap)
    m = cfg.moe
    print(f"  {GRANITE} as published: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} query heads (padded to "
          f"{cfg.n_heads_padded}) over {cfg.n_kv_heads} KV heads of "
          f"{cfg.head_dim}, {m.n_experts} experts (padded to "
          f"{m.n_experts_padded}) top-{m.top_k} of d_ff {m.d_ff}, capacity "
          f"factor {m.capacity_factor} ({m.capacity(LM_SEQ)} slots an "
          f"expert at {LM_SEQ} tokens), vocabulary {cfg.vocab:,} "
          f"({cfg.vocab_padded:,} rows), final softcap {cfg.final_softcap},"
          f" {cfg.dtype}; {cfg.param_count():,} parameters, "
          f"{cfg.active_param_count():,} active; SCE at {LM_SEQ} positions:"
          f" n_b {sce_cfg.n_buckets}, b_x {sce_cfg.bucket_size_x}, b_y "
          f"{sce_cfg.bucket_size_y}")
    kern = lm_bf16_kernel_phase(dev, cfg, sce_cfg=sce_cfg,
                                cap=cfg.final_softcap, tag="granite",
                                extras=False)
    gc.collect()
    torch.cuda.empty_cache()
    block = granite_block_phase(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    trained = lm_train_phase(dev, cfg, arch=GRANITE)
    full_ce = lm_full_ce_phase(dev, cfg, trained, arch=GRANITE)
    served = lm_serve_phase(dev, cfg, arch=GRANITE)
    print(f"  card: {smi()}")
    return {"kernels": kern, "block": block, "train": trained,
            "full_ce": full_ce, "serve": served}


# ---------------------------------------------------------------------------
# Distribution on one card (phase 21)
# ---------------------------------------------------------------------------
SHARDS4 = 4  # the model-axis split each shard's local stage is run for
DIST_USERS = 256  # eval users of the seqrec sweeps (EVAL_B[1])
DIST_LM_SEQS, DIST_LM_T = 4, 256  # 1,024 token-rank rows at gemma's vocab
# The kernels line's shard entries: (name, timing, source, the TPU kernel
# it replaces, the sharded entry point whose launches it carries).
DIST_KERNELS = (
    ("mips_topk_shard4_serve_b512_k10", "mips_sasrec", "mips_topk.cu",
     "mips_topk.py:52", "RetrievalServer_sasrec-sce"),
    ("mips_topk_shard4_b4r_serve_p99_k100", "mips_b4r", "mips_topk.cu",
     "mips_topk.py:52", "serve_step_bert4rec"),
    ("eval_fused_shard4", "eval_fused_sasrec", "eval_fused.cu",
     "eval_fused.py:104", "evaluate_streaming_sasrec-sce"),
    ("eval_tgt_gather_shard4", "eval_tgt_gather_sasrec", "eval_fused.cu",
     "eval_fused.py:82", "evaluate_streaming_sasrec-sce"),
    ("eval_fused_shard4_b4r", "eval_fused_b4r", "eval_fused.cu",
     "eval_fused.py:104", "evaluate_streaming_bert4rec"),
    ("eval_tgt_gather_shard4_b4r", "eval_tgt_gather_b4r", "eval_fused.cu",
     "eval_fused.py:82", "evaluate_streaming_bert4rec"),
    ("eval_fused_shard4_lm_bf16", "eval_fused_lm", "eval_fused.cu",
     "eval_fused.py:104", "evaluate_streaming_lm_gemma2-2b"),
    ("eval_tgt_gather_shard4_lm_bf16", "eval_tgt_gather_lm", "eval_fused.cu",
     "eval_fused.py:82", "evaluate_streaming_lm_gemma2-2b"),
)


def shard_blocks(y):
    """The catalog's ``SHARDS4`` model blocks and their ``id_offset``s."""
    per = y.shape[0] // SHARDS4
    check(per * SHARDS4 == y.shape[0], f"{y.shape[0]} rows do not split 4 ways")
    return [(y[j * per:(j + 1) * per], j * per) for j in range(SHARDS4)]


def shard_eval(x, y, t, k, *, c_lo, c_hi, cap=None, with_lse=False):
    """The sharded evaluation's local stages, one model shard after the
    other as ``eval/harness.py``'s sharded sweep runs them: each shard's
    ``eval_tgt_gather`` at its ``id_offset`` summed over the shards (the
    owner's score and exact zeros: the ``psum``) before the sweeps, each
    shard's ``eval_fused`` against it, and the collectives' own merges
    (``merge_gathered_topk``, ``merge_gathered_lse``; the counts summed)
    → ``(vals, ids, gt, eq, tgt, lse or None)``."""
    import torch

    from repro_torch.dist.collectives import (merge_gathered_lse,
                                              merge_gathered_topk)
    from repro_torch.kernels import ops

    blocks = shard_blocks(y)
    tgt = torch.stack([ops.eval_tgt_gather(x, y_j, t, id_offset=off)
                       for y_j, off in blocks]).sum(0)
    outs = [ops.eval_fused(x, y_j, t, k, tgt_scores=tgt, c_lo=c_lo,
                           c_hi=c_hi, id_offset=off, logit_softcap=cap,
                           with_lse=with_lse) for y_j, off in blocks]
    vals, ids = merge_gathered_topk(torch.stack([o[0] for o in outs]),
                                    torch.stack([o[1] for o in outs]), k)
    gt = torch.stack([o[2] for o in outs]).sum(0)
    eq = torch.stack([o[3] for o in outs]).sum(0)
    lse = None
    if with_lse:
        lse = merge_gathered_lse(torch.stack([o[5] for o in outs]),
                                 torch.stack([o[6] for o in outs]))
    return vals, ids, gt, eq, tgt, lse


def shard_topk(x, y, k, *, c_lo, c_hi):
    """The mesh serve steps' local stage per model shard (``mips_topk``
    over the block at its ``id_offset`` under the window), merged by
    ``merge_gathered_topk`` → ``(vals, ids)``."""
    import torch

    from repro_torch.dist.collectives import merge_gathered_topk
    from repro_torch.eval.streaming import streaming_topk

    outs = [streaming_topk(x, y_j, k, c_lo=c_lo, c_hi=c_hi, id_offset=off)
            for y_j, off in shard_blocks(y)]
    return merge_gathered_topk(torch.stack([o[0] for o in outs]),
                               torch.stack([o[1] for o in outs]), k)


def equal_bits(name, got, want):
    """Hold every output of a merged shard-by-shard stage against the
    unsharded kernel's bit for bit; returns the largest |Δ| of the
    values (0 when equal)."""
    import torch

    err = 0.0
    for what, a, b in zip(("vals", "ids", "gt", "eq", "tgt"), got, want):
        check(a.shape == b.shape, f"{name} {what}: shape {tuple(a.shape)} "
              f"against {tuple(b.shape)}")
        if a.is_floating_point():
            err = max(err, (a - b).abs().max().item())
        check(torch.equal(a, b), f"{name} {what}: the 4-way merge differs "
              f"from the unsharded kernel (max |Δ| "
              f"{(a.double() - b.double()).abs().max().item():.3e})")
    return err


def shard_vs_plain(name, x, y0, t, k, tgt, win, kw):
    """One model shard's ``eval_fused`` (given the ``psum``'d target
    scores ``tgt``, as the sharded sweep runs it) and ``eval_tgt_gather``
    against their plain versions on the same inputs, at the tolerance of
    :func:`eval_case`: values and the gather within ``1e-5·max|score|``,
    ids equal where isolated, ``gt`` and ``gt + eq`` apart by no more
    than the columns within that tolerance of the target, the LSE within
    1e-5 relative → the largest |Δ| of each kernel."""
    import torch

    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels import ref

    off = kw["id_offset"]
    got = ek.eval_fused(x, y0, t, k, tgt_scores=tgt, **kw)
    got_t = ek.eval_tgt_gather(x, y0, t, id_offset=off)
    torch.cuda.synchronize()
    want = ref.eval_fused_ref(x, y0, t, k, tgt_scores=tgt, **kw)
    want_t = ref.eval_tgt_gather_ref(x, y0, t, id_offset=off)
    s64 = torch.where(win[None, :], x.double() @ y0.double().T, NEG_INF)
    scale = s64[:, win].abs().max().item()
    tol = 1e-5 * scale
    err = (got[0] - want[0]).abs().max().item()
    tgt_err = (got_t - want_t).abs().max().item()
    check(err <= tol, f"{name}: values differ by {err} > {tol}")
    check(tgt_err <= tol, f"{name}: the gather differs by {tgt_err} > {tol}")
    check(isolated_ids_agree(s64, got[1], want[1], k, 1e-4 * scale),
          f"{name}: isolated ids differ from the plain version")
    near = ((s64 - tgt.double()[:, None]).abs() <= tol).sum(1)
    for what, a, b in (("gt", got[2], want[2]),
                       ("gt + eq", got[2] + got[3], want[2] + want[3])):
        check(bool(((a - b).abs() <= near).all()),
              f"{name}: {what} differs from the plain version by more than "
              f"the columns within {tol:.3e} of the target")
    lse_err = 0.0
    if kw["with_lse"]:
        lse, want_lse = got[5] + torch.log(got[6]), want[5] + torch.log(want[6])
        lse_err = ((lse - want_lse).abs()
                   / want_lse.abs().clamp_min(1e-6)).max().item()
        check(lse_err <= 1e-5, f"{name}: lse relative error {lse_err}")
    print(f"  {name}: eval_fused against its plain version max |Δ| vals "
          f"{err:.3e}, eval_tgt_gather {tgt_err:.3e} (tol {tol:.3e}), lse "
          f"rel {lse_err:.3e}; isolated ids equal, counts within the band")
    return {"eval_fused": err, "eval_tgt_gather": tgt_err, "lse_rel": lse_err,
            "tol": tol}


def dist_kernel_checks(dev, x, y, t, k, tag, *, c_lo, c_hi, cap=None,
                       with_lse=False, reps=20):
    """(b) for one catalog: the 4-way shard-by-shard eval merge against the
    unsharded ``eval_fused``, then shard 0's ``eval_fused`` and
    ``eval_tgt_gather`` timed at the shard's shape (C/4 rows) beside
    their plain versions and one PyTorch call each."""
    import torch

    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels import ops, ref

    whole = ops.eval_fused(x, y, t, k, c_lo=c_lo, c_hi=c_hi,
                           logit_softcap=cap, with_lse=with_lse)
    got = shard_eval(x, y, t, k, c_lo=c_lo, c_hi=c_hi, cap=cap,
                     with_lse=with_lse)
    torch.cuda.synchronize()
    err = equal_bits(f"{tag} eval", got[:5], whole[:5])
    lse_err = None
    if with_lse:
        lse = whole[5] + torch.log(whole[6])
        lse_err = ((got[5] - lse).abs() / lse.abs().clamp_min(1e-6)).max()
        lse_err = lse_err.item()
        check(lse_err <= 1e-5, f"{tag} eval: the merged LSE is {lse_err:.3e} "
              f"from the unsharded one (relative; the f32 fold tolerance "
              f"is 1e-5)")
    print(f"  {tag}: B {x.shape[0]} × C {y.shape[0]:,} (4 shards of "
          f"{y.shape[0] // SHARDS4:,}), d {x.shape[1]} {str(x.dtype)[6:]}, "
          f"k {k}: vals, ids, gt, eq, tgt of the 4-way merge equal the "
          f"unsharded eval_fused bit for bit (max |Δ| {err:.1e})"
          + (f"; LSE max relative |Δ| {lse_err:.3e}" if with_lse else ""))
    y0, off = shard_blocks(y)[0]
    n, d, c = x.shape[0], x.shape[1], y0.shape[0]
    kw = dict(c_lo=c_lo, c_hi=c_hi, id_offset=off, logit_softcap=cap,
              with_lse=with_lse)
    tgt = got[4]
    gid = off + torch.arange(c, device=dev)
    win = (gid >= c_lo) & (gid < c_hi)
    plain_err = shard_vs_plain(f"{tag} shard 0", x, y0, t, k, tgt, win, kw)

    def library():
        s_ = torch.where(win[None, :], (x @ y0.T).float(), NEG_INF)
        out = (torch.topk(s_, k), (s_ > tgt[:, None]).sum(1),
               (s_ == tgt[:, None]).sum(1))
        if with_lse:
            out += (torch.logsumexp(s_ if cap is None
                                    else cap * torch.tanh(s_ / cap), -1),)
        return out

    # the gather on this shard needs only the rows whose target it owns
    # (the others get 0 unread): their x rows, the distinct target rows
    owned = (t >= off) & (t < off + c)
    n_own, n_rows = int(owned.sum()), int(torch.unique(t[owned]).numel())
    if x.dtype == torch.bfloat16:
        bf = bf16_bound(2 * (n * d + c * d) + 8 * n + 8 * n * k + 16 * n,
                        2 * n * c * d, n * c if with_lse else 0)[:2]
        bg = bf16_bound(2 * (n_own * d + n_rows * d) + 8 * n, 2 * n_own * d,
                        0)[:2]
    else:
        bf = eval_bounds(n, c, d, k, 0)[0][:2]
        bg = tf32x3_bound(4 * (n_own * d + n_rows * d + n) + 4 * n,
                          2 * n_own * d, 0)[:2]
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    timings = {}
    for name, fn, plain, lib, bound in (
            ("eval_fused", lambda: ek.eval_fused(x, y0, t, k, tgt_scores=tgt,
                                                 **kw),
             lambda: ref.eval_fused_ref(x, y0, t, k, tgt_scores=tgt, **kw),
             library, bf),
            ("eval_tgt_gather",
             lambda: ek.eval_tgt_gather(x, y0, t, id_offset=off),
             lambda: ref.eval_tgt_gather_ref(x, y0, t, id_offset=off),
             lambda: (x * y0[(t.long() - off).clamp(0, c - 1)]).float()
             .sum(-1), bg)):
        timings[f"{name}_{tag}"] = tt = {
            "ms": time_ms(fn, reps, flush),
            "plain_ms": time_ms(plain, 1, flush),
            "library_ms": time_ms(lib, reps, flush),
            "bound_ms": bound[0], "bound_by": bound[1],
            "max_abs_err": plain_err[name], "merge_max_abs_err": err,
            "shape": [n, c, d, k]}
        print(f"  time {name} on shard 0 of 4 ({tag}, B {n} × {c:,}): kernel "
              f"{tt['ms']:.4f} ms, plain {tt['plain_ms']:.3f} ms, library "
              f"{tt['library_ms']:.4f} ms, bound {bound_text(tt)}")
    del flush
    return timings, {"max_abs_err": err, "lse_rel_err": lse_err,
                     "shard0_vs_plain": plain_err}


def dist_topk_checks(dev, x, y, k, tag, *, c_lo, c_hi, reps=20):
    """(b) for a serve step's catalog stage: the 4-way shard-by-shard
    ``mips_topk`` merge against the unsharded kernel bit for bit, and
    shard 0's launch timed."""
    import torch

    from repro_torch.eval.streaming import _window, streaming_topk
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.kernels.ref import mips_topk_ref

    whole = streaming_topk(x, y, k, c_lo=c_lo, c_hi=c_hi)
    got = shard_topk(x, y, k, c_lo=c_lo, c_hi=c_hi)
    torch.cuda.synchronize()
    err = equal_bits(f"{tag} serve", got, whole)
    print(f"  {tag}: n_q {x.shape[0]} × C {y.shape[0]:,} (4 shards), k {k}, "
          f"window [{c_lo}, {c_hi}): the 4-way mips_topk merge equals the "
          f"unsharded kernel bit for bit (vals, ids; max |Δ| {err:.1e})")
    (y0, off) = shard_blocks(y)[0]
    valid = _window(y0.shape[0], c_lo, c_hi, off, y0.device)
    plain = run_case(f"{tag} shard 0 of 4", x, y0, k, valid=valid,
                     id_offset=off)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)

    def library():
        s_ = torch.where(valid[None, :], x @ y0.T, NEG_INF)
        return torch.topk(s_, k)

    b, by = bound_ms(x.shape[0], y0.shape[0], x.shape[1], k)
    tt = {"ms": time_ms(lambda: mips_topk(x, y0, k, valid=valid,
                                          id_offset=off), reps, flush),
          "plain_ms": time_ms(lambda: mips_topk_ref(
              x, y0, k, valid=valid, id_offset=off), 1, flush),
          "library_ms": time_ms(library, reps, flush),
          "bound_ms": b, "bound_by": by, "max_abs_err": plain["max_abs_err"],
          "merge_max_abs_err": err,
          "shape": [x.shape[0], y0.shape[0], x.shape[1], k]}
    print(f"  time mips_topk on shard 0 of 4 ({tag}): kernel {tt['ms']:.4f} "
          f"ms, plain {tt['plain_ms']:.3f} ms, library "
          f"{tt['library_ms']:.4f} ms, bound {b:.4f} ms ({by})")
    del flush
    return tt


def host_ms(fn, reps=3):
    """Median host-clock time of ``fn`` (its results on the host), after
    one warm call → (ms, result of the last call)."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], out


def same_result(name, a, b):
    """A sharded entry point's answer against the one-device one: equal
    (metric dicts exactly; tensors bit for bit) → max |Δ| (0.0)."""
    import torch

    if isinstance(a, dict):
        check(a == b, f"{name}: the (1, 1) mesh's metrics differ: {a} "
              f"against {b}")
        return 0.0
    err = 0.0
    for x, y in zip(a, b):
        x, y = torch.as_tensor(x), torch.as_tensor(y)  # the server's numpy
        if x.is_floating_point():
            err = max(err, (x - y).abs().max().item())
        check(torch.equal(x, y), f"{name}: the (1, 1) mesh's answer differs "
              f"(max |Δ| {err:.3e})")
    return err


def dist_entry_points(dev):
    """(a): the public entry points on a (1, 1) mesh against ``mesh=None``
    at full width — SASRec-SCE's and BERT4Rec's evaluation, gemma-2-2b's
    token rank (its published widths in bf16, depth cut to 2 of 26
    layers, random weights: 1,024 rows at the 256,000-token vocabulary
    with the softcap), BERT4Rec's three serve steps and the SASRec
    server — each equal and timed by the host clock, the kernels' launches of its
    sharded calls counted from 0. Returns the timings and the inputs (b)
    reuses."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.gemma2_2b import make_config as gemma_config
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.eval import evaluate_streaming, evaluate_streaming_lm
    from repro_torch.eval.harness import (_keep_and_targets, default_score_fn,
                                          lm_score_fn, lm_targets_and_valid)
    from repro_torch.launch import steps
    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.serve import RetrievalServer
    from repro_torch.models import transformer

    mesh = make_mesh((1, 1))
    out, inputs = {}, {}
    counters = (mips_topk, ek.eval_fused, ek.eval_tgt_gather)

    def pair(name, one, sharded):
        ms1, a = host_ms(one)
        for fn in counters:  # this sharded path starts here
            fn.launches = 0
        ms2, b = host_ms(sharded)
        launches = {fn.__name__: fn.launches for fn in counters}  # ... ends
        err = same_result(name, b, a)
        out[name] = {"ms": ms2, "one_device_ms": ms1, "max_abs_diff": err,
                     "launches": launches}
        print(f"  {name}: the (1, 1) mesh equals mesh=None (max |Δ| "
              f"{err:.1e}); {ms2:.3f} ms against {ms1:.3f} ms a call (host "
              f"clock, median of 3 after a warm call); launches of the 4 "
              f"sharded calls {launches}")

    for arch in ("sasrec-sce", "bert4rec"):
        cfg = get_arch(arch).make_config()
        params = encoder(cfg).init_params(cfg, seed=0, device=dev)
        batch = SequenceDataset(SeqDataConfig(
            n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=DIST_USERS,
        )).eval_batch(Cursor(seed=0))[0]
        pair(f"evaluate_streaming_{arch}",
             lambda: evaluate_streaming(params, cfg, batch),
             lambda: evaluate_streaming(params, cfg, batch, mesh=mesh))
        tokens, targets = _keep_and_targets(batch["tokens"])
        with torch.no_grad():
            x, y = default_score_fn(cfg)(params, torch.from_numpy(tokens)
                                         .to(dev))
        inputs[arch] = (cfg, params, x, y, torch.from_numpy(
            targets.astype(np.int32)).to(dev))
        if arch == "sasrec-sce":
            hist = batch["tokens"][:BUCKETS[-1]]
            while hist.shape[0] < BUCKETS[-1]:
                hist = np.concatenate([hist, hist])[:BUCKETS[-1]]
            kw = dict(cfg=cfg, params=params, buckets=BUCKETS, device=dev)
            servers = (RetrievalServer(arch, **kw),
                       RetrievalServer(arch, mesh=mesh, **kw))
            pair("RetrievalServer_sasrec-sce", lambda: servers[0].score(hist),
                 lambda: servers[1].score(hist))
            for s in servers:
                s.close()
            del servers
    cfg, params = inputs["bert4rec"][:2]
    hist = torch.from_numpy(SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=B4R_SERVE,
    )).next_batch(Cursor(seed=1))[0]["tokens"]).to(dev)
    cand = torch.randperm(cfg.catalog_loss_size,
                          generator=torch.Generator().manual_seed(2)).to(
        device=dev, dtype=torch.int32)
    for name, make, args, k in (
            ("mips_serve_step", steps.make_seqrec_mips_serve_step, (hist,),
             K),
            ("serve_step", steps.make_seqrec_serve_step, (hist,), B4R_TOP_K),
            ("retrieval_step", steps.make_seqrec_retrieval_step,
             (hist[:1], cand), B4R_TOP_K)):
        one, sharded = make(cfg, top_k=k), make(cfg, top_k=k, mesh=mesh)
        pair(f"{name}_bert4rec", lambda: one(params, *args),
             lambda: sharded(params, *args))
    inputs["b4r_hist"] = hist
    del cand

    # gemma-2-2b's token rank: published widths in bf16, one pair of its
    # local and global layers
    lcfg = dataclasses.replace(gemma_config(), n_layers=2)
    check((lcfg.vocab, lcfg.vocab_padded, lcfg.d_model, lcfg.final_softcap,
           lcfg.dtype) == (256_000, 256_000, 2304, LM_CAP, "bfloat16"),
          f"gemma-2-2b's published config changed: {lcfg}")
    lparams = transformer.init_params(lcfg, seed=0, device=dev)
    toks = SequenceDataset(SeqDataConfig(
        n_items=lcfg.vocab, seq_len=DIST_LM_T, batch_size=DIST_LM_SEQS,
        min_len_frac=1.0)).heldout_batch(Cursor(seed=0))[0]
    pair("evaluate_streaming_lm_gemma2-2b",
         lambda: evaluate_streaming_lm(lparams, lcfg, toks),
         lambda: evaluate_streaming_lm(lparams, lcfg, toks, mesh=mesh))
    targets, _ = lm_targets_and_valid(toks["tokens"])
    with torch.no_grad():
        x, y = lm_score_fn(lcfg)(lparams, torch.from_numpy(toks["tokens"])
                                 .to(dev))
    inputs["lm"] = (lcfg, x, y, torch.from_numpy(
        targets.reshape(-1).astype(np.int32)).to(dev))
    del lparams
    return out, inputs


def dist_train_checks(dev):
    """(c): ``train("sasrec-sce", grad_compression="int8", n_hosts=4)`` at
    full width — its host batches bit for bit the one-host batches, its
    losses beside the uncompressed run's — and a checkpointed, resumed
    compressed run repeating the uninterrupted one bit for bit, the
    error-feedback residual included."""
    import statistics
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.launch.train import _host_batch, train
    from repro_torch.optim.optimizers import tree_leaves

    cfg = make_config()
    batch = N_POS // cfg.max_len
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=batch))
    for i in range(4):
        one, c1 = _host_batch(data, Cursor(seed=0, step=i))
        four, c4 = _host_batch(data, Cursor(seed=0, step=i), 4)
        check(set(one) == set(four) and all(
            np.array_equal(one[k], four[k]) for k in one) and c1 == c4,
            f"step {i}: the 4-host batch differs from the 1-host batch")
    kw = dict(cfg=cfg, batch=batch, steps=4, seed=0, device=dev,
              log_every=0)
    plain = train("sasrec-sce", **kw)
    comp = train("sasrec-sce", grad_compression="int8", n_hosts=4, **kw)
    print(f"  4 steps of {batch} × {cfg.max_len}: the 4-host batches equal "
          f"the 1-host ones bit for bit; losses int8-compressed "
          f"{[round(v, 6) for v in comp['losses']]} against uncompressed "
          f"{[round(v, 6) for v in plain['losses']]}; median step "
          f"{statistics.median(comp['step_s'][1:]) * 1e3:.3f} against "
          f"{statistics.median(plain['step_s'][1:]) * 1e3:.3f} ms (host "
          f"clock, steps 2–4)")
    ckw = dict(kw, grad_compression="int8", ckpt_every=2)
    with tempfile.TemporaryDirectory() as tmp:
        whole = train("sasrec-sce", ckpt_dir=f"{tmp}/a", **ckw)
        train("sasrec-sce", ckpt_dir=f"{tmp}/b", **dict(ckw, steps=2))
        rest = train("sasrec-sce", ckpt_dir=f"{tmp}/b", **ckw)
        check(rest["steps"] == 2 and rest["losses"] == whole["losses"][2:],
              f"the resumed compressed run's losses {rest['losses']} differ "
              f"from the uninterrupted {whole['losses'][2:]}")
        (sa, ta), (sb, tb) = (CheckpointManager(f"{tmp}/{d}").restore_latest()
                              for d in "ab")
        la, lb = tree_leaves(ta), tree_leaves(tb)
        check(sa == sb == 3 and len(la) == len(lb) and all(
            np.array_equal(np.asarray(a.cpu() if hasattr(a, "cpu") else a),
                           np.asarray(b.cpu() if hasattr(b, "cpu") else b))
            for a, b in zip(la, lb)),
            "the resumed compressed run's last checkpoint differs")
        n_ef = len(tree_leaves(ta["opt_state"][1]["ef"]))
    print(f"  compressed run checkpointed at step 1, resumed to 4: losses "
          f"and the step-3 checkpoint ({len(la)} leaves, {n_ef} of them the "
          f"error-feedback residual) equal the uninterrupted run's bit for "
          f"bit")
    return {"losses_int8_hosts4": comp["losses"],
            "losses_uncompressed": plain["losses"],
            "step_s_int8": comp["step_s"], "step_s_uncompressed":
            plain["step_s"], "resumed_losses": rest["losses"],
            "ckpt_leaves": len(la), "ef_leaves": n_ef}


def dist_phase(dev):
    """Phase 21: distributed inference and data-parallel training on one
    card, a world of one. (a) the sharded entry points on a (1, 1) mesh
    against ``mesh=None``; (b) each model shard's local stage of a 4-way
    split of the same catalogs in turn, merged by the collectives' own
    merge functions and held against the unsharded kernels bit for bit
    (the LSE within 1e-5 relative), shard 0's kernels timed; (c) int8
    gradient compression with 4 emulated hosts, and its resume."""
    import torch

    t0 = time.monotonic()
    gc.collect()  # what earlier phases left in reference cycles
    torch.cuda.empty_cache()
    entry, inputs = dist_entry_points(dev)
    timings, merges = {}, {}
    for arch, tag in (("sasrec-sce", "sasrec"), ("bert4rec", "b4r")):
        cfg, _, x, y, t = inputs[arch]
        tt, merges[tag] = dist_kernel_checks(dev, x, y, t, K, tag, c_lo=1,
                                             c_hi=cfg.n_items)
        timings.update(tt)
    lcfg, x, y, t = inputs["lm"]
    tt, merges["lm"] = dist_kernel_checks(dev, x, y, t, 1, "lm", c_lo=1,
                                          c_hi=lcfg.vocab, cap=LM_CAP,
                                          with_lse=True)
    timings.update(tt)
    cfg, params, x, y, _ = inputs["sasrec-sce"]
    q = x[:BUCKETS[-1]] if x.shape[0] >= BUCKETS[-1] else torch.cat(
        [x] * (-(-BUCKETS[-1] // x.shape[0])))[:BUCKETS[-1]]
    timings["mips_sasrec"] = dist_topk_checks(dev, q.contiguous(), y, K,
                                              "sasrec", c_lo=1,
                                              c_hi=cfg.n_items)
    cfg, params = inputs["bert4rec"][:2]
    from repro_torch.launch.steps import _last_states
    from repro_torch.models.sasrec import loss_catalog

    with torch.inference_mode():
        q = _last_states(cfg, params, inputs["b4r_hist"])
    timings["mips_b4r"] = dist_topk_checks(dev, q, loss_catalog(params, cfg),
                                           B4R_TOP_K, "b4r", c_lo=0,
                                           c_hi=cfg.n_items)
    del inputs
    gc.collect()
    torch.cuda.empty_cache()
    trained = dist_train_checks(dev)
    wall_s = time.monotonic() - t0
    print(f"  phase 21 in {wall_s:.1f} s (host clock); card: {smi()}")
    return {"entry_points": entry, "merges": merges, "timings": timings,
            "train": trained, "wall_s": wall_s}


# ---------------------------------------------------------------------------
# The CTR models and SchNet at published widths (phase 22)
# ---------------------------------------------------------------------------
RECSYS_ARCHS = ("dcn-v2", "dlrm-rm2", "xdeepfm")
RECSYS_BATCH = 65_536  # train_batch as published
RECSYS_STEPS = 4
RECSYS_SERVE = (("serve_p99", 512, 10), ("serve_bulk", 262_144, 3))
RECSYS_CANDS = 1_000_000  # retrieval_cand's candidates, one user
RECSYS_TOP_K = 100  # the retrieval step's own
RECSYS_PROB_TOL = 2e-5  # |p − p_f64| of the click probabilities
RECSYS_SCORE_TOL = 1e-4  # × max|score|: retrieval values, and the id gap
STEP_PHASES = ("h2d", "forward", "backward", "optimizer")
GNN_STEPS = 4
GNN_SHAPES = ("molecule", "full_graph_sm", "minibatch_lg")
GNN_PAD = 512  # full-graph node and edge counts padded to a multiple
GNN_GRAD_TOL = 1e-4  # × max|g| a leaf: the first step against f64


class PeakMarks(StepMarks):
    """``StepMarks`` that also keep, for each phase, the most device
    memory allocated since the mark before it (the allocator's peak,
    read and reset at each mark: host-side, no sync)."""

    def __init__(self, phases):
        super().__init__(phases)
        self.peaks = {}

    def __call__(self, name):
        import torch

        super().__call__(name)
        self.peaks[name] = max(self.peaks.get(name, 0),
                               torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()


def kernel_counters():
    """Every launch counter of the port's kernel wrappers (each function
    of ``repro_torch.kernels`` with an int ``launches``), by name."""
    import importlib
    import pkgutil

    from repro_torch import kernels

    out = {}
    for m in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"repro_torch.kernels.{m.name}")
        for fn in vars(mod).values():
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int):
                out.setdefault(f"{fn.__module__}.{fn.__name__}", fn)
    return out


def step_totals(marks):
    """Per step, the device ms from its ``start`` mark to its last one."""
    return [m[0][1].elapsed_time(m[-1][1]) for m in marks.steps]


def peak_window(dev):
    """Collect garbage, empty the cache and start a peak-memory window →
    the bytes live at its start."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def recsys_train_run(dev, name):
    """``train(name, cfg=make_config(), batch=65536, steps=4)``: the
    published widths and train_batch, guarded AdamW. The host draws each
    batch before the step's ``start`` mark, so the clickstream's cost
    stays out of the device time; the median of steps 2–4 from ``start``
    to ``optimizer``, its phases, the peak memory, finite losses."""
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train

    cfg = get_arch(name).make_config()
    marks = PeakMarks(STEP_PHASES)
    live = peak_window(dev)
    t0 = time.monotonic()
    out = train(name, cfg=cfg, batch=RECSYS_BATCH, steps=RECSYS_STEPS,
                seed=0, log_every=0, device=dev, mark=marks)
    wall_s = time.monotonic() - t0
    peak = max(torch.cuda.max_memory_allocated(dev), *marks.peaks.values())
    losses = out["losses"]
    check(len(losses) == RECSYS_STEPS
          and all(math.isfinite(v) for v in losses),
          f"{name}: losses {losses}")
    check(out["skipped_steps"] == 0, f"{name}: {out['skipped_steps']} "
          f"steps skipped")
    totals = step_totals(marks)
    median_ms = statistics.median(totals[1:])
    host_ms = statistics.median(out["step_s"][1:]) * 1e3
    bd = marks.breakdown()
    rows = sum(cfg.vocab_sizes)
    print(f"  {name} ({len(cfg.vocab_sizes)} fields, {rows:,} table rows × "
          f"{cfg.embed_dim}, {cfg.param_count():,} parameters): "
          f"{RECSYS_STEPS} steps of {RECSYS_BATCH:,} rows in {wall_s:.2f} s"
          f" (set-up and the clickstream included); loss "
          f"{' → '.join(f'{v:.4f}' for v in losses)}; median step "
          f"{median_ms:.2f} ms (device events start → optimizer, steps 2–"
          f"{RECSYS_STEPS}; host clock with the batch's draw "
          f"{host_ms:.1f} ms)")
    print("  step breakdown: " + " + ".join(
        f"{p} {bd[p + '_ms']:.2f}" for p in STEP_PHASES)
        + f" = {sum(bd.values()):.2f} ms (mean of steps 2–{RECSYS_STEPS})")
    print(f"  peak device memory: {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated; {live / 2**30:.2f} GiB live before); "
          f"by the phase that reached it: " + ", ".join(
              f"{p} {v / 2**30:.2f}" for p, v in marks.peaks.items()))
    return {"losses": losses, "step_ms": totals, "median_step_ms": median_ms,
            "host_step_ms": host_ms, "breakdown": bd, "wall_s": wall_s,
            "peak_bytes": peak, "live_bytes_before": live,
            "peak_bytes_by_phase": marks.peaks}


def recsys_serve_run(dev, name):
    """The serve step at serve_p99 and serve_bulk and the retrieval step
    at retrieval_cand on random weights (seed 0) and random rows (uniform
    ids in each field), timed by the host clock to the result on the
    device; the first 512 probabilities held against an f64 forward of
    the same rows within ``RECSYS_PROB_TOL``, the retrieval's values
    against the top 100 of the f64 scores of every candidate within
    ``RECSYS_SCORE_TOL·max|s|`` and its positions wherever an f64 score
    stands further than that from its neighbours."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.optim.optimizers import tree_map

    arch = get_arch(name)
    cfg = arch.make_config()
    peak_window(dev)
    params = steps.RECSYS_INIT[name](cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    n = max(r for _, r, _ in RECSYS_SERVE)
    dense = torch.randn(n, getattr(cfg, "n_dense", 1), generator=g,
                        device=dev)
    sparse = torch.stack([torch.randint(0, v, (n, cfg.hot), generator=g,
                                        device=dev, dtype=torch.int32)
                          for v in cfg.vocab_sizes], dim=1)
    fwd = steps.recsys_forward_fn(name)
    p64 = tree_map(lambda p: p.double(), params)
    with torch.inference_mode():
        want = torch.sigmoid(fwd(p64, cfg, dense[:512].double(),
                                 sparse[:512]))
    serve = steps.make_recsys_serve_step(arch, cfg)
    out = {}
    for shape, rows, reps in RECSYS_SERVE:
        d, s_ = dense[:rows], sparse[:rows]
        got = serve(params, d, s_)
        torch.cuda.synchronize()
        err = (got[:512].double() - want).abs().max().item()
        check(got.shape == (rows,) and bool(torch.isfinite(got).all()),
              f"{name} {shape}: output {tuple(got.shape)}")
        check(err <= RECSYS_PROB_TOL, f"{name} {shape}: probabilities "
              f"{err:.3e} from f64 > {RECSYS_PROB_TOL}")
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            serve(params, d, s_)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        ms.sort()
        out[shape] = {"rows": rows, "ms": ms, "median_ms": ms[len(ms) // 2],
                      "f64_max_abs_err": err, "tol": RECSYS_PROB_TOL}
        print(f"  {name} {shape}: {rows:,} rows, median "
              f"{out[shape]['median_ms']:.3f} ms a call (host clock to the "
              f"result on the card, of {reps}: "
              f"{', '.join(f'{t:.3f}' for t in ms)}); first 512 "
              f"probabilities within {err:.2e} of f64 (tol "
              f"{RECSYS_PROB_TOL})")
    cand = torch.randperm(cfg.vocab_sizes[0], generator=g, device=dev)[
        :RECSYS_CANDS].to(torch.int32)
    retrieve = steps.make_recsys_retrieval_step(arch, cfg,
                                                top_k=RECSYS_TOP_K)
    vals, ids = retrieve(params, dense[:1], sparse[:1], cand)
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        retrieve(params, dense[:1], sparse[:1], cand)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ms.sort()
    with torch.inference_mode():
        s64 = recsys.retrieval_scores(fwd, p64, cfg, dense[:1].double(),
                                      sparse[:1], cand, chunk=4096)
    del p64
    tol = RECSYS_SCORE_TOL * s64.abs().max().item()
    want_v, want_i = dense_topk(s64[None], RECSYS_TOP_K + 1)
    err = compare((vals[None], ids[None]),
                  (want_v[:, :RECSYS_TOP_K], want_i[:, :RECSYS_TOP_K]),
                  want_v[:, RECSYS_TOP_K], tol, exact=False)
    out["retrieval_cand"] = {"candidates": RECSYS_CANDS, "k": RECSYS_TOP_K,
                             "ms": ms, "median_ms": ms[1],
                             "f64_max_abs_err": err, "tol": tol}
    print(f"  {name} retrieval_cand: 1 user × {RECSYS_CANDS:,} candidates "
          f"in chunks of 4,096, top {RECSYS_TOP_K}: median {ms[1]:.2f} ms a "
          f"call (of 3: {', '.join(f'{t:.2f}' for t in ms)}); values within "
          f"{err:.2e} of f64 (tol {tol:.2e}), positions equal where "
          f"isolated")
    return out


def gnn_batches(shape, dims):
    """SchNet's batches of ``shape`` (its ``dims``) for ``GNN_STEPS``
    steps, as numpy (the molecules and the sampled subgraphs change every
    step, the full graph does not), and what building them cost on the
    host."""
    import resource

    import numpy as np

    from repro_torch.data import (Cursor, GraphDataConfig, NeighborSampler,
                                  batched_molecules, random_graph)

    t0 = time.monotonic()
    if shape == "molecule":
        out = []
        for i in range(GNN_STEPS):
            b, _ = batched_molecules(
                Cursor(seed=0, step=i), n_mols=dims["batch"],
                nodes_per_mol=dims["n_nodes"],
                edges_per_mol=dims["n_edges"], d_feat=dims["d_feat"])
            b.pop("n_graphs")
            out.append(b)
        return out, {"host_s": time.monotonic() - t0}
    if shape == "full_graph_sm":
        # n_edges directed edges: random_graph symmetrises its draw
        g = random_graph(GraphDataConfig(
            n_nodes=dims["n_nodes"], n_edges=dims["n_edges"] // 2,
            d_feat=dims["d_feat"], seed=0))
        n, e = dims["n_nodes"], g["edge_index"].shape[1]
        n_pad, e_pad = -(-n // GNN_PAD) * GNN_PAD, -(-e // GNN_PAD) * GNN_PAD
        b = {"node_feats": np.pad(g["node_feats"], ((0, n_pad - n), (0, 0))),
             "positions": np.pad(g["positions"], ((0, n_pad - n), (0, 0))),
             "edge_index": np.pad(g["edge_index"], ((0, 0), (0, e_pad - e))),
             "edge_valid": np.arange(e_pad) < e,
             "node_valid": np.arange(n_pad) < n,
             "targets": np.pad(g["targets"], (0, n_pad - n))}
        return [b] * GNN_STEPS, {"host_s": time.monotonic() - t0,
                                 "nodes": n_pad, "edges": e_pad}
    g = random_graph(GraphDataConfig(
        n_nodes=dims["n_nodes"], n_edges=dims["n_edges"],
        d_feat=dims["d_feat"], seed=0))
    t_graph = time.monotonic() - t0
    sampler = NeighborSampler(g["edge_index"], dims["n_nodes"])
    t_csr = time.monotonic() - t0 - t_graph
    out, real = [], []
    for i in range(GNN_STEPS):
        s_, _ = sampler.sample(Cursor(seed=0, step=i), dims["batch_nodes"],
                               (dims["fanout0"], dims["fanout1"]))
        ids = s_["node_ids"]
        real.append(int(s_["n_real_nodes"]))
        out.append({"node_feats": g["node_feats"][ids],
                    "positions": g["positions"][ids],
                    "edge_index": s_["edge_index"],
                    "edge_valid": s_["edge_valid"],
                    "seed_local": s_["seed_local"],
                    "targets": g["targets"][ids[s_["seed_local"]]]})
    info = {"host_s": time.monotonic() - t0, "graph_s": t_graph,
            "csr_s": t_csr, "directed_edges": int(g["edge_index"].shape[1]),
            "max_rss_gib": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2**20,
            "nodes": int(out[0]["node_feats"].shape[0]),
            "edges": int(out[0]["edge_index"].shape[1]),
            "real_nodes": real}
    del g, sampler
    return out, info


def gnn_run(dev, shape):
    """SchNet at ``make_config(shape)``: the first step on f32 and on f64
    copies of the same weights and batch — the loss within ``1e-5``
    relative and each gradient (AdamW's first moment, ``(1 − β₁)·g``)
    within ``GNN_GRAD_TOL·max|g|`` — then ``GNN_STEPS`` guarded AdamW
    steps through ``make_gnn_train_step``: finite losses, the median step
    from ``start`` to ``optimizer``, its phases, the peak memory."""
    import statistics

    import torch

    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.launch import steps
    from repro_torch.launch.train import to_device
    from repro_torch.models import schnet
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    arch = get_arch("schnet")
    cfg = arch.make_config(shape)
    spec = arch.shape(shape)
    step, (opt_init, _) = steps.make_gnn_train_step(
        arch, cfg, ShapeSpec(shape, spec.kind, dict(spec.dims)))
    batches, info = gnn_batches(shape, spec.dims)
    first = to_device(batches[0], dev)
    moments = {}
    for dt in (torch.float64, torch.float32):
        p = tree_map(lambda t: t.to(dt),
                     schnet.init_params(cfg, seed=0, device=dev))
        b = {k: v.to(dt) if v.is_floating_point() else v
             for k, v in first.items()}
        _, st, m = step(p, opt_init(p), b)
        moments[dt] = ([t.double() for t in tree_leaves(st.inner["m"])],
                       float(m["loss"]))
    (m64, l64), (m32, l32) = moments[torch.float64], moments[torch.float32]
    rel = max(((a - w).abs().max() / w.abs().max().clamp(min=1e-300)).item()
              for a, w in zip(m32, m64))
    check(abs(l32 - l64) <= 1e-5 * abs(l64), f"schnet {shape}: loss {l32} "
          f"against f64 {l64}")
    check(rel <= GNN_GRAD_TOL, f"schnet {shape}: a gradient {rel:.3e}·max|g|"
          f" from f64 > {GNN_GRAD_TOL}")
    del moments, first
    params = schnet.init_params(cfg, seed=0, device=dev)
    state = opt_init(params)
    marks = StepMarks(STEP_PHASES)
    live = peak_window(dev)
    losses = []
    for b in batches:
        marks("start")
        b = to_device(b, dev)
        marks("h2d")
        params, state, m = step(params, state, b, mark=marks)
        losses.append(float(m["loss"]))
        check(not bool(m["skipped"]), f"schnet {shape}: a step skipped")
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(v) for v in losses), f"schnet {shape}: losses "
          f"{losses}")
    totals = step_totals(marks)
    median_ms = statistics.median(totals[1:])
    bd = marks.breakdown()
    n_e = batches[0]["edge_index"].shape[1]
    print(f"  schnet {shape} (d_feat {cfg.d_feat}, {cfg.n_interactions} "
          f"interactions, d {cfg.d_hidden}, {cfg.n_rbf} RBFs): "
          f"{batches[0]['node_feats'].shape[0]:,} nodes, {n_e:,} edges a "
          f"step; host batches {info['host_s']:.2f} s"
          + (f" (the {info['directed_edges']:,}-edge graph "
             f"{info['graph_s']:.2f} s, its CSR {info['csr_s']:.2f} s, host "
             f"max RSS {info['max_rss_gib']:.1f} GiB; real nodes a step "
             f"{info['real_nodes']})" if "graph_s" in info else "")
          + f"; first step against f64: loss {l32:.6f} ({l64:.6f}), "
          f"gradients within {rel:.2e}·max|g|; losses "
          f"{' → '.join(f'{v:.4f}' for v in losses)}; median step "
          f"{median_ms:.3f} ms (device events, steps 2–{GNN_STEPS}): "
          + " + ".join(f"{p} {bd[p + '_ms']:.3f}" for p in STEP_PHASES)
          + f"; peak {peak / 2**20:.1f} MiB ({live / 2**20:.1f} MiB live "
          f"before)")
    return {"losses": losses, "step_ms": totals, "median_step_ms": median_ms,
            "breakdown": bd, "peak_bytes": peak, "loss_f32": l32,
            "loss_f64": l64, "grad_rel_err": rel, **info}


def recsys_gnn_phase(dev):
    """Phase 22: the CTR models and SchNet at their published widths —
    none of them runs a kernel of the port (the reference runs them
    without Pallas), so every launch counter must stay where it was."""
    counters = kernel_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    t0 = time.monotonic()
    out = {}
    for name in RECSYS_ARCHS:
        out[name] = {"train": recsys_train_run(dev, name),
                     **recsys_serve_run(dev, name)}
    for shape in GNN_SHAPES:
        out[f"schnet_{shape}"] = gnn_run(dev, shape)
    print("  schnet ogb_products: not run — 2 × 61,859,140 directed edges, "
          "whose (E, 300) RBF features alone are 138 GiB in f32 (edge "
          "sharding over several cards, ROADMAP.md queue 1 item 14)")
    moved = {k: fn.launches - before[k] for k, fn in counters.items()
             if fn.launches != before[k]}
    check(not moved, f"kernels launched by the CTR or SchNet paths: {moved}")
    wall_s = time.monotonic() - t0
    print(f"  none of the {len(counters)} kernel launch counters moved; "
          f"phase 22 in {wall_s:.1f} s (host clock); card: {smi()}")
    out["wall_s"] = wall_s
    out["counters_watched"] = len(counters)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the detailed results to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    card = smi()
    print(f"[1/{N_PHASES}] device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    t0 = time.monotonic()
    libs = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"[2/{N_PHASES}] build: {len(libs)} kernel libraries in "
          f"{build_s:.2f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    def phase(i, what):
        print(f"[{i}/{N_PHASES}] {what}:")

    phase(3, "kernel guard: every conformance canary on the card")
    conformance = conformance_phase(dev)
    phase(4, "serve kernel against its plain version")
    cases, timings = kernel_phase(dev)
    phase(5, "server at full width")
    server = server_phase(dev)
    phase(6, "train kernels against their plain versions")
    tcases, gcases, pcases, ttimes = train_kernel_phase(dev)
    phase(7, "trainer at full width, sce_mode=gspmd")
    trainer = train_phase(dev, "gspmd")
    again = train_phase(dev, "gspmd")  # the same tree and seed once more
    same_run = again["losses"] == trainer["losses"]
    print(f"  two gspmd runs of this tree end on the same loss: {same_run} "
          f"({trainer['losses'][-1]!r} and {again['losses'][-1]!r}; every "
          f"step's loss equal: {same_run}) — measured, not required")
    trainer["repeat_losses_equal"] = same_run
    del again
    phase(8, "trainer at full width, its default sce_mode=exact, guard "
             "strict, its verdicts run at first dispatch")
    exact = train_phase(dev, "exact", guard_policy="strict",
                        fresh=("mips_topk", "sce_gather", "eval_fused"))
    phase(9, "the same trainer with the guard off")
    exact_off = train_phase(dev, "exact", guard_policy="off")
    phase(10, "one batch through the three SCE modes")
    agreement = mode_agreement_phase(dev)
    phase(11, "eval kernels against their plain versions")
    ecases, etimes = eval_kernel_phase(dev)
    phase(12, "evaluation at full width")
    evaluation = eval_phase(dev)
    phase(13, "full-CE kernels against their plain versions")
    ccases, ctimes = ce_kernel_phase(dev)
    phase(14, "trainer with the competitor losses at full width")
    competitors = loss_phase(dev, (trainer, exact))
    phase(15, "guard kernels (sce_bucket, eval_topk) against their plain "
              "versions")
    bcases, tkcases, gtimes = guard_kernel_phase(dev)
    phase(16, "drills: divergence without and with checkpoints, broken "
              "kernel")
    drills = drill_phase(dev)
    phase(17, "checkpoints at full width: the trainer saves, resumes, "
              "drains on SIGTERM; the server serves the checkpoint")
    ckpt = ckpt_phase(dev)
    phase(18, "the LM path at full width: gemma-2-2b trains with SCE, is "
              "evaluated by token rank and decodes")
    lm = lm_phase(dev)
    phase(19, "BERT4Rec at full width: 10⁶ items, trained with SCE, "
              "evaluated by cloze leave-one-out, served")
    b4r = b4r_phase(dev)
    phase(20, "granite-moe-3b-a800m at full width: its MoE FFN trains with "
          "SCE, is evaluated by token rank and decodes")
    granite = granite_phase(dev)
    phase(21, "distribution on one card: the sharded entry points on a "
              "(1, 1) mesh, a 4-way shard-by-shard merge, int8 gradient "
              "compression over 4 emulated hosts")
    dist = dist_phase(dev)
    phase(22, "recsys and SchNet at published widths: dcn-v2, dlrm-rm2 and "
              "xdeepfm trained, served and retrieving; SchNet trained on "
              "three graph regimes")
    recsys_gnn = recsys_gnn_phase(dev)

    t = timings[512]  # the serve_p99 bucket
    mips = {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mips_topk.cu",
            "replaces": "src/repro/kernels/mips_topk.py:52"}
    trainers = (trainer, exact)
    kernels = [{
        "name": "mips_topk",
        **mips,
        # serving's launches, both trainers' and the checkpoint path's
        # (phase 17), each path counted from 0
        "launches": server["launches"] + sum(
            r["launches"]["mips_topk"] for r in trainers)
        + ckpt["launches"]["mips_topk"],
        "max_abs_err": max([timings[b]["max_abs_err"] for b in BUCKETS]
                           + [c["max_abs_err"] for c in tcases]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]
    # The same kernel at training's two selections, with the launches both
    # trainers made at that k.
    for name, k in (("positions_k320", B_X), ("catalog_k256", B_Y)):
        tt = ttimes[name]
        kernels.append({
            "name": f"mips_topk_train_{name}",
            **mips,
            "launches": sum(r["mips_topk_launches_by_k"][k]
                            for r in trainers) + ckpt["mips_topk_by_k"][k],
            "max_abs_err": next(c["max_abs_err"] for c in tcases
                                if c["name"] == f"train_{name}"),
            "ms": tt["ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"],
            "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
        })
    for name, what, line in (("sce_gather_fwd", "loss", 79),
                             ("sce_gather_dx", "dx", 152),
                             ("sce_gather_dy", "dy", 203)):
        tt = ttimes[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sce_gather.cu",
            "replaces": f"src/repro/kernels/sce_prefetch.py:{line}",
            "launches": trainer["launches"][name] + ckpt["launches"][name],
            "max_abs_err": max(c["max_abs_err"][what] for c in gcases),
            "ms": tt["ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"],
            "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
        })
    tt = ttimes["sce_gather_dy_sum"]
    kernels.append({  # the gathered dY's second kernel, in both trainers
        "name": "sce_gather_dy_sum",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sce_gather.cu",
        "replaces": "src/repro/kernels/sce_prefetch.py:250",
        "launches": sum(r["launches"]["sce_gather_dy_sum"]
                        for r in trainers)
        + ckpt["launches"]["sce_gather_dy_sum"],
        "max_abs_err": tt["max_abs_err"],
        "ms": tt["ms"],
        "plain_ms": tt["plain_ms"],
        "bound_ms": tt["bound_ms"],
        "bound_by": tt["bound_by"],
        "library_ms": tt["library_ms"],
    })
    for name, what in zip(PLSE, ("plse", "dx", "dy")):
        tt = ttimes[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sce_gather.cu",
            "replaces": "src/repro/kernels/sce_prefetch.py:497",
            "launches": exact["launches"][name],
            "max_abs_err": max(c["max_abs_err"][what] for c in pcases),
            "ms": tt["ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"],
            "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
        })
    for name, line in (("eval_fused", 104), ("eval_tgt_gather", 82)):
        for b, launches in ((EVAL_B[1], evaluation["launches"][name]),
                            (EVAL_B[0], sum(r["launches"][name]
                                            for r in trainers))):
            tt = etimes[b][name]
            err = max(c["max_abs_err" if name == "eval_fused" else "tgt_err"]
                      for c in ecases)
            kernels.append({
                "name": name if b == EVAL_B[1] else f"{name}_b{b}",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/eval_fused.cu",
                "replaces": f"src/repro/kernels/eval_fused.py:{line}",
                "launches": launches,
                "max_abs_err": err,
                "ms": tt["ms"],
                "plain_ms": tt["plain_ms"],
                "bound_ms": tt["bound_ms"],
                "bound_by": tt["bound_by"],
                "library_ms": tt["library_ms"],
            })
    for name, (src, replaces) in GUARD_KERNELS.items():
        bcase_err = {"sce_bucket_fwd": "loss", "sce_bucket_dx": "dx",
                     "sce_bucket_dy": "dy", "sce_bucket_plse_fwd": "plse"}
        if name in bcase_err:
            err = max(c["max_abs_err"][bcase_err[name]] for c in bcases)
        else:
            err = max(c["max_abs_err" if name == "eval_topk" else "tgt_err"]
                      for c in tkcases)
        tt = gtimes[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            # the conformance phase is the path that runs these
            "launches": conformance["launches"][name],
            "max_abs_err": err,
            "ms": tt["ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"],
            "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
        })
    # the split is a prologue of the port's own backward: no TPU kernel
    for kname, _, _, replaces in CE_KERNELS + (
            ("linear_ce_split", "linear", "split", None),):
        tt = ctimes[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/linear_ce.cu",
            "replaces": replaces,
            "launches": competitors["launches"][kname],
            "max_abs_err": max(c["max_abs_err"][kname] for c in ccases),
            "ms": tt["ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"],
            "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
        })
    # The LM path (phase 18): its kernels at gemma-2's shapes, with the
    # launches of the LM trainers' runs (counted from 0 around each): the
    # f32 entries the f32 runs' (reduced depth), the bf16 entries
    # (``*_lm_bf16``) the published bf16 runs'.
    lm_launch = lm["train_f32"]["launches"]
    ce_launch = lm["full_ce_f32"]["launches"]
    lm_by_k = lm["train_f32"]["mips_topk_launches_by_k"]
    bf_launch = lm["train"]["launches"]
    bf_ce = lm["full_ce"]["launches"]
    bf_by_k = lm["train"]["mips_topk_launches_by_k"]
    for name, src, replaces, launches in (
            ("mips_topk_lm_positions_k128", "mips_topk.cu",
             "mips_topk.py:52", lm_by_k.get(128, 0)),
            ("mips_topk_lm_vocab_k1024", "mips_topk.cu", "mips_topk.py:52",
             lm_by_k.get(1024, 0)),
            ("sce_gather_plse_fwd_lm", "sce_gather.cu",
             "sce_prefetch.py:497", lm_launch["sce_gather_plse_fwd"]),
            ("sce_gather_plse_dx_lm", "sce_gather.cu",
             "sce_prefetch.py:497", lm_launch["sce_gather_plse_dx"]),
            ("sce_gather_plse_dy_lm", "sce_gather.cu",
             "sce_prefetch.py:497", lm_launch["sce_gather_plse_dy"]),
            # each of the LM path's backwards is one such launch, counted
            # on dX's and dY's wrappers
            ("sce_gather_plse_bwd_lm", "sce_gather.cu",
             "sce_prefetch.py:497", lm_launch["sce_gather_plse_dx"]),
            ("sce_gather_dy_sum_lm", "sce_gather.cu", "sce_prefetch.py:250",
             lm_launch["sce_gather_dy_sum"]),
            ("eval_fused_lm", "eval_fused.cu", "eval_fused.py:104",
             lm_launch["eval_fused"]),
            ("eval_tgt_gather_lm", "eval_fused.cu", "eval_fused.py:82",
             lm_launch["eval_tgt_gather"]),
            # the full-CE baseline's run: its forwards, and its backwards,
            # each one launch counted on dX's and dW's wrappers (fused_lse's
            # deep times, the same entries without pluck and cap, are in
            # --json: no LM path runs them)
            ("linear_ce_fwd_lm", "linear_ce.cu", "linear_sce.py:60",
             ce_launch["linear_ce_fwd"]),
            ("linear_ce_bwd_lm", "linear_ce.cu", "linear_sce.py:121",
             ce_launch["linear_ce_dx"]),
            ("mips_topk_positions_k128_lm_bf16", "mips_topk.cu",
             "mips_topk.py:52", bf_by_k.get(128, 0)),
            ("mips_topk_vocab_k1024_lm_bf16", "mips_topk.cu",
             "mips_topk.py:52", bf_by_k.get(1024, 0)),
            ("sce_gather_plse_fwd_lm_bf16", "sce_gather.cu",
             "sce_prefetch.py:497", bf_launch["sce_gather_plse_fwd"]),
            ("sce_gather_plse_dx_lm_bf16", "sce_gather.cu",
             "sce_prefetch.py:497", bf_launch["sce_gather_plse_dx"]),
            ("sce_gather_plse_dy_lm_bf16", "sce_gather.cu",
             "sce_prefetch.py:497", bf_launch["sce_gather_plse_dy"]),
            ("sce_gather_plse_bwd_lm_bf16", "sce_gather.cu",
             "sce_prefetch.py:497", bf_launch["sce_gather_plse_dx"]),
            ("eval_fused_lm_bf16", "eval_fused.cu", "eval_fused.py:104",
             bf_launch["eval_fused"]),
            ("eval_tgt_gather_lm_bf16", "eval_fused.cu", "eval_fused.py:82",
             bf_launch["eval_tgt_gather"]),
            ("linear_ce_fwd_lm_bf16", "linear_ce.cu", "linear_sce.py:60",
             bf_ce["linear_ce_fwd"]),
            ("linear_ce_bwd_lm_bf16", "linear_ce.cu", "linear_sce.py:121",
             bf_ce["linear_ce_dx"])):
        tt = (lm["kernels_bf16"] if name.endswith("_bf16")
              else lm["kernels"])["timings"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches,
            "max_abs_err": tt["max_abs_err"],
            "ms": tt["ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"],
            "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
        })
    # the in-order dY sum on the bf16 path: into the bf16 table
    tt = lm["kernels_bf16"]["timings"]["sce_gather_dy_sum_lm_bf16"]
    kernels.append({
        "name": "sce_gather_dy_sum_lm_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sce_gather.cu",
        "replaces": "src/repro/kernels/sce_prefetch.py:250",
        "launches": bf_launch["sce_gather_dy_sum"],
        **{k: tt[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}})
    # BERT4Rec (phase 19): its kernels at its shapes, with the launches of
    # its own main-path runs (training, evaluation, the server, the serve
    # and retrieval steps), each counted from 0 around the run.
    bk = b4r["kernels"]["timings"]
    b_by_k = b4r["train"]["mips_topk_launches_by_k"]
    b_launch = b4r["train"]["launches"]
    b_steps = b4r["serve_steps"]
    for name, timing, src, replaces, launches in (
            ("mips_topk_b4r_positions_k320", "mips_topk_positions_k320",
             "mips_topk.cu", "mips_topk.py:52", b_by_k.get(B4R_B_X, 0)),
            ("mips_topk_b4r_catalog_k512", "mips_topk_catalog_k512",
             "mips_topk.cu", "mips_topk.py:52", b_by_k.get(B4R_B_Y, 0)),
            ("mips_topk_b4r_serve_b512_k10", "mips_topk_serve_b512_k10",
             "mips_topk.cu", "mips_topk.py:52", b4r["server"]["launches"]),
            ("mips_topk_b4r_serve_p99_k100", "mips_topk_serve_p99_k100",
             "mips_topk.cu", "mips_topk.py:52",
             b_steps["serve_p99"]["launches"]),
            ("mips_topk_b4r_retrieval_k100", "mips_topk_retrieval_k100",
             "mips_topk.cu", "mips_topk.py:52",
             b_steps["retrieval_cand"]["launches"]),
            ("sce_gather_plse_fwd_b4r", "sce_gather_plse_fwd",
             "sce_gather.cu", "sce_prefetch.py:497",
             b_launch["sce_gather_plse_fwd"]),
            ("sce_gather_plse_dx_b4r", "sce_gather_plse_dx",
             "sce_gather.cu", "sce_prefetch.py:497",
             b_launch["sce_gather_plse_dx"]),
            ("sce_gather_plse_dy_b4r", "sce_gather_plse_dy",
             "sce_gather.cu", "sce_prefetch.py:497",
             b_launch["sce_gather_plse_dy"]),
            ("sce_gather_dy_sum_b4r", "sce_gather_dy_sum", "sce_gather.cu",
             "sce_prefetch.py:250", b_launch["sce_gather_dy_sum"]),
            ("eval_fused_b4r", "eval_fused", "eval_fused.cu",
             "eval_fused.py:104", b4r["eval"]["launches"]["eval_fused"]),
            ("eval_tgt_gather_b4r", "eval_tgt_gather", "eval_fused.cu",
             "eval_fused.py:82", b4r["eval"]["launches"]["eval_tgt_gather"])):
        tt = bk[timing]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches,
            **{k: tt[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}})
    # granite (phase 20): its kernels at its shapes, with the launches of
    # its own main-path runs (SCE training and its evaluation, the
    # full-CE baseline), each counted from 0 around the run.
    gk = granite["kernels"]["timings"]
    g_launch = granite["train"]["launches"]
    g_by_k = granite["train"]["mips_topk_launches_by_k"]
    g_ce = granite["full_ce"]["launches"]
    g_counts = {
        "mips_topk_positions_k128_granite": g_by_k.get(128, 0),
        "mips_topk_vocab_k512_granite": g_by_k.get(512, 0),
        "sce_gather_plse_fwd_granite": g_launch["sce_gather_plse_fwd"],
        "sce_gather_plse_dx_granite": g_launch["sce_gather_plse_dx"],
        "sce_gather_plse_dy_granite": g_launch["sce_gather_plse_dy"],
        # each backward is one launch, counted on dX's and dY's wrappers
        "sce_gather_plse_bwd_granite": g_launch["sce_gather_plse_dx"],
        "sce_gather_dy_sum_granite": g_launch["sce_gather_dy_sum"],
        "eval_fused_granite": g_launch["eval_fused"],
        "eval_tgt_gather_granite": g_launch["eval_tgt_gather"],
        "linear_ce_fwd_granite": g_ce["linear_ce_fwd"],
        "linear_ce_bwd_granite": g_ce["linear_ce_dx"],
    }
    for name, src, replaces in GRANITE_KERNELS:
        tt = gk[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": g_counts[name],
            **{k: tt[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}})
    # distribution (phase 21): shard 0 of 4's times, the launches of the
    # sharded entry points on the (1, 1) mesh
    for name, timing, src, replaces, entry in DIST_KERNELS:
        tt = dist["timings"][timing]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": dist["entry_points"][entry]["launches"][
                name.split("_shard4")[0]],
            **{k: tt[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "merge_max_abs_err")}})
    missing = [k["name"] for k in kernels if k["launches"] < 1]
    check(not missing, f"kernels of a main path launched no time: {missing}")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": card, "build_s": build_s, "cases": cases,
            "timings": {str(b): v for b, v in timings.items()},
            "server": server, "train_cases": tcases, "gather_cases": gcases,
            "plse_cases": pcases, "train_timings": ttimes,
            "trainer": trainer, "trainer_exact": exact,
            "mode_agreement": agreement,
            "eval_cases": ecases,
            "eval_timings": {str(b): v for b, v in etimes.items()},
            "evaluation": evaluation, "ce_cases": ccases,
            "ce_timings": ctimes, "competitor_losses": competitors,
            "conformance": conformance, "trainer_exact_guard_off": exact_off,
            "bucket_cases": bcases, "two_pass_cases": tkcases,
            "guard_timings": gtimes, "drills": drills, "checkpoints": ckpt,
            "lm": lm, "bert4rec": b4r, "granite": granite,
            "distribution": dist, "recsys_gnn": recsys_gnn,
            "kernels": kernels,
        }, indent=1))
    print(f"[{N_PHASES}/{N_PHASES}] summary")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
