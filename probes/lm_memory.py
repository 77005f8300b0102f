#!/usr/bin/env python3
"""What makes up an LM trainer's device memory, on the card.

Runs ``train(ARCH, cfg=make_config(), batch=n, seq_len=4096, steps=2)``
(n = train_4k's microbatches of one sequence, SCE ``exact``, the guard's
``warn``) with a ``mark`` hook that reads, at every phase's end, the
bytes the caching allocator holds for tensors and their peak
(``memory_allocated`` / ``max_memory_allocated``). Prints them for the
first step, phase by phase, so one sees where memory grows. At the
second step's start it takes a census of the CUDA tensors Python can
reach (``gc.get_objects``; one entry a storage), grouped by type and
shape, with for the largest groups who holds each tensor (the chain of
referrers: dict keys, attributes, frames), and prints the bytes held
that Python cannot reach (autograd's graph, caches) as the difference
to ``memory_allocated``. From the first step's last backward to the
second step's start the allocator records each allocation's Python
stack (``torch.cuda.memory._record_memory_history``), so the blocks of
that window still live at the second step's start are summed by the
innermost ``src/repro_torch`` frame that allocated them. Last, what is
left allocated once ``train`` has returned, and the card's name and
power limit.

Usage (from the repository root, on a machine with one NVIDIA GPU)::

    python3 probes/lm_memory.py [ARCH] [--top N]

ARCH defaults to ``granite-moe-3b-a800m``.
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import sys
import types
import weakref
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SEQ = 4096
GiB = 2**30


SKIP_FRAMES = ("holders", "census", "mark")


def holders(obj, depth=4):
    """A short description of who refers to ``obj``, up ``depth`` links."""
    chain, cur, seen = [], obj, {id(obj)}
    for _ in range(depth):
        refs = [r for r in gc.get_referrers(cur) if id(r) not in seen
                and not (isinstance(r, types.FrameType)
                         and r.f_code.co_name in SKIP_FRAMES)]
        if not refs:
            chain.append("(no referrer)")
            break
        # a dict's key or a frame names a holder best
        r = min(refs, key=lambda r_: (not isinstance(r_, dict),
                                      not isinstance(r_, types.FrameType)))
        seen.add(id(r))
        if isinstance(r, dict):
            key = next((k for k, v in r.items() if v is cur), "?")
            chain.append(f"dict[{key!r}]")
        elif isinstance(r, types.FrameType):
            chain.append(f"frame {r.f_code.co_name} "
                         f"({Path(r.f_code.co_filename).name}:{r.f_lineno})")
            break
        else:
            chain.append(type(r).__name__)
        cur = r
    return " <- ".join(chain)


def census(torch, top):
    """CUDA tensors Python reaches, one a storage, grouped by (dtype,
    shape) → (bytes reached, the ``top`` largest groups as (key, storages,
    bytes, [(bytes, its holders)] for up to 3 of a group above 0.25
    GiB))."""
    gc.collect()
    by_storage = {}
    objs = gc.get_objects()
    for o in objs:
        try:
            if torch.is_tensor(o) and o.is_cuda:
                st = o.untyped_storage()
                if st.data_ptr() not in by_storage:
                    by_storage[st.data_ptr()] = (st.nbytes(), weakref.ref(o),
                                                 str(o.dtype).split(".")[1],
                                                 tuple(o.shape))
        except Exception:  # objects that fail is_tensor's checks
            continue
    del objs, o
    groups = defaultdict(list)
    for nbytes, ref, dtype, shape in by_storage.values():
        groups[(dtype, shape)].append((nbytes, ref))
    reach = sum(v[0] for v in by_storage.values())
    rows = []
    for key, items in sorted(groups.items(),
                             key=lambda kv: -sum(n for n, _ in kv[1]))[:top]:
        size = sum(n for n, _ in items)
        who = []
        if size > GiB / 4:
            for nb, ref in items[:3]:
                t = ref()
                who.append((nb, "(freed)" if t is None else holders(t)))
                del t
        rows.append((key, len(items), size, who))
    return reach, rows


def window_blocks(snap, top):
    """The live blocks of a snapshot that carry an allocation stack
    (those allocated while history was on), summed by the innermost
    ``src/repro_torch`` frame → (bytes, [(where, bytes, blocks)])."""
    groups = defaultdict(lambda: [0, 0])
    for seg in snap["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = blk.get("frames") or [
                f for h in blk.get("history", []) for f in h.get("frames", [])]
            if not frames:
                continue
            g = groups[where(frames)]
            g[0] += blk["size"]
            g[1] += 1
    total = sum(g[0] for g in groups.values())
    rows = sorted(((k, v[0], v[1]) for k, v in groups.items()),
                  key=lambda r: -r[1])[:top]
    return total, rows


def where(frames) -> str:
    """The innermost frame under src/repro_torch, else the innermost."""
    for f in frames:
        if "repro_torch" in f["filename"]:
            name = f["filename"].split("src/")[-1]
            return f"{name}:{f['line']} {f['name']}"
    f = frames[0]
    return f"{Path(f['filename']).name}:{f['line']} {f['name']}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="granite-moe-3b-a800m")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lm_memory: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.kernels import guard
    from repro_torch.launch.train import train

    dev = resolve_device("cuda")
    arch = get_arch(args.arch)
    cfg = arch.make_config()
    n = arch.microbatches["train_4k"]
    guard.run_conformance(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    marks, seen = [], {"start": 0, "backward": 0}
    found = {}

    def mark(name):
        if name == "start":
            seen["start"] += 1
            if seen["start"] == 2:
                torch.cuda.synchronize()
                found["allocated"] = torch.cuda.memory_allocated(dev)
                found["census"] = census(torch, args.top)
                found["window"] = window_blocks(
                    torch.cuda.memory._snapshot(), args.top)
                torch.cuda.memory._record_memory_history(enabled=None)
        if seen["start"] != 1:
            return
        marks.append((name, torch.cuda.memory_allocated(dev),
                      torch.cuda.max_memory_allocated(dev)))
        if name == "backward":
            seen["backward"] += 1
            if seen["backward"] == n:
                # from the last microbatch's backward to the next step:
                # the allocations of the update, with their Python
                # stacks (none of it runs on autograd's threads)
                torch.cuda.memory._record_memory_history(
                    enabled="all", context="alloc", stacks="python",
                    max_entries=1_000_000)

    out = train(args.arch, cfg=cfg, batch=n, seq_len=SEQ, steps=2, seed=0,
                sce_mode="exact", log_every=1, device=dev,
                guard_policy="warn", mark=mark)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{args.arch} ({cfg.n_layers} layers, {cfg.dtype}), 2 steps of "
          f"{n} × {SEQ} tokens in {n} microbatches; losses {out['losses']};"
          f" live before {base / GiB:.3f} GiB, peak {peak:,} B "
          f"({peak / GiB:.2f} GiB)")
    print("step 1 by mark (allocated / peak so far, GiB): " + ", ".join(
        f"{i}:{name} {a / GiB:.2f}/{p / GiB:.2f}"
        for i, (name, a, p) in enumerate(marks)))
    reach, rows = found["census"]
    alloc = found["allocated"]
    print(f"at the second step's start: allocated {alloc:,} B "
          f"({alloc / GiB:.2f} GiB); Python reaches {reach / GiB:.2f} GiB "
          f"of it, {(alloc - reach) / GiB:.2f} GiB it cannot (autograd, "
          f"caches); largest groups (dtype, shape: storages, GiB):")
    for (dtype, shape), count, size, who in rows:
        print(f"  {dtype} {shape}: {count}, {size / GiB:.3f}")
        for nb, chain in who:
            print(f"      {nb / GiB:.3f} GiB held by {chain}")
    total, rows = found["window"]
    print(f"live at the second step's start and allocated from the last "
          f"microbatch's backward on: {total / GiB:.2f} GiB, by allocating "
          f"frame:")
    for name, size, count in rows:
        print(f"  {size / GiB:8.3f} GiB  {count:5d} blocks  {name}")
    del out
    gc.collect()
    torch.cuda.synchronize()
    print(f"after train() returned and gc: allocated "
          f"{torch.cuda.memory_allocated(dev) / GiB:.2f} GiB")
    print(f"card: {smi.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
