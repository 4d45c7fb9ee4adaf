"""Time the seeding kernels smem_collect and sa_resolve of a checkout on one
default-size chunk, to compare two commits' kernels on the same inputs and
card.

    python bwamem2_tpu_torch/tools/seed_probe.py --root DIR [--scale 2.0]
        [--data DIR] [--reps 3] [--pairs 35000] [--task-bases 10000000]
        [--walk]

Imports bwamem2_tpu_torch from the checkout at --root (this commit's or an
earlier one's whose smem_collect takes per-read slot offsets), makes or
reuses the benchdata genome of --scale (2.0: 93.4 Mbp, an occ table beyond
the H100's 50 MB L2) with 35,000 2x150 pairs under --data, takes the first
chunk at the CLI's default task size (10 Mbp: 66,668 reads), and prints
one JSON line: the card with its power limit, the reads, the backward_ext
calls and smem_collect's CUDA-event milliseconds, then the chunk's
max_occ-sampled SA positions (FusedSeeder's compaction of that output) and
sa_resolve's milliseconds on them, each the mean of --reps launches after
a warm-up.  --pairs and --task-bases pick another chunk (chip_smoke.py's
run (a): --scale 0.25 --pairs 10000 --task-bases 2250000).  --walk also
times round1_walk (the seed-extend step's round-1 walk; the checkout must
have it) on the chunk and reports its ptxas registers and stack frame
per index view where this process built the library.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--data", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=35_000)
    ap.add_argument("--task-bases", type=int, default=10_000_000)
    ap.add_argument("--walk", action="store_true")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("seed_probe: no CUDA device")
    from bwamem2_tpu_torch import benchdata
    from bwamem2_tpu_torch.align.seeding import encode_reads
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
    from bwamem2_tpu_torch.ops import seed
    from bwamem2_tpu_torch.ops.backend import _pad_reads
    from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
    from bwamem2_tpu_torch.options import MemOptions
    data = a.data or os.path.join(root, ".tmp", f"bench_scale{a.scale}")
    prefix, fq1, fq2 = benchdata.ensure(data, a.scale, a.pairs)
    fm = FMIndex.load(prefix)
    reads = read_chunk(FastxReader(fq1), FastxReader(fq2), a.task_bases)
    enc, lens = _pad_reads(encode_reads([r.seq for r in reads]))
    dfm = DeviceFMIndex.from_host(fm, "cuda")
    e, ln = torch.from_numpy(enc).cuda(), torch.from_numpy(lens).cuda()
    opt = MemOptions().finalize()
    N, L = enc.shape
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    off = seed.slot_offsets(ln)
    args = (dfm, e, ln, opt.min_seed_len, split_len, int(opt.split_width),
            int(opt.max_mem_intv), seed.list_cap(L), off)
    sa = seed.sa_resolve
    if hasattr(sa, "shape_for"):
        W, threads = sa.shape_for(0)
        sa_design = f"{W} walks per lane, {threads} threads per block"
    else:
        sa_design = "one thread per position"

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(a.reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / a.reps

    out = seed.smem_collect(*args)
    sm_ms = timed(lambda: seed.smem_collect(*args))
    pos = seed.compact_and_expand(*out[:5], off, int(opt.max_occ))[3]
    sa_ms = timed(lambda: sa(dfm, pos))
    walk = {}
    if a.walk:
        import re
        from bwamem2_tpu_torch.ops.smem import round1_walk
        walk["round1_walk_ms"] = timed(lambda: round1_walk(dfm, e, ln))
        for ln_ in round1_walk.build_log.splitlines():
            m = re.search(r"Function properties for (\w+)|Used (\d+) "
                          r"registers|(\d+) bytes stack frame", ln_)
            if m and m[1]:
                view = "FmShardView" if "ILi1E" in m[1] else "FmView"
            elif m and m[2]:
                walk[f"round1_walk_registers_{view}"] = int(m[2])
            elif m and m[3]:
                walk[f"round1_walk_stack_{view}"] = int(m[3])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        root=root, card=card, scale=a.scale, l_pac=int(fm.l_pac), reads=N,
        L=L, lanes=seed.smem_collect.lanes_for(N),
        bwd_ext=int(out[5].sum()), overflowed=int((out[4] < 0).sum()),
        smem_collect_ms=sm_ms, positions=int(pos.numel()),
        sa_design=sa_design, sa_resolve_ms=sa_ms, **walk)), flush=True)


if __name__ == "__main__":
    main()
