"""Time the seeding kernel smem_collect of a checkout on one default-size
chunk, to compare two commits' kernels on the same inputs and card.

    python bwamem2_tpu_torch/tools/seed_probe.py --root DIR [--scale 2.0]
        [--data DIR] [--reps 3]

Imports bwamem2_tpu_torch from the checkout at --root (this commit's or an
earlier one's), makes or reuses the benchdata genome of --scale (2.0: 93.4
Mbp, an occ table beyond the H100's 50 MB L2) with 35,000 2x150 pairs
under --data, takes the first chunk at the CLI's default task size (10
Mbp: 66,668 reads), and prints one JSON line: the card with its power
limit, the reads, the backward_ext calls and smem_collect's CUDA-event
milliseconds (mean of --reps launches after a warm-up).  It drives either
kernel interface: the lane-group kernel's list capacity and per-read slot
offsets, or, for a checkout older than the lane-group kernel (PR 6), the
one-thread kernel's per-grid slot cap (smem_cap), which exists only to
time such a checkout as the "before" figure.
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
    prefix, fq1, fq2 = benchdata.ensure(data, a.scale, 35_000)
    fm = FMIndex.load(prefix)
    reads = read_chunk(FastxReader(fq1), FastxReader(fq2), 10_000_000)
    enc, lens = _pad_reads(encode_reads([r.seq for r in reads]))
    dfm = DeviceFMIndex.from_host(fm, "cuda")
    e, ln = torch.from_numpy(enc).cuda(), torch.from_numpy(lens).cuda()
    opt = MemOptions().finalize()
    N, L = enc.shape
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    args = (dfm, e, ln, opt.min_seed_len, split_len, int(opt.split_width),
            int(opt.max_mem_intv))
    if hasattr(seed, "smem_cap"):           # a checkout before PR 6
        args += (seed.smem_cap(L),)
        design = "one thread per read"
    else:
        args += (seed.list_cap(L), seed.slot_offsets(ln))
        design = (f"lane group of {seed.smem_collect.lanes_for(N)} per "
                  "read")
    out = seed.smem_collect(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(a.reps):
        seed.smem_collect(*args)
    e1.record()
    torch.cuda.synchronize()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        root=root, design=design, card=card, scale=a.scale,
        l_pac=int(fm.l_pac), reads=N, L=L, bwd_ext=int(out[5].sum()),
        overflowed=int((out[4] < 0).sum()),
        smem_collect_ms=e0.elapsed_time(e1) / a.reps)), flush=True)


if __name__ == "__main__":
    main()
