"""Time parallel/mesh.py:sharded_seed_extend over one card and over every
visible card on the same batch, to show whether the data-parallel step
spreads its work over the cards.

    python bwamem2_tpu_torch/tools/mesh_probe.py [--reads 60000]
        [--reps 5] [--data DIR]

Makes or reuses the benchdata genome of scale 0.25 (11.7 Mbp) with enough
2x150 pairs under --data (default .tmp/bench_scale0.25), takes --reads of
its reads (L = 152 after padding), and times, each after a warm-up that
also builds the kernels:
  one:    sharded_seed_extend over make_mesh(1) (card 0);
  all:    sharded_seed_extend over make_mesh() (every visible card, each
          slice from a thread of its own);
  serial: the same slices' seed_extend_step run one card after another
          from one thread (what a loop over the cards does: each step
          waits on its card between stages, so card i+1 starts late).
All three are held equal (the five outputs), and the index's replication
onto the cards is timed on its own.  Prints one JSON line: the card with
its power limit, the card count, the reads and each wall time (the median
of --reps, seconds, host clock).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=60_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--data", default=None)
    a = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("mesh_probe: no CUDA device")
    from bwamem2_tpu_torch import benchdata
    from bwamem2_tpu_torch.align.seeding import encode_reads
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
    from bwamem2_tpu_torch.ops.backend import _pad_reads
    from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
    from bwamem2_tpu_torch.ops.entry import seed_extend_step
    from bwamem2_tpu_torch.parallel.mesh import (make_mesh, replicate_index,
                                                 shard_batch,
                                                 sharded_seed_extend)
    data = a.data or os.path.join(REPO, ".tmp", "bench_scale0.25")
    prefix, fq1, fq2 = benchdata.ensure(data, 0.25, (a.reads + 1) // 2)
    fm = FMIndex.load(prefix)
    reads = read_chunk(FastxReader(fq1), FastxReader(fq2), 1 << 40)
    enc, lens = _pad_reads(encode_reads([r.seq for r in reads[:a.reads]]))
    dfm = DeviceFMIndex.from_host(fm, "cuda:0")
    one, every = make_mesh(1), make_mesh()

    def serial():
        dfms = replicate_index(every, dfm)
        encs, lenss, n = shard_batch(every, enc, lens)
        parts = [[x.cpu() for x in seed_extend_step(d, e, ln)]
                 for d, e, ln in zip(dfms, encs, lenss)]
        return [torch.cat([p[i] for p in parts]).numpy()[:n]
                for i in range(5)]

    runs = {"one": lambda: sharded_seed_extend(one, dfm, enc, lens),
            "all": lambda: sharded_seed_extend(every, dfm, enc, lens),
            "serial": serial,
            "replicate": lambda: replicate_index(every, dfm)}
    want = runs["one"]()
    for name in ("all", "serial"):
        for nm, x, y in zip(("b", "k", "s", "coords", "ext"), runs[name](),
                            want):
            if not np.array_equal(x, y):
                sys.exit(f"mesh_probe: {name}'s {nm} differs from one card")
    secs = {}
    for name, fn in runs.items():
        ts = []
        for _ in range(a.reps):
            for d in every:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            fn()
            for d in every:
                torch.cuda.synchronize(d)
            ts.append(time.perf_counter() - t0)
        secs[name] = statistics.median(ts)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"card": smi[0] if smi else None, "cards": len(every),
                      "reads": int(enc.shape[0]), "L": int(enc.shape[1]),
                      "reps": a.reps, "seconds": secs,
                      "identical": True}))


if __name__ == "__main__":
    main()
