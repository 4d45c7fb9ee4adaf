"""Time parallel/mesh.py:sharded_seed_extend over one card and over every
visible card on the same batch, to show whether the data-parallel step
spreads its work over the cards; and the same step and `mem` over an
index sharded over the cards (parallel/shard_index.py) beside the
replicated ones.

    python bwamem2_tpu_torch/tools/mesh_probe.py [--reads 60000]
        [--reps 5] [--data DIR] [--mem-pairs 10000]

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
  sharded: parallel/shard_index.py:sharded_seed_extend_sharded_index
          over every card (the index split into one shard per card, made
          anew each call as in the JAX package, and the batch split);
All four are held equal (the five outputs), and the index's replication
and its sharding onto the cards are timed on their own.  Then `mem` PE on
the first --mem-pairs pairs at -K 2,250,000 through the CLI entry, once
with one backend per card (the replicated index) and once with
BWAMEM2_TPU_SHARD_INDEX set (one backend over an index sharded over every
card), each once to warm up and then timed; their SAM must be equal.
Prints one JSON line: the card with its power limit, the card count, the
reads, each wall time (the median of --reps for the step, one run for
mem; seconds, host clock) and the bytes of index tables each card holds
in either layout.
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
    ap.add_argument("--mem-pairs", type=int, default=10_000)
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
    from bwamem2_tpu_torch.parallel.shard_index import (
        shard_index, sharded_seed_extend_sharded_index, table_bytes)
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
            "sharded": lambda: sharded_seed_extend_sharded_index(
                every, dfm, enc, lens),
            "replicate": lambda: replicate_index(every, dfm),
            "shard": lambda: shard_index(dfm, every)}
    want = runs["one"]()
    for name in ("all", "serial", "sharded"):
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
    rep_bytes = {}
    for d in replicate_index(every, dfm):
        rep_bytes[str(d.device)] = sum(
            t.numel() * t.element_size() for t in (
                d.occp, d.occ_hi, d.sa_ms, d.sa_ls, d.ref, d.counts))
    shard_bytes = table_bytes(shard_index(dfm, every))
    mem_s = mem_runs(prefix, fq1, fq2, a.mem_pairs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"card": smi[0] if smi else None, "cards": len(every),
                      "reads": int(enc.shape[0]), "L": int(enc.shape[1]),
                      "reps": a.reps, "seconds": secs,
                      "mem_pairs": a.mem_pairs, "mem_seconds": mem_s,
                      "table_bytes": {"replicated": rep_bytes,
                                      "sharded": shard_bytes},
                      "identical": True}))


def mem_run(prefix: str, fqs: list, sam: str, devices=None,
            sharded: bool = False, reps: int = 2,
            device: str = "cuda") -> tuple:
    """`mem` (the CLI entry, -K 2,250,000) on fqs into sam, `reps` times,
    over `devices` (ops.resolve_devices replaced for the runs; None: every
    visible card) with BWAMEM2_TPU_SHARD_INDEX set when `sharded`: one
    backend per device (replicated) or one over an index in a shard per
    device.  Returns (the last run's seconds, its SAM records)."""
    from bwamem2_tpu_torch import cli, ops
    resolve = ops.resolve_devices
    if devices is not None:
        ops.resolve_devices = lambda dev=None: list(devices)
    if sharded:
        os.environ["BWAMEM2_TPU_SHARD_INDEX"] = "1"
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            if cli.main(["mem", "--device", device, "-K", "2250000", "-v",
                         "1", "-o", sam, prefix, *fqs]):
                raise RuntimeError(f"mem over {devices} (sharded "
                                   f"{sharded}) failed")
            secs = time.perf_counter() - t0
    finally:
        os.environ.pop("BWAMEM2_TPU_SHARD_INDEX", None)
        ops.resolve_devices = resolve
    with open(sam) as f:
        return secs, [ln for ln in f if not ln.startswith("@")]


def mem_runs(prefix: str, fq1: str, fq2: str, pairs: int) -> dict:
    """`mem` PE on the first `pairs` pairs over every card, replicated and
    sharded, each warm (a first run builds and uploads), their SAM held
    equal: {layout: seconds of the timed run}."""
    import tempfile
    d = tempfile.mkdtemp(prefix="mesh_probe_")
    fqs = []
    for i, src in enumerate((fq1, fq2)):
        fqs.append(os.path.join(d, f"r{i + 1}.fq"))
        with open(src) as f, open(fqs[-1], "w") as g:
            g.writelines(ln for _, ln in zip(range(4 * pairs), f))
    out, secs = {}, {}
    for layout in ("replicated", "sharded"):
        secs[layout], out[layout] = mem_run(
            prefix, fqs, os.path.join(d, f"{layout}.sam"),
            sharded=layout == "sharded")
    if out["replicated"] != out["sharded"]:
        sys.exit("mesh_probe: the sharded mem's SAM differs from the "
                 "replicated one's")
    return secs


if __name__ == "__main__":
    main()
