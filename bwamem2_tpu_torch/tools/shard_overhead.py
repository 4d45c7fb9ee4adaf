"""What the genome-bucket sharded index costs against the replicated one,
on the same inputs (the port of tools/shard_overhead.py).

    python -m bwamem2_tpu_torch.tools.shard_overhead [--scale 0.25]
        [--pairs 10000] [--sections kernels,pipeline] [--device cuda]
        [--shards 2]
    python -m bwamem2_tpu_torch.tools.shard_overhead --index PREFIX
        --fq1 R1.fq [--fq2 R2.fq] ...

The JAX tool times one jitted occ_all4 round, where a sharded row fetch is
a collective; in the port a row fetch is a load inside each kernel
(csrc/fm_occ.cuh:FmShardView reads the owning shard, over NVLink when it
lies on another card), so there is no launch of its own to time.  The
kernels section times instead the FmView and FmShardView instantiations
of two kernels at the JAX tool's lane counts, 1,024, 8,192 and 65,536:
  sa_resolve   that many random BWT positions (the SA walk's row reads);
  round1_walk  that many (read, end) lanes: reads of the data cut to 128
               bases, lanes / 128 of them (the LF walk's row reads).
Each is held equal to the replicated launch and timed (the mean of 5
calls after a warm-up, CUDA events; host clock on the CPU) over every
layout: --shards shards on the first device, and, with several cards
visible, one shard per card (a launch on cuda:0 reading every card).
sa_resolve's plain version (sa_resolve_ref, whose row fetch is
device_index.dist_rows_ref, the collective's semantics) is timed over
each layout too, one call after a warm-up.
The pipeline section runs `mem` (the CLI entry, -K 2,250,000) on the
reads, replicated on the first device and with BWAMEM2_TPU_SHARD_INDEX
set over each layout, twice each (the second timed: the first builds and
uploads; once on the CPU), and raises unless every SAM is bit-identical to the
replicated one (tools/mesh_probe.py:mem_run).  Beside them it runs the
sharded layouts' own code over one shard on the first device
(TorchBackend(sharded=True) with one device, which `mem` never builds):
the per-stage seeding with every row local, so that the sharded layouts'
time over it is the cost of the fetch alone, and the replicated time
over it the cost of the per-stage path against the fused one.  Data: benchdata.ensure
(.tmp/bench_scale<scale>, scale, pairs), or the files given (--fq2 left
out: SE).  Prints one JSON line with the card and its power
limit.  On --device cpu the shards are CPU "cards" and every launch runs
the plain version.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LANES = (1024, 8192, 65536)
WALK_L = 128
REPS = 5


def timed_ms(dev, fn, reps: int) -> float:
    """Mean ms of fn() over reps calls after one warm-up (CUDA events on a
    card, the host clock on the CPU)."""
    fn()
    if dev.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize(dev)
        return e0.elapsed_time(e1) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def layouts(dev: torch.device, shards: int) -> dict:
    """{name: device list of the shards}: `shards` on the first device
    and, with several cards visible, one per card."""
    out = {f"{shards} shards on {dev}": [dev] * shards}
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        out[f"one shard per card ({n} cards)"] = [
            torch.device("cuda", i) for i in range(n)]
    return out


def kernels(fm, reads, dev, lays: dict, log) -> dict:
    """The kernels section: {kernel: {lanes: {layout: ms}}}, "replicated"
    among the layouts."""
    from ..align.seeding import encode_reads
    from ..ops.backend import _pad_reads
    from ..ops.device_index import DeviceFMIndex
    from ..ops.seed import sa_resolve, sa_resolve_ref
    from ..ops.smem import round1_walk
    from ..parallel.shard_index import shard_index
    rep = DeviceFMIndex.from_host(fm, dev)
    views = {"replicated": rep}
    views.update({name: shard_index(rep, devs)[0]
                  for name, devs in lays.items()})
    rng = np.random.default_rng(0)
    enc_all, _ = _pad_reads(encode_reads(
        [r.seq[:WALK_L] for r in reads[:max(LANES) // WALK_L]]), WALK_L)
    out: dict = {"sa_resolve": {}, "round1_walk": {}}
    for n in LANES:
        pos = torch.from_numpy(rng.integers(0, 2 * fm.l_pac + 1, n)).to(dev)
        nr = n // WALK_L
        if nr > enc_all.shape[0]:
            raise ValueError(f"round1_walk at {n} lanes needs {nr} reads, "
                             f"the data has {enc_all.shape[0]}")
        enc = torch.from_numpy(enc_all[:nr]).to(dev)
        lens = torch.full((nr,), WALK_L, dtype=torch.int32, device=dev)
        calls = {"sa_resolve": lambda v: (sa_resolve(v, pos),),
                 "round1_walk": lambda v: round1_walk(v, enc, lens)}
        for kern, call in calls.items():
            want = call(rep)
            row = {}
            for name, v in views.items():
                if not all(torch.equal(g, w) for g, w in zip(call(v), want)):
                    raise RuntimeError(f"{kern} over {name} differs from "
                                       "the replicated index")
                row[name] = round(timed_ms(dev, lambda: call(v), REPS), 5)
            if kern == "sa_resolve":    # the plain version's fetch,
                for name in lays:          # dist_rows_ref, over the shards
                    row[f"plain, {name}"] = round(timed_ms(
                        dev, lambda: sa_resolve_ref(views[name], pos), 1), 3)
            out[kern][n] = row
            log(f"  {kern:<12} lanes={n:6d}  " + "  ".join(
                f"{k} {ms:.4f} ms ({ms / row['replicated']:.2f}x)"
                for k, ms in row.items()))
    return out


def per_stage_one_shard(prefix, fqs, dev, reps: int) -> tuple:
    """The sharded index's pipeline over one shard on `dev` (the per-stage
    seeding through FmView, which `mem` never takes: it shards only over
    several devices), as `mem` runs it (-K 2,250,000, one worker):
    (seconds of the last of `reps` runs, SAM records)."""
    from ..align.pipeline import Aligner
    from ..index.fmindex import FMIndex
    from ..io.fastq import FastxReader
    from ..ops.backend import TorchBackend
    from ..options import MEM_F_PE, MemOptions
    from ..runtime import run_pipeline
    from .host_ceiling import sync
    opt = MemOptions().finalize(None)
    if len(fqs) > 1:
        opt.flag |= MEM_F_PE
    for _ in range(reps):
        out = io.StringIO()
        t0 = time.perf_counter()
        fm = FMIndex.load(prefix)
        al = Aligner(fm, opt, backend=TorchBackend(
            fm, opt, devices=[dev], sharded=True), verbose=0)
        run_pipeline(al, FastxReader(fqs[0]),
                     FastxReader(fqs[1]) if len(fqs) > 1 else None,
                     2_250_000, out, verbose=0, n_workers=1)
        sync(dev)
        secs = time.perf_counter() - t0
    return secs, out.getvalue().splitlines(keepends=True)


def pipeline(prefix, fqs, dev, lays: dict, log) -> dict:
    """The pipeline section: {layout: seconds} of `mem`, "replicated" on
    the first device among them, and the per-stage path over one shard
    there ("per-stage, 1 shard": the sharded layouts' code with every row
    local); every SAM bit-identical."""
    from .mesh_probe import mem_run
    d = tempfile.mkdtemp(prefix="shard_overhead_")
    dtype = dev.type
    reps = 2 if dtype == "cuda" else 1   # a card's first run builds, uploads
    secs, want = mem_run(prefix, fqs, os.path.join(d, "replicated.sam"),
                         [dev], False, reps, dtype)
    out = {"replicated": round(secs, 4)}
    log(f"  mem replicated on {dev}: {secs:.3f}s ({len(want)} records)")
    secs, got = per_stage_one_shard(prefix, fqs, dev, reps)
    if got != want:
        raise RuntimeError("the per-stage path over one shard differs from "
                           "the replicated run")
    out["per-stage, 1 shard"] = round(secs, 4)
    log(f"  per-stage seeding, 1 shard on {dev} (index load and upload "
        f"included, as in mem): {secs:.3f}s, SAM identical")
    for i, (name, devs) in enumerate(lays.items()):
        secs, got = mem_run(prefix, fqs, os.path.join(d, f"sharded{i}.sam"),
                            devs, True, reps, dtype)
        if got != want:
            bad = sum(x != y for x, y in zip(got, want))
            raise RuntimeError(f"mem over {name}: {bad} of {len(want)} SAM "
                               "records differ from the replicated run")
        out[name] = round(secs, 4)
        log(f"  mem sharded, {name}: {secs:.3f}s "
            f"({secs / out['replicated']:.2f}x), SAM identical")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--pairs", type=int, default=10_000)
    ap.add_argument("--index", default=None)
    ap.add_argument("--fq1", default=None)
    ap.add_argument("--fq2", default=None)
    ap.add_argument("--sections", default="kernels,pipeline")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from .. import benchdata
    from ..index.fmindex import FMIndex
    from ..io.fastq import FastxReader, read_chunk
    from ..ops import resolve_device
    from .kernel_micro import card
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    dev = resolve_device(a.device)        # cuda without a card raises
    if a.index:
        prefix, fqs = a.index, [f for f in (a.fq1, a.fq2) if f]
    else:
        prefix, *fqs = benchdata.ensure(
            os.path.join(REPO, ".tmp", f"bench_scale{a.scale}"), a.scale,
            a.pairs)
    fm = FMIndex.load(prefix)
    lays = layouts(dev, a.shards)
    sections = a.sections.split(",")
    rep = dict(card=card(dev), cards=torch.cuda.device_count()
               if dev.type == "cuda" else 0, layouts=list(lays))
    if "kernels" in sections:
        log(f"== sa_resolve / round1_walk, FmView vs FmShardView "
            f"[{rep['card']}]")
        reads = read_chunk(FastxReader(fqs[0]), None, 1 << 40)
        rep["kernels_ms"] = kernels(fm, reads, dev, lays, log)
    if "pipeline" in sections:
        log(f"== mem, replicated vs sharded index [{rep['card']}]")
        rep["mem_s"] = pipeline(prefix, fqs, dev, lays, log)
        rep["identical"] = True
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
