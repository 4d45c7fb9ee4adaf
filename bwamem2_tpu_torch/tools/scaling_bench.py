"""How `mem` PE scales over several cards (the port of
tools/scaling_bench.py).  Two modes:

  shard       for each N of --ns, N processes of `python -m
              bwamem2_tpu_torch.cli mem --shard h:N --out-dir D` (the
              deterministic chunk split; `mem` puts shard h on card h % the
              visible cards), then `merge`.  When N cards are visible the
              N processes run at once, one a card, as on N hosts; else back
              to back on the cards there are.  The JSON says which
              ("concurrent").  Efficiency is T(1) / (N x max_h T_shard(h,
              N)), each T a process's wall (Python start, index load and
              upload included: the costs a shard pays); the kernels are
              built once, before the first process starts.
  roundrobin  for each N, one Aligner over a TorchBackend per card
              (cuda:0 ... cuda:N-1) through runtime.run_pipeline(aligners,
              ...) with max(N, 2) workers, two passes (the second timed;
              one on the CPU): the in-process data parallelism of `mem`
              over N cards.  Its
              wall against one card's (speedup_vs_1 = T(1) / T(N); the
              JAX tool's overhead_vs_1dev = T(N) / T(1)).

Both hold every N's SAM records identical to N = 1's and raise if they
differ.

    python -m bwamem2_tpu_torch.tools.scaling_bench [--mode shard]
        [--ns 1,2,4] [--scale 1.0] [--pairs 10000] [--chunk 750000]
        [--device cuda]
    python -m bwamem2_tpu_torch.tools.scaling_bench --index PREFIX
        --fq1 R1.fq [--fq2 R2.fq] ...

Data: benchdata.ensure(.tmp/bench_scale<scale>, scale, pairs), or the
files given (--fq2 left out: SE).  On --device cpu the devices are
those ops.resolve_devices("cpu") gives (one, unless a test replaces it).
Prints one JSON line, keyed by N, with the card and its power limit.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_kernels() -> None:
    """Build the kernel libraries `mem` loads on a replicated index, side
    by side (ops/cuda_build.py keys each by its sources' hash and reuses a
    built one), so that no shard process pays or races for a build."""
    from concurrent.futures import ThreadPoolExecutor
    from ..ops.bsw_cuda import bsw_extend
    from ..ops.bsw_shear_cuda import bsw_shear
    from ..ops.kswv_cuda import kswv
    from ..ops.seed import sa_resolve, smem_collect
    with ThreadPoolExecutor(5) as pool:
        list(pool.map(lambda k: k.lib(), (bsw_extend, bsw_shear, kswv,
                                          sa_resolve, smem_collect)))


def run_shards(prefix, fqs, outdir, hs, n, chunk, device) -> dict:
    """`mem --shard h:n` for every h of hs as processes at once; returns
    ({h: its wall seconds}, {h: the seconds `mem` itself reports, from
    the index load to the last chunk: the wall less Python's start, the
    imports and the card's context})."""
    procs, logs, walls = {}, {}, {}
    t0 = time.perf_counter()
    for h in hs:
        logs[h] = open(os.path.join(outdir, f"shard{h}.log"), "w+")
        procs[h] = subprocess.Popen(
            [sys.executable, "-m", "bwamem2_tpu_torch.cli", "mem",
             "--device", device, "-K", str(chunk), "-v", "1", "--shard",
             f"{h}:{n}", "--out-dir", outdir, "-o",
             os.path.join(outdir, f"header{h}.sam"), prefix, *fqs],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=logs[h])
    try:
        while len(walls) < len(procs):
            for h, p in procs.items():
                if h not in walls and p.poll() is not None:
                    walls[h] = time.perf_counter() - t0
            time.sleep(0.005)
    finally:
        for p in procs.values():
            p.kill()
    inner = {}
    for h, p in procs.items():
        logs[h].seek(0)
        err = logs[h].read()
        logs[h].close()
        if p.returncode:
            raise RuntimeError(f"--shard {h}:{n} exited with "
                               f"{p.returncode}:\n{err[-3000:]}")
        done = re.findall(r"\* done in ([0-9.]+)s", err)
        inner[h] = float(done[-1]) if done else None
    return walls, inner


def shard_mode(prefix, fqs, ns, chunk, device, log) -> dict:
    from .. import cli
    cards = 0
    if device == "cuda":
        import torch
        cards = torch.cuda.device_count()
        build_kernels()
    work = tempfile.mkdtemp(prefix="scaling_bench_")
    report, sams, walls = {}, {}, {}
    for n in ns:
        outdir = os.path.join(work, f"shards_{n}")
        shutil.rmtree(outdir, ignore_errors=True)
        os.makedirs(outdir)
        concurrent = cards >= n
        times, inner = [0.0] * n, [None] * n
        for hs in ([range(n)] if concurrent else [[h] for h in range(n)]):
            w, m = run_shards(prefix, fqs, outdir, hs, n, chunk, device)
            for h in hs:
                times[h], inner[h] = w[h], m[h]
        parts = sorted(os.path.join(outdir, f) for f in os.listdir(outdir)
                       if f.startswith("part.chunk") and f.endswith(".sam"))
        merged = os.path.join(outdir, "merged.sam")
        if cli.main(["merge", merged, *parts]):
            raise RuntimeError(f"merge of N={n} failed")
        with open(merged) as f:
            sams[n] = [ln for ln in f if not ln.startswith("@")]
        walls[n] = times
        report[n] = dict(shard_walls_s=[round(t, 4) for t in times],
                         shard_mem_s=inner,
                         max_shard_wall_s=round(max(times), 4),
                         concurrent=concurrent, chunks=len(parts))
        log(f"[scaling] N={n}: shard walls {[round(t, 2) for t in times]}s"
            f" ({'at once, a card each' if concurrent else 'back to back'})")
    base = max(walls[min(ns)])
    for n in ns:
        if sams[n] != sams[ns[0]]:
            raise RuntimeError(f"N={n}: merged SAM differs from N={ns[0]}")
        report[n]["efficiency"] = round(base / (n * max(walls[n])), 4)
        report[n]["output_identical"] = True
        log(f"[scaling] N={n}: efficiency {report[n]['efficiency']:.2%}, "
            "output identical")
    return report


def roundrobin_mode(prefix, fqs, ns, chunk, device, log) -> dict:
    from ..align.pipeline import Aligner
    from ..index.fmindex import FMIndex
    from ..io.fastq import FastxReader
    from ..ops import resolve_devices
    from ..ops.backend import TorchBackend
    from ..options import MEM_F_PE, MemOptions
    from ..runtime import run_pipeline
    from .host_ceiling import sync
    fm = FMIndex.load(prefix)
    opt = MemOptions().finalize(None)
    if len(fqs) > 1:
        opt.flag |= MEM_F_PE
    devs_all = resolve_devices(device)
    report, sam0 = {}, None
    for n in ns:
        if n > len(devs_all):
            raise ValueError(f"N={n}: {len(devs_all)} devices visible")
        devs = devs_all[:n]
        aligners = [Aligner(fm, opt, backend=TorchBackend(fm, opt,
                                                          device=d),
                            verbose=0) for d in devs]
        # on a card a first pass builds and uploads; the CPU has neither
        for _ in range(2 if device == "cuda" else 1):
            out = io.StringIO()
            t0 = time.perf_counter()
            run_pipeline(aligners, FastxReader(fqs[0]),
                         FastxReader(fqs[1]) if len(fqs) > 1 else None,
                         chunk, out, verbose=0, n_workers=max(n, 2))
            for d in set(devs):
                sync(d)
            wall = time.perf_counter() - t0
        sam = out.getvalue()
        sam0 = sam if sam0 is None else sam0
        if sam != sam0:
            raise RuntimeError(f"N={n}: SAM differs from N={ns[0]}")
        report[n] = dict(wall_s=round(wall, 4), output_identical=True,
                         devices=[str(d) for d in devs],
                         launches_per_backend=[dict(a.backend.launches)
                                               for a in aligners])
        log(f"[scaling-rr] N={n}: wall {wall:.2f}s, identical")
    base = report[ns[0]]["wall_s"]
    for n in ns:
        report[n]["overhead_vs_1dev"] = round(report[n]["wall_s"] / base, 4)
        report[n]["speedup_vs_1"] = round(base / report[n]["wall_s"], 4)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["shard", "roundrobin"],
                    default="shard")
    ap.add_argument("--ns", default="1,2,4")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--pairs", type=int, default=10_000)
    ap.add_argument("--index", default=None)
    ap.add_argument("--fq1", default=None)
    ap.add_argument("--fq2", default=None)
    ap.add_argument("--chunk", type=int, default=750_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from .. import benchdata
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
    ns = [int(x) for x in a.ns.split(",")]
    if a.mode == "shard":
        rep = shard_mode(prefix, fqs, ns, a.chunk, dev.type, log)
    else:
        rep = roundrobin_mode(prefix, fqs, ns, a.chunk, dev.type, log)
    print(json.dumps(dict(mode=a.mode, card=card(dev), chunk=a.chunk,
                          **{str(n): r for n, r in rep.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
