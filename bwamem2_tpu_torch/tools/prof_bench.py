"""One profiled `mem` PE pass: the PROF phase table and counters (the port
of tools/prof_bench.py).

    python -m bwamem2_tpu_torch.tools.prof_bench [--scale 1.0]
        [--pairs 10000] [--task-bases 750000] [--workers 4] [--passes 1]
        [--device cuda]
    python -m bwamem2_tpu_torch.tools.prof_bench --index PREFIX
        --fq1 R1.fq [--fq2 R2.fq] ...

Data: benchdata.ensure(.tmp/bench_scale<scale>, scale, pairs), or the
files given (--fq2 left out: SE).  A warm pass (kernel builds,
index upload), then PROF's tables are reset and --passes timed passes run
through runtime.run_pipeline with --workers workers, one TorchBackend on
--device; each prints its reads, wall and process CPU seconds on stderr,
then PROF.report prints the phase table and counters there.  With
BWAMEM2_TPU_TRACE=<dir> set the timed passes are traced
(utils/profiling.py).
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--pairs", type=int, default=10_000)
    ap.add_argument("--index", default=None)
    ap.add_argument("--fq1", default=None)
    ap.add_argument("--fq2", default=None)
    ap.add_argument("--task-bases", type=int, default=750_000)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    from .. import benchdata
    from ..align.pipeline import Aligner
    from ..index.fmindex import FMIndex
    from ..io.fastq import FastxReader
    from ..ops import resolve_device
    from ..ops.backend import TorchBackend
    from ..options import MEM_F_PE, MemOptions
    from ..runtime import run_pipeline
    from ..utils.profiling import PROF
    from .kernel_micro import card

    dev = resolve_device(a.device)        # cuda without a card raises
    if a.index:
        prefix, fq1, fq2 = a.index, a.fq1, a.fq2
    else:
        prefix, fq1, fq2 = benchdata.ensure(
            os.path.join(REPO, ".tmp", f"bench_scale{a.scale}"), a.scale,
            a.pairs)
    fm = FMIndex.load(prefix)
    opt = MemOptions().finalize(None)
    if fq2:
        opt.flag |= MEM_F_PE
    al = Aligner(fm, opt, backend=TorchBackend(fm, opt, device=dev),
                 verbose=0)
    print(f"[prof_bench] {card(dev)}", file=sys.stderr)

    def one_pass():
        t0 = time.perf_counter()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        with open(os.devnull, "w") as out:
            n = run_pipeline(al, FastxReader(fq1),
                             FastxReader(fq2) if fq2 else None,
                             a.task_bases, out, verbose=0,
                             n_workers=a.workers)
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
        return n, time.perf_counter() - t0, cpu

    n, w, c = one_pass()
    print(f"[warm] {n} reads {w:.2f}s wall {c:.2f}s cpu", file=sys.stderr)
    for d in (PROF.t, PROF.n, PROF.c, PROF.ctot):
        d.clear()
    PROF.start_trace()
    try:
        for _ in range(a.passes):
            n, w, c = one_pass()
            print(f"[timed] {n} reads {w:.2f}s wall {c:.2f}s cpu "
                  f"({n / w:.0f} reads/s)", file=sys.stderr)
    finally:
        path = PROF.stop_trace()
    if path:
        print(f"[prof_bench] trace {path}", file=sys.stderr)
    PROF.report(out=sys.stderr, total_reads=n * a.passes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
