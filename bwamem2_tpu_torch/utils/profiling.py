"""Runtime profiling: named phase timers + an exit summary table.

The analog of the reference's rdtsc slot table (tprof[128][128],
macro.h:68-172) and display_stats() (profiling.cpp:54-239): wall-clock per
pipeline phase, accumulated across chunks, printed as a hierarchical summary
at the end of a run.  Device-side kernel times come from CUDA events in
chip_smoke.py, not from this table.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from contextlib import contextmanager


class Prof:
    def __init__(self):
        self.t = defaultdict(float)
        self.n = defaultdict(int)
        self.c = defaultdict(int)
        self.ctot = defaultdict(int)
        self.enabled = True

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.t[name] += time.perf_counter() - t0
            self.n[name] += 1

    def add(self, name: str, dt: float) -> None:
        self.t[name] += dt
        self.n[name] += 1

    def count(self, name: str, n: int = 1, total: int = 0) -> None:
        """Event counters (capacity overflows, fallback takes...): printed
        as counts + rate, the macro.h:45-52 sizing-evidence analog."""
        self.c[name] += n
        self.ctot[name] += total

    def report(self, out=sys.stderr, total_reads: int | None = None) -> None:
        if not self.t:
            return
        out.write("\n[prof] phase timing summary\n")
        order = ["read_input", "seeding.round1", "seeding.round2",
                 "seeding.round3", "seeding.sort", "sa_lookup", "chaining",
                 "chain_filter", "extension.gather", "extension.bsw",
                 "extension.post", "dedup_patch", "pestat", "pairing",
                 "matesw", "finalize.sam", "write_output"]
        shown = set()
        width = max(len(k) for k in self.t)
        for k in order:
            if k in self.t:
                out.write(f"[prof]   {k:<{width}}  {self.t[k]:9.3f}s"
                          f"  x{self.n[k]}\n")
                shown.add(k)
        for k in sorted(self.t):
            if k not in shown:
                out.write(f"[prof]   {k:<{width}}  {self.t[k]:9.3f}s"
                          f"  x{self.n[k]}\n")
        total = sum(self.t.values())
        out.write(f"[prof]   {'(sum of phases)':<{width}}  {total:9.3f}s\n")
        for k in sorted(self.c):
            tot = self.ctot[k]
            rate = f" ({100.0 * self.c[k] / tot:.2f}% of {tot})" if tot \
                else ""
            out.write(f"[prof]   {k:<{width}}  {self.c[k]:9d}{rate}\n")
        if total_reads:
            out.write(f"[prof]   reads: {total_reads}  "
                      f"({total_reads / max(total, 1e-9):.0f} reads/s over "
                      f"summed phases)\n")


PROF = Prof()
