"""Runtime profiling: named phase timers + an exit summary table.

The analog of the reference's rdtsc slot table (tprof[128][128],
macro.h:68-172) and display_stats() (profiling.cpp:54-239): wall-clock per
pipeline phase, accumulated across chunks, printed as a hierarchical summary
at the end of a run.  Device-side kernel times come from CUDA events in
chip_smoke.py, not from this table.

The trace hook (the JAX package's BWAMEM2_TPU_TRACE): with
BWAMEM2_TPU_TRACE=<dir> set when `start_trace` is called, the calls
between it and `stop_trace` run under torch.profiler (CPU activity, plus
CUDA activity when the process has initialized a card), and `stop_trace`
writes a Chrome trace, <dir>/trace_<pid>_<n>.json: every PyTorch op and,
on a card, every kernel with its device timestamps (the hand-written
kernels launched through ctypes included; CUPTI records them by their
__global__ names).  `mem` (cli.py) traces its pipeline so.  Unset, both
calls do nothing.
"""

from __future__ import annotations

import os
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
        self._trace = None          # (profiler, directory, start time)
        self._n_traces = 0
        self.trace_path: str | None = None     # the last trace written
        self.trace_s: dict = {}     # its host seconds (stop_trace)

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

    def start_trace(self) -> None:
        """Start a torch.profiler trace if BWAMEM2_TPU_TRACE names a
        directory (read now, not at import) and none is running: CPU
        activity, and CUDA activity when the process has initialized a
        card."""
        trace_dir = os.environ.get("BWAMEM2_TPU_TRACE")
        if not trace_dir or self._trace is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        try:    # the pipeline's ops run on its worker threads
            from torch._C._profiler import _ExperimentalConfig
            cfg = {"experimental_config":
                   _ExperimentalConfig(profile_all_threads=True)}
        except (ImportError, TypeError):   # a torch without the option:
            cfg = {}     # the starting thread's ops, and every kernel
        t0 = time.perf_counter()
        prof = profile(activities=acts, **cfg)
        prof.__enter__()
        t1 = time.perf_counter()
        self._trace = (prof, trace_dir, t1)
        self.trace_s = {"start": t1 - t0}

    def stop_trace(self) -> str | None:
        """Stop the running trace and write it as a Chrome trace under the
        directory; returns its path (also `trace_path`), or None when
        nothing was traced.  `trace_s` holds the host seconds of the
        profiler's start, of the traced calls ("traced", to the cards'
        last kernel) and of its stop with the export."""
        if self._trace is None:
            return None
        prof, trace_dir, t0 = self._trace
        self._trace = None
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        t1 = time.perf_counter()
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        self._n_traces += 1
        path = os.path.join(trace_dir,
                            f"trace_{os.getpid()}_{self._n_traces}.json")
        prof.export_chrome_trace(path)
        self.trace_s.update(traced=t1 - t0, stop=time.perf_counter() - t1)
        self.trace_path = path
        return path

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
