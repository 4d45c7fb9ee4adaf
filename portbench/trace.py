"""The traced run's device record: CUDA activity only, from the
benchmark's own torch.profiler (no host ops, no program hook).

The profiler starts in set-up, before the pipeline, and stops after it has
drained.  The window's edges are marked on the device: at each edge the
writer thread launches one `torch.cuda._sleep` (a spin kernel, which the
program never launches) on a stream of its own, so the window on the
device's clock runs from the first marker's start to the second's.  What
ran on the device (kernels, copies, sets) is read from the exported
Chrome trace, clipped to that window.
"""

from __future__ import annotations

import json
import os
import tempfile

MARK = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.ops = None          # [(name, start_s, end_s)], device clock
        self.lo = self.hi = None

    def mark(self, which: str) -> None:
        with self.torch.cuda.stream(self.stream):
            self.torch.cuda._sleep(1000)

    def stop(self) -> None:
        """Stop the profiler, read its trace, keep the window's records."""
        self.torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        ops, marks = [], []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            s = float(e["ts"]) * 1e-6
            rec = (e.get("name", "?"), s, s + float(e.get("dur", 0)) * 1e-6)
            (marks if MARK in rec[0] else ops).append(rec)
        marks.sort(key=lambda r: r[1])
        if len(marks) >= 2:
            self.lo, self.hi = marks[0][1], marks[-1][1]
        self.ops = ops

    def window_ops(self) -> list:
        """The device operations inside the window, clipped to it."""
        if self.lo is None:
            return []
        return [(n, max(s, self.lo), min(e, self.hi)) for n, s, e in self.ops
                if e > self.lo and s < self.hi]
