"""The measured window and its arithmetic.

`SamSink` is the `out` that `runtime.run_pipeline` writes to: it writes
every read's SAM text to the real file and sees each chunk complete (its
last read written, by the stream's record of where chunks end).  The
window opens when chunk `open_after` completes, with every worker busy,
and closes at the first chunk completion at least `seconds` later; then
it stops the stream, which ends the input at the next chunk boundary.  So
the window holds whole chunks only, and its rate is all their reads over
all its time.

Snapshots at both edges (reads written, `PROF` phase seconds, the
process's CPU seconds) give the per-layer deltas; `on_edge` lets the
tracer mark the edges on the device.
"""

from __future__ import annotations

import time


def rate(reads: int, t_open: float, t_close: float) -> float:
    """Reads of whole chunks over the window's whole time."""
    if t_close <= t_open:
        raise ValueError("the window has no length")
    return reads / (t_close - t_open)


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    iv = sorted((max(s, lo), min(e, hi)) for s, e in intervals
                if e > lo and s < hi)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(named, lo: float, hi: float) -> list[tuple[str, float]]:
    """The gaps of [lo, hi) where no interval runs, each named by the
    operations that end before it and start after it; longest first.
    named: (name, start, end)."""
    iv = sorted((max(s, lo), min(e, hi), n) for n, s, e in named
                if e > lo and s < hi)
    gaps, last_end, last_name = [], lo, "window open"
    for s, e, n in iv:
        if s > last_end:
            gaps.append((f"{last_name} -> {n}", s - last_end))
        if e > last_end:
            last_end, last_name = e, n
    if hi > last_end:
        gaps.append((f"{last_name} -> window close", hi - last_end))
    return sorted(gaps, key=lambda g: -g[1])


def per_kread(value: float, reads: int) -> float | None:
    return value / (reads / 1000.0) if reads > 0 else None


def prof_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0.0) for k in after
            if after[k] - before.get(k, 0.0) > 0.0}


class SamSink:
    def __init__(self, f, stream, open_after: int, seconds: float,
                 prof, keep=None, on_edge=None):
        self.f = f
        self.stream = stream
        self.open_after = open_after
        self.seconds = seconds
        self.prof = prof
        self.keep = keep or (lambda i: False)
        self.on_edge = on_edge or (lambda which: None)
        self.written = 0
        self.k = 0                      # the next chunk to complete
        self.kept: dict[int, str] = {}  # read index -> its SAM text
        self.bad_in_window = 0
        self.open = self.close = None   # edge snapshots

    def _snap(self) -> dict:
        return {"t": time.perf_counter(), "reads": self.written,
                "chunk": self.k, "cpu": time.process_time(),
                "prof": dict(self.prof.t)}

    def write(self, s: str) -> None:
        i = self.written
        self.f.write(s)
        self.written += 1
        if self.keep(i):
            self.kept[i] = s
        if self.open is not None and self.close is None:
            name = self.stream.name_of(i)
            if not s or not s.startswith(name + "\t"):
                self.bad_in_window += 1
        ends = self.stream.chunk_ends
        if self.k < len(ends) and self.written == ends[self.k]:
            t = time.perf_counter()
            if self.open is None and self.k == self.open_after:
                self.open = self._snap()
                self.on_edge("open")
            elif (self.open is not None and self.close is None
                  and t - self.open["t"] >= self.seconds):
                self.close = self._snap()
                self.on_edge("close")
                self.stream.stop.set()
            self.k += 1
