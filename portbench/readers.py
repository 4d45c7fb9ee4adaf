"""What the metric readers (`metrics/<name>.py`) share.

A reader is `read(w) -> float | None`; `w` is the run's window record
(`bench.Window`).  None means the reader found nothing to read in this
run, and the metric is left out of the result line.
"""

from __future__ import annotations

import re

from portbench.window import per_kread, union_seconds


def prof_ms_per_kread(w, phases: tuple[str, ...]) -> float | None:
    """Milliseconds of the named PROF phases over the window (worker
    seconds: summed over the pipeline's threads), per 1,000 reads."""
    if not any(p in w.prof for p in phases):
        return None
    return per_kread(1e3 * sum(w.prof.get(p, 0.0) for p in phases), w.reads)


def kernel_ms_per_kread(w, patterns: tuple[str, ...]) -> float | None:
    """Milliseconds of device kernels whose names match any pattern (the
    union of their intervals in the window), per 1,000 reads."""
    if w.device_ops is None:
        return None
    rx = re.compile("|".join(patterns))
    iv = [(s, e) for n, s, e in w.device_ops if rx.search(n)]
    if not iv:
        return None
    return per_kread(1e3 * union_seconds(iv, w.dev_lo, w.dev_hi), w.reads)
