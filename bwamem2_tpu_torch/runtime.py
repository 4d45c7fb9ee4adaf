"""Host runtime: ordered read->compute->write pipeline.

Replicates the 3-step kt_pipeline of the reference driver (fastmap.cpp:
189-366): chunks of ~chunk_size bases stream through {read, align, write}
with the write order equal to the read order, and the next chunk's input
I/O overlapped with the current chunk's compute (double buffering).
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time

from .io.fastq import FastxReader, read_chunk
from .utils.profiling import PROF


class ChunkJournal:
    """Chunk-granular resume journal for plain (unsharded) runs.

    A sidecar `<out>.resume` records one line per COMPLETED chunk —
    "idx n_reads end_offset" — appended and flushed only after that
    chunk's records are flushed to the output file, so the journal never
    claims bytes that didn't reach the OS.  On restart, the output file is
    truncated to the last journaled offset (dropping any partial chunk)
    and the journaled chunks are skipped.  Chunk boundaries are a pure
    function of the input stream and task_size, so the restarted run's
    remaining chunks are identical to the uninterrupted run's."""

    def __init__(self, path: str):
        self.path = path
        self.n_done = 0
        self.n_reads = 0
        self.end_offset = None   # None until the header offset is known
        if os.path.exists(path):
            good = []
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 3 or not all(
                            x.isdigit() for x in parts):
                        break   # torn write: ignore the tail
                    idx, nr, off = (int(x) for x in parts)
                    if idx != self.n_done:
                        break
                    self.n_done += 1
                    self.n_reads += nr
                    self.end_offset = off
                    good.append(line)
            with open(path, "w") as f:   # drop any torn tail
                f.writelines(good)
        self._f = None

    def truncate_output(self, out_path: str, header_end: int) -> None:
        """Drop any partial chunk past the last journaled offset.  With no
        journaled chunks the file is cut back to the header (which the
        caller just rewrote identically)."""
        end = self.end_offset if self.end_offset is not None else header_end
        with open(out_path, "r+b") as f:
            f.truncate(end)

    def mark_done(self, idx: int, n_reads: int, out) -> None:
        out.flush()
        if self._f is None:
            self._f = open(self.path, "a")
        self._f.write(f"{idx} {n_reads} {out.tell()}\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None



def run_pipeline(aligner, ks1: FastxReader, ks2: FastxReader | None,
                 task_size: int, out, pes0=None, copy_comment=False,
                 pipeline_depth: int = 2, verbose: int = 3,
                 n_workers: int = 2, resume=None) -> int:
    """Stream chunks through the aligner; returns total reads processed.

    `n_workers` compute threads each process whole chunks: while one blocks
    on the device (GIL released), the other runs the host-side python
    (chaining / SAM finalization) — the TPU analog of the reference's
    2-thread kt_pipeline overlap.  Chunk boundaries and per-chunk state
    (pestat, n_processed bases) are fixed by the single reader, and the
    writer emits strictly in chunk order, so output is bit-identical for
    any worker count.

    `aligner` may be a LIST of aligners (one per chip, each with a
    device-pinned backend): each chunk runs on the LEAST-LOADED chip at
    the moment a worker picks it up (ties break to the lowest device
    index, so a single-chunk run is reproducible) — data parallelism over
    chips with a replicated index and zero collectives, the scale-out
    shape of SURVEY §5.8.  Dynamic assignment is the kthread
    work-stealing analog (kthread.cpp:41-50): a pathological chunk (e.g.
    an ultra-long-read batch) occupies one chip while every other chunk
    drains over the remaining chips, instead of stalling a static
    round-robin slot.  Results are device-invariant, and the writer
    sequences output by chunk index, so the schedule never affects
    output bytes.

    `resume`: optional ChunkJournal — chunks it already holds are read
    from the input (to keep chunk boundaries, read-id bases, and per-chunk
    insert-size estimation identical) but not re-aligned; each completed
    chunk is journaled after its ordered write, so a killed run restarted
    with the same arguments produces a byte-identical output file
    (SURVEY §5.4's chunk-granular restart; the reference has none)."""
    aligners = aligner if isinstance(aligner, (list, tuple)) else [aligner]
    q_in: queue.Queue = queue.Queue(maxsize=max(pipeline_depth, n_workers))
    done = object()
    skip = resume.n_done if resume is not None else 0
    nw = max(n_workers, 1)
    results: dict[int, list] = {}
    res_lock = threading.Condition()
    n_done_workers = [0]
    worker_err: list = []
    # set once the run fails: the reader stops putting chunks (nothing may
    # take them any more) and closes its inputs
    cancel = threading.Event()

    def put(item) -> bool:
        """q_in.put unless the run is cancelled first; False if it was."""
        while not cancel.is_set():
            try:
                q_in.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def reader():
        n = 0
        idx = 0
        try:
            while True:
                reads = read_chunk(ks1, ks2, task_size)
                if not reads:
                    break
                if idx < skip:   # journaled chunk: advance the stream only
                    idx += 1
                    n += len(reads)
                    continue
                if not copy_comment:
                    for r in reads:
                        r.comment = None
                if not put((idx, n, reads)):
                    break
                idx += 1
                n += len(reads)
        except BaseException as e:   # propagate instead of hanging the run
            with res_lock:
                worker_err.append(e)
                res_lock.notify_all()
        finally:
            for _ in range(nw):
                if not put(done):
                    break
            if cancel.is_set():
                for ks in (ks1, ks2):
                    if ks is not None:
                        ks.close()

    # Serialize each aligner's FIRST-EVER chunk: concurrent first-use
    # compiles from several worker threads (multiple device-pinned
    # executable variants compiling + persistent-cache writes in parallel)
    # segfault inside XLA/the jax compilation cache (observed on the
    # 8-device virtual mesh).  Once an aligner is warm — across pipeline
    # invocations — workers run fully concurrent; ordering/determinism are
    # unaffected (the writer already sequences output by chunk index).
    warm_lock = threading.Lock()

    # per-aligner in-flight chunk counts for least-loaded dispatch
    load_lock = threading.Lock()
    inflight = [0] * len(aligners)

    def worker():
        while True:
            item = q_in.get()
            if item is done:
                with res_lock:
                    n_done_workers[0] += 1
                    res_lock.notify_all()
                return
            idx, base, reads = item
            t0 = time.time()
            with load_lock:
                ai = min(range(len(aligners)), key=lambda j: inflight[j])
                inflight[ai] += 1
            try:
                al = aligners[ai]
                if not getattr(al, "_pipeline_warm", False):
                    with warm_lock:
                        al.process(reads, base, pes0=pes0)
                        al._pipeline_warm = True
                else:
                    al.process(reads, base, pes0=pes0)
            except BaseException as e:  # propagate to the writer thread
                with res_lock:
                    worker_err.append(e)
                    n_done_workers[0] += 1
                    res_lock.notify_all()
                return
            finally:
                with load_lock:
                    inflight[ai] -= 1
            with res_lock:
                results[idx] = (reads, time.time() - t0)
                res_lock.notify_all()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    workers = [threading.Thread(target=worker, daemon=True)
               for _ in range(nw)]
    for w in workers:
        w.start()

    n_processed = resume.n_reads if resume is not None else 0
    next_idx = skip
    while True:
        with res_lock:
            while (next_idx not in results and n_done_workers[0] < nw
                   and not worker_err):
                res_lock.wait()
            if worker_err:
                cancel.set()
                t.join(timeout=5)
                raise worker_err[0]
            if next_idx not in results:
                break  # all workers done and nothing pending
            reads, dt = results.pop(next_idx)
        next_idx += 1
        n_processed += len(reads)
        with PROF("write_output"):
            for r in reads:
                out.write(r.sam)
                r.sam = None
            if resume is not None:
                resume.mark_done(next_idx - 1, len(reads), out)
        if verbose >= 3:
            sys.stderr.write(
                f"[M::pipeline] processed {len(reads)} reads in "
                f"{dt:.3f} sec (total {n_processed})\n")
    t.join()
    for w in workers:
        w.join()
    if verbose >= 3:
        PROF.report(total_reads=n_processed)
    return n_processed
