"""Multi-host scale-out: deterministic sharded runs and the chunk-ordered
merge (a copy of bwamem2_tpu/parallel/multihost.py, with the process group
brought up by torch.distributed).

With N shards, shard h aligns exactly the chunks c with c % N == h (chunk
boundaries depend only on the task size, never on N), so the shards'
outputs concatenated in chunk order are byte-identical to a single run.
Insert-size estimation stays per chunk, so PE output is also invariant to
sharding.  Each process aligns its chunks on its own card; nothing crosses
processes on the critical path.
"""

from __future__ import annotations

import os
import re
import sys

from ..io.fastq import FastxReader, read_chunk
from ..utils.profiling import PROF

CHUNK_RE = re.compile(r"\.chunk(\d+)\.sam$")
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def run_sharded(aligner, ks1: FastxReader, ks2: FastxReader | None,
                task_size: int, out_dir: str, shard: int, n_shards: int,
                pes0=None, copy_comment=False, verbose: int = 3) -> int:
    """Align chunks c = shard (mod n_shards); write out_dir/part.chunk{c}.sam."""
    os.makedirs(out_dir, exist_ok=True)
    c = 0
    n_processed = 0
    n_mine = 0
    while True:
        reads = read_chunk(ks1, ks2, task_size)
        if not reads:
            break
        if c % n_shards == shard:
            if not copy_comment:
                for r in reads:
                    r.comment = None
            aligner.process(reads, n_processed, pes0=pes0)
            path = os.path.join(out_dir, f"part.chunk{c:08d}.sam")
            with open(path, "w") as f:
                for r in reads:
                    f.write(r.sam)
                    r.sam = None
            n_mine += len(reads)
            if verbose >= 3:
                sys.stderr.write(f"[shard {shard}/{n_shards}] chunk {c}: "
                                 f"{len(reads)} reads\n")
        n_processed += len(reads)
        c += 1
    if verbose >= 3:
        PROF.report(total_reads=n_mine)
    return n_mine


def merge_chunks(out, paths: list[str], header: str | None = None) -> int:
    """Concatenate chunk files in chunk-index order (deterministic merge)."""
    tagged = []
    for p in paths:
        m = CHUNK_RE.search(p)
        if not m:
            raise ValueError(f"not a chunk file: {p}")
        tagged.append((int(m.group(1)), p))
    tagged.sort()
    if header:
        out.write(header)
    n = 0
    for _, p in tagged:
        with open(p) as f:
            for line in f:
                out.write(line)
                n += 1
    return n


def init_distributed(device=None) -> tuple[int, int]:
    """Bring up the torch.distributed process group from the standard
    env:// variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, set on
    every process); returns (rank, world_size), and (0, 1), one process,
    when they are absent.  It runs on a card unless the caller asks for
    "cpu": the backend is nccl on card `device` (for "cuda" without an
    index, card LOCAL_RANK, else RANK, modulo the visible cards), which
    becomes this process's current card, and gloo for "cpu".  Without a
    card and without "cpu" it raises, as every entry point does."""
    import torch
    import torch.distributed as dist

    from ..ops import resolve_device
    dev = resolve_device(device)        # raises without a card
    if not all(v in os.environ for v in ENV_VARS):
        return 0, 1
    if not dist.is_initialized():
        if dev.type == "cuda":
            if device is None or torch.device(device).index is None:
                rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dist.get_rank(), dist.get_world_size()
