"""The traffic: read pairs made on demand from `--seed`, with their true
origin.

One general generator reads a traffic mix (`traffic/<mix>.json`):

- `read_length`: bases read from each end of a fragment (FR pairs: the
  second mate is reverse-complemented);
- `fragment`: its length, {"dist": "normal", "mean", "std", "min"}
  (redrawn below `min`);
- `reverse_share`: the share of fragments taken from the reverse strand;
- `per_base`: {"sub"}: per base, the chance it is replaced by another;
- `per_read_indel`: the share of reads with one indel that keeps the
  length (a base dropped and a random one appended, or a random base
  inserted and the last dropped), 10 bases or more from either end;
- `quality`: {"const": Q} (Phred).

This is the model of `bwamem2_tpu_torch/benchdata.py:sample_reads_pe`,
vectorised and streamed: no FASTQ is written.  Origins are uniform over
the genome's N-free stretches (`genome.clean_segments`), so every read
lies on real sequence.

`ReadStream` hands the reads to `runtime.run_pipeline` through `mates()`,
two objects with the `read_one` / `close` of the program's FastxReader.
It mirrors the program's chunking rule (`io/fastq.py:read_chunk`: a chunk
closes once it holds `task_size` bases and an even number of reads) to
record where each chunk ends, and once `stop` is set it ends the input at
the next chunk boundary, so no chunk is cut short.
"""

from __future__ import annotations

import threading

import numpy as np

from portbench.genome import clean_segments

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
BLOCK_PAIRS = 2048        # fragments made at a time
MARGIN = 1000             # bases kept clear of every N run


def seed_words(seed: int) -> list[int]:
    """--seed as 32-bit words for NumPy's seeding (its low 64 bits, so a
    negative seed is taken too)."""
    s = int(seed)
    return [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF]


def draw_lengths(rng, dist: dict, n: int) -> np.ndarray:
    if dist["dist"] != "normal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    x = np.rint(rng.normal(dist["mean"], dist["std"], n)).astype(np.int64)
    lo = int(dist["min"])
    bad = x < lo
    while bad.any():           # redraw, as benchdata does
        x[bad] = np.rint(rng.normal(dist["mean"], dist["std"],
                                    int(bad.sum()))).astype(np.int64)
        bad = x < lo
    return x


def rc_codes(c: np.ndarray) -> np.ndarray:
    return (3 - c[..., ::-1]).astype(np.uint8)


def subs_2d(rng, r: np.ndarray, p_sub: float) -> None:
    hit = rng.random(r.shape) < p_sub
    r[hit] = (r[hit] + rng.integers(1, 4, int(hit.sum()))) % 4


def read_indel_2d(rng, r: np.ndarray, share: float) -> None:
    """One length-keeping indel in `share` of the rows of r (in place)."""
    n, L = r.shape
    rows = np.flatnonzero(rng.random(n) < share)
    if not len(rows):
        return
    q = rng.integers(10, L - 10, len(rows))
    dele = rng.random(len(rows)) < 0.5
    new = rng.integers(0, 4, len(rows), dtype=np.uint8)
    j = np.arange(L)[None, :]
    qq = q[:, None]
    src = np.where(dele[:, None], np.where(j < qq, j, j + 1),
                   np.where(j <= qq, j, j - 1))
    old = r[rows]
    out = np.take_along_axis(old, np.minimum(src, L - 1), 1)
    fill = np.where(dele[:, None], j == L - 1, j == qq)
    out[fill] = new
    r[rows] = out


class ReadStream:
    """Read pairs of one traffic mix from one seed, made a block at a time
    on the thread that asks for them (the pipeline's reader); read i is
    mate i % 2 of fragment i // 2, which is its name."""

    def __init__(self, codes: np.ndarray, traffic: dict, seed: int,
                 task_size: int, make_read):
        self.codes = codes
        self.t = traffic
        self.rng = np.random.default_rng(np.random.SeedSequence(
            seed_words(seed) + [0x70627e]))
        self.task_size = task_size
        self.make_read = make_read          # (name, seq, qual) -> a Read
        self.seg = clean_segments(codes, MARGIN)
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.pending: list = []              # Reads made, not handed out
        self.n_frag = 0
        # truth, one entry per read in stream order
        self.t_start: list = []              # source span start (forward)
        self.t_rev: list = []                # 1: the read is the span's rc
        self.t_seq: list = []                # the read's codes
        # chunk accounting (io/fastq.py:read_chunk)
        self.n_out = 0
        self.chunk_ends: list[int] = []      # reads handed out at each end
        self._size = 0
        self._count = 0

    def _origins(self, span: np.ndarray) -> np.ndarray:
        lens = self.seg[:, 1] - self.seg[:, 0]
        w = lens / lens.sum()
        k = self.rng.choice(len(self.seg), len(span), p=w)
        room = np.maximum(lens[k] - span, 1)
        return self.seg[k, 0] + (self.rng.random(len(span)) * room
                                 ).astype(np.int64)

    def _block(self) -> None:
        t, rng = self.t, self.rng
        B = BLOCK_PAIRS
        L = int(t["read_length"])
        frag = draw_lengths(rng, t["fragment"], B)
        p = self._origins(frag)
        rev = rng.random(B) < t.get("reverse_share", 0.5)
        idx = np.arange(L)[None, :]
        left = self.codes[p[:, None] + idx]
        right = self.codes[(p + frag - L)[:, None] + idx]
        # forward fragment: r1 = left, r2 = rc(right); reverse: swapped
        r1 = np.where(rev[:, None], rc_codes(right), left)
        r2 = np.where(rev[:, None], left, rc_codes(right))
        reads = np.empty((2 * B, L), np.uint8)
        reads[0::2], reads[1::2] = r1, r2
        subs_2d(rng, reads, t.get("per_base", {}).get("sub", 0.0))
        read_indel_2d(rng, reads, t.get("per_read_indel", 0.0))
        starts = np.empty(2 * B, np.int64)
        starts[0::2] = np.where(rev, p + frag - L, p)
        starts[1::2] = np.where(rev, p, p + frag - L)
        rcs = np.empty(2 * B, bool)
        rcs[0::2], rcs[1::2] = rev, ~rev
        qual = chr(33 + int(t["quality"]["const"])) * L
        for i in range(2 * B):
            self.pending.append(self.make_read(
                str(self.n_frag + i // 2), ACGT[reads[i]].tobytes().decode(),
                qual))
        self.n_frag += B
        self.pending.reverse()              # pop() from the end, in order
        self.t_start.append(starts)
        self.t_rev.append(rcs)
        self.t_seq.extend(reads)

    # ---- the two mate files ----
    def _next(self, mate: int):
        with self.lock:
            if mate == 0 and self._count == 0 and self.stop.is_set():
                return None
            if not self.pending:
                self._block()
            r = self.pending.pop()
            self.n_out += 1
            self._count += 1
            self._size += len(r.seq)
            if mate == 1 and self._size >= self.task_size \
                    and self._count % 2 == 0:
                self.chunk_ends.append(self.n_out)
                self._size = self._count = 0
            return r

    @staticmethod
    def name_of(i: int) -> str:
        """The name of the i-th read handed out."""
        return str(i // 2)

    def mates(self):
        """(ks1, ks2) for run_pipeline."""
        s = self

        class Mate:
            def __init__(self, k):
                self.k = k

            def read_one(self):
                return s._next(self.k)

            def close(self):
                pass

        return Mate(0), Mate(1)

    def truth(self) -> dict:
        """Every read made so far, in stream order; "span" is each read's
        source span, `read_length` bases."""
        start = np.concatenate(self.t_start)
        return {"start": start,
                "span": np.full(len(start), int(self.t["read_length"])),
                "rev": np.concatenate(self.t_rev),
                "seq": self.t_seq}
