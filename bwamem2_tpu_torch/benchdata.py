"""Deterministic synthetic dataset for runs on the card (chip_smoke.py).

The port's own copy of the generator logic of tools/make_bench_data.py:
one contig of random core sequence with interspersed repeat families (a
300 bp ALU-like family, 1 copy per 3 kb, and a 6 kb LINE-like family, 1
per 150 kb, each copy at 2% divergence) and telomeric/centromeric N runs,
indexed with the port's index builder, plus 2x150 bp FR pairs (insert 420
+- 60, 0.5% substitutions, one indel in 5% of reads).  scale 1.0 is the
46.7 Mbp chr21 class; scale 0.25 is 11.7 Mbp, the size of a yeast genome.
`sample_reads_long` samples pacbio/ont-like long reads (2-8 kb, ~10 %
error) from the built genome, the generator of the repository's long-read
fixture (tests/make_fixtures.py, reads_pacbio.fq).  `rescue_windows` and
`rescue_batch` make random mate-rescue problems on a genome, for holding
the rescue kernel against its plain version and the native ksw_align.

Everything is made from fixed seeds and cached by existence under `dir`.
"""

from __future__ import annotations

import os
import sys

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
GENOME_LEN = 46_700_000
READ_LEN = 150
INSERT_MEAN, INSERT_STD = 420.0, 60.0


def make_genome(path: str, scale: float, seed: int = 2024) -> None:
    """One contig; random core + repeat families + N runs."""
    rng = np.random.default_rng(seed)
    n = int(GENOME_LEN * scale)
    g = BASES[rng.integers(0, 4, n)]
    # ALU-like family: 300bp consensus, ~n/3000 copies (1 per 3kb)
    alu = BASES[rng.integers(0, 4, 300)]
    for _ in range(n // 3000):
        p = int(rng.integers(0, n - 300))
        cp = alu.copy()
        div = rng.random(300) < 0.02
        cp[div] = BASES[rng.integers(0, 4, int(div.sum()))]
        g[p:p + 300] = cp
    # LINE-like family: 6kb consensus, 1 per 150kb
    line = BASES[rng.integers(0, 4, 6000)]
    for _ in range(n // 150_000):
        p = int(rng.integers(0, n - 6000))
        cp = line.copy()
        div = rng.random(6000) < 0.02
        cp[div] = BASES[rng.integers(0, 4, int(div.sum()))]
        g[p:p + 6000] = cp
    # telomere/centromere N runs
    g[:10_000] = ord("N")
    g[-10_000:] = ord("N")
    mid = n // 2
    g[mid:mid + 50_000] = ord("N")
    with open(path, "w") as f:
        f.write(">chr21s synthetic chr21-scale\n")
        s = g.tobytes().decode()
        for i in range(0, n, 80):
            f.write(s[i:i + 80])
            f.write("\n")


def sample_reads_pe(prefix: str, fq1: str, fq2: str, n_pairs: int,
                    seed: int = 7) -> None:
    """Sample proper FR pairs from the built index's packed genome."""
    from .index.fmindex import FMIndex
    fm = FMIndex.load(prefix)
    g = fm.ref_string  # 2-bit codes, forward strand first, len >= l_pac
    rng = np.random.default_rng(seed)
    B = "ACGT"
    rc = {"A": "T", "C": "G", "G": "C", "T": "A"}
    lines1, lines2 = [], []
    npairs = 0
    while npairs < n_pairs:
        isize = int(rng.normal(INSERT_MEAN, INSERT_STD))
        if isize < READ_LEN + 10:
            continue
        p = int(rng.integers(0, fm.l_pac - isize))
        frag = g[p:p + isize]
        r1 = frag[:READ_LEN].copy()
        r2 = frag[-READ_LEN:][::-1].copy()  # reverse; complement via code
        seqs = []
        for ri, r in enumerate((r1, r2)):
            # 0.5% subs, 0.05% indels via code-space edits
            sub = rng.random(len(r)) < 0.005
            r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
            s = "".join(B[c] for c in r)
            if ri == 1:
                s = "".join(rc[c] for c in s)
            if rng.random() < 0.05:  # one indel in 5% of reads
                q = int(rng.integers(10, len(s) - 10))
                if rng.random() < 0.5:
                    s = s[:q] + s[q + 1:] + B[int(rng.integers(0, 4))]
                else:
                    s = s[:q] + B[int(rng.integers(0, 4))] + s[q:-1]
            seqs.append(s)
        q = "I" * READ_LEN
        lines1.append(f"@p{npairs}/1\n{seqs[0]}\n+\n{q}\n")
        lines2.append(f"@p{npairs}/2\n{seqs[1]}\n+\n{q}\n")
        npairs += 1
    with open(fq1, "w") as f:
        f.write("".join(lines1))
    with open(fq2, "w") as f:
        f.write("".join(lines2))


def sample_reads_long(prefix: str, fq: str, n_reads: int, seed: int = 31,
                      lens: tuple[int, int] = (2000, 8000)) -> None:
    """n_reads long reads from the built index's genome: length drawn from
    [lens), per source base 4 % deleted, 3 % an inserted random base, 3 % a
    random base in its place (the substitution may redraw the same base),
    half of the reads reverse-complemented, qualities 10-29."""
    from .index.fmindex import FMIndex
    fm = FMIndex.load(prefix)
    g = fm.ref_string[:fm.l_pac]
    rng = np.random.default_rng(seed)
    rc = str.maketrans("ACGT", "TGCA")
    out = []
    for i in range(n_reads):
        ln = int(rng.integers(*lens))
        p0 = int(rng.integers(0, fm.l_pac - ln))
        src = g[p0:p0 + ln]
        seq, j = bytearray(), 0
        while j < ln:                      # one draw and base per step
            r = rng.random(ln)
            b = BASES[rng.integers(0, 4, ln)]
            for x, c in zip(r.tolist(), b.tolist()):
                if j == ln:
                    break
                if x < 0.04:               # deletion
                    j += 1
                elif x < 0.07:             # insertion
                    seq.append(c)
                else:
                    seq.append(c if x < 0.10 else BASES[src[j]])
                    j += 1
        s = seq.decode()
        if rng.random() < 0.5:
            s = s.translate(rc)[::-1]
        q = "".join(chr(33 + int(x)) for x in rng.integers(10, 30, len(s)))
        out.append(f"@lr{i}\n{s}\n+\n{q}\n")
    with open(fq, "w") as f:
        f.write("".join(out))


def ensure_long(dir: str, scale: float, n_reads: int) -> tuple[str, str]:
    """ensure()'s genome and index under `dir`, and n_reads long reads
    (sample_reads_long, made once); returns (index prefix, reads.fq)."""
    fa = ensure_genome(dir, scale)
    fq = os.path.join(dir, f"long{n_reads}.fq")
    if not os.path.exists(fq):
        print(f"[bench-data] sampling {n_reads} long reads", file=sys.stderr)
        sample_reads_long(fa, fq, n_reads)
    return fa, fq


def ensure(dir: str, scale: float, n_pairs: int) -> tuple[str, str, str]:
    """Genome + index + reads under `dir` (made once); returns (index
    prefix, r1.fq, r2.fq)."""
    fa = ensure_genome(dir, scale)
    fq1 = os.path.join(dir, f"reads{n_pairs}_r1.fq")
    fq2 = os.path.join(dir, f"reads{n_pairs}_r2.fq")
    if not os.path.exists(fq2):
        print(f"[bench-data] sampling {n_pairs} 2x{READ_LEN}bp pairs",
              file=sys.stderr)
        sample_reads_pe(fa, fq1, fq2, n_pairs)
    return fa, fq1, fq2


def ensure_genome(dir: str, scale: float) -> str:
    """Genome + index under `dir` (made once); returns the index prefix."""
    os.makedirs(dir, exist_ok=True)
    fa = os.path.join(dir, "genome.fa")
    if not os.path.exists(fa):
        print(f"[bench-data] generating genome ({scale:.2f}x chr21)",
              file=sys.stderr)
        make_genome(fa, scale)
    if not os.path.exists(fa + ".bwt.2bit.64"):
        print("[bench-data] building index", file=sys.stderr)
        from .index.build import build_index
        build_index(fa, fa)
    return fa


def rescue_windows(genome: np.ndarray, seed: int, n: int, L: int,
                   qr: tuple[int, int], tr: tuple[int, int], nmut: int,
                   n_every: int, plant: int):
    """n random mate-rescue problems on the doubled `genome`, one per row of
    an int8[n, L] read grid: qlen drawn from [qr), tlen from [tr); even
    problems query a slice of their own window (from `plant` bases in, with
    `nmut` substitutions: rescuable), odd ones random bases; one in
    `n_every` gets an N and one in three is reverse-complemented (qdir -1,
    qcomp).  Returns (enc, qoff, qdir, qcomp, qlen, toff, tlen)."""
    l_pac = len(genome) // 2
    rng = np.random.default_rng(seed)
    enc = np.full((n, L), 4, np.int8)
    qoff = np.zeros(n, np.int32)
    qdir = np.zeros(n, np.int32)
    qcomp = np.zeros(n, bool)
    qlen = np.zeros(n, np.int32)
    toff = np.zeros(n, np.int64)
    tlen = np.zeros(n, np.int32)
    for i in range(n):
        ql = int(rng.integers(*qr))
        tl = int(rng.integers(*tr))
        tb = int(rng.integers(0, l_pac - tl))
        if i % 2 == 0:
            q = genome[tb + plant: tb + plant + ql].copy()
            mut = rng.integers(0, ql, nmut)
            q[mut] = (q[mut] + 1) % 4
        else:
            q = rng.integers(0, 4, ql).astype(np.uint8)
        if i % n_every == 0:
            q[rng.integers(0, ql)] = 4
        enc[i, :ql] = q
        rev = i % 3 == 0
        qoff[i] = i * L + (ql - 1 if rev else 0)
        qdir[i] = -1 if rev else 1
        qcomp[i] = rev
        qlen[i] = ql
        toff[i] = tb
        tlen[i] = tl
    return enc, qoff, qdir, qcomp, qlen, toff, tlen


def rescue_batch(genome: np.ndarray, parts: list[dict]):
    """Several rescue_windows sets as one batch on a shared read grid.
    parts: rescue_windows keywords (seed, n, qr, tr, nmut, n_every, plant;
    an L there is replaced by the grid's, the longest qr) plus u8, the
    precision class of the set.  Returns (enc int8[sum n, L], descriptors
    as DeviceKswv.align_batch takes them)."""
    L = max(p["qr"][1] for p in parts)
    ws = [rescue_windows(genome, **{k: v for k, v in p.items()
                                    if k not in ("L", "u8")}, L=L)
          for p in parts]
    row0 = np.cumsum([0] + [p["n"] for p in parts])
    desc = dict(zip(("qoff", "qdir", "qcomp", "qlen", "toff", "tlen"), (
        np.concatenate([w[1] + r * L for w, r in zip(ws, row0)]),
        *(np.concatenate([w[k] for w in ws]) for k in range(2, 7)))))
    desc["u8"] = np.concatenate([np.full(p["n"], p["u8"]) for p in parts])
    return np.concatenate([w[0] for w in ws]), desc
