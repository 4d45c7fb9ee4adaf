"""Index construction: FASTA -> {.pac,.ann,.amb,.0123,.bwt.2bit.64}.

Mirrors `bwa-mem2 index` (bwtindex.cpp:43-80): bns_fasta2bntseq builds the
forward-only pac + metadata, then the FM-index build doubles the genome
(forward + reverse complement), runs SA-IS, derives the BWT, and writes the
checkpointed occurrence table + 8x compressed suffix array.
"""

from __future__ import annotations

import sys

import numpy as np

from ..native import sais
from . import io as idxio
from .io import AmbHole, BntSeq, Contig, Lrand48, NT4_TABLE


def fasta_to_bnt(fasta_path: str, prefix: str) -> tuple[BntSeq, np.ndarray]:
    """Parse FASTA, build pac codes (N -> deterministic random base), write
    .pac/.ann/.amb.  Mirrors bns_fasta2bntseq + add1 (bntseq.cpp:249-357),
    including the fixed lrand48 seed 11."""
    bns = BntSeq(seed=11)
    rng = Lrand48(11)
    all_codes = []
    for name, comment, seq in idxio.read_fasta(fasta_path):
        codes = NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)].copy()
        offset = bns.l_pac
        # ambiguity holes: runs of the same raw character with code >= 4
        n_ambs = 0
        amb_idx = np.nonzero(codes >= 4)[0]
        if len(amb_idx):
            raw = np.frombuffer(seq, dtype=np.uint8)
            run_start = None
            prev_i = None
            for i in amb_idx:
                i = int(i)
                if run_start is not None and i == prev_i + 1 and raw[i] == raw[prev_i]:
                    bns.ambs[-1].length += 1
                else:
                    bns.ambs.append(AmbHole(offset + i, 1, chr(raw[i])))
                    n_ambs += 1
                    run_start = i
                prev_i = i
            # fill N with deterministic random bases, in sequence order
            for i in amb_idx:
                codes[i] = rng.next() & 3
        bns.anns.append(Contig(name=name, anno=comment, offset=offset,
                               length=len(codes), n_ambs=n_ambs))
        bns.l_pac += len(codes)
        all_codes.append(codes)
    pac_codes = np.concatenate(all_codes) if all_codes else np.zeros(0, np.uint8)
    idxio.write_pac(prefix, pac_codes)
    # bns_dump writes "(null)" for missing comments
    dump = BntSeq(l_pac=bns.l_pac, seed=bns.seed, ambs=bns.ambs)
    for a in bns.anns:
        dump.anns.append(Contig(name=a.name, anno=a.anno if a.anno else "(null)",
                                offset=a.offset, length=a.length,
                                n_ambs=a.n_ambs, gi=a.gi))
    idxio.write_ann_amb(prefix, dump)
    return bns, pac_codes


def build_index(fasta_path: str, prefix: str | None = None,
                verbose: bool = True) -> None:
    """Full `index` subcommand (bwtindex.cpp:43-80 + FMI_search::build_index)."""
    prefix = prefix or fasta_path
    log = (lambda *a: print(*a, file=sys.stderr)) if verbose else (lambda *a: None)

    log(f"[index] parsing {fasta_path}")
    bns, pac_codes = fasta_to_bnt(fasta_path, prefix)
    l_pac = bns.l_pac
    log(f"[index] l_pac = {l_pac}, contigs = {bns.n_seqs}, holes = {bns.n_holes}")

    # doubled genome: forward + reverse complement (pac2nt, FMI_search.cpp:83-142)
    rc = (3 - pac_codes[::-1]).astype(np.uint8)
    seq = np.concatenate([pac_codes, rc])
    idxio.write_0123(prefix, seq)

    log(f"[index] building suffix array over {len(seq)} bases (SA-IS)")
    sa = np.empty(len(seq) + 1, dtype=np.int64)
    sa[0] = len(seq)  # empty suffix first (FMI_search.cpp:373)
    sais(seq, 4, out=sa[1:])   # writes in place: no second SA-sized copy

    log("[index] building FM arrays (BWT, CP_OCC, compressed SA)")
    arrays = idxio.build_fm_arrays(seq, sa)
    idxio.write_bwt_2bit_64(prefix, arrays)
    log(f"[index] wrote {prefix}.bwt.2bit.64 "
        f"(sentinel at {arrays['sentinel_index']})")
