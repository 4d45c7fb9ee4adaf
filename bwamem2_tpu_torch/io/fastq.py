"""Batched FASTQ/FASTA reading (bseq_read_orig, bwa.cpp:170-216).

Reads are accumulated until total bases >= chunk_size (and the count is even,
so pairs never split across chunks).  Mate files are interleaved 1:1 and
trailing /1 //2 read-number suffixes are trimmed (trim_readno, bwa.cpp:62-66).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..index.io import open_maybe_gz


@dataclass(slots=True)
class Read:
    name: str
    comment: str | None
    seq: str
    qual: str | None
    id: int = 0
    sam: str | None = None


def _trim_readno(name: str) -> str:
    if len(name) > 2 and name[-2] == "/" and name[-1].isdigit():
        return name[:-2]
    return name


class FastxReader:
    """Streaming FASTA/FASTQ parser (kseq semantics: multi-line sequences)."""

    def __init__(self, path: str):
        self.f = open_maybe_gz(path)
        self._peek: bytes | None = None

    def _readline(self) -> bytes:
        if self._peek is not None:
            line, self._peek = self._peek, None
            return line
        return self.f.readline()

    def _pushback(self, line: bytes) -> None:
        self._peek = line

    def read_one(self) -> Read | None:
        line = self._readline()
        while line and not line.startswith((b">", b"@")):
            line = self._readline()
        if not line:
            return None
        is_fq = line.startswith(b"@")
        hdr = line[1:].rstrip(b"\r\n").decode()
        parts = hdr.split(None, 1)
        name = parts[0] if parts else ""
        comment = parts[1] if len(parts) > 1 else None
        seq_chunks = []
        qual = None
        while True:
            line = self._readline()
            if not line:
                break
            if line.startswith(b"+") and is_fq:
                # quality section: read until length matches
                slen = sum(len(c) for c in seq_chunks)
                qchunks = []
                got = 0
                while got < slen:
                    ql = self._readline()
                    if not ql:
                        break
                    ql = ql.rstrip(b"\r\n")
                    qchunks.append(ql)
                    got += len(ql)
                qual = b"".join(qchunks).decode()
                break
            if line.startswith(b">") or (is_fq and line.startswith(b"@")):
                self._pushback(line)
                break
            seq_chunks.append(line.rstrip(b"\r\n"))
        seq = b"".join(seq_chunks).decode()
        return Read(name=_trim_readno(name), comment=comment, seq=seq,
                    qual=qual)

    def close(self):
        self.f.close()


def read_chunk(ks1: FastxReader, ks2: FastxReader | None,
               chunk_size: int) -> list[Read]:
    """bseq_read_orig: fill a chunk of reads up to chunk_size bases."""
    reads: list[Read] = []
    size = 0
    while True:
        r1 = ks1.read_one()
        if r1 is None:
            break
        if ks2 is not None:
            r2 = ks2.read_one()
            if r2 is None:
                import sys
                print("[W] the 2nd file has fewer sequences.", file=sys.stderr)
                break
        r1.id = len(reads)
        reads.append(r1)
        size += len(r1.seq)
        if ks2 is not None:
            r2.id = len(reads)
            reads.append(r2)
            size += len(r2.seq)
        if size >= chunk_size and len(reads) % 2 == 0:
            break
    return reads
