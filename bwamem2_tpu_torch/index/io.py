"""On-disk index formats, byte-compatible with bwa-mem2 v2.2.1.

Files (for index prefix P):
  P.pac          2-bit packed forward reference (+2 trailer bytes)
                 [bntseq.cpp:338-351]
  P.ann / P.amb  contig metadata / ambiguity holes (text) [bntseq.cpp:73-104]
  P.alt          optional ALT contig names [bntseq.cpp:199-226]
  P.0123         byte-per-base codes 0..3 of the doubled genome (fwd+revcomp)
                 [FMI_search.cpp:325-362]
  P.bwt.2bit.64  FM-index: int64 seqlen, int64 count[5], CP_OCC blocks
                 (4x int64 counts + 4x uint64 one-hot per 64 BWT chars),
                 8x-compressed SA (int8 ms byte + uint32 ls word), int64
                 sentinel index [FMI_search.cpp:144-304, 384-460]

Either toolchain's index files work with the other — this is tested against
indexes produced by the reference binary.
"""

from __future__ import annotations

import gzip
import os
from bisect import bisect_right
from dataclasses import dataclass, field

import numpy as np

CP_SHIFT = 6
CP_BLOCK_SIZE = 64
CP_MASK = 63
SA_COMPX = 3
SA_COMPX_MASK = 7

# base encoding: A=0 C=1 G=2 T=3, N/other=4, '-'=5 (bntseq.cpp:54-71)
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i
NT4_TABLE[ord("-")] = 5


class Lrand48:
    """drand48-family LCG, replicating glibc lrand48 after srand48(seed).

    Needed to reproduce the reference's deterministic N->random-base filling
    (bntseq.cpp:284,314: srand48(11), lrand48()&3).
    """

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int):
        self.x = ((seed << 16) | 0x330E) & self.MASK

    def next(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x >> 17


@dataclass
class Contig:
    name: str
    anno: str
    offset: int
    length: int
    n_ambs: int
    gi: int = 0
    is_alt: bool = False


@dataclass
class AmbHole:
    offset: int
    length: int
    amb: str


@dataclass
class BntSeq:
    """Reference metadata — the bntseq_t analog (bntseq.h:56-64)."""

    l_pac: int = 0
    seed: int = 11
    anns: list = field(default_factory=list)
    ambs: list = field(default_factory=list)

    @property
    def n_seqs(self) -> int:
        return len(self.anns)

    @property
    def n_holes(self) -> int:
        return len(self.ambs)

    # -- coordinate mapping on the doubled genome (bntseq.h:87-90, bntseq.cpp:378-402)
    def depos(self, pos: int) -> tuple[int, bool]:
        is_rev = pos >= self.l_pac
        return ((self.l_pac << 1) - 1 - pos) if is_rev else pos, is_rev

    def pos2rid(self, pos_f: int) -> int:
        if pos_f >= self.l_pac:
            return -1
        # bisect on a cached python list: called per seed occurrence, and a
        # C bisect is ~10x a numpy scalar searchsorted
        return bisect_right(self._offsets(), pos_f) - 1

    def intv2rid(self, rb: int, re: int) -> int:
        if rb < self.l_pac < re:
            return -2
        rid_b = self.pos2rid(self.depos(rb)[0])
        rid_e = self.pos2rid(self.depos(re - 1)[0]) if rb < re else rid_b
        return rid_b if rid_b == rid_e else -1

    _offsets_cache: list | None = None

    def _offsets(self) -> list:
        if self._offsets_cache is None or len(self._offsets_cache) != self.n_seqs:
            self._offsets_cache = [a.offset for a in self.anns]
        return self._offsets_cache


def open_maybe_gz(path: str):
    """Open a local file, http(s)://, or ftp:// input, transparently
    gunzipping — the kopen analog (kopen.cpp:117 http_open, :189 ftp)."""
    if path.startswith(("http://", "https://", "ftp://")):
        import io as _io
        import urllib.request
        resp = urllib.request.urlopen(path)
        # read exactly 2 magic bytes (peek may return fewer on a slow
        # stream), then replay them ahead of the remaining body
        head = b""
        while len(head) < 2:
            b = resp.read(2 - len(head))
            if not b:
                break
            head += b

        class _Replay(_io.RawIOBase):
            def __init__(self, first, rest):
                self._first = first
                self._rest = rest

            def readable(self):
                return True

            def readinto(self, b):
                if self._first:
                    n = min(len(b), len(self._first))
                    b[:n] = self._first[:n]
                    self._first = self._first[n:]
                    return n
                data = self._rest.read(len(b))
                if not data:
                    return 0
                b[: len(data)] = data
                return len(data)

        buf = _io.BufferedReader(_Replay(head, resp))
        if head[:2] == b"\x1f\x8b":
            return gzip.open(buf, "rb")
        return buf
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path: str):
    """Yield (name, comment, sequence_bytes) per contig."""
    name, comment, chunks = None, "", []
    with open_maybe_gz(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, comment, b"".join(chunks)
                hdr = line[1:].decode()
                parts = hdr.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                chunks = []
            elif name is not None:
                chunks.append(line)
    if name is not None:
        yield name, comment, b"".join(chunks)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (0..3) into bwa's .pac layout: base i in byte i>>2,
    bits (3-(i&3))*2 (bntseq.cpp:246)."""
    n = len(codes)
    pad = (-n) % 4
    c = np.concatenate([codes.astype(np.uint8), np.zeros(pad, np.uint8)])
    c = c.reshape(-1, 4)
    return (c[:, 0] << 6 | c[:, 1] << 4 | c[:, 2] << 2 | c[:, 3]).astype(np.uint8)


def unpack_2bit(pac: np.ndarray, n: int) -> np.ndarray:
    b = pac.reshape(-1, 1)
    out = np.empty((len(pac), 4), dtype=np.uint8)
    out[:, 0] = (b[:, 0] >> 6) & 3
    out[:, 1] = (b[:, 0] >> 4) & 3
    out[:, 2] = (b[:, 0] >> 2) & 3
    out[:, 3] = b[:, 0] & 3
    return out.reshape(-1)[:n]


def write_pac(prefix: str, codes: np.ndarray) -> None:
    """Write .pac with bwa's 2-byte trailer (bntseq.cpp:338-351)."""
    l_pac = len(codes)
    with open(prefix + ".pac", "wb") as f:
        f.write(pack_2bit(codes).tobytes())
        if l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l_pac % 4]))


def read_pac(path: str) -> np.ndarray:
    """Inverse of write_pac (bwa .pac trailer convention, bntseq.cpp:341-347)."""
    raw = np.fromfile(path, dtype=np.uint8)
    rem = int(raw[-1])
    if rem == 0:
        body = raw[:-2]
        n = len(body) * 4
    else:
        body = raw[:-1]
        n = (len(body) - 1) * 4 + rem
    return unpack_2bit(body, n)


def write_ann_amb(prefix: str, bns: BntSeq) -> None:
    with open(prefix + ".ann", "w") as f:
        f.write(f"{bns.l_pac} {bns.n_seqs} {bns.seed}\n")
        for a in bns.anns:
            anno = a.anno if a.anno else "(null)"
            f.write(f"{a.gi} {a.name} {anno}\n")
            f.write(f"{a.offset} {a.length} {a.n_ambs}\n")
    with open(prefix + ".amb", "w") as f:
        f.write(f"{bns.l_pac} {bns.n_seqs} {bns.n_holes}\n")
        for h in bns.ambs:
            f.write(f"{h.offset} {h.length} {h.amb}\n")


def read_ann_amb(prefix: str) -> BntSeq:
    bns = BntSeq()
    with open(prefix + ".ann") as f:
        toks = f.read().split("\n")
    hdr = toks[0].split()
    bns.l_pac, n_seqs, bns.seed = int(hdr[0]), int(hdr[1]), int(hdr[2])
    li = 1
    for _ in range(n_seqs):
        parts = toks[li].split(None, 2)
        gi, name = int(parts[0]), parts[1]
        anno = parts[2] if len(parts) > 2 else ""
        if anno == "(null)":
            anno = ""
        nums = toks[li + 1].split()
        bns.anns.append(Contig(name=name, anno=anno, offset=int(nums[0]),
                               length=int(nums[1]), n_ambs=int(nums[2]), gi=gi))
        li += 2
    with open(prefix + ".amb") as f:
        lines = f.read().split("\n")
    n_holes = int(lines[0].split()[2])
    for i in range(n_holes):
        o, l, c = lines[1 + i].split()
        bns.ambs.append(AmbHole(int(o), int(l), c))
    # optional .alt
    alt_path = prefix + ".alt"
    if os.path.exists(alt_path):
        names = {a.name: a for a in bns.anns}
        with open(alt_path) as f:
            for line in f:
                tok = line.split("\t")[0].split("\n")[0].strip()
                if tok and not tok.startswith("@") and tok in names:
                    names[tok].is_alt = True
    return bns


def one_hot_pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack (n, 64) boolean rows into uint64 with bit 63 = column 0
    (FMI_search.cpp:234-246: shift left then add)."""
    packed = np.packbits(bits.astype(np.uint8), axis=1)  # big-endian bytes
    return packed.reshape(-1, 8).view(">u8").astype(np.uint64).reshape(-1)


def build_fm_arrays(seq_codes: np.ndarray, sa: np.ndarray):
    """Compute BWT, checkpointed occ and compressed SA arrays.

    seq_codes: doubled genome codes (len n), sa: suffix array with the empty
    suffix first (len n+1).  Mirrors FMI_search.cpp:144-304.
    Returns dict of arrays ready for serialization.
    """
    n1 = len(sa)  # = ref_seq_len in the file (includes sentinel slot)
    # BWT with sentinel = 4 where sa == 0, computed in chunks: a whole-array
    # fancy index would materialize a second SA-sized int64 array (50GB at
    # human scale — the 3.1Gbp build OOM'd exactly there)
    n_aligned = ((n1 + CP_BLOCK_SIZE - 1) // CP_BLOCK_SIZE) * CP_BLOCK_SIZE
    bwt_pad = np.full(n_aligned, 6, dtype=np.uint8)
    sentinel_index = -1
    CH = 1 << 27
    for i in range(0, n1, CH):
        s = sa[i:i + CH]
        z = s == 0
        if sentinel_index < 0 and z.any():
            sentinel_index = i + int(np.argmax(z))
        # s-1 == -1 at the sentinel wraps to the last element; the where
        # overrides that lane, so no clip copy is needed
        bwt_pad[i:i + len(s)] = np.where(z, np.uint8(4),
                                         seq_codes[s - 1])
    if sentinel_index < 0:
        raise ValueError("suffix array has no sentinel entry (sa == 0)")
    blocks = bwt_pad.reshape(-1, CP_BLOCK_SIZE)

    cp_occ_size = (n1 >> CP_SHIFT) + 1
    cp_count = np.zeros((cp_occ_size, 4), dtype=np.int64)
    one_hot = np.zeros((cp_occ_size, 4), dtype=np.uint64)
    nb = blocks.shape[0]
    for c in range(4):
        eq = blocks == c
        per_block = eq.sum(axis=1, dtype=np.int64)
        cum = np.zeros(nb, dtype=np.int64)
        cum[1:] = np.cumsum(per_block)[:-1]
        cp_count[:min(nb, cp_occ_size), c] = cum[:cp_occ_size]
        one_hot[:min(nb, cp_occ_size), c] = one_hot_pack_bits(eq)[:cp_occ_size]
    # if n1 is a multiple of 64 the reference leaves the final (partial) block
    # zeroed; replicate
    if n1 % CP_BLOCK_SIZE == 0 and cp_occ_size > nb:
        pass  # zeros already

    counts = np.zeros(5, dtype=np.int64)
    binc = np.bincount(seq_codes, minlength=5)
    counts[1] = binc[0]
    counts[2] = counts[1] + binc[1]
    counts[3] = counts[2] + binc[2]
    counts[4] = counts[3] + binc[3]

    n_sa = (n1 >> SA_COMPX) + 1
    sampled = sa[::8][:n_sa]
    sa_ms_byte = np.full(n_sa, -1, dtype=np.int8)
    sa_ls_word = np.zeros(n_sa, dtype=np.uint32)
    sa_ms_byte[: len(sampled)] = (sampled >> 32).astype(np.int8)
    sa_ls_word[: len(sampled)] = (sampled & 0xFFFFFFFF).astype(np.uint32)

    return dict(ref_seq_len=n1, counts=counts, cp_count=cp_count,
                one_hot=one_hot, sa_ms_byte=sa_ms_byte, sa_ls_word=sa_ls_word,
                sentinel_index=sentinel_index)


def write_bwt_2bit_64(prefix: str, arr: dict) -> None:
    n1 = arr["ref_seq_len"]
    cp_occ_size = (n1 >> CP_SHIFT) + 1
    with open(prefix + ".bwt.2bit.64", "wb") as f:
        np.int64(n1).tofile(f)
        arr["counts"].astype(np.int64).tofile(f)
        # interleave CP_OCC: 4 int64 counts then 4 uint64 one-hot per block
        rec = np.empty((cp_occ_size, 8), dtype=np.uint64)
        rec[:, :4] = arr["cp_count"].astype(np.uint64)
        rec[:, 4:] = arr["one_hot"]
        rec.tofile(f)
        arr["sa_ms_byte"].astype(np.int8).tofile(f)
        arr["sa_ls_word"].astype(np.uint32).tofile(f)
        np.int64(arr["sentinel_index"]).tofile(f)


def read_bwt_2bit_64(prefix: str) -> dict:
    with open(prefix + ".bwt.2bit.64", "rb") as f:
        n1 = int(np.fromfile(f, np.int64, 1)[0])
        counts_raw = np.fromfile(f, np.int64, 5)
        cp_occ_size = (n1 >> CP_SHIFT) + 1
        rec = np.fromfile(f, np.uint64, cp_occ_size * 8).reshape(-1, 8)
        cp_count = rec[:, :4].astype(np.int64)
        one_hot = rec[:, 4:].copy()
        n_sa = (n1 >> SA_COMPX) + 1
        sa_ms_byte = np.fromfile(f, np.int8, n_sa)
        sa_ls_word = np.fromfile(f, np.uint32, n_sa)
        sentinel_index = int(np.fromfile(f, np.int64, 1)[0])
    # load-time +1 on counts (sentinel) — FMI_search.cpp:432-436
    counts = counts_raw + 1
    return dict(ref_seq_len=n1, counts=counts, counts_raw=counts_raw,
                cp_count=cp_count, one_hot=one_hot, sa_ms_byte=sa_ms_byte,
                sa_ls_word=sa_ls_word, sentinel_index=sentinel_index)


def write_0123(prefix: str, seq_codes: np.ndarray) -> None:
    seq_codes.astype(np.uint8).tofile(prefix + ".0123")


def read_0123(prefix: str) -> np.ndarray:
    return np.fromfile(prefix + ".0123", dtype=np.uint8)
