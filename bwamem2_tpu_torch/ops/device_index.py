"""Device-resident FM-index tables (torch) and the plain occ/LF primitives.

Layout on the device:
  occp      int32[nblocks, 8]  one 32-byte row per 64-char BWT block:
                               [cp_lo[4] | code[4]]
                               cp_lo    = low 32 bits of the 4 checkpoint
                                          counts (GET_OCC base)
                               code[4]  = the block's 64 BWT chars as 2-bit
                                          codes, 16 per 32-bit word,
                                          LSB-first
  occ_hi    int32[nblocks]     the counts' bits 32.., one byte per base
                               packed into one word (a hi byte >= 128
                               makes the word negative); identically zero
                               for any genome whose doubled length fits 32
                               bits, and then a size-1 dummy that is never
                               read (`has_hi` False)
  counts    int64[5]           cumulative char counts (+1 sentinel shift)
  sa_ms     int8[(n>>3)+1]     8x-compressed suffix array, high byte
                               (sign-extends at use)
  sa_ls     int32[(n>>3)+1]    low 32 bits, carried as int32 bits (read
                               back as uint32 values)
  sentinel  int64 0-d          BWT position of the sentinel
  ref       uint8[2*l_pac]     doubled genome (the .0123 buffer), packed 4
                               chars/byte once 2*l_pac reaches REF_PACK_MIN
  lut_start int64[4^K]         the K-mer interval table (index/klut.py) of
  lut_size  int64[4^K]         the legacy round-1 walk: start and size of
                               the interval of each K-mer (code = sum of
                               base(i) << 2(K-1-i), read left to right);
                               size-1 dummies without a table, and
                               lut_depth = K (0: no table)

The index file's checkpoint blocks are 64 bytes per 64 chars (4 int64
counts + 4 one-hot uint64 masks, FMI_search.h:54-58); the packed row holds
the same information in 32 bytes by storing each char as a 2-bit code, so
every occ() query is ONE 32-byte row read — one sector of the card's
memory.  occ/backward-ext semantics mirror GET_OCC (FMI_search.h:66-73)
and backwardExt (FMI_search.cpp:1025-1052) exactly, with 64-bit counts.
The sentinel's slot stores code 0; occ() subtracts the phantom 'A' when
the sentinel falls inside the counted prefix of its block.

Sharded index (the genome buckets of parallel/shard_index.py): occp,
occ_hi (where has_hi), sa_ms and sa_ls split into D contiguous row ranges
of equal length (the last padded with zero rows), one per card; counts,
sentinel and ref replicated.  Such an index has `shards` set and its own
occp / occ_hi / sa_ms / sa_ls unset, and every row fetch of the plain
primitives goes through dist_rows_ref.

The functions below are the plain PyTorch versions of the `__host__
__device__` primitives in csrc/fm_occ.cuh.  torch on the CPU has no
popcount and no unsigned 32-bit arithmetic, so they compute in int64 with
masks and a SWAR popcount; int64 is exact for every genome.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.fmindex import FMIndex
from . import resolve_device

# 16-bit -> 32-bit "reverse and spread" table: bit (15-t) of the input (the
# one-hot convention puts the block's first char at the TOP bit,
# FMI_search.cpp:218-252) lands at bit 2t of the output (codes are
# LSB-first so char extraction is a plain shift by 2*(j&15)).
_SPREAD16: np.ndarray | None = None


def _spread16() -> np.ndarray:
    global _SPREAD16
    if _SPREAD16 is None:
        v = np.arange(1 << 16, dtype=np.uint32)
        out = np.zeros(1 << 16, np.uint32)
        for t in range(16):
            out |= ((v >> (15 - t)) & 1) << (2 * t)
        _SPREAD16 = out
    return _SPREAD16


def pack_occ_rows(cp_count: np.ndarray,
                  one_hot: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side build of the packed occ table from the index file's
    checkpoint layout (cp_count int64[nb,4], one_hot uint64[nb,4]).
    Returns (occp int32[nb,8], occ_hi int32[nb])."""
    nb = cp_count.shape[0]
    occp = np.zeros((nb, 8), np.int32)
    occp[:, 0:4] = (cp_count & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (cp_count >> 32).astype(np.int32)   # < 256 for any genome < 2^40
    occ_hi = (hi[:, 0] | (hi[:, 1] << 8) | (hi[:, 2] << 16)
              | (hi[:, 3] << 24)).astype(np.int32)
    spread = _spread16()
    # code planes: lo bit set for chars 1,3; hi bit for chars 2,3
    lo64 = one_hot[:, 1] | one_hot[:, 3]
    hi64 = one_hot[:, 2] | one_hot[:, 3]
    for wi in range(4):
        sh = np.uint64(48 - 16 * wi)
        sub_lo = ((lo64 >> sh) & np.uint64(0xFFFF)).astype(np.uint16)
        sub_hi = ((hi64 >> sh) & np.uint64(0xFFFF)).astype(np.uint16)
        occp[:, 4 + wi] = (spread[sub_lo]
                           | (spread[sub_hi] << 1)).view(np.int32)
    return occp, occ_hi


def pack_ref(ref_string: np.ndarray) -> tuple[np.ndarray, bool]:
    """The doubled genome as stored on the device: uint8, one code per
    byte, or 2-bit packed once it reaches REF_PACK_MIN chars (char k of
    byte b at bits 2k..2k+1, LSB first, the tail padded with zeros)."""
    ref = np.ascontiguousarray(ref_string, np.uint8)
    packed = ref.shape[0] >= DeviceFMIndex.REF_PACK_MIN
    if packed:
        pad = (-ref.shape[0]) % 4
        if pad:
            ref = np.concatenate([ref, np.zeros(pad, np.uint8)])
        r = ref.reshape(-1, 4)
        ref = (r[:, 0] | (r[:, 1] << 2) | (r[:, 2] << 4)
               | (r[:, 3] << 6)).astype(np.uint8)
    return ref, packed


@dataclass
class FmShards:
    """The occ and SA tables split by contiguous row range: table[i] holds
    rows [i * rows, (i + 1) * rows) of occp / occ_hi (sa_rows for sa_ms /
    sa_ls), each on its shard's device; occ_hi is None without has_hi."""
    occp: list
    occ_hi: list | None
    sa_ms: list
    sa_ls: list
    rows: int
    sa_rows: int
    nblocks: int      # occ rows of the whole table


@dataclass
class DeviceFMIndex:
    ref: torch.Tensor         # uint8[2*l_pac], or 2-bit packed (ref_packed)
    ref_packed: bool
    device: torch.device
    n_ref: int = 0            # chars of the doubled genome (2*l_pac)
    occp: torch.Tensor | None = None      # int32[nb, 8]
    occ_hi: torch.Tensor | None = None    # int32[nb] (or [1] dummy)
    counts: torch.Tensor | None = None    # int64[5]
    sa_ms: torch.Tensor | None = None     # int8[(n>>3)+1]
    sa_ls: torch.Tensor | None = None     # int32 bits of uint32 values
    sentinel: torch.Tensor | None = None  # int64 0-d
    has_hi: bool = False
    shards: FmShards | None = None        # set: the tables are split
    lut_start: torch.Tensor | None = None  # int64[4^K] (or [1] dummy)
    lut_size: torch.Tensor | None = None   # int64[4^K] (or [1] dummy)
    lut_depth: int = 0                     # K of the K-mer table, 0: none

    @property
    def nblocks(self) -> int:
        """Rows of the occ table (64 BWT positions each)."""
        return (self.occp.shape[0] if self.shards is None
                else self.shards.nblocks)

    # pack the doubled genome 4 chars/byte above this (2*l_pac): at human
    # scale the u8 genome alone is 6.2 GB; packed it is 1.55 GB
    REF_PACK_MIN = 1 << 31

    @classmethod
    def from_genome(cls, ref_string: np.ndarray, device=None
                    ) -> "DeviceFMIndex":
        """Only the doubled genome (what extension reads), no occ/SA
        tables."""
        dev = resolve_device(device)
        ref, packed = pack_ref(ref_string)
        return cls(ref=torch.from_numpy(ref).to(dev), ref_packed=packed,
                   device=dev, n_ref=int(ref_string.shape[0]))

    @classmethod
    def from_host(cls, fm: FMIndex, device=None,
                  lut: tuple | None = None) -> "DeviceFMIndex":
        """Carry the loaded index onto `device` ("cuda" unless "cpu" is
        asked for): the genome plus the packed occ rows, the count-hi
        plane, the counts and the compressed SA, and the K-mer table `lut`
        = (K, starts, sizes) as index/klut.py:load_or_build_klut returns
        it (None: size-1 dummies, lut_depth 0)."""
        out = cls.from_genome(fm.ref_string, device)
        dev = out.device
        occp, occ_hi = pack_occ_rows(fm.cp_count.astype(np.int64),
                                     fm.one_hot)
        out.has_hi = bool(occ_hi.any())
        if not out.has_hi:
            occ_hi = np.zeros(1, np.int32)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        out.occp = put(occp)
        out.occ_hi = put(occ_hi)
        out.counts = put(fm.counts.astype(np.int64))
        out.sa_ms = put(fm.sa_ms_byte.astype(np.int8))
        out.sa_ls = put(fm.sa_ls_word.astype(np.uint32).view(np.int32))
        out.sentinel = torch.tensor(int(fm.sentinel_index),
                                    dtype=torch.int64, device=dev)
        K, starts, sizes = lut if lut else (0, np.zeros(1), np.zeros(1))
        out.lut_depth = int(K)
        out.lut_start = put(np.asarray(starts, np.int64))
        out.lut_size = put(np.asarray(sizes, np.int64))
        return out


# ------------------------------------------------------------ primitives
_M32 = 0xFFFFFFFF
_ONES = 0x55555555


def _popc32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & _ONES)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def take_counts(counts: torch.Tensor, a: torch.Tensor, base: int = 0
                ) -> torch.Tensor:
    """counts[a + base] per lane (int64)."""
    return counts[a.long() + base]


def dist_rows_ref(shards: list, ids: torch.Tensor) -> torch.Tensor:
    """Rows `ids` (int64, global row ids) of a table split by contiguous
    row range into equal shards, on ids' device: each shard contributes
    the rows whose ids fall in its range and zeros elsewhere, and the
    contributions are summed (bwamem2_tpu/ops/device_index.py:_dist_rows,
    whose all_gather / local gather / psum_scatter compute the same)."""
    n = shards[0].shape[0]
    out = None
    for i, tab in enumerate(shards):
        loc = ids.to(tab.device) - i * n
        inr = (loc >= 0) & (loc < n)
        rows = tab[loc.clamp(0, n - 1)]
        inr = inr.reshape(inr.shape + (1,) * (rows.dim() - inr.dim()))
        rows = torch.where(inr, rows, 0).to(ids.device)
        out = rows if out is None else out + rows
    return out


def occ_rows(dfm: DeviceFMIndex, blk: torch.Tensor):
    """(occp rows int32 [..., 8], occ_hi words [...] or None) of the
    blocks `blk` (int64), from the shards when the index is split."""
    sh = dfm.shards
    if sh is None:
        return dfm.occp[blk], (dfm.occ_hi[blk] if dfm.has_hi else None)
    return (dist_rows_ref(sh.occp, blk),
            dist_rows_ref(sh.occ_hi, blk) if dfm.has_hi else None)


def sa_words(dfm: DeviceFMIndex, idx: torch.Tensor):
    """(sa_ms, sa_ls) words of the sampled slots `idx` (int64)."""
    sh = dfm.shards
    if sh is None:
        return dfm.sa_ms[idx], dfm.sa_ls[idx]
    return dist_rows_ref(sh.sa_ms, idx), dist_rows_ref(sh.sa_ls, idx)


def _row(dfm: DeviceFMIndex, pos: torch.Tensor):
    """The packed row of each position's block as int64 words in
    [0, 2^32): (row [..., 8], y [...], hi [...] or None)."""
    row, hi = occ_rows(dfm, pos >> 6)
    return (row.long() & _M32, pos & 63,
            hi.long() & _M32 if hi is not None else None)


def _prefix_masks(y: torch.Tensor) -> torch.Tensor:
    """Per code word, the mask over its first clip(y - 16*wi, 0, 16)
    chars.  y int64[...] -> int64[..., 4]."""
    wi = torch.arange(4, device=y.device, dtype=torch.int64) * 16
    nfull = (y[..., None] - wi).clamp(0, 16)
    return (torch.ones_like(nfull) << (2 * nfull)) - 1


def _cp(row, hi, c: int | torch.Tensor):
    """64-bit checkpoint count for base c ([..., ] lanes)."""
    if isinstance(c, int):
        lo = row[..., c]
    else:
        lo = row[..., :4].gather(-1, c.long()[..., None])[..., 0]
    if hi is None:
        return lo
    return lo + (((hi >> (8 * c)) & 0xFF) << 32)


def _sent_in_prefix(dfm, pos, y):
    """1 where the sentinel slot falls inside [block_start, pos)."""
    s = dfm.sentinel
    return (((pos - y) <= s) & (s < pos)).long()


def occ_all4(dfm: DeviceFMIndex, pos: torch.Tensor) -> torch.Tensor:
    """occ(pos, c) for all 4 chars -> int64[..., 4].  One row read."""
    pos = pos.long()
    row, y, hi = _row(dfm, pos)
    words = row[..., 4:8]
    pmask = _prefix_masks(y)
    lo = words & _ONES
    hib = (words >> 1) & _ONES
    n = []
    for c in range(4):
        zlo = lo if (c & 1) else lo ^ _ONES
        zhi = hib if (c & 2) else hib ^ _ONES
        n.append(_popc32(zlo & zhi & pmask).sum(-1))
    n = torch.stack(n, -1)
    n[..., 0] -= _sent_in_prefix(dfm, pos, y)
    cp = row[..., 0:4]
    if hi is not None:
        sh = torch.arange(4, device=pos.device, dtype=torch.int64) * 8
        cp = cp + (((hi[..., None] >> sh) & 0xFF) << 32)
    return cp + n


def _match_c(words, c):
    """Per code word, even-bit mask of the chars equal to per-lane c."""
    pat = (c.long() * _ONES)[..., None]
    m = words ^ pat
    return ~(m | (m >> 1)) & _ONES


def occ_one(dfm: DeviceFMIndex, pos: torch.Tensor, c) -> torch.Tensor:
    """occ(pos, c) for one char per lane: # of c in BWT[0:pos)."""
    pos = pos.long()
    c = torch.as_tensor(c, device=pos.device).long().expand_as(pos)
    row, y, hi = _row(dfm, pos)
    z = _match_c(row[..., 4:8], c) & _prefix_masks(y)
    n = _popc32(z).sum(-1) - (c == 0).long() * _sent_in_prefix(dfm, pos, y)
    return _cp(row, hi, c) + n


def lf_step(dfm: DeviceFMIndex, k, s, a):
    """Backward extension of the interval (k, s) by char a, tracking only
    (k, s): C[a] + occ(k, a) and occ(k + s, a) - occ(k, a).  Two row
    reads."""
    occ_sp = occ_one(dfm, k, a)
    return (take_counts(dfm.counts, torch.as_tensor(a, device=k.device))
            + occ_sp, occ_one(dfm, k + s, a) - occ_sp)


def backward_ext_full(dfm: DeviceFMIndex, k, l, s, a):
    """backwardExt: (k', l', s') of the interval (k, l, s) extended by
    char a, including the RC-twin bound l and the sentinel correction.
    Forward extension is the same call on the RC twin with k/l swapped."""
    k, l, s = k.long(), l.long(), s.long()
    a = torch.as_tensor(a, device=k.device).long().expand_as(k)
    occ_sp = occ_all4(dfm, k)
    occ_ep = occ_all4(dfm, k + s)
    kk = dfm.counts[:4] + occ_sp
    ss = occ_ep - occ_sp
    sent = ((k <= dfm.sentinel) & (dfm.sentinel < k + s)).long()
    l3 = l + sent
    l2 = l3 + ss[..., 3]
    l1 = l2 + ss[..., 2]
    l0 = l1 + ss[..., 1]
    ll = torch.stack([l0, l1, l2, l3], -1)
    ai = a[..., None]
    return (kk.gather(-1, ai)[..., 0], ll.gather(-1, ai)[..., 0],
            ss.gather(-1, ai)[..., 0])


def bwt_char(dfm: DeviceFMIndex, pos: torch.Tensor) -> torch.Tensor:
    """BWT char at pos from the stored codes (4 = sentinel), int64."""
    pos = pos.long()
    row, y, _ = _row(dfm, pos)
    word = row[..., 4:8].gather(-1, (y >> 4)[..., None])[..., 0]
    code = (word >> ((y & 15) * 2)) & 3
    return torch.where(pos == dfm.sentinel, 4, code)


def bwt_char_occ(dfm: DeviceFMIndex, pos: torch.Tensor):
    """(BWT char at pos (4 = sentinel), occ(pos, stored code)) from ONE
    row read — the LF step of SA resolution."""
    pos = pos.long()
    row, y, hi = _row(dfm, pos)
    words = row[..., 4:8]
    word = words.gather(-1, (y >> 4)[..., None])[..., 0]
    code = (word >> ((y & 15) * 2)) & 3
    z = _match_c(words, code) & _prefix_masks(y)
    n = _popc32(z).sum(-1) - (code == 0).long() * _sent_in_prefix(dfm, pos,
                                                                   y)
    occ = _cp(row, hi, code) + n
    return torch.where(pos == dfm.sentinel, 4, code), occ


def take_ref(ref: torch.Tensor, pos: torch.Tensor, packed: bool
             ) -> torch.Tensor:
    """Doubled-genome char at int64 `pos` (int32 in [0,4)).

    Out-of-range positions are clipped (unpacked) or wrap within the last
    byte (packed) — callers mask those lanes, only in-range values are
    consumed."""
    n = ref.shape[0]
    if not packed:
        return ref[pos.clamp(0, n - 1)].to(torch.int32)
    b = ref[(pos >> 2).clamp(0, n - 1)].to(torch.int32)
    return (b >> ((pos.to(torch.int32) & 3) * 2)) & 3
