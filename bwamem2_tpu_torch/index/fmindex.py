"""Loaded FM-index: host (NumPy) arrays + scalar FM operations.

This is the data model used by both the host oracle and the device kernels
(which receive the same arrays as torch tensors, see ops/).  Scalar
methods here are the exact behavioral spec of the device kernels:
  backward_ext    — FMI_search::backwardExt (FMI_search.cpp:1025-1052)
  get_sa_entry    — FMI_search::get_sa_entry_compressed (FMI_search.cpp:1103-1175)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import io as idxio
from .io import CP_MASK, CP_SHIFT, SA_COMPX, SA_COMPX_MASK, BntSeq


@dataclass
class FMIndex:
    bns: BntSeq
    ref_seq_len: int          # 2*l_pac + 1 (includes sentinel slot)
    counts: np.ndarray        # int64[5], +1 applied (sentinel), cumulative
    cp_count: np.ndarray      # int64[nblocks, 4]
    one_hot: np.ndarray       # uint64[nblocks, 4], bit 63 = first char of block
    sa_ms_byte: np.ndarray    # int8[(n>>3)+1]
    sa_ls_word: np.ndarray    # uint32[(n>>3)+1]
    sentinel_index: int
    ref_string: np.ndarray    # uint8[2*l_pac] doubled genome (.0123)
    pac: np.ndarray           # uint8[l_pac] forward codes (unpacked .pac)

    @classmethod
    def load(cls, prefix: str) -> "FMIndex":
        fm = idxio.read_bwt_2bit_64(prefix)
        bns = idxio.read_ann_amb(prefix)
        ref_string = idxio.read_0123(prefix)
        pac = idxio.read_pac(prefix + ".pac")
        return cls(bns=bns, ref_seq_len=fm["ref_seq_len"], counts=fm["counts"],
                   cp_count=fm["cp_count"], one_hot=fm["one_hot"],
                   sa_ms_byte=fm["sa_ms_byte"], sa_ls_word=fm["sa_ls_word"],
                   sentinel_index=fm["sentinel_index"], ref_string=ref_string,
                   pac=pac)

    @property
    def l_pac(self) -> int:
        return self.bns.l_pac

    # ---- scalar FM ops (spec for the device kernels) ----

    def occ(self, pos: int, c: int) -> int:
        """# occurrences of char c in BWT[0:pos) (GET_OCC, FMI_search.h:66-73)."""
        blk = pos >> CP_SHIFT
        y = pos & CP_MASK
        base = int(self.cp_count[blk, c])
        if y == 0:
            return base
        mask = (~np.uint64(0)) << np.uint64(64 - y)
        return base + int(bin(int(self.one_hot[blk, c]) & int(mask)).count("1"))

    def backward_ext(self, k: int, l: int, s: int, a: int) -> tuple[int, int, int]:
        """One backward extension step for char a; returns (k', l', s').

        Mirrors backwardExt: occ at both interval ends for all 4 chars, new
        l from the reverse-complement ordering plus sentinel correction."""
        kk = [0] * 4
        ss = [0] * 4
        ll = [0] * 4
        for b in range(4):
            occ_sp = self.occ(k, b)
            occ_ep = self.occ(k + s, b)
            kk[b] = int(self.counts[b]) + occ_sp
            ss[b] = occ_ep - occ_sp
        sentinel_offset = 1 if (k <= self.sentinel_index < k + s) else 0
        ll[3] = l + sentinel_offset
        ll[2] = ll[3] + ss[3]
        ll[1] = ll[2] + ss[2]
        ll[0] = ll[1] + ss[1]
        return kk[a], ll[a], ss[a]

    def bwt_char(self, pos: int) -> int:
        """BWT character at pos from the one-hot blocks (4 = sentinel)."""
        blk = pos >> CP_SHIFT
        y = 64 - (pos & CP_MASK) - 1
        for b in range(4):
            if (int(self.one_hot[blk, b]) >> y) & 1:
                return b
        return 4

    def get_sa_entry(self, pos: int) -> int:
        """Resolve BWT position -> reference coordinate via LF-walk to a
        sampled SA slot (get_sa_entry_compressed)."""
        offset = 0
        sp = pos
        while sp & SA_COMPX_MASK:
            b = self.bwt_char(sp)
            if b == 4:  # hit the sentinel: suffix == offset from start
                return offset
            sp = int(self.counts[b]) + self.occ(sp, b)
            offset += 1
        ms = int(self.sa_ms_byte[sp >> SA_COMPX])
        ls = int(self.sa_ls_word[sp >> SA_COMPX])
        return ((ms << 32) + ls) + offset

    # ---- reference subsequence fetch on the doubled genome ----

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """bns_get_seq_v2 semantics: direct slice of the .0123 buffer
        (bwamem.cpp:1851-1888); empty if bridging the strand boundary."""
        if end < beg:
            beg, end = end, beg
        end = min(end, self.l_pac << 1)
        beg = max(beg, 0)
        if beg >= self.l_pac or end <= self.l_pac:
            return self.ref_string[beg:end]
        return self.ref_string[0:0]

    def fetch_seq(self, beg: int, mid: int, end: int) -> tuple[np.ndarray, int, int, int]:
        """bns_fetch_seq_v2: clamp [beg,end) to the contig containing mid
        (strand-flipped), return (seq, rid, beg, end)."""
        if end < beg:
            beg, end = end, beg
        pos_f, is_rev = self.bns.depos(mid)
        rid = self.bns.pos2rid(pos_f)
        far_beg = self.bns.anns[rid].offset
        far_end = far_beg + self.bns.anns[rid].length
        if is_rev:
            far_beg, far_end = ((self.l_pac << 1) - far_end,
                                (self.l_pac << 1) - far_beg)
        beg = max(beg, far_beg)
        end = min(end, far_end)
        return self.get_seq(beg, end), rid, beg, end
