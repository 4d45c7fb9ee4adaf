"""Seed chaining and chain filtering.

Mirrors mem_chain_seeds (bwamem.cpp:806-974, test_and_merge 357-399),
mem_chain_weight (429-448), mem_chain_flt (506-624) and
mem_flt_chained_seeds (472-504) per read.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass, field

import numpy as np

from ..index.fmindex import FMIndex
from ..native import ksw_align
from ..utils.f32 import f32, fmul
from ..utils.ksort import ks_introsort

MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05
KSW_XBYTE, KSW_XSTOP, KSW_XSUBO, KSW_XSTART = 0x10000, 0x20000, 0x40000, 0x80000


@dataclass(slots=True)
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int = 0
    aln: int = 0  # index of the alnreg produced from this seed


@dataclass(slots=True)
class Chain:
    pos: int
    rid: int
    seqid: int
    is_alt: bool
    seeds: list = field(default_factory=list)
    w: int = 0
    kept: int = 0
    first: int = -1
    frac_rep: float = 0.0

    @property
    def n(self) -> int:
        return len(self.seeds)


def test_and_merge(opt, l_pac: int, c: Chain, p: Seed, seed_rid: int) -> bool:
    """Append seed to chain if compatible (test_and_merge, bwamem.cpp:357-399)."""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (p.qbeg >= c.seeds[0].qbeg and p.qbeg + p.len <= qend and
            p.rbeg >= c.seeds[0].rbeg and p.rbeg + p.len <= rend):
        return True  # contained: do nothing
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and p.rbeg >= l_pac:
        return False  # different strand
    x = p.qbeg - last.qbeg  # non-negative (seeds arrive sorted by qbeg)
    y = p.rbeg - last.rbeg
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w and
            x - last.len < opt.max_chain_gap and
            y - last.len < opt.max_chain_gap):
        c.seeds.append(p)
        return True
    return False


def sa_positions_batch(opt, smems_per_read):
    """Chunk-flat version of sa_positions: BWT positions in consumption
    order plus the per-SMEM/per-read offset tables the native chainer
    needs."""
    smem_off = np.zeros(len(smems_per_read) + 1, np.int64)
    m, n, s = [], [], []
    occ_cnt = []
    pos = []
    for r, smems in enumerate(smems_per_read):
        for (_, mm, nn, kk, _, ss) in smems:
            m.append(mm)
            n.append(nn)
            s.append(ss)
            step = ss // opt.max_occ if ss > opt.max_occ else 1
            cnt = 0
            j = 0
            while j < ss and cnt < opt.max_occ:
                pos.append(kk + j)
                j += step
                cnt += 1
            occ_cnt.append(cnt)
        smem_off[r + 1] = len(m)
    occ_off = np.zeros(len(m) + 1, np.int64)
    np.cumsum(occ_cnt, out=occ_off[1:])
    return (np.array(pos, np.int64), smem_off,
            np.array(m, np.int32), np.array(n, np.int32),
            np.array(s, np.int64), occ_off)


def _ctg_arrays(fm: FMIndex):
    """Contig offset / is-alt arrays for the native chainer, cached on
    the index (rebuilt only if the contig list changes)."""
    cached = getattr(fm, "_ctg_arrays_cache", None)
    if cached is not None and len(cached[0]) == fm.bns.n_seqs:
        return cached
    ctg_off = np.fromiter((a.offset for a in fm.bns.anns), np.int64,
                          fm.bns.n_seqs)
    ctg_alt = np.fromiter((1 if a.is_alt else 0 for a in fm.bns.anns),
                          np.uint8, fm.bns.n_seqs)
    fm._ctg_arrays_cache = (ctg_off, ctg_alt)
    return ctg_off, ctg_alt


def _chain_seeds_arrays(fm: FMIndex, opt, encs, smem_off, smem_m, smem_n,
                        smem_s, occ_off, coords):
    from ..native import chain_seeds_batch
    lseq = np.fromiter((len(e) for e in encs), np.int32, len(encs))
    ctg_off, ctg_alt = _ctg_arrays(fm)
    return chain_seeds_batch(
        lseq, smem_off, smem_m, smem_n, smem_s, occ_off, coords,
        fm.l_pac, ctg_off, ctg_alt, opt)


def chain_and_filter_batch_native(fm: FMIndex, opt, encs, smem_off,
                                  smem_m, smem_n, smem_s, occ_off,
                                  coords: np.ndarray) -> list[list[Chain]]:
    """mem_chain_seeds + mem_chain_flt for a whole chunk in C++ (both
    bit-identical to the python spec incl. ks_introsort tie permutation);
    Chain/Seed objects are built only for the surviving chains."""
    from ..native import chain_filter_batch
    (chain_off, chain_pos, chain_rid, chain_alt, chain_frac, chain_nseeds,
     seed_rbeg, seed_qbeg, seed_len) = _chain_seeds_arrays(
        fm, opt, encs, smem_off, smem_m, smem_n, smem_s, occ_off, coords)
    out_off, out_idx, out_w, out_kept = chain_filter_batch(
        chain_off, chain_alt, chain_nseeds, seed_rbeg, seed_qbeg,
        seed_len, opt)
    soff = np.zeros(len(chain_nseeds) + 1, np.int64)
    np.cumsum(chain_nseeds, out=soff[1:])
    out: list[list[Chain]] = []
    for r in range(len(encs)):
        lst = []
        for oi in range(int(out_off[r]), int(out_off[r + 1])):
            ci = int(out_idx[oi])
            s0 = int(soff[ci])
            ns = int(chain_nseeds[ci])
            seeds = [Seed(rbeg=int(seed_rbeg[s0 + j]),
                          qbeg=int(seed_qbeg[s0 + j]),
                          len=int(seed_len[s0 + j]),
                          score=int(seed_len[s0 + j]))
                     for j in range(ns)]
            lst.append(Chain(pos=int(chain_pos[ci]), rid=int(chain_rid[ci]),
                             seqid=r, is_alt=bool(chain_alt[ci]),
                             seeds=seeds, w=int(out_w[oi]),
                             kept=int(out_kept[oi]),
                             frac_rep=float(chain_frac[ci])))
        out.append(lst)
    return out


def chain_seeds_batch_native(fm: FMIndex, opt, encs, smem_off, smem_m,
                             smem_n, smem_s, occ_off,
                             coords: np.ndarray) -> list[list[Chain]]:
    """mem_chain_seeds for a whole chunk via the C++ port (bit-identical to
    chain_seeds per read; parity-tested)."""
    (chain_off, chain_pos, chain_rid, chain_alt, chain_frac, chain_nseeds,
     seed_rbeg, seed_qbeg, seed_len) = _chain_seeds_arrays(
        fm, opt, encs, smem_off, smem_m, smem_n, smem_s, occ_off, coords)
    out: list[list[Chain]] = []
    sw = 0
    for r in range(len(encs)):
        lst = []
        for ci in range(int(chain_off[r]), int(chain_off[r + 1])):
            ns = int(chain_nseeds[ci])
            seeds = [Seed(rbeg=int(seed_rbeg[sw + j]),
                          qbeg=int(seed_qbeg[sw + j]),
                          len=int(seed_len[sw + j]),
                          score=int(seed_len[sw + j]))
                     for j in range(ns)]
            sw += ns
            lst.append(Chain(pos=int(chain_pos[ci]), rid=int(chain_rid[ci]),
                             seqid=r, is_alt=bool(chain_alt[ci]),
                             seeds=seeds,
                             frac_rep=float(chain_frac[ci])))
        out.append(lst)
    return out


def chain_seeds(fm: FMIndex, opt, seqid: int, l_seq: int,
                smems: list[tuple], coords: np.ndarray | None = None) -> list[Chain]:
    """SA-resolve SMEMs into seeds and chain them (mem_chain_seeds).

    smems: (rid, m, n, k, l, s) sorted by (m, n).  coords: optional
    pre-resolved SA entries for sa_positions(opt, smems) (device batch);
    resolved on the host when absent.  Returns chains in genome-position
    order (B-tree in-order traversal equivalent)."""
    if not smems or l_seq < opt.min_seed_len:
        return []
    l_pac = fm.l_pac
    coord_iter = iter(coords) if coords is not None else None

    # repeat fraction: coverage of the read by high-occurrence SMEMs
    b = e = l_rep = 0
    for (_, m, n, _, _, s) in smems:
        sb, se = m, n + 1
        if s <= opt.max_occ:
            continue
        if sb > e:
            l_rep += e - b
            b, e = sb, se
        else:
            e = max(e, se)
    l_rep += e - b

    chains: list[Chain] = []     # kept sorted by pos
    poslist: list[int] = []
    for (_, m, n, k, _, s) in smems:
        slen = n + 1 - m
        step = s // opt.max_occ if s > opt.max_occ else 1
        count = 0
        j = 0
        while j < s and count < opt.max_occ:
            rbeg = (int(next(coord_iter)) if coord_iter is not None
                    else fm.get_sa_entry(k + j))
            seed = Seed(rbeg=rbeg, qbeg=m, len=slen, score=slen)
            rid = fm.bns.intv2rid(rbeg, rbeg + slen)
            j += step
            count += 1
            if rid < 0:
                continue
            to_add = True
            if chains:
                # closest chain with pos <= rbeg (kb_intervalp lower)
                i = bisect_right(poslist, rbeg) - 1
                if i >= 0 and test_and_merge(opt, l_pac, chains[i], seed, rid):
                    to_add = False
            if to_add:
                c = Chain(pos=rbeg, rid=rid, seqid=seqid,
                          is_alt=bool(fm.bns.anns[rid].is_alt), seeds=[seed])
                i = bisect_right(poslist, rbeg)
                chains.insert(i, c)
                poslist.insert(i, rbeg)
    frac_rep = float(f32(f32(l_rep) / f32(l_seq)))
    for c in chains:
        c.frac_rep = frac_rep
    return chains


def chain_weight(c: Chain) -> int:
    """min(query-coverage, ref-coverage) (mem_chain_weight)."""
    w = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w += s.len
        elif s.qbeg + s.len > end:
            w += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    tmp, w, end = w, 0, 0
    for s in c.seeds:
        if s.rbeg >= end:
            w += s.len
        elif s.rbeg + s.len > end:
            w += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    w = min(w, tmp)
    return min(w, (1 << 30) - 1)


def chain_filter(opt, chains: list[Chain]) -> list[Chain]:
    """Drop light/shadowed chains (mem_chain_flt, single-read group)."""
    if not chains:
        return []
    kept0 = []
    for c in chains:
        c.first, c.kept = -1, 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            kept0.append(c)
    if not kept0:
        return []
    # ks_introsort(mem_flt): tie permutation must match the reference since
    # the "first shadowed" chain feeds MAPQ (see utils/ksort.py)
    a = kept0
    ks_introsort(a, lambda x, y: x.w > y.w)

    chains_idx = [0]
    a[0].kept = 3
    for i in range(1, len(a)):
        large_ovlp = False
        broke = False
        for j in chains_idx:
            b_max = max(a[j].seeds[0].qbeg, a[i].seeds[0].qbeg)
            e_min = min(a[j].seeds[-1].qbeg + a[j].seeds[-1].len,
                        a[i].seeds[-1].qbeg + a[i].seeds[-1].len)
            if e_min > b_max and (not a[j].is_alt or a[i].is_alt):
                li = (a[i].seeds[-1].qbeg + a[i].seeds[-1].len
                      - a[i].seeds[0].qbeg)
                lj = (a[j].seeds[-1].qbeg + a[j].seeds[-1].len
                      - a[j].seeds[0].qbeg)
                min_l = min(li, lj)
                if (f32(e_min - b_max) >= fmul(min_l, opt.mask_level)
                        and min_l < opt.max_chain_gap):
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if (f32(a[i].w) < fmul(a[j].w, opt.drop_ratio)
                            and a[j].w - a[i].w >= opt.min_seed_len << 1):
                        broke = True
                        break
        if not broke:
            chains_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in chains_idx:
        c = a[j]
        if c.first >= 0:
            a[c.first].kept = 1
    # cap the number of .kept=1/2 chains to extend (zeroing starts at the
    # chain that hit the cap, matching bwamem.cpp:597-603)
    k = 0
    i = 0
    while i < len(a):
        if a[i].kept in (1, 2):
            k += 1
            if k >= opt.max_chain_extend:
                break
        i += 1
    for i2 in range(i, len(a)):
        if a[i2].kept < 3:
            a[i2].kept = 0
    return [c for c in a if c.kept != 0]


def seed_sw_score(fm: FMIndex, opt, l_query: int, query: np.ndarray,
                  s: Seed) -> int:
    """Re-score a dubious seed with local SW (mem_seed_sw, bwamem.cpp:401-427)."""
    l_pac = fm.l_pac
    if s.len >= MEM_SHORT_LEN:
        return -1
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re = s.rbeg, s.rbeg + s.len
    mid = (rb + re) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, l_query)
    rb = max(rb - MEM_SHORT_EXT, 0)
    re = min(re + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return -1
    rseq, rid, rb, re = fm.fetch_seq(rb, mid, re)
    mat = np.array(opt.mat, dtype=np.int8)
    res = ksw_align(query[qb:qe], rseq, mat, opt.o_del, opt.e_del,
                    opt.o_ins, opt.e_ins, KSW_XSTART)
    return res[0]


def filter_chained_seeds(fm: FMIndex, opt, l_query: int, query: np.ndarray,
                         chains: list[Chain]) -> None:
    """Drop low-scoring short seeds inside chains (mem_flt_chained_seeds)."""
    for c in chains:
        min_l = (MEM_HSP_COEF * opt.min_chain_weight if opt.min_chain_weight
                 else MEM_MINSC_COEF * math.log(l_query))
        min_hsp_score = int(opt.a * min_l + 0.499)
        if min_l > MEM_SEEDSW_COEF * l_query:
            continue
        kept = []
        for s in c.seeds:
            s.score = seed_sw_score(fm, opt, l_query, query, s)
            if s.score < 0 or s.score >= min_hsp_score:
                s.score = s.len * opt.a if s.score < 0 else s.score
                kept.append(s)
        c.seeds = kept


def chain_and_filter_flat(fm: FMIndex, opt, encs, smem_off, smem_m,
                          smem_n, smem_s, occ_off, coords: np.ndarray):
    """mem_chain_seeds + mem_chain_flt with FLAT survivor arrays out — the
    input to the native extension stage (no Chain/Seed objects).

    Returns (chain_off, chain_rid, chain_alt, chain_frac, chain_nseeds,
    soff, seed_rbeg, seed_qbeg, seed_len) where chain_off is per-read over
    the surviving chains in final (sorted) order."""
    from ..native import chain_filter_batch
    (chain_off, chain_pos, chain_rid, chain_alt, chain_frac, chain_nseeds,
     seed_rbeg, seed_qbeg, seed_len) = _chain_seeds_arrays(
        fm, opt, encs, smem_off, smem_m, smem_n, smem_s, occ_off, coords)
    out_off, out_idx, out_w, out_kept = chain_filter_batch(
        chain_off, chain_alt, chain_nseeds, seed_rbeg, seed_qbeg,
        seed_len, opt)
    soff_all = np.zeros(len(chain_nseeds) + 1, np.int64)
    np.cumsum(chain_nseeds, out=soff_all[1:])
    n_out = int(out_off[-1])
    idx = out_idx[:n_out]
    ns = chain_nseeds[idx]
    soff = np.zeros(n_out + 1, np.int64)
    np.cumsum(ns, out=soff[1:])
    # gather the survivor chains' seed slices
    take = np.concatenate(
        [np.arange(soff_all[ci], soff_all[ci] + chain_nseeds[ci])
         for ci in idx]) if n_out else np.zeros(0, np.int64)
    return (np.ascontiguousarray(out_off, np.int64),
            np.ascontiguousarray(chain_rid[idx], np.int32),
            np.ascontiguousarray(chain_alt[idx], np.uint8),
            np.ascontiguousarray(chain_frac[idx], np.float32),
            np.ascontiguousarray(ns, np.int32),
            soff,
            np.ascontiguousarray(seed_rbeg[take], np.int64),
            np.ascontiguousarray(seed_qbeg[take], np.int32),
            np.ascontiguousarray(seed_len[take], np.int32))
