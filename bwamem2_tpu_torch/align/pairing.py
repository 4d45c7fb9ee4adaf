"""Paired-end processing: insert-size stats, pairing, mate rescue, PE SAM.

Mirrors src/bwamem_pair.cpp:
  mem_infer_dir    :58-65      mem_pestat   :81-148
  mem_matesw       :150-283    mem_pair     :285-346
  mem_sam_pe       :353-551
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..index.fmindex import FMIndex
from ..native import ksw_align
from ..options import (MEM_F_ALL, MEM_F_NOPAIRING, MEM_F_NO_RESCUE,
                       MEM_F_PRIMARY5)
from ..utils.f32 import f32, fmul
from ..utils.hashing import hash_64
from ..utils.profiling import PROF
from .extend import AlnReg
from . import finalize as fin

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0
KSW_XBYTE, KSW_XSTOP, KSW_XSUBO, KSW_XSTART = 0x10000, 0x20000, 0x40000, 0x80000
M_SQRT1_2 = 1.0 / math.sqrt(2.0)


@dataclass
class PEStat:
    low: int = 0
    high: int = 0
    failed: int = 1
    avg: float = 0.0
    std: float = 0.0


def infer_dir(l_pac: int, b1: int, b2: int) -> tuple[int, int]:
    """Orientation (FF=0 FR=1 RF=2 RR=3) and distance (mem_infer_dir)."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def _cal_sub(opt, r: list[AlnReg]) -> int:
    for j in range(1, len(r)):
        b_max = max(r[j].qb, r[0].qb)
        e_min = min(r[j].qe, r[0].qe)
        if e_min > b_max:
            min_l = min(r[j].qe - r[j].qb, r[0].qe - r[0].qb)
            if f32(e_min - b_max) >= fmul(min_l, opt.mask_level):
                return r[j].score
    return opt.min_seed_len * opt.a


def pestat(opt, l_pac: int, regs_per_read, verbose: int = 3) -> list[PEStat]:
    """Insert-size distribution per orientation (mem_pestat)."""
    import sys
    pes = [PEStat() for _ in range(4)]
    isize = [[] for _ in range(4)]
    n = len(regs_per_read)
    for i in range(n >> 1):
        r0 = regs_per_read[i << 1]
        r1 = regs_per_read[i << 1 | 1]
        if not r0 or not r1:
            continue
        if _cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if _cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, dist = infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    for d in range(4):
        r = pes[d]
        q = sorted(isize[d])
        if len(q) < MIN_DIR_CNT:
            r.failed = 1
            continue
        r.failed = 0
        p25 = q[int(0.25 * len(q) + 0.499)]
        p50 = q[int(0.50 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        r.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        vals = [x for x in q if r.low <= x <= r.high]
        r.avg = sum(vals) / len(vals)
        r.std = math.sqrt(sum((x - r.avg) ** 2 for x in vals) / len(vals))
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + 0.499)
        if r.high < r.avg + MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + 0.499)
        r.low = max(r.low, 1)
        if verbose >= 3:
            print(f"[PE] orientation {'FF FR RF RR'.split()[d]}: "
                  f"n={len(q)} mean={r.avg:.2f} std={r.std:.2f} "
                  f"bounds=({r.low},{r.high})", file=sys.stderr)
    mx = max(len(i) for i in isize)
    for d in range(4):
        if pes[d].failed == 0 and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = 1
    return pes


def matesw_window(opt, pes, r: int, a_rb: int, l_ms: int,
                  l_pac: int) -> tuple[int, int, bool]:
    """Rescue window geometry for orientation r (mem_matesw's rb/re)."""
    is_rev = (r >> 1) != (r & 1)
    is_larger = not (r >> 1)
    if not is_rev:
        rb = a_rb + pes[r].low if is_larger else a_rb - pes[r].high
        re = (a_rb + pes[r].high if is_larger else a_rb - pes[r].low) + l_ms
    else:
        rb = (a_rb + pes[r].low if is_larger else a_rb - pes[r].high) - l_ms
        re = a_rb + pes[r].high if is_larger else a_rb - pes[r].low
    return max(rb, 0), min(re, l_pac << 1), is_rev


def matesw(fm: FMIndex, opt, pes: list[PEStat], a: AlnReg, l_ms: int,
           ms: np.ndarray, ma: list[AlnReg], rescue: dict | None = None,
           rkey: tuple | None = None) -> int:
    """Mate rescue around one anchor hit (mem_matesw).

    When `rescue` holds a pre-batched device result for (rkey..., r) the
    SW call is skipped (mem_sam_pe_batch consumption, bwamem_pair.cpp:713);
    results are bit-identical either way.  A lookup that misses a given
    `rescue` is counted as `overflow.rescue_miss`."""
    l_pac = fm.l_pac
    skip = [p.failed != 0 for p in pes]
    for reg in ma:
        r, dist = infer_dir(l_pac, a.rb, reg.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = True
    if all(skip):
        return 0
    n = 0
    mat = np.array(opt.mat, np.int8)
    for r in range(4):
        if skip[r]:
            continue
        rb, re, is_rev = matesw_window(opt, pes, r, a.rb, l_ms, l_pac)
        rid = -1
        ref = None
        if rb < re:
            ref, rid, rb, re = fm.fetch_seq(rb, (rb + re) >> 1, re)
        if a.rid == rid and re - rb >= opt.min_seed_len:
            res = rescue.get(rkey + (r,)) if rescue is not None else None
            if res is None:
                if rescue is not None:
                    PROF.count("overflow.rescue_miss")
                if is_rev:
                    seq = np.array(
                        [3 - int(c) if c < 4 else 4 for c in ms[::-1]],
                        np.uint8)
                else:
                    seq = ms
                xtra = (KSW_XSUBO | KSW_XSTART
                        | (KSW_XBYTE if l_ms * opt.a < 250 else 0)
                        | (opt.min_seed_len * opt.a))
                res = ksw_align(
                    seq, np.ascontiguousarray(ref), mat, opt.o_del,
                    opt.e_del, opt.o_ins, opt.e_ins, xtra)
            score, te, qe, score2, te2, tb, qb = (int(v) for v in res)
            if score >= opt.min_seed_len and qb >= 0:
                b = AlnReg(rid=a.rid, is_alt=a.is_alt, score=score,
                           csub=score2, secondary=-1)
                b.qb = l_ms - (qe + 1) if is_rev else qb
                b.qe = l_ms - qb if is_rev else qe + 1
                b.rb = ((l_pac << 1) - (rb + te + 1)) if is_rev else rb + tb
                b.re = ((l_pac << 1) - (rb + tb)) if is_rev else rb + te + 1
                b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                # insert keeping ma sorted by score
                ins = len(ma)
                for i in range(len(ma)):
                    if ma[i].score < b.score:
                        ins = i
                        break
                ma.insert(ins, b)
            n += 1
        if n:
            ma[:] = fin.sort_dedup_patch(fm, opt, None, ma)
    return n


def batch_rescue_pre(fm: FMIndex, opt, pes, regs_per_read, encs,
                     L: int) -> tuple[dict, list]:
    """Collect every mate-rescue SW problem of a chunk up front
    (mem_sam_pe_batch_pre / mem_matesw_batch_pre, bwamem_pair.cpp:553-602,
    930-1093): a SUPERSET keyed (pair_idx, end, anchor_j, r) — the
    sequential skip rules in matesw only grow as rescued hits are inserted,
    so problems skipped at runtime simply leave their batch result unused.

    A mate longer than the read grid's width L (ops/backend.py:
    grid_read_cap) has no grid row to read its query from; its problems
    stay out of the batch.

    Returns (descriptor dict for TorchBackend.rescue_batch, which scores
    it with ops/kswv.py:DeviceKswv.align_batch, keys)."""
    l_pac = fm.l_pac
    keys: list[tuple] = []
    qoff, qdir, qcomp, qlen = [], [], [], []
    toff, tlen, u8 = [], [], []
    if opt.flag & MEM_F_NO_RESCUE or all(p.failed for p in pes):
        return {}, []
    for p in range(len(encs) >> 1):
        a = [regs_per_read[p << 1], regs_per_read[p << 1 | 1]]
        if not a[0] and not a[1]:
            continue
        b = rescue_anchors(opt, a)
        for i in range(2):
            mate_row = (p << 1) | (not i)
            l_ms = len(encs[mate_row])
            if l_ms > L:    # not on the read grid: matesw rescues on the host
                continue
            for j, breg in enumerate(b[i]):
                if j >= opt.max_matesw:
                    break
                skip = [pe.failed != 0 for pe in pes]
                for reg in a[not i]:
                    r, dist = infer_dir(l_pac, breg.rb, reg.rb)
                    if pes[r].low <= dist <= pes[r].high:
                        skip[r] = True
                for r in range(4):
                    if skip[r]:
                        continue
                    rb, re, is_rev = matesw_window(opt, pes, r, breg.rb,
                                                   l_ms, l_pac)
                    if rb >= re:
                        continue
                    _, rid, rb, re = fm.fetch_seq(rb, (rb + re) >> 1, re)
                    if breg.rid != rid or re - rb < opt.min_seed_len:
                        continue
                    keys.append((p, i, j, r))
                    qoff.append(mate_row * L + (l_ms - 1 if is_rev else 0))
                    qdir.append(-1 if is_rev else 1)
                    qcomp.append(is_rev)
                    qlen.append(l_ms)
                    toff.append(rb)
                    tlen.append(re - rb)
                    u8.append(l_ms * opt.a < 250)
    if not keys:
        return {}, []
    desc = dict(qoff=np.array(qoff, np.int32),
                qdir=np.array(qdir, np.int32),
                qcomp=np.array(qcomp, bool),
                qlen=np.array(qlen, np.int32),
                toff=np.array(toff, np.int64),
                tlen=np.array(tlen, np.int32),
                u8=np.array(u8, bool))
    return desc, keys


def mem_pair(fm: FMIndex, opt, pes: list[PEStat], a, read_id: int,
             n_pri) -> tuple[int, int, int, list[int]]:
    """Pair the two ends' hits (mem_pair); returns (o, subo, n_sub, z)."""
    l_pac = fm.l_pac
    v = []
    for r in range(2):
        for i in range(n_pri[r]):
            e = a[r][i]
            x = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            key_x = (e.rid << 32) | (x - fm.bns.anns[e.rid].offset)
            key_y = (e.score << 32) | (i << 2) | ((e.rb >= l_pac) << 1) | r
            v.append((key_x, key_y))
    v.sort()
    y = [-1, -1, -1, -1]
    u = []
    for i in range(len(v)):
        for r in range(2):
            dr = (r << 1) | ((v[i][1] >> 1) & 1)
            if pes[dr].failed:
                continue
            which = (r << 1) | ((v[i][1] & 1) ^ 1)
            if y[which] < 0:
                continue
            for k in range(y[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[dr].high:
                    break
                if dist < pes[dr].low:
                    continue
                ns = (dist - pes[dr].avg) / pes[dr].std
                q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                        + 0.721 * math.log(2.0 * math.erfc(abs(ns) * M_SQRT1_2))
                        * opt.a + 0.499)
                q = max(q, 0)
                uy = (k << 32) | i
                ux = (q << 32) | (hash_64(uy ^ (read_id << 8))
                                  & 0xFFFFFFFF)
                u.append((ux, uy))
        y[v[i][1] & 3] = i
    if not u:
        return 0, 0, 0, [-1, -1]
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    u.sort()
    i = u[-1][1] >> 32
    k = u[-1][1] & 0xFFFFFFFF
    z = [-1, -1]
    # C: (y<<32)>>34 on uint64 keeps bits 2..31 of y — the hit index
    z[v[i][1] & 1] = (v[i][1] & 0xFFFFFFFF) >> 2
    z[v[k][1] & 1] = (v[k][1] & 0xFFFFFFFF) >> 2
    o = u[-1][0] >> 32
    sub = (u[-2][0] >> 32) if len(u) > 1 else 0
    n_sub = 0
    for i2 in range(len(u) - 2, -1, -1):
        if sub - (u[i2][0] >> 32) <= tmp:
            n_sub += 1
    return o, sub, n_sub, z


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


def rescue_anchors(opt, a) -> list[list[AlnReg]]:
    """Anchor candidates for mate rescue, snapshotted for BOTH ends before
    any rescue mutates the other end's region list (bwamem_pair.cpp:380-385).
    """
    return [[reg for reg in a[i]
             if reg.score >= a[i][0].score - opt.pen_unpaired]
            if a[i] else [] for i in range(2)]


def sam_pe(fm: FMIndex, opt, pes: list[PEStat], pair_id: int, reads, encs,
           regs2, rg_id=None, rescue: dict | None = None,
           pair_idx: int | None = None) -> int:
    """mem_sam_pe: rescue + pair + SAM for one read pair.

    `rescue` is the chunk-wide pre-batched device SW cache keyed
    (pair_idx, end, anchor_j, r) — mem_sam_pe_batch_post's consumption
    (bwamem_pair.cpp:713); absent entries run the native scalar kernel."""
    s = reads
    a = regs2
    n = 0
    extra_flag = 1
    if not (opt.flag & MEM_F_NO_RESCUE):
        b = rescue_anchors(opt, a)
        for i in range(2):
            for j, breg in enumerate(b[i]):
                if j >= opt.max_matesw:
                    break
                n += matesw(fm, opt, pes, breg, len(encs[not i]),
                            encs[not i], a[not i], rescue=rescue,
                            rkey=(pair_idx, i, j) if rescue is not None
                            else None)
    n_pri = [0, 0]
    for i in range(2):
        a[i], n_pri[i] = fin.mark_primary(opt, a[i], (pair_id << 1) | i)
    if opt.flag & MEM_F_PRIMARY5:
        fin.reorder_primary5(opt.T, a[0])
        fin.reorder_primary5(opt.T, a[1])

    if not (opt.flag & MEM_F_NOPAIRING) and n_pri[0] and n_pri[1]:
        o, subo, n_sub, z = mem_pair(fm, opt, pes, a, pair_id, n_pri)
        if o > 0:
            # multiple primary hits on either end -> no pairing
            is_multi = [False, False]
            for i in range(2):
                for j in range(1, n_pri[i]):
                    if a[i][j].secondary < 0 and a[i][j].score >= opt.T:
                        is_multi[i] = True
                        break
            if not (is_multi[0] or is_multi[1]):
                score_un = a[0][0].score + a[1][0].score - opt.pen_unpaired
                subo = max(subo, score_un)
                q_pe = raw_mapq(o - subo, opt.a)
                if n_sub > 0:
                    q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
                q_pe = min(max(q_pe, 0), 60)
                q_pe = int(q_pe * (1.0 - 0.5 * (a[0][0].frac_rep
                                                + a[1][0].frac_rep)) + 0.499)
                if o > score_un:  # paired alignment preferred
                    c = [a[0][z[0]], a[1][z[1]]]
                    q_se = [0, 0]
                    for i in range(2):
                        if c[i].secondary >= 0:
                            c[i].sub = a[i][c[i].secondary].score
                            c[i].secondary = -2
                        q_se[i] = fin.approx_mapq(opt, c[i])
                    for i in range(2):
                        q_se[i] = (q_se[i] if q_se[i] > q_pe
                                   else min(q_pe, q_se[i] + 40))
                        cap = raw_mapq(c[i].score - c[i].csub, opt.a)
                        q_se[i] = min(q_se[i], cap)
                    extra_flag |= 2
                else:
                    z = [0, 0]
                    q_se = [fin.approx_mapq(opt, a[0][0]),
                            fin.approx_mapq(opt, a[1][0])]
                # swap secondary and primary if both non-ALT
                for i in range(2):
                    k = a[i][z[i]].secondary_all
                    if 0 <= k < n_pri[i]:
                        assert a[i][k].secondary_all < 0
                        for j in range(len(a[i])):
                            if a[i][j].secondary_all == k or j == k:
                                a[i][j].secondary_all = z[i]
                        a[i][z[i]].secondary_all = -1
                XA = [None, None]
                if not (opt.flag & MEM_F_ALL):
                    for i in range(2):
                        XA[i] = fin.gen_alt(fm, opt, a[i], len(encs[i]),
                                            encs[i])
                h = [None, None]
                g = [None, None]
                aa = [[], []]
                for i in range(2):
                    h[i] = fin.reg2aln(fm, opt, len(encs[i]), encs[i],
                                       a[i][z[i]])
                    h[i].mapq = q_se[i]
                    h[i].flag |= (0x40 << i) | extra_flag
                    h[i].XA = XA[i][z[i]] if XA[i] else None
                    aa[i].append(h[i])
                    if n_pri[i] < len(a[i]):
                        p = a[i][n_pri[i]]
                        if (p.score >= opt.T and p.secondary < 0
                                and p.is_alt):
                            g[i] = fin.reg2aln(fm, opt, len(encs[i]),
                                               encs[i], p)
                            g[i].flag |= 0x800 | (0x40 << i) | extra_flag
                            g[i].XA = XA[i][n_pri[i]] if XA[i] else None
                            aa[i].append(g[i])
                s[0].sam = "".join(
                    fin.aln2sam(fm, opt, s[0], len(aa[0]), aa[0], i, h[1],
                                rg_id) for i in range(len(aa[0])))
                s[1].sam = "".join(
                    fin.aln2sam(fm, opt, s[1], len(aa[1]), aa[1], i, h[0],
                                rg_id) for i in range(len(aa[1])))
                if s[0].name != s[1].name:
                    raise RuntimeError("paired reads have different names")
                return n

    # no_pairing path
    h = [None, None]
    for i in range(2):
        which = -1
        if a[i]:
            if a[i][0].score >= opt.T:
                which = 0
            elif n_pri[i] < len(a[i]) and a[i][n_pri[i]].score >= opt.T:
                which = n_pri[i]
        h[i] = fin.reg2aln(fm, opt, len(encs[i]), encs[i],
                           a[i][which] if which >= 0 else None)
    if (not (opt.flag & MEM_F_NOPAIRING) and h[0].rid == h[1].rid
            and h[0].rid >= 0 and a[0] and a[1]):
        d, dist = infer_dir(fm.l_pac, a[0][0].rb, a[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    s[0].sam = fin.reg2sam(fm, opt, s[0], encs[0], a[0], 0x41 | extra_flag,
                           h[1], rg_id)
    s[1].sam = fin.reg2sam(fm, opt, s[1], encs[1], a[1], 0x81 | extra_flag,
                           h[0], rg_id)
    return n
