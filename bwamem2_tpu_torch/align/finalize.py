"""Region post-processing and SAM record generation.

Mirrors (all in the reference's src/):
  mem_sort_dedup_patch / mem_patch_reg   bwamem.cpp:292-353 / 175-225
  mem_mark_primary_se (+_core)           bwamem.cpp:1392-1464
  mem_approx_mapq_se                     bwamem.cpp:1470-1494
  mem_reorder_primary5                   bwamem.cpp:1496-1518
  mem_reg2aln + bwa_gen_cigar2           bwamem.cpp:1732-1805, bwa.cpp:260-347
  mem_aln2sam / mem_reg2sam              bwamem.cpp:1592-1730 / 1521-1577
  mem_gen_alt (XA tag)                   bwamem_extra.cpp:122-183
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field, replace as dc_replace

import numpy as np

from ..index.fmindex import FMIndex
from ..native import ksw_global
from ..options import (MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NO_MULTI,
                       MEM_F_PRIMARY5, MEM_F_REF_HDR, MEM_F_SOFTCLIP)
from ..utils.f32 import f32, fmul
from ..utils.hashing import hash_64
from ..utils.ksort import ks_introsort
from .extend import AlnReg

PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90
MEM_MAPQ_COEF = 30.0
INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# CIGAR generation
# ---------------------------------------------------------------------------

def gen_cigar(fm: FMIndex, opt, l_query: int, query: np.ndarray, rb: int,
              re: int, w_: int, want_cigar: bool = True):
    """bwa_gen_cigar2: global alignment between fixed endpoints.

    Returns (score, cigar list [(len, op)], NM, MD) — cigar/NM/MD None when
    want_cigar is False.  op ints: 0=M 1=I 2=D 3=S 4=H."""
    if l_query <= 0 or rb >= re or (rb < fm.l_pac < re):
        return None
    rseq = fm.get_seq(rb, re)
    rlen = len(rseq)
    if re - rb != rlen:
        return None
    query = query[:l_query]
    if rb >= fm.l_pac:  # reverse both so indels left-shift on the fwd strand
        query = query[::-1]
        rseq = rseq[::-1]
    query = np.ascontiguousarray(query)
    rseq = np.ascontiguousarray(rseq)
    mat = np.array(opt.mat, np.int8)

    if l_query == re - rb and w_ == 0:
        cigar = [(l_query, 0)]
        score = int(mat[rseq.astype(np.int32) * 5
                        + query.astype(np.int32)].astype(np.int32).sum())
        n_cigar = 1
    else:
        max_ins = int((((l_query + 1) >> 1) * opt.mat[0] - opt.o_ins)
                      / opt.e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * opt.mat[0] - opt.o_del)
                      / opt.e_del + 1.0)
        max_gap = max(max(max_ins, max_del), 1)
        w = (max_gap + abs(rlen - l_query) + 1) >> 1
        w = min(w, w_)
        min_w = abs(rlen - l_query) + 3
        w = max(w, min_w)
        score, cig = ksw_global(query, rseq, mat, opt.o_del, opt.e_del,
                                opt.o_ins, opt.e_ins, w,
                                traceback=want_cigar)
        if not want_cigar:
            return int(score), None, None, None
        cigar = [(int(c) >> 4, int(c) & 0xF) for c in cig]
        n_cigar = len(cigar)

    # NM + MD (bwa.cpp:309-339)
    NM = None
    MD = None
    if n_cigar:
        int2base = "ACGTN" if rb < fm.l_pac else "TGCAN"
        x = y = u = 0
        n_mm = n_gap = 0
        md = []
        for k, (ln, op) in enumerate(cigar):
            if op == 0:
                mism = np.flatnonzero(query[x:x + ln] != rseq[y:y + ln])
                prev = -1
                for i in mism.tolist():
                    md.append(str(u + i if prev < 0 else i - prev - 1))
                    md.append(int2base[int(rseq[y + i])])
                    prev = i
                n_mm += len(mism)
                u = (u + ln if prev < 0 else ln - prev - 1)
                x += ln
                y += ln
            elif op == 2:
                if 0 < k < n_cigar - 1:
                    md.append(str(u))
                    md.append("^")
                    md.extend(int2base[int(rseq[y + i])] for i in range(ln))
                    u = 0
                    n_gap += ln
                y += ln
            elif op == 1:
                x += ln
                n_gap += ln
        md.append(str(u))
        NM = n_mm + n_gap
        MD = "".join(md)
    return int(score), cigar, NM, MD


# ---------------------------------------------------------------------------
# De-overlap / merge colinear split hits
# ---------------------------------------------------------------------------

def patch_reg(fm: FMIndex, opt, query: np.ndarray, a: AlnReg, b: AlnReg):
    """mem_patch_reg: test whether two colinear hits merge; returns
    (score, w) or None."""
    if query is None:
        return None
    assert a.rid == b.rid and a.rb <= b.rb
    if a.rb < fm.l_pac and b.rb >= fm.l_pac:
        return None
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return None
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if getattr(opt, "verbose", 3) >= 4:   # bwamem.cpp:191-195, verbatim
        sys.stderr.write(
            "* potential hit merge between [%d,%d)<=>[%ld,%ld) and "
            "[%d,%d)<=>[%ld,%ld), @ %s; w=%d, r=%.4g\n"
            % (a.qb, a.qe, a.rb, a.re, b.qb, b.qe, b.rb, b.re,
               fm.bns.anns[a.rid].name, w, r))
    if a.re < b.rb or a.qe < b.qb:
        if w > opt.w << 1 or r >= PATCH_MAX_R_BW:
            return None
    elif w > opt.w << 2 or r >= PATCH_MAX_R_BW * 2:
        return None
    w += a.w + b.w
    w = min(w, opt.w << 2)
    if getattr(opt, "verbose", 3) >= 4:   # bwamem.cpp:206-207
        sys.stderr.write("* test potential hit merge with global "
                         "alignment; w=%d\n" % w)
    res = gen_cigar(fm, opt, b.qe - a.qb, query[a.qb:], a.rb, b.re, w,
                    want_cigar=False)
    if res is None:
        return None
    score = res[0]
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb))
              * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb))
              * (b.score + a.score) + 0.499)
    if getattr(opt, "verbose", 3) >= 4:   # bwamem.cpp:219-220
        sys.stderr.write("* score=%d;(%d,%d)\n" % (score, q_s, r_s))
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return None
    return score, w


def sort_dedup_patch(fm: FMIndex, opt, query: np.ndarray | None,
                     regs: list[AlnReg]) -> list[AlnReg]:
    """mem_sort_dedup_patch (bwamem.cpp:292-353)."""
    n = len(regs)
    if n <= 1:
        return regs
    a = list(regs)
    ks_introsort(a, lambda x, y: x.re < y.re)  # mem_ars2: sort by END
    for r in a:
        r.n_comp = 1
    for i in range(1, n):
        p = a[i]
        if p.rid != a[i - 1].rid or p.rb >= a[i - 1].re + opt.max_chain_gap:
            continue
        for j in range(i - 1, -1, -1):
            q = a[j]
            if p.rid != q.rid or p.rb >= q.re + opt.max_chain_gap:
                break
            if q.qe == q.qb:
                continue
            or_ = q.re - p.rb
            oq = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            mr = min(q.re - q.rb, p.re - p.rb)
            mq = min(q.qe - q.qb, p.qe - p.qb)
            if (f32(or_) > fmul(mr, opt.mask_level_redun)
                    and f32(oq) > fmul(mq, opt.mask_level_redun)):
                if p.score < q.score:
                    p.qe = p.qb
                    break
                q.qe = q.qb
            elif q.rb < p.rb and query is not None:
                pr = patch_reg(fm, opt, query, q, p)
                if pr is not None:
                    score, w = pr
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb, p.rb = q.qb, q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qb = q.qe
    a = [r for r in a if r.qe > r.qb]
    # alnreg_slt via ks_introsort (tie permutation preserved)
    ks_introsort(a, lambda x, y: (x.score > y.score
                                  or (x.score == y.score
                                      and (x.rb < y.rb
                                           or (x.rb == y.rb and x.qb < y.qb)))))
    for i in range(1, len(a)):
        if (a[i].score == a[i - 1].score and a[i].rb == a[i - 1].rb
                and a[i].qb == a[i - 1].qb):
            a[i].qe = a[i].qb
    out = [a[0]] if a else []
    out.extend(r for r in a[1:] if r.qe > r.qb)
    return out


# ---------------------------------------------------------------------------
# Primary marking / MAPQ
# ---------------------------------------------------------------------------

def _mark_primary_core(opt, a: list[AlnReg], n: int) -> None:
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z: list[int] = [0]
    for i in range(1, n):
        matched = None
        for k in z:
            b_max = max(a[k].qb, a[i].qb)
            e_min = min(a[k].qe, a[i].qe)
            if e_min > b_max:
                min_l = min(a[i].qe - a[i].qb, a[k].qe - a[k].qb)
                if f32(e_min - b_max) >= fmul(min_l, opt.mask_level):
                    if a[k].sub == 0:
                        a[k].sub = a[i].score
                    if (a[k].score - a[i].score <= tmp
                            and (a[k].is_alt or not a[i].is_alt)):
                        a[k].sub_n += 1
                    matched = k
                    break
        if matched is None:
            z.append(i)
        else:
            a[i].secondary = matched


def mark_primary(opt, regs: list[AlnReg], read_id: int) -> tuple[list[AlnReg], int]:
    """mem_mark_primary_se; returns (sorted regs, n_pri)."""
    n = len(regs)
    if n == 0:
        return regs, 0
    n_pri = 0
    for i, r in enumerate(regs):
        r.sub = r.alt_sc = 0
        r.secondary = r.secondary_all = -1
        r.hash = hash_64(read_id + i)
        if not r.is_alt:
            n_pri += 1
    # sort: score desc, is_alt asc, hash asc  (alnreg_hlt)
    a = sorted(regs, key=lambda r: (-r.score, r.is_alt, r.hash))
    _mark_primary_core(opt, a, n)
    for i, p in enumerate(a):
        p.secondary_all = i  # rank in the first round
        if not p.is_alt and p.secondary >= 0 and a[p.secondary].is_alt:
            p.alt_sc = a[p.secondary].score
    if 0 <= n_pri < n:
        z = [0] * n
        if n_pri > 0:
            # alnreg_hlt2: is_alt asc, then score desc, then hash
            a = sorted(a, key=lambda r: (r.is_alt, -r.score, r.hash))
        for i in range(n):
            z[a[i].secondary_all] = i
        for i in range(n):
            if a[i].secondary >= 0:
                a[i].secondary_all = z[a[i].secondary]
                if a[i].is_alt:
                    a[i].secondary = INT_MAX
            else:
                a[i].secondary_all = -1
        if n_pri > 0:
            for i in range(n_pri):
                a[i].sub = 0
                a[i].secondary = -1
            _mark_primary_core(opt, a, n_pri)
    else:
        for r in a:
            r.secondary_all = r.secondary
    return a, n_pri


def approx_mapq(opt, a: AlnReg) -> int:
    """mem_approx_mapq_se (bwamem.cpp:1470-1494)."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    ln = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (ln * opt.a - a.score) / (opt.a + opt.b) / ln
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if ln < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(ln)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(MEM_MAPQ_COEF * (1.0 - sub / a.score)
                   * math.log(a.seedcov) + 0.499)
        if identity < 0.95:
            mapq = int(mapq * identity * identity + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    return int(mapq * (1.0 - a.frac_rep) + 0.499)


def reorder_primary5(T: int, a: list[AlnReg]) -> None:
    """mem_reorder_primary5: put the leftmost primary hit first (-5 flag)."""
    n_pri = sum(1 for r in a
                if r.secondary < 0 and not r.is_alt and r.score >= T)
    if n_pri <= 1:
        return
    left_st, left_k = INT_MAX, -1
    for k, p in enumerate(a):
        if p.secondary >= 0 or p.is_alt or p.score < T:
            continue
        if p.qb < left_st:
            left_st, left_k = p.qb, k
    if left_k == 0:
        return
    a[0], a[left_k] = a[left_k], a[0]
    for k in range(1, len(a)):
        p = a[k]
        if p.secondary == 0:
            p.secondary = left_k
        elif p.secondary == left_k:
            p.secondary = 0
        if p.secondary_all == 0:
            p.secondary_all = left_k
        elif p.secondary_all == left_k:
            p.secondary_all = 0


# ---------------------------------------------------------------------------
# AlnReg -> mem_aln_t (position + CIGAR)
# ---------------------------------------------------------------------------

@dataclass(slots=True)
class Aln:
    """mem_aln_t analog."""
    pos: int = -1
    rid: int = -1
    flag: int = 0
    is_rev: bool = False
    is_alt: bool = False
    mapq: int = 0
    NM: int = -1
    cigar: list = field(default_factory=list)  # [(len, op)] op: MIDSH=01234
    MD: str = ""
    score: int = -1
    sub: int = -1
    alt_sc: int = 0
    XA: str | None = None


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def reg2aln(fm: FMIndex, opt, l_query: int, query: np.ndarray,
            ar: AlnReg | None) -> Aln:
    """mem_reg2aln (bwamem.cpp:1732-1805)."""
    a = Aln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        # mem_reg2aln memsets the record: score/sub/NM all read back as 0
        a.rid, a.pos, a.flag = -1, -1, 0x4
        a.score, a.sub, a.NM = 0, 0, 0
        return a
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    a.mapq = approx_mapq(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    w2 = max(infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del),
             infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins))
    if getattr(opt, "verbose", 3) >= 4:   # bwamem.cpp:1755
        sys.stderr.write("* Band width: inferred=%d, cmd_opt=%d, "
                         "alnreg=%d\n" % (w2, opt.w, ar.w))
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    last_sc = -(1 << 30)
    i = 0
    cigar, NM, MD, score = None, -1, "", 0
    while True:
        w2 = min(w2, opt.w << 2)
        res = gen_cigar(fm, opt, qe - qb, query[qb:], rb, re, w2)
        assert res is not None
        score, cigar, NM, MD = res
        if getattr(opt, "verbose", 3) >= 4:   # bwamem.cpp:1762
            sys.stderr.write("* Final alignment: w2=%d, global_sc=%d, "
                             "local_sc=%d\n" % (w2, score, ar.truesc))
        if score == last_sc or w2 == opt.w << 2:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < ar.truesc - opt.a):
            break
    pos_f, is_rev = fm.bns.depos(rb if rb < fm.l_pac else re - 1)
    a.is_rev = is_rev
    if cigar:
        # squeeze out leading or trailing deletions
        if cigar[0][1] == 2:
            pos_f += cigar[0][0]
            cigar = cigar[1:]
        elif cigar[-1][1] == 2:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:  # soft clipping
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [(clip5, 3)] + cigar
        if clip3:
            cigar = cigar + [(clip3, 3)]
    a.rid = fm.bns.pos2rid(pos_f)
    assert a.rid == ar.rid
    a.pos = pos_f - fm.bns.anns[a.rid].offset
    a.cigar = cigar or []
    a.NM = NM
    a.MD = MD
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = bool(ar.is_alt)
    a.alt_sc = ar.alt_sc
    return a


# ---------------------------------------------------------------------------
# XA alt-hit strings
# ---------------------------------------------------------------------------

def gen_alt(fm: FMIndex, opt, regs: list[AlnReg], l_query: int,
            query: np.ndarray) -> list[str | None]:
    """mem_gen_alt: XA strings per region (only valid after mark_primary)."""
    n = len(regs)
    XA: list[str | None] = [None] * n

    def pri_idx(i):
        # get_pri_idx takes XA_drop_ratio as a double: the float 0.8f is
        # widened to 0.800000011920929 and the product computed in double
        k = regs[i].secondary_all
        if k >= 0 and regs[i].score >= regs[k].score * float(f32(opt.XA_drop_ratio)):
            return k
        return -1

    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = pri_idx(i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if regs[i].is_alt:
                has_alt[r] = True
    if tot == 0:
        return XA
    aln_strs: list[list[str]] = [[] for _ in range(n)]
    for i in range(n):
        r = pri_idx(i)
        if r < 0:
            continue
        if cnt[r] > opt.max_XA_hits_alt or (not has_alt[r]
                                            and cnt[r] > opt.max_XA_hits):
            continue
        t = reg2aln(fm, opt, l_query, query, regs[i])
        s = [fm.bns.anns[t.rid].name, ",", "+-"[t.is_rev], str(t.pos + 1), ","]
        for ln, op in t.cigar:
            s.append(str(ln))
            s.append("MIDSHN"[op])
        s.append(f",{t.NM};")
        aln_strs[r].append("".join(s))
    for k in range(n):
        if aln_strs[k]:
            XA[k] = "".join(aln_strs[k])
    return XA


# ---------------------------------------------------------------------------
# SAM output
# ---------------------------------------------------------------------------

def get_rlen(cigar) -> int:
    return sum(ln for ln, op in cigar if op in (0, 2))


def _cigar_str(opt, p: Aln, which: int) -> str:
    if not p.cigar:
        return "*"
    out = []
    for ln, op in p.cigar:
        c = op
        if not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt and c in (3, 4):
            c = 4 if which else 3
        out.append(f"{ln}{'MIDSH'[c]}")
    return "".join(out)


COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
# 256-entry translate table: COMP with everything else -> N (matches the
# per-char COMP.get(c, "N") of mem_aln2sam's revcomp loop, but in C speed)
RC_TABLE = str.maketrans({chr(i): COMP.get(chr(i), "N") for i in range(256)})
NT_CHR = "ACGTN"
NT_CHR_RC = "TGCAN"


def aln2sam(fm: FMIndex, opt, read, n: int, alns: list[Aln], which: int,
            m_: Aln | None, rg_id: str | None = None) -> str:
    """mem_aln2sam: one SAM line (bwamem.cpp:1592-1730)."""
    p = dc_replace(alns[which])
    m = dc_replace(m_) if m_ is not None else None
    p.flag |= 0x1 if m else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m and m.rid < 0) else 0
    if p.rid < 0 and m and m.rid >= 0:  # copy mate position
        p.rid, p.pos, p.is_rev, p.cigar = m.rid, m.pos, m.is_rev, []
    if m and m.rid < 0 and p.rid >= 0:
        m.rid, m.pos, m.is_rev, m.cigar = p.rid, p.pos, p.is_rev, []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m and m.is_rev) else 0

    seq, qual, name = read.seq, read.qual, read.name
    out = [name, "\t", str((p.flag & 0xFFFF) | (0x100 if p.flag & 0x10000 else 0))]
    if p.rid >= 0:
        out += ["\t", fm.bns.anns[p.rid].name, "\t", str(p.pos + 1), "\t",
                str(p.mapq), "\t", _cigar_str(opt, p, which)]
    else:
        out += ["\t*\t0\t0\t*"]
    # mate position
    if m and m.rid >= 0:
        out.append("\t")
        out.append("=" if p.rid == m.rid else fm.bns.anns[m.rid].name)
        out += ["\t", str(m.pos + 1), "\t"]
        if p.rid == m.rid:
            p0 = p.pos + (get_rlen(p.cigar) - 1 if p.is_rev else 0)
            p1 = m.pos + (get_rlen(m.cigar) - 1 if m.is_rev else 0)
            if not m.cigar or not p.cigar:
                out.append("0")
            else:
                out.append(str(-(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))))
        else:
            out.append("0")
    else:
        out.append("\t*\t0\t0")
    out.append("\t")

    # SEQ/QUAL
    if p.flag & 0x100:
        out.append("*\t*")
    else:
        qb, qe = 0, len(seq)
        clip_ok = (p.cigar and which and not (opt.flag & MEM_F_SOFTCLIP)
                   and not p.is_alt)
        if not p.is_rev:
            if clip_ok:
                if p.cigar[0][1] in (3, 4):
                    qb += p.cigar[0][0]
                if p.cigar[-1][1] in (3, 4):
                    qe -= p.cigar[-1][0]
            out.append(seq[qb:qe])
            out.append("\t")
            out.append(qual[qb:qe] if qual else "*")
        else:
            if clip_ok:
                if p.cigar[0][1] in (3, 4):
                    qe -= p.cigar[0][0]
                if p.cigar[-1][1] in (3, 4):
                    qb += p.cigar[-1][0]
            out.append(seq[qb:qe].translate(RC_TABLE)[::-1])
            out.append("\t")
            out.append(qual[qb:qe][::-1] if qual else "*")

    # tags
    if p.cigar:
        out.append(f"\tNM:i:{p.NM}\tMD:Z:{p.MD}")
    if m and m.cigar:
        out.append("\tMC:Z:")
        out.append(_cigar_str(opt, m, which))
    if p.score >= 0:
        out.append(f"\tAS:i:{p.score}")
    if p.sub >= 0:
        out.append(f"\tXS:i:{p.sub}")
    if rg_id:
        out.append(f"\tRG:Z:{rg_id}")
    if not (p.flag & 0x100):
        others = [i for i in range(n)
                  if i != which and not (alns[i].flag & 0x100)]
        if others:
            out.append("\tSA:Z:")
            for i in range(n):
                if i == which or (alns[i].flag & 0x100):
                    continue
                r = alns[i]
                out.append(fm.bns.anns[r.rid].name)
                out.append(f",{r.pos + 1},{'+-'[r.is_rev]},")
                out.append("".join(f"{ln}{'MIDSH'[op]}" for ln, op in r.cigar))
                out.append(f",{r.mapq},{r.NM};")
        if p.alt_sc > 0:
            out.append(f"\tpa:f:{p.score / p.alt_sc:.3f}")
    if p.XA:
        out.append(f"\tXA:Z:{p.XA}")
    if read.comment:
        out.append("\t")
        out.append(read.comment)
    if (opt.flag & MEM_F_REF_HDR) and p.rid >= 0 and fm.bns.anns[p.rid].anno:
        out.append("\tXR:Z:")
        out.append(fm.bns.anns[p.rid].anno.replace("\t", " "))
    out.append("\n")
    return "".join(out)


def reg2sam(fm: FMIndex, opt, read, enc: np.ndarray, regs: list[AlnReg],
            extra_flag: int, m_: Aln | None, rg_id: str | None = None) -> str:
    """mem_reg2sam (bwamem.cpp:1521-1577)."""
    l_query = len(enc)
    XA = None
    if not (opt.flag & MEM_F_ALL):
        XA = gen_alt(fm, opt, regs, l_query, enc)
    aa: list[Aln] = []
    keep_idx = []
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if (0 <= p.secondary < INT_MAX
                and f32(p.score) < fmul(regs[p.secondary].score,
                                        opt.drop_ratio)):
            continue
        q = reg2aln(fm, opt, l_query, enc, p)
        q.XA = XA[k] if XA else None
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1
        if aa and p.secondary < 0:  # supplementary
            q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if (not (opt.flag & MEM_F_KEEP_SUPP_MAPQ) and aa and not p.is_alt
                and q.mapq > aa[0].mapq):
            q.mapq = aa[0].mapq
        aa.append(q)
        keep_idx.append(k)
    if not aa:
        t = reg2aln(fm, opt, l_query, enc, None)
        t.flag |= extra_flag
        return aln2sam(fm, opt, read, 1, [t], 0, m_, rg_id)
    return "".join(aln2sam(fm, opt, read, len(aa), aa, k, m_, rg_id)
                   for k in range(len(aa)))
