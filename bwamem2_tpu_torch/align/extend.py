"""Seed extension: chains -> scored alignment regions.

Mirrors mem_chain2aln_across_reads_V2 (bwamem.cpp:2069-2994): gather left /
right extension problems for a whole batch into SoA buffers (left sequences
reversed so both directions extend forward), run the banded-SW kernel with
MAX_BAND_TRY band-doubling retries and the reference's acceptance rule, then
replicate the seed-contained-in-existing-alignment purge.

The SW kernel is pluggable: the host path calls the native C++ batch kernel;
the device path (ops/bsw.py) scores the same pairs on the GPU.  Both return
(score, qle, tle, gtle, gscore, max_off) per pair.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..index.fmindex import FMIndex
from ..native import bsw_extend_batch
from .chain import Chain, Seed

MAX_BAND_TRY = 2
H0_NULL = -99  # H0_ sentinel for "not yet extended" coordinates (macro.h:44)


@dataclass(slots=True)
class AlnReg:
    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = 0
    truesc: int = 0
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    is_alt: int = 0
    frac_rep: float = 0.0
    hash: int = 0
    chain: Chain | None = None
    flg: int = 0


def cal_max_gap(opt, qlen: int) -> int:
    # memoized per qlen: called twice per seed plus per purge probe
    try:
        return opt._maxgap_cache[qlen]
    except (AttributeError, KeyError):
        pass
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = min(max(max(l_del, l_ins), 1), opt.w << 1)
    try:
        opt._maxgap_cache[qlen] = l
    except AttributeError:
        try:
            opt._maxgap_cache = {qlen: l}
        except Exception:
            pass
    return l


@dataclass(slots=True)
class _Pair:
    """One extension problem (SeqPair analog, bandedSWA.h:90-99).

    ref/qer are the materialized sequences (host kernels, device fallback);
    when the read grid and reference live on device, the descriptor fields
    (qoff/qdir into the padded read grid row, toff/tdir absolute into the
    doubled-genome ref array) let the device kernel gather the sequences
    itself so only ~40B/pair crosses the host->device link."""
    ref: np.ndarray | None
    qer: np.ndarray | None
    h0: int
    regid: int      # index into the read's alnreg list
    seqid: int
    qoff: int = -1  # first query char offset within the read (qdir walk)
    qdir: int = 0
    toff: int = -1  # first ref char (absolute, doubled genome)
    tdir: int = 0
    qlen: int = -1  # lengths (so descriptor-only pairs skip the copies)
    tlen: int = -1


def _run_class(pairs: list[_Pair], opt, regs_by_seqid, side: str,
               kernel, l_seqs) -> None:
    """Band-doubling retry loop with the acceptance rule of
    bwamem.cpp:2472-2526 (left) / 2688-2742 (right)."""
    pending = pairs
    for i in range(MAX_BAND_TRY):
        if not pending:
            break
        w = opt.w << i
        res = kernel(pending, w, opt)
        nxt = []
        for sp, (score, qle, tle, gtle, gscore, max_off) in zip(pending, res):
            a = regs_by_seqid[sp.seqid][sp.regid]
            prev = a.score
            a.score = int(score)
            if (a.score == prev or max_off < (w >> 1) + (w >> 2)
                    or i + 1 == MAX_BAND_TRY):
                if side == "left":
                    if gscore <= 0 or gscore <= a.score - opt.pen_clip5:
                        a.qb -= int(qle)
                        a.rb -= int(tle)
                        a.truesc = a.score
                    else:
                        a.qb = 0
                        a.rb -= int(gtle)
                        a.truesc = int(gscore)
                else:
                    if gscore <= 0 or gscore <= a.score - opt.pen_clip3:
                        a.qe += int(qle)
                        a.re += int(tle)
                        a.truesc += a.score - sp.h0
                    else:
                        a.qe = l_seqs[sp.seqid]
                        a.re += int(gtle)
                        a.truesc += int(gscore) - sp.h0
                a.w = max(a.w, w)
                if (a.rb != H0_NULL and a.qb != H0_NULL and a.qe != H0_NULL
                        and a.re != H0_NULL):
                    a.seedcov = sum(
                        t.len for t in a.chain.seeds
                        if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                            and t.rbeg >= a.rb and t.rbeg + t.len <= a.re))
            else:
                nxt.append(sp)
        pending = nxt


def native_bsw_kernel_factory(end_bonus_attr: str):
    """Host kernel: pack the pending pairs into SoA buffers and run the
    native banded-SW batch (spec: scalarBandedSWA)."""
    def kernel(pending: list[_Pair], w: int, opt) -> np.ndarray:
        n = len(pending)
        ref_len = np.array([len(p.ref) for p in pending], np.int32)
        qer_len = np.array([len(p.qer) for p in pending], np.int32)
        ref_off = np.zeros(n, np.int64)
        qer_off = np.zeros(n, np.int64)
        np.cumsum(ref_len[:-1], out=ref_off[1:])
        np.cumsum(qer_len[:-1], out=qer_off[1:])
        refs = (np.concatenate([p.ref for p in pending])
                if n else np.zeros(0, np.uint8))
        qers = (np.concatenate([p.qer for p in pending])
                if n else np.zeros(0, np.uint8))
        h0 = np.array([p.h0 for p in pending], np.int32)
        mat = np.array(opt.mat, np.int8)
        return bsw_extend_batch(
            refs, ref_off, ref_len, qers, qer_off, qer_len, h0, w, mat,
            opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
            getattr(opt, end_bonus_attr))
    return kernel


def extend_chains(fm: FMIndex, opt, encs: list[np.ndarray],
                  chains_per_read: list[list[Chain]],
                  left_kernel=None, right_kernel=None,
                  device_caps: tuple | None = None) -> list[list[AlnReg]]:
    """Extension over a batch of reads; returns per-read alignment regions
    (purged entries have qb == qe == -1 and are filtered by the caller)."""
    l_pac = fm.l_pac
    left_kernel = left_kernel or native_bsw_kernel_factory("pen_clip5")
    right_kernel = right_kernel or native_bsw_kernel_factory("pen_clip3")

    regs: list[list[AlnReg]] = [[] for _ in encs]
    left_pairs: list[_Pair] = []
    right_pairs: list[_Pair] = []
    srt_per_chain: dict[tuple[int, int], list[int]] = {}

    for seqid, (enc, chains) in enumerate(zip(encs, chains_per_read)):
        l_query = len(enc)
        av = regs[seqid]
        for cidx, c in enumerate(chains):
            if c.n == 0:
                continue
            # max possible reference span of this chain
            rmax0, rmax1 = l_pac << 1, 0
            for t in c.seeds:
                b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
                e = (t.rbeg + t.len + (l_query - t.qbeg - t.len)
                     + cal_max_gap(opt, l_query - t.qbeg - t.len))
                rmax0 = min(rmax0, b)
                rmax1 = max(rmax1, e)
            rmax0 = max(rmax0, 0)
            rmax1 = min(rmax1, l_pac << 1)
            if rmax0 < l_pac < rmax1:
                if c.seeds[0].rbeg < l_pac:
                    rmax1 = l_pac
                else:
                    rmax0 = l_pac
            rseq, rid, rmax0, rmax1 = fm.fetch_seq(rmax0, c.seeds[0].rbeg,
                                                   rmax1)
            assert rid == c.rid

            # seeds in (score, index) ascending -> process descending
            srt = sorted(range(c.n),
                         key=lambda i: (c.seeds[i].score << 32) | i)
            srt_per_chain[(seqid, cidx)] = srt
            for k in range(c.n - 1, -1, -1):
                s = c.seeds[srt[k]]
                a = AlnReg(w=opt.w, score=-1, truesc=-1, rid=c.rid,
                           frac_rep=c.frac_rep, seedlen0=s.len, chain=c,
                           rb=H0_NULL, qb=H0_NULL, re=H0_NULL, qe=H0_NULL)
                av.append(a)
                s.aln = len(av) - 1
                regid = len(av) - 1

                if s.qbeg:  # left extension (query prefix vs ref, reversed)
                    tmp = s.rbeg - rmax0
                    if (device_caps and s.qbeg <= device_caps[0]
                            and tmp <= device_caps[1]):
                        qs = rs = None  # device gathers from descriptors
                    else:
                        qs = enc[s.qbeg - 1::-1].copy()
                        rs = rseq[tmp - 1::-1].copy() if tmp > 0 \
                            else rseq[0:0].copy()
                    left_pairs.append(_Pair(ref=rs, qer=qs,
                                            h0=s.len * opt.a, regid=regid,
                                            seqid=seqid,
                                            qoff=s.qbeg - 1, qdir=-1,
                                            toff=s.rbeg - 1, tdir=-1,
                                            qlen=s.qbeg, tlen=max(tmp, 0)))
                    a.qb = s.qbeg
                    a.rb = s.rbeg
                else:
                    a.score = a.truesc = s.len * opt.a
                    a.qb = 0
                    a.rb = s.rbeg

                if s.qbeg + s.len != l_query:  # right extension
                    qe = s.qbeg + s.len
                    re = s.rbeg + s.len - rmax0
                    qln = l_query - qe
                    tln = (rmax1 - rmax0) - re
                    if (device_caps and qln <= device_caps[0]
                            and tln <= device_caps[1]):
                        qs = rs = None
                    else:
                        qs = enc[qe:].copy()
                        rs = rseq[re:rmax1 - rmax0].copy()
                    right_pairs.append(_Pair(ref=rs, qer=qs, h0=H0_NULL,
                                             regid=regid, seqid=seqid,
                                             qoff=qe, qdir=1,
                                             toff=s.rbeg + s.len, tdir=1,
                                             qlen=qln, tlen=tln))
                    a.qe = qe
                    a.re = rmax0 + re
                else:
                    a.qe = l_query
                    a.re = s.rbeg + s.len
                    if a.rb != H0_NULL and a.qb != H0_NULL:
                        a.seedcov = sum(
                            t.len for t in c.seeds
                            if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                                and t.rbeg >= a.rb and t.rbeg + t.len <= a.re))

    # left extensions first; right pairs then read their alnreg's score as h0
    _run_class(left_pairs, opt, regs, "left", left_kernel,
               [len(e) for e in encs])
    for sp in right_pairs:
        sp.h0 = regs[sp.seqid][sp.regid].score
    _run_class(right_pairs, opt, regs, "right", right_kernel,
               [len(e) for e in encs])

    # ---- seed-contained purge (bwamem.cpp:2895-2989) ----
    for seqid, (enc, chains) in enumerate(zip(encs, chains_per_read)):
        l_query = len(enc)
        av = regs[seqid]
        lim = 0
        for cidx, c in enumerate(chains):
            if c.n == 0:
                continue
            srt = list(srt_per_chain[(seqid, cidx)])
            for k in range(c.n - 1, -1, -1):
                s = c.seeds[srt[k]]
                v = 0
                for p in av:
                    if v >= lim:
                        break
                    if p.qb == -1 and p.qe == -1:
                        continue
                    if (s.rbeg < p.rb or s.rbeg + s.len > p.re
                            or s.qbeg < p.qb or s.qbeg + s.len > p.qe):
                        v += 1
                        continue
                    if s.len - p.seedlen0 > 0.1 * l_query:
                        v += 1
                        continue
                    qd = s.qbeg - p.qb
                    rd = s.rbeg - p.rb
                    max_gap = cal_max_gap(opt, min(qd, rd))
                    w = min(max_gap, p.w)
                    if qd - rd < w and rd - qd < w:
                        break
                    qd = p.qe - (s.qbeg + s.len)
                    rd = p.re - (s.rbeg + s.len)
                    max_gap = cal_max_gap(opt, min(qd, rd))
                    w = min(max_gap, p.w)
                    if qd - rd < w and rd - qd < w:
                        break
                    v += 1
                # "v < lim" == the scan broke on a containing hit (or ran out
                # of candidates), exactly as bwamem.cpp:2962
                if v < lim:
                    # confirm no overlapping distinct seed would extend
                    # differently
                    ok_skip = True
                    for v2 in range(k + 1, c.n):
                        if srt[v2] == -1:
                            continue
                        t = c.seeds[srt[v2]]
                        if t.len < s.len * 0.95:
                            continue
                        if (s.qbeg <= t.qbeg
                                and s.qbeg + s.len - t.qbeg >= s.len >> 2
                                and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                            ok_skip = False
                            break
                        if (t.qbeg <= s.qbeg
                                and t.qbeg + t.len - s.qbeg >= s.len >> 2
                                and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                            ok_skip = False
                            break
                    if ok_skip:
                        ar = av[s.aln]
                        ar.qb = ar.qe = -1
                        srt[k] = -1
                        continue
                lim += 1
    return regs
