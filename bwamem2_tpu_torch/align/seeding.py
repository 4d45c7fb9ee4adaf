"""SMEM seeding — host (exact/oracle) implementation.

Implements the 3-round SMEM collection of mem_collect_smem
(bwamem.cpp:626-803) with the per-position enumeration semantics of
getSMEMsOnePosOneThread (FMI_search.cpp:496-670) and the 3rd-round
forward-only strategy bwtSeedStrategyAllPosOneThread (FMI_search.cpp:726-812).

The TPU kernel in ops/smem.py computes the same SMEM sets batched over reads;
tests assert set equality against this implementation.

SMEM tuple: (rid, m, n, k, l, s) — query span [m, n], FM interval [k, k+s)
with reverse-complement twin at l.
"""

from __future__ import annotations

import numpy as np

from ..index.fmindex import FMIndex


def smems_one_pos(fm: FMIndex, enc: np.ndarray, rid: int, x: int,
                  min_intv: int, min_seed_len: int, out: list) -> int:
    """Enumerate SMEMs through position x; returns the next start position.

    Exact behavioral mirror of getSMEMsOnePosOneThread for one read and one
    starting position."""
    readlength = len(enc)
    next_x = x + 1
    a = int(enc[x])
    if a >= 4:
        return next_x

    # forward extension: interval of the single char a
    k = int(fm.counts[a])
    l = int(fm.counts[3 - a])
    s = int(fm.counts[a + 1] - fm.counts[a])
    m, n = x, x
    prev = []  # intervals (m, n, k, l, s), pushed shortest-first
    for j in range(x + 1, readlength):
        aj = int(enc[j])
        next_x = j + 1
        if aj >= 4:
            break
        # forward extension == backward extension on the RC index: swap k/l
        nk, nl, ns = fm.backward_ext(l, k, s, 3 - aj)
        nk, nl = nl, nk
        if ns != s:
            prev.append((m, n, k, l, s))
        if ns < min_intv:
            next_x = j
            break
        k, l, s, n = nk, nl, ns, j
    else:
        next_x = readlength
    if s >= min_intv:
        prev.append((m, n, k, l, s))

    prev.reverse()  # longest-match first

    # backward search
    for j in range(x - 1, -1, -1):
        if not prev:
            break
        aj = int(enc[j])
        if aj >= 4:
            break
        curr = []
        curr_s = -1
        p = 0
        emitted_or_kept = False
        while p < len(prev):
            pm, pn, pk, pl, ps = prev[p]
            nk, nl, ns = fm.backward_ext(pk, pl, ps, aj)
            if ns < min_intv and (pn - pm + 1) >= min_seed_len:
                out.append((rid, pm, pn, pk, pl, ps))
                p += 1
                emitted_or_kept = True
                break
            if ns >= min_intv and ns != curr_s:
                curr_s = ns
                curr.append((j, pn, nk, nl, ns))
                p += 1
                emitted_or_kept = True
                break
            p += 1
        # remaining entries: keep the distinct survivors
        while p < len(prev):
            pm, pn, pk, pl, ps = prev[p]
            nk, nl, ns = fm.backward_ext(pk, pl, ps, aj)
            if ns >= min_intv and ns != curr_s:
                curr_s = ns
                curr.append((j, pn, nk, nl, ns))
            p += 1
        prev = curr
        if not curr:
            break
    if prev:
        pm, pn, pk, pl, ps = prev[0]
        if pn - pm + 1 >= min_seed_len:
            out.append((rid, pm, pn, pk, pl, ps))
    return next_x


def smems_all_pos(fm: FMIndex, enc: np.ndarray, rid: int, min_intv: int,
                  min_seed_len: int, out: list) -> None:
    """Round-1 enumeration over all start positions (getSMEMsAllPosOneThread)."""
    x = 0
    while x < len(enc):
        x = smems_one_pos(fm, enc, rid, x, min_intv, min_seed_len, out)


def seed_strategy_all_pos(fm: FMIndex, enc: np.ndarray, rid: int,
                          max_intv: int, min_seed_len: int, out: list) -> None:
    """Round-3 forward-only seeding (bwtSeedStrategyAllPosOneThread): at each
    start, extend forward until the interval size drops below max_intv while
    the match is at least min_seed_len long; emit that interval."""
    readlength = len(enc)
    x = 0
    while x < readlength:
        next_x = x + 1
        a = int(enc[x])
        if a < 4:
            k = int(fm.counts[a])
            l = int(fm.counts[3 - a])
            s = int(fm.counts[a + 1] - fm.counts[a])
            m = x
            for j in range(x + 1, readlength):
                next_x = j + 1
                aj = int(enc[j])
                if aj >= 4:
                    break
                nk, nl, ns = fm.backward_ext(l, k, s, 3 - aj)
                nk, nl = nl, nk
                k, l, s = nk, nl, ns
                n = j
                if s < max_intv and (n - m + 1) >= min_seed_len:
                    if s > 0:
                        out.append((rid, m, n, k, l, s))
                    break
            else:
                next_x = readlength
        x = next_x


def collect_smems(fm: FMIndex, encs: list[np.ndarray], opt) -> list[list[tuple]]:
    """Full 3-round SMEM collection for a batch of nt4-encoded reads.

    Returns per-read SMEM lists sorted by (m, n) ascending — the composition
    of sortSMEMs (rid grouping) and the per-read ks_introsort(mem_intv1) at
    bwamem.cpp:785-799."""
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    per_read: list[list[tuple]] = [[] for _ in encs]

    for rid, enc in enumerate(encs):
        out: list[tuple] = []
        # round 1: all positions, min_intv = 1
        smems_all_pos(fm, enc, rid, 1, opt.min_seed_len, out)
        # round 2: re-seed long low-occ SMEMs from their midpoint
        n1 = len(out)
        for i in range(n1):
            _, m, n, k, l, s = out[i]
            if (n + 1 - m) < split_len or s > opt.split_width:
                continue
            x = (n + 1 + m) >> 1
            smems_one_pos(fm, enc, rid, x, s + 1, opt.min_seed_len, out)
        # round 3: forward-only seeds capped by max_mem_intv
        if opt.max_mem_intv > 0:
            seed_strategy_all_pos(fm, enc, rid, int(opt.max_mem_intv),
                                  opt.min_seed_len + 1, out)
        out.sort(key=lambda t: (t[1] << 32) | t[2])
        per_read[rid] = out
    return per_read


def encode_reads(seqs: list[bytes | str]) -> list[np.ndarray]:
    """ASCII reads -> nt4 codes (A0 C1 G2 T3, N=4)."""
    from ..index.io import NT4_TABLE
    encs = []
    for s in seqs:
        if isinstance(s, str):
            s = s.encode()
        encs.append(NT4_TABLE[np.frombuffer(s, dtype=np.uint8)].copy())
    return encs
