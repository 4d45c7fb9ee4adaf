"""Fused seeding on the device: SMEM collection and SA resolution.

The port's counterpart of the JAX package's ops/seedall.py (with
smem.round3_replay_kernel) and ops/salookup.py.  Two kernels carry it:

  smem_collect   mem_collect_smem for every read of a chunk — round 1
                 (pivots at next_x, min_intv 1), round 2 (the split rule
                 over round 1's output), round 3 (forward-only seeds while
                 max_mem_intv > 0), then the per-read (m, n) sort.  Output
                 goes into each read's own slots (slot_offsets, sized from
                 its length); a read that outruns them, or the candidate
                 list's capacity (list_cap), is flagged (count -1) and
                 re-seeded exactly on the host by the caller
                 (ops/backend.py:_patch_chunk).
  sa_resolve     get_sa_entry_compressed for every sampled BWT position.

Each has a plain PyTorch version here (`smem_collect_ref`,
`sa_resolve_ref`) and a wrapper (`smem_collect`, `sa_resolve`, bound in
ops/seed_cuda.py): CPU tensors run the plain version, CUDA tensors launch
the kernel (csrc/smem_collect.cu, csrc/sa_resolve.cu) or raise.

`FusedSeeder.run` chains them for one read grid: smem_collect, compaction
of the slots into (m, n, k, s) of the SMEMs alone, expansion of the max_occ-sampled
positions (sa_positions_batch semantics: cnt = min(s, max_occ),
pos = k + j*step), sa_resolve, and one fetch of everything.  The sizes of
the flat arrays are read from the device once before they are built (two
scalars), so nothing else waits on the card.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..utils.profiling import PROF
from .device_index import (DeviceFMIndex, backward_ext_full, bwt_char_occ,
                           sa_words)
from .seed_cuda import SaResolve, SmemCollect

I64 = torch.int64


# The two route rules of smem_collect.  They decide only where a read is
# seeded (on the device, or re-seeded exactly on the host when it outruns
# either), never what it gets.
SLOTS_BASE, SLOTS_PER_BASE = 16, 4     # a read's slots: 16 + len // 4
LIST_CAPS = (160, 320)                 # on-chip candidate list entries


def list_cap(L: int) -> int:
    """Candidate list entries for a read grid of width L: a list holds at
    most one entry per base of its read, so 160 never overflows under 160
    bp."""
    return LIST_CAPS[0] if L < LIST_CAPS[0] else LIST_CAPS[1]


def slot_offsets(lens: torch.Tensor) -> torch.Tensor:
    """int64[N + 1] offsets of each read's SMEM slots in the flat outputs,
    prefix-summed on lens' device: read r gets SLOTS_BASE + lens[r] //
    SLOTS_PER_BASE slots."""
    caps = SLOTS_BASE + lens.long().clamp(min=0) // SLOTS_PER_BASE
    off = torch.zeros(lens.shape[0] + 1, dtype=I64, device=lens.device)
    torch.cumsum(caps, 0, out=off[1:])
    return off


# ------------------------------------------------------ smem_collect_ref
def _emit(st, rows, mask, m, n, k, s) -> None:
    """Append (m, n, k, s) to the slots of reads rows[mask] (at most one
    per read per call); a read whose slots are full is flagged dead."""
    mask = mask & st.alive[rows]
    pos = st.cnt[rows]
    over = mask & (pos >= st.cap[rows])
    w = mask & ~over
    pp = torch.minimum(pos, st.cap[rows] - 1).clamp(min=0)
    for arr, v in ((st.m, m), (st.n, n), (st.k, k), (st.s, s)):
        arr[rows, pp] = torch.where(w, v.to(arr.dtype), arr[rows, pp])
    st.cnt[rows] = pos + w.long()
    st.alive[rows] = st.alive[rows] & ~over


def _one_pos(st, rows, x, mi):
    """smems_one_pos for the reads `rows` at pivots x with min_intv mi
    (int64[R] each), lockstep over the reads; returns next_x.

    The candidate lists are [R, C] tensors with a per-read length, C =
    min(L+1, list_cap); a read whose forward walk would push more than
    list_cap candidates is flagged dead.  One backward step extends every
    candidate of every read at once; the
    sequential rules of the host loop become masked scans:
      * first emit: the first candidate that either survives or dies at
        full length; it emits if it died;
      * distinct survivors: a survivor is kept when its size differs from
        the previous survivor's."""
    dfm, counts = st.dfm, st.dfm.counts
    e = st.enc[rows]
    ln = st.lens[rows]
    R, L = e.shape
    C = min(L + 1, st.lcap)
    dev = e.device
    ar = torch.arange(R, device=dev)
    cidx = torch.arange(C, device=dev)
    take = lambda t, i: t.gather(1, i[:, None])[:, 0]  # noqa: E731

    a = take(e, x.clamp(max=L - 1))
    valid = (a < 4) & st.alive[rows]
    ac = a.clamp(max=3)
    k, l, s = counts[ac], counts[3 - ac], counts[ac + 1] - counts[ac]
    n = x.clone()
    Pn, Pk, Pl, Ps = (torch.zeros((R, C), dtype=I64, device=dev)
                      for _ in range(4))
    npv = torch.zeros(R, dtype=I64, device=dev)

    def push(mask, vn, vk, vl, vs):
        nonlocal npv
        mask = mask & st.alive[rows]
        over = mask & (npv >= st.lcap)
        st.alive[rows] = st.alive[rows] & ~over
        mask = mask & ~over
        at = npv.clamp(max=C - 1)
        for P, v in ((Pn, vn), (Pk, vk), (Pl, vl), (Ps, vs)):
            P[ar, at] = torch.where(mask, v, P[ar, at])
        npv = npv + mask.long()

    # forward: extend right from x while the interval stays >= mi
    next_x = x + 1
    fwd = valid.clone()
    j = x + 1
    while True:
        ended = fwd & (j >= ln)
        next_x = torch.where(ended, ln, next_x)
        fwd = fwd & ~ended
        if not bool(fwd.any()):
            break
        aj = take(e, j.clamp(max=L - 1))
        next_x = torch.where(fwd, j + 1, next_x)
        ext = fwd & (aj < 4)
        # forward extension == backward on the RC twin with k/l swapped
        ko, lo, ns = backward_ext_full(dfm, l, k, s, 3 - aj.clamp(max=3))
        st.nbwd[rows] += ext.long()
        push(ext & (ns != s), n, k, l, s)
        die = ext & (ns < mi)
        next_x = torch.where(die, j, next_x)
        fwd = ext & ~die
        k = torch.where(fwd, lo, k)
        l = torch.where(fwd, ko, l)
        s = torch.where(fwd, ns, s)
        n = torch.where(fwd, j, n)
        j = torch.where(fwd, j + 1, j)
    push(valid & (s >= mi), n, k, l, s)
    # longest match first
    rev = (npv[:, None] - 1 - cidx).clamp(min=0)
    Pn, Pk, Pl, Ps = (P.gather(1, rev) for P in (Pn, Pk, Pl, Ps))

    # backward: extend every candidate left, column by column
    mcur = x.clone()
    bwd = valid & (npv > 0)
    j = x - 1
    while True:
        aj = take(e, j.clamp(min=0))
        bwd = bwd & st.alive[rows] & (j >= 0) & (aj < 4)
        if not bool(bwd.any()):
            break
        Cm = int(torch.where(bwd, npv, 0).max())
        pn, pk, pl, ps = Pn[:, :Cm], Pk[:, :Cm], Pl[:, :Cm], Ps[:, :Cm]
        cm = (cidx[:Cm] < npv[:, None]) & bwd[:, None]
        nk, nl, ns = backward_ext_full(
            dfm, pk, pl, ps, aj.clamp(max=3)[:, None].expand(R, Cm))
        st.nbwd[rows] += torch.where(bwd, npv, 0)
        dies = ns < mi[:, None]
        longc = (pn - mcur[:, None] + 1) >= st.msl
        hit = cm & ((dies & longc) | ~dies)
        f = hit.long().argmax(1)
        fe = bwd & hit.any(1) & take(dies, f)
        _emit(st, rows, fe, mcur, take(pn, f), take(pk, f), take(ps, f))
        surv = cm & ~dies
        last = torch.where(surv, cidx[:Cm], -1).cummax(1).values
        prev = torch.cat([torch.full((R, 1), -1, dtype=I64, device=dev),
                          last[:, :-1]], 1)
        prev_ns = torch.where(prev >= 0, ns.gather(1, prev.clamp(min=0)), -1)
        keep = surv & (ns != prev_ns)
        dest = torch.where(keep, keep.long().cumsum(1) - 1, Cm)
        for P, v in ((Pn, pn), (Pk, nk), (Pl, nl), (Ps, ns)):
            buf = torch.zeros((R, Cm + 1), dtype=I64, device=dev)
            buf.scatter_(1, dest, v)
            P[:, :Cm] = torch.where(bwd[:, None], buf[:, :Cm], P[:, :Cm])
        npv = torch.where(bwd, keep.sum(1), npv)
        mcur = torch.where(bwd, j, mcur)
        bwd = bwd & (npv > 0)
        j = j - 1
    fin = valid & (npv > 0) & ((Pn[:, 0] - mcur + 1) >= st.msl)
    _emit(st, rows, fin, mcur, Pn[:, 0], Pk[:, 0], Ps[:, 0])
    return next_x


def smem_collect_ref(dfm: DeviceFMIndex, enc: torch.Tensor,
                     lens: torch.Tensor, min_seed_len: int, split_len: int,
                     split_width: int, max_mem_intv: int, lcap: int,
                     slot_off: torch.Tensor):
    """Plain PyTorch version of csrc/smem_collect.cu: one lane per read,
    lockstep over the read axis.  enc int8[N, L] (4 = N/padding), lens
    int32[N]; the route rules: lcap candidate list entries, and read r's
    slots at [slot_off[r], slot_off[r+1]) of the flat outputs.  Returns
    (m, n int32[S], k, s int64[S], cnt int32[N], nbwd int64[N]), S =
    slot_off[N]; each read's first cnt slots hold its SMEMs sorted by (m,
    n), the rest are unspecified; a read that outran its list or its slots
    has cnt -1 and nbwd 0."""
    dev = enc.device
    N, L = enc.shape
    caps = slot_off[1:] - slot_off[:-1]
    cmax = max(int(caps.max()), 1) if N else 1
    z = lambda *sh: torch.zeros(sh, dtype=I64, device=dev)  # noqa: E731
    st = SimpleNamespace(
        dfm=dfm, enc=enc.long(), lens=lens.long().clamp(0, L), cap=caps,
        lcap=int(lcap), msl=int(min_seed_len), m=z(N, cmax), n=z(N, cmax),
        k=z(N, cmax), s=z(N, cmax), cnt=z(N), nbwd=z(N),
        alive=torch.ones(N, dtype=torch.bool, device=dev))
    all_rows = torch.arange(N, device=dev)

    # round 1: pivots at next_x, min_intv = 1
    x = z(N)
    while True:
        rows = (st.alive & (x < st.lens)).nonzero()[:, 0]
        if rows.numel() == 0:
            break
        x[rows] = _one_pos(st, rows, x[rows], torch.ones_like(rows))

    # round 2: the split rule over a snapshot of round 1's output
    slot = torch.arange(cmax, device=dev)
    qm, qn, qs = st.m.clone(), st.n.clone(), st.s.clone()
    q = ((slot < st.cnt[:, None]) & ((qn + 1 - qm) >= split_len)
         & (qs <= split_width) & st.alive[:, None])
    rank = q.long().cumsum(1) - 1
    for t in range(int(q.sum(1).max()) if N else 0):
        sel = q & (rank == t)
        rows = (sel.any(1) & st.alive).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        si = sel[rows].long().argmax(1)
        pm, pn_, ps = (a[rows, si] for a in (qm, qn, qs))
        _one_pos(st, rows, (pm + pn_ + 1) >> 1, ps + 1)

    # round 3: forward-only seeds (bwtSeedStrategyAllPosOneThread)
    if max_mem_intv > 0:
        counts = dfm.counts
        msl1 = st.msl + 1
        x3, j, m3, k, l, s = z(N), z(N), z(N), z(N), z(N), z(N)
        walk = torch.zeros(N, dtype=torch.bool, device=dev)
        take = lambda t, i: t.gather(1, i[:, None].clamp(0, L - 1))[:, 0]
        while True:
            act = st.alive & (x3 < st.lens)
            if not bool(act.any()):
                break
            a = take(st.enc, x3)
            start = act & ~walk
            x3 = torch.where(start & (a >= 4), x3 + 1, x3)
            new = start & (a < 4)
            ac = a.clamp(max=3)
            k = torch.where(new, counts[ac], k)
            l = torch.where(new, counts[3 - ac], l)
            s = torch.where(new, counts[ac + 1] - counts[ac], s)
            m3 = torch.where(new, x3, m3)
            j = torch.where(new, x3 + 1, j)
            walk = walk | new
            w = act & walk
            ended = w & (j >= st.lens)
            x3 = torch.where(ended, st.lens, x3)
            walk = walk & ~ended
            w = w & ~ended
            aj = take(st.enc, j)
            nb = w & (aj >= 4)
            x3 = torch.where(nb, j + 1, x3)
            walk = walk & ~nb
            ext = w & (aj < 4)
            ko, lo, ns = backward_ext_full(dfm, l, k, s, 3 - aj.clamp(max=3))
            st.nbwd += ext.long()
            k = torch.where(ext, lo, k)
            l = torch.where(ext, ko, l)
            s = torch.where(ext, ns, s)
            stop = ext & (s < max_mem_intv) & ((j - m3 + 1) >= msl1)
            _emit(st, all_rows, stop & (s > 0), m3, j, k, s)
            x3 = torch.where(stop, j + 1, x3)
            walk = walk & ~stop
            j = torch.where(ext & ~stop, j + 1, j)

    # per-read (m, n) sort; ties are full-tuple duplicates
    valid = slot < st.cnt[:, None]
    key = torch.where(valid, st.m * (L + 2) + st.n, (L + 2) ** 2)
    order = torch.sort(key, dim=1, stable=True).indices
    own = slot < caps[:, None]
    at = (slot_off[:-1, None] + slot)[own]
    S = int(slot_off[-1])

    def flat(a, dt):
        out = torch.zeros(S, dtype=dt, device=dev)
        out[at] = a.gather(1, order)[own].to(dt)
        return out

    cnt = torch.where(st.alive, st.cnt, -1).to(torch.int32)
    nbwd = torch.where(st.alive, st.nbwd, 0)
    return (flat(st.m, torch.int32), flat(st.n, torch.int32),
            flat(st.k, I64), flat(st.s, I64), cnt, nbwd)


# -------------------------------------------------------- sa_resolve_ref
def sa_resolve_ref(dfm: DeviceFMIndex, pos: torch.Tensor,
                   row_reads: list | None = None) -> torch.Tensor:
    """Plain PyTorch version of csrc/sa_resolve.cu: every lane LF-walks
    until its position is a sampled slot (pos & 7 == 0) or the sentinel,
    lockstep.  `row_reads`, when given, receives the number of occ-row
    reads the walks made (LF steps, plus one per walk that ended at the
    sentinel)."""
    pos = pos.long()
    sp = pos.clone()
    off = torch.zeros_like(pos)
    sent = torch.zeros_like(pos, dtype=torch.bool)
    done = (sp & 7) == 0
    while not bool(done.all()):
        b, occ = bwt_char_occ(dfm, sp)
        hit = ~done & (b == 4)
        sent = sent | hit
        step = ~done & ~hit
        sp = torch.where(step, dfm.counts[b.clamp(max=3)] + occ, sp)
        off = torch.where(step, off + 1, off)
        done = done | hit | (step & ((sp & 7) == 0))
    if row_reads is not None:
        row_reads.append(int(off.sum()) + int(sent.sum()))
    ms, ls = sa_words(dfm, sp >> 3)
    sa = ms.long() * (1 << 32) + (ls.long() & 0xFFFFFFFF)
    return torch.where(sent, off, sa + off)


smem_collect = SmemCollect(smem_collect_ref)
sa_resolve = SaResolve(sa_resolve_ref)


# ----------------------------------------------------------- the seeder
def compact_and_expand(m, n, k, s, cnt, slot_off, max_occ: int):
    """smem_collect's flat per-read slots (read r's at slot_off[r]...) ->
    flat (m, n, s) in (read, m, n) order (overflowed reads contribute
    nothing) and the max_occ-sampled BWT positions of every SMEM: cnt =
    min(s, max_occ) positions k + j*step, step = s // max_occ when s >
    max_occ, else 1 (the sampling of mem_chain_seeds,
    align/chain.py:sa_positions_batch).  One read of two sizes from the
    device; nothing else waits on it."""
    dev = m.device
    S = m.shape[0]
    rid = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev),
                                  slot_off[1:] - slot_off[:-1],
                                  output_size=S)
    c = cnt.long().clamp(min=0)
    valid = (torch.arange(S, device=dev) - slot_off[rid]) < c[rid]
    occ_n = torch.where(valid, s, 0).clamp(max=max_occ)
    nsm, npos = torch.stack([c.sum(), occ_n.sum()]).tolist()
    # compact the slots, read-major, keeping each read's sorted order
    dest = torch.where(valid, valid.long().cumsum(0) - 1, nsm)

    def compact(a):
        buf = torch.zeros(nsm + 1, dtype=a.dtype, device=dev)
        return buf.scatter_(0, dest, a)[:nsm]

    m_c, n_c, k_c, s_c = (compact(a) for a in (m, n, k, s))
    cnt_c = s_c.clamp(max=max_occ)
    slot = torch.repeat_interleave(torch.arange(nsm, device=dev), cnt_c,
                                   output_size=npos)
    start = cnt_c.cumsum(0) - cnt_c
    jj = torch.arange(npos, device=dev) - start[slot]
    step = torch.where(s_c > max_occ, s_c // max_occ, 1)
    return m_c, n_c, s_c, k_c[slot] + jj * step[slot]


class FusedSeeder:
    """Seeding + SA resolution of one read grid on the index's device."""

    def __init__(self, dfm: DeviceFMIndex):
        self.dfm = dfm

    def run(self, encj: torch.Tensor, lensj, opt):
        """encj int8[N, L] on the index's device, lensj int32[N] there or
        on the host (numpy; uploaded here, so that the chunk's device work
        starts in this call).  Returns
        numpy (cnt int32[N] (-1: overflowed read), m, n int32, s int64,
        coords int64) — the flat arrays in (read, m, n) order, with
        min(s, max_occ) coordinates per SMEM.  PROF spans: seeding.collect
        ends at the size read (smem_collect done), seeding.resolve at the
        fetch."""
        N, L = encj.shape
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        lensj = torch.as_tensor(lensj).to(encj.device)
        with PROF("seeding.collect"):
            slot_off = slot_offsets(lensj)
            m, n, k, s, cnt, _ = smem_collect(
                self.dfm, encj, lensj, opt.min_seed_len, split_len,
                int(opt.split_width), int(opt.max_mem_intv), list_cap(L),
                slot_off)
            m_c, n_c, s_c, pos = compact_and_expand(m, n, k, s, cnt,
                                                    slot_off,
                                                    int(opt.max_occ))
        with PROF("seeding.resolve"):
            nsm, npos = s_c.shape[0], pos.shape[0]
            coords = sa_resolve(self.dfm, pos)
            flat = torch.cat([cnt.long(), m_c.long(), n_c.long(), s_c,
                              coords]).cpu().numpy()
        o = np.cumsum([0, N, nsm, nsm, nsm, npos])
        cnt, m, n, s, coords = (flat[o[i]:o[i + 1]] for i in range(5))
        return (cnt.astype(np.int32), m.astype(np.int32),
                n.astype(np.int32), s, coords)
