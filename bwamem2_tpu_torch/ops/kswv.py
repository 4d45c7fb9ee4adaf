"""Batched mate-rescue Smith-Waterman (kswv analog): dispatch and plain
reference.

The reference rescues mates with a striped (Farrar) local SW, ksw_align
(ksw.cpp:347-381; the port's lane-exact scalar emulation is
native/core.cpp:ksw_run_u8/ksw_run_i16/ksw_align).  Its quirks show in the
output, so the batched versions emulate the striped kernel, not the
textbook DP:

- the main pass computes each cell with only the INTRA-STRIPE gap-in-query
  (F) contribution (F restarts at every stripe of slen = ceil(qlen/16)
  columns); the lazy-F fixup then raises H to the true DP value, but E for
  the next row was already fed from the PRE-fixup cell;
- the per-row maximum (score, te, b-array) is taken before the fixup; the
  row kept for the end-position scan (Hmax) after it;
- u8 arithmetic saturates per operation (adds at 255 against the profile
  biased by shift = -min(mat), subtracts at 0); the i16 class (8 stripes)
  adds raw signed values and saturates at 32767 (_mm_adds_epi16), which
  only a score of round_up(qlen, 16) * a > 32767 can reach;
- the scores are those of bwa-mem2's int8 matrix (options.fill_scmat,
  MemOptions.mat_scores: at -A52, -B208 is a mismatch of +48 there), so
  the u8 profile never wraps and the i16 one fits a signed byte;
- the query is padded to 16*slen (8*slen) columns that score 0 and take
  part in the row maxima and the qe scan.

`kswv_phase_ref` is the plain PyTorch version of one phase (of
bwamem2_tpu's `kswv_kernel`, and of the one-phase kernel kswv_cuda.
kswv_phase, whose caller is tools/kernel_micro.py), vectorized
across problems (one row of the (P, Qmax) grids per problem, int32
throughout).  Both F recurrences unroll to prefix maxima with linear decay:
the pre-fixup F is a cummax segmented by stripe, the true F a plain cummax.
`kswv_two_phase_ref` runs phase 0 (score, end) and phase 1 (the start, on
reversed prefixes that end at the phase-0 end, stopping at the phase-0
score) with phase 1's descriptors computed from phase 0's result.  The CUDA
kernel (csrc/kswv.cu, csrc/kswv_group.cuh) computes the same two rows of 6.

`DeviceKswv.align_batch` is the dispatch that TorchBackend.rescue_batch
calls: both precision classes go to `kswv_cuda.kswv` — the kernel for a
read grid on the GPU, this reference for one on the CPU — each in
descending (tlen, qlen) order, and are enqueued before one fetch; the
result is the native ksw_align 7-tuple per problem, in descriptor order.
Every problem runs there; the i16 problems that can saturate are counted
as `rescue.i16_wide`.  There the output is the native kernel's:
the JAX package's int32 emulation (bwamem2_tpu/ops/kswv.py) does not
saturate, so it differs where qlen <= 512 (above, it sends the problem to
the native kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import PROF
from . import round_up
from .device_index import take_ref

I32 = torch.int32
NEGBIG = -(1 << 24)
HUGE = 1 << 22
NO_LIMIT = 1 << 16          # endsc / minsc value meaning "none"
ROW_BLOCK = 32              # rows between the plain version's exit checks


def kswv_phase_ref(ref, enc, qoff, qdir, qcomp, qlen, toff, tdir, tlen,
                   endsc, do_lane, Qmax: int, Tmax: int, minsc: int,
                   mat_a: int, mat_b: int, o_del: int, e_del: int,
                   o_ins: int, e_ins: int, ref_packed: bool = False,
                   u8: bool = True, work: list | None = None
                   ) -> torch.Tensor:
    """One phase of batched striped local SW from descriptors (plain
    PyTorch), emulating the u8 (16 stripes, biased, saturating at 255) or
    i16 (8 stripes, signed, saturating at 32767) kernel lane-exactly.

    ref: uint8 doubled genome (2-bit packed if ref_packed); enc: int8[N, L]
    read grid.  Per problem: qoff int32 (flat row*L+col of the first query
    char), qdir int32 (+-1), qcomp bool (complement codes < 4), qlen int32
    (<= Qmax; Qmax a multiple of 16, so the pad columns fit); toff int64 +
    tdir int32: the walk in the doubled genome; tlen int32 (<= Tmax);
    endsc int32: stop once the score reaches it (NO_LIMIT: none); do_lane
    bool.  minsc: the b-array floor (> 0xFFFF: no second best).

    Returns int32[P, 6]: score, te, qe, score2, te2, saturated (0 in the
    i16 class).  If `work` is a list, the striped cells and rows this
    phase ran are appended to it as (cells, rows)."""
    dev = enc.device
    P = qoff.shape[0]
    N, L = enc.shape
    NL = 16 if u8 else 8
    shift = max(-mat_a, mat_b, 1)   # -min(mat), mat = (a, -b, -1)
    maxsc = max(mat_a, -mat_b, 1)   # max(mat)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins

    enc_flat = enc.reshape(-1).to(I32)
    cols = torch.arange(Qmax, dtype=I32, device=dev)[None, :]
    qpos = qoff[:, None].long() + qdir[:, None].long() * cols
    qc = enc_flat[qpos.clamp(0, N * L - 1)]
    qc = torch.where(qcomp[:, None] & (qc < 4), 3 - qc, qc)
    qc = torch.where(cols < qlen[:, None], qc, 5)             # 5 = pad col
    slen = (qlen + NL - 1) // NL
    qpad = slen * NL
    valid = cols < qpad[:, None]                               # striped cols
    sid = torch.where(valid, cols // slen.clamp(min=1)[:, None], 0)
    colsE = cols * e_ins
    colsE1 = (cols - 1) * e_ins
    sidH = sid * HUGE
    neg_col = torch.full((P, 1), NEGBIG, dtype=I32, device=dev)
    zero_col = torch.zeros((P, 1), dtype=I32, device=dev)

    H = torch.zeros((P, Qmax), dtype=I32, device=dev)
    E = torch.zeros_like(H)
    Hmax = torch.zeros_like(H)
    rowmax = torch.zeros((P, Tmax), dtype=I32, device=dev)
    gmax = torch.zeros((P,), dtype=I32, device=dev)
    te = torch.full((P,), -1, dtype=I32, device=dev)
    rowstop = torch.where(do_lane, tlen, 0).to(I32)
    alive = do_lane & (tlen > 0)

    for i in range(Tmax):
        act = alive & (i < tlen)
        if i % ROW_BLOCK == 0 and not bool(act.any()):
            break          # every lane broke or ran out of rows
        tpos = toff + tdir.long() * i
        ti = take_ref(ref, tpos, ref_packed)[:, None]
        # profile on the fly: pad columns 0, ambiguous bases -1
        s = torch.where(qc == 5, 0,
                        torch.where((ti >= 4) | (qc >= 4), -1,
                                    torch.where(ti == qc, mat_a, -mat_b)))
        Hs = torch.cat([zero_col, H[:, :-1]], 1)               # diagonal
        if u8:
            M = ((Hs + s + shift).clamp(max=255) - shift).clamp(min=0)
        else:
            M = (Hs + s).clamp(max=32767)
        base = torch.maximum(M, E)
        # pre-fixup cell: intra-stripe F only (segmented prefix max)
        u = torch.where(valid, base - oe_ins + colsE + sidH, NEGBIG)
        useg = torch.cat([neg_col, torch.cummax(u, 1).values[:, :-1]], 1)
        hpre = torch.where(valid,
                           torch.maximum(base, useg - sidH - colsE1), 0)
        imax = hpre.max(1).values
        # post-fixup cell: true F (plain prefix max)
        ug = torch.where(valid, base - oe_ins + colsE, NEGBIG)
        ugm = torch.cat([neg_col, torch.cummax(ug, 1).values[:, :-1]], 1)
        hfin = torch.where(valid, torch.maximum(base, ugm - colsE1), 0)
        Enew = torch.where(valid,
                           torch.maximum((E - e_del).clamp(min=0),
                                         (hpre - oe_del).clamp(min=0)), 0)
        wr = act[:, None]
        H = torch.where(wr, hfin, H)
        E = torch.where(wr, Enew, E)
        rowmax[:, i] = torch.where(act, imax, 0)
        upd = act & (imax > gmax)
        gmax = torch.where(upd, imax, gmax)
        te = torch.where(upd, i, te)
        Hmax = torch.where(upd[:, None], hfin, Hmax)
        brk = gmax >= endsc
        if u8:
            brk = brk | (gmax + shift >= 255)
        brk = upd & brk
        rowstop = torch.where(brk, i + 1, rowstop)
        alive = alive & ~brk
    if work is not None:
        work.append((int((rowstop.long() * qpad).sum()),
                     int(rowstop.sum())))

    if u8:
        saturated = (gmax + shift >= 255) & do_lane
        score = torch.where(saturated, 255, gmax)
    else:
        saturated = torch.zeros((P,), dtype=torch.bool, device=dev)
        score = gmax
    # qe: the least query column among Hmax == max (pad columns included)
    hm = torch.where(valid, Hmax, -1)
    mx = hm.max(1).values
    qe = torch.where(hm == mx[:, None], cols, Qmax + 1).min(1).values
    qe = torch.where(do_lane & (te >= 0), qe, -1)

    # second best over the recorded row maxima (the b-array)
    best2 = torch.full((P,), -1, dtype=I32, device=dev)
    te2 = best2.clone()
    if minsc <= 0xFFFF:
        i2 = (score + maxsc - 1) // maxsc
        low, high = te - i2, te + i2
        have = torch.zeros((P,), dtype=torch.bool, device=dev)
        val = torch.zeros((P,), dtype=I32, device=dev)
        row = torch.full((P,), -2, dtype=I32, device=dev)

        def flush(cond):
            hit = cond & have & ((row < low) | (row > high)) & (val > best2)
            return torch.where(hit, val, best2), torch.where(hit, row, te2)

        n_rows = int(rowstop.max()) if P else 0
        for i in range(n_rows):
            rm = rowmax[:, i]
            rec = (i < rowstop) & (rm >= minsc)
            merge = rec & have & (row + 1 == i)
            improve = merge & (rm > val)
            start = rec & ~merge
            best2, te2 = flush(start)
            val = torch.where(improve | start, rm, val)
            row = torch.where(improve | start, i, row)
            have = have | rec
        best2, te2 = flush(torch.ones_like(have))
        best2 = torch.where(do_lane, best2, -1)
        te2 = torch.where(do_lane, te2, -1)
        best2 = torch.where(best2 < 0, -1, best2)
    return torch.stack([score, te, qe, best2, te2, saturated.to(I32)], 1)


def kswv_two_phase_ref(ref, enc, qoff, qdir, qcomp, qlen, toff, tlen,
                       Qmax: int, Tmax: int, minsc: int, mat_a: int,
                       mat_b: int, o_del: int, e_del: int, o_ins: int,
                       e_ins: int, ref_packed: bool = False, u8: bool = True,
                       work: list | None = None):
    """Both phases of every problem (bwamem2_tpu/ops/kswv.py:
    kswv_two_phase with every lane live, where no i16 score saturates;
    where one does, the native ksw_align): phase 0 forward from the
    descriptors with the b-array floor `minsc`; phase 1 on the reversed
    prefixes ending at the phase-0 end (query qe+1 long, target te+1),
    stopping at the phase-0 score, for the lanes where phase 0 found a
    score >= minsc that did not saturate.  Returns (r0, r1), int32[P, 6]
    each."""
    ones = torch.ones_like(qoff)
    live = torch.ones_like(qcomp)
    r0 = kswv_phase_ref(ref, enc, qoff, qdir, qcomp, qlen, toff, ones, tlen,
                        ones * NO_LIMIT, live, Qmax, Tmax, minsc, mat_a,
                        mat_b, o_del, e_del, o_ins, e_ins, ref_packed, u8,
                        work)
    score, te, qe = r0[:, 0], r0[:, 1], r0[:, 2]
    want = (r0[:, 5] == 0) & (score >= minsc) & (te >= 0) & (qe >= 0)
    r1 = kswv_phase_ref(ref, enc, qoff + qdir * qe, -qdir, qcomp,
                        torch.where(want, qe + 1, 0), toff + te.long(), -ones,
                        torch.where(want, te + 1, 0), score, want, Qmax,
                        Tmax, NO_LIMIT, mat_a, mat_b, o_del, e_del, o_ins,
                        e_ins, ref_packed, u8, work)
    return r0, r1


class DeviceKswv:
    """Two-phase batched mate-rescue SW (mem_sam_pe_batch analog).

    align_batch() takes per-problem descriptors into the chunk's read grid
    and the doubled genome and returns the native ksw_align 7-tuple
    (score te qe score2 te2 tb qb) per problem, identical to the scalar
    path.  Every problem runs in the kernel, in its precision class (u8 =
    kswv512_u8, i16 = kswv512_16 analogs), whatever its length: one launch
    per class, one lane group per problem, the stripes sized from the
    class's own longest query.  Each class is launched longest first, by
    descending (tlen, qlen), so that neighbouring lane groups run rows of
    similar count; the results go back to descriptor order.  u8-saturated
    lanes keep the native saturated shape."""

    def __init__(self, dfm, opt):
        self.dfm = dfm
        self.opt = opt
        self.minsc = opt.min_seed_len * opt.a

    def wide(self, desc: dict) -> np.ndarray:
        """The i16 problems whose scores can reach 32767, where the
        kernel saturates as the native one does."""
        span = (desc["qlen"].astype(np.int64) + 15) // 16 * 16 * self.opt.a
        return ~desc["u8"] & (span > 32767)

    def launch_order(self, desc: dict) -> list:
        """[(u8, idx)] per precision class present: the class's kernel
        problems by descending (tlen, qlen), ties in descriptor order."""
        out = []
        for u8 in (True, False):
            idx = np.nonzero(desc["u8"] == u8)[0]
            if len(idx):
                out.append((u8, idx[np.lexsort((-desc["qlen"][idx],
                                                -desc["tlen"][idx]))]))
        return out

    def kswv_args(self, encj, desc: dict, idx, u8: bool) -> tuple:
        """The kswv arguments for the problems `idx` of one precision class,
        uploaded to the read grid's device; Qmax (a multiple of 16, so the
        pad columns of both classes fit) and Tmax are this batch's own
        maxima."""
        opt = self.opt
        dev = encj.device
        Qmax = round_up(int(desc["qlen"][idx].max()), 16)
        Tmax = max(int(desc["tlen"][idx].max()), 1)

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a[idx], dt)).to(dev)

        return (self.dfm.ref, encj, put(desc["qoff"], np.int32),
                put(desc["qdir"], np.int32), put(desc["qcomp"], bool),
                put(desc["qlen"], np.int32), put(desc["toff"], np.int64),
                put(desc["tlen"], np.int32), Qmax, Tmax, self.minsc,
                *opt.mat_scores(), opt.o_del, opt.e_del, opt.o_ins,
                opt.e_ins, self.dfm.ref_packed, u8)

    def _finish(self, r0h, r1h) -> np.ndarray:
        """The native ksw_align 7-tuples from the fetched phase results."""
        res = np.zeros((len(r0h), 7), np.int32)
        res[:, :5] = r0h[:, :5]
        res[:, 5:] = -1
        # saturated u8 lanes keep exactly the native shape (255, te, -1,
        # -1, -1, -1, -1): ksw_u8 skips the qe/2nd-best scans at 255 and
        # ksw_align2 has no i16 rerun (ksw.cpp:219-231, 367-380)
        sat = r0h[:, 5] > 0
        res[sat, 2:5] = -1
        ok1 = (r1h[:, 0] == r0h[:, 0]) & (r0h[:, 0] >= self.minsc) \
            & ~sat & (r0h[:, 1] >= 0) & (r0h[:, 2] >= 0)
        res[ok1, 5] = r0h[ok1, 1] - r1h[ok1, 1]
        res[ok1, 6] = r0h[ok1, 2] - r1h[ok1, 2]
        return res

    def align_batch(self, encj, desc: dict) -> np.ndarray:
        """desc arrays (length n): qoff (flat read-grid index), qdir,
        qcomp, qlen, toff (absolute), tlen, u8 (the XBYTE class).  Returns
        int32[n, 7].  Both precision classes are enqueued before the one
        fetch."""
        from .kswv_cuda import kswv
        n = len(desc["qoff"])
        out = np.zeros((n, 7), np.int32)
        flights = [(idx, kswv(*self.kswv_args(encj, desc, idx, u8)))
                   for u8, idx in self.launch_order(desc)]
        PROF.count("rescue.i16_wide", int(self.wide(desc).sum()), n)
        if flights:
            fetched = torch.cat([torch.cat(r, 1) for _, r in flights]) \
                .cpu().numpy()                                   # 1 fetch
            pos = 0
            for idx, _ in flights:
                r = fetched[pos:pos + len(idx)]
                out[idx] = self._finish(r[:, :6], r[:, 6:])
                pos += len(idx)
        return out
